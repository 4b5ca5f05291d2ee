"""What a run hands back, and the result line it prints."""
from __future__ import annotations

import dataclasses
import json
import sys
from typing import Dict, List, Optional

# modules whose presence after the window refuses the result: the JAX
# stack and the JAX package, compared by whole top-level name (the port's
# name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Check:
    """One compared number: it passes while ``value <= limit``."""
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    """A driver's run: ``ctx`` is what the metric readers read."""
    ctx: Dict
    attempted: int
    failed: int
    checks: Dict[str, Check]
    problems: List[str]
    device: Dict
    breakdown: Optional[Dict] = None
    # what the driver's ``control`` needs to read the control on the same
    # inputs (the limits tool's; never printed)
    check_inputs: Optional[tuple] = None

    @property
    def correct(self) -> bool:
        return not self.problems and all(c.ok for c in self.checks.values())


def forbidden_modules(modules=None) -> List[str]:
    mods = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in mods} & set(FORBIDDEN))


def metric_values(metrics: List[Dict], ctx: Dict, reader) -> Dict:
    """Each listed metric a reader finds something for, with its unit."""
    out = {}
    for m in metrics:
        value = reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def line(outcome: Outcome, metrics: Dict) -> str:
    """The result line: ``checks`` (each compared number beside its limit)
    comes last."""
    res = {"correct": outcome.correct, "attempted": outcome.attempted,
           "failed": outcome.failed, "metrics": metrics,
           "device": outcome.device}
    if outcome.breakdown is not None:
        res["breakdown"] = outcome.breakdown
    res["checks"] = {k: {"value": c.value, "limit": c.limit}
                     for k, c in outcome.checks.items()}
    return json.dumps(res)


def print_checks(outcome: Outcome, file=sys.stderr) -> None:
    """The compared numbers as the last lines of standard error."""
    for p in outcome.problems:
        print(f"problem: {p}", file=file)
    for k, c in outcome.checks.items():
        print(f"check {k} = {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=file, flush=True)
