"""Chain planner: wire pruning plans and pick per-layer execution configs,
as ``repro.compiler.planner``.

Second compiler stage.  Takes the calibrator's per-layer fits and decides,
offline, what the engine would otherwise decide per call:

  * **pruning plans** — each producer layer is parameter-pruned to exactly
    the split dims its consumer's encode reads (``core.pruning``);
  * **backend choice** — the dispatch's ``select_backend`` policy for the
    card, at a representative batch and the post-quantisation LUT dtype;
  * **launch plan** — through ``kernels.autotune`` (the wrappers' own pick
    by default, measured on the card when ``autotune=True``).

Plans are recorded in the artifact with ``platform: "cuda"``; loading
applies them only where the platform matches (``compiler.artifact``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from repro_torch.compiler.calibrate import LayerCalibration
from repro_torch.compiler.quantize import ResolutionConfig
from repro_torch.core import pruning as P
from repro_torch.kernels import autotune as AT
from repro_torch.kernels import dispatch as D


@dataclasses.dataclass
class LayerPlan:
    """Everything the compiler decided about one layer."""

    prune_plan: Optional[P.PruningPlan]  # pruning of this layer's OUTPUT
    cols: int                            # shipped LUT columns
    backend: str                         # resolved engine backend
    tiles: Optional[AT.TileConfig]       # launch plan (None = ref)
    platform: str                        # platform the choice was made for


def plan_chain(calibs: Sequence[LayerCalibration],
               resolution: ResolutionConfig, *, prune: bool = True,
               batch_hint: int = 256, platform: str = AT.PLATFORM,
               autotune: bool = False, device=None) -> List[LayerPlan]:
    """Plan a calibrated cascade for the card: pruning hand-offs + execution
    configs evaluated at ``batch_hint`` rows.  ``device`` is where a
    launch plan is measured (``autotune``) or sized; off the card the
    plan is an H100's by shared memory alone."""
    plans: List[LayerPlan] = []
    for i, cal in enumerate(calibs):
        prune_plan = None
        if prune and i < len(calibs) - 1:
            prune_plan = P.plan_from_consumer_tree(
                calibs[i + 1].params.tree, consumer_in_dim=cal.out_features)
        cols = prune_plan.num_kept if prune_plan is not None else cal.out_features
        backend = D.select_backend(batch_hint, cal.num_codebooks, cols,
                                   cal.depth, resolution.runtime_dtype,
                                   platform)
        tiles = None
        if backend != "ref":
            tiles = AT.get_tiles(batch_hint, cal.num_codebooks, cols,
                                 cal.depth, resolution.runtime_dtype,
                                 platform=platform, backend=backend,
                                 allow_measure=autotune, device=device)
        plans.append(LayerPlan(prune_plan=prune_plan, cols=cols,
                               backend=backend, tiles=tiles,
                               platform=platform))
    return plans
