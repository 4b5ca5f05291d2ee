"""BENCHMARK.json against the benchmark's contract, the files it names,
the import guard, and that a cell added as new files is found."""
import ast
import json
import re
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.match(entry["name"]), entry["name"]
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for text in (entry.get("why"), entry.get("layer"), entry.get("source")):
        if text is not None:
            assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_entries(m):
    assert UNIT.match(m["unit"]), m["unit"]
    assert m["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    from portbench.harness import cell as C
    mod = C.reader(m["name"], ROOT)
    if m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])
        moves = {e["name"]: e for e in BENCH["end_to_end"]}[m["moves"]]
        assert set(m["workloads"]) <= set(moves.get("workloads", cells))


def test_every_cell_reports_setup_another_metric_and_a_layer():
    from portbench.harness import cell as C
    setup = {e["name"]: e for e in BENCH["end_to_end"]}["setup_s"]
    assert setup["bound"] <= 0.25 and "workloads" not in setup
    for w in BENCH["workloads"]:
        assert w["chips"] == 1
        e2e, per = C.cell_metrics(BENCH, w["name"])
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert per


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_configs(c):
    path = ROOT / c["file"]
    assert path.is_file() and path.with_suffix(".py").is_file()
    assert c["file"].startswith("portbench/") and c["reduced"] == []
    from portbench.harness import cell as C
    mod = C.load_module(path.with_suffix(".py"))
    assert mod.SOURCE == c["source"] and tuple(mod.REDUCED) == ()
    assert (ROOT / "portbench" / "drivers" / f"{mod.DRIVER}.py").is_file()
    assert (ROOT / "portbench" / "reference" / f"{mod.REFERENCE}.py").is_file()


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_resolves_with_its_limits(w):
    from portbench.harness import cell as C
    cell = C.resolve(w["name"], ROOT)
    assert cell.limits and all(v >= 0 for v in cell.limits.values())


FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted((ROOT / "portbench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_import_guard(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN, f"{path} imports {tops & FORBIDDEN}"
    if "reference" in path.relative_to(ROOT / "portbench").parts:
        assert "repro_torch" not in tops, f"{path} imports the program"


def test_run_refuses_the_jax_stack():
    from portbench.harness import result as R
    assert R.forbidden_modules({"repro_torch.serving": 1, "torch": 1}) == []
    assert R.forbidden_modules({"repro.models": 1, "jax.numpy": 1}) == ["jax", "repro"]


def test_a_cell_added_as_files_is_found(tmp_path):
    """A later PR's cell: a traffic file, a metric reader, a limits file and
    one new workloads entry; no existing file changes."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    shutil.copy(tmp_path / "portbench/traffic/batch-decode.json",
                tmp_path / "portbench/traffic/batch-decode-long.json")
    (tmp_path / "portbench/metrics/new_ms.tok2.py").write_text(
        'LAYER = "device"\nMOVES = "tok_s"\n\n\ndef read(ctx):\n    return 1.0\n')
    (tmp_path / "portbench/limits/qwen3-14b-lutmu.batch-decode-long.json"
     ).write_text('{"logit_gap": 0.5}')
    bench["workloads"].append({"name": "qwen3-14b-lutmu.batch-decode-long",
                               "config": "qwen3-14b-lutmu",
                               "traffic": "batch-decode-long", "chips": 1,
                               "why": "a later cell"})
    bench["per_layer"].append({"name": "new_ms.tok2", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "device", "moves": "tok_s",
                               "workloads": ["qwen3-14b-lutmu.batch-decode-long"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    from portbench.harness import cell as C
    cell = C.resolve("qwen3-14b-lutmu.batch-decode-long", tmp_path)
    assert cell.limits == {"logit_gap": 0.5}
    assert [m["name"] for m in cell.per_layer] == ["new_ms.tok2"]
    assert C.reader("new_ms.tok2", tmp_path).read({}) == 1.0
    assert C.driver(cell, tmp_path).__name__.endswith("serve_py")
    assert all(p.read_bytes() == b for p, b in before.items())


def test_run_without_a_card_prints_no_result():
    """``run.py`` exits non-zero with nothing on standard output where the
    cell's cards are missing (this host has none)."""
    import subprocess
    import sys
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA device" in proc.stderr
