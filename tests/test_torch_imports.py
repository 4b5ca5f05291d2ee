"""The port stands alone: importing every ``repro_torch`` module and
``chip_smoke.py`` loads no ``jax*`` module and nothing of ``repro``."""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, importlib.util, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad, " ".join(names))
sys.exit(1 if bad else 0)
"""


def test_port_and_chip_smoke_import_no_jax_and_no_repro():
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", _PROBE,
                           str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 64, proc.stdout
    # the artifact, observability, compiler, case-study and training
    # slices' modules are among those imported
    for name in ("repro_torch.compiler", "repro_torch.compiler.artifact",
                 "repro_torch.compiler.quantize", "repro_torch.core.lut_mu",
                 "repro_torch.serving.loader", "repro_torch.launch.serve",
                 "repro_torch.serving.obs", "repro_torch.serving.profiler",
                 "repro_torch.serving.quality", "repro_torch.serving.http",
                 "repro_torch.compiler.calibrate",
                 "repro_torch.compiler.planner",
                 "repro_torch.compiler.__main__", "repro_torch.kernels.ops",
                 "repro_torch.kernels.autotune", "repro_torch.core.conv",
                 "repro_torch.core.ste", "repro_torch.core.ii_model",
                 "repro_torch.models.cnn", "repro_torch.quant.fake_quant",
                 "repro_torch.optim.adamw", "repro_torch.optim.compression",
                 "repro_torch.runtime.steps", "repro_torch.runtime.trainer",
                 "repro_torch.checkpoint.manager", "repro_torch.launch.train",
                 "repro_torch.pytree"):
        assert name in proc.stdout.split(), name


def test_chip_smoke_alone_fails_without_result(tmp_path):
    """Copied alone into an empty directory (or on a host without CUDA),
    the smoke script exits non-zero and prints no result line."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(alone)], capture_output=True,
                          text=True, cwd=tmp_path, timeout=120,
                          env={"PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
