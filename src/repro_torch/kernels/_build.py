"""Build and bind the CUDA kernels: ``nvcc`` into shared libraries with a
plain C interface, loaded with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own, all of them in parallel, at
the first use of any kernel::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
        -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

into ``src/repro_torch/_build/`` (listed in ``.gitignore``); the hash
covers the sources and the flags, so an edit rebuilds.  A build that fails
raises: there is no fallback.  Every C entry point returns
``cudaGetLastError()`` after its launches, and :func:`check` raises when it
is not 0.  Nothing here runs at import: the CPU tests import every module.

``python -m repro_torch.kernels._build`` builds every kernel with ptxas's
report (registers, shared memory and spills of each kernel instance).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import torch

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("fused_lutmu", "maddness_encode", "lut_aggregate", "verify_window")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# dtype codes shared with csrc/common.cuh::DType
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.int16: 3}

_VP, _CI = ctypes.c_void_p, ctypes.c_int
# each library's C entry point: name and argument types (pointers and the
# stream as c_void_p, so ctypes never cuts them to 32 bits)
ENTRY_POINTS = {
    "fused_lutmu": ("fused_lutmu_launch",
                    [_VP, _VP, _VP, _CI, _VP, _CI, _VP, _CI, _VP, _CI, _CI,
                     _CI, _CI, _CI, _CI, _CI, _CI, _CI, _VP]),
    "maddness_encode": ("encode_onehot_launch",
                        [_VP, _VP, _VP, _CI, _CI, _CI, _CI, _CI, _CI, _CI,
                         _CI, _VP]),
    "lut_aggregate": ("lut_aggregate_launch",
                      [_VP, _CI, _VP, _CI, _VP, _CI, _VP, _CI, _VP, _VP, _CI,
                       _CI, _CI, _CI, _CI, _VP]),
    "verify_window": ("verify_window_launch",
                      [_VP, _VP, _VP, _CI, _VP, _VP, _VP, _VP, _CI, _CI, _CI,
                       _CI, _CI, _CI, _CI, _CI, _CI, _CI, _CI, _VP]),
}
# further C functions of a library: name and argument types
QUERIES = {
    "fused_lutmu": ("fused_lutmu_max_clusters", [_CI] * 8),
    "verify_window": ("verify_window_max_clusters", [_CI] * 8),
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


# every LaunchCount made, so a captured program can replay their counts
_COUNTERS: List["LaunchCount"] = []


class LaunchCount:
    """A plain launch counter: a wrapper bumps it once per call that
    launched its kernel, and nowhere else.  A wrapper's bump runs in Python,
    so inside a captured CUDA graph it runs at capture and not at replay:
    :class:`CapturedLaunches` carries the counts over to the replays."""

    def __init__(self) -> None:
        self.n = 0
        _COUNTERS.append(self)

    def bump(self) -> None:
        self.n += 1

    def reset(self) -> None:
        self.n = 0


def launch_counts() -> Dict[LaunchCount, int]:
    """Every registered counter's count now."""
    return {c: c.n for c in _COUNTERS}


class CapturedLaunches:
    """The launches of one captured program, counted once per replay.

    Runs ``warm_up()`` then ``capture()``: the counters' deltas over the
    capture are what one replay launches; the counts of both runs are taken
    back out (also when either raises), since neither is a step the caller
    asked for.  :meth:`replay` adds the deltas."""

    def __init__(self, warm_up: Callable[[], None],
                 capture: Callable[[], None]) -> None:
        before = launch_counts()
        try:
            warm_up()
            mid = launch_counts()
            capture()
            after = launch_counts()
        finally:
            for c, n in before.items():
                c.n = n
        self.deltas = [(c, n - mid.get(c, 0)) for c, n in after.items()
                       if n != mid.get(c, 0)]

    def replay(self) -> None:
        for c, d in self.deltas:
            c.n += d


def nvcc_path() -> str:
    cands = [os.path.join(os.environ[v], "bin", "nvcc")
             for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "cannot be built")


def _lib_path(name: str, extra: Sequence[str] = ()) -> Path:
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *extra)).encode())
    for src in (SRC_DIR / "common.cuh", SRC_DIR / f"{name}.cu"):
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES, extra: Sequence[str] = (),
          log: bool = False) -> Dict[str, Path]:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all started together, with ``extra`` flags after the
    standard ones; ``log`` prints each compiler's output.  Returns name →
    library path."""
    paths = {n: _lib_path(n, extra) for n in names}
    todo = {n: p for n, p in paths.items() if not p.is_file()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-I", str(SRC_DIR), "-o", str(tmp),
               str(SRC_DIR / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log_text, _ = proc.communicate()
        if log:
            print(f"--- {n} ---\n{log_text}", flush=True)
        if proc.returncode != 0:
            failed.append(f"--- {n} (nvcc rc {proc.returncode}) ---\n{log_text}")
            continue
        os.replace(tmp, todo[n])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (building every missing
    kernel first)."""
    with _LOCK:
        if name not in _LIBS:
            paths = build(n for n in SOURCES if n not in _LIBS)
            for n, p in paths.items():
                lib = ctypes.CDLL(str(p))
                lib.repro_error_string.argtypes = [ctypes.c_int]
                lib.repro_error_string.restype = ctypes.c_char_p
                fn_name, argtypes = ENTRY_POINTS[n]
                fn = getattr(lib, fn_name)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
                if n in QUERIES:
                    q_name, q_args = QUERIES[n]
                    qfn = getattr(lib, q_name)
                    qfn.argtypes, qfn.restype = q_args, ctypes.c_int
                _LIBS[n] = lib
        return _LIBS[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU, False when all lie on one
    CUDA device; anything else raises (a wrapper never moves data)."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def require_contiguous(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        require(t.is_contiguous(), f"{name} must be contiguous")


def epilogue_args(t: torch.Tensor, n: int, name: str):
    """A ``()`` or ``(N,)`` float32 scale/offset → (pointer, stride)."""
    require(t.dtype == torch.float32, f"{name} must be float32, got {t.dtype}")
    require(t.numel() in (1, n) and t.dim() <= 1,
            f"{name} must have shape () or ({n},), got {tuple(t.shape)}")
    require_contiguous(**{name: t})
    return ctypes.c_void_p(t.data_ptr()), int(t.numel() == n and n != 1)


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def sm_count(device: Optional[torch.device] = None) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


if __name__ == "__main__":
    # python -m repro_torch.kernels._build: build every kernel with ptxas's
    # report (registers, shared memory, spills of each kernel instance)
    build(extra=("-Xptxas", "-v"), log=True)
