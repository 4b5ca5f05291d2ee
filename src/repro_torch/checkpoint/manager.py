"""Checkpointing: async, atomic, in the JAX package's on-disk format (as
``repro.checkpoint.manager``).

  * **save** — the leaves are copied to host memory at once (a clone: the
    in-place optimizer overwrites the live tensors on the next step), then
    written on a background thread into ``step_XXXXXXXX.tmp`` as
    ``leaves.npz`` (each leaf's raw bytes) plus ``manifest.json`` (path,
    shape, dtype per leaf, and the step), and renamed atomically, so a
    crash mid-write never corrupts the latest checkpoint;
  * **restore** — :func:`restore_into` rebuilds a template's tree from
    disk on each template leaf's device and dtype;
  * **retention** — the last ``keep`` checkpoints stay.

Leaves are in JAX's flatten order (``repro_torch.pytree``): a checkpoint
written by either package restores in the other.  ``bfloat16`` leaves are
read as raw ``uint16`` viewed as ``torch.bfloat16``; nothing here needs
``ml_dtypes``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import pytree as T

Tree = Any

# torch dtype ↔ the numpy name the manifest records
_NAMES = {torch.float32: "float32", torch.float64: "float64",
          torch.float16: "float16", torch.bfloat16: "bfloat16",
          torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
          torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool"}
_DTYPES = {v: k for k, v in _NAMES.items()}


def _host_bytes(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as raw bytes (owning its memory)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    arr = t.to("cpu", copy=True).contiguous().numpy()
    return np.frombuffer(arr.tobytes(), np.uint8)


class CheckpointManager:
    def __init__(self, directory, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Tree, blocking: bool = False) -> None:
        """Snapshot to host now, then write (asynchronously unless
        ``blocking``) with an atomic rename."""
        flat = T.leaves_with_paths(tree)
        host = [(k, _host_bytes(torch.as_tensor(v)), list(torch.as_tensor(
            v).shape), _NAMES[torch.as_tensor(v).dtype]) for k, v in flat]
        self.wait()  # one writer at a time

        def _write():
            tmp = self.dir / f"step_{step:08d}.tmp"
            final = self.dir / f"step_{step:08d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir()
            np.savez(tmp / "leaves.npz",
                     **{f"leaf_{i}": h[1] for i, h in enumerate(host)})
            manifest = {
                "step": step,
                "time": time.time(),
                "leaves": [{"path": k, "shape": shape, "dtype": dt}
                           for k, _, shape, dt in host],
            }
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)  # atomic commit
            self._gc()

        if blocking:
            _write()
            return

        def _run():
            try:
                _write()
            except BaseException as e:  # surfaced by the next wait()
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the writer; a failed write raises here."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _ckpts(self):
        return [c for c in sorted(self.dir.glob("step_*"))
                if not c.name.endswith(".tmp")]

    def _gc(self) -> None:
        for old in self._ckpts()[: -self.keep]:
            shutil.rmtree(old)

    # -- restore --------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        ckpts = self._ckpts()
        return int(ckpts[-1].name.split("_")[1]) if ckpts else None

    def restore(self, template: Tree, step: Optional[int] = None,
                device=None) -> Tree:
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        return restore_into(template, self.dir / f"step_{step:08d}",
                            device=device)


def _load_leaf(raw: np.ndarray, meta: dict) -> torch.Tensor:
    name = meta["dtype"]
    if name not in _DTYPES:
        raise ValueError(f"unsupported checkpoint dtype {name!r}")
    if name == "bfloat16":
        arr = np.frombuffer(raw.tobytes(), np.uint16).copy()
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.frombuffer(raw.tobytes(),
                                           np.dtype(name)).copy())
    return t.reshape(meta["shape"])


def restore_into(template: Tree, path, device=None) -> Tree:
    """Rebuild ``template``'s tree from the checkpoint at ``path``.

    Template leaves are tensors (``meta`` ones will do, with ``device``);
    each loaded leaf takes the template leaf's dtype, and ``device`` or
    else the template leaf's device.  A leaf count or shape that differs
    raises."""
    path = Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    data = np.load(path / "leaves.npz")
    metas = manifest["leaves"]
    flat_t = T.leaves(template)
    if len(flat_t) != len(metas):
        raise ValueError(
            f"template has {len(flat_t)} leaves, checkpoint {len(metas)}")
    out = []
    for i, (tmpl, meta) in enumerate(zip(flat_t, metas)):
        loaded = _load_leaf(data[f"leaf_{i}"], meta)
        if tuple(loaded.shape) != tuple(tmpl.shape):
            raise ValueError(f"leaf {meta['path']}: shape mismatch "
                             f"{tuple(loaded.shape)} vs {tuple(tmpl.shape)}")
        out.append(loaded.to(device=device if device is not None
                             else tmpl.device, dtype=tmpl.dtype))
    return T.unflatten_like(template, out)
