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
  * **retention** — the last ``keep`` checkpoints stay;
  * **on a mesh** (``par``, a ``ParallelContext`` the ``Trainer`` sets) —
    the tree is a rank's shards of a train state: ``save`` gathers it
    whole leaf by leaf on the device, rank 0 alone copies each leaf to
    the host and writes it in the same format, and every rank learns in
    :meth:`wait` whether that write failed; ``restore`` reads one whole
    leaf at a time and keeps this rank's shard of it.

Leaves are in JAX's flatten order (``repro_torch.pytree``): a checkpoint
written by either package restores in the other.  ``bfloat16`` leaves are
read as raw ``uint16`` viewed as ``torch.bfloat16``; nothing here needs
``ml_dtypes``.
"""
from __future__ import annotations

import functools
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
from repro_torch.distributed.sharding import take_shard

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
        self.par = None  # on a mesh: its ParallelContext (set by the Trainer)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _writes(self) -> bool:
        """Whether this process writes (rank 0 of a mesh)."""
        par = self.par
        return par is None or (par.dp_rank == 0 and par.tp_rank == 0)

    def _whole(self, tree: Tree) -> Tree:
        """On a mesh: ``tree``'s leaves gathered whole one at a time on the
        device (every rank takes part); the writer keeps each on the host,
        the other ranks keep nothing."""
        par, keep = self.par, self._writes()

        def one(path, t, spec):
            whole = par.unshard(t, spec, parts=par.parts(path))
            return whole.to("cpu", copy=True) if keep else None

        with torch.no_grad():
            return T.map_with_path(one, tree, par.state_specs(tree))

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Tree, blocking: bool = False) -> None:
        """Snapshot to host now, then write (asynchronously unless
        ``blocking``) with an atomic rename.  On a mesh every rank calls
        this with its shards, and rank 0 writes the whole tree; a blocking
        save returns on every rank once that write is committed."""
        if self.par is not None:
            tree = self._whole(tree)
        host = [(k, _host_bytes(t), list(t.shape), _NAMES[t.dtype])
                for k, t in ((k, torch.as_tensor(v)) for k, v in
                             T.leaves_with_paths(tree))
                ] if self._writes() else None
        self.wait()  # one writer at a time
        if host is not None:
            self._thread = threading.Thread(target=self._run,
                                            args=(step, host), daemon=True)
            self._thread.start()
        if blocking:
            self.wait()

    def _run(self, step: int, host: list) -> None:
        try:
            self._write(step, host)
        except BaseException as e:  # surfaced by the next wait()
            self._error = e

    def _write(self, step: int, host: list) -> None:
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

    def wait(self) -> None:
        """Join the writer; a failed write raises here.  On a mesh every
        rank then learns whether rank 0's write failed (one flag summed
        over the world, which also holds every rank until the writer is
        done) and raises if it did, so all of them recover together."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        if (self.par is not None and self.par.comm.any_rank(err is not None)
                and err is None):
            err = RuntimeError("rank 0 failed to write a checkpoint")
        if err is not None:
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
        """The checkpoint of ``step`` (default: the latest) in
        ``template``'s tree (see :func:`restore_into`).  On a mesh
        ``template`` holds a rank's shards of a train state, and each whole
        leaf read is cut to this rank's shard before the next is read."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = self.dir / f"step_{step:08d}"
        cuts = None
        if self.par is not None:
            par = self.par
            cuts = T.leaves(T.map_with_path(
                lambda p, t, spec: functools.partial(
                    take_shard, spec=spec, mesh=par.mesh,
                    parts=par.parts(p)),
                template, par.state_specs(template)))
        return restore_into(template, path, device=device, cuts=cuts)


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


def restore_into(template: Tree, path, device=None, cuts=None) -> Tree:
    """Rebuild ``template``'s tree from the checkpoint at ``path``.

    Template leaves are tensors (``meta`` ones will do, with ``device``);
    each loaded leaf takes the template leaf's dtype, and ``device`` or
    else the template leaf's device.  ``cuts`` (one function per leaf, in
    flatten order) maps each leaf read to the part kept, e.g. a rank's
    shard, which the template leaf then shapes.  A leaf count or shape
    that differs raises."""
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
        if cuts is not None:
            loaded = cuts[i](loaded)
        if tuple(loaded.shape) != tuple(tmpl.shape):
            raise ValueError(f"leaf {meta['path']}: shape mismatch "
                             f"{tuple(loaded.shape)} vs {tuple(tmpl.shape)}")
        out.append(loaded.to(device=device if device is not None
                             else tmpl.device, dtype=tmpl.dtype))
    return T.unflatten_like(template, out)
