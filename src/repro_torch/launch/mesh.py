"""Serving and training meshes (PyTorch), as in ``repro.launch.mesh``: one
process (rank) per device, grouped into a ``data × model`` ``DeviceMesh``.

A CUDA mesh runs NCCL and a CPU mesh gloo; nothing falls back from one to
the other.  ``make_serve_mesh`` is strict: the world must hold exactly
D·M ranks (``torchrun --nproc-per-node D·M`` starts them), and a world of
one needs no launcher (a file store in a temporary directory).

The production meshes (16×16, 2×16×16) cannot be built on one host:
:func:`make_production_mesh` describes their shape for the rule engine
(``distributed/sharding.py``).  :func:`make_host_mesh` is the lenient
small mesh of tests and examples.
"""
from __future__ import annotations

import os
import tempfile
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import AbstractMesh


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The production mesh's shape: (16, 16) over ``("data", "model")``, or
    (2, 16, 16) over ``("pod", "data", "model")``."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def make_host_mesh(data: int = 1, model: int = 1, device="cpu", **init):
    """A small ``data × model`` mesh over the ranks that exist (tests and
    examples; JAX's ``make_host_mesh``): a shape asking for more ranks
    than the world holds falls back to ``(world, 1)``, and a smaller one
    takes the first ``data·model`` ranks (the others get no coordinate).
    The process group is joined if needed (``init`` goes to
    :func:`init_distributed`)."""
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve_device(device)
    init_distributed(dev, **init)
    n = dist.get_world_size()
    if data * model > n:
        data, model = n, 1
    return DeviceMesh(dev.type, torch.arange(data * model).reshape(
        data, model), mesh_dim_names=("data", "model"))


def parse_mesh_spec(spec: str):
    """``"DxM"`` (data × model) → ``(data, model)``; raises on junk (the
    parser every mesh-taking CLI shares)."""
    try:
        data, model = (int(v) for v in spec.lower().split("x"))
    except ValueError:
        raise ValueError(
            f"mesh spec must be 'DxM' (e.g. 2x4), got {spec!r}") from None
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be positive, got {spec!r}")
    return data, model


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def init_distributed(device="cuda", *, init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> None:
    """Join (or check) the default process group on ``device``'s backend.

    Rank and world size come from the arguments, else ``RANK`` /
    ``WORLD_SIZE`` (torchrun sets them, with ``MASTER_ADDR``/``PORT`` for
    ``env://``).  A world of one with neither needs no launcher: it meets in
    a file store in a temporary directory.  A CUDA rank binds the card
    ``LOCAL_RANK`` (else its rank modulo the card count).
    """
    dev = resolve_device(device)
    want = _backend(dev)
    if dist.is_initialized():
        have = dist.get_backend()
        if have != want:
            raise ValueError(f"the process group runs {have!r}, a "
                             f"{dev.type} mesh needs {want!r}")
        return
    rank = int(os.environ.get("RANK", 0)) if rank is None else int(rank)
    world = (int(os.environ.get("WORLD_SIZE", 1)) if world_size is None
             else int(world_size))
    if init_method is None:
        if "MASTER_ADDR" in os.environ:
            init_method = "env://"
        elif world == 1:
            store = os.path.join(tempfile.mkdtemp(prefix="repro_mesh_"),
                                 "store")
            init_method = f"file://{store}"
        else:
            raise ValueError(
                f"a world of {world} ranks needs a launcher (torchrun sets "
                "MASTER_ADDR) or an explicit init_method")
    kwargs = {}
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        kwargs["device_id"] = torch.device("cuda", local)
    dist.init_process_group(want, init_method=init_method, rank=rank,
                            world_size=world, **kwargs)


def make_serve_mesh(spec: str, device="cuda", **init):
    """Parse a ``"DxM"`` mesh spec (serving, or the training launcher's
    production mesh) into a ``DeviceMesh`` with dims
    ``("data", "model")`` over the process group (joined here if needed;
    ``init`` goes to :func:`init_distributed`).  Strict: a world of another
    size than D·M raises rather than serving on another topology than the
    operator asked for."""
    from torch.distributed.device_mesh import init_device_mesh

    data, model = parse_mesh_spec(spec)
    dev = resolve_device(device)
    joined = not dist.is_initialized()
    init_distributed(dev, **init)
    n = dist.get_world_size()
    if data * model != n:
        if joined:  # leave no group behind a refused mesh
            dist.destroy_process_group()
        raise ValueError(
            f"mesh {data}x{model} needs {data * model} ranks, the world has "
            f"{n} (hint: torchrun --nproc-per-node {data * model} starts "
            "D·M ranks)")
    return init_device_mesh(dev.type, (data, model),
                            mesh_dim_names=("data", "model"))

