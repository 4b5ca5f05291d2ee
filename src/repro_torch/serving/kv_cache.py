"""Paged KV cache: fixed-size pages, a free-list allocator, per-request
page tables, and host swap for preempted requests.

The allocator is host-side Python ported verbatim from
``repro.serving.kv_cache``; the buffers are torch tensors on the engine's
device, updated in place (the model writes each step's K/V into them).

Layout: one physical buffer per K and V, ``(L, P_total, page_size, n_kv,
hd)`` with ``P_total = ceil((P+1) / pad_to) · pad_to``.  Physical pages
``0..P-1`` are allocatable; the **last** page is the *trash page* —
scatter targets for padding tokens and for the batch rows that have no
active request point there, so the batched gather/scatter never needs a
dynamic shape or a branch; the pages between are padding, never
allocated.  Logical position ``t`` of a request lives at
``(page_table[t // page_size], t % page_size)``.

On a mesh with more than one data rank (``par``) the engine pads to the
data degree and each rank holds its shard of the pages, JAX's
``paged_cache_shardings``: the ``P_total / dp`` pages from ``rank ·
P_total / dp`` on, plus one *write-sink* page of its own, where its writes
to pages other ranks hold land (never read).  Page ids stay global, and
the allocator hands out the ids it hands out on one device.  A
copy-on-write clone between pages of two ranks and a swap-in to pages of
other ranks than the swap-out's cross ranks through the mesh.

The allocator is deliberately host-side and strict: double-frees and
foreign pages raise ``PageError`` (the scheduler fuzz tests drive random
admit/evict/cancel traces through it and assert the pool is conserved).
Pages are **refcounted** so several requests (and the scheduler's radix
prefix index) can map the same physical page read-only: ``alloc`` hands a
page out at refcount 1, ``share`` increments, ``free`` decrements, and a
page only returns to the free list when its count reaches zero.  Writers
never touch a page they merely share — the scheduler plans a
copy-on-write ``clone_page`` into a freshly allocated page instead.

Swap: evicting a request under page pressure copies its pages to host
(``gather_host``) before the allocator hands them to someone else; resume
re-allocates and writes the copies back (``scatter_host``) — bit-exact
restore, so preemption cannot change a token stream.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Set

import numpy as np
import torch

from repro_torch.models import model as MD
from repro_torch.models.config import ModelConfig
from repro_torch.serving.obs import NULL_RECORDER


class PageError(RuntimeError):
    """Allocator misuse: double free, foreign page, or negative request."""


class PageAllocator:
    """Refcounted free-list allocator over ``num_pages`` fixed-size pages.

    ``alloc`` is all-or-nothing (returns ``None`` when the request cannot
    be satisfied — the scheduler then evicts or waits) and hands pages out
    at refcount 1.  ``share`` increments the count of an already-live page
    (prefix reuse: a second request — or the prefix index itself — maps
    the page read-only).  ``free`` decrements and only returns a page to
    the free list when its count reaches zero; it still validates every
    page so leaks, over-frees and foreign pages surface as ``PageError``
    instead of silent cache corruption.
    """

    def __init__(self, num_pages: int, *, recorder=None):
        if num_pages < 1:
            raise ValueError(f"need at least one page, got {num_pages}")
        self.num_pages = num_pages
        self._free: Deque[int] = deque(range(num_pages))
        self._free_set: Set[int] = set(range(num_pages))
        self._ref: List[int] = [0] * num_pages
        # observability hooks (obs.py); the default NullRecorder is falsy
        # so each hook site costs one truthiness check when disabled
        self.obs = recorder if recorder is not None else NULL_RECORDER

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.num_pages - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        if n < 0:
            raise PageError(f"cannot allocate {n} pages")
        if n > len(self._free):
            if self.obs:
                self.obs.on_alloc_fail(n)
            return None
        pages = [self._free.popleft() for _ in range(n)]
        self._free_set.difference_update(pages)
        for p in pages:
            self._ref[p] = 1
        if self.obs:
            self.obs.on_alloc(n)
        return pages

    def share(self, pages: List[int]) -> None:
        """Take an extra reference on live pages (prefix reuse)."""
        for p in pages:
            if not 0 <= p < self.num_pages:
                raise PageError(f"page {p} is not part of this pool")
            if self._ref[p] < 1:
                raise PageError(f"cannot share free page {p}")
        for p in pages:
            self._ref[p] += 1

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if not 0 <= p < self.num_pages:
                raise PageError(f"page {p} is not part of this pool")
            if p in self._free_set or self._ref[p] < 1:
                raise PageError(f"double free of page {p}")
        released = 0
        for p in pages:
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)
                self._free_set.add(p)
                released += 1
        if self.obs and released:
            self.obs.on_free(released)

    def refcount(self, page: int) -> int:
        if not 0 <= page < self.num_pages:
            raise PageError(f"page {page} is not part of this pool")
        return self._ref[page]

    def is_shared(self, page: int) -> bool:
        return self.refcount(page) > 1

    def free_pages(self) -> Set[int]:
        """Snapshot of the free set (for invariant checks)."""
        return set(self._free_set)


@dataclasses.dataclass
class HostKV:
    """Host-side copy of a swapped-out request's pages (k/v per layer).
    On a cut pool a rank copies the pages it holds: ``held`` lists their
    positions among the ``total`` pages swapped."""

    k: torch.Tensor  # (L, n_pages, page_size, n_kv, hd), on the CPU
    v: torch.Tensor
    held: Optional[List[int]] = None
    total: Optional[int] = None

    @property
    def num_pages(self) -> int:
        return int(self.k.shape[1]) if self.total is None else self.total


class PagedKVCache:
    """Device-resident paged K/V buffers plus the page-pool allocator.

    ``buffers`` is a ``{"k","v"}`` dict with a leading layer axis; the
    model's prefill and decode write into it in place.
    """

    def __init__(self, cfg: ModelConfig, *, num_pages: int, page_size: int,
                 dtype=torch.float32, pad_to: int = 1, device="cuda",
                 allocator: Optional[PageAllocator] = None, recorder=None,
                 par=None):
        """``dtype`` is the page type (float, bfloat16, or int8 for the
        quantised cache).  ``cfg``'s kv-head count is the page's (a rank's
        local heads under attention TP).  ``pad_to`` rounds the physical
        page count up to a multiple (the engine passes the data degree).
        ``allocator`` shares another cache's page pool: the speculative
        engine mirrors its target cache with a draft cache of identical
        geometry, and one page id must address the same logical slot in
        both (one page table, one scheduler, two physical pools).  ``par``
        (a ``ParallelContext`` with more than one data rank) keeps only
        this rank's shard of the pages."""
        if not MD.supports_paged(cfg):
            raise ValueError(
                f"family {cfg.family!r} has no paged KV layout")
        if allocator is not None and allocator.num_pages != num_pages:
            raise ValueError(
                f"shared allocator manages {allocator.num_pages} pages, "
                f"mirror cache asked for {num_pages}")
        self.cfg = cfg
        self.num_pages = num_pages
        self.page_size = page_size
        self.obs = recorder if recorder is not None else NULL_RECORDER
        self.allocator = allocator or PageAllocator(num_pages,
                                                    recorder=recorder)
        # +1 physical page for the trash page, then the physical count up
        # to a multiple of ``pad_to`` so the page axis divides the mesh;
        # the trash page is always the LAST physical page
        total = -(-(num_pages + 1) // pad_to) * pad_to
        self.trash = total - 1
        self.par = par if par is not None and par.pool_cut else None
        if self.par is not None and total % self.par.dp:
            raise ValueError(f"{total} physical pages do not cut over "
                             f"{self.par.dp} data ranks (pad_to)")
        # pages this rank holds (all of them off a cut pool); a cut pool's
        # shard has one more, its write sink
        self.held = total if self.par is None else total // self.par.dp
        self.buffers: Dict[str, torch.Tensor] = MD.init_paged_cache(
            cfg, self.held + (self.par is not None), page_size, dtype,
            device)

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` cache rows."""
        return -(-n_tokens // self.page_size)

    def page_row(self, pages: List[int], max_pages: int) -> np.ndarray:
        """A request's page-table row, padded with the trash page."""
        row = np.full((max_pages,), self.trash, np.int32)
        row[: len(pages)] = pages
        return row

    def _held(self, pages: List[int]):
        """The pages of ``pages`` this rank holds (all of them off a cut
        pool): their positions in ``pages`` and their local indices."""
        if self.par is None:
            return list(range(len(pages))), torch.as_tensor(
                pages, dtype=torch.int64, device=self.buffers["k"].device)
        placed = [self.par.pool_place(p, self.held) for p in pages]
        pos = [i for i, (mine, _) in enumerate(placed) if mine]
        return pos, torch.as_tensor([placed[i][1] for i in pos],
                                    dtype=torch.int64,
                                    device=self.buffers["k"].device)

    def clone_page(self, src: int, dst: int) -> None:
        """Copy-on-write: duplicate physical page ``src`` into ``dst``
        (all layers, k and v), in place.  On a cut pool every rank calls
        it (the host schedule is the same on every rank): the page goes
        from the rank holding ``src`` to the one holding ``dst`` through a
        bitwise sum over ``data`` (``ParallelContext.pool_sum``)."""
        if self.par is None:
            for buf in self.buffers.values():
                buf[:, dst] = buf[:, src]
        else:
            mine_src, l_src = self.par.pool_place(src, self.held)
            mine_dst, l_dst = self.par.pool_place(dst, self.held)
            for buf in self.buffers.values():
                page = self.par.pool_sum(
                    buf[:, l_src] if mine_src else torch.zeros_like(
                        buf[:, 0]), False)
                if mine_dst:
                    buf[:, l_dst] = page
        if self.obs:
            k = self.buffers["k"]
            self.obs.on_cow_clone(2 * k[:, 0].numel() * k.element_size())

    def gather_host(self, pages: List[int]) -> HostKV:
        """Copy the given physical pages to host (swap-out): on a cut pool
        those this rank holds."""
        mine, idx = self._held(pages)
        host = HostKV(k=self.buffers["k"][:, idx].cpu(),
                      v=self.buffers["v"][:, idx].cpu())
        if self.par is not None:
            host.held, host.total = mine, len(pages)
        if self.obs:
            self.obs.on_swap_bytes("out", 2 * host.k.numel() * host.k.element_size())
        return host

    def scatter_host(self, host: HostKV, pages: List[int]) -> None:
        """Write a host copy back into (newly allocated) pages (swap-in).
        On a cut pool every rank calls it: each puts the pages it copied
        out into a device buffer of the swapped set, zeros elsewhere, the
        buffers are summed over ``data`` bitwise, and each rank writes the
        new pages it holds."""
        if len(pages) < host.num_pages:
            raise PageError(
                f"swap-in needs {host.num_pages} pages, got {len(pages)}")
        if self.obs:
            self.obs.on_swap_bytes("in", 2 * host.k.numel() * host.k.element_size())
        mine, idx = self._held(pages[: host.num_pages])
        for name, src in (("k", host.k), ("v", host.v)):
            buf = self.buffers[name]
            src = src.to(device=buf.device, dtype=buf.dtype)
            if self.par is not None:
                whole = buf.new_zeros((buf.shape[0], host.total)
                                      + tuple(buf.shape[2:]))
                whole[:, host.held] = src
                src = self.par.pool_sum(whole, False)[:, mine]
            buf[:, idx] = src
