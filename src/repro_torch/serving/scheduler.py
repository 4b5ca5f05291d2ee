"""Continuous-batching scheduler: FCFS + priority admission, chunked
prefill, prefix-sharing KV reuse, page-fault eviction, cancellation.

Host-side Python, ported almost verbatim from ``repro.serving.scheduler``.

Pure host-side logic — no jax arrays — so the fuzz tests can drive
millions of admit/evict/cancel transitions without touching a model.  The
engine calls :meth:`Scheduler.schedule` once per step and executes the
returned :class:`StepPlan` (swap-outs first, then swap-ins, copy-on-write
clones, one prefill chunk, one batched decode).

Prefix reuse (see ``docs/serving.md``): admission looks the prompt up in
a :class:`~repro_torch.serving.prefix.RadixPrefixIndex`; the longest cached
prefix's pages map read-only into the new request's page table (allocator
refcount +1 per page), a partially-covered page is cloned copy-on-write
into a fresh page before the request may extend it, and chunked prefill
starts at the first uncovered token.  Finished prefills insert their
prompt pages into the index, which holds its own reference per page so
cached prefixes survive request retirement.  When the pool runs dry the
scheduler reclaims LRU index leaves *before* evicting live requests.

Request lifecycle::

    WAITING ──admit (row + prompt pages)──► PREFILL ──last chunk──► RUNNING
       ▲                                       │                      │
       └────────── evicted mid-prefill ◄───────┘     page fault, no   │
                                                     victim available │
    SWAPPED (pages copied to host) ◄──────────────────────────────────┘
       └─────resume (row + pages re-allocated, pages restored)──► RUNNING

Policies (documented in docs/serving.md):

  * **admission** — highest priority first, FIFO within a priority, and
    strictly in order (no skipping past a request that doesn't fit, so a
    large request is never starved by a stream of small ones);
  * **eviction** — a decode-time page fault evicts the lowest-priority,
    most-recently-admitted *other* running request (swap to host); if no
    other request is running the faulting request swaps itself out.  A
    mid-prefill victim is simply restarted (its cache is recomputable);
  * **budgets** — ``max_new_tokens`` bounds every request (checked right
    after prefill too, so a request never overshoots its budget), and the
    engine's ``max_len`` bounds prompt+generation.

Swapping restores pages bit-exactly, so no schedule — however adversarial
— can change a token stream (asserted by ``tests/test_scheduler_fuzz.py``).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Tuple

from repro_torch.serving.kv_cache import HostKV, PageAllocator
from repro_torch.serving.obs import NULL_RECORDER
from repro_torch.serving.prefix import RadixPrefixIndex
from repro_torch.serving.sampling import SamplingParams

# request states
WAITING = "waiting"
PREFILL = "prefill"
RUNNING = "running"
SWAPPED = "swapped"
DONE = "done"


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    priority: int = 0
    # caller-supplied correlation id (HTTP ``X-Request-Id``): opaque to
    # the scheduler, echoed in trace instants and NDJSON final records
    client_request_id: Optional[str] = None
    # per-request stochastic sampling (default: greedy argmax).  Host-side
    # config only — the RNG key is never materialised here: every draw is
    # re-derived from (sampling.seed, len(generated), role) inside the
    # engine's jitted step (serving/sampling.py), so eviction, host swap
    # and re-admission carry the stream state for free.
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    # filled by the engine / scheduler
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    cancelled: bool = False
    state: str = WAITING
    seq: int = -1            # admission-order tiebreak (set at submit)
    row: Optional[int] = None
    pages: List[int] = dataclasses.field(default_factory=list)
    pf_done: int = 0         # prompt tokens already prefilled
    # first `shared_prefix` entries of `pages` are read-only shared prefix
    # pages (refcounted); everything after is this request's to write
    shared_prefix: int = 0
    # (src, dst) of a planned-but-not-yet-executed copy-on-write clone
    cow: Optional[Tuple[int, int]] = None
    host_kv: Optional[HostKV] = None  # swap-out copy while SWAPPED
    # speculative-decoding telemetry (filled by SpeculativeEngine)
    spec_rounds: int = 0     # draft+verify rounds this request took part in
    spec_proposed: int = 0   # draft tokens offered for verification
    spec_accepted: int = 0   # draft tokens the target accepted

    @property
    def next_pos(self) -> int:
        """Cache index the next decode step writes (= tokens written)."""
        return len(self.prompt) + len(self.generated) - 1

    @property
    def acceptance_rate(self) -> float:
        """Fraction of verified draft proposals the target accepted."""
        return self.spec_accepted / max(1, self.spec_proposed)

    def budget_reached(self, max_len: int) -> bool:
        last = self.generated[-1] if self.generated else None
        return (len(self.generated) >= self.max_new_tokens
                or (self.eos_id is not None and last == self.eos_id)
                or len(self.prompt) + len(self.generated) >= max_len)


@dataclasses.dataclass
class PrefillChunk:
    req: Request
    start: int    # tokens already prefilled
    n_valid: int  # real tokens in this chunk


@dataclasses.dataclass
class CowClone:
    """Copy page ``src`` into ``dst`` before ``req``'s prefill chunk runs.

    The scheduler holds an extra reference on ``src`` so it cannot be
    recycled before the copy; the engine performs the device copy then
    calls :meth:`Scheduler.cow_executed` to release it.
    """

    req: Request
    src: int
    dst: int


@dataclasses.dataclass
class StepPlan:
    swap_out: List[Tuple[Request, List[int]]] = dataclasses.field(
        default_factory=list)  # (request, pages to copy out) — pages already
    # released to the allocator; the engine must copy them before any write
    swap_in: List[Request] = dataclasses.field(default_factory=list)
    cow: List[CowClone] = dataclasses.field(default_factory=list)
    prefill: Optional[PrefillChunk] = None
    decode: List[Tuple[int, Request]] = dataclasses.field(
        default_factory=list)  # (row, request)


class Scheduler:
    def __init__(self, *, max_batch: int, allocator: PageAllocator,
                 page_size: int, max_pages_per_seq: int, prefill_chunk: int,
                 max_len: int, lookahead: int = 1, prefix_cache: bool = True,
                 recorder=None):
        self.max_batch = max_batch
        # observability: every hook site is ``if self.obs:``-guarded, so
        # the default NullRecorder costs one truthiness check (obs.py)
        self.obs = recorder if recorder is not None else NULL_RECORDER
        self.alloc = allocator
        self.page_size = page_size
        self.max_pages_per_seq = max_pages_per_seq
        self.prefill_chunk = prefill_chunk
        self.max_len = max_len
        # radix prefix index for shared-prefix KV reuse (None disables)
        self.prefix: Optional[RadixPrefixIndex] = (
            RadixPrefixIndex(allocator, page_size, recorder=self.obs)
            if prefix_cache else None)
        self._cow_pending: List[int] = []  # src pages with a held clone ref
        # tokens a decode step may write per request: 1 for plain decode,
        # k+1 for a speculative verify window (page growth must cover the
        # whole window before the step runs).  Clamped per request by its
        # remaining budget and max_len, so lookahead never demands more
        # pages than ``submit`` proved schedulable.
        self.lookahead = max(1, int(lookahead))
        self.rows: Dict[int, Request] = {}   # row -> PREFILL/RUNNING request
        self.waiting: List[Request] = []
        self.swapped: List[Request] = []
        self._seq = itertools.count()

    # -- submission / cancellation ----------------------------------------
    def submit(self, req: Request) -> None:
        if not req.prompt:
            raise ValueError("empty prompt")
        if len(req.prompt) >= self.max_len:
            raise ValueError(
                f"prompt of {len(req.prompt)} tokens ≥ max_len {self.max_len}")
        total = min(len(req.prompt) + req.max_new_tokens, self.max_len)
        if self._pages_for(total) > self.alloc.num_pages:
            raise ValueError(
                f"request needs {self._pages_for(total)} pages, pool has "
                f"{self.alloc.num_pages} — it could never be scheduled")
        req.seq = next(self._seq)
        req.state = WAITING
        self.waiting.append(req)
        if self.obs:
            self.obs.on_submit(req)

    def cancel(self, uid: int) -> bool:
        """Drop a request wherever it is; frees its row/pages.  Returns
        False when the uid is unknown or already finished."""
        for req in self.waiting:
            if req.uid == uid:
                self.waiting.remove(req)
                return self._mark_cancelled(req)
        for req in self.swapped:
            if req.uid == uid:
                self.swapped.remove(req)
                req.host_kv = None
                return self._mark_cancelled(req)
        for row, req in list(self.rows.items()):
            if req.uid == uid:
                self._release(req)
                return self._mark_cancelled(req)
        return False

    def _mark_cancelled(self, req: Request) -> bool:
        req.state = DONE
        req.cancelled = True
        req.done = True
        if self.obs:
            self.obs.on_cancel(req)
        return True

    # -- per-step planning -------------------------------------------------
    def schedule(self) -> StepPlan:
        plan = StepPlan()
        self._resume(plan)
        self._admit(plan)
        pf = [r for r in self.rows.values() if r.state == PREFILL]
        if pf:
            req = self._ordered(pf)[0]
            n = min(self.prefill_chunk, len(req.prompt) - req.pf_done)
            plan.prefill = PrefillChunk(req, req.pf_done, n)
        for req in self._ordered(
                [r for r in self.rows.values() if r.state == RUNNING]):
            if req.state != RUNNING:
                continue  # evicted by an earlier request's page fault
            # mirrors the speculative engine's verify-window clamp (the
            # -1: emitted tokens keep prompt+generated <= max_len) so no
            # page is reserved that the window can never write
            la = min(self.lookahead, req.max_new_tokens - len(req.generated),
                     self.max_len - req.next_pos - 1)
            if not self._ensure_pages(req, req.next_pos + max(la, 1), plan):
                continue  # swapped itself out
            plan.decode.append((req.row, req))
        plan.decode = [(row, r) for row, r in plan.decode
                       if r.state == RUNNING]
        if plan.prefill is not None and plan.prefill.req.state != PREFILL:
            plan.prefill = None  # chunk's request was evicted by a page fault
        return plan

    def prefill_finished(self, req: Request) -> None:
        """Called by the engine once the last chunk ran and the first token
        was sampled; the request joins the decode batch next step.  Its
        prompt pages are inserted into the prefix index here — the KV for
        every prompt position is now resident and final (prompt slots are
        write-once), so future admissions can map them read-only."""
        req.state = RUNNING
        if self.prefix is not None and not req.cancelled:
            self.prefix.insert(req.prompt, req.pages)

    def cow_executed(self, clone: CowClone) -> None:
        """The engine cloned ``src`` → ``dst``; release the clone ref."""
        self._cow_pending.remove(clone.src)
        self.alloc.free([clone.src])
        clone.req.cow = None

    def retire(self, req: Request) -> None:
        self._release(req)
        req.state = DONE
        req.done = True
        if self.obs:
            self.obs.on_finish(req)

    def live(self) -> List[Request]:
        return (self.waiting + self.swapped + list(self.rows.values()))

    # -- internals ---------------------------------------------------------
    def _pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    @staticmethod
    def _ordered(reqs: List[Request]) -> List[Request]:
        return sorted(reqs, key=lambda r: (-r.priority, r.seq))

    def _free_row(self) -> Optional[int]:
        for row in range(self.max_batch):
            if row not in self.rows:
                return row
        return None

    def _release(self, req: Request) -> None:
        if req.row is not None:
            del self.rows[req.row]
            req.row = None
        if req.pages:
            self.alloc.free(req.pages)
            req.pages = []
        req.shared_prefix = 0
        self._drop_cow(req)

    def _drop_cow(self, req: Request) -> None:
        """A request left the device before its planned clone ran (evicted
        or cancelled in the same plan): release the held src reference.
        The engine skips executing clones whose ``req.cow`` was cleared."""
        if req.cow is not None:
            src = req.cow[0]
            self._cow_pending.remove(src)
            self.alloc.free([src])
            req.cow = None

    def _alloc_reclaim(self, n: int) -> Optional[List[int]]:
        """``alloc``, reclaiming LRU cached prefixes when the pool is dry —
        cached pages are strictly lower value than live requests, so the
        index gives way before any request is evicted."""
        pages = self.alloc.alloc(n)
        if pages is None and self.prefix is not None:
            if self.prefix.evict(n - self.alloc.available):
                pages = self.alloc.alloc(n)
        return pages

    def _resume(self, plan: StepPlan) -> None:
        for req in self._ordered(list(self.swapped)):
            row = self._free_row()
            if row is None:
                break
            need = max(self._pages_for(req.next_pos + 1),
                       req.host_kv.num_pages if req.host_kv else 0)
            pages = self._alloc_reclaim(need)
            if pages is None:
                break  # strict order: don't let later requests jump ahead
            req.pages = pages
            req.row = row
            self.rows[row] = req
            req.state = RUNNING
            self.swapped.remove(req)
            plan.swap_in.append(req)
            if self.obs:
                self.obs.on_resume(req)

    def _admit(self, plan: StepPlan) -> None:
        for req in self._ordered(list(self.waiting)):
            row = self._free_row()
            if row is None:
                break
            # longest cached prefix: full pages map read-only into this
            # request's table; a partially-covered page is cloned
            # copy-on-write; prefill runs only the uncovered tail
            full: List[int] = []
            partial = None
            covered = 0
            if self.prefix is not None:
                full, partial, covered = self.prefix.match(req.prompt)
                # hold references BEFORE any reclaim/alloc below so the
                # matched pages cannot be evicted out from under us
                held = full + ([partial[0]] if partial else [])
                if held:
                    self.alloc.share(held)
            pages = self._alloc_reclaim(
                self._pages_for(len(req.prompt) + 1) - len(full))
            if pages is None:
                if self.prefix is not None and held:
                    self.alloc.free(held)
                break
            req.pages = full + pages
            req.shared_prefix = len(full)
            req.row = row
            self.rows[row] = req
            req.state = PREFILL
            req.pf_done = covered
            if partial is not None:
                # the engine clones src → pages[0] (the table slot right
                # after the shared full pages) before the prefill chunk;
                # the share() above keeps src alive until cow_executed
                clone = CowClone(req, partial[0], pages[0])
                req.cow = (partial[0], pages[0])
                self._cow_pending.append(partial[0])
                plan.cow.append(clone)
            self.waiting.remove(req)
            if self.obs:
                self.obs.on_admit(req)
                if self.prefix is not None:
                    self.obs.on_prefix_lookup(covered, len(full),
                                              partial is not None)

    def _ensure_pages(self, req: Request, n_tokens: int,
                      plan: StepPlan) -> bool:
        """Grow ``req`` until its pages cover ``n_tokens`` cache rows,
        evicting if the pool is dry.  Returns False when ``req`` had to
        swap itself out instead."""
        while len(req.pages) * self.page_size < n_tokens:
            pages = self._alloc_reclaim(1)
            if pages is not None:
                req.pages += pages
                continue
            # Requests resumed in THIS plan are not evictable: their host
            # KV copy hasn't been restored yet, so swapping them out again
            # would gather garbage pages (and land them in both swap_in and
            # swap_out — the engine executes swap-outs first and would read
            # pages whose restore never ran).
            resumed = {r.uid for r in plan.swap_in}
            victims = [r for r in self.rows.values()
                       if r is not req and r.state in (RUNNING, PREFILL)
                       and r.uid not in resumed]
            if not victims:
                self._swap_out(req, plan)
                return False
            self._evict(min(victims, key=lambda r: (r.priority, -r.seq)),
                        plan)
        return True

    def rollback(self, req: Request) -> int:
        """Free a running request's trailing pages past its live prefix.

        After a speculative verify step, positions beyond ``next_pos - 1``
        hold rejected-draft K/V — garbage that the next window's writes
        always precede any read of, so the pages backing *only* garbage
        can be returned to the pool immediately (both the target and the
        draft cache share these page ids).  Keeps ``pages_for(next_pos +
        1)`` so the next write never faults.  Returns the pages freed.
        """
        if req.state != RUNNING or not req.pages:
            return 0
        keep = self._pages_for(req.next_pos + 1)
        extra = req.pages[keep:]
        if extra:
            req.pages = req.pages[:keep]
            self.alloc.free(extra)
            if self.obs:
                self.obs.on_rollback(len(extra))
        return len(extra)

    def _evict(self, victim: Request, plan: StepPlan) -> None:
        if victim.state == PREFILL:
            # recomputable: back to the head of the queue, no swap needed
            self._release(victim)
            victim.state = WAITING
            victim.pf_done = 0
            self.waiting.append(victim)  # seq preserved → re-admits in order
            if self.obs:
                self.obs.on_evict(victim, "restart")
        else:
            self._swap_out(victim, plan)

    def _swap_out(self, req: Request, plan: StepPlan) -> None:
        plan.swap_out.append((req, list(req.pages)))
        self._release(req)
        req.state = SWAPPED
        self.swapped.append(req)
        if self.obs:
            self.obs.on_evict(req, "swap")

    # -- invariants (used by the fuzz tests) --------------------------------
    def check_invariants(self) -> None:
        # refcount conservation: every page's allocator refcount equals
        # the number of holders — request page-table entries, prefix-index
        # nodes, and pending copy-on-write sources — and exactly the
        # zero-ref pages are on the free list
        holds: Dict[int, int] = {}
        for req in self.live():
            for p in req.pages:
                holds[p] = holds.get(p, 0) + 1
        if self.prefix is not None:
            for p in self.prefix.pages_held():
                holds[p] = holds.get(p, 0) + 1
        for p in self._cow_pending:
            holds[p] = holds.get(p, 0) + 1
        free = self.alloc.free_pages()
        for p in range(self.alloc.num_pages):
            ref = self.alloc.refcount(p)
            assert ref == holds.get(p, 0), (
                f"page {p}: refcount {ref} != {holds.get(p, 0)} holders")
            assert (ref == 0) == (p in free), (
                f"page {p}: refcount {ref} but free={p in free}")
        # copy-on-write never aliases a writer: a physical page sits in
        # at most one request's *writable* region (everything past its
        # read-only shared prefix) — sharers clone before writing
        writers: Dict[int, int] = {}
        for req in self.rows.values():
            for p in req.pages[req.shared_prefix:]:
                writers[p] = writers.get(p, 0) + 1
        for p, n in writers.items():
            assert n <= 1, f"page {p} is writable by {n} requests"
        for row, req in self.rows.items():
            assert req.row == row and req.state in (PREFILL, RUNNING)
        for req in self.waiting + self.swapped:
            assert req.row is None
            assert not req.pages, "queued request still holds pages"
            assert req.cow is None, "queued request has a pending clone"
