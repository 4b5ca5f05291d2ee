"""Speculative decoding: a low-resolution LUT-MU draft proposes, the
full-resolution target verifies, as in ``repro.serving.speculative`` —
greedy streams equal to the plain engine's, sampled streams distributed as
plain sampling from the target.

Round structure (one :meth:`SpeculativeEngine.step`):

1. **draft** — ``models/model.py::paged_draft_loop`` runs ``k`` decode
   steps of the draft model over the whole decode batch (plus one
   write-only step), writing the draft's own paged KV cache; a sampled
   round draws each proposal from the draft's post-transform distribution
   ``q`` on the ``ROLE_DRAFT`` stream;
2. **verify** — ``models/model.py::paged_verify_step`` feeds each row's
   last emitted token plus its ``k`` proposals at positions
   ``next_pos .. next_pos+k`` and returns per-position logits; the
   ``fused`` backend runs one verify-window attention per layer (the CUDA
   kernel ``csrc/verify_window.cu`` on the card);
3. **accept** — greedy: proposal ``j`` is accepted while it equals the
   target's argmax after the prefix before it, and the target's token at
   the first mismatch (the correction) or after the whole window (the
   bonus) is emitted too.  Sampled: the rejection-sampling correction
   ``sampling.py::speculative_accept`` on the target's distribution ``p``
   (accept with probability ``min(1, p/q)``, resample the first rejection
   from ``max(p - q, 0)``, the bonus from ``p`` on the plain engine's own
   stream).  Each request gains 1 to ``k+1`` tokens per round;
4. **rollback** — positions past the accepted prefix hold rejected-draft
   K/V in both caches.  The next window starts at the first rejected
   position and every paged write precedes every read of the same
   position, so that garbage is overwritten before it is attended to;
   pages backing only garbage go back to the pool
   (``scheduler.Scheduler.rollback``).

Each round is one step program, and so is each prefill chunk through both
models (``serving/programs.py``; JAX ``_round``, ``_round_greedy`` and
``_prefill_pair``): on the card one CUDA-graph replay each.  The program
functions are :func:`sampled_round`, :func:`greedy_round` and
:func:`prefill_pair`.  A round whose rows are all greedy runs
``round_greedy``, any other ``round``, as JAX picks on the host; the
greedy round gives the tokens the sampled one gives at T = 0.  Every
uniform of a sampled round depends on ``(seed, t0 + j, role)`` only, never
on a drafted token, so one batched hash draws them all before the draft
loop (``sampling.py::round_uniforms``).

Both models share one scheduler, one page allocator and one page table;
the draft's cache mirrors the target's pool (``PagedKVCache(allocator=…)``),
so admission, chunked prefill, eviction with host swap, copy-on-write
prefix sharing and cancellation all come from the plain engine, applied to
both caches.

With a recorder (``recorder=``, as the plain engine), each round records
the JAX engine's speculative telemetry: a ``spec-round`` span, the round
by program (``spec_rounds_total{path=greedy|sampled}``), per-row
proposals, acceptances, corrections and bonuses, the emitted tokens, and
pages freed by rollback; the draft cache's swap and copy-on-write bytes
count too.  ``stats`` stays a dict and counts the same whether or not a
recorder is attached.

A compiled target+draft bundle (``compiler/artifact.py::load_bundle``) or a
pair of ``amm_lm`` artifacts is served through :meth:`_from_bundle` /
:meth:`_from_artifacts`: both halves are spliced into the one dense tree
they were compiled against (they share the backbone; only the LUT tables
differ).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.annotate import NO_RANGE
from repro_torch.compiler.artifact import load_bundle
from repro_torch.models import model as MD
from repro_torch.models.config import ModelConfig
from repro_torch.serving.engine import (ServeEngine, _profiled_call,
                                        _splice_artifact)
from repro_torch.serving import sampling as S
from repro_torch.serving.kv_cache import HostKV, PagedKVCache
from repro_torch.serving.profiler import tree_bytes
from repro_torch.serving.scheduler import Request

Tensor = torch.Tensor

# cfg fields that must agree between target and draft: both models route
# through one page table and one verify window, so KV geometry and the
# token space are load-bearing (LUT/AMM settings are free to differ — that
# difference is the draft)
_GEOMETRY_FIELDS = ("family", "num_layers", "d_model", "num_heads",
                    "num_kv_heads", "head_dim", "vocab_size",
                    "sliding_window", "local_global_ratio", "qk_norm",
                    "qkv_bias", "rope_theta", "norm_eps")

_SPEC_KEYS = ("rounds", "proposed", "accepted", "emitted", "corrections",
              "bonuses")


def greedy_round(params: dict, draft_params: dict, token: Tensor, pos: Tensor,
                 n_valid: Tensor, table: Tensor, cache: Dict[str, Tensor],
                 draft_cache: Dict[str, Tensor], cfg: ModelConfig,
                 draft_cfg: ModelConfig, k: int, *, compute_dtype,
                 backend: str) -> Tuple[Tensor, Tensor]:
    """One greedy round (JAX ``_round_greedy``): draft ``k`` proposals,
    verify the ``k+1`` window, match prefixes.  Both caches are updated in
    place.  Returns ``(accepted (B,), target (B, k+1))`` on the device."""
    draft, _ = MD.paged_draft_loop(
        draft_params, token, pos, n_valid, table, draft_cache, draft_cfg, k,
        compute_dtype=compute_dtype)
    window = torch.cat([token.to(draft.dtype), draft], dim=1)  # (B, k+1)
    logits = MD.paged_verify_step(
        params, window, pos, n_valid, table, cache, cfg,
        compute_dtype=compute_dtype, backend=backend)
    target = torch.argmax(logits, dim=-1).to(torch.int32)
    ok = (draft == target[:, :-1]) & (
        torch.arange(k, device=draft.device)[None, :] < n_valid[:, None] - 1)
    accepted = torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1)
    return accepted, target


def sampled_round(params: dict, draft_params: dict, token: Tensor,
                  pos: Tensor, n_valid: Tensor, table: Tensor, seed: Tensor,
                  t0: Tensor, temperature: Tensor, top_k: Tensor,
                  top_p: Tensor, cache: Dict[str, Tensor],
                  draft_cache: Dict[str, Tensor], cfg: ModelConfig,
                  draft_cfg: ModelConfig, k: int, *, compute_dtype,
                  backend: str) -> Tuple[Tensor, Tensor]:
    """One sampled round (JAX ``_round``): the draft samples ``k`` proposals
    from its own post-transform ``q`` (``ROLE_DRAFT``), the target verifies
    the ``k+1`` window, ``speculative_accept`` corrects.  Per-row ``seed``
    (int64 holding uint32), ``t0`` (emission index of the window's first
    token), ``temperature``, ``top_k``, ``top_p``.  Both caches are updated
    in place.  Returns ``(accepted (B,), emit (B, k+1))`` on the device."""
    u_draft, u_acc, u_res, u_bonus = S.round_uniforms(seed, t0, n_valid, k)

    def draft_sample(logits, off):
        q = S.sampling_probs(logits, temperature, top_k, top_p)
        return S.categorical_from_uniform(q, u_draft[:, off]), q

    draft, q_probs = MD.paged_draft_loop(
        draft_params, token, pos, n_valid, table, draft_cache, draft_cfg, k,
        sample=draft_sample, compute_dtype=compute_dtype)
    window = torch.cat([token.to(draft.dtype), draft], dim=1)  # (B, k+1)
    logits = MD.paged_verify_step(
        params, window, pos, n_valid, table, cache, cfg,
        compute_dtype=compute_dtype, backend=backend)
    p_probs = S.sampling_probs(logits, temperature[:, None], top_k[:, None],
                               top_p[:, None])
    return S.speculative_accept(p_probs, q_probs, draft, seed, t0, n_valid,
                                uniforms=(u_acc, u_res, u_bonus))


def prefill_pair(params: dict, draft_params: dict, tokens: Tensor, start,
                 n_valid, row: Tensor, cache: Dict[str, Tensor],
                 draft_cache: Dict[str, Tensor], cfg: ModelConfig,
                 draft_cfg: ModelConfig, *, compute_dtype) -> Tensor:
    """One prefill chunk through both models (JAX ``_prefill_pair``): the
    draft needs its own KV of the prompt; returns the target's logits
    (1, 1, V), the plain engine's call on the same arguments."""
    logits = MD.paged_prefill_chunk(params, tokens, start, n_valid, row,
                                    cache, cfg, compute_dtype=compute_dtype)
    MD.paged_prefill_chunk(draft_params, tokens, start, n_valid, row,
                           draft_cache, draft_cfg, compute_dtype=compute_dtype)
    return logits


class SpeculativeEngine(ServeEngine):
    """Continuous-batching serving with draft-propose / target-verify.

    ``stats`` holds the plain engine's ``prefill_calls`` (one per chunk,
    through both models) and ``decode_calls`` (one per draft+verify round)
    beside the JAX package's speculative counters: ``rounds`` counts
    per-request round participations, ``proposed``/``accepted`` draft
    proposals, ``emitted`` every token a round appended, split into
    ``accepted + corrections + bonuses``.
    """

    def __init__(self, params: dict, cfg: ModelConfig, draft_params: dict, *,
                 draft_cfg: Optional[ModelConfig] = None, spec_k: int = 4,
                 **kwargs):
        if kwargs.get("mesh") is not None:
            raise NotImplementedError(
                "mesh-parallel speculative serving is an open item (see "
                "ROADMAP.md) — serve unsharded or use ServeEngine")
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        super().__init__(params, cfg, **kwargs)
        self.spec_k = int(spec_k)
        self.draft_cfg = draft_cfg if draft_cfg is not None else self.cfg
        for f in _GEOMETRY_FIELDS:
            if getattr(self.cfg, f) != getattr(self.draft_cfg, f):
                raise ValueError(
                    f"draft/target geometry mismatch on {f!r}: "
                    f"{getattr(self.draft_cfg, f)!r} vs "
                    f"{getattr(self.cfg, f)!r}")
        self.draft_params = draft_params
        # verify windows write up to k+1 positions per request per step;
        # the scheduler grows pages to cover the window up front
        self.sched.lookahead = self.spec_k + 1
        # mirror of the target pool: same page ids, the draft model's KV
        # (the shared allocator keeps the target's recorder, so pool
        # counters are not counted twice; the draft's swap and clone bytes
        # are)
        self.kv_draft = PagedKVCache(
            self.cfg, num_pages=self.kv.num_pages, page_size=self.page_size,
            dtype=self.kv_dtype, device=self.device,
            allocator=self.kv.allocator, recorder=self.obs)
        assert self.kv_draft.trash == self.kv.trash
        self._draft_host: Dict[int, HostKV] = {}  # uid → swapped draft KV
        self.stats.update({k: 0 for k in _SPEC_KEYS})
        # the step programs: the round replaces the plain decode program
        pt, pd, ct, cdr = (self.params, draft_params, self.kv.buffers,
                           self.kv_draft.buffers)
        cfg_t, cfg_d, k, cd, vb = (self.cfg, self.draft_cfg, self.spec_k,
                                   self.cd, self.verify_backend)

        def round_greedy(token, pos, n_valid, table):
            return greedy_round(pt, pd, token, pos, n_valid, table, ct, cdr,
                                cfg_t, cfg_d, k, compute_dtype=cd, backend=vb)

        def round_sampled(token, pos, n_valid, table, seed, t, temperature,
                          top_k, top_p):
            return sampled_round(pt, pd, token, pos, n_valid, table,
                                 *S.from_staged(seed, t, temperature, top_k,
                                                top_p),
                                 ct, cdr, cfg_t, cfg_d, k, compute_dtype=cd,
                                 backend=vb)

        def prefill(tokens, start, n_valid, row):
            return prefill_pair(pt, pd, tokens, start, n_valid, row, ct, cdr,
                                cfg_t, cfg_d, compute_dtype=cd)

        self._decode = self._sample_decode = None
        self._draft_param_bytes = tree_bytes(draft_params)
        window = ((self.max_batch,), 0)  # n_valid's (shape, idle value)
        self._round_greedy = self._program(
            round_greedy, "round_greedy", self._decode_inputs(n_valid=window),
            cost=self._round_cost)
        self._round = self._program(
            round_sampled, "round",
            self._decode_inputs(n_valid=window,
                                **S.staged_inputs(self.max_batch)),
            cost=self._round_cost)
        self._prefill = self._program(prefill, "prefill_pair",
                                      self._prefill_inputs(),
                                      cost=self._prefill_pair_cost)
        if self.obs:
            for site, prog in (("spec.round", self._round),
                               ("spec.round_greedy", self._round_greedy),
                               ("spec.prefill_pair", self._prefill)):
                self.obs.register_jit_site(site, prog)

    # -- construction ------------------------------------------------------
    @classmethod
    def _from_artifacts(cls, target_art, draft_art, params: dict,
                        cfg: ModelConfig, **kwargs) -> "SpeculativeEngine":
        """Build from two loaded ``amm_lm`` artifacts, both spliced into
        the same dense params tree."""
        device = kwargs.get("device", "cuda")
        params_t, cfg_t = _splice_artifact(target_art, params, cfg, device,
                                           kwargs.get("mesh"))
        params_d, cfg_d = _splice_artifact(draft_art, params, cfg, device,
                                           kwargs.get("mesh"))
        return cls(params_t, cfg_t, params_d, draft_cfg=cfg_d, **kwargs)

    @classmethod
    def _from_bundle(cls, bundle_path, params: dict, cfg: ModelConfig,
                     **kwargs) -> "SpeculativeEngine":
        """Serve a compiled target+draft bundle; ``spec_k`` defaults to the
        bundle manifest's recorded value, else 4."""
        target, draft, manifest = load_bundle(bundle_path)
        kwargs.setdefault("spec_k", int(manifest.get("spec_k", 4)))
        return cls._from_artifacts(target, draft, params, cfg, **kwargs)

    _prefill_site = "spec.prefill_pair"

    # -- telemetry ---------------------------------------------------------
    @property
    def acceptance_rate(self) -> float:
        """Engine-wide fraction of verified proposals accepted so far."""
        return self.stats["accepted"] / max(1, self.stats["proposed"])

    @property
    def mean_emitted_per_round(self) -> float:
        """Tokens emitted per request per draft+verify round (1 .. k+1)."""
        return self.stats["emitted"] / max(1, self.stats["rounds"])

    # -- API ---------------------------------------------------------------
    def cancel(self, uid: int) -> bool:
        ok = super().cancel(uid)
        if ok:
            self._draft_host.pop(uid, None)
        return ok

    # -- internals: the plain engine's step calls these ---------------------
    def _round_cost(self, arrays):
        """A round: ``k + 1`` draft decode steps, then the target's verify
        window of ``k + 1`` positions (the head at each)."""
        b, w = len(arrays["token"]), self.spec_k + 1
        fd, bd = self._forward_cost(self.draft_cfg, b, 1, 1,
                                    self._draft_param_bytes)
        ft, bt = self._forward_cost(self.cfg, b, w, w, self._param_bytes)
        return w * fd + ft, w * bd + bt

    def _prefill_pair_cost(self, arrays):
        cs = arrays["tokens"].shape[1]
        ft, bt = self._forward_cost(self.cfg, 1, cs, 1, self._param_bytes)
        fd, bd = self._forward_cost(self.draft_cfg, 1, cs, 1,
                                    self._draft_param_bytes)
        return ft + fd, bt + bd

    def _swap_out(self, req: Request, old_pages: List[int]) -> None:
        super()._swap_out(req, old_pages)
        self._draft_host[req.uid] = self.kv_draft.gather_host(old_pages)

    def _swap_in(self, req: Request) -> None:
        super()._swap_in(req)
        host_d = self._draft_host.pop(req.uid, None)
        if host_d is not None:
            self.kv_draft.scatter_host(host_d, req.pages)

    def _clone_pages(self, src: int, dst: int) -> None:
        """Copy-on-write covers both caches: one page table addresses both,
        so a cloned page id must carry both models' prefix KV."""
        self.kv.clone_page(src, dst)
        self.kv_draft.clone_page(src, dst)

    def _run_decode(self, decode, finished: List[Request]) -> None:
        """One speculative round over the decode batch (JAX
        ``_run_spec_round``): draft, verify, accept, then emit 1 to k+1
        tokens per request and roll back what was rejected."""
        k = self.spec_k
        token = np.zeros((self.max_batch, 1), np.int32)
        pos = np.zeros((self.max_batch,), np.int32)
        n_valid = np.zeros((self.max_batch,), np.int32)
        table = np.full((self.max_batch, self.max_pages_per_seq),
                        self.kv.trash, np.int32)
        for row, req in decode:
            token[row, 0] = req.generated[-1]
            pos[row] = req.next_pos
            # never verify past the request's token budget or max_len: the
            # last window position stays a legal cache index, and every
            # emitted token is one the plain engine could have emitted
            n_valid[row] = min(
                k + 1,
                req.max_new_tokens - len(req.generated),
                self.max_len - len(req.prompt) - len(req.generated))
            table[row, : len(req.pages)] = req.pages
        obs = self.obs
        greedy = S.all_greedy(decode)
        with obs.span("spec-round") if obs else NO_RANGE as sp:
            if greedy:
                # every row greedy: the greedy round, whose tokens the
                # sampled round gives at T = 0
                accepted, emit = _profiled_call(
                    obs, "spec.round_greedy", self._round_greedy,
                    token=token, pos=pos, n_valid=n_valid, table=table)
            else:
                accepted, emit = _profiled_call(
                    obs, "spec.round", self._round, token=token, pos=pos,
                    n_valid=n_valid, table=table,
                    **S.stage_rows(decode, self.max_batch))
            # the round's outputs come to the host: the span covers its
            # device time without a sync of the recorder's own
            accepted = accepted.cpu().numpy()  # (B,) accepted-prefix lengths
            emit = emit.cpu().numpy()          # (B, k+1) tokens to emit
        self.stats["decode_calls"] += 1
        if obs:
            obs.on_decode(decode, sp.t0, sp.t1, name=sp.name)
            obs.on_spec_round("greedy" if greedy else "sampled")

        st = self.stats
        for row, req in decode:
            w = int(n_valid[row])
            a = int(accepted[row])
            req.spec_rounds += 1
            req.spec_proposed += w - 1
            # emit the accepted proposals + the correction/bonus token,
            # checking the budget after every token as the plain engine's
            # one-token steps do (eos truncates the window)
            emitted_n = 0
            for tok in emit[row, : a + 1]:
                req.generated.append(int(tok))
                emitted_n += 1
                if req.budget_reached(self.max_len):
                    break
            # only tokens that landed count, so emitted == accepted +
            # corrections + bonuses holds under eos truncation too
            acc_emitted = min(emitted_n, a)
            final_emitted = emitted_n == a + 1
            correction = int(final_emitted and a < w - 1)
            bonus = int(final_emitted and a == w - 1)
            req.spec_accepted += acc_emitted
            st["rounds"] += 1
            st["proposed"] += w - 1
            st["accepted"] += acc_emitted
            st["emitted"] += emitted_n
            st["corrections"] += correction
            st["bonuses"] += bonus
            if obs:
                obs.on_spec_row(w - 1, acc_emitted, correction, bonus,
                                emitted_n)
                obs.on_tokens(req, emitted_n, sp.t1)
            if req.budget_reached(self.max_len):
                self.sched.retire(req)
                finished.append(req)
            else:
                # positions past the new next_pos hold rejected-draft KV in
                # both caches: free the pages backing only garbage
                self.sched.rollback(req)
