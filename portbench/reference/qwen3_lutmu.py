"""Plain PyTorch reference of a Qwen3 decoder whose MLPs are pruned LUT-MU
chains; it imports nothing of the program.

The model (Qwen3, ``hf.co/Qwen/Qwen3-14B``): token embedding; per layer
``h += o(attn(rmsnorm(h)))`` with per-head RMSNorm on q and k, rotary
embedding (``rotate_half`` form, base ``rope_theta``), grouped-query causal
softmax attention, then ``h += mlp(rmsnorm(h))``; a final RMSNorm and an
untied head.  The MLP is the paper's LUT-MU chain: one tree encode of the
input feeds the gate and up tables, ``silu(gate) · up`` is the pruned
package (level ``l`` of down-codebook ``c`` at ``l·C + c``), the down
tables' tree encodes it (``maddness.py``).

Precision is the configuration's: bf16 activations between operations,
float32 inside the norms, the rotary embedding, the softmax and the
LUT-MU epilogue; attention weights rounded to bf16 before the value
product.  The tree encode turns a one-ulp change of a compared value into
another table row, and the next layers carry it on, so the reference
computes every row of a step at the shapes the engine computes them (a
decode step of ``max_batch`` rows, prefill chunks of ``chunk`` tokens, a
key/value view of ``max_len`` positions): a product of the same shapes
sums in the same order.  It keeps its own contiguous cache of every
position and never reads the program's.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import maddness as MR

Tensor = torch.Tensor
NEG = -1e30  # additive mask of a position a query may not see


def rms_norm(x: Tensor, weight: Tensor, eps: float) -> Tensor:
    """RMSNorm in float32, scaled by ``1 + weight`` (the stored weights are
    offsets from Qwen3's unit scale), rounded to ``x``'s type."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.to(torch.float32))).to(x.dtype)


def rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """Rotary embedding of ``x (..., S, H, hd)`` at ``positions (..., S)``:
    ``x·cos + rotate_half(x)·sin`` in float32."""
    hd = x.shape[-1]
    inv_freq = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                             device=x.device) / hd))
    ang = positions[..., None].to(torch.float32) * inv_freq
    cos = torch.cat([torch.cos(ang), torch.cos(ang)], dim=-1)[..., None, :]
    sin = torch.cat([torch.sin(ang), torch.sin(ang)], dim=-1)[..., None, :]
    xf = x.to(torch.float32)
    half = hd // 2
    rot = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos + rot * sin).to(x.dtype)


def plain_mm(x: Tensor, w: Tensor) -> Tensor:
    return x @ w


def fp8(t: Tensor) -> Tensor:
    """``t`` through float8 e4m3 with one scale for the tensor (its largest
    magnitude at e4m3's 448), back in ``t``'s type."""
    s = t.abs().amax().to(torch.float32).clamp(min=1e-30) / 448.0
    return ((t.to(torch.float32) / s).to(torch.float8_e4m3fn)
            .to(torch.float32) * s).to(t.dtype)


def fp8_mm(x: Tensor, w: Tensor) -> Tensor:
    """The control's product: both operands in float8 e4m3, the precision
    below the configuration's bf16."""
    return fp8(x) @ fp8(w)


class Qwen3LutmuReference:
    """The reference over requests' prompts and served tokens.

    ``params`` is the benchmark's input tree (``embed (V, D)``,
    ``lm_head (D, V)``, ``final_norm``, and ``layers`` stacked over a
    leading layer axis); ``sizes`` the configuration's keys.  ``mm(x, w)``
    computes every dense projection and the head (the control swaps in a
    lower precision); ``codes_seen`` sees the leaves of every LUT-MU call.
    """

    def __init__(self, params: Dict, sizes: Dict, *, max_batch: int,
                 max_len: int, chunk: int, mm: Callable = plain_mm,
                 codes_seen: Optional[Callable] = None):
        self.p = params
        self.s = sizes
        self.max_batch, self.max_len, self.chunk = max_batch, max_len, chunk
        self.mm = mm
        self.codes_seen = codes_seen
        self.dtype = params["embed"].dtype
        self.dev = params["embed"].device
        self.nq = sizes["num_attention_heads"]
        self.nkv = sizes["num_key_value_heads"]
        self.hd = sizes["head_dim"]
        self.eps = sizes["rms_norm_eps"]
        self.theta = float(sizes["rope_theta"])
        self.n_layers = sizes["num_hidden_layers"]

    # -- layers ------------------------------------------------------------
    def _layer(self, l: int) -> Dict:
        def pick(tree):
            return {k: pick(v) if isinstance(v, dict) else v[l]
                    for k, v in tree.items()}
        return pick(self.p["layers"])

    def _qkv(self, a: Dict, x: Tensor, positions: Tensor):
        b, s, _ = x.shape
        q = self.mm(x, a["wq"]).reshape(b, s, self.nq, self.hd)
        k = self.mm(x, a["wk"]).reshape(b, s, self.nkv, self.hd)
        v = self.mm(x, a["wv"]).reshape(b, s, self.nkv, self.hd)
        q = rms_norm(q, a["q_norm"], self.eps)
        k = rms_norm(k, a["k_norm"], self.eps)
        return rope(q, positions, self.theta), rope(k, positions, self.theta), v

    def _mlp(self, m: Dict, x: Tensor) -> Tensor:
        b, s, d = x.shape
        xt = x.reshape(b * s, d).to(torch.float32)
        xs = MR.gather_split_values(xt, m["up_split_dims"])
        seen = self.codes_seen
        gate = MR.lutmu(xs, m["up_thresholds"], m["lut_gate"],
                        m["lut_gate_scale"], m["lut_gate_offset"], seen)
        up = MR.lutmu(xs, m["up_thresholds"], m["lut_up"], m["lut_up_scale"],
                      m["lut_up_offset"], seen)
        h = F.silu(gate) * up
        c_down, depth = m["down_split_dims"].shape
        xs_d = h.reshape(b * s, depth, c_down).transpose(1, 2)
        out = MR.lutmu(xs_d, m["down_thresholds"], m["lut_down"],
                       m["lut_down_scale"], m["lut_down_offset"], seen)
        return out.reshape(b, s, d).to(x.dtype)

    def _head(self, h: Tensor) -> Tensor:
        h = rms_norm(h, self.p["final_norm"], self.eps)
        return self.mm(h, self.p["lm_head"]).to(torch.float32)

    def _out(self, a: Dict, o: Tensor, b: int, s: int) -> Tensor:
        # a decode step's heads are made contiguous before the product, a
        # chunk's reach it as the reshape leaves them: the engine's layouts
        o = o.reshape(b, s, self.nq * self.hd).to(self.dtype)
        return self.mm(o.contiguous() if s == 1 else o, a["wo"])

    # -- the two step shapes -------------------------------------------------
    def prefill_chunk(self, cache: Tuple[Tensor, Tensor], row: int,
                      tokens: Sequence[int], start: int) -> Tensor:
        """One chunk of ``len(tokens) ≤ chunk`` prompt tokens of the request
        in cache row ``row`` at positions ``start …``; returns the float32
        logits ``(1, 1, V)`` of its last token."""
        n = len(tokens)
        cs = self.chunk
        tok = torch.zeros((1, cs), dtype=torch.int64, device=self.dev)
        tok[0, :n] = torch.as_tensor(list(tokens), device=self.dev)
        idx = start + torch.arange(cs, device=self.dev)
        kv_pos = torch.arange(self.max_len, device=self.dev)
        mask = torch.where(kv_pos[None, :] <= idx[:, None], 0.0, NEG).to(
            torch.float32)
        g = self.nq // self.nkv
        scale = 1.0 / math.sqrt(self.hd)
        h = self.p["embed"][tok]
        for l in range(self.n_layers):
            lp = self._layer(l)
            a = lp["attn"]
            q, k, v = self._qkv(a, rms_norm(h, lp["ln1"], self.eps), idx[None])
            ck, cv = cache[0][l, row:row + 1], cache[1][l, row:row + 1]
            ck[0, start:start + n] = k[0, :n]
            cv[0, start:start + n] = v[0, :n]
            qg = q.reshape(1, cs, self.nkv, g, self.hd)
            lg = torch.einsum("bsngh,btnh->bngst", qg, ck).to(torch.float32)
            lg = lg * scale + mask[None, None, None]
            w = torch.softmax(lg, dim=-1).to(self.dtype)
            o = torch.einsum("bngst,btnh->bsngh", w, cv)
            h = h + self._out(a, o, 1, cs)
            h = h + self._mlp(lp["amm_mlp"], rms_norm(h, lp["ln2"], self.eps))
        last = torch.tensor([n - 1], device=self.dev)
        return self._head(h.index_select(1, last))

    def decode_step(self, cache: Tuple[Tensor, Tensor], tokens: Tensor,
                    pos: Tensor) -> Tensor:
        """One token for each of ``max_batch`` rows (``tokens``, ``pos``:
        ``(B,)``), each written into its own cache row at ``pos``; returns
        the float32 logits ``(B, 1, V)``."""
        b = self.max_batch
        g = self.nq // self.nkv
        scale = 1.0 / math.sqrt(self.hd)
        rows = torch.arange(b, device=self.dev)
        kv_pos = torch.arange(self.max_len, device=self.dev)
        valid = (kv_pos[None, :] <= pos[:, None])[:, None, None, None, :]
        h = self.p["embed"][tokens.to(torch.int64)[:, None]]
        for l in range(self.n_layers):
            lp = self._layer(l)
            a = lp["attn"]
            q, k, v = self._qkv(a, rms_norm(h, lp["ln1"], self.eps),
                                pos[:, None])
            ck, cv = cache[0][l], cache[1][l]
            ck[rows, pos] = k[:, 0]
            cv[rows, pos] = v[:, 0]
            qg = q.reshape(b, 1, self.nkv, g, self.hd)
            lg = torch.einsum("bsngh,btnh->bngst", qg.float(), ck.float()) * scale
            lg = torch.where(valid, lg, torch.full_like(lg, NEG))
            w = torch.softmax(lg, dim=-1)
            o = torch.einsum("bngst,btnh->bsngh", w.to(self.dtype).float(),
                             cv.float())
            h = h + self._out(a, o, b, 1)
            h = h + self._mlp(lp["amm_mlp"], rms_norm(h, lp["ln2"], self.eps))
        return self._head(h)

    # -- a walk over served requests -------------------------------------
    def _decode_program(self, cache, tokens: Tensor, pos: Tensor):
        """``decode_step`` at its static inputs, as a CUDA graph on the card
        (the same kernels at the same shapes, without the host's per-op
        cost) and eagerly elsewhere.  The warm-up writes position 0 of
        every row, so it runs before the first prefill."""
        if self.dev.type != "cuda":
            return lambda: self.decode_step(cache, tokens, pos)
        seen, self.codes_seen = self.codes_seen, None
        side = torch.cuda.Stream(self.dev)
        side.wait_stream(torch.cuda.current_stream(self.dev))
        with torch.cuda.stream(side):
            self.decode_step(cache, tokens, pos)
        torch.cuda.current_stream(self.dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = self.decode_step(cache, tokens, pos)
        self.codes_seen = seen

        def replay():
            graph.replay()
            return out
        return replay

    def walk(self, requests: List[Tuple[List[int], List[int]]],
             on_logits: Callable[[Tensor, Tensor, Tensor], None]) -> None:
        """Teacher-forced pass over ``requests`` (at most ``max_batch``
        ``(prompt, served tokens)`` pairs, one cache row each).  For every
        position that predicted a served token, ``on_logits(logits (R, V),
        targets (R,), rows (R,))`` gets the reference logits of the
        requests' rows ``rows`` and the tokens the program served there.
        Where ``codes_seen`` is set, the first decode step runs eagerly so
        that it sees a decode batch's leaves."""
        if len(requests) > self.max_batch:
            raise ValueError(f"{len(requests)} requests, {self.max_batch} rows")
        shape = (self.n_layers, self.max_batch, self.max_len, self.nkv, self.hd)
        cache = (torch.zeros(shape, dtype=self.dtype, device=self.dev),
                 torch.zeros(shape, dtype=self.dtype, device=self.dev))
        tokens = torch.zeros((self.max_batch,), dtype=torch.int64, device=self.dev)
        pos = torch.zeros((self.max_batch,), dtype=torch.int64, device=self.dev)
        step = self._decode_program(cache, tokens, pos)
        for r, (prompt, served) in enumerate(requests):
            for start in range(0, len(prompt), self.chunk):
                logits = self.prefill_chunk(cache, r, prompt[start:start + self.chunk],
                                            start)
            tgt = torch.tensor([served[0]], device=self.dev)
            on_logits(logits[:, 0], tgt, torch.tensor([r], device=self.dev))
        steps = max(len(s) for _, s in requests) - 1
        host = torch.zeros((3, self.max_batch), dtype=torch.int64)
        for t in range(steps):
            host.zero_()
            active = []
            for r, (prompt, served) in enumerate(requests):
                if t + 1 < len(served):
                    host[:, r] = torch.tensor([served[t], len(prompt) + t,
                                               served[t + 1]])
                    active.append(r)
            dev = host.to(self.dev)
            tokens.copy_(dev[0])
            pos.copy_(dev[1])
            if t == 0 and self.codes_seen is not None:
                logits = self.decode_step(cache, tokens, pos)
            else:
                logits = step()
            rows = torch.tensor(active, device=self.dev)
            on_logits(logits[rows, 0], dev[2][rows], rows)
        del cache


Reference = Qwen3LutmuReference
