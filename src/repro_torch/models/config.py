"""Unified model configuration (a copy of the JAX package's, so the port imports
nothing of it).

One frozen dataclass describes dense / MoE / SSM / hybrid / enc-dec / VLM
transformer variants; each ``repro_torch/configs/<id>.py`` instantiates it
with the exact published numbers plus a ``reduced()`` twin for CPU tests.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class AMMConfig:
    """The paper's technique, as a first-class model feature.

    When enabled, the flagged projections are LUT-MU approximate matmuls at
    serving time (LUT params live in the params tree; offline fitting or a
    dry-run ShapeDtypeStruct provides them).
    """

    enabled: bool = False
    backend: str = "auto"     # LUT-MU engine backend: auto|ref|unfused|fused
    d_sub: int = 8            # codebook length (paper default)
    depth: int = 4            # I — split dims per codebook (G = 2**I)
    quantize_int8: bool = True
    targets: Tuple[str, ...] = ("mlp",)  # which projections to substitute
    prune: bool = True        # the paper's contribution: chain pruning on/off
    kv_int8: bool = False     # §Perf-C3 beyond-paper: int8-quantised KV cache
    # (decode is KV-bandwidth-bound; int8 halves it — the PQ/LUT-compressed
    # cache in kernels/pq_kv_attention.py pushes further)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | audio | ssm | moe | vlm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default: d_model // num_heads

    # -- attention ----------------------------------------------------------
    sliding_window: Optional[int] = None  # window of "local" layers
    local_global_ratio: Optional[Tuple[int, int]] = None  # e.g. (5, 1)
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0

    # -- MoE ------------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: Optional[int] = None  # per-expert FF dim if != d_ff
    moe_every: int = 1  # a layer is MoE iff layer_idx % moe_every == moe_offset
    moe_offset: int = 0
    moe_capacity: float = 1.25  # GShard capacity factor (tokens dropped past it)

    # -- SSM (Mamba-2 SSD) ----------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_ngroups: int = 1
    ssm_chunk: int = 256

    # -- hybrid (Jamba) -------------------------------------------------------
    attn_every: int = 0  # 1 attention layer per this many (rest Mamba); 0=all attn

    # -- encoder/decoder + modality frontends ----------------------------------
    encoder_layers: int = 0          # >0 ⇒ enc-dec (Whisper)
    num_frontend_tokens: int = 0     # stubbed frame/patch embeddings length

    # -- misc -----------------------------------------------------------------
    norm_eps: float = 1e-6
    act: str = "silu"
    max_seq_len: int = 131072
    grad_accum: int = 1  # microbatches per train step (activation memory ÷ N)
    seq_parallel: bool = True  # shard boundary activations over tp (SP);
    # worth it for wide models — small-d_model archs pay more in boundary
    # all-gathers than they save (§Perf-A3)
    amm: AMMConfig = dataclasses.field(default_factory=AMMConfig)

    # ---------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_ssm(self) -> bool:
        return self.family == "ssm"

    @property
    def is_hybrid(self) -> bool:
        return self.family == "hybrid"

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def layer_is_moe(self, idx: int) -> bool:
        if not self.is_moe:
            return False
        return idx % self.moe_every == self.moe_offset

    def layer_is_attn(self, idx: int) -> bool:
        """Hybrid interleave: True for attention mixer, False for Mamba."""
        if self.family == "ssm":
            return False
        if self.attn_every and self.attn_every > 1:
            # Jamba: 1 attention layer per `attn_every` (at the middle slot).
            return idx % self.attn_every == self.attn_every // 2
        return True

    def layer_is_local(self, idx: int) -> bool:
        """Sliding-window pattern: gemma3-style N local : 1 global."""
        if self.local_global_ratio is None:
            return self.sliding_window is not None
        loc, glob = self.local_global_ratio
        return (idx % (loc + glob)) < loc

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, hd = self.d_model, self.resolved_head_dim
        n_q, n_kv = self.num_heads, self.num_kv_heads
        attn = d * hd * n_q + 2 * d * hd * n_kv + hd * n_q * d
        dense_mlp = 3 * d * self.d_ff  # gated
        moe_ff = self.moe_d_ff or self.d_ff
        moe_mlp = self.num_experts * 3 * d * moe_ff + d * self.num_experts
        ssm = 0
        if self.is_ssm or self.is_hybrid:
            di, ns, hs = self.d_inner, self.ssm_state, self.ssm_headdim
            nh = di // hs
            g = self.ssm_ngroups
            # in_proj: z, x, B, C, dt ; out_proj
            ssm = d * (2 * di + 2 * g * ns + nh) + di * d + di * self.ssm_conv
        total = self.vocab_size * d  # embedding
        total += self.vocab_size * d  # unembed (untied)
        for i in range(self.num_layers):
            is_attn = self.layer_is_attn(i)
            total += attn if is_attn else ssm
            if self.family == "ssm":
                continue  # mamba2 has no separate MLP
            total += moe_mlp if self.layer_is_moe(i) else dense_mlp
            total += 2 * d  # norms
        for _ in range(self.encoder_layers):
            total += attn + dense_mlp + 2 * d  # encoder blocks
            total += attn + d  # cross-attention in decoder blocks (approx)
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        moe_ff = self.moe_d_ff or self.d_ff
        per_layer_full = self.num_experts * 3 * d * moe_ff
        per_layer_active = self.num_experts_per_tok * 3 * d * moe_ff
        n_moe = sum(1 for i in range(self.num_layers) if self.layer_is_moe(i))
        return int(self.param_count() - n_moe * (per_layer_full - per_layer_active))
