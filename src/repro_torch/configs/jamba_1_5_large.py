"""jamba-1.5-large-398b [hybrid]: 72L d8192 64H (GQA kv=8) ff24576
vocab65536, MoE 16 experts top-2, Mamba:attention 7:1 interleave (one
attention layer per period-8 block), MoE every 2nd layer.
[arXiv:2403.19887; hf]

Note: Jamba's original mixer is Mamba-1; this framework uses the Mamba-2 SSD
mixer throughout (state 128) — recorded as a hardware-adaptation decision in
DESIGN.md (SSD's chunked matmul form is the TPU-friendly formulation).
"""
from repro_torch.models.config import AMMConfig, ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    head_dim=128,
    num_experts=16,
    num_experts_per_tok=2,
    moe_every=2,
    moe_offset=1,
    attn_every=8,
    ssm_state=128,
    ssm_conv=4,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_ngroups=1,
    ssm_chunk=128,  # halves the (…,heads,Q,Q) SSD decay tensor
    max_seq_len=524288,
    grad_accum=8,
    amm=AMMConfig(enabled=False, d_sub=8, depth=4, targets=("mlp",)),
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=8, d_model=128, num_heads=4, num_kv_heads=2,
        d_ff=256, vocab_size=512, head_dim=32, num_experts=4,
        num_experts_per_tok=2, attn_every=4, ssm_state=16, ssm_headdim=32,
        ssm_chunk=16, max_seq_len=64)
