"""qwen3-moe-30b-a3b [moe]: 48L d2048 32H (GQA kv=4) expert-ff768
vocab151936, 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.models.config import AMMConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=768,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    num_experts=128,
    num_experts_per_tok=8,
    moe_d_ff=768,
    rope_theta=1_000_000.0,
    max_seq_len=32768,
    grad_accum=4,
    amm=AMMConfig(enabled=False, d_sub=8, depth=4, targets=("mlp",)),
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=128, num_heads=4, num_kv_heads=2,
        d_ff=64, vocab_size=512, head_dim=32, num_experts=8,
        num_experts_per_tok=2, moe_d_ff=64, max_seq_len=64)
