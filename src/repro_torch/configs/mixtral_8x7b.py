"""mixtral-8x7b [moe]: 32L d4096 32H (GQA kv=8) ff14336 vocab32000,
8 experts top-2, sliding-window attention.  [arXiv:2401.04088; hf]"""
from repro_torch.models.config import AMMConfig, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    sliding_window=4096,
    num_experts=8,
    num_experts_per_tok=2,
    rope_theta=1_000_000.0,
    max_seq_len=524288,  # SWA ⇒ sub-quadratic; long_500k runs
    grad_accum=4,
    amm=AMMConfig(enabled=False, d_sub=8, depth=4, targets=("mlp",)),
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=128, num_heads=4, num_kv_heads=2,
        d_ff=256, vocab_size=512, head_dim=32, sliding_window=8,
        num_experts=4, num_experts_per_tok=2, max_seq_len=64)
