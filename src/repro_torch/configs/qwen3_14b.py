"""qwen3-14b [dense]: 40L d5120 40H (GQA kv=8) ff17408 vocab151936,
qk-norm + GQA.  [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.models.config import AMMConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=17408,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    max_seq_len=32768,
    grad_accum=2,
    amm=AMMConfig(enabled=False, d_sub=8, depth=4, targets=("mlp",)),
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=128, num_heads=4, num_kv_heads=2,
        d_ff=256, vocab_size=512, head_dim=32, max_seq_len=64)
