"""qwen2.5-32b [dense]: 64L d5120 40H (GQA kv=8) ff27648 vocab152064,
GQA with QKV bias.  [hf:Qwen/Qwen2.5-0.5B; hf]"""
from repro_torch.models.config import AMMConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    max_seq_len=32768,
    grad_accum=4,
    amm=AMMConfig(enabled=False, d_sub=8, depth=4, targets=("mlp",)),
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=128, num_heads=4, num_kv_heads=2,
        d_ff=256, vocab_size=512, head_dim=32, max_seq_len=64)
