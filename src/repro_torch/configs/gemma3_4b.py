"""gemma3-4b [dense]: 34L d2560 8H (GQA kv=4) ff10240 vocab262144,
5:1 local:global sliding-window, 128k context.  [hf:google/gemma-3-1b-pt;
unverified]"""
from repro_torch.models.config import AMMConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    d_ff=10240,
    vocab_size=262144,
    head_dim=256,
    sliding_window=1024,
    local_global_ratio=(5, 1),
    rope_theta=1_000_000.0,
    max_seq_len=524288,
    grad_accum=2,
    amm=AMMConfig(enabled=False, d_sub=8, depth=4, targets=("mlp",)),
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=6, d_model=128, num_heads=4, num_kv_heads=2,
        d_ff=256, vocab_size=512, head_dim=32, sliding_window=8,
        max_seq_len=64)
