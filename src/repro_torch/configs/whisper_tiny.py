"""whisper-tiny [audio]: 4L enc + 4L dec, d384 6H (kv=6) ff1536 vocab51865,
enc-dec with stubbed conv frontend (precomputed 1500-frame embeddings).
[arXiv:2212.04356; unverified]"""
from repro_torch.models.config import AMMConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    head_dim=64,
    encoder_layers=4,
    num_frontend_tokens=1500,
    act="gelu",
    max_seq_len=32768,
    grad_accum=2,
    amm=AMMConfig(enabled=False, d_sub=8, depth=4, targets=("mlp",)),
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, encoder_layers=2, d_model=128, num_heads=4,
        num_kv_heads=4, d_ff=256, vocab_size=512, head_dim=32,
        num_frontend_tokens=16, max_seq_len=64)
