"""internvl2-26b [vlm]: 48L d6144 48H (GQA kv=8) ff16384 vocab92553,
InternViT frontend stubbed (precomputed patch embeddings) + InternLM2
backbone.  [arXiv:2404.16821; hf]"""
from repro_torch.models.config import AMMConfig, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    head_dim=128,
    num_frontend_tokens=256,  # InternVL pixel-shuffled patch count per image
    rope_theta=1_000_000.0,
    max_seq_len=32768,
    grad_accum=4,
    amm=AMMConfig(enabled=False, d_sub=8, depth=4, targets=("mlp",)),
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=128, num_heads=4, num_kv_heads=2,
        d_ff=256, vocab_size=512, head_dim=32, num_frontend_tokens=8,
        max_seq_len=64)
