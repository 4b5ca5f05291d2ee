"""mamba2-370m [ssm]: 48L d1024 (attention-free) vocab50280, SSD state 128.
[arXiv:2405.21060; unverified]"""
from repro_torch.models.config import AMMConfig, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    head_dim=64,
    ssm_state=128,
    ssm_conv=4,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_ngroups=1,
    ssm_chunk=128,  # §Perf B2: (…,Q,Q) decay-tensor traffic ∝ Q
    max_seq_len=524288,
    grad_accum=2,
    amm=AMMConfig(enabled=False, d_sub=8, depth=4, targets=("mlp",)),
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=128, vocab_size=512, ssm_state=16,
        ssm_headdim=32, ssm_chunk=16, max_seq_len=64)
