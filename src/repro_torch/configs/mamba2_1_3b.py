"""mamba2-1.3b — attention-free SSD (state-space duality).

[arXiv:2405.21060; unverified] 48L d_model=2048 d_ff=0 vocab=50280 ssm_state=128.
"""
from repro_torch.configs.base import FAMILY_SSM, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family=FAMILY_SSM,
    num_layers=48,
    d_model=2048,
    num_heads=64,               # d_inner(4096) / head_dim(64)
    num_kv_heads=64,
    d_ff=0,                     # attention-free, no FFN block (SSD mixer only)
    vocab_size=50280,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk=256, conv_width=4),
    tie_embeddings=True,
    source="arXiv:2405.21060; unverified",
)
