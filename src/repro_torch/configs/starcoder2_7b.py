"""starcoder2-7b — dense decoder, GQA, RoPE.

[arXiv:2402.19173; hf] 32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.
"""
from repro_torch.configs.base import FAMILY_DENSE, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family=FAMILY_DENSE,
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    rope_theta=1e5,
    qkv_bias=True,
    norm="layernorm",
    glu=False,                  # starcoder2 uses plain GELU MLP
    act="gelu",
    microbatches=4,
    source="arXiv:2402.19173; hf",
)
