"""qwen2-0.5b — dense decoder, GQA, QKV bias, tied embeddings.

[arXiv:2407.10671; hf] 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936.
"""
from repro_torch.configs.base import FAMILY_DENSE, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family=FAMILY_DENSE,
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151936,
    rope_theta=1e6,
    qkv_bias=True,
    tie_embeddings=True,
    source="arXiv:2407.10671; hf",
)
