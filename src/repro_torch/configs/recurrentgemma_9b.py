"""recurrentgemma-9b — RG-LRU + local attention hybrid, 1:2 attn:recurrent.

[arXiv:2402.19427; unverified] 38L d_model=4096 16H (GQA kv=1, i.e. MQA)
d_ff=12288 vocab=256000, window=2048.
"""
from repro_torch.configs.base import FAMILY_HYBRID, ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family=FAMILY_HYBRID,
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,             # MQA for the local-attention blocks
    head_dim=256,               # Griffin uses wide heads (4096/16)
    d_ff=12288,
    vocab_size=256000,
    rglru=RGLRUConfig(lru_width=4096, window=2048,
                      pattern=("rec", "rec", "attn"), conv_width=4),
    glu=True,
    act="gelu",                 # GeGLU
    tie_embeddings=True,
    microbatches=4,
    source="arXiv:2402.19427; unverified",
)
