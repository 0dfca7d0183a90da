"""qwen2-vl-2b — VLM backbone, M-RoPE, dynamic resolution (patch stub).

[arXiv:2409.12191; hf] 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.
The vision frontend is a STUB: ``input_specs()`` provides precomputed patch
embeddings and 3D (t,h,w) M-RoPE position ids.
"""
from repro_torch.configs.base import FAMILY_VLM, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family=FAMILY_VLM,
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    rope_theta=1e6,
    qkv_bias=True,
    mrope=True,
    tie_embeddings=True,
    embed_stub=True,            # patch embeddings precomputed
    source="arXiv:2409.12191; hf",
)
