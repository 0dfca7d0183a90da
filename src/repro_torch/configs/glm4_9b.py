"""glm4-9b — dense decoder, RoPE, GQA.

[hf:THUDM/glm-4-9b; hf] 40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.
"""
from repro_torch.configs.base import FAMILY_DENSE, ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family=FAMILY_DENSE,
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=151552,
    rope_theta=10000.0,
    qkv_bias=True,              # GLM-4 uses qkv bias
    fsdp=True,
    microbatches=4,
    source="hf:THUDM/glm-4-9b; hf",
)
