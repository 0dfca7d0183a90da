"""command-r-plus-104b — dense decoder, GQA, no bias.

[hf:CohereForAI/c4ai-command-r-v01; unverified] 64L d_model=12288 96H (GQA kv=8)
d_ff=33792 vocab=256000.
"""
from repro_torch.configs.base import FAMILY_DENSE, ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family=FAMILY_DENSE,
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab_size=256000,
    rope_theta=75e6,
    qkv_bias=False,
    tie_embeddings=True,        # command-r ties input/output embeddings
    optimizer="adafactor",
    param_dtype="bfloat16",      # HBM budget at 512 chips (see DESIGN.md §4)
    fsdp=True,
    microbatches=16,
    source="hf:CohereForAI/c4ai-command-r-v01; unverified",
)
