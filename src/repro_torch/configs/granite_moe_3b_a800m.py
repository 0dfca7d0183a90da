"""granite-moe-3b-a800m — MoE, 40 experts top-8, GQA.

[hf:ibm-granite/granite-3.0-1b-a400m-base; hf] 32L d_model=1536 24H (GQA kv=8)
d_ff=512 (per-expert) vocab=49155, MoE 40e top-8.
"""
from repro_torch.configs.base import FAMILY_MOE, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family=FAMILY_MOE,
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    moe=MoEConfig(num_experts=40, top_k=8, expert_ff=512, dispatch="sort"),
    tie_embeddings=True,
    fsdp=True,
    microbatches=4,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)
