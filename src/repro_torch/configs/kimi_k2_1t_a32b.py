"""kimi-k2-1t-a32b — trillion-param MoE, 384 experts top-8.

[arXiv:2501.kimi2; unverified] 61L d_model=7168 64H (GQA kv=8) d_ff=2048
(per-expert) vocab=163840, MoE 384e top-8.
"""
from repro_torch.configs.base import FAMILY_MOE, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family=FAMILY_MOE,
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=112,               # 7168/64; kernels pad lanes 112->128
    d_ff=2048,
    vocab_size=163840,
    moe=MoEConfig(num_experts=384, top_k=8, expert_ff=2048, dispatch="sort"),
    optimizer="adafactor",
    param_dtype="bfloat16",      # 1T params: Adam states cannot fit 512 x 16GB
    fsdp=True,
    microbatches=8,
    source="arXiv:2501.kimi2; unverified (paper-table)",
)
