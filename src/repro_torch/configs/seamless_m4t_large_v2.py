"""seamless-m4t-large-v2 — enc-dec multimodal (audio) backbone.

[arXiv:2308.11596; hf] 24L d_model=1024 16H (GQA kv=16) d_ff=8192 vocab=256206.
Modality frontend is a STUB: ``input_specs()`` provides precomputed frame
embeddings for the encoder; the text decoder is real.
"""
from repro_torch.configs.base import FAMILY_ENCDEC, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family=FAMILY_ENCDEC,
    num_layers=24,              # decoder layers
    num_encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,            # MHA
    d_ff=8192,
    vocab_size=256206,
    rope_theta=10000.0,
    norm="layernorm",
    act="gelu",
    glu=False,                  # seamless uses plain (non-gated) FFN
    embed_stub=True,            # audio frames arrive as precomputed embeddings
    cross_kv_len=4096,
    source="arXiv:2308.11596; hf",
)
