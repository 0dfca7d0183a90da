"""Base configuration dataclasses for the repro framework.

Every assigned architecture is expressed as a ``ModelConfig``; input shapes as
``ShapeConfig``; the production mesh as ``MeshConfig``. Configs are plain frozen
dataclasses so they hash (usable as static args) and serialize to JSON.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

# ---------------------------------------------------------------------------
# Model families
# ---------------------------------------------------------------------------
FAMILY_DENSE = "dense"          # decoder-only full attention
FAMILY_MOE = "moe"              # decoder-only, MoE FFN
FAMILY_SSM = "ssm"              # attention-free (Mamba2 SSD)
FAMILY_HYBRID = "hybrid"        # RG-LRU + local attention (RecurrentGemma)
FAMILY_ENCDEC = "encdec"        # encoder-decoder (SeamlessM4T)
FAMILY_VLM = "vlm"              # decoder-only w/ M-RoPE + patch-embedding stub

SUBQUADRATIC_FAMILIES = (FAMILY_SSM, FAMILY_HYBRID)


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 0
    expert_ff: int = 0              # per-expert hidden dim
    aux_loss_weight: float = 0.01
    # dispatch mode: "dense" (one-hot matmul, small E) or
    # "sort" (ragged sort-based, the >64-expert scale path)
    dispatch: str = "dense"


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128            # N in Mamba2
    head_dim: int = 64              # P
    expand: int = 2                 # d_inner = expand * d_model
    chunk: int = 256                # SSD chunk length
    conv_width: int = 4


@dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int = 0              # 0 -> d_model
    window: int = 2048              # local attention window
    pattern: Tuple[str, ...] = ("rec", "rec", "attn")   # 2 recurrent : 1 attn
    conv_width: int = 4


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads
    # --- attention details ---
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    mrope: bool = False             # Qwen2-VL multimodal RoPE (3D position ids)
    tie_embeddings: bool = False
    norm: str = "rmsnorm"           # or "layernorm"
    act: str = "silu"               # glu act; "gelu" for enc-dec MLP
    glu: bool = True                # gated MLP (SwiGLU) vs plain MLP
    # --- family extensions ---
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    # enc-dec only
    num_encoder_layers: int = 0
    cross_kv_len: int = 4096        # precomputed encoder frames seen by decoder
    # modality stub: tokens are replaced by precomputed embeddings (audio/vlm)
    embed_stub: bool = False
    # --- attention implementation (smoke: "ref"; dry-run/train: "chunked";
    # kernels: "pallas"). In repro_torch this does not select the attention
    # path: a CUDA tensor always goes to the hand-written kernels, a CPU
    # tensor to the plain reference (see models/attention.py) ---
    attn_impl: str = "ref"
    q_chunk: int = 256
    packed_causal: bool = False     # triangle-packed causal schedule (§Perf)
    loss_chunk: int = 256           # sequence-chunked xent (big-vocab memory)
    microbatches: int = 1           # gradient-accumulation steps per train step
    # --- numerics / parallelism hints ---
    dtype: str = "bfloat16"         # compute dtype
    param_dtype: str = "float32"    # master params ("bfloat16" for >=100B)
    optimizer: str = "adamw"        # "adafactor" for the >100B archs
    remat: bool = True
    fsdp: bool = False              # additionally shard params over the data axis
    pipeline_stages: int = 1
    # source annotation
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), for roofline 6ND."""
        d, v = self.d_model, self.vocab_size
        n = v * d  # embeddings
        if not self.tie_embeddings:
            n += v * d  # lm head
        hd = self.resolved_head_dim
        attn = d * (self.num_heads * hd) + d * (self.num_kv_heads * hd) * 2 \
            + (self.num_heads * hd) * d
        if self.family == FAMILY_SSM:
            s = self.ssm
            d_in = s.expand * d
            nh = d_in // s.head_dim
            per_layer = d * (2 * d_in + 2 * nh * s.state_dim // (s.state_dim // s.state_dim) if False else 0)
            # explicit: in_proj (z,x,B,C,dt), out_proj, conv, A, D, dt_bias, norm
            proj_in = d * (2 * d_in + 2 * s.state_dim + nh)
            per_layer = proj_in + d_in * d + s.conv_width * (d_in + 2 * s.state_dim) + 3 * nh + 2 * d
            return n + self.num_layers * per_layer
        if self.family == FAMILY_HYBRID:
            r = self.rglru
            lw = r.lru_width or d
            ff = 3 * d * self.d_ff if self.glu else 2 * d * self.d_ff
            rec = d * lw * 2 + lw * d + 2 * lw + r.conv_width * lw  # in/out proj + gates + conv
            n_attn = self.num_layers // len(r.pattern) * sum(1 for p in r.pattern if p == "attn")
            n_rec = self.num_layers - n_attn
            return n + n_attn * (attn + ff + 2 * d) + n_rec * (rec + ff + 2 * d)
        ff_params = (3 if self.glu else 2) * d * self.d_ff
        if self.moe is not None:
            m = self.moe
            ff_params = d * m.num_experts + m.num_experts * (3 if self.glu else 2) * d * m.expert_ff
        per_layer = attn + ff_params + 2 * d  # + norms
        total = n + self.num_layers * per_layer
        if self.family == FAMILY_ENCDEC:
            # encoder blocks + decoder cross-attention
            enc_layer = attn + (2 * d * self.d_ff) + 2 * d
            total += self.num_encoder_layers * enc_layer + self.num_layers * attn
        return total

    @property
    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.moe is None:
            return self.param_count
        m = self.moe
        full_ff = m.num_experts * (3 if self.glu else 2) * self.d_model * m.expert_ff
        act_ff = m.top_k * (3 if self.glu else 2) * self.d_model * m.expert_ff
        return self.param_count - self.num_layers * (full_ff - act_ff)


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Mesh
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


SINGLE_POD = MeshConfig((16, 16), ("data", "model"))
MULTI_POD = MeshConfig((2, 16, 16), ("pod", "data", "model"))


# ---------------------------------------------------------------------------
# Hardware
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class HardwareConfig:
    peak_flops_bf16: float          # per card, dense
    hbm_bandwidth: float            # bytes/s per card
    ici_bandwidth: float            # bytes/s per card into its links
    hbm_bytes: int


# NVIDIA H100 SXM5, as ``nvidia-smi`` names it: "NVIDIA H100 80GB HBM3",
# power limit 700.00 W. NVIDIA's data sheet: 989 TFLOP/s dense bf16, 3.35
# TB/s of HBM3, NVLink 4 at 18 links x 25 GB/s in each direction. The
# ``ici_bandwidth`` is NVLink's, which joins the cards of one node only: a
# 256- or 512-rank mesh crosses nodes on some of its axes, where the links
# are slower, so its collective term is a lower bound.
H100_SXM = HardwareConfig(peak_flops_bf16=989e12, hbm_bandwidth=3.35e12,
                          ici_bandwidth=450e9, hbm_bytes=80 * 2**30)


def to_json(cfg: Any) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2)
