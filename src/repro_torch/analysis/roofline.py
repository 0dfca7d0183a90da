"""Roofline analysis per (arch x shape x mesh) from counted dry-run cells
(the reference's ``analysis/roofline.py``).

Three terms (NVIDIA H100 SXM5, ``configs.H100_SXM``: 989 TFLOP/s dense
bf16, 3.35 TB/s HBM3, 450 GB/s NVLink a card):

  compute    = counted FLOPs       / peak_flops
  memory     = counted bytes       / hbm_bw
  collective = link_bytes/card     / link_bw

Counting: the port lowers nothing. :func:`run_probe` runs the step of a
cell (``launch.steps.shape_cells``) on meta tensors laid out on the mesh,
at the mesh's world (``sharding.init_fake_ranks``), under one
:class:`StepCounter`, a dispatch mode that sees each op on each rank's
own tensors and adds up

  flops        the FLOPs of ``torch.utils.flop_counter``'s registered
               formulas: matrix products (mm, addmm, bmm, baddbmm,
               convolutions, SDPA) only. XLA's ``cost_analysis`` also
               counts elementwise ops and reductions, so these FLOPs are
               below the reference's counted ones and are not compared
               with them;
  bytes        each op's operand and result bytes, the per-op model of
               XLA's "bytes accessed" (views and allocations move none);
  link_bytes   the collectives' bytes (``hlo_collectives.count_collectives``)
               through the ring model;

and the memory high-water mark of the step (``temp``, by storage, so that
views are not counted twice). Every count is per device.

Two-point depth probe: the reference lowers the step at depths d1 and d2
because ``cost_analysis`` counts a while-loop (scan) body once. The port
has no scans (its layers are a Python loop), so a count at full depth is
exact; the probe is kept to keep the count small (a few layers instead of
all of them at world 256), and the same extrapolation holds exactly:

  per_layer = (cost(d2) - cost(d1)) / (d2 - d1)
  total     = cost(d1) + per_layer * (L_real - d1)

The same scaling applies to collective bytes. The gradient all-reduce bytes
DO scale with microbatch count; the analytic correction (mb-1) *
grad_sync_bytes is added on top of the probe, as in the reference.

MODEL_FLOPS (the "useful" numerator for the efficiency ratio) is the standard
analytic count: 6*N_active*T for training (2*N_active*T forward) plus the
attention term 12*L*B*S^2*H*Dh*(0.5 causal) (4*... for forward-only), and the
family-specific mixer terms for SSD / RG-LRU.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
from torch.utils.flop_counter import flop_registry

from repro_torch.analysis.hlo_collectives import (CollectiveCounter,
                                                  tensor_bytes)
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import (FAMILY_ENCDEC, FAMILY_HYBRID,
                                      FAMILY_SSM, H100_SXM, HardwareConfig,
                                      ModelConfig, ShapeConfig)


# ---------------------------------------------------------------------------
# analytic MODEL_FLOPS
# ---------------------------------------------------------------------------
def analytic_model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    n_active = cfg.active_param_count
    hd = cfg.resolved_head_dim
    if shape.kind == "train":
        tokens = shape.tokens
        base = 6.0 * n_active * tokens
        attn = _attn_flops(cfg, shape.global_batch, shape.seq_len,
                           mult=12.0)
        return base + attn
    if shape.kind == "prefill":
        tokens = shape.tokens
        base = 2.0 * n_active * tokens
        attn = _attn_flops(cfg, shape.global_batch, shape.seq_len, mult=4.0)
        return base + attn
    # decode: one token per sequence
    b = shape.global_batch
    base = 2.0 * n_active * b
    # attention over the cache: 4*B*L_attn*Hq*Dh*S_kv (QK^T + PV)
    l_attn, _ = _attn_layer_count(cfg)
    skv = shape.seq_len
    if cfg.family == FAMILY_HYBRID:
        skv = min(skv, cfg.rglru.window)
    if cfg.family == FAMILY_SSM:
        attn = 2.0 * b * cfg.num_layers * _ssd_state_flops(cfg)
    else:
        attn = 4.0 * b * l_attn * cfg.num_heads * hd * skv
    if cfg.family == FAMILY_ENCDEC:
        attn += 4.0 * b * cfg.num_layers * cfg.num_heads * hd \
            * cfg.cross_kv_len
    return base + attn


def _attn_layer_count(cfg: ModelConfig) -> Tuple[int, float]:
    """(#self-attention layers, causal factor)."""
    if cfg.family == FAMILY_SSM:
        return 0, 1.0
    if cfg.family == FAMILY_HYBRID:
        plen = len(cfg.rglru.pattern)
        n_attn = (cfg.num_layers // plen) * sum(
            1 for p in cfg.rglru.pattern if p == "attn")
        return n_attn, 1.0
    if cfg.family == FAMILY_ENCDEC:
        return cfg.num_layers + cfg.num_encoder_layers, 1.0
    return cfg.num_layers, 0.5     # causal


def _attn_flops(cfg: ModelConfig, b: int, s: int, mult: float) -> float:
    l_attn, causal = _attn_layer_count(cfg)
    hd = cfg.resolved_head_dim
    if cfg.family == FAMILY_HYBRID:
        # local attention: each query sees at most `window` keys
        w = cfg.rglru.window
        span = min(w, s)
        per = mult * b * s * span * cfg.num_heads * hd * 0.5
        rec_layers = cfg.num_layers - l_attn
        ssd = 0.0
        return l_attn * per + rec_layers * mult / 2.0 * b * s \
            * (cfg.rglru.lru_width or cfg.d_model)   # recurrence ~ elementwise
    if cfg.family == FAMILY_SSM:
        return cfg.num_layers * mult / 2.0 * b * s * _ssd_chunk_flops(cfg)
    if cfg.family == FAMILY_ENCDEC:
        enc = cfg.num_encoder_layers * mult * b * s * s \
            * cfg.num_heads * hd
        dec_s = max(cfg.loss_chunk, s // 8)
        dec = cfg.num_layers * mult * b * dec_s * dec_s * cfg.num_heads \
            * hd * 0.5
        cross = cfg.num_layers * mult * b * dec_s * min(s, cfg.cross_kv_len) \
            * cfg.num_heads * hd
        return enc + dec + cross
    return l_attn * mult * b * s * s * cfg.num_heads * hd * causal


def _ssd_chunk_flops(cfg: ModelConfig) -> float:
    """Per-token SSD dual-form flops (intra-chunk quadratic + states)."""
    s_cfg = cfg.ssm
    d_in = s_cfg.expand * cfg.d_model
    nh = d_in // s_cfg.head_dim
    q = s_cfg.chunk
    n, p = s_cfg.state_dim, s_cfg.head_dim
    # per token: scores row q*n + y_diag q*p per head group + states n*p
    return nh * (q * n / nh + q * p + 2 * n * p)


def _ssd_state_flops(cfg: ModelConfig) -> float:
    s_cfg = cfg.ssm
    d_in = s_cfg.expand * cfg.d_model
    nh = d_in // s_cfg.head_dim
    return nh * s_cfg.head_dim * s_cfg.state_dim * 2


# ---------------------------------------------------------------------------
# counting one step
# ---------------------------------------------------------------------------
# allocations move no bytes
_FACTORIES = {torch.ops.aten.empty, torch.ops.aten.empty_strided,
              torch.ops.aten.empty_like, torch.ops.aten.new_empty,
              torch.ops.aten.new_empty_strided}
# elementwise transcendentals, counted by output element
_TRANSCENDENTAL = {getattr(torch.ops.aten, n) for n in (
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "tanh",
    "sigmoid", "rsqrt", "sqrt", "sin", "cos", "erf", "pow", "_softmax",
    "_log_softmax", "silu", "gelu", "softplus")}


def local_tensors(tree: Any):
    """Every tensor in ``tree`` (dicts, lists, tuples, modules), a DTensor
    as this rank's shard of it."""
    from repro_torch.sharding import is_dtensor
    if isinstance(tree, torch.nn.Module):
        tree = list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for t in tree:
            yield from local_tensors(t)
    elif isinstance(tree, torch.Tensor):
        yield tree.to_local() if is_dtensor(tree) else tree


def _distinct(tree: Any):
    """``tree``'s local tensors, one per storage (a view, or a tied
    parameter, once)."""
    seen = set()
    for t in local_tensors(tree):
        key = t.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            yield key, t


def storage_bytes(tree: Any) -> Tuple[int, set]:
    """(bytes, storage ids) of the distinct storages of ``tree``'s local
    tensors."""
    pairs = list(_distinct(tree))
    return (sum(t.untyped_storage().nbytes() for _, t in pairs),
            {k for k, _ in pairs})


class StepCounter(CollectiveCounter):
    """Per-device FLOPs, bytes accessed, transcendentals and collectives of
    the ops run under it, and the high-water mark of the bytes of the
    storages its ops made (``peak``). The storages of the step's arguments
    (:meth:`mark_arguments`) are not the step's own and are left out.

    Each storage is held by a weak reference (its ``cdata``, whose weak
    count keeps the address from being reused while it is held). Deaths
    are found by a sweep of the live storages, made only when the bytes
    not yet known dead pass the peak: the peak is then exact, and the
    sweeps fewer than the allocations. :meth:`close` drops the references."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.transcendentals = 0
        self.peak = 0
        self._args: set = set()
        self._alive: Dict[int, int] = {}      # cdata -> bytes
        self._total = 0

    def mark_arguments(self, tree: Any) -> None:
        for t in local_tensors(tree):
            st = t.untyped_storage()
            if st._cdata not in self._args:
                self._args.add(st._weak_ref())

    def record(self, func, args, kwargs, out) -> None:
        super().record(func, args, kwargs, out)
        packet = func.overloadpacket
        formula = flop_registry.get(packet)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if not func.is_view and packet not in _FACTORIES:
            self.bytes += tensor_bytes(list(args)) \
                + tensor_bytes(list(kwargs.values())) + tensor_bytes(out)
        if packet in _TRANSCENDENTAL and isinstance(out, torch.Tensor):
            self.transcendentals += out.numel()
        self._track(out)

    def _track(self, out) -> None:
        for t in (out if isinstance(out, (list, tuple)) else (out,)):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._args or key in self._alive:
                continue
            n = st.nbytes()
            self._alive[st._weak_ref()] = n
            self._total += n
            if self._total > self.peak:
                self._sweep()
                self.peak = max(self.peak, self._total)

    def _sweep(self) -> None:
        expired = torch.UntypedStorage._expired
        for k in [k for k in self._alive if expired(k)]:
            self._total -= self._alive.pop(k)
            torch.UntypedStorage._free_weak_ref(k)

    def close(self) -> None:
        for k in list(self._alive) + list(self._args):
            torch.UntypedStorage._free_weak_ref(k)
        self._alive.clear()
        self._args.clear()


def count_cell(cell) -> Dict[str, Any]:
    """Runs ``cell`` (``shape_cells``' bound step) under a
    :class:`StepCounter`: its flops, bytes, transcendentals, collectives
    and the memory record (the reference's ``memory_analysis`` keys):

      argument_size_in_bytes  this rank's shards of the step's arguments
      output_size_in_bytes    its outputs
      alias_size_in_bytes     the outputs that are arguments (a state
                              updated in place, a cache written in place)
      temp_size_in_bytes      the high-water mark of the bytes of the
                              storages the step made, less its new outputs
      per_device_total        argument + temp + output - alias"""
    counter = StepCounter()
    counter.mark_arguments(cell.args)
    arg_bytes, arg_ids = storage_bytes(cell.args)
    try:
        with counter:
            out = cell()
    finally:
        counter.close()
    out_bytes, _ = storage_bytes(out)
    alias = sum(t.untyped_storage().nbytes() for k, t in _distinct(out)
                if k in arg_ids)
    mem = {"argument_size_in_bytes": arg_bytes,
           "output_size_in_bytes": out_bytes,
           "temp_size_in_bytes": max(0, counter.peak - (out_bytes - alias)),
           "alias_size_in_bytes": alias}
    mem["per_device_total"] = (mem["argument_size_in_bytes"]
                               + mem["temp_size_in_bytes"]
                               + mem["output_size_in_bytes"]
                               - mem["alias_size_in_bytes"])
    return {"flops": float(counter.flops), "bytes": float(counter.bytes),
            "transcendentals": float(counter.transcendentals),
            "collectives": counter.stats, "memory": mem}


# ---------------------------------------------------------------------------
# probe
# ---------------------------------------------------------------------------
def probe_depths(cfg: ModelConfig) -> Tuple[int, int]:
    """Two depths of whole units: the hybrid probes whole pattern groups
    (2 and 3), the others 2 and 3 layers."""
    if cfg.family == FAMILY_HYBRID:
        plen = len(cfg.rglru.pattern)
        return 2 * plen, 3 * plen        # 2 and 3 pattern groups
    return 2, 3


def layer_units(cfg: ModelConfig) -> float:
    """Real depth in probe units (hybrid: groups incl. fractional tail)."""
    if cfg.family == FAMILY_HYBRID:
        plen = len(cfg.rglru.pattern)
        return cfg.num_layers / plen
    return float(cfg.num_layers)


def probe_cfg(cfg: ModelConfig, depth: int) -> ModelConfig:
    upd = dict(num_layers=depth, microbatches=1, q_chunk=2048,
               loss_chunk=2048, attn_impl="chunked")
    if cfg.family == FAMILY_ENCDEC:
        plen = 1
        upd["num_encoder_layers"] = depth
    return dataclasses.replace(cfg, **upd)


def _mesh_size(mesh) -> int:
    return 1 if mesh is None else mesh.size()


def probe(cfg0: ModelConfig, shape: ShapeConfig, mesh=None
          ) -> Dict[str, Any]:
    """Counts the cell at the two probe depths on ``mesh`` (None: one
    device, no rules) and extrapolates to the config's depth."""
    from repro_torch.launch.steps import shape_cells
    d1, d2 = probe_depths(cfg0)
    n = _mesh_size(mesh)
    out: Dict[int, Dict[str, float]] = {}
    for d in (d1, d2):
        c = count_cell(shape_cells(probe_cfg(cfg0, d), shape, mesh))
        out[d] = {"flops": c["flops"], "bytes": c["bytes"],
                  "link_bytes": c["collectives"].link_bytes(n)}
    units = layer_units(cfg0)
    # per-unit delta: non-hybrid probes step layers; hybrid probes step whole
    # (rec,rec,attn) groups
    plen = len(cfg0.rglru.pattern) if cfg0.family == FAMILY_HYBRID else 1
    unit_span = (d2 - d1) / plen
    per_unit = {k: (out[d2][k] - out[d1][k]) / unit_span for k in out[d1]}
    base_units = d1 / plen
    total = {k: out[d1][k] + per_unit[k] * (units - base_units)
             for k in out[d1]}
    # microbatch gradient-sync correction (train only): each extra microbatch
    # re-syncs gradients once
    mb = cfg0.microbatches
    if shape.kind == "train" and mb > 1:
        grad_bytes = cfg0.param_count * 2.0    # bf16 grads
        total["link_bytes"] += (mb - 1) * 2.0 * grad_bytes * (n - 1) / n / n
    return {"d1": out[d1], "d2": out[d2], "per_unit": per_unit,
            "total": total, "units": units}


def run_probe(arch: str, shape_name: str, multi_pod: bool = False
              ) -> Dict[str, Any]:
    """The cell counted at two depths on the production mesh; this process
    must have joined a world of its size (``sharding.init_fake_ranks``)."""
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    return probe(get_config(arch), SHAPES[shape_name], mesh)


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------
def roofline_terms(total: Dict[str, float], n_chips: int,
                   hw: HardwareConfig = H100_SXM) -> Dict[str, float]:
    """The counts are PER-DEVICE (each rank's own ops); link_bytes is
    already per-card."""
    compute_s = total["flops"] / hw.peak_flops_bf16
    memory_s = total["bytes"] / hw.hbm_bandwidth
    coll_s = total["link_bytes"] / hw.ici_bandwidth
    dom = max(("compute", compute_s), ("memory", memory_s),
              ("collective", coll_s), key=lambda kv: kv[1])[0]
    return {"compute_s": compute_s, "memory_s": memory_s,
            "collective_s": coll_s, "bottleneck": dom}


def analyze_cell(arch: str, shape_name: str, multi_pod: bool = False,
                 hw: HardwareConfig = H100_SXM) -> Dict[str, object]:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    probe_ = run_probe(arch, shape_name, multi_pod)
    n_chips = 512 if multi_pod else 256
    terms = roofline_terms(probe_["total"], n_chips, hw)
    model_flops = analytic_model_flops(cfg, shape)
    hlo_flops_global = probe_["total"]["flops"] * n_chips
    useful = model_flops / hlo_flops_global if hlo_flops_global else 0.0
    step_s = max(terms["compute_s"], terms["memory_s"],
                 terms["collective_s"])
    mfu = (model_flops / n_chips / hw.peak_flops_bf16) / step_s \
        if step_s > 0 else 0.0
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "multipod_2x16x16" if multi_pod else "pod_16x16",
        "terms": terms,
        "model_flops": model_flops,
        "hlo_flops_global": hlo_flops_global,
        "useful_ratio": useful,
        "roofline_fraction": mfu,
        "probe": probe_,
    }
