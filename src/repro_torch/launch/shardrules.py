"""Per-(arch x shape x mesh) sharding strategy: the reference's
``launch/shardrules.py`` on the port's parameter names.

Strategy selection (the reference's DESIGN.md §4):
- <2B dense-ish archs: pure DP — params replicated, batch over every divisible
  axis; ZeRO-1 shards optimizer moments over spare axes.
- >=2B: TP over "model" (Megatron col/row pairs), DP batch over ("pod","data").
- fsdp archs (>=9B): params additionally sharded over "data".
- MoE: experts over "model" (EP); kimi additionally FSDP on the expert matrices.
- KV heads: sharded over "model" only when divisible; otherwise replicated
  (GQA-TP practice: KV weights are small, Q/O carry the TP split).

The port keeps a per-layer tensor where the reference keeps a layer-stacked
leaf, and ``nn.Linear``'s ``[out, in]`` where the reference keeps ``[in,
out]`` (``interop.jax_key`` names the leaf and says which). So each spec is
taken in the reference's layout, the stacked leaf's shape included, and
mapped to the port's tensor: the layer axis dropped, the two dims of a
transposed weight swapped. The one spec that does not map is a moment that
ZeRO-1 shards on its leaf's layer axis (mamba2-1.3b's 48 layers over 16
data ranks): the port's per-layer moment stays whole there. Adafactor's
statistics are held per reference leaf, in its layout
(``optim/adafactor.py``), so their specs are the reference's as they are.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Tuple

from torch import nn

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.interop import is_stacked, reference_leaves
from repro_torch.sharding import NamedSharding, Rules, Spec, axis_size


@dataclasses.dataclass(frozen=True)
class Strategy:
    tp: bool
    fsdp: bool
    ep: bool
    dp_only: bool

    @staticmethod
    def for_arch(cfg: ModelConfig) -> "Strategy":
        big = cfg.param_count >= 2e9
        ep = cfg.moe is not None
        tp = big
        return Strategy(tp=tp, fsdp=cfg.fsdp, ep=ep,
                        dp_only=not big and not ep)


def _prod(xs) -> int:
    n = 1
    for x in xs:
        n *= int(x)
    return n


def make_rules(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Rules:
    st = Strategy.for_arch(cfg)
    axes = tuple(mesh.mesh_dim_names)
    has_pod = "pod" in axes
    dp_axes: Tuple[str, ...] = (("pod", "data") if has_pod else ("data",))
    total_dp = _prod(axis_size(mesh, a) for a in dp_axes)
    model_size = axis_size(mesh, "model")

    # batch mapping: fold "model" into DP when unused by TP and divisible
    batch_axes = dp_axes
    if (st.dp_only and shape.global_batch % (total_dp * model_size) == 0):
        batch_axes = dp_axes + ("model",)
    elif shape.global_batch % total_dp != 0:
        batch_axes = ("data",) if shape.global_batch % \
            axis_size(mesh, "data") == 0 else ()

    table: Dict[str, Any] = {
        "batch": batch_axes,
        "seq": None,
        "model_ff": "model" if st.tp else None,
        "model_heads": "model" if st.tp else None,
        "model_kv": "model" if (st.tp and cfg.num_kv_heads % model_size == 0)
                    else None,
        # decode KV-cache sequence sharding when KV heads can't split
        "model_kvseq": None if (st.tp and cfg.num_kv_heads % model_size == 0)
                       else "model",
        "model_vocab": "model" if (st.tp or st.dp_only is False) else None,
        "model_embed": "model" if st.tp else None,
        "model_expert": "model" if st.ep else None,
        "fsdp": "data" if st.fsdp else None,
    }
    return Rules(mesh, table)


def fit_spec(mesh, spec: Spec, shape: Tuple[int, ...]) -> Spec:
    """Drop spec axes whose dim isn't divisible by the axis-size product
    (the reference's jit in_shardings need exact divisibility; dropped axes
    mean that tensor dim stays replicated)."""
    dims = list(spec) + [None] * (len(shape) - len(list(spec)))
    out = []
    for dim_size, ax in zip(shape, dims):
        if ax is None:
            out.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        prod = _prod(axis_size(mesh, a) for a in axes)
        out.append(ax if dim_size % prod == 0 else None)
    return tuple(out)


# ---------------------------------------------------------------------------
# parameter shardings (by the reference's leaf key)
# ---------------------------------------------------------------------------
def param_spec(cfg: ModelConfig, rules: Rules, path: str,
               shape: Tuple[int, ...]) -> Spec:
    """The reference's spec of one layer of leaf ``path`` (its ``/``-joined
    key), ``shape`` in the reference's layout without the layer axis."""
    mdl = rules.physical("model_ff")          # "model" or None
    fsdp = rules.physical("fsdp")             # "data" or None
    vocab = "model" if rules.physical("model_vocab") else None
    ep = rules.physical("model_expert")
    ndim = len(shape)

    def spec(*dims):
        return tuple(dims) + (None,) * (ndim - len(dims))

    if re.search(r"head/table$", path):
        return (vocab, fsdp)
    if re.search(r"embed/table$", path):
        return (fsdp, mdl)
    if re.search(r"moe/router$", path):
        return spec(None, None)
    if re.search(r"moe/(up|gate)$", path):
        return spec(ep, fsdp, None)
    if re.search(r"moe/down$", path):
        return spec(ep, None, fsdp)
    if re.search(r"(attn|self_attn|cross_attn)/(q|k|v)/w$", path):
        kv = re.search(r"/(k|v)/w$", path) and rules.physical("model_kv") is None
        return spec(fsdp, None if kv else mdl)
    if re.search(r"(attn|self_attn|cross_attn)/(q|k|v)/b$", path):
        kv = re.search(r"/(k|v)/b$", path) and rules.physical("model_kv") is None
        return spec(None if kv else mdl)
    if re.search(r"(attn|self_attn|cross_attn)/o/w$", path):
        return spec(mdl, fsdp)
    if re.search(r"mlp/(up|gate)/w$", path):
        return spec(fsdp, mdl)
    if re.search(r"mlp/down/w$", path):
        return spec(mdl, fsdp)
    if re.search(r"mlp/(up|gate|down)/b$", path):
        return spec(mdl)
    # SSM / RG-LRU mixers
    if re.search(r"mixer/(in|gate)/w$", path):          # rglru in/gate
        return spec(fsdp, mdl)
    if re.search(r"mixer/out/w$", path):
        return spec(mdl, fsdp)
    if re.search(r"mixer/(wa|wx)/w$", path):      # block-diag [nb, c, c]
        return spec(mdl, None, None)
    if re.search(r"mixer/(wa|wx)/b$", path):      # [nb, c]
        return spec(mdl, None)
    if re.search(r"mixer/lam$", path):
        return spec(mdl)
    if re.search(r"mixer/conv_w$", path):
        return spec(None, mdl)
    if re.search(r"mixer/(in_proj|out_proj)/w$", path):  # mamba2: dp-only
        return spec(None, None)
    return spec()  # norms, scalars, biases: replicated


def _ref_shape(p, transposed: bool) -> Tuple[int, ...]:
    shape = tuple(p.shape)
    return shape[::-1] if transposed else shape


def _to_port(spec: Spec, stacked: bool, transposed: bool) -> Spec:
    """A spec of the reference's (stacked) leaf as one of the port's
    tensors: the layer axis dropped, a transposed weight's dims swapped."""
    spec = tuple(spec[1:]) if stacked else tuple(spec)
    return spec[::-1] if transposed else spec


def _leaves(params: nn.Module):
    """(reference key, stacked leaf's shape, its param spec fitted, [(port
    name, transposed), ...]) per reference leaf."""
    named = dict(params.named_parameters())
    out = []
    for key, members in reference_leaves(params).items():
        name, transposed = members[0]
        shape = _ref_shape(named[name], transposed)
        stacked = is_stacked(key)
        full = ((len(members),) if stacked else ()) + shape
        out.append((key, full, stacked, members))
    return out


def _param_spec_full(cfg, rules, key, full, stacked) -> Spec:
    """The reference's ``param_spec`` of the leaf (layer axis included)."""
    lead = (None,) if stacked else ()
    return lead + param_spec(cfg, rules, key, full[len(lead):])


def param_specs(cfg: ModelConfig, rules: Rules, params: nn.Module
                ) -> Dict[str, Spec]:
    """{port parameter name: spec}, fitted as ``param_shardings`` fits."""
    out = {}
    for key, full, stacked, members in _leaves(params):
        spec = fit_spec(rules.mesh,
                        _param_spec_full(cfg, rules, key, full, stacked), full)
        for name, transposed in members:
            out[name] = _to_port(spec, stacked, transposed)
    return out


def param_shardings(cfg: ModelConfig, rules: Rules, params: nn.Module
                    ) -> Dict[str, NamedSharding]:
    return {n: NamedSharding(rules.mesh, s)
            for n, s in param_specs(cfg, rules, params).items()}


def zero1_spec(rules: Rules, pspec: Spec, shape: Tuple[int, ...]) -> Spec:
    """ZeRO-1: shard large replicated optimizer moments over the data axis."""
    if any(s is not None for s in pspec) or _prod(shape) < (1 << 20):
        return tuple(pspec)
    data = axis_size(rules.mesh, "data")
    dims = list(pspec) + [None] * (len(shape) - len(pspec))
    for i, s in enumerate(shape):
        if s % data == 0:
            dims[i] = "data"
            return tuple(dims)
    return tuple(pspec)


def _moment_spec(rules, pspec: Spec, shape, kind=None) -> Spec:
    """The reference's ``opt_shardings`` rule for one state leaf of
    ``shape`` whose param has ``pspec``."""
    ndim = len(shape)
    dims = list(pspec) + [None] * max(0, ndim - len(list(pspec)))
    if kind == "vr":                 # [..., R] stats: drop last param dim
        dims = dims[:-1] if dims else dims
    elif kind == "vc":               # drop second-to-last param dim
        if len(dims) >= 2:
            dims = dims[:-2] + dims[-1:]
    dims = dims[:ndim] + [None] * (ndim - len(dims[:ndim]))
    spec = zero1_spec(rules, tuple(dims), shape)
    dims = list(spec)[:ndim]
    dims += [None] * (ndim - len(dims))
    return fit_spec(rules.mesh, tuple(dims), shape)


def opt_specs(cfg: ModelConfig, rules: Rules, params: nn.Module,
              opt_state) -> Dict[str, Any]:
    """Specs of the optimizer state, in its structure: AdamW's ``m`` and
    ``v`` by port parameter name (each its param's spec, or ZeRO-1's over
    the stacked leaf, mapped), Adafactor's ``vr`` / ``vc`` / ``v`` by
    reference leaf; ``step`` replicated."""
    inner = opt_state["inner"]
    out: Dict[str, Any] = {"step": ()}
    if cfg.optimizer != "adafactor":
        moments = {}
        for key, full, stacked, members in _leaves(params):
            pspec = _param_spec_full(cfg, rules, key, full, stacked)
            spec = _moment_spec(rules, pspec, full)
            for name, transposed in members:
                moments[name] = _to_port(spec, stacked, transposed)
        out["inner"] = {"m": dict(moments), "v": dict(moments)}
        return out
    pspecs = {key: _param_spec_full(cfg, rules, key, full, stacked)
              for key, full, stacked, _ in _leaves(params)}
    out["inner"] = {key: {kind: _moment_spec(rules, pspecs[key],
                                             tuple(t.shape), kind)
                          for kind, t in stats.items()}
                    for key, stats in inner.items()}
    return out


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def opt_shardings(cfg: ModelConfig, rules: Rules, params: nn.Module,
                  opt_state) -> Dict[str, Any]:
    """Moments follow their param's sharding (+ ZeRO-1 for replicated
    ones); see :func:`opt_specs`."""
    return _map(opt_specs(cfg, rules, params, opt_state),
                lambda s: NamedSharding(rules.mesh, s))


# ---------------------------------------------------------------------------
# batch / cache shardings
# ---------------------------------------------------------------------------
def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def batch_shardings(cfg: ModelConfig, rules: Rules, specs: Dict[str, Any]
                    ) -> Dict[str, Any]:
    """``specs``: {field: tensor or shape}; "cache" holds a cache tree."""
    out = {}
    for name, sds in specs.items():
        if name == "cache":
            out[name] = cache_shardings(cfg, rules, sds)
            continue
        shape = _shape(sds)
        if name == "mrope_positions":          # [3,B,S]
            spec = rules.spec(None, "batch", None)
        else:
            spec = rules.spec(*(["batch"] + [None] * (len(shape) - 1)))
        out[name] = NamedSharding(rules.mesh,
                                  fit_spec(rules.mesh, spec, shape))
    return out


def cache_shardings(cfg: ModelConfig, rules: Rules, cache, _path: str = ""
                    ) -> Any:
    """Shardings of a cache tree (nested dicts of tensors or shapes, the
    reference's layouts), by the ``/``-joined path of each leaf."""
    if isinstance(cache, dict):
        return {k: cache_shardings(cfg, rules, v,
                                   f"{_path}/{k}" if _path else str(k))
                for k, v in cache.items()}
    if cache is None:
        return None
    ps, shape = _path, _shape(cache)
    if ps.endswith("idx"):
        spec = rules.spec()
    elif re.search(r"(^|/)(k|v)$", ps):     # [L,B,S,Hkv,Dh]
        if shape[2] >= 4096:                # long cache: shard seq
            spec = rules.spec(None, "batch", "model_kvseq", "model_kv", None)
        else:
            spec = rules.spec(None, "batch", None, "model_kv", None)
    elif ps.endswith("enc_out"):            # [B,S,D]
        spec = rules.spec("batch", None, None)
    elif re.search(r"conv$", ps):           # [L,B,W,C]
        spec = rules.spec(None, "batch", None, "model_ff")
    elif re.search(r"ssm$", ps):            # [L,B,H,P,N]
        spec = rules.spec(None, "batch", "model_heads", None, None)
    elif re.search(r"lru$", ps):            # [L,B,W]
        spec = rules.spec(None, "batch", "model_ff")
    else:
        spec = (None,) * len(shape)
    return NamedSharding(rules.mesh, fit_spec(rules.mesh, spec, shape))
