"""Megatron sharding rules for tp and ep, and the stage split of pp: the
full parameter dict -> one rank's local tensors.

The JAX package states these rules as ``PartitionSpec`` annotations
(``parallel/sharding.py::param_shardings``) and GSPMD slices and reduces.
Here they are plain slicing: each rank keeps its slice of every split
weight, and ``models/llama.py`` runs one all-reduce after ``wo`` and one
after ``w_down`` (or the MoE combine), one all-gather of the vocab shards
of the logits, and one all-reduce of the vocab-sharded embedding lookup.

- q projection (weight, bias, scales) column-split over tp;
- k/v projections column-split when tp divides the kv heads; when the kv
  heads divide tp instead, each rank keeps the ONE kv head its local q
  heads read (the JAX package replicates all of them and falls back to XLA
  attention; keeping one head is the same math, and the kernel sees a plain
  GQA group). When neither divides the other, a rank's q heads straddle kv
  heads: it keeps one kv head PER LOCAL Q HEAD (``g = 1``), its ``wk``/``wv``
  columns (biases, scales) repeating the kv head each of its q heads reads,
  so the pool and the kernels see plain MHA at ``nh / tp`` heads. The JAX
  package replicates the whole kv pool over tp instead. Per token and layer
  a rank's pool then holds ``2 * (nh / tp) * hd`` elements against the JAX
  layout's ``2 * n_kv * hd``: 12 q / 6 kv heads at tp 4 hold 3 heads a
  rank against 6 (half the JAX bytes; 12 heads over the 4 ranks against 6
  unique), 24 q / 3 kv at tp 2 hold 12 against 3 (four times);
- under pp every layer tensor is split on its layer axis: stage ``s`` of
  ``S`` keeps layers ``[s * L / S, (s + 1) * L / S)``, then the tp/ep rules
  apply inside the stage; ``embed``, ``final_norm``, ``lm_head`` (and
  ``pos_embed``) stay whole over pp (under tp they keep the vocab split);
  sp ranks hold the same slices as their sp peers;
- ``wo`` and ``w_down`` row-split; ``bo`` and ``b_down`` replicated and
  added once, after the reduce;
- ``w_gate``/``w_up`` (and ``b_up``) column-split;
- MoE experts split over ep, each expert's ffn over tp; the router stays
  whole on every rank;
- int8 per-output-channel scales split like their weight's out axis
  (replicated for the row-split ``wo``/``w_down``); int4 group scales split
  on the group axis where the weight's input axis is split, which needs a
  whole, even number of groups per rank (nibbles pack along K);
- ``embed`` and ``lm_head`` split over the vocab; a tied head uses its
  embedding's vocab slice.
"""

from __future__ import annotations

import torch

from ..config import ModelConfig
from ..models import llama as model_lib
from .pp import validate_pp_mesh

# (axis, mesh axis) pairs of a weight; "kv" is tp under the kv-head rule.
Rules = tuple[tuple[int, str], ...]


def straddles(cfg: ModelConfig, tp: int) -> bool:
    """Whether a tp rank's q heads straddle kv heads: neither of tp and
    the kv heads divides the other."""
    return bool(cfg.num_kv_heads % tp and tp % cfg.num_kv_heads)


def local_kv_heads(cfg: ModelConfig, tp: int) -> int:
    """kv heads one tp rank holds: ``n_kv / tp`` when tp divides them, 1
    when they divide tp (each rank keeps the head its q heads read), and
    one per local q head when its q heads straddle kv heads."""
    n_kv = cfg.num_kv_heads
    if n_kv % tp == 0:
        return n_kv // tp
    if tp % n_kv == 0:
        return 1
    return cfg.num_heads // tp


def validate(cfg: ModelConfig, tp: int, ep: int, pp: int = 1) -> None:
    """Raise ValueError for a model the layout cannot split."""
    if pp > 1:
        validate_pp_mesh(cfg, pp, tp, ep)
    if cfg.num_heads % tp != 0:
        raise ValueError(f"num_heads={cfg.num_heads} not divisible by "
                         f"tp={tp}")
    if cfg.is_moe and cfg.num_experts % ep != 0:
        raise ValueError(f"num_experts={cfg.num_experts} not divisible by "
                         f"ep={ep}")
    for what, n in (("vocab_size", cfg.vocab_size),
                    ("intermediate_size", cfg.intermediate_size)):
        if n % tp:
            raise ValueError(f"{what}={n} not divisible by tp={tp}")
    if cfg.quantization == "int4" and tp > 1:
        gs = cfg.quant_group_size
        for what, k in (("wo", cfg.num_heads * cfg.head_dim),
                        ("w_down", cfg.intermediate_size)):
            if (k // tp) % gs or (k // tp) % 2:
                raise ValueError(
                    f"int4 {what}: K/tp = {k}/{tp} is not a whole number of "
                    f"{gs}-row groups of even length (nibbles pack along K)")


def split_rules(cfg: ModelConfig) -> tuple[dict[str, Rules],
                                           dict[str, Rules]]:
    """(layer rules, top-level rules): name -> ((axis, mesh axis), ...)
    over the STORED layout of ``models.llama.param_layouts`` (leading
    ``[L]`` axis included); names absent from the rules are replicated."""
    q8 = cfg.quantization == "int8"
    q4 = cfg.quantization == "int4"
    layers: dict[str, Rules] = {"wq": ((2, "tp"),), "wk": ((2, "kv"),),
                                "wv": ((2, "kv"),), "wo": ((1, "tp"),)}
    if cfg.attention_bias:
        layers.update(bq=((1, "tp"),), bk=((1, "kv"),), bv=((1, "kv"),))
    if cfg.linear_bias:
        layers["b_up"] = ((1, "tp"),)
    if cfg.is_moe:
        col, row = ((1, "ep"), (3, "tp")), ((1, "ep"), (2, "tp"))
        layers.update(w_gate=col, w_up=col, w_down=row)
    else:
        if cfg.mlp_type != "mlp":
            layers["w_gate"] = ((2, "tp"),)
        layers.update(w_up=((2, "tp"),), w_down=((1, "tp"),))
    top: dict[str, Rules] = {"embed": ((0, "tp"),)}
    if not cfg.tie_word_embeddings:
        top["lm_head"] = ((1, "tp"),)
    if q4:
        # Group scales [..., in/gs, out]: the same axes as the weight.
        for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            if name in layers:
                layers[name + "_scale"] = layers[name]
        if "lm_head" in top:
            top["lm_head_scale"] = top["lm_head"]
    elif q8:
        # Per-output-channel scales [..., out]: the weight's out axis only.
        layers.update(wq_scale=((1, "tp"),), wk_scale=((1, "kv"),),
                      wv_scale=((1, "kv"),))
        if cfg.is_moe:
            layers.update(w_gate_scale=((1, "ep"), (2, "tp")),
                          w_up_scale=((1, "ep"), (2, "tp")),
                          w_down_scale=((1, "ep"),))
        else:
            if cfg.mlp_type != "mlp":
                layers["w_gate_scale"] = ((1, "tp"),)
            layers["w_up_scale"] = ((1, "tp"),)
        if "lm_head" in top:
            top["lm_head_scale"] = ((0, "tp"),)
    return layers, top


def _span(cfg: ModelConfig, mesh_axis: str, size: int, groups,
          name: str) -> tuple[int, int] | list[int]:
    """One rank's part of an axis of ``size``: (start, length), or under
    a kv-head straddle the list of indices it gathers."""
    tp = groups.tp
    if mesh_axis == "kv" and cfg.num_kv_heads % tp:
        width = size // cfg.num_kv_heads
        q_per_kv = cfg.num_heads // cfg.num_kv_heads
        if not straddles(cfg, tp):
            return (groups.tp_rank // (tp // cfg.num_kv_heads)) * width, width
        nh = cfg.num_heads // tp
        heads = [(groups.tp_rank * nh + j) // q_per_kv for j in range(nh)]
        return [h * width + i for h in heads for i in range(width)]
    n, i = {"ep": (groups.ep, groups.ep_rank),
            "pp": (groups.pp, groups.pp_rank)}.get(
                mesh_axis, (tp, groups.tp_rank))
    if size % n:
        raise ValueError(f"{name}: axis of {size} not divisible by "
                         f"{mesh_axis}={n}")
    return i * (size // n), size // n


def shard_tensor(t: torch.Tensor, rules: Rules, cfg: ModelConfig, groups,
                 name: str = "") -> torch.Tensor:
    """One rank's slice of the full tensor ``t`` under ``rules``, as a new
    tensor (the full one can then be freed); ``t`` itself when nothing is
    split."""
    if not rules:
        return t
    out = t
    for axis, mesh_axis in rules:
        span = _span(cfg, mesh_axis, t.shape[axis], groups, name)
        if isinstance(span, list):
            out = out.index_select(axis, torch.tensor(span,
                                                      device=out.device))
        else:
            out = out.narrow(axis, *span)
    return out.clone(memory_format=torch.contiguous_format)


def local_shape(shape: tuple, rules: Rules, cfg: ModelConfig,
                groups) -> tuple:
    shape = list(shape)
    for axis, mesh_axis in rules:
        span = _span(cfg, mesh_axis, shape[axis], groups, "")
        shape[axis] = len(span) if isinstance(span, list) else span[1]
    return tuple(shape)


def _rule_sets(cfg: ModelConfig, groups) -> tuple[dict, dict, Rules]:
    """(layer rules, top-level rules, the rule every layer tensor takes
    first: its layer axis over pp)."""
    validate(cfg, groups.tp, groups.ep, groups.pp)
    layer_rules, top_rules = split_rules(cfg)
    return layer_rules, top_rules, (((0, "pp"),) if groups.pp > 1 else ())


def init_shard_fn(cfg: ModelConfig, groups):
    """``models.llama.init_params``'s ``shard`` hook: each full tensor is
    sliced to this rank's part right after it is drawn."""
    layer_rules, top_rules, stage = _rule_sets(cfg, groups)

    def shard(name: str, t: torch.Tensor, top: bool) -> torch.Tensor:
        rules = (top_rules.get(name, ()) if top
                 else stage + layer_rules.get(name, ()))
        return shard_tensor(t, rules, cfg, groups, name)
    return shard


def shard_params(params: dict, cfg: ModelConfig, groups) -> dict:
    """The full parameter dict -> this rank's local tensors. A tensor
    already at its local shape (a sharded load) is kept as it is; any
    other shape raises."""
    layer_rules, top_rules, stage = _rule_sets(cfg, groups)
    want_layers, want_top = model_lib.param_layouts(cfg)

    def one(name, t, full, rules):
        if tuple(t.shape) == tuple(full):
            return shard_tensor(t, rules, cfg, groups, name)
        if tuple(t.shape) == local_shape(full, rules, cfg, groups):
            return t
        raise ValueError(f"{name}: shape {tuple(t.shape)} is neither the "
                         f"full {tuple(full)} nor this rank's slice")

    out = {"layers": {n: one(n, t, want_layers[n][0],
                             stage + layer_rules.get(n, ()))
                      for n, t in params["layers"].items()}}
    out.update({n: one(n, t, want_top[n][0], top_rules.get(n, ()))
                for n, t in params.items() if n != "layers"})
    return out


def local_kv_config(cfg: ModelConfig, groups) -> ModelConfig:
    """``cfg`` with one rank's layer and head counts: the geometry of its
    paged KV pool ``[L / pp, P, ps, n_kv_local * hd]`` (and of its host
    tier)."""
    if groups is None:
        return cfg
    if groups.pp > 1:
        cfg = cfg.replace(num_layers=cfg.num_layers // groups.pp)
    if groups.tp == 1:
        return cfg
    return cfg.replace(num_heads=cfg.num_heads // groups.tp,
                       num_kv_heads=local_kv_heads(cfg, groups.tp))
