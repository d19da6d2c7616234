"""Decoder-only transformer for serving, in PyTorch: llama-class dense and
mixtral-class MoE.

The JAX package's ``models/llama.py`` with the same parameter layout and the
same step contract. One config-driven implementation serves every family of
``config/model_config.py``: Llama 1/2/3 and TinyLlama, Qwen2/2.5 (q/k/v
bias), Qwen3 (per-head qk-norm, tied embeddings), OPT (LayerNorm with bias,
learned positions, a biased fc1/act/fc2 MLP, tied embeddings) and Mixtral
(sparse MoE, dense dispatch).

- Plain functions over a params dict whose per-layer weights are STACKED
  with a leading ``[L, ...]`` axis (the JAX pytree layout, so
  ``params_from_numpy`` carries a JAX weight set across unchanged). The
  layer loop is a Python loop over views of the stacked weights.
- Entry points matching the serving hot loop: ``forward_prefill`` (ragged
  flattened prompt tokens), ``forward_prefill_hist`` (one sequence's chunk
  over its pool history), ``forward_mixed`` (a chunk plus decode rows),
  ``forward_decode`` (one token per sequence against the paged pool),
  ``forward_spec_verify`` (every running sequence's ``[last, k drafts]``
  slice) and ``forward_spec_mixed`` (a chunk plus verify slices).
- Attention reads the pool BEFORE this step's write: the current step's
  K/V fold in directly, and one in-place scatter after the layer loop
  commits every layer's K/V (``ops.attention.write_kv_pages_all``).
- Every matmul returns fp32 (``_dot``), as JAX's ``preferred_element_type``
  does, and callers cast down exactly where the JAX package does; norms,
  RoPE, softmax and the SwiGLU product run in fp32 and logits stay fp32.
- Weight-only quantization (``ModelConfig.quantization`` "int8" / "int4",
  ``ops/quant.py``) is consumed by ``_dot`` alone.
- Only the hidden states that feed sampling are projected to logits.
- Tensor and expert parallelism (``parallel/``): every forward takes
  ``groups``, one rank's ``ParallelGroups``, with that rank's local weights
  (``parallel/sharding.py``). Head counts come from the local projection
  widths; the fp32 outputs of ``wo`` and ``w_down`` (or of the MoE
  combine) are all-reduced before the cast and before ``bo``/``b_down``;
  the vocab-sharded embedding lookup is all-reduced and the logits'
  vocab shards are all-gathered. With ``groups=None`` no collective and
  no extra op runs.
- Pipeline and sequence parallelism (``parallel/pp.py``, ``parallel/sp.py``):
  ``forward_prefill``, ``forward_decode`` and ``forward_prefill_hist`` take
  ``hidden_in``, the hidden state a previous stage sent (the layer loop then
  skips the embedding and runs this stage's layers, its K/V scattered into
  its own slab of the pool), and ``forward_prefill`` takes ``attn_impl``,
  which replaces its attention (the sp ring).
"""

from __future__ import annotations

import functools
from typing import TYPE_CHECKING, Any, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..ops import quant as quant_ops
from ..ops.attention import (mixed_attention, paged_decode_attention,
                             prefill_history_attention,
                             prefill_history_valid, prefill_window,
                             ragged_prefill_attention, spec_mixed_attention,
                             spec_verify_attention, write_kv_pages_all)
from ..ops.rope import apply_rope, rope_cos_sin

if TYPE_CHECKING:  # import cycle guard: the engine package imports us
    from ..engine.kv_cache import KVCache

Params = dict[str, Any]


class PrefillMeta(NamedTuple):
    """Metadata for a ragged prefill step over T flattened prompt tokens."""
    seg_ids: torch.Tensor        # [T] int32 sequence id per token; padding -1
    positions: torch.Tensor      # [T] int32 position within its sequence
    slot_mapping: torch.Tensor   # [T] int32 flat KV slot (scrap for padding)
    logits_indices: torch.Tensor # [B] int32 index into T of each last token


class DecodeMeta(NamedTuple):
    """Metadata for a decode step: one new token per sequence."""
    positions: torch.Tensor      # [B] int32 position of the new token
    slot_mapping: torch.Tensor   # [B] int32 flat KV slot for the new token
    page_tables: torch.Tensor    # [B, pages_per_seq] int32 (pad = scrap)
    context_lens: torch.Tensor   # [B] int32 valid tokens incl. the new one


class SpecMeta(NamedTuple):
    """Metadata for a speculative-verification step over one padded token
    axis ``T = R_pad * S``: every running sequence contributes S = k+1
    contiguous slots (its last committed token + k drafts), attending to
    its own paged-pool history plus the earlier slice tokens causally
    (``S = T // page_tables.shape[0]``)."""
    seg_ids: torch.Tensor        # [T] row id on real slots, -1 padding
    positions: torch.Tensor      # [T] global positions (RoPE input)
    slot_mapping: torch.Tensor   # [T] KV write slot (overflow -> scrap page)
    page_tables: torch.Tensor    # [R_pad, pages] per-row history pages
    context_lens: torch.Tensor   # [R_pad] committed tokens incl. slot 0's


class MixedMeta(NamedTuple):
    """Metadata for a mixed step over one padded token axis
    ``T = Tp_bucket + R_pad``: a prefill chunk (tokens [0:Tp_bucket), one
    sequence, attending to its pool history) followed by decode rows."""
    seg_ids: torch.Tensor          # [T] 0 on chunk tokens, -1 elsewhere
    positions: torch.Tensor        # [T] global positions (RoPE)
    slot_mapping: torch.Tensor     # [T] KV write slot (pad -> scrap page)
    logits_indices: torch.Tensor   # [R_pad] decode rows, then the chunk's last
    chunk_page_table: torch.Tensor # [1, hist_width] the chunk seq's pages
    hist_len: torch.Tensor         # [1] int32 chunk history in the pool
    page_tables: torch.Tensor      # [R_pad, pages_bucket] decode page tables
    context_lens: torch.Tensor     # [R_pad] decode valid tokens incl. current


def check_supported(cfg: ModelConfig) -> None:
    """Raise ValueError for an unknown quantization method or MLP
    activation. Every model family of ``config/model_config.py`` is
    served."""
    if cfg.quantization is not None and \
            cfg.quantization not in quant_ops.QUANT_METHODS:
        raise ValueError(f"unsupported quantization {cfg.quantization!r} "
                         f"(one of {quant_ops.QUANT_METHODS})")
    if cfg.mlp_type == "mlp" and cfg.mlp_act not in MLP_ACTS:
        raise ValueError(f"unsupported activation {cfg.mlp_act!r} "
                         f"(one of {sorted(MLP_ACTS)})")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

# Initial value of a non-matmul weight: norm weights are ones, biases zeros
# (as the JAX package's init); a matmul weight's init is its fan-in.
ONES, ZEROS = "ones", "zeros"


def _shapes(cfg: ModelConfig) -> dict[str, tuple[tuple[int, ...], Any]]:
    """name -> (logical shape, init) of every layer weight: ONES, ZEROS, or
    the fan-in of an N(0, 1/fan_in) matmul weight. The key set is the JAX
    package's for the same config."""
    d, L = cfg.hidden_size, cfg.num_layers
    nh, nkv, hd, ff = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                       cfg.intermediate_size)
    out = {
        "input_norm": ((L, d), ONES), "post_attn_norm": ((L, d), ONES),
        "wq": ((L, d, nh * hd), d), "wk": ((L, d, nkv * hd), d),
        "wv": ((L, d, nkv * hd), d), "wo": ((L, nh * hd, d), nh * hd),
    }
    if cfg.attention_bias:
        out.update(bq=((L, nh * hd), ZEROS), bk=((L, nkv * hd), ZEROS),
                   bv=((L, nkv * hd), ZEROS))
    if cfg.qk_norm:
        out.update(q_norm=((L, hd), ONES), k_norm=((L, hd), ONES))
    if cfg.is_moe:
        E = cfg.num_experts
        out.update(router=((L, d, E), d), w_gate=((L, E, d, ff), d),
                   w_up=((L, E, d, ff), d), w_down=((L, E, ff, d), ff))
    else:
        if cfg.mlp_type != "mlp":
            out["w_gate"] = ((L, d, ff), d)
        out.update(w_up=((L, d, ff), d), w_down=((L, ff, d), ff))
    if cfg.norm_type == "layernorm":
        out.update(input_norm_b=((L, d), ZEROS),
                   post_attn_norm_b=((L, d), ZEROS))
    if cfg.linear_bias:
        out.update(bo=((L, d), ZEROS), b_up=((L, ff), ZEROS),
                   b_down=((L, d), ZEROS))
    return out


def _top_shapes(cfg: ModelConfig) -> dict[str, tuple[tuple[int, ...], Any]]:
    """The top-level weights as ``_shapes``: no ``lm_head`` when the
    embedding is tied, OPT's learned positions (with HF's +2 offset rows)
    and LayerNorm bias when the config has them."""
    d, V = cfg.hidden_size, cfg.vocab_size
    out = {"embed": ((V, d), d), "final_norm": ((d,), ONES)}
    if cfg.norm_type == "layernorm":
        out["final_norm_b"] = ((d,), ZEROS)
    if cfg.pos_embedding == "learned":
        out["pos_embed"] = ((cfg.max_model_len + 2, d), d)
    if not cfg.tie_word_embeddings:
        out["lm_head"] = ((d, V), d)
    return out


def _quantized(cfg: ModelConfig, name: str) -> bool:
    return cfg.quantization is not None and (
        name in quant_ops.QUANT_LAYER_KEYS or name == "lm_head")


def _quant_shapes(cfg: ModelConfig, shape: tuple[int, ...]):
    """Logical ``[..., in, out]`` weight -> (stored weight shape, scale
    shape) of ``cfg.quantization``: int4 ``[..., in/2, out]`` +
    ``[..., in/gs, out]``, int8 ``[..., in, out]`` + ``[..., out]``."""
    lead, din, dout = shape[:-2], shape[-2], shape[-1]
    if cfg.quantization == "int4":
        gs = cfg.quant_group_size
        if din % gs or din % 2:
            raise ValueError(f"int4 input dim {din} not divisible by "
                             f"quant_group_size {gs}")
        return lead + (din // 2, dout), lead + (din // gs, dout)
    return shape, lead + (dout,)


def param_layouts(cfg: ModelConfig) -> tuple[dict, dict]:
    """(layer params, top-level params): name -> (stored shape, kind) with
    kind "float" (the model dtype), "int8" (quantized codes) or "scale"
    (f32)."""
    def layout(shapes):
        out: dict = {}
        for name, (shape, _) in shapes.items():
            if _quantized(cfg, name):
                wshape, sshape = _quant_shapes(cfg, shape)
                out[name] = (wshape, "int8")
                out[name + "_scale"] = (sshape, "scale")
            else:
                out[name] = (shape, "float")
        return out

    return layout(_shapes(cfg)), layout(_top_shapes(cfg))


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device | str,
                dtype: Optional[torch.dtype] = None,
                shard=None) -> Params:
    """Random-init params on ``device`` from ``generator`` (which must live
    on that device): N(0, 1/fan_in) matmul weights and embeddings, unit
    norm weights, zero biases. Layout: stacked [L, ...] per-layer tensors
    (``[L, E, ...]`` for MoE experts) + the top-level weights, as in the
    JAX package.

    With ``cfg.quantization`` the matmul weights and ``lm_head`` are drawn
    directly in their quantized layout, never through a float copy (a
    float draw first would peak at the full-precision footprint): uniform
    random int8 codes, or for int4 uniform packed bytes (two uniform
    [-8, 7] nibbles each), with a constant scale that gives the dequantized
    weights the dense init's magnitude class (std ~0.57 and ~0.66 of
    fan_in^-0.5), as the JAX package's ``_init_params_quant`` does. The
    MoE router stays in the model dtype. Checkpoints quantize at load
    (``engine/weights.py``).

    ``shard(name, tensor, top)`` (``parallel.sharding.init_shard_fn``)
    takes each FULL tensor right after its draw and returns the rank's
    slice, so a tp/ep rank draws the same weights as one device and holds
    at most one full tensor beyond its shards."""
    check_supported(cfg)
    dtype = dtype or cfg.torch_dtype

    def w(shape, init):
        if init == ONES:
            return torch.ones(shape, dtype=dtype, device=device)
        if init == ZEROS:
            return torch.zeros(shape, dtype=dtype, device=device)
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device).mul_(init ** -0.5)

    def wq(shape, fan_in):
        wshape, sshape = _quant_shapes(cfg, shape)
        low, top = (-128, 7.0) if cfg.quantization == "int4" else (-127, 127.0)
        codes = torch.randint(low, 128, wshape, generator=generator,
                              dtype=torch.int8, device=device)
        return codes, torch.full(sshape, fan_in ** -0.5 / top,
                                 dtype=torch.float32, device=device)

    def draw(shapes, top):
        out = {}
        for name, (shape, init) in shapes.items():
            if _quantized(cfg, name):
                out[name], out[name + "_scale"] = wq(shape, init)
            else:
                out[name] = w(shape, init)
            if shard is not None:
                for key in (name, name + "_scale"):
                    if key in out:
                        out[key] = shard(key, out[key], top)
        return out

    return {"layers": draw(_shapes(cfg), False),
            **draw(_top_shapes(cfg), True)}


def params_from_numpy(np_params: Params, cfg: ModelConfig,
                      device: torch.device | str,
                      dtype: Optional[torch.dtype] = None) -> Params:
    """The JAX params pytree (as numpy arrays, stacked ``[L, ...]``
    layout, quantized or not) -> the port's params on ``device``. Float
    weights take the model dtype; int8 codes stay int8 and ``*_scale``
    stays f32. Both packages then compute the same function."""
    check_supported(cfg)
    dtype = dtype or cfg.torch_dtype

    def conv(name, a, shape, kind):
        if tuple(a.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(a.shape)} != {shape}")
        if kind == "int8" and a.dtype != np.int8:
            raise ValueError(f"{name}: quantized weight must be int8, got "
                             f"{a.dtype}")
        # np.array copies: JAX hands out read-only buffers.
        np_dtype = {"float": np.float32, "int8": np.int8,
                    "scale": np.float32}[kind]
        t = torch.from_numpy(np.array(a, dtype=np_dtype)).to(device)
        return t.to(dtype) if kind == "float" else t

    want_layers, want_top = param_layouts(cfg)
    layers = np_params["layers"]
    top = {k: v for k, v in np_params.items() if k != "layers"}
    for got, want, what in ((layers, want_layers, "layer weights"),
                            (top, want_top, "params")):
        if set(got) != set(want):
            raise ValueError(f"{what} {sorted(got)} != {sorted(want)}")
    out = {"layers": {name: conv(name, layers[name], *spec)
                      for name, spec in want_layers.items()}}
    out.update({name: conv(name, top[name], *spec)
                for name, spec in want_top.items()})
    return out


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalise over the last axis in fp32, cast to x's dtype, then scale
    in x's dtype (the JAX order; also the per-head qk-norm of
    ``[T, heads, hd]``)."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm in the JAX package's rounding order: normalise in fp32,
    cast to x's dtype, then ``* weight + bias`` in x's dtype
    (``F.layer_norm`` applies the affine in fp32 and rounds once, other
    bits at bf16)."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) * (xf - mu), dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * weight + bias


def _norm(cfg: ModelConfig, x: torch.Tensor, store: Params,
          name: str) -> torch.Tensor:
    """RMSNorm, or OPT's LayerNorm with its bias stored as ``<name>_b``."""
    if cfg.norm_type == "layernorm":
        return layer_norm(x, store[name], store[name + "_b"],
                          cfg.rms_norm_eps)
    return rms_norm(x, store[name], cfg.rms_norm_eps)


def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` with JAX's gather semantics: a negative index wraps
    once (``+ rows``), then every index is clamped to ``[0, rows - 1]``.
    An id the table does not hold reads a row, never faults the device."""
    n = table.shape[0]
    idx = idx.to(torch.int64)
    return table[torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)]


def _embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
           positions: torch.Tensor, groups=None) -> torch.Tensor:
    """Token embedding, plus OPT's learned position embedding (HF keeps a
    +2 offset into its table). Out-of-range ids and positions gather as
    JAX's clamped gather does (``_rows``). Under tp each rank holds a
    vocab slice of ``embed``: the id is clamped against the whole
    vocabulary, the rank that holds its row gathers it, the others give
    zeros, and one all-reduce sums them (exact: one term is nonzero)."""
    if groups is None or groups.tp == 1:
        h = _rows(params["embed"], tokens)
    else:
        table = params["embed"]
        n = table.shape[0]
        V = n * groups.tp
        idx = tokens.to(torch.int64)
        idx = torch.where(idx < 0, idx + V, idx).clamp(0, V - 1)
        local = idx - groups.tp_rank * n
        mine = (local >= 0) & (local < n)
        h = table[local.clamp(0, n - 1)] * mine[:, None].to(table.dtype)
        h = groups.all_reduce(h, "tp")
    if cfg.pos_embedding == "learned":
        h = h + _rows(params["pos_embed"], positions.to(torch.int64) + 2)
    return h


def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [T, in] @ w [in, out] with an fp32 result, as JAX's
    ``preferred_element_type=float32``: on the card a bf16 product goes to
    cuBLAS with fp32 output (``aten::mm.dtype``, CUDA only); elsewhere both
    operands are taken to fp32, where a bf16 product is exact."""
    if x.device.type == "cuda" and x.dtype != torch.float32:
        return torch.mm(x, w, out_dtype=torch.float32)
    return x.to(torch.float32) @ w.to(torch.float32)


def _dot(x: torch.Tensor, lp: Params, name: str) -> torch.Tensor:
    """x @ lp[name] in fp32, the one consumer of quantized weights:

    - int4 (packed nibbles + group scales, ``scale.ndim == w.ndim``):
      ``ops.quant.int4_matmul``, the hand-written kernel on the card;
    - int8 (per-output-channel scale): the codes are cast to x's dtype,
      multiplied with an fp32 result, and scaled once per output channel
      (on the card the cast is a bf16 copy of this one layer's weight);
    - a float weight takes the plain fp32-output product.
    """
    w = lp[name]
    if w.dtype == torch.int8:
        scale = lp[name + "_scale"]
        if quant_ops.is_packed_int4(w, scale):
            return quant_ops.int4_matmul(x, w, scale)
        return _mm_f32(x, w.to(x.dtype)) * scale
    return _mm_f32(x, w)


def _qkv(lp: Params, cfg: ModelConfig, x: torch.Tensor,
         rope: Optional[tuple[torch.Tensor, torch.Tensor]]):
    """Project (+ qwen2's bias on the fp32 projection), cast to x's dtype,
    per-head RMSNorm of q and k (qwen3), then RoPE from ``rope`` = (cos,
    sin) unless the positions are learned. x: [T, d] -> q [T, nh, hd],
    k/v [T, nkv, hd] in x's dtype."""
    T, hd = x.shape[0], cfg.head_dim
    out = []
    for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")):
        y = _dot(x, lp, w)
        if cfg.attention_bias:
            y = y + lp[b]
        out.append(y.to(x.dtype).reshape(T, -1, hd))
    q, k, v = out
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"], cfg.rms_norm_eps)
        k = rms_norm(k, lp["k_norm"], cfg.rms_norm_eps)
    if rope is not None:
        q, k = apply_rope(q, *rope), apply_rope(k, *rope)
    return q, k, v


# HF's ACT2FN names. "gelu" is the exact erf GELU (the tanh approximation
# drifts ~1e-3 per layer from HF), "gelu_new" HF's tanh variant.
MLP_ACTS = {"relu": F.relu,
            "gelu": functools.partial(F.gelu, approximate="none"),
            "gelu_new": functools.partial(F.gelu, approximate="tanh"),
            "silu": F.silu}


def _swiglu(lp: Params, x: torch.Tensor) -> torch.Tensor:
    """silu(x @ w_gate) * (x @ w_up) in fp32, cast to x's dtype, then
    @ w_down: the fp32 result."""
    h = (F.silu(_dot(x, lp, "w_gate")) * _dot(x, lp, "w_up")).to(x.dtype)
    return _dot(h, lp, "w_down")


def _reduce(out: torch.Tensor, groups, over: str = "tp") -> torch.Tensor:
    """Sum a row-split projection's fp32 partials over ``over``; no op
    without groups."""
    return out if groups is None else groups.all_reduce(out, over)


def _dense_mlp(lp: Params, cfg: ModelConfig, x: torch.Tensor,
               groups=None) -> torch.Tensor:
    """SwiGLU cast to x's dtype, or with ``mlp_type="mlp"`` OPT's fc1 (+
    bias), activation, cast, fc2 (+ bias), cast. Under tp the fp32 output
    of ``w_down`` is reduced before ``b_down`` (added once) and the
    cast."""
    if cfg.mlp_type == "mlp":
        h = _dot(x, lp, "w_up")
        if "b_up" in lp:
            h = h + lp["b_up"]
        out = _reduce(_dot(MLP_ACTS[cfg.mlp_act](h).to(x.dtype), lp,
                           "w_down"), groups)
        if "b_down" in lp:
            out = out + lp["b_down"]
        return out.to(x.dtype)
    return _reduce(_swiglu(lp, x), groups).to(x.dtype)


_EXPERT_KEYS = ("w_gate", "w_up", "w_down",
                "w_gate_scale", "w_up_scale", "w_down_scale")


def _moe_mlp(lp: Params, cfg: ModelConfig, x: torch.Tensor,
             groups=None) -> torch.Tensor:
    """Mixtral's sparse MoE, dense-dispatch as in the JAX package: an fp32
    router, top-k, a softmax over the k logits, [T, E] combine weights
    (zero for experts a token did not choose); every expert runs over all
    T tokens through ``_dot`` on its own contiguous 2-D weight slices (an
    int4 expert goes to the int4 kernel), and the outputs combine in fp32
    before the one cast. Under ep a rank holds ``E / ep`` experts and
    takes its slice of the combine weights (under tp each expert's ffn
    slice); the fp32 partials are reduced over ep and tp together."""
    k = cfg.num_experts_per_tok
    logits = _mm_f32(x.to(torch.float32), lp["router"])           # [T, E]
    top_vals, top_idx = torch.topk(logits, k, dim=-1)
    combine = torch.zeros_like(logits).scatter_(
        1, top_idx, torch.softmax(top_vals, dim=-1))
    e_local = lp["w_up"].shape[0]
    first = 0 if groups is None else groups.ep_rank * e_local
    out = torch.zeros((x.shape[0], x.shape[1]), dtype=torch.float32,
                      device=x.device)
    for e in range(e_local):
        ep = {name: lp[name][e] for name in _EXPERT_KEYS if name in lp}
        out += combine[:, first + e, None] * _swiglu(ep, x)
    return _reduce(out, groups, "moe").to(x.dtype)


def _layer_loop(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                positions: torch.Tensor, attn_fn, groups=None,
                hidden_in: Optional[torch.Tensor] = None):
    """Embed ``tokens`` (or start from ``hidden_in``, a previous pipeline
    stage's output) and run every layer ``params`` holds. ``attn_fn(q, k,
    v, layer) -> [T, nh, hd]`` sees a pool holding tokens written in
    PREVIOUS steps only (this step's k/v fold in directly). Returns (h,
    k_all, v_all) with k_all/v_all [L, T, n_kv*hd] (this rank's layers and
    kv heads), for the caller's one post-loop scatter."""
    h = (_embed(params, cfg, tokens, positions, groups) if hidden_in is None
         else hidden_in)
    layers = params["layers"]
    L = layers["wq"].shape[0]
    T = h.shape[0]
    kd = layers["wk"].shape[-1]
    k_all = torch.empty((L, T, kd), dtype=h.dtype, device=h.device)
    v_all = torch.empty_like(k_all)
    rope = None
    if cfg.pos_embedding == "rope":                 # once for all layers
        rope = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                            scaling=cfg.rope_scaling_dict)
    mlp = _moe_mlp if cfg.is_moe else _dense_mlp
    for layer in range(L):
        lp = {name: t[layer] for name, t in layers.items()}
        q, k, v = _qkv(lp, cfg, _norm(cfg, h, lp, "input_norm"), rope)
        k_all[layer] = k.reshape(T, kd)
        v_all[layer] = v.reshape(T, kd)
        o = _reduce(_dot(attn_fn(q, k, v, layer).reshape(T, -1), lp, "wo"),
                    groups)
        if "bo" in lp:
            o = o + lp["bo"]
        h = h + o.to(h.dtype)
        h = h + mlp(lp, cfg, _norm(cfg, h, lp, "post_attn_norm"), groups)
    return h, k_all, v_all


def _finish(params: Params, cfg: ModelConfig, h: torch.Tensor, kv: KVCache,
            k_all, v_all, slot_mapping, logits_indices):
    write_kv_pages_all(kv.k, kv.v, k_all, v_all, slot_mapping)
    selected = h if logits_indices is None else \
        h[logits_indices.to(torch.int64)]
    return _norm(cfg, selected, params, "final_norm"), kv, h


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def forward_prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                    meta: PrefillMeta, kv: KVCache, groups=None,
                    hidden_in=None, attn_impl=None):
    """Ragged prefill over T flattened tokens; each sequence's whole prompt
    is in the batch, so attention needs no pool. ``attn_impl`` replaces
    ``ops.attention.ragged_prefill_attention`` (same signature). Returns
    (normed_selected [B, d], kv (updated in place), raw_hidden [T, d])."""
    scale = cfg.head_dim ** -0.5
    attn = attn_impl or ragged_prefill_attention
    window = None if attn_impl else prefill_window(meta.seg_ids)  # once

    def attn_fn(q, k, v, layer):
        return attn(q, k, v, meta.seg_ids, meta.positions, scale, window)

    h, k_all, v_all = _layer_loop(params, cfg, tokens, meta.positions,
                                  attn_fn, groups, hidden_in)
    return _finish(params, cfg, h, kv, k_all, v_all, meta.slot_mapping,
                   meta.logits_indices)


def forward_prefill_hist(params: Params, cfg: ModelConfig,
                         tokens: torch.Tensor, meta: PrefillMeta, kv: KVCache,
                         page_table: torch.Tensor, hist_len: torch.Tensor,
                         groups=None, hidden_in=None):
    """Chunked prefill: one sequence's chunk attending to its pool history
    plus itself causally. ``hist_len``: [1] int32 on the step's device,
    made once per forward (every layer's kernel reads it there). Returns
    (normed_selected [1, d], kv, raw_hidden)."""
    scale = cfg.head_dim ** -0.5
    n_valid = prefill_history_valid(meta.seg_ids)  # once for all layers

    def attn_fn(q, k, v, layer):
        return prefill_history_attention(
            q, k, v, meta.seg_ids, meta.positions, kv.k, kv.v, page_table,
            hist_len, scale, layer=layer, n_valid=n_valid)

    h, k_all, v_all = _layer_loop(params, cfg, tokens, meta.positions,
                                  attn_fn, groups, hidden_in)
    return _finish(params, cfg, h, kv, k_all, v_all, meta.slot_mapping,
                   meta.logits_indices)


def forward_mixed(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  meta: MixedMeta, kv: KVCache, groups=None):
    """Mixed prefill/decode step: ONE forward over the combined token axis
    (embedding, matmuls and norms run once for chunk and decode tokens
    together), attention split at ``n_prefill = T - R_pad``: chunk tokens
    run history attention, decode rows run paged decode
    (ops.attention.mixed_attention). Returns (normed_selected [R_pad, d],
    kv, raw_hidden [T, d])."""
    scale = cfg.head_dim ** -0.5
    n_prefill = tokens.shape[0] - meta.page_tables.shape[0]
    n_valid = prefill_history_valid(meta.seg_ids[:n_prefill])  # once

    def attn_fn(q, k, v, layer):
        return mixed_attention(
            q, k, v, meta.seg_ids, meta.positions, kv.k, kv.v,
            meta.chunk_page_table, meta.hist_len, meta.page_tables,
            meta.context_lens, scale, n_prefill=n_prefill, layer=layer,
            n_valid=n_valid)

    h, k_all, v_all = _layer_loop(params, cfg, tokens, meta.positions,
                                  attn_fn, groups)
    return _finish(params, cfg, h, kv, k_all, v_all, meta.slot_mapping,
                   meta.logits_indices)


def forward_spec_mixed(params: Params, cfg: ModelConfig,
                       tokens: torch.Tensor, meta: MixedMeta, kv: KVCache,
                       S: int, groups=None):
    """Spec×mixed step: ONE forward over ``[prefill chunk | verify
    slices]`` with attention split at ``n_prefill = T - R_pad * S``
    (ops.attention.spec_mixed_attention). Returns (normed_selected
    [R_pad*S + 1, d]: every verify slot, then the chunk's last token; kv;
    raw_hidden [T, d])."""
    scale = cfg.head_dim ** -0.5
    n_prefill = tokens.shape[0] - meta.page_tables.shape[0] * S
    n_valid = prefill_history_valid(meta.seg_ids[:n_prefill])  # once

    def attn_fn(q, k, v, layer):
        return spec_mixed_attention(
            q, k, v, meta.seg_ids, meta.positions, kv.k, kv.v,
            meta.chunk_page_table, meta.hist_len, meta.page_tables,
            meta.context_lens, scale, n_prefill=n_prefill, layer=layer,
            n_valid=n_valid)

    h, k_all, v_all = _layer_loop(params, cfg, tokens, meta.positions,
                                  attn_fn, groups)
    return _finish(params, cfg, h, kv, k_all, v_all, meta.slot_mapping,
                   meta.logits_indices)


def forward_spec_verify(params: Params, cfg: ModelConfig,
                        tokens: torch.Tensor, meta: SpecMeta, kv: KVCache,
                        groups=None):
    """Speculative verification: every running sequence's ``[last token,
    k drafts]`` slice in one forward over the flat ``[R_pad * S]`` axis,
    attention by ``ops.attention.spec_verify_attention``. Returns
    (normed_hidden [T, d] over EVERY slot, kv, raw_hidden [T, d]). All new
    K/V, rejected drafts' included, commit in the one post-loop scatter;
    rejected slots sit past the committed length and are overwritten
    before any later step reads them."""
    scale = cfg.head_dim ** -0.5

    def attn_fn(q, k, v, layer):
        return spec_verify_attention(q, k, v, kv.k, kv.v, meta.page_tables,
                                     meta.context_lens, scale, layer=layer)

    h, k_all, v_all = _layer_loop(params, cfg, tokens, meta.positions,
                                  attn_fn, groups)
    return _finish(params, cfg, h, kv, k_all, v_all, meta.slot_mapping, None)


def forward_decode(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   meta: DecodeMeta, kv: KVCache, groups=None,
                   hidden_in=None):
    """Decode step: B sequences, one new token each, against the paged pool
    (positions 0..ctx-2 in the pool; this step's k/v fold in directly).
    Returns (normed_hidden [B, d], kv, raw_hidden [B, d])."""
    scale = cfg.head_dim ** -0.5

    def attn_fn(q, k, v, layer):
        return paged_decode_attention(q, kv.k, kv.v, meta.page_tables,
                                      meta.context_lens, k, v, scale,
                                      layer=layer)

    h, k_all, v_all = _layer_loop(params, cfg, tokens, meta.positions,
                                  attn_fn, groups, hidden_in)
    return _finish(params, cfg, h, kv, k_all, v_all, meta.slot_mapping, None)


def compute_logits(params: Params, cfg: ModelConfig,
                   hidden: torch.Tensor, groups=None) -> torch.Tensor:
    """hidden [B, d] -> logits [B, V] in fp32, never rounded to the model
    dtype on the way. A tied head multiplies by the model-dtype embedding
    (never quantized: there is no ``lm_head``). Under tp each rank's vocab
    shard is all-gathered into the whole ``[B, V]`` on every rank."""
    if cfg.tie_word_embeddings:
        logits = _mm_f32(hidden, params["embed"].T)
    else:
        logits = _dot(hidden, params, "lm_head")
    return logits if groups is None else groups.all_gather(logits, dim=-1)
