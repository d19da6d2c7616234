"""Decoder-only llama-class dense transformer for serving, in PyTorch.

The JAX package's ``models/llama.py`` with the same parameter layout and the
same step contract:

- Plain functions over a params dict whose per-layer weights are STACKED
  with a leading ``[L, ...]`` axis (the JAX pytree layout, so
  ``params_from_numpy`` carries a JAX weight set across unchanged). The
  layer loop is a Python loop over views of the stacked weights.
- Entry points matching the serving hot loop: ``forward_prefill`` (ragged
  flattened prompt tokens), ``forward_prefill_hist`` (one sequence's chunk
  over its pool history), ``forward_mixed`` (a chunk plus decode rows) and
  ``forward_decode`` (one token per sequence against the paged pool).
- Attention reads the pool BEFORE this step's write: the current step's
  K/V fold in directly, and one in-place scatter after the layer loop
  commits every layer's K/V (``ops.attention.write_kv_pages_all``).
- Every matmul returns fp32 (``_dot``), as JAX's ``preferred_element_type``
  does, and callers cast down exactly where the JAX package does; norms,
  RoPE, softmax and the SwiGLU product run in fp32 and logits stay fp32.
- Weight-only quantization (``ModelConfig.quantization`` "int8" / "int4",
  ``ops/quant.py``) is consumed by ``_dot`` alone.
- Only the hidden states that feed sampling are projected to logits.

Not ported yet (each raises NotImplementedError, see ``check_supported``):
MoE, OPT's layernorm / learned positions / plain MLP, and qwen's attention
bias, qk-norm and tied embeddings.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..ops import quant as quant_ops
from ..ops.attention import (mixed_attention, paged_decode_attention,
                             prefill_history_attention,
                             prefill_history_valid, prefill_window,
                             ragged_prefill_attention, write_kv_pages_all)
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


class MixedMeta(NamedTuple):
    """Metadata for a mixed step over one padded token axis
    ``T = Tp_bucket + R_pad``: a prefill chunk (tokens [0:Tp_bucket), one
    sequence, attending to its pool history) followed by decode rows."""
    seg_ids: torch.Tensor          # [T] 0 on chunk tokens, -1 elsewhere
    positions: torch.Tensor        # [T] global positions (RoPE)
    slot_mapping: torch.Tensor     # [T] KV write slot (pad -> scrap page)
    logits_indices: torch.Tensor   # [R_pad] decode rows, then the chunk's last
    chunk_page_table: torch.Tensor # [1, hist_width] the chunk seq's pages
    hist_len: int                  # chunk history already in the pool
    page_tables: torch.Tensor      # [R_pad, pages_bucket] decode page tables
    context_lens: torch.Tensor     # [R_pad] decode valid tokens incl. current


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for model features the port lacks, and
    ValueError for an unknown quantization method."""
    if cfg.quantization is not None and \
            cfg.quantization not in quant_ops.QUANT_METHODS:
        raise ValueError(f"unsupported quantization {cfg.quantization!r} "
                         f"(one of {quant_ops.QUANT_METHODS})")
    missing = []
    if cfg.is_moe:
        missing.append("MoE (ROADMAP R3)")
    if cfg.norm_type != "rmsnorm":
        missing.append(f"norm_type={cfg.norm_type!r} (ROADMAP R3)")
    if cfg.pos_embedding != "rope":
        missing.append(f"pos_embedding={cfg.pos_embedding!r} (ROADMAP R3)")
    if cfg.mlp_type != "swiglu":
        missing.append(f"mlp_type={cfg.mlp_type!r} (ROADMAP R3)")
    if cfg.linear_bias:
        missing.append("linear_bias (ROADMAP R3)")
    if cfg.attention_bias:
        missing.append("attention_bias (ROADMAP R3)")
    if cfg.qk_norm:
        missing.append("qk_norm (ROADMAP R3)")
    if cfg.tie_word_embeddings:
        missing.append("tie_word_embeddings (ROADMAP R3)")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet: " + ", ".join(missing))


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _shapes(cfg: ModelConfig) -> dict[str, tuple[tuple[int, ...], int]]:
    """name -> (logical shape, fan_in) of every layer weight (0 = ones)."""
    d, L = cfg.hidden_size, cfg.num_layers
    nh, nkv, hd, ff = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                       cfg.intermediate_size)
    return {
        "input_norm": ((L, d), 0), "post_attn_norm": ((L, d), 0),
        "wq": ((L, d, nh * hd), d), "wk": ((L, d, nkv * hd), d),
        "wv": ((L, d, nkv * hd), d), "wo": ((L, nh * hd, d), nh * hd),
        "w_gate": ((L, d, ff), d), "w_up": ((L, d, ff), d),
        "w_down": ((L, ff, d), ff),
    }


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
    def add(out, name, shape, quantized):
        if quantized:
            wshape, sshape = _quant_shapes(cfg, shape)
            out[name] = (wshape, "int8")
            out[name + "_scale"] = (sshape, "scale")
        else:
            out[name] = (shape, "float")

    q = cfg.quantization is not None
    d, V = cfg.hidden_size, cfg.vocab_size
    layers: dict = {}
    for name, (shape, _) in _shapes(cfg).items():
        add(layers, name, shape, q and name in quant_ops.QUANT_LAYER_KEYS)
    top = {"embed": ((V, d), "float"), "final_norm": ((d,), "float")}
    add(top, "lm_head", (d, V), q)
    return layers, top


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device | str,
                dtype: Optional[torch.dtype] = None) -> Params:
    """Random-init params on ``device`` from ``generator`` (which must live
    on that device): N(0, 1/fan_in) matmul weights, unit norms. Layout:
    stacked [L, ...] per-layer tensors + embed/final_norm/lm_head, as in
    the JAX package.

    With ``cfg.quantization`` the matmul weights and ``lm_head`` are drawn
    directly in their quantized layout, never through a float copy (a
    float draw first would peak at the full-precision footprint): uniform
    random int8 codes, or for int4 uniform packed bytes (two uniform
    [-8, 7] nibbles each), with a constant scale that gives the dequantized
    weights the dense init's magnitude class (std ~0.57 and ~0.66 of
    fan_in^-0.5), as the JAX package's ``_init_params_quant`` does.
    Checkpoints quantize at load (``engine/weights.py``)."""
    check_supported(cfg)
    dtype = dtype or cfg.torch_dtype

    def w(shape, fan_in):
        if fan_in == 0:
            return torch.ones(shape, dtype=dtype, device=device)
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device).mul_(fan_in ** -0.5)

    def wq(shape, fan_in):
        wshape, sshape = _quant_shapes(cfg, shape)
        low, top = (-128, 7.0) if cfg.quantization == "int4" else (-127, 127.0)
        codes = torch.randint(low, 128, wshape, generator=generator,
                              dtype=torch.int8, device=device)
        return codes, torch.full(sshape, fan_in ** -0.5 / top,
                                 dtype=torch.float32, device=device)

    layers = {}
    for name, (shape, fan) in _shapes(cfg).items():
        if cfg.quantization and name in quant_ops.QUANT_LAYER_KEYS:
            layers[name], layers[name + "_scale"] = wq(shape, fan)
        else:
            layers[name] = w(shape, fan)
    d = cfg.hidden_size
    params = {"layers": layers, "embed": w((cfg.vocab_size, d), d),
              "final_norm": w((d,), 0)}
    if cfg.quantization:
        params["lm_head"], params["lm_head_scale"] = wq((d, cfg.vocab_size),
                                                        d)
    else:
        params["lm_head"] = w((d, cfg.vocab_size), d)
    return params


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
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight


def _embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.to(torch.int64)]


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


def _qkv(lp: Params, cfg: ModelConfig, x: torch.Tensor, cos: torch.Tensor,
         sin: torch.Tensor):
    """Project + RoPE. x: [T, d] -> q [T, nh, hd], k/v [T, nkv, hd] in x's
    dtype (the fp32 projections are cast down before RoPE, as in JAX)."""
    T, hd = x.shape[0], cfg.head_dim
    q = _dot(x, lp, "wq").to(x.dtype).reshape(T, -1, hd)
    k = _dot(x, lp, "wk").to(x.dtype).reshape(T, -1, hd)
    v = _dot(x, lp, "wv").to(x.dtype).reshape(T, -1, hd)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _dense_mlp(lp: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: silu(x @ w_gate) * (x @ w_up) in fp32, cast to x's dtype,
    then @ w_down, cast to x's dtype."""
    h = (F.silu(_dot(x, lp, "w_gate")) * _dot(x, lp, "w_up")).to(x.dtype)
    return _dot(h, lp, "w_down").to(x.dtype)


def _layer_loop(params: Params, cfg: ModelConfig, h: torch.Tensor,
                positions: torch.Tensor, attn_fn):
    """Run every layer. ``attn_fn(q, k, v, layer) -> [T, nh, hd]`` sees a
    pool holding tokens written in PREVIOUS steps only (this step's k/v
    fold in directly). Returns (h, k_all, v_all) with k_all/v_all
    [L, T, n_kv*hd], for the caller's one post-loop scatter."""
    layers = params["layers"]
    L = layers["wq"].shape[0]
    T = h.shape[0]
    kd = cfg.num_kv_heads * cfg.head_dim
    k_all = torch.empty((L, T, kd), dtype=h.dtype, device=h.device)
    v_all = torch.empty_like(k_all)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                            scaling=cfg.rope_scaling_dict)
    eps = cfg.rms_norm_eps
    for layer in range(L):
        lp = {name: t[layer] for name, t in layers.items()}
        x = rms_norm(h, lp["input_norm"], eps)
        q, k, v = _qkv(lp, cfg, x, cos, sin)
        k_all[layer] = k.reshape(T, kd)
        v_all[layer] = v.reshape(T, kd)
        attn = attn_fn(q, k, v, layer).reshape(T, -1)
        h = h + _dot(attn, lp, "wo").to(h.dtype)
        h = h + _dense_mlp(lp, rms_norm(h, lp["post_attn_norm"], eps))
    return h, k_all, v_all


def _finish(params: Params, cfg: ModelConfig, h: torch.Tensor, kv: KVCache,
            k_all, v_all, slot_mapping, logits_indices):
    write_kv_pages_all(kv.k, kv.v, k_all, v_all, slot_mapping)
    selected = h if logits_indices is None else \
        h[logits_indices.to(torch.int64)]
    return rms_norm(selected, params["final_norm"], cfg.rms_norm_eps), kv, h


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def forward_prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                    meta: PrefillMeta, kv: KVCache):
    """Ragged prefill over T flattened tokens; each sequence's whole prompt
    is in the batch, so attention needs no pool. Returns
    (normed_selected [B, d], kv (updated in place), raw_hidden [T, d])."""
    scale = cfg.head_dim ** -0.5
    window = prefill_window(meta.seg_ids)      # once for all layers

    def attn_fn(q, k, v, layer):
        return ragged_prefill_attention(q, k, v, meta.seg_ids, meta.positions,
                                        scale, window)

    h, k_all, v_all = _layer_loop(params, cfg, _embed(params, tokens),
                                  meta.positions, attn_fn)
    return _finish(params, cfg, h, kv, k_all, v_all, meta.slot_mapping,
                   meta.logits_indices)


def forward_prefill_hist(params: Params, cfg: ModelConfig,
                         tokens: torch.Tensor, meta: PrefillMeta, kv: KVCache,
                         page_table: torch.Tensor, hist_len: int):
    """Chunked prefill: one sequence's chunk attending to its pool history
    plus itself causally. Returns (normed_selected [1, d], kv, raw_hidden)."""
    scale = cfg.head_dim ** -0.5
    n_valid = prefill_history_valid(meta.seg_ids)  # once for all layers

    def attn_fn(q, k, v, layer):
        return prefill_history_attention(
            q, k, v, meta.seg_ids, meta.positions, kv.k, kv.v, page_table,
            hist_len, scale, layer=layer, n_valid=n_valid)

    h, k_all, v_all = _layer_loop(params, cfg, _embed(params, tokens),
                                  meta.positions, attn_fn)
    return _finish(params, cfg, h, kv, k_all, v_all, meta.slot_mapping,
                   meta.logits_indices)


def forward_mixed(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  meta: MixedMeta, kv: KVCache):
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

    h, k_all, v_all = _layer_loop(params, cfg, _embed(params, tokens),
                                  meta.positions, attn_fn)
    return _finish(params, cfg, h, kv, k_all, v_all, meta.slot_mapping,
                   meta.logits_indices)


def forward_decode(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   meta: DecodeMeta, kv: KVCache):
    """Decode step: B sequences, one new token each, against the paged pool
    (positions 0..ctx-2 in the pool; this step's k/v fold in directly).
    Returns (normed_hidden [B, d], kv, raw_hidden [B, d])."""
    scale = cfg.head_dim ** -0.5

    def attn_fn(q, k, v, layer):
        return paged_decode_attention(q, kv.k, kv.v, meta.page_tables,
                                      meta.context_lens, k, v, scale,
                                      layer=layer)

    h, k_all, v_all = _layer_loop(params, cfg, _embed(params, tokens),
                                  meta.positions, attn_fn)
    return _finish(params, cfg, h, kv, k_all, v_all, meta.slot_mapping, None)


def compute_logits(params: Params, cfg: ModelConfig,
                   hidden: torch.Tensor) -> torch.Tensor:
    """hidden [B, d] -> logits [B, V] in fp32, never rounded to the model
    dtype on the way."""
    return _dot(hidden, params, "lm_head")
