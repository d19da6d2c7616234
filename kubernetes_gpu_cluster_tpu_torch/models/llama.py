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
- Matmuls run in the model dtype (cuBLAS accumulates in fp32); norms,
  RoPE, softmax and the SwiGLU product in fp32.
- Only the hidden states that feed sampling are projected to logits.

Not ported yet (each raises NotImplementedError, see ``check_supported``):
quantization, MoE, OPT's layernorm / learned positions / plain MLP, and
qwen's attention bias, qk-norm and tied embeddings.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..ops.attention import (mixed_attention, paged_decode_attention,
                             prefill_history_attention,
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
    """Raise NotImplementedError for model features the port lacks."""
    missing = []
    if cfg.quantization is not None:
        missing.append(f"quantization={cfg.quantization!r} (ROADMAP R5)")
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
    """name -> (shape, fan_in) of every random-init weight (0 = ones)."""
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


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device | str,
                dtype: Optional[torch.dtype] = None) -> Params:
    """Random-init params on ``device`` from ``generator`` (which must live
    on that device): N(0, 1/fan_in) matmul weights, unit norms. Layout:
    stacked [L, ...] per-layer tensors + embed/final_norm/lm_head, as in
    the JAX package."""
    check_supported(cfg)
    dtype = dtype or cfg.torch_dtype

    def w(shape, fan_in):
        if fan_in == 0:
            return torch.ones(shape, dtype=dtype, device=device)
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device).mul_(fan_in ** -0.5)

    d = cfg.hidden_size
    return {
        "layers": {name: w(shape, fan) for name, (shape, fan)
                   in _shapes(cfg).items()},
        "embed": w((cfg.vocab_size, d), d),
        "final_norm": w((d,), 0),
        "lm_head": w((d, cfg.vocab_size), d),
    }


def params_from_numpy(np_params: Params, cfg: ModelConfig,
                      device: torch.device | str,
                      dtype: Optional[torch.dtype] = None) -> Params:
    """The JAX params pytree (as numpy arrays, stacked ``[L, ...]``
    layout) -> the port's params on ``device``. Both packages then compute
    the same function."""
    check_supported(cfg)
    dtype = dtype or cfg.torch_dtype

    def conv(a):
        # np.array copies: JAX hands out read-only buffers.
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=device, dtype=dtype)

    layers = np_params["layers"]
    want = {name: shape for name, (shape, _) in _shapes(cfg).items()}
    if set(layers) != set(want):
        raise ValueError(f"layer weights {sorted(layers)} != "
                         f"{sorted(want)}")
    out = {"layers": {}}
    for name, shape in want.items():
        if tuple(layers[name].shape) != shape:
            raise ValueError(f"{name}: shape {tuple(layers[name].shape)} "
                             f"!= {shape}")
        out["layers"][name] = conv(layers[name])
    for name in ("embed", "final_norm", "lm_head"):
        out[name] = conv(np_params[name])
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


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w for a dense weight ([in, out], the JAX layout)."""
    return torch.matmul(x, w)


def _qkv(lp: Params, cfg: ModelConfig, x: torch.Tensor, cos: torch.Tensor,
         sin: torch.Tensor):
    """Project + RoPE. x: [T, d] -> q [T, nh, hd], k/v [T, nkv, hd]."""
    T, hd = x.shape[0], cfg.head_dim
    q = _dot(x, lp["wq"]).reshape(T, -1, hd)
    k = _dot(x, lp["wk"]).reshape(T, -1, hd)
    v = _dot(x, lp["wv"]).reshape(T, -1, hd)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _dense_mlp(lp: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: silu(x @ w_gate) * (x @ w_up), then @ w_down."""
    gate = _dot(x, lp["w_gate"]).to(torch.float32)
    up = _dot(x, lp["w_up"]).to(torch.float32)
    return _dot((F.silu(gate) * up).to(x.dtype), lp["w_down"])


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
        h = h + _dot(attn, lp["wo"]).to(h.dtype)
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

    def attn_fn(q, k, v, layer):
        return ragged_prefill_attention(q, k, v, meta.seg_ids, meta.positions,
                                        scale)

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

    def attn_fn(q, k, v, layer):
        return prefill_history_attention(
            q, k, v, meta.seg_ids, meta.positions, kv.k, kv.v, page_table,
            hist_len, scale, layer=layer)

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

    def attn_fn(q, k, v, layer):
        return mixed_attention(
            q, k, v, meta.seg_ids, meta.positions, kv.k, kv.v,
            meta.chunk_page_table, meta.hist_len, meta.page_tables,
            meta.context_lens, scale, n_prefill=n_prefill, layer=layer)

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
    """hidden [B, d] -> logits [B, V] in fp32."""
    return _dot(hidden, params["lm_head"]).to(torch.float32)
