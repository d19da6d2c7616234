"""Weight-only quantization ladder (W8A16 / W4A16), in PyTorch.

The port's own copy of the JAX package's ``ops/quant.py``: the same
formulas and layouts, so a checkpoint quantized here is bit-identical to
one quantized there. The functions take numpy arrays (the host load path)
or torch tensors.

- **int8** (per-output-channel symmetric): weight ``[..., in, out]`` int8,
  scale ``[..., out]`` f32. The scale factors out of the dot:
  ``x @ dequant(w) == (x @ w) * scale``.
- **int4** (group-wise symmetric): scales per (input-dim group, output
  channel), ``group_size`` input rows per group. Two nibbles pack into one
  int8 byte along the INPUT dim: byte ``i`` holds input row ``2i`` in its
  low nibble and ``2i+1`` in its high nibble. Weight ``[..., in/2, out]``
  int8, scale ``[..., in/group, out]`` f32 (``scale.ndim == w.ndim``). Group
  scales do not factor out of the dot: :func:`int4_matmul` contracts each
  group, then folds the scales into the f32 partials. On a CUDA device it
  launches the hand-written kernel (``ops/cuda/int4_matmul.py``), which
  reads the packed bytes once and never writes a dequantized copy.

Both rungs are engine config (``ModelConfig.quantization``), applied to any
checkpoint at load time (``engine/weights.py``); no pre-quantized artifacts.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

# The big streamed matmul weights (MoE experts ``[L, E, in, out]`` too: the
# formulas act on the last two axes). Norms, biases, embeddings and the MoE
# router stay high-precision.
QUANT_LAYER_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")

QUANT_METHODS = ("int8", "int4")

# int4 input rows per scale group; divides every preset's matmul input dims.
DEFAULT_INT4_GROUP = 128


def _is_torch(a) -> bool:
    return isinstance(a, torch.Tensor)


def _f32(w):
    return w.to(torch.float32) if _is_torch(w) else w.astype(np.float32)


def _amax(wf, axis: int):
    return wf.abs().amax(dim=axis) if _is_torch(wf) else \
        np.max(np.abs(wf), axis=axis)


def _floor_scale(amax, top: float):
    """max(amax / top, 1e-8) in f32 — the one scale formula."""
    if _is_torch(amax):
        return torch.clamp_min(amax / top, 1e-8).to(torch.float32)
    return np.maximum(amax / top, 1e-8).astype(np.float32)


def _round_clip_int8(v, lim: int):
    if _is_torch(v):
        return torch.clamp(torch.round(v), -lim, lim).to(torch.int8)
    return np.clip(np.round(v), -lim, lim).astype(np.int8)


def quantize_tensor(w):
    """w: [..., in, out] -> (w_q int8 [..., in, out], scale f32 [..., out])."""
    wf = _f32(w)
    scale = _floor_scale(_amax(wf, -2), 127.0)
    return _round_clip_int8(wf / scale[..., None, :], 127), scale


def pack_int4(q):
    """Nibble values ``[..., in, out]`` int8 in [-8, 7] -> packed int8
    ``[..., in/2, out]``: byte ``i`` holds input row ``2i`` in its low
    nibble and ``2i+1`` in its high nibble."""
    if q.shape[-2] % 2:
        raise ValueError(f"int4 packing needs an even input dim, got "
                         f"{q.shape[-2]}")
    if _is_torch(q):
        lo = q[..., 0::2, :].to(torch.uint8) & 0xF
        hi = q[..., 1::2, :].to(torch.uint8) & 0xF
        return (lo | (hi << 4)).view(torch.int8)
    lo = q[..., 0::2, :] & 0xF
    hi = q[..., 1::2, :] & 0xF
    return (lo | (hi << 4)).astype(np.int8)


def unpack_int4(packed):
    """Packed int8 ``[..., in/2, out]`` -> nibble values ``[..., in, out]``
    int8 in [-8, 7] (each nibble sign-extended)."""
    if _is_torch(packed):
        p = packed.to(torch.int16)            # sign-extends the byte
        lo = ((p & 0xF) ^ 8) - 8
        hi = p >> 4                           # arithmetic: -8..7
        out = torch.stack([lo, hi], dim=-2).to(torch.int8)
    else:
        lo = (np.left_shift(packed, 4)).astype(np.int8) >> 4
        hi = packed >> 4
        out = np.stack([lo, hi], axis=-2)     # [..., in/2, 2, out]
    return out.reshape(tuple(packed.shape[:-2]) + (packed.shape[-2] * 2,)
                       + tuple(packed.shape[-1:]))


def _grouped(wf, group_size: int):
    din = wf.shape[-2]
    if din % group_size:
        raise ValueError(
            f"int4 input dim {din} not divisible by group_size {group_size}")
    return wf.reshape(tuple(wf.shape[:-2]) + (din // group_size, group_size)
                      + tuple(wf.shape[-1:]))


def int4_group_scale(w, group_size: int = DEFAULT_INT4_GROUP):
    """w: [..., in, out] -> f32 scales [..., in/group_size, out]: amax/7
    with a 1e-8 floor, per (group, output channel)."""
    return _floor_scale(_amax(_grouped(_f32(w), group_size), -2), 7.0)


def quantize_tensor_int4(w, group_size: int = DEFAULT_INT4_GROUP):
    """w: [..., in, out] -> (packed int8 [..., in/2, out],
    scale f32 [..., in/group_size, out]).

    Symmetric round-to-nearest per (group, output channel); nibbles clipped
    to [-7, 7] so the scale maps amax exactly onto the top code."""
    scale = int4_group_scale(w, group_size)
    wf = _f32(w)
    q = _round_clip_int8(_grouped(wf, group_size) / scale[..., None, :], 7)
    return pack_int4(q.reshape(wf.shape)), scale


def is_packed_int4(w, scale) -> bool:
    """Layout discriminator of the two rungs: group scales carry the extra
    group axis, per-channel scales do not."""
    return str(w.dtype) in ("int8", "torch.int8") and scale is not None \
        and scale.ndim == w.ndim


def int4_matmul_plain(x: torch.Tensor, w_packed: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """``x @ dequant(w_packed)`` term for term as the JAX package's
    ``int4_matmul_xla``: contract each input group (``tgi,gio->tgo``), then
    fold the per-(group, channel) scales into the partials (``tgo,go->to``).
    In fp32 throughout: a bf16 activation times a nibble is exact in fp32.
    x: [T, K]; w_packed: [K/2, N] int8; scale: [K/gs, N] f32 -> f32 [T, N]."""
    n_groups = scale.shape[-2]
    w = unpack_int4(w_packed)                                # [K, N] int8
    gs = w.shape[-2] // n_groups
    wg = w.reshape(n_groups, gs, w.shape[-1]).to(torch.float32)
    xg = x.to(torch.float32).reshape(x.shape[0], n_groups, gs)
    partial = torch.einsum("tgi,gio->tgo", xg, wg)
    # einsum may hand back a strided view; callers (and the kernels after
    # them) take the row-major layout the kernel returns.
    return torch.einsum("tgo,go->to", partial,
                        scale.to(torch.float32)).contiguous()


def int4_matmul(x: torch.Tensor, w_packed: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """Dequant-fused int4 matmul, chosen by device only: a CPU tensor takes
    :func:`int4_matmul_plain`; a CUDA tensor launches the kernel (which
    raises on what it does not take). Returns f32 [T, N]."""
    if x.device.type == "cuda":
        from .cuda.int4_matmul import int4_matmul as kernel
        return kernel(x, w_packed, scale)
    return int4_matmul_plain(x, w_packed, scale)


def quantize_params(params: dict[str, Any], method: str,
                    group_size: int = DEFAULT_INT4_GROUP) -> dict[str, Any]:
    """Quantize the big matmul weights of a models/llama params dict in
    place (returns the same dict). ``method``: "int8" or "int4"."""
    if method not in QUANT_METHODS:
        raise ValueError(
            f"unsupported quantization {method!r} (one of {QUANT_METHODS})")

    def quant(w):
        if method == "int4":
            return quantize_tensor_int4(w, group_size)
        return quantize_tensor(w)

    layers = params["layers"]
    for key in QUANT_LAYER_KEYS:
        if key in layers:
            layers[key], layers[key + "_scale"] = quant(layers[key])
    if "lm_head" in params:
        params["lm_head"], params["lm_head_scale"] = quant(params["lm_head"])
    return params
