"""Chunked-prefill history attention on Hopper: the wrapper of
``csrc/flash_prefill_hist.cu``.

Replaces ``ops/pallas/flash_prefill_hist.py::flash_prefill_history`` of the
JAX package. The plain version is
``ops.attention.prefill_history_attention_plain``.

Shape checks and a C launch record are cached per (shapes, dtypes, scale,
device) key, so a call makes its device and contiguity checks, one
allocation and one ctypes call. The chunk's valid length ``n_valid`` stays
on the device: the caller computes it once per forward (``valid_tokens``)
and every layer's call reads it; a call without it computes it itself.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import (build, check_geometry, check_tensors, device_of,
               layer_offset, pool_layers, raw_stream)

# Kernel launches since the last reset (the caller may set it to 0).
launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int


class LaunchArgs(ctypes.Structure):
    """csrc/flash_prefill_hist.cu's HistLaunch: what every call of one key
    passes unchanged."""
    _fields_ = [(f, _I) for f in ("T", "nh", "n_kv", "hd", "ps", "pps",
                                  "dtype")] + [("scale", ctypes.c_float)]


def _lib() -> ctypes.CDLL:
    lib = build.library("flash_prefill_hist")
    fn = lib.kgct_flash_prefill_hist
    if fn.argtypes is None:
        fn.argtypes = [_P] * 8 + [_I, ctypes.POINTER(LaunchArgs), _P]
        fn.restype = _I
    return lib


def valid_tokens(seg_ids: torch.Tensor) -> torch.Tensor:
    """int32 [1] on seg_ids' device: the chunk's valid tokens
    ``sum(seg_ids >= 0)`` (padding is a tail of -1), never read on the
    host."""
    return (seg_ids >= 0).sum(dtype=torch.int32).reshape(1)


class _Launch(NamedTuple):
    """What a call of one key reuses."""
    layers: int         # L of a stacked pool, 0 for a one-layer pool
    layer_bytes: int    # bytes between two layers of a stacked pool
    args: object        # pointer to LaunchArgs, or None when T == 0
    fn: object          # the library's kgct_flash_prefill_hist


# (shapes, dtypes, scale, device index) -> _Launch
_launch_cache: dict[tuple, _Launch] = {}


def _prepare(q, k, v, seg_ids, k_pool, v_pool, page_table,
             scale: float) -> _Launch:
    dtype = check_tensors(
        "flash_prefill_hist",
        dict(q=q, k=k, v=v, k_pool=k_pool, v_pool=v_pool),
        dict(seg_ids=seg_ids, page_table=page_table))
    layers, layer_bytes, pool_shape = pool_layers(k_pool)
    if q.dim() != 3 or k.dim() != 3 or len(pool_shape) != 3:
        raise ValueError(f"flash_prefill_hist: expected q [T, nh, hd], k "
                         f"[T, n_kv, hd], pool [(L,) P, ps, n_kv*hd]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(k_pool.shape)}")
    T, nh, hd = q.shape
    n_kv = k.shape[1]
    P, ps, kd = pool_shape
    check_geometry("flash_prefill_hist", nh, n_kv, hd, ps)
    if (tuple(k.shape) != (T, n_kv, hd) or tuple(v.shape) != (T, n_kv, hd)
            or kd != n_kv * hd or tuple(v_pool.shape) != tuple(k_pool.shape)
            or tuple(seg_ids.shape) != (T,) or page_table.dim() != 1):
        raise ValueError(
            f"flash_prefill_hist: inconsistent shapes q={tuple(q.shape)} "
            f"k={tuple(k.shape)} pool={tuple(k_pool.shape)} "
            f"table={tuple(page_table.shape)}")
    fn = _lib().kgct_flash_prefill_hist
    if T == 0:
        return _Launch(layers, layer_bytes, None, fn)
    args = LaunchArgs(T, nh, n_kv, hd, ps, page_table.shape[0], dtype, scale)
    return _Launch(layers, layer_bytes, ctypes.pointer(args), fn)


def flash_prefill_hist(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       seg_ids: torch.Tensor, positions: torch.Tensor,
                       k_pool: torch.Tensor, v_pool: torch.Tensor,
                       page_table: torch.Tensor, hist_len: int, scale: float,
                       *, layer: int | None = None,
                       n_valid: torch.Tensor | None = None) -> torch.Tensor:
    """q: [T, nh, hd]; k/v: [T, n_kv, hd] (this chunk); k_pool/v_pool:
    [P, ps, n_kv*hd] or [L, P, ps, n_kv*hd] with ``layer``; page_table:
    [pps] int32; hist_len: tokens already committed (may be 0); seg_ids:
    [T] int32 (0 = chunk token, -1 = tail padding). ``positions`` is implied
    by the flat order and accepted for signature parity. ``n_valid`` is
    ``valid_tokens(seg_ids)`` when the caller has it already (one forward
    shares it across layers); it is computed here otherwise. Returns
    [T, nh, hd]."""
    global launches
    del positions
    dev = device_of("flash_prefill_hist", (q, k, v, seg_ids, k_pool, v_pool,
                                           page_table))
    scale = float(scale)
    key = (q.shape, q.dtype, k.shape, k.dtype, v.shape, v.dtype,
           seg_ids.shape, seg_ids.dtype, k_pool.shape, k_pool.dtype,
           v_pool.shape, v_pool.dtype, page_table.shape, page_table.dtype,
           scale, dev)
    c = _launch_cache.get(key)
    if c is None:
        c = _launch_cache[key] = _prepare(q, k, v, seg_ids, k_pool, v_pool,
                                          page_table, scale)
    hist_len = int(hist_len)
    if hist_len < 0:
        raise ValueError(f"flash_prefill_hist: hist_len {hist_len} < 0")
    off = layer_offset("flash_prefill_hist", c.layers, c.layer_bytes, layer)
    out = torch.empty_like(q)
    if c.args is None:
        return out
    if n_valid is None:
        n_valid = valid_tokens(seg_ids)
    elif (n_valid.dtype != torch.int32 or n_valid.get_device() != dev
          or n_valid.numel() != 1):
        raise ValueError(f"flash_prefill_hist: n_valid must be one int32 on "
                         f"cuda:{dev}, got {n_valid.dtype} "
                         f"{tuple(n_valid.shape)} on {n_valid.device}")
    code = c.fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                k_pool.data_ptr() + off, v_pool.data_ptr() + off,
                page_table.data_ptr(), n_valid.data_ptr(), out.data_ptr(),
                hist_len, c.args, raw_stream(dev))
    if code:
        build.check_status(_lib(), "flash_prefill_hist", code)
    launches += 1
    return out
