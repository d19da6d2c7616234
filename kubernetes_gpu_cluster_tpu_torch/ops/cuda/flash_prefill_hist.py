"""Chunked-prefill history attention on Hopper: the wrapper of
``csrc/flash_prefill_hist.cu``.

Replaces ``ops/pallas/flash_prefill_hist.py::flash_prefill_history`` of the
JAX package. The plain version is
``ops.attention.prefill_history_attention_plain``.

Shape checks and a C launch record are cached per (shapes, dtypes, scale,
device) key, so a call makes its device and contiguity checks, one
allocation and one ctypes call. The chunk's valid length ``n_valid`` and
its history length ``hist_len`` stay on the device as int32 [1] tensors
that the kernel reads: nothing of one chunk is passed by value, so a launch
captured in a CUDA graph serves every chunk a replay writes into them. The
caller computes ``n_valid`` once per forward (``valid_tokens``) and every
layer's call reads it; a call without it computes it itself. ``hist_len``
is the caller's, uploaded once per forward.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import (build, check_geometry, check_tensors, device_of, layer_offset,
               note_launch, pool_layers, raw_stream)

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
        fn.argtypes = [_P] * 9 + [ctypes.POINTER(LaunchArgs), _P]
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


def _check_scalar(name: str, t, dev: int) -> None:
    if not (isinstance(t, torch.Tensor) and t.dtype == torch.int32
            and t.get_device() == dev and t.numel() == 1):
        what = (f"{t.dtype} {tuple(t.shape)} on {t.device}"
                if isinstance(t, torch.Tensor) else type(t).__name__)
        raise ValueError(f"flash_prefill_hist: {name} must be one int32 on "
                         f"cuda:{dev}, got {what}")


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
                       page_table: torch.Tensor, hist_len: torch.Tensor,
                       scale: float,
                       *, layer: int | None = None,
                       n_valid: torch.Tensor | None = None) -> torch.Tensor:
    """q: [T, nh, hd]; k/v: [T, n_kv, hd] (this chunk); k_pool/v_pool:
    [P, ps, n_kv*hd] or [L, P, ps, n_kv*hd] with ``layer``; page_table:
    [pps] int32; hist_len: int32 [1] on the card, tokens already committed
    (may be 0; a negative value reads as 0); seg_ids:
    [T] int32 (0 = chunk token, -1 = tail padding). ``positions`` is implied
    by the flat order and accepted for signature parity. ``n_valid`` is
    ``valid_tokens(seg_ids)`` when the caller has it already (one forward
    shares it across layers); it is computed here otherwise. Returns
    [T, nh, hd]."""
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
    _check_scalar("hist_len", hist_len, dev)
    off = layer_offset("flash_prefill_hist", c.layers, c.layer_bytes, layer)
    out = torch.empty_like(q)
    if c.args is None:
        return out
    if n_valid is None:
        n_valid = valid_tokens(seg_ids)
    else:
        _check_scalar("n_valid", n_valid, dev)
    code = c.fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                k_pool.data_ptr() + off, v_pool.data_ptr() + off,
                page_table.data_ptr(), n_valid.data_ptr(),
                hist_len.data_ptr(), out.data_ptr(), c.args, raw_stream(dev))
    if code:
        build.check_status(_lib(), "flash_prefill_hist", code)
    note_launch("flash_prefill_hist")
    return out
