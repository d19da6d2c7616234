"""Chunked-prefill history attention on Hopper: the wrapper of
``csrc/flash_prefill_hist.cu``.

Replaces ``ops/pallas/flash_prefill_hist.py::flash_prefill_history`` of the
JAX package. The plain version is
``ops.attention.prefill_history_attention_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, check_geometry, check_tensors, stream_handle

# Kernel launches since the last reset (the caller may set it to 0).
launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.library("flash_prefill_hist")
    fn = lib.kgct_flash_prefill_hist
    if fn.argtypes is None:
        fn.argtypes = [_P] * 8 + [_I] * 7 + [ctypes.c_float, _I, _P]
        fn.restype = _I
    return lib


def flash_prefill_hist(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       seg_ids: torch.Tensor, positions: torch.Tensor,
                       k_pool: torch.Tensor, v_pool: torch.Tensor,
                       page_table: torch.Tensor, hist_len: int, scale: float,
                       *, layer: int | None = None) -> torch.Tensor:
    """q: [T, nh, hd]; k/v: [T, n_kv, hd] (this chunk); k_pool/v_pool:
    [P, ps, n_kv*hd] or [L, P, ps, n_kv*hd] with ``layer``; page_table:
    [pps] int32; hist_len: tokens already committed (may be 0); seg_ids:
    [T] int32 (0 = chunk token, -1 = tail padding). ``positions`` is implied
    by the flat order and accepted for signature parity. Returns
    [T, nh, hd]."""
    global launches
    del positions
    if k_pool.dim() == 4:
        if layer is None:
            raise ValueError("flash_prefill_hist: layer index required for "
                             "a stacked pool")
        k_pool, v_pool = k_pool[layer], v_pool[layer]
    dtype = check_tensors(
        "flash_prefill_hist",
        dict(q=q, k=k, v=v, k_pool=k_pool, v_pool=v_pool),
        dict(seg_ids=seg_ids, page_table=page_table))
    T, nh, hd = q.shape
    n_kv = k.shape[1]
    P, ps, kd = k_pool.shape
    pps = page_table.shape[0]
    check_geometry("flash_prefill_hist", nh, n_kv, hd, ps)
    if (tuple(k.shape) != (T, n_kv, hd) or tuple(v.shape) != (T, n_kv, hd)
            or kd != n_kv * hd or tuple(v_pool.shape) != (P, ps, kd)
            or tuple(seg_ids.shape) != (T,) or page_table.dim() != 1):
        raise ValueError(
            f"flash_prefill_hist: inconsistent shapes q={tuple(q.shape)} "
            f"k={tuple(k.shape)} pool={tuple(k_pool.shape)} "
            f"table={tuple(page_table.shape)}")
    hist_len = int(hist_len)
    if hist_len < 0:
        raise ValueError(f"flash_prefill_hist: hist_len {hist_len} < 0")
    out = torch.empty_like(q)
    if T == 0:
        return out
    n_valid = (seg_ids >= 0).sum(dtype=torch.int32).reshape(1)
    lib = _lib()
    code = lib.kgct_flash_prefill_hist(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), page_table.data_ptr(), n_valid.data_ptr(),
        out.data_ptr(), T, nh, n_kv, hd, ps, pps, hist_len, float(scale),
        dtype, stream_handle(q.device))
    build.check_status(lib, "flash_prefill_hist", code)
    launches += 1
    return out
