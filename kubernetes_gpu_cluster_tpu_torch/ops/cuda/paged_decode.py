"""Paged decode attention on Hopper: the wrapper of ``csrc/paged_decode.cu``.

Replaces ``ops/pallas/paged_decode.py::pallas_paged_decode`` of the JAX
package. The plain version is ``ops.attention.paged_decode_attention_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, check_geometry, check_tensors, stream_handle

# Kernel launches since the last reset (the caller may set it to 0).
launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.library("paged_decode")
    fn = lib.kgct_paged_decode
    if fn.argtypes is None:
        fn.argtypes = [_P] * 8 + [_I] * 6 + [ctypes.c_float, _I, _P]
        fn.restype = _I
    return lib


def paged_decode(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                 page_tables: torch.Tensor, context_lens: torch.Tensor,
                 k_cur: torch.Tensor, v_cur: torch.Tensor, scale: float, *,
                 layer: int | None = None) -> torch.Tensor:
    """q: [B, nh, hd]; k_pool/v_pool: [P, ps, n_kv*hd] (one layer) or
    [L, P, ps, n_kv*hd] with ``layer``; page_tables: [B, pps] int32;
    context_lens: [B] int32 (incl. the current token, 0 on padded rows);
    k_cur/v_cur: [B, n_kv, hd]. Returns [B, nh, hd] in q's dtype."""
    global launches
    if k_pool.dim() == 4:
        if layer is None:
            raise ValueError("paged_decode: layer index required for a "
                             "stacked pool")
        k_pool, v_pool = k_pool[layer], v_pool[layer]
    dtype = check_tensors(
        "paged_decode",
        dict(q=q, k_pool=k_pool, v_pool=v_pool, k_cur=k_cur, v_cur=v_cur),
        dict(page_tables=page_tables, context_lens=context_lens))
    B, nh, hd = q.shape
    P, ps, kd = k_pool.shape
    n_kv = k_cur.shape[1]
    pps = page_tables.shape[1]
    check_geometry("paged_decode", nh, n_kv, hd, ps)
    if (kd != n_kv * hd or tuple(v_pool.shape) != (P, ps, kd)
            or tuple(k_cur.shape) != (B, n_kv, hd)
            or tuple(v_cur.shape) != (B, n_kv, hd)
            or tuple(page_tables.shape) != (B, pps)
            or tuple(context_lens.shape) != (B,)):
        raise ValueError(
            f"paged_decode: inconsistent shapes q={tuple(q.shape)} "
            f"pool={tuple(k_pool.shape)} k_cur={tuple(k_cur.shape)} "
            f"tables={tuple(page_tables.shape)} "
            f"ctx={tuple(context_lens.shape)}")
    out = torch.empty_like(q)
    lib = _lib()
    code = lib.kgct_paged_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_tables.data_ptr(), context_lens.data_ptr(), k_cur.data_ptr(),
        v_cur.data_ptr(), out.data_ptr(), B, nh, n_kv, hd, ps, pps,
        float(scale), dtype, stream_handle(q.device))
    build.check_status(lib, "paged_decode", code)
    launches += 1
    return out
