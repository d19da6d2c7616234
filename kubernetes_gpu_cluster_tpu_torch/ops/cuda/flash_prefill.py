"""Ragged flash prefill attention on Hopper: the wrapper of
``csrc/flash_prefill.cu``.

Replaces ``ops/pallas/flash_prefill.py::flash_ragged_prefill`` of the JAX
package. The plain version is
``ops.attention.ragged_prefill_attention_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from ...utils import cdiv
from . import build, check_geometry, check_tensors, raw_stream

# Kernel launches since the last reset (the caller may set it to 0).
launches = 0

# The kernel's tile sizes (csrc/flash_prefill.cu kBQ/kBK; checked against
# the library at load).
BLOCK_Q = 64
BLOCK_K = 64

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.library("flash_prefill")
    fn = lib.kgct_flash_prefill
    if fn.argtypes is None:
        for tile in (lib.kgct_flash_prefill_block_q,
                     lib.kgct_flash_prefill_block_k):
            tile.argtypes, tile.restype = [], _I
        if (lib.kgct_flash_prefill_block_q() != BLOCK_Q
                or lib.kgct_flash_prefill_block_k() != BLOCK_K):
            raise RuntimeError("flash_prefill: library tile sizes differ "
                               "from the wrapper's")
        fn.argtypes = [_P] * 6 + [_I] * 4 + [ctypes.c_float, _I, _P]
        fn.restype = _I
    return lib


def kb_min(seg_ids: torch.Tensor, block_q: int = BLOCK_Q,
           block_k: int = BLOCK_K) -> torch.Tensor:
    """[ceil(T/block_q)] int32: the first K tile each q tile can attend —
    the tile holding the segment start of the q tile's first token.
    Segment ids ascend along the flat index, so that first token belongs to
    the tile's earliest segment. The same window start as the TPU kernel's
    (``flash_prefill.py`` ``kb_min``), from change points and a cummax."""
    T = seg_ids.shape[0]
    seg = seg_ids.to(torch.int32)
    idx = torch.arange(T, dtype=torch.int64, device=seg.device)
    change = torch.ones(T, dtype=torch.bool, device=seg.device)
    change[1:] = seg[1:] != seg[:-1]
    starts = torch.cummax(torch.where(change, idx, 0), dim=0).values
    first = torch.clamp(
        torch.arange(cdiv(T, block_q), device=seg.device) * block_q,
        max=T - 1)
    return (starts[first] // block_k).to(torch.int32)


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  seg_ids: torch.Tensor, positions: torch.Tensor,
                  scale: float, window: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """q: [T, nh, hd]; k/v: [T, n_kv, hd]; seg_ids: [T] int32 (-1 =
    padding). ``positions`` is implied by the flat order (causal within a
    segment) and accepted for signature parity. ``window`` is
    ``kb_min(seg_ids)`` when the caller has it already (one forward shares
    it across layers); it is computed here otherwise. Returns [T, nh, hd]."""
    global launches
    del positions
    dtype = check_tensors("flash_prefill", dict(q=q, k=k, v=v),
                          dict(seg_ids=seg_ids))
    T, nh, hd = q.shape
    n_kv = k.shape[1]
    check_geometry("flash_prefill", nh, n_kv, hd)
    if (tuple(k.shape) != (T, n_kv, hd) or tuple(v.shape) != (T, n_kv, hd)
            or tuple(seg_ids.shape) != (T,)):
        raise ValueError(f"flash_prefill: inconsistent shapes q={tuple(q.shape)}"
                         f" k={tuple(k.shape)} seg={tuple(seg_ids.shape)}")
    out = torch.empty_like(q)
    if T == 0:
        return out
    kbm = kb_min(seg_ids) if window is None else window
    if (kbm.dtype != torch.int32 or kbm.device != q.device
            or tuple(kbm.shape) != (cdiv(T, BLOCK_Q),)):
        raise ValueError(f"flash_prefill: window must be int32 "
                         f"[{cdiv(T, BLOCK_Q)}] on {q.device}, got "
                         f"{kbm.dtype} {tuple(kbm.shape)} on {kbm.device}")
    lib = _lib()
    code = lib.kgct_flash_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_ids.data_ptr(),
        kbm.data_ptr(), out.data_ptr(), T, nh, n_kv, hd, float(scale), dtype,
        raw_stream(q.get_device()))
    build.check_status(lib, "flash_prefill", code)
    launches += 1
    return out
