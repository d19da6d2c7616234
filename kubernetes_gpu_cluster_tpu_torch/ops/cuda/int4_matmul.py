"""W4A16 dequant-fused matmul on Hopper: the wrapper of ``csrc/int4_matmul.cu``.

Replaces ``ops/pallas/int4_matmul.py::pallas_int4_matmul`` of the JAX
package. The plain version is ``ops.quant.int4_matmul_plain``. Unlike the
Pallas wrapper there is no quiet fallback for unaligned dims: the kernel
takes any T and N, and this wrapper raises on what it does not take.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build, stream_handle

# Kernel launches since the last reset (the caller may set it to 0).
launches = 0

X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# One tensor-core step covers 16 input rows and must lie inside one group.
GROUP_MULTIPLE = 16
BLOCK_N = 128           # output columns per block (csrc kBN)
# Split K until the grid holds about this many blocks per SM.
BLOCKS_PER_SM = 2

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.library("int4_matmul")
    fn = lib.kgct_int4_matmul
    if fn.argtypes is None:
        fn.argtypes = [_P] * 5 + [_I] * 9 + [_P]
        fn.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def plan(T: int, K: int, N: int, gs: int, sms: int) -> tuple[int, int, int]:
    """(m16 row tiles per block, K slices, rows per slice) of one launch.
    A block takes up to 64 rows; when the (row tile, column tile) grid
    alone leaves the SMs short (decode), K is cut into slices of whole
    groups, at least two stage widths (256 rows) each."""
    mt = 1 if T <= 16 else 2 if T <= 32 else 4
    tiles = -(-N // BLOCK_N) * -(-T // (16 * mt))
    splits = max(1, min(-(-BLOCKS_PER_SM * sms // tiles), K // max(gs, 256)))
    slice_rows = -(-(-(-K // splits)) // gs) * gs
    return mt, -(-K // slice_rows), slice_rows


def int4_matmul(x: torch.Tensor, w_packed: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x: [T, K] bf16 or f32; w_packed: [K/2, N] int8 (``ops.quant.pack_int4``
    layout); scale: [K/gs, N] f32, gs a multiple of 16. All contiguous on
    one CUDA device. Returns f32 [T, N]."""
    global launches
    for name, t in (("x", x), ("w_packed", w_packed), ("scale", scale)):
        if t.device.type != "cuda":
            raise ValueError(f"int4_matmul: {name} is on {t.device}; the "
                             "kernel takes CUDA tensors only")
        if t.device != x.device:
            raise ValueError(f"int4_matmul: {name} is on {t.device}, "
                             f"expected {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"int4_matmul: {name} must be contiguous")
    if x.dtype not in X_DTYPES:
        raise ValueError(f"int4_matmul: x dtype {x.dtype} not supported "
                         f"(one of {list(X_DTYPES)})")
    if w_packed.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError(f"int4_matmul: w_packed must be int8 and scale "
                         f"float32, got {w_packed.dtype} and {scale.dtype}")
    if x.dim() != 2 or w_packed.dim() != 2 or scale.dim() != 2:
        raise ValueError(
            f"int4_matmul: expected x [T, K], w_packed [K/2, N], scale "
            f"[K/gs, N]; got {tuple(x.shape)}, {tuple(w_packed.shape)}, "
            f"{tuple(scale.shape)} (an int8 per-channel weight has a 1-D "
            "scale and takes the int8 path)")
    T, K = x.shape
    half, N = w_packed.shape
    n_groups = scale.shape[0]
    if half * 2 != K or scale.shape[1] != N:
        raise ValueError(
            f"int4_matmul: w_packed {tuple(w_packed.shape)} and scale "
            f"{tuple(scale.shape)} do not pack x's K={K} into N columns")
    if n_groups == 0 or K % n_groups:
        raise ValueError(f"int4_matmul: K={K} is not a whole number of "
                         f"{n_groups} scale groups")
    gs = K // n_groups
    if gs % GROUP_MULTIPLE:
        raise ValueError(f"int4_matmul: group size {gs} is not a multiple "
                         f"of {GROUP_MULTIPLE}")
    out = torch.empty((T, N), dtype=torch.float32, device=x.device)
    if T == 0 or N == 0:
        return out
    vec = int(N % 16 == 0 and all(t.data_ptr() % 16 == 0
                                  for t in (x, w_packed, scale)))
    mt, splits, slice_rows = plan(T, K, N, gs, _sm_count(x.device))
    ws = (torch.empty((splits, T, N), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    lib = _lib()
    code = lib.kgct_int4_matmul(
        x.data_ptr(), w_packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), T, K, N, gs,
        X_DTYPES[x.dtype], mt, splits, slice_rows, vec,
        stream_handle(x.device))
    build.check_status(lib, "int4_matmul", code)
    launches += 1
    return out
