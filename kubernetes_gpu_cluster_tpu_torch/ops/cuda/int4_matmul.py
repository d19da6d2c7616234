"""W4A16 dequant-fused matmul on Hopper: the wrapper of ``csrc/int4_matmul.cu``.

Replaces ``ops/pallas/int4_matmul.py::pallas_int4_matmul`` of the JAX
package. The plain version is ``ops.quant.int4_matmul_plain``. Unlike the
Pallas wrapper there is no quiet fallback for unaligned dims: the kernel
takes any T and N, and this wrapper raises on what it does not take.

One call is one kernel launch. The kernel splits the work over exactly the
blocks the card keeps resident (``plan``) and sums cut tiles itself, through
a workspace and per-tile counters that this module allocates once per
device and grows on demand. The kernel leaves the counters at 0, so calls
may follow each other, or be captured in a CUDA graph and replayed, without
a reset. Workspace and counters are shared by every call on a device: the
wrapper assumes one stream, as the engine runs.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import build, raw_stream

# Kernel launches since the last reset (the caller may set it to 0).
launches = 0

X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_F32 = torch.float32
# One tensor-core step covers 16 input rows and must lie inside one group.
GROUP_MULTIPLE = 16
# Output columns per tile (csrc kDBN, kPBN; checked against the library at
# load).
DECODE_COLS = 128
PREFILL_COLS = 128
# Rows up to which the decode tile (one row tile, nibbles decoded in
# registers) runs; above it a bf16 x takes the 128-row prefill tile.
DECODE_ROWS = 64
PREFILL_ROWS = 128      # csrc kPBM
DECODE, PREFILL = 0, 1  # kernel kinds (csrc)

_P, _I = ctypes.c_void_p, ctypes.c_int


class Plan(NamedTuple):
    kind: int           # DECODE or PREFILL
    mt: int             # m16 row tiles of a decode tile (0 for prefill)
    tile_rows: int      # output rows per tile
    tile_cols: int      # output columns per tile
    tiles: int          # output tiles
    groups: int         # scale groups along K (work units per tile)
    blocks: int         # the grid: resident blocks, at most one per unit


def _lib() -> ctypes.CDLL:
    lib = build.library("int4_matmul")
    fn = lib.kgct_int4_matmul
    if fn.argtypes is None:
        lib.kgct_int4_matmul_resident.argtypes = [_I] * 3
        lib.kgct_int4_matmul_resident.restype = _I
        lib.kgct_int4_matmul_tile_cols.argtypes = [_I]
        lib.kgct_int4_matmul_tile_cols.restype = _I
        cols = tuple(lib.kgct_int4_matmul_tile_cols(k) for k in (DECODE, PREFILL))
        if cols != (DECODE_COLS, PREFILL_COLS):
            raise RuntimeError(f"int4_matmul: library tile columns {cols} != "
                               f"{(DECODE_COLS, PREFILL_COLS)}")
        fn.argtypes = [_P] * 4 + [ctypes.POINTER(LaunchArgs), ctypes.c_bool,
                                  _P]
        fn.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _resident(x_dtype: int, kind: int, mt: int) -> int:
    """Blocks of one kernel instance an SM keeps resident (occupancy API)."""
    lib = _lib()
    n = lib.kgct_int4_matmul_resident(x_dtype, kind, mt)
    if n < 0:
        build.check_status(lib, "int4_matmul", -n)
    if n == 0:
        raise RuntimeError(f"int4_matmul: kernel (x {x_dtype}, kind {kind}, "
                           f"mt {mt}) fits no SM")
    return n


def tile_shape(T: int, x_bf16: bool) -> tuple[int, int]:
    """(kind, mt) of the kernel a T-row call takes."""
    if T > DECODE_ROWS and x_bf16:
        return PREFILL, 0
    return DECODE, (1 if T <= 16 else 2 if T <= 32 else 4)


# Largest excess of the busiest SM's blocks over the mean that a grid of
# whole-tile slices may have before the balanced grid is taken instead.
ALIGNED_IMBALANCE = 1.05


def plan(T: int, K: int, N: int, gs: int, sms: int, resident: int,
         x_bf16: bool = True, decode_cols: int = DECODE_COLS) -> Plan:
    """The launch of one call: the tile kind and the grid, at most the
    blocks ``sms`` SMs keep resident at ``resident`` blocks each. The
    prefill tile is bound by operations and has many tiles: block b takes
    whole tiles b, b + blocks, ... At decode, block b
    takes units [b U / blocks, (b + 1) U / blocks) of the tile-major list of
    U (tile, group) units (``block_units``), so every block reads the same
    packed bytes to within one group. The grid is either every resident
    block (balanced: every SM gets the same bytes; a block's range may cut
    two tiles), or, when the tiles fill fewer slots, S blocks per tile
    (aligned: each block one slice of one tile, and the blocks of one slice
    index walk the same K rows together), taken when it loads the busiest
    SM at most ALIGNED_IMBALANCE times the mean."""
    kind, mt = tile_shape(T, x_bf16)
    rows = PREFILL_ROWS if kind == PREFILL else 16 * mt
    cols = PREFILL_COLS if kind == PREFILL else decode_cols
    tiles = -(-N // cols) * -(-T // rows)
    groups = K // gs
    slots = sms * resident
    if kind == PREFILL:             # whole tiles, strided over the grid
        return Plan(kind, mt, rows, cols, tiles, groups, min(tiles, slots))
    blocks = min(tiles * groups, slots)
    per_tile = min(slots // tiles, groups)
    if per_tile >= 1:
        aligned = tiles * per_tile
        if -(-aligned // sms) <= ALIGNED_IMBALANCE * aligned / sms:
            blocks = aligned
    return Plan(kind, mt, rows, cols, tiles, groups, blocks)


def block_units(p: Plan, b: int) -> tuple[int, int]:
    """Units [lo, hi) of block b of a decode plan, as the kernel computes
    them (unit u is group u % groups of output tile u // groups)."""
    units = p.tiles * p.groups
    return b * units // p.blocks, (b + 1) * units // p.blocks


@functools.lru_cache(maxsize=4096)
def _plan_for(T: int, K: int, N: int, gs: int, x_dtype: int,
              device: torch.device) -> Plan:
    sms = _sm_count(device)
    kind, mt = tile_shape(T, x_dtype == 1)
    return plan(T, K, N, gs, sms, _resident(x_dtype, kind, mt),
                x_dtype == 1)


class LaunchArgs(ctypes.Structure):
    """csrc/int4_matmul.cu's Int4Launch: what every call of one key passes
    unchanged."""
    _fields_ = [("ws", _P), ("counters", _P)] + [
        (f, _I) for f in ("T", "K", "N", "gs", "x_dtype", "kind", "mt",
                          "blocks")]


class _Launch(NamedTuple):
    """What a call of one (shapes, dtypes, device) key reuses."""
    out_shape: tuple[int, int]
    device: torch.device
    n16: bool                   # N % 16 == 0: 16-byte copies if aligned
    plan: Plan | None           # None: T == 0 or N == 0, nothing to launch
    args: object                # pointer to LaunchArgs, or None
    fn: object                  # the library's kgct_int4_matmul


# (x shape, x dtype, w shape, w dtype, scale shape, scale dtype, device index)
# -> _Launch: the shape checks and the plan run once per key.
_launch_cache: dict[tuple, _Launch] = {}

# Per device index: the workspace (partials of cut tiles, two slots per
# block) and the tile counters (all 0 between calls), grown by ``_prepare``
# only; every cached launch of the device points at the current pair.
_scratch: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}


def _grow_workspace(device: torch.device, p: Plan) -> tuple[int, int]:
    ws, cnt = _scratch.get(device.index, (None, None))
    need_ws = 2 * p.blocks * p.tile_rows * p.tile_cols
    grown = False
    if ws is None or ws.numel() < need_ws:
        ws, grown = torch.empty(need_ws, dtype=torch.float32,
                                device=device), True
    if cnt is None or cnt.numel() < p.tiles:
        cnt, grown = torch.zeros(p.tiles, dtype=torch.int32,
                                 device=device), True
    _scratch[device.index] = (ws, cnt)
    if grown:
        for c in _launch_cache.values():
            if c.args is not None and c.device == device:
                c.args.contents.ws = ws.data_ptr()
                c.args.contents.counters = cnt.data_ptr()
    return ws.data_ptr(), cnt.data_ptr()


def _prepare(x: torch.Tensor, w_packed: torch.Tensor,
             scale: torch.Tensor) -> _Launch:
    """The dtype and shape checks of a new key, its plan, and the device's
    workspace grown to cover it."""
    x_dtype = X_DTYPES.get(x.dtype)
    if x_dtype is None:
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
    if T == 0 or N == 0:
        return _Launch((T, N), x.device, False, None, None, None)
    fn = _lib().kgct_int4_matmul
    p = _plan_for(T, K, N, gs, x_dtype, x.device)
    ws, cnt = _grow_workspace(x.device, p)
    args = LaunchArgs(ws, cnt, T, K, N, gs, x_dtype, p.kind, p.mt, p.blocks)
    return _Launch((T, N), x.device, N % 16 == 0, p, ctypes.pointer(args),
                   fn)


def int4_matmul(x: torch.Tensor, w_packed: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x: [T, K] bf16 or f32; w_packed: [K/2, N] int8 (``ops.quant.pack_int4``
    layout); scale: [K/gs, N] f32, gs a multiple of 16. All contiguous on
    one CUDA device. Returns f32 [T, N].

    Per call the wrapper checks devices and contiguity, looks up the key's
    checked shapes, plan and launch record, allocates the output and
    launches once."""
    global launches
    dev = x.get_device()
    if dev < 0 or w_packed.get_device() != dev or scale.get_device() != dev:
        raise ValueError(f"int4_matmul: x on {x.device}, w_packed on "
                         f"{w_packed.device}, scale on {scale.device}; the "
                         "kernel takes CUDA tensors only, all on one device")
    if not (x.is_contiguous() and w_packed.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError("int4_matmul: x, w_packed and scale must be "
                         "contiguous")
    key = (x.shape, x.dtype, w_packed.shape, w_packed.dtype, scale.shape,
           scale.dtype, dev)
    c = _launch_cache.get(key)
    if c is None:
        c = _launch_cache[key] = _prepare(x, w_packed, scale)
    out = torch.empty(c.out_shape, dtype=_F32, device=c.device)
    if c.args is None:
        return out
    xp, wp, sp = x.data_ptr(), w_packed.data_ptr(), scale.data_ptr()
    code = c.fn(xp, wp, sp, out.data_ptr(), c.args,
                c.n16 and not (xp | wp | sp) & 15, raw_stream(dev))
    if code:
        build.check_status(_lib(), "int4_matmul", code)
    launches += 1
    return out
