"""Speculative-verification attention on Hopper: the wrapper of
``csrc/spec_verify.cu``.

Replaces no TPU kernel: the JAX package computes this function in XLA
(``ops/attention.py::spec_verify_attention_xla``). The plain version is
``ops.attention.spec_verify_attention_plain``; the kernel's note says why
it exists and how it works.

bf16 cuts the call into units: segment (row, kv head, query group) has one
unit per 64-key stage of the row's pooled history and one for its slice.
The grid is the blocks the card keeps resident (``plan``: the SM count
times the occupancy API's blocks an SM, one), and block c of the first
P = min(grid, U) takes units [c U / P, (c + 1) U / P); every block
computes U and its range from the contexts on the device, so the host
plans from shapes alone.
``schedule`` mirrors that cut for the tests. A (row, kv head) has
``S * g`` queries, held by ``tile_groups`` 64-row tiles. The kernel
reads the pool through TMA tensor maps over the whole stacked pool
``[L * P * ps, n_kv * hd]`` (``layer_row`` is a layer's first row); a map
holds the pool's address, so the library encodes the pair from each
call's pool pointers. The workspace (two partial slots a block) and
counters come from ``SCRATCH`` (``ops.cuda.Scratch``: one set per stream,
one per capture), grown to the largest call; launch records are cached per
(shapes, dtypes, scale, device) key, as in ``paged_decode``, and a key
seen once outside a capture can be captured.

fp32 keeps the CUDA-core tile: one block per (row, kv head, group of
``block_rows`` queries).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ...utils import cdiv
from . import (DTYPE_CODES, Scratch, build, check_geometry, check_tensors,
               device_of, layer_offset, note_launch, pool_layers, raw_stream)

# Kernel launches since the last reset (the caller may set it to 0).
launches = 0

# Keys per stage and query rows per tile of the bf16 kernel (csrc kSK and
# kTile); the most queries per row (S = k + 1). Checked against the library
# at load.
STAGE_KEYS = 64
TILE_ROWS = 64
MAX_S = 16
# K and V bytes of the bf16 kernel's ring, one block an SM (csrc kRingBytes).
RING_BYTES = 224 * 1024

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def ring_stages(hd: int) -> int:
    """Ring slots of the bf16 kernel: 7 at hd 128, 14 at hd 64."""
    return RING_BYTES // (4 * STAGE_KEYS * hd)


def box_rows(ps: int) -> int:
    """Rows of one TMA box: a page, or a stage's 64-key piece of a larger
    page."""
    return min(ps, STAGE_KEYS)


def stage_boxes(ps: int, hd: int) -> int:
    """TMA boxes of K (and as many of V) a whole stage takes: one per page
    piece and 64-column half of the head."""
    return STAGE_KEYS // box_rows(ps) * (hd // 64)


def layer_row(layer: int, pages: int, ps: int) -> int:
    """The first row of ``layer`` in the map over the stacked pool
    ``[L * pages * ps, n_kv * hd]``."""
    return layer * pages * ps


def tile_groups(M: int) -> int:
    """64-row wgmma tiles over the M = S * g queries of a (row, kv head)."""
    return cdiv(M, TILE_ROWS)


def seg_units(n_tok: int) -> int:
    """Units of one segment over ``n_tok`` pooled keys: its 64-key stages
    and the slice."""
    return cdiv(n_tok, STAGE_KEYS) + 1


def block_rows(M: int) -> int:
    """Queries one fp32 block holds for M = S * g queries per (row, kv
    head): 16, 32 or 64 (csrc ``block_rows``)."""
    return 16 if M <= 16 else 32 if M <= 32 else 64


def plan(sms: int, resident: int) -> int:
    """The bf16 grid: every block the card keeps resident, ``resident`` on
    each of ``sms`` SMs. From the kernel and the card alone, never from
    the context lengths."""
    if resident < 1:
        raise RuntimeError(f"spec_verify: the card keeps {resident} blocks "
                           "of the kernel resident")
    return sms * resident


def block_of(U: int, blocks: int, u: int) -> int:
    """The block whose units [c U / P, (c + 1) U / P) hold unit u (csrc
    ``block_of``)."""
    return ((u + 1) * blocks - 1) // U


class Segment(NamedTuple):
    row: int
    kv_head: int
    group: int
    start: int          # first unit
    units: int          # its stages, then the slice
    blocks: tuple       # contributors, in merge order: (block, slot, lo, hi)


def schedule(ctx, cap: int, n_kv: int, groups: int,
             blocks: int) -> list[Segment]:
    """The kernel's cut of a call, on the host: each segment with the
    blocks that take its units [lo, hi) (segment-relative), found as the
    kernel's merge finds them, and the workspace slot each leaves its
    partial in (2c for block c's first segment, 2c + 1 for its last).
    ``cap``: pooled keys a table covers (pps * ps)."""
    units = [seg_units(min(max(int(c) - 1, 0), cap)) for c in ctx]
    U = n_kv * groups * sum(units)
    blocks = min(blocks, U)             # the blocks that take units
    lo = [U * c // blocks for c in range(blocks + 1)]
    segs, start = [], 0
    for b, u in enumerate(units):
        for seg in range(n_kv * groups):
            parts = tuple(
                (c, 2 * c + (lo[c] < start), max(lo[c], start) - start,
                 min(lo[c + 1], start + u) - start)
                for c in range(block_of(U, blocks, start),
                               block_of(U, blocks, start + u - 1) + 1))
            segs.append(Segment(b, seg // groups, seg % groups, start, u,
                                parts))
            start += u
    return segs


class LaunchArgs(ctypes.Structure):
    """csrc/spec_verify.cu's SpecVerifyLaunch: what every call of one key
    passes unchanged, written once when the key is prepared (a call's
    workspace and counters are arguments of the call)."""
    _fields_ = [
        (f, _I) for f in ("R", "S", "nh", "n_kv", "hd", "ps", "pps", "pages",
                          "layers", "dtype", "blocks")] + [
        ("scale", ctypes.c_float)]


_HOST_MIRRORS = (  # (library function, argument tuples, wrapper function)
    ("stages", [(64,), (128,)], ring_stages),
    ("box_rows", [(ps,) for ps in (8, 16, 32, 64, 128)], box_rows),
    ("stage_boxes", [(ps, hd) for ps in (8, 16, 32, 64, 128)
                     for hd in (64, 128)], stage_boxes),
    ("layer_row", [(0, 512, 16), (1, 512, 16), (31, 6144, 16),
                   (3, 100, 128)], layer_row),
    ("tile_groups", [(m,) for m in range(1, MAX_S * 16 + 1)], tile_groups),
    ("seg_units", [(n,) for n in (0, 1, 63, 64, 65, 8191)], seg_units),
    ("block_rows", [(m,) for m in range(1, MAX_S * 16 + 1)], block_rows),
)


def _lib() -> ctypes.CDLL:
    lib = build.library("spec_verify")
    fn = lib.kgct_spec_verify
    if fn.argtypes is None:
        for name in ("stage_keys", "tile_rows", "max_s"):
            f = getattr(lib, f"kgct_spec_verify_{name}")
            f.argtypes, f.restype = [], _I
        consts = (lib.kgct_spec_verify_stage_keys(),
                  lib.kgct_spec_verify_tile_rows(),
                  lib.kgct_spec_verify_max_s())
        differ = [] if consts == (STAGE_KEYS, TILE_ROWS, MAX_S) else [consts]
        for name, cases, mirror in _HOST_MIRRORS:
            f = getattr(lib, f"kgct_spec_verify_{name}")
            f.argtypes = [_I] * len(cases[0])
            f.restype = _LL if name == "layer_row" else _I
            differ += [(name, c) for c in cases if f(*c) != mirror(*c)]
        if differ:
            raise RuntimeError("spec_verify: library constants differ from "
                               f"the wrapper's: {differ[:4]}")
        lib.kgct_spec_verify_resident.argtypes = [_I]
        lib.kgct_spec_verify_resident.restype = _I
        fn.argtypes = [_P] * 10 + [ctypes.POINTER(LaunchArgs), _I, _P]
        fn.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(dev: int) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


@functools.lru_cache(maxsize=None)
def _resident(dev: int, hd: int) -> int:
    with torch.cuda.device(dev):
        n = _lib().kgct_spec_verify_resident(hd)
    if n < 0:
        build.check_status(_lib(), "spec_verify", -n)
    return n


class _Launch(NamedTuple):
    """What a call of one key reuses."""
    layers: int         # L of a stacked pool, 0 for a one-layer pool
    layer_bytes: int    # bytes between two layers of a stacked pool
    args: object        # pointer to LaunchArgs, or None when R == 0
    fn: object          # the library's kgct_spec_verify
    ws_floats: int      # workspace and counters a call takes (0: none)
    n_counters: int


# (shapes, dtypes, scale, device index) -> _Launch
_launch_cache: dict[tuple, _Launch] = {}
# The split plan's workspace and counters.
SCRATCH = Scratch()


def _prepare(q, k_pool, v_pool, page_tables, context_lens, k_new, v_new,
             scale: float, dev: int) -> _Launch:
    """The dtype and shape checks of a new key, its plan, and the scratch
    its calls take."""
    dtype = check_tensors(
        "spec_verify",
        dict(q=q, k_pool=k_pool, v_pool=v_pool, k_new=k_new, v_new=v_new),
        dict(page_tables=page_tables, context_lens=context_lens))
    layers, layer_bytes, pool_shape = pool_layers(k_pool)
    if (q.dim() != 3 or len(pool_shape) != 3 or k_new.dim() != 3
            or page_tables.dim() != 2):
        raise ValueError(f"spec_verify: expected q [R*S, nh, hd], pool "
                         f"[(L,) P, ps, n_kv*hd], k_new [R*S, n_kv, hd], "
                         f"page_tables [R, pps]; got {tuple(q.shape)}, "
                         f"{tuple(k_pool.shape)}, {tuple(k_new.shape)}, "
                         f"{tuple(page_tables.shape)}")
    T, nh, hd = q.shape
    R, pps = page_tables.shape
    P, ps, kd = pool_shape
    n_kv = k_new.shape[1]
    check_geometry("spec_verify", nh, n_kv, hd, ps)
    S = T // R if R else 0
    if (R and (T != R * S or not 1 <= S <= MAX_S)) or (not R and T):
        raise ValueError(f"spec_verify: {T} query tokens over {R} rows "
                         f"(1 to {MAX_S} tokens a row)")
    if (kd != n_kv * hd or tuple(v_pool.shape) != tuple(k_pool.shape)
            or tuple(k_new.shape) != (T, n_kv, hd)
            or tuple(v_new.shape) != (T, n_kv, hd)
            or tuple(context_lens.shape) != (R,)):
        raise ValueError(
            f"spec_verify: inconsistent shapes q={tuple(q.shape)} "
            f"pool={tuple(k_pool.shape)} k_new={tuple(k_new.shape)} "
            f"tables={tuple(page_tables.shape)} "
            f"ctx={tuple(context_lens.shape)}")
    fn = _lib().kgct_spec_verify
    if R == 0:
        return _Launch(layers, layer_bytes, None, fn, 0, 0)
    blocks = ws = cnt = 0
    if dtype == DTYPE_CODES[torch.bfloat16]:
        blocks = plan(_sm_count(dev), _resident(dev, hd))
        ws = 2 * blocks * TILE_ROWS * (hd + 2)
        cnt = R * n_kv * tile_groups(S * (nh // n_kv))
    args = LaunchArgs(R, S, nh, n_kv, hd, ps, pps, P, max(layers, 1),
                      dtype, blocks, scale)
    return _Launch(layers, layer_bytes, ctypes.pointer(args), fn, ws, cnt)


def spec_verify(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                k_pool: torch.Tensor, v_pool: torch.Tensor,
                page_tables: torch.Tensor, context_lens: torch.Tensor,
                scale: float, *, layer: int | None = None) -> torch.Tensor:
    """q: [R*S, nh, hd] (row-major slices); k_new/v_new: [R*S, n_kv, hd]
    this step's keys and values; k_pool/v_pool: [P, ps, n_kv*hd] (one
    layer) or [L, P, ps, n_kv*hd] with ``layer``; page_tables: [R, pps]
    int32; context_lens: [R] int32 (committed tokens incl. the slice's
    first, 0 on padding rows). Returns [R*S, nh, hd] in q's dtype."""
    dev = device_of("spec_verify", (q, k_new, v_new, k_pool, v_pool,
                                    page_tables, context_lens))
    scale = float(scale)
    key = (q.shape, q.dtype, k_new.shape, k_new.dtype, v_new.shape,
           v_new.dtype, k_pool.shape, k_pool.dtype, v_pool.shape,
           v_pool.dtype, page_tables.shape, page_tables.dtype,
           context_lens.shape, context_lens.dtype, scale, dev)
    c = _launch_cache.get(key)
    if c is None:
        c = _launch_cache[key] = _prepare(q, k_pool, v_pool, page_tables,
                                          context_lens, k_new, v_new, scale,
                                          dev)
    layer_offset("spec_verify", c.layers, c.layer_bytes, layer)  # checks it
    out = torch.empty_like(q)
    if c.args is None:
        return out
    stream = raw_stream(dev)
    ws = cnt = None
    if c.n_counters:
        ws, cnt = SCRATCH.pointers(dev, stream, c.ws_floats, c.n_counters)
    code = c.fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                page_tables.data_ptr(), context_lens.data_ptr(),
                k_new.data_ptr(), v_new.data_ptr(), out.data_ptr(), ws, cnt,
                c.args, layer or 0, stream)
    if code:
        build.check_status(_lib(), "spec_verify", code)
    note_launch("spec_verify")
    return out
