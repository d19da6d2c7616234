"""Speculative-verification attention on Hopper: the wrapper of
``csrc/spec_verify.cu``.

Replaces no TPU kernel: the JAX package computes this function in XLA
(``ops/attention.py::spec_verify_attention_xla``). The plain version is
``ops.attention.spec_verify_attention_plain``; the kernel's note says why
it exists and how it works.

bf16 runs split-K as ``paged_decode`` does: the grid holds ``splits``
blocks per (row, query group, kv head), each row's pooled tokens are cut
evenly over them in the kernel, and the last block to finish merges the
partials and the in-slice block. ``plan`` sizes the grid from the shapes
and the SM count alone; the contexts stay on the device. A (row, kv head)
has ``S * g`` queries, held by blocks of ``block_rows`` of them (16, 32 or
64: one, two or four 16-row tensor-core tiles), ``groups`` blocks of a
split when there are more than 64. The workspace and counters are this
kernel's own, allocated once per device at the size of the largest grid
a split call can have, and grown (the old ones kept alive for captured
graphs) only for a wider head geometry; launch records are cached per
(shapes, dtypes, scale, device) key, as in ``paged_decode``, and a key
seen once outside a capture can be captured.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ...utils import cdiv
from . import (DTYPE_CODES, build, check_geometry, check_tensors, device_of,
               layer_offset, pool_layers, raw_stream)

# Kernel launches since the last reset (the caller may set it to 0).
launches = 0

# Keys per stage of the bf16 kernel (csrc kSK, checked against the library
# at load); the split rule is paged_decode's (ops/cuda/paged_decode.py).
STAGE_KEYS = 64
MIN_SPLIT_TOKENS = 512
MAX_SPLITS = 16
# Blocks per SM the grid may fill: two waves of the two a bf16 block's
# 87 KB of shared memory (hd 128) lets the card keep resident.
BLOCKS_PER_SM = 4
# Most queries per row (S = k + 1) and per block (four 16-row tiles).
MAX_S = 16
MAX_BLOCK_ROWS = 64

_P, _I = ctypes.c_void_p, ctypes.c_int


def block_rows(M: int) -> int:
    """Queries one block holds for M = S * g queries per (row, kv head):
    the fewest 16-row tiles that hold them, at most four (csrc
    ``block_rows``)."""
    return 16 if M <= 16 else 32 if M <= 32 else MAX_BLOCK_ROWS


class Plan(NamedTuple):
    min_split: int      # fewest keys per split, a multiple of STAGE_KEYS
    splits: int         # blocks per (row, group, kv head) in the grid
    groups: int         # blocks of queries per (row, kv head)


def plan(R: int, S: int, g: int, n_kv: int, pps: int, ps: int,
         sms: int) -> Plan:
    """The grid of an R-row call of S queries a row at g query heads per
    kv head, over ``pps``-page tables of page size ``ps`` on a card of
    ``sms`` SMs: ``paged_decode``'s rule over R * groups rows. From the
    shapes alone, never from the context lengths."""
    M = S * g
    groups = cdiv(M, block_rows(M))
    most = min(MAX_SPLITS, cdiv(pps * ps, MIN_SPLIT_TOKENS))
    fit = BLOCKS_PER_SM * sms // max(1, R * groups * n_kv)
    return Plan(MIN_SPLIT_TOKENS, max(1, min(most, fit)), groups)


def split_ranges(p: Plan, n_tok: int) -> list[tuple[int, int]]:
    """Key ranges [lo, hi) of the blocks that run for a row with ``n_tok``
    pooled tokens, as the kernel cuts them (``paged_decode``'s cut)."""
    size = max(p.min_split,
               cdiv(cdiv(n_tok, p.splits), STAGE_KEYS) * STAGE_KEYS)
    return [(s * size, min((s + 1) * size, n_tok))
            for s in range(max(1, cdiv(n_tok, size)))]


class LaunchArgs(ctypes.Structure):
    """csrc/spec_verify.cu's SpecVerifyLaunch: what every call of one key
    passes unchanged."""
    _fields_ = [("ws", _P), ("counters", _P)] + [
        (f, _I) for f in ("R", "S", "nh", "n_kv", "hd", "ps", "pps", "dtype",
                          "min_split", "splits")] + [
        ("scale", ctypes.c_float)]


def _lib() -> ctypes.CDLL:
    lib = build.library("spec_verify")
    fn = lib.kgct_spec_verify
    if fn.argtypes is None:
        for name in ("kgct_spec_verify_stage_keys", "kgct_spec_verify_max_s"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = _I
        lib.kgct_spec_verify_block_rows.argtypes = [_I]
        lib.kgct_spec_verify_block_rows.restype = _I
        if (lib.kgct_spec_verify_stage_keys() != STAGE_KEYS
                or lib.kgct_spec_verify_max_s() != MAX_S
                or any(lib.kgct_spec_verify_block_rows(m) != block_rows(m)
                       for m in range(1, MAX_S * 16 + 1))):
            raise RuntimeError("spec_verify: library constants differ from "
                               "the wrapper's")
        fn.argtypes = [_P] * 8 + [ctypes.POINTER(LaunchArgs), _P]
        fn.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(dev: int) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


class _Launch(NamedTuple):
    """What a call of one key reuses."""
    layers: int         # L of a stacked pool, 0 for a one-layer pool
    layer_bytes: int    # bytes between two layers of a stacked pool
    args: object        # pointer to LaunchArgs, or None when R == 0
    fn: object          # the library's kgct_spec_verify


# (shapes, dtypes, scale, device index) -> _Launch
_launch_cache: dict[tuple, _Launch] = {}
# Per device index: the current workspace and counters.
_scratch: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
# Outgrown workspaces, kept alive for graphs captured while they were current.
_retired: list[torch.Tensor] = []


def _grow_scratch(dev: int, ws_floats: int, n_counters: int) -> tuple[int, int]:
    ws, cnt = _scratch.get(dev, (None, None))
    grown = False
    if ws is None or ws.numel() < ws_floats:
        if ws is not None:
            _retired.append(ws)
        ws, grown = torch.empty(ws_floats, dtype=torch.float32,
                                device=torch.device("cuda", dev)), True
    if cnt is None or cnt.numel() < n_counters:
        if cnt is not None:
            _retired.append(cnt)
        cnt, grown = torch.zeros(n_counters, dtype=torch.int32,
                                 device=torch.device("cuda", dev)), True
    _scratch[dev] = (ws, cnt)
    if grown:
        for key, c in _launch_cache.items():
            if c.args is not None and key[-1] == dev:
                c.args.contents.ws = ws.data_ptr()
                c.args.contents.counters = cnt.data_ptr()
    return ws.data_ptr(), cnt.data_ptr()


def _prepare(q, k_pool, v_pool, page_tables, context_lens, k_new, v_new,
             scale: float, dev: int) -> _Launch:
    """The dtype and shape checks of a new key, its plan, and the device's
    workspace grown to cover it."""
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
        return _Launch(layers, layer_bytes, None, fn)
    p = plan(R, S, nh // n_kv, n_kv, pps, ps, _sm_count(dev))
    ws = cnt = 0
    if dtype == DTYPE_CODES[torch.bfloat16] and p.splits > 1:
        # A split grid holds at most BLOCKS_PER_SM blocks an SM (``plan``),
        # so this covers every R of the geometry.
        slots = BLOCKS_PER_SM * _sm_count(dev)
        ws, cnt = _grow_scratch(dev, slots * MAX_BLOCK_ROWS * (hd + 2), slots)
    args = LaunchArgs(ws, cnt, R, S, nh, n_kv, hd, ps, pps, dtype,
                      p.min_split, p.splits, scale)
    return _Launch(layers, layer_bytes, ctypes.pointer(args), fn)


def spec_verify(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                k_pool: torch.Tensor, v_pool: torch.Tensor,
                page_tables: torch.Tensor, context_lens: torch.Tensor,
                scale: float, *, layer: int | None = None) -> torch.Tensor:
    """q: [R*S, nh, hd] (row-major slices); k_new/v_new: [R*S, n_kv, hd]
    this step's keys and values; k_pool/v_pool: [P, ps, n_kv*hd] (one
    layer) or [L, P, ps, n_kv*hd] with ``layer``; page_tables: [R, pps]
    int32; context_lens: [R] int32 (committed tokens incl. the slice's
    first, 0 on padding rows). Returns [R*S, nh, hd] in q's dtype."""
    global launches
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
    off = layer_offset("spec_verify", c.layers, c.layer_bytes, layer)
    out = torch.empty_like(q)
    if c.args is None:
        return out
    code = c.fn(q.data_ptr(), k_pool.data_ptr() + off,
                v_pool.data_ptr() + off, page_tables.data_ptr(),
                context_lens.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                out.data_ptr(), c.args, raw_stream(dev))
    if code:
        build.check_status(_lib(), "spec_verify", code)
    launches += 1
    return out
