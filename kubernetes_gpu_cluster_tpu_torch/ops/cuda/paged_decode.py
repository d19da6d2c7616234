"""Paged decode attention on Hopper: the wrapper of ``csrc/paged_decode.cu``.

Replaces ``ops/pallas/paged_decode.py::pallas_paged_decode`` of the JAX
package. The plain version is ``ops.attention.paged_decode_attention_plain``.

bf16 runs split-K: the grid holds ``splits`` blocks per (sequence, kv
head), each sequence's pooled tokens are cut evenly over them in the kernel
(whole 64-key stages, at least ``min_split`` keys a split), and the last
block of a (sequence, kv head) to finish merges the partials (the kernel's
note says how). ``plan`` sizes the grid from the shapes and the SM count
alone: no call reads a device value on the host. The
workspace for the partials and the counters (all 0 between calls, left 0
by the kernel) come from ``SCRATCH`` (``ops.cuda.Scratch``: one set per
stream, one per capture), sized for the largest grid a split call of the
head geometry can have (``BLOCKS_PER_SM`` blocks per SM), so every decode
bucket's call fits the first set. Shape checks, the plan and a C launch
record are cached per (shapes, dtypes, scale, device) key, so a call makes
its device and contiguity checks, one allocation and one ctypes call. A
key seen once outside a capture can be captured in a CUDA graph.
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

# Keys per stage of the bf16 kernel (csrc kSK, checked against the library
# at load): a split is whole stages.
STAGE_KEYS = 64
# Fewest keys per split; most splits per (sequence, kv head); blocks per SM
# the grid may fill: two waves of the two the bf16 kernel keeps resident.
# One wave loses 1.8x when one long sequence decodes among short ones; a
# grid just past a whole number of waves ends in a tail wave
# (tools/decode_sweep.py). At llama-3-8b's 8 kv heads on 132 SMs: 2 splits
# at B 32, 8 at B 8, 16 at B 1.
MIN_SPLIT_TOKENS = 512
MAX_SPLITS = 16
BLOCKS_PER_SM = 4

_P, _I = ctypes.c_void_p, ctypes.c_int


class Plan(NamedTuple):
    min_split: int      # fewest keys per split, a multiple of STAGE_KEYS
    splits: int         # blocks per (sequence, kv head) in the grid


def plan(B: int, n_kv: int, pps: int, ps: int, sms: int) -> Plan:
    """The grid of a B-row call over ``pps``-page tables of page size
    ``ps`` on a card of ``sms`` SMs: as many splits per (sequence, kv head)
    as fit BLOCKS_PER_SM blocks per SM (at least one), no more
    than MAX_SPLITS, and no more than the table's width holds at
    MIN_SPLIT_TOKENS keys each. From the shapes alone, never from the
    context lengths (those live on the device)."""
    most = min(MAX_SPLITS, cdiv(pps * ps, MIN_SPLIT_TOKENS))
    fit = BLOCKS_PER_SM * sms // max(1, B * n_kv)
    return Plan(MIN_SPLIT_TOKENS, max(1, min(most, fit)))


def split_ranges(p: Plan, n_tok: int) -> list[tuple[int, int]]:
    """Key ranges [lo, hi) of the blocks that run for a sequence with
    ``n_tok`` pooled tokens (``min(max(ctx - 1, 0), pps * ps)``), as the
    kernel computes them: n_tok cut into at most ``p.splits`` splits of
    whole stages, at least ``p.min_split`` keys each; split 0 runs with an
    empty range when n_tok is 0 (its output is the current token's V)."""
    size = max(p.min_split,
               cdiv(cdiv(n_tok, p.splits), STAGE_KEYS) * STAGE_KEYS)
    return [(s * size, min((s + 1) * size, n_tok))
            for s in range(max(1, cdiv(n_tok, size)))]


def workspace_floats(p: Plan, B: int, n_kv: int, g: int, hd: int) -> int:
    """fp32 workspace of a bf16 call: a partial (o [g, hd], m and l [g])
    per split slot of the grid."""
    return p.splits * n_kv * B * g * (hd + 2)


class LaunchArgs(ctypes.Structure):
    """csrc/paged_decode.cu's PagedDecodeLaunch: what every call of one key
    passes unchanged. Written once, when the key is prepared: a call's
    workspace and counters are arguments of the call, so that two threads
    launching one key at once (the GIL is released inside the call) each
    pass their own set."""
    _fields_ = [(f, _I) for f in ("B", "nh", "n_kv", "hd", "ps", "pps",
                                  "dtype", "min_split", "splits")] + [
        ("scale", ctypes.c_float)]


def _lib() -> ctypes.CDLL:
    lib = build.library("paged_decode")
    fn = lib.kgct_paged_decode
    if fn.argtypes is None:
        lib.kgct_paged_decode_stage_keys.argtypes = []
        lib.kgct_paged_decode_stage_keys.restype = _I
        if lib.kgct_paged_decode_stage_keys() != STAGE_KEYS:
            raise RuntimeError("paged_decode: library stage size differs "
                               "from the wrapper's")
        fn.argtypes = [_P] * 10 + [ctypes.POINTER(LaunchArgs), _P]
        fn.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(dev: int) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


class _Launch(NamedTuple):
    """What a call of one key reuses."""
    layers: int         # L of a stacked pool, 0 for a one-layer pool
    layer_bytes: int    # bytes between two layers of a stacked pool
    args: object        # pointer to LaunchArgs, or None when B == 0
    fn: object          # the library's kgct_paged_decode
    ws_floats: int      # workspace and counters a call takes (0: none)
    n_counters: int


# (shapes, dtypes, scale, device index) -> _Launch
_launch_cache: dict[tuple, _Launch] = {}
# The split grid's workspace and counters.
SCRATCH = Scratch()


def _prepare(q, k_pool, v_pool, page_tables, context_lens, k_cur, v_cur,
             scale: float, dev: int) -> _Launch:
    """The dtype and shape checks of a new key, its plan, and the scratch
    its calls take."""
    dtype = check_tensors(
        "paged_decode",
        dict(q=q, k_pool=k_pool, v_pool=v_pool, k_cur=k_cur, v_cur=v_cur),
        dict(page_tables=page_tables, context_lens=context_lens))
    layers, layer_bytes, pool_shape = pool_layers(k_pool)
    if q.dim() != 3 or len(pool_shape) != 3 or k_cur.dim() != 3:
        raise ValueError(f"paged_decode: expected q [B, nh, hd], pool "
                         f"[(L,) P, ps, n_kv*hd], k_cur [B, n_kv, hd]; got "
                         f"{tuple(q.shape)}, {tuple(k_pool.shape)}, "
                         f"{tuple(k_cur.shape)}")
    B, nh, hd = q.shape
    P, ps, kd = pool_shape
    n_kv = k_cur.shape[1]
    check_geometry("paged_decode", nh, n_kv, hd, ps)
    pps = page_tables.shape[-1]
    if (kd != n_kv * hd or tuple(v_pool.shape) != tuple(k_pool.shape)
            or tuple(k_cur.shape) != (B, n_kv, hd)
            or tuple(v_cur.shape) != (B, n_kv, hd)
            or tuple(page_tables.shape) != (B, pps)
            or tuple(context_lens.shape) != (B,)):
        raise ValueError(
            f"paged_decode: inconsistent shapes q={tuple(q.shape)} "
            f"pool={tuple(k_pool.shape)} k_cur={tuple(k_cur.shape)} "
            f"tables={tuple(page_tables.shape)} "
            f"ctx={tuple(context_lens.shape)}")
    fn = _lib().kgct_paged_decode
    if B == 0:
        return _Launch(layers, layer_bytes, None, fn, 0, 0)
    p = plan(B, n_kv, pps, ps, _sm_count(dev))
    ws = cnt = 0
    if dtype == DTYPE_CODES[torch.bfloat16] and p.splits > 1:
        # A split grid holds at most BLOCKS_PER_SM blocks an SM (``plan``:
        # splits * B * n_kv <= slots), so this covers every B of the
        # geometry: ``workspace_floats`` of any such plan is no larger.
        slots = BLOCKS_PER_SM * _sm_count(dev)
        ws, cnt = slots * (nh // n_kv) * (hd + 2), slots
    args = LaunchArgs(B, nh, n_kv, hd, ps, pps, dtype, p.min_split,
                      p.splits, scale)
    return _Launch(layers, layer_bytes, ctypes.pointer(args), fn, ws, cnt)


def paged_decode(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                 page_tables: torch.Tensor, context_lens: torch.Tensor,
                 k_cur: torch.Tensor, v_cur: torch.Tensor, scale: float, *,
                 layer: int | None = None) -> torch.Tensor:
    """q: [B, nh, hd]; k_pool/v_pool: [P, ps, n_kv*hd] (one layer) or
    [L, P, ps, n_kv*hd] with ``layer``; page_tables: [B, pps] int32;
    context_lens: [B] int32 (incl. the current token, 0 on padded rows);
    k_cur/v_cur: [B, n_kv, hd]. Returns [B, nh, hd] in q's dtype."""
    dev = device_of("paged_decode", (q, k_pool, v_pool, page_tables,
                                     context_lens, k_cur, v_cur))
    scale = float(scale)
    key = (q.shape, q.dtype, k_pool.shape, k_pool.dtype, v_pool.shape,
           v_pool.dtype, page_tables.shape, page_tables.dtype,
           context_lens.shape, context_lens.dtype, k_cur.shape, k_cur.dtype,
           v_cur.shape, v_cur.dtype, scale, dev)
    c = _launch_cache.get(key)
    if c is None:
        c = _launch_cache[key] = _prepare(q, k_pool, v_pool, page_tables,
                                          context_lens, k_cur, v_cur, scale,
                                          dev)
    off = layer_offset("paged_decode", c.layers, c.layer_bytes, layer)
    out = torch.empty_like(q)
    if c.args is None:
        return out
    stream = raw_stream(dev)
    ws = cnt = None
    if c.n_counters:
        ws, cnt = SCRATCH.pointers(dev, stream, c.ws_floats, c.n_counters)
    code = c.fn(q.data_ptr(), k_pool.data_ptr() + off,
                v_pool.data_ptr() + off, page_tables.data_ptr(),
                context_lens.data_ptr(), k_cur.data_ptr(), v_cur.data_ptr(),
                out.data_ptr(), ws, cnt, c.args, stream)
    if code:
        build.check_status(_lib(), "paged_decode", code)
    note_launch("paged_decode")
    return out
