"""The port's CUDA kernels against their plain PyTorch versions, ON THE CARD.

Marked ``gpu``: each test decides inside the ``cuda_device`` fixture
whether a card is present and skips without one (the CPU tests hold the
plain versions against the JAX package instead). This file imports only
torch and the port, so it also runs on the card's machine, which has no
JAX: ``python -m pytest tests/test_torch_kernels_gpu.py -m gpu
--noconftest -q`` (``tests/conftest.py`` imports JAX).

Tolerances: fp32 atol 1e-4 (online vs dense softmax, different summation
order); bf16 atol 2e-2 (both sides accumulate in fp32 and round the output
once to bf16: 2^-8 relative on outputs of magnitude < ~2.5; the
tensor-core attention kernels also round the probabilities to bf16 before
P.V, about 2^-9 relative per term). The int4
matmul returns fp32 for bf16 and fp32 x alike, and both sides sum exact
products (x times a nibble; an fp32 x enters the tensor cores as three
exact bf16 terms) in fp32 in different orders: max abs error 1e-5 of the
largest output.

The KV transfer layer (host tier, export/import seams) has no kernel of
its own: its gather and scatter are step programs, captured at a key's
first transfer and replayed. Its card cases hold page copies to bit
equality (a replayed key against the same bodies run eagerly too), pin the
host-page reuse fence, and drive small card engines through swap and
import.

Tensor parallelism: two rank processes at tp 2 give the one-card engine's
tokens, over NCCL on two cards (skipped with one) and over gloo with both
ranks on card 0.

Step programs: card engines capture each decode window once per (variant,
bucket), each prefill, solo chunk, mixed, spec and spec×mixed step and
each draft dispatch and reset chunk once per key of the JAX bucket grid,
and replay them; against ``enforce_eager`` engines they give the same
tokens and logprobs, and a body that reads the device from the host fails
its capture, and the cyclic collector is paused while a capture is
open. The verify attention kernel (no TPU kernel: the JAX package
computes it in XLA) holds to its plain version over the whole table, at
split edges, on a padding row and replayed at other contexts. The history kernel reads ``hist_len`` from
device memory: one launch captured in a graph, replayed at several
history lengths written into its buffer, matches the plain version at
each.

Runtime sanitizers: ``KGCT_SANITIZE=1`` on a card engine (n-gram spec,
mixed batching, swap) gives the plain engine's tokens and makes the same
number of synchronizing CUDA calls (``torch.cuda.set_sync_debug_mode``).
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import warnings
from pathlib import Path

import pytest
import torch

from kubernetes_gpu_cluster_tpu_torch.config import (CacheConfig,
                                                     EngineConfig,
                                                     SchedulerConfig,
                                                     get_model_config)
from kubernetes_gpu_cluster_tpu_torch.engine import LLMEngine, SamplingParams
from kubernetes_gpu_cluster_tpu_torch.engine import kv_cache as KV
from kubernetes_gpu_cluster_tpu_torch.engine.step_programs import StepPrograms
from kubernetes_gpu_cluster_tpu_torch.models import llama as M
from kubernetes_gpu_cluster_tpu_torch.ops import attention as A
from kubernetes_gpu_cluster_tpu_torch.ops import quant as Q
from kubernetes_gpu_cluster_tpu_torch.ops.cuda import flash_prefill as cfp
from kubernetes_gpu_cluster_tpu_torch.ops.cuda import flash_prefill_hist as cfh
from kubernetes_gpu_cluster_tpu_torch.ops.cuda import int4_matmul as c4
from kubernetes_gpu_cluster_tpu_torch.ops.cuda import paged_decode as cpd
from kubernetes_gpu_cluster_tpu_torch.ops.cuda import spec_verify as csv

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA and nvcc "
                    "(python3 chip_smoke.py runs the same checks on the card)")
    return torch.device("cuda")


def _segments(T, lens, device):
    seg = torch.full((T,), -1, dtype=torch.int32)
    pos = torch.zeros(T, dtype=torch.int32)
    i = 0
    for s, n in enumerate(lens):
        seg[i:i + n] = s
        pos[i:i + n] = torch.arange(n, dtype=torch.int32)
        i += n
    return seg.to(device), pos.to(device)


def _rn(gen, dtype, device, *shape):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


# The served families' heads at the engine's page size: qwen2.5-7b (a GQA
# group of 7, 9 of the decode tile's 16 rows empty), qwen3-14b (g 5) and
# opt-125m (MHA at hd 64).
FAMILY_GEOMETRIES = [(28, 4, 128, 16), (40, 8, 128, 16), (12, 12, 64, 16)]
GEOMETRIES = [  # nh, n_kv, hd, ps
    (8, 2, 64, 16), (32, 8, 128, 16), (12, 1, 128, 8), (16, 16, 64, 128),
    (8, 4, 128, 32), *FAMILY_GEOMETRIES]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nh,n_kv,hd,ps", GEOMETRIES)
def test_paged_decode_matches_plain(cuda_device, dtype, nh, n_kv, hd, ps):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    B, pps, L = 4, 6, 2
    P = B * pps + 1
    tables = torch.randperm(P - 1, generator=torch.Generator().manual_seed(1)
                            )[:B * pps].reshape(B, pps).to(torch.int32) + 1
    tables[3] = 0                                  # padded row
    ctx = torch.tensor([1, ps + 3, pps * ps, 0], dtype=torch.int32)
    args = (_rn(g, dtype, cuda_device, B, nh, hd),
            _rn(g, dtype, cuda_device, L, P, ps, n_kv * hd),
            _rn(g, dtype, cuda_device, L, P, ps, n_kv * hd),
            tables.to(cuda_device), ctx.to(cuda_device),
            _rn(g, dtype, cuda_device, B, n_kv, hd),
            _rn(g, dtype, cuda_device, B, n_kv, hd), hd ** -0.5)
    before = cpd.launches
    got = cpd.paged_decode(*args, layer=1)
    assert cpd.launches == before + 1
    torch.testing.assert_close(got, A.paged_decode_attention_plain(
        *args, layer=1), atol=TOL[dtype], rtol=0)


def _decode_case(gen, dtype, device, nh, n_kv, hd, ps, ctx, pps, L=2):
    """paged_decode arguments for rows of context lengths ``ctx`` (0 =
    padded row), each on its own random pages of a ``pps``-wide table,
    reading layer 1 of an L-layer pool."""
    ctx = [int(c) for c in ctx]
    need = [-(-max(c - 1, 0) // ps) for c in ctx]
    P = sum(need) + 1
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(11)
                          ).to(torch.int32) + 1
    tables = torch.zeros(len(ctx), pps, dtype=torch.int32)
    o = 0
    for b, n in enumerate(need):
        tables[b, :n] = perm[o:o + n]
        o += n
    B = len(ctx)
    return (_rn(gen, dtype, device, B, nh, hd),
            _rn(gen, dtype, device, L, P, ps, n_kv * hd),
            _rn(gen, dtype, device, L, P, ps, n_kv * hd),
            tables.to(device), torch.tensor(ctx, dtype=torch.int32).to(device),
            _rn(gen, dtype, device, B, n_kv, hd),
            _rn(gen, dtype, device, B, n_kv, hd), hd ** -0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nh,n_kv,hd,ps", GEOMETRIES)
def test_paged_decode_split_contexts(cuda_device, dtype, nh, n_kv, hd, ps):
    """The engine's table width (8192 keys), contexts that end at the
    smallest split's edge and one past it, one page, one token, 4097 and
    8191 (one sequence filling most of the table), a padded row; the same
    bits on a second call (splits merged in a fixed order, counters left
    at 0)."""
    pps = 8192 // ps
    S = cpd.MIN_SPLIT_TOKENS
    ctx = [1, ps, S, S + 1, S + 2, 4097, 8191, 0]     # pooled: ctx - 1
    g = torch.Generator(device=cuda_device).manual_seed(12)
    args = _decode_case(g, dtype, cuda_device, nh, n_kv, hd, ps, ctx, pps)
    before = cpd.launches
    got = cpd.paged_decode(*args, layer=1)
    assert cpd.launches == before + 1
    torch.testing.assert_close(got, A.paged_decode_attention_plain(
        *args, layer=1), atol=TOL[dtype], rtol=0)
    assert torch.equal(got[-1], args[6][-1].repeat_interleave(nh // n_kv, 0))
    assert torch.equal(cpd.paged_decode(*args, layer=1), got)


@pytest.mark.gpu
def test_paged_decode_mixed_step_slice(cuda_device):
    """The mixed step's decode half: q, k and v are row slices of the
    step's token axis (contiguous views at an offset)."""
    nh, n_kv, hd, ps, n_prefill = 32, 8, 128, 16, 300
    ctx = [700, 1, 0, 2000, 257]
    g = torch.Generator(device=cuda_device).manual_seed(13)
    q, kp, vp, tables, t_ctx, kc, vc, scale = _decode_case(
        g, torch.bfloat16, cuda_device, nh, n_kv, hd, ps, ctx, 512)
    B = len(ctx)
    q_all = _rn(g, torch.bfloat16, cuda_device, n_prefill + B, nh, hd)
    k_all = _rn(g, torch.bfloat16, cuda_device, n_prefill + B, n_kv, hd)
    v_all = _rn(g, torch.bfloat16, cuda_device, n_prefill + B, n_kv, hd)
    q_all[n_prefill:], k_all[n_prefill:], v_all[n_prefill:] = q, kc, vc
    args = (q_all[n_prefill:], kp, vp, tables, t_ctx, k_all[n_prefill:],
            v_all[n_prefill:], scale)
    got = cpd.paged_decode(*args, layer=1)
    torch.testing.assert_close(got, A.paged_decode_attention_plain(
        *args, layer=1), atol=TOL[torch.bfloat16], rtol=0)
    assert torch.equal(got, cpd.paged_decode(q, kp, vp, tables, t_ctx, kc, vc,
                                             scale, layer=1))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nh,n_kv,hd,ps", GEOMETRIES)
def test_flash_prefill_matches_plain(cuda_device, dtype, nh, n_kv, hd, ps):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    T = 150                                        # not a multiple of 64
    seg, pos = _segments(T, [40, 1, 70, 29], cuda_device)   # + 10 padding
    args = (_rn(g, dtype, cuda_device, T, nh, hd),
            _rn(g, dtype, cuda_device, T, n_kv, hd),
            _rn(g, dtype, cuda_device, T, n_kv, hd), seg, pos, hd ** -0.5)
    got = cfp.flash_prefill(*args)
    torch.testing.assert_close(got, A.ragged_prefill_attention_plain(*args),
                               atol=TOL[dtype], rtol=0)
    assert torch.all(got[seg < 0] == 0)


# llama-3-8b heads at engine shapes; the bf16 kernel's 64-row q tiles and
# 64-key tiles meet segment starts in the middle of a tile, T % 64 != 0,
# T < 64 and padding rows.
PREFILL_LAYOUTS = {
    "4x512": (2048, [512] * 4),
    "one_2048": (2048, [2048]),
    "1100_mid_tile": (1100, [37, 300, 1, 129, 90, 500, 13]),    # + 30 padding
    "16x128": (2048, [128] * 16),
    "short_50": (50, [20, 25]),                                  # + 5 padding
    "short_1": (1, [1]),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", sorted(PREFILL_LAYOUTS))
def test_flash_prefill_engine_layouts(cuda_device, dtype, layout):
    T, lens = PREFILL_LAYOUTS[layout]
    g = torch.Generator(device=cuda_device).manual_seed(6)
    seg, pos = _segments(T, lens, cuda_device)
    nh, n_kv, hd = 32, 8, 128
    args = (_rn(g, dtype, cuda_device, T, nh, hd),
            _rn(g, dtype, cuda_device, T, n_kv, hd),
            _rn(g, dtype, cuda_device, T, n_kv, hd), seg, pos, hd ** -0.5)
    before = cfp.launches
    got = cfp.flash_prefill(*args)
    assert cfp.launches == before + 1
    torch.testing.assert_close(got, A.ragged_prefill_attention_plain(*args),
                               atol=TOL[dtype], rtol=0)
    assert torch.all(got[seg < 0] == 0)
    # The window computed once by the caller gives the same bits, and so
    # does a second call: no atomics, no order dependence.
    again = cfp.flash_prefill(*args, window=cfp.kb_min(seg))
    assert torch.equal(got, again)


@pytest.mark.gpu
def test_flash_prefill_padding_only_tiles(cuda_device):
    """A 64-row q tile made only of padding stores zeros and skips its keys."""
    T = 200
    seg, pos = _segments(T, [60], cuda_device)          # tiles 1..3: padding
    g = torch.Generator(device=cuda_device).manual_seed(8)
    args = (_rn(g, torch.bfloat16, cuda_device, T, 8, 64),
            _rn(g, torch.bfloat16, cuda_device, T, 2, 64),
            _rn(g, torch.bfloat16, cuda_device, T, 2, 64), seg, pos, 0.125)
    got = cfp.flash_prefill(*args)
    assert torch.all(got[60:] == 0)
    torch.testing.assert_close(got, A.ragged_prefill_attention_plain(*args),
                               atol=TOL[torch.bfloat16], rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hist_len", [0, 37, 200])
@pytest.mark.parametrize("nh,n_kv,hd,ps", GEOMETRIES[:3] + FAMILY_GEOMETRIES)
def test_flash_prefill_hist_matches_plain(cuda_device, dtype, hist_len, nh,
                                          n_kv, hd, ps):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    T, n_valid, L = 70, 53, 2
    pps = -(-(hist_len + T) // ps) + 2
    P = pps + 1
    table = (torch.randperm(P - 1, generator=torch.Generator().manual_seed(4))
             + 1).to(torch.int32)[:pps]
    seg = torch.where(torch.arange(T) < n_valid, 0, -1).to(torch.int32)
    args = (_rn(g, dtype, cuda_device, T, nh, hd),
            _rn(g, dtype, cuda_device, T, n_kv, hd),
            _rn(g, dtype, cuda_device, T, n_kv, hd), seg.to(cuda_device),
            (torch.arange(T, dtype=torch.int32) + hist_len).to(cuda_device),
            _rn(g, dtype, cuda_device, L, P, ps, n_kv * hd),
            _rn(g, dtype, cuda_device, L, P, ps, n_kv * hd),
            table.to(cuda_device), _scalar(hist_len, cuda_device),
            hd ** -0.5)
    got = cfh.flash_prefill_hist(*args, layer=1)
    torch.testing.assert_close(got, A.prefill_history_attention_plain(
        *args, layer=1), atol=TOL[dtype], rtol=0)
    assert torch.all(got[n_valid:] == 0)


# (chunk T, valid tokens, history): engine chunks (512 over 2048; the second
# chunk of a 3000-token prompt; a short chunk over a long history), no
# history, a history that is a multiple of neither 64 nor ps, and a chunk
# whose padding leaves q tiles made only of padding.
HIST_CASES = {
    "512_over_2048": (512, 512, 2048),
    "952_pad_over_2048": (1024, 952, 2048),
    "2048_over_952": (2048, 2048, 952),
    "64_over_6000": (64, 64, 6000),
    "hist_0": (300, 300, 0),
    "hist_1037": (200, 200, 1037),
    "padding_tiles": (300, 100, 77),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(HIST_CASES))
def test_flash_prefill_hist_engine_shapes(cuda_device, dtype, case):
    T, n_valid, hist_len = HIST_CASES[case]
    nh, n_kv, hd, ps, L = 32, 8, 128, 16, 2
    pps = -(-(hist_len + T) // ps)
    P = pps + 1
    table = (torch.randperm(P - 1, generator=torch.Generator().manual_seed(14))
             + 1).to(torch.int32)
    seg = torch.where(torch.arange(T) < n_valid, 0, -1).to(torch.int32)
    g = torch.Generator(device=cuda_device).manual_seed(15)
    args = (_rn(g, dtype, cuda_device, T, nh, hd),
            _rn(g, dtype, cuda_device, T, n_kv, hd),
            _rn(g, dtype, cuda_device, T, n_kv, hd), seg.to(cuda_device),
            (torch.arange(T, dtype=torch.int32) + hist_len).to(cuda_device),
            _rn(g, dtype, cuda_device, L, P, ps, n_kv * hd),
            _rn(g, dtype, cuda_device, L, P, ps, n_kv * hd),
            table.to(cuda_device), _scalar(hist_len, cuda_device),
            hd ** -0.5)
    before = cfh.launches
    got = cfh.flash_prefill_hist(*args, layer=1)
    assert cfh.launches == before + 1
    torch.testing.assert_close(got, A.prefill_history_attention_plain(
        *args, layer=1), atol=TOL[dtype], rtol=0)
    assert torch.all(got[n_valid:] == 0)
    # n_valid computed once by the caller gives the same bits, and so does
    # a second call.
    again = cfh.flash_prefill_hist(*args, layer=1,
                                   n_valid=cfh.valid_tokens(args[3]))
    assert torch.equal(got, again)


def _hist_args(gen, dtype, device, nh, n_kv, hd, ps, T, n_valid, hist_len,
               L, pps, seed):
    """flash_prefill_hist arguments: a T-token chunk (``n_valid`` real) over
    ``hist_len`` pooled tokens on random pages of a ``pps``-wide table,
    layer 1 of an L-layer pool."""
    P = pps + 1
    table = (torch.randperm(P - 1, generator=torch.Generator().manual_seed(
        seed)) + 1).to(torch.int32)
    seg = torch.where(torch.arange(T) < n_valid, 0, -1).to(torch.int32)
    return (_rn(gen, dtype, device, T, nh, hd),
            _rn(gen, dtype, device, T, n_kv, hd),
            _rn(gen, dtype, device, T, n_kv, hd), seg.to(device),
            (torch.arange(T, dtype=torch.int32) + hist_len).to(device),
            _rn(gen, dtype, device, L, P, ps, n_kv * hd),
            _rn(gen, dtype, device, L, P, ps, n_kv * hd),
            table.to(device), _scalar(hist_len, device), hd ** -0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_prefill_hist_captured_once_replayed_per_hist_len(cuda_device,
                                                                dtype):
    """One launch captured in a CUDA graph serves every chunk: the history
    length is read from its int32 [1] buffer at each replay (none baked
    into the graph), so replays at four lengths written into that buffer
    each match the plain version at that length; a negative length reads
    as no history."""
    nh, n_kv, hd, ps, T, n_valid, pps = 32, 8, 128, 16, 256, 230, 128
    g = torch.Generator(device=cuda_device).manual_seed(31)
    args = list(_hist_args(g, dtype, cuda_device, nh, n_kv, hd, ps, T,
                           n_valid, 1500, 2, pps, 32))
    hist = args[8]
    n_valid_t = cfh.valid_tokens(args[3])
    cfh.flash_prefill_hist(*args, layer=1, n_valid=n_valid_t)  # warm-up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = cfh.flash_prefill_hist(*args, layer=1, n_valid=n_valid_t)
    for h in (0, 37, 1500, 2000 - T):
        hist.fill_(h)
        args[4].copy_(torch.arange(T, dtype=torch.int32,
                                   device=cuda_device) + h)
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(out, A.prefill_history_attention_plain(
            *args, layer=1), atol=TOL[dtype], rtol=0)
    hist.fill_(-5)
    graph.replay()
    hist.fill_(0)
    torch.testing.assert_close(out, A.prefill_history_attention_plain(
        *args, layer=1), atol=TOL[dtype], rtol=0)


def _scalar(value: int, device) -> torch.Tensor:
    """An int32 [1] on ``device``: how the kernel takes ``hist_len``."""
    return torch.tensor([value], dtype=torch.int32, device=device)


@pytest.mark.gpu
def test_split_calls_on_two_streams_at_once_share_no_scratch(cuda_device):
    """An engine's capture warm-up runs on its side stream while another
    engine's thread launches on the default one: split-K calls on the two
    streams at once, from two threads, give the bits of the same call made
    alone, and leave every counter at 0; again with the interpreter's
    switch interval at its floor, so that the threads' wrapper calls
    interleave as finely as they can (each call passes its own stream's
    workspace and counters to the kernel)."""
    import threading
    g = torch.Generator(device=cuda_device).manual_seed(5)
    args = _decode_case(g, torch.bfloat16, cuda_device, 32, 8, 128, 16,
                        [2048, 1500, 700, 1], 128)
    want = cpd.paged_decode(*args, layer=1)
    torch.cuda.synchronize()
    outs = {}
    go = threading.Barrier(2)

    def run(name, stream):
        with torch.cuda.stream(stream):
            go.wait()
            outs[name] = [cpd.paged_decode(*args, layer=1)
                          for _ in range(200)]
        stream.synchronize()
    interval = sys.getswitchinterval()
    # Then again with the interpreter switching threads as often as it can
    # (1 us): the wrappers' calls interleave as finely as they may.
    for switch in (interval, 1e-6):
        sys.setswitchinterval(switch)
        try:
            other = threading.Thread(target=run,
                                     args=("side", torch.cuda.Stream()))
            other.start()
            run("default", torch.cuda.current_stream())
            other.join()
        finally:
            sys.setswitchinterval(interval)
        for name, got in outs.items():
            assert all(torch.equal(o, want) for o in got), (name, switch)
        assert cpd.SCRATCH.counters_in_use() == 0


@pytest.mark.gpu
def test_two_pools_interleaved_through_one_wrapper(cuda_device):
    """Draft-model speculation alternates the target pool and the draft
    model's pool on one stream: llama-3-8b heads over a 4-layer pool and
    tinyllama heads (32 / 4 / 64) over a 3-layer pool with another page
    count. ``paged_decode`` (contexts long enough to split, so both keys
    share the device's split-K workspace and self-resetting counters) and
    ``flash_prefill_hist`` each match the plain version on both pools, and
    three rounds of interleaved calls give the same bits every round."""
    g = torch.Generator(device=cuda_device).manual_seed(21)
    dt = torch.bfloat16
    decode = [_decode_case(g, dt, cuda_device, 32, 8, 128, 16,
                           [700, 4097, 1, 2000, 0], 512, L=4),
              _decode_case(g, dt, cuda_device, 32, 4, 64, 16,
                           [690, 4090, 3, 1990, 0, 35], 512, L=3)]
    hist = [_hist_args(g, dt, cuda_device, 32, 8, 128, 16, 128, 100, 900, 4,
                       64, 22),
            _hist_args(g, dt, cuda_device, 32, 4, 64, 16, 64, 64, 300, 3,
                       32, 23)]
    want_d = [A.paged_decode_attention_plain(*c, layer=1) for c in decode]
    want_h = [A.prefill_history_attention_plain(*c, layer=1) for c in hist]
    rounds = []
    for _ in range(3):
        outs = []
        for dc, hc, wd, wh in zip(decode, hist, want_d, want_h):
            before = cpd.launches, cfh.launches
            outs.append(cpd.paged_decode(*dc, layer=1))
            outs.append(cfh.flash_prefill_hist(*hc, layer=1))
            assert (cpd.launches, cfh.launches) == (before[0] + 1,
                                                    before[1] + 1)
            torch.testing.assert_close(outs[-2], wd, atol=TOL[dt], rtol=0)
            torch.testing.assert_close(outs[-1], wh, atol=TOL[dt], rtol=0)
        rounds.append(outs)
    for later in rounds[1:]:
        assert all(torch.equal(a, b) for a, b in zip(rounds[0], later))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spec_mixed_attention_chunk_half_through_the_kernel(cuda_device,
                                                            dtype):
    """A spec×mixed step's attention at llama-3-8b heads: a 512-slot chunk
    (470 real tokens over 1037 pooled) through the history kernel, then 8
    verify rows of S 5 (one padding) through the plain verify attention.
    Each half equals its plain version (the verify half through the
    verify kernel, fed row slices of the step's token axis); the chunk
    length computed once (``n_valid``) gives the same bits."""
    nh, n_kv, hd, ps, L = 32, 8, 128, 16, 2
    Tp, n_real, hist_len, R, S = 512, 470, 1037, 8, 5
    g = torch.Generator(device=cuda_device).manual_seed(24)
    chunk = _hist_args(g, dtype, cuda_device, nh, n_kv, hd, ps, Tp, n_real,
                       hist_len, L, 128, 25)
    q, k, v, seg_c, pos_c, kp, vp, table, _, scale = chunk
    ctx = torch.tensor([1, 17, 300, 1500, 64, 700, 2047, 0],
                       dtype=torch.int32)
    pps = 128
    tables = torch.randint(1, kp.shape[1], (R, pps),
                           generator=torch.Generator().manual_seed(26),
                           dtype=torch.int32)
    tables[ctx == 0] = 0
    qs = _rn(g, dtype, cuda_device, R * S, nh, hd)
    ks = _rn(g, dtype, cuda_device, R * S, n_kv, hd)
    vs = _rn(g, dtype, cuda_device, R * S, n_kv, hd)
    seg = torch.cat([seg_c, torch.repeat_interleave(
        torch.arange(R, dtype=torch.int32, device=cuda_device), S)])
    seg[Tp + (R - 1) * S:] = -1
    pos = torch.cat([pos_c, torch.zeros(R * S, dtype=torch.int32,
                                        device=cuda_device)])
    args = (torch.cat([q, qs]), torch.cat([k, ks]), torch.cat([v, vs]), seg,
            pos, kp, vp, table[None], _scalar(hist_len, cuda_device),
            tables.to(cuda_device), ctx.to(cuda_device), scale)
    before = cfh.launches, csv.launches
    got = A.spec_mixed_attention(*args, n_prefill=Tp, layer=1)
    assert (cfh.launches, csv.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got[:Tp], A.prefill_history_attention_plain(
        q, k, v, seg_c, pos_c, kp, vp, table, hist_len, scale, layer=1),
        atol=TOL[dtype], rtol=0)
    torch.testing.assert_close(got[Tp:], A.spec_verify_attention_plain(
        qs, ks, vs, kp, vp, tables.to(cuda_device), ctx.to(cuda_device),
        scale, layer=1), atol=TOL[dtype], rtol=0)
    again = A.spec_mixed_attention(*args, n_prefill=Tp, layer=1,
                                   n_valid=cfh.valid_tokens(seg_c))
    assert torch.equal(got, again)


def _verify_case(gen, dtype, device, nh, n_kv, hd, ps, ctx, pps, S, L=2):
    """Verify arguments for rows of context lengths ``ctx`` (0 = padding
    row) over a ``pps``-wide table, as the engine passes it: each row's
    pages random, the rest of its columns on the scrap page 0."""
    q, kp, vp, tables, t_ctx, _, _, scale = _decode_case(
        gen, dtype, device, nh, n_kv, hd, ps, ctx, pps, L)
    R = len(ctx)
    return (_rn(gen, dtype, device, R * S, nh, hd),
            _rn(gen, dtype, device, R * S, n_kv, hd),
            _rn(gen, dtype, device, R * S, n_kv, hd), kp, vp, tables, t_ctx,
            scale)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [2, 5, 9])
@pytest.mark.parametrize("nh,n_kv,hd,ps", GEOMETRIES)
def test_spec_verify_matches_plain(cuda_device, dtype, S, nh, n_kv, hd, ps):
    """Rows of one token, a page and a few, the whole table and a padding
    row, at every head geometry (up to 144 queries a kv head: three
    blocks of 64), S 2, 5 and 9."""
    pps = 6
    ctx = [1, ps + 3, pps * ps, 0, 2 * ps]
    g = torch.Generator(device=cuda_device).manual_seed(40 + S)
    args = _verify_case(g, dtype, cuda_device, nh, n_kv, hd, ps, ctx, pps, S)
    before = csv.launches
    got = csv.spec_verify(*args, layer=1)
    assert csv.launches == before + 1
    torch.testing.assert_close(got, A.spec_verify_attention_plain(
        *args, layer=1), atol=TOL[dtype], rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R", [1, 8, 32])
def test_spec_verify_split_contexts(cuda_device, dtype, R):
    """llama-3-8b heads over the engine's table (8192 keys): contexts at a
    stage's edge and past it, 4097 and 8191 keys, a padding row; at R 1
    the row's eight segments are cut over every block of the grid, at R 32
    most segments over two or three. The same bits on a second call
    (partials merged in block order, counters left at 0)."""
    nh, n_kv, hd, ps, S = 32, 8, 128, 16, 5
    K = csv.STAGE_KEYS
    base = [8191, 1, ps, K, K + 1, K + 2, 4097, 0]
    ctx = (base * 4)[:R] if R > 1 else [8191]
    g = torch.Generator(device=cuda_device).manual_seed(41)
    args = _verify_case(g, dtype, cuda_device, nh, n_kv, hd, ps, ctx,
                        8192 // ps, S)
    got = csv.spec_verify(*args, layer=1)
    torch.testing.assert_close(got, A.spec_verify_attention_plain(
        *args, layer=1), atol=TOL[dtype], rtol=0)
    assert torch.equal(csv.spec_verify(*args, layer=1), got)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spec_verify_captured_once_replayed_per_context(cuda_device, dtype):
    """One launch captured in a CUDA graph serves every verify step: each
    row's context is read from the device at each replay (none baked into
    the graph), so replays at other contexts written into that buffer
    match the plain version at each."""
    nh, n_kv, hd, ps, S, pps = 32, 8, 128, 16, 5, 128
    g = torch.Generator(device=cuda_device).manual_seed(42)
    args = list(_verify_case(g, dtype, cuda_device, nh, n_kv, hd, ps,
                             [2048] * 8, pps, S))
    ctx = args[6]
    csv.spec_verify(*args, layer=1)                       # warm-up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = csv.spec_verify(*args, layer=1)
    for lens in ([2048] * 8, [1, 0, 700, 2048, 513, 64, 1999, 3],
                 [0] * 8):
        ctx.copy_(torch.tensor(lens, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(out, A.spec_verify_attention_plain(
            *args, layer=1), atol=TOL[dtype], rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("ps", [16, 64])
@pytest.mark.parametrize("nh,n_kv,S", [(8, 8, 5), (32, 8, 5), (28, 4, 5),
                                       (32, 8, 16), (32, 4, 9), (16, 1, 16)])
def test_spec_verify_tile_regimes(cuda_device, nh, n_kv, S, ps):
    """bf16 at M = S * g queries a (row, kv head) in each tile regime: 5,
    20 (llama-3-8b), 35 (qwen2.5-7b's g 7), 64 (one full tile), 72 (two
    tiles) and 256 (four), over contexts at page and stage edges (1, ps,
    64, 65, 8191 and beside them) and padding rows, against the plain
    version; the same bits on a second call."""
    hd = 128
    ctx = [1, ps, 64, 65, 8191, 0, ps + 1, 129, 0, 2]
    g = torch.Generator(device=cuda_device).manual_seed(43 + S)
    args = _verify_case(g, torch.bfloat16, cuda_device, nh, n_kv, hd, ps,
                        ctx, 8192 // ps, S)
    before = csv.launches
    got = csv.spec_verify(*args, layer=1)
    assert csv.launches == before + 1
    torch.testing.assert_close(got, A.spec_verify_attention_plain(
        *args, layer=1), atol=TOL[torch.bfloat16], rtol=0)
    assert torch.equal(csv.spec_verify(*args, layer=1), got)


@pytest.mark.gpu
def test_spec_verify_two_pools_of_one_shape(cuda_device):
    """A target's and a draft's pools of one shape, read alternately through
    one wrapper: each call reads its own pool (a tensor map holds a pool's
    address; the launch encodes the pair from each call's pool pointers),
    layer 0 and layer 1 alike."""
    nh, n_kv, hd, ps, S = 32, 8, 128, 16, 5
    ctx = [700, 1, 2048, 0, 65]
    g = torch.Generator(device=cuda_device).manual_seed(44)
    a = _verify_case(g, torch.bfloat16, cuda_device, nh, n_kv, hd, ps, ctx,
                     128, S)
    b = list(_verify_case(g, torch.bfloat16, cuda_device, nh, n_kv, hd, ps,
                          ctx, 128, S))
    b[:3] = a[:3]                       # the same queries, other pools
    want = {id(x): {layer: A.spec_verify_attention_plain(*x, layer=layer)
                    for layer in (0, 1)} for x in (a, b)}
    outs = {}
    for _ in range(2):
        for x in (a, b, a, b):
            for layer in (1, 0):
                got = csv.spec_verify(*x, layer=layer)
                torch.testing.assert_close(got, want[id(x)][layer],
                                           atol=TOL[torch.bfloat16], rtol=0)
                key = (id(x), layer)
                assert key not in outs or torch.equal(outs[key], got)
                outs[key] = got
    assert not torch.equal(outs[(id(a), 1)], outs[(id(b), 1)])


@pytest.mark.gpu
def test_spec_verify_replays_are_bit_identical(cuda_device):
    """One bf16 launch captured once, replayed twice at each of several
    contexts written into its buffer: both replays and an eager call at
    those contexts give the same bits."""
    nh, n_kv, hd, ps, S, pps = 32, 8, 128, 16, 5, 512
    g = torch.Generator(device=cuda_device).manual_seed(45)
    args = list(_verify_case(g, torch.bfloat16, cuda_device, nh, n_kv, hd,
                             ps, [8191] * 8, pps, S))
    ctx = args[6]
    csv.spec_verify(*args, layer=1)                       # warm-up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = csv.spec_verify(*args, layer=1)
    for lens in ([8191] * 8, [1, 0, 64, 65, 8191, 513, 2, 4096],
                 [0] * 8, [16, 17, 1000, 1, 0, 3000, 8000, 63]):
        ctx.copy_(torch.tensor(lens, dtype=torch.int32))
        graph.replay()
        first = out.clone()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(first, out)
        assert torch.equal(csv.spec_verify(*args, layer=1), out)
        torch.testing.assert_close(out, A.spec_verify_attention_plain(
            *args, layer=1), atol=TOL[torch.bfloat16], rtol=0)


@pytest.mark.gpu
def test_wrappers_reject_unsupported_geometry(cuda_device):
    q = torch.zeros(2, 4, 96, device=cuda_device)         # hd 96
    k = torch.zeros(2, 2, 96, device=cuda_device)
    seg = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        cfp.flash_prefill(q, k, k, seg, seg, 0.1)
    q = torch.zeros(1, 4, 64, device=cuda_device)
    pool = torch.zeros(3, 12, 128, device=cuda_device)    # ps 12
    cur = torch.zeros(1, 2, 64, device=cuda_device)
    one = torch.ones(1, 1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="page_size"):
        cpd.paged_decode(q, pool, pool, one, one[0], cur, cur, 0.1)


INT4_RTOL = 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,N", [(128, 96), (4096, 1024), (14336, 4096)])
@pytest.mark.parametrize("gs", [32, 128])
@pytest.mark.parametrize("T", [1, 7, 32, 33, 64, 65, 128, 512, 2048])
def test_int4_matmul_matches_plain(cuda_device, dtype, K, N, gs, T):
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = _rn(g, dtype, cuda_device, T, K)
    wp = torch.randint(-128, 128, (K // 2, N), generator=g,
                       device=cuda_device, dtype=torch.int8)
    scale = torch.rand(K // gs, N, generator=g, device=cuda_device) * 0.1
    before = c4.launches
    got = Q.int4_matmul(x, wp, scale)          # the dispatcher: the kernel
    assert c4.launches == before + 1
    ref = Q.int4_matmul_plain(x, wp, scale)
    assert got.dtype == torch.float32 and got.shape == (T, N)
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=INT4_RTOL * float(ref.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [96, 100])      # 16-byte copies / plain loads
@pytest.mark.parametrize("rows", [64, 512])   # decode tile / prefill tile
def test_int4_matmul_every_nibble_exact(cuda_device, dtype, N, rows):
    """Every byte value -128..127 in every column position; x = identity,
    so each output row is one dequantized weight row, exactly: both
    nibbles sign-extended and the low nibble the even input row. Calls of
    64 rows take the decode tile; 512 bf16 rows the prefill tile."""
    K, gs = 512, 32
    wp = ((torch.arange(K // 2 * N) % 256) - 128).to(torch.int8).reshape(
        K // 2, N).to(cuda_device)
    scale = (torch.arange(K // gs * N, dtype=torch.float32) % 7 + 1
             ).reshape(K // gs, N).to(cuda_device) / 8
    x = torch.eye(K, device=cuda_device).to(dtype)
    got = torch.cat([c4.int4_matmul(x[r:r + rows].contiguous(), wp, scale)
                     for r in range(0, K, rows)])
    want = Q.unpack_int4(wp).float() * scale.repeat_interleave(gs, dim=0)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("T,K,N", [(32, 4096, 14336), (1, 14336, 4096),
                                   (64, 14336, 1024)])
def test_int4_matmul_cut_tiles_deterministic(cuda_device, T, K, N):
    """Decode plans whose blocks cut tiles (partials summed by the last
    block to arrive) give the plain result, and the same bits on every
    call: the sum runs in block order and the counters are left at 0."""
    g = torch.Generator(device=cuda_device).manual_seed(9)
    x = _rn(g, torch.bfloat16, cuda_device, T, K)
    wp = torch.randint(-128, 128, (K // 2, N), generator=g,
                       device=cuda_device, dtype=torch.int8)
    scale = torch.rand(K // 128, N, generator=g, device=cuda_device) * 0.01
    p = c4._plan_for(T, K, N, 128, 1, x.device)
    assert any(lo // p.groups != (hi - 1) // p.groups or hi - lo < p.groups
               for lo, hi in map(lambda b: c4.block_units(p, b),
                                 range(p.blocks)))
    first = c4.int4_matmul(x, wp, scale)
    ref = Q.int4_matmul_plain(x, wp, scale)
    torch.testing.assert_close(first, ref, rtol=0,
                               atol=INT4_RTOL * float(ref.abs().max()))
    for _ in range(3):
        assert torch.equal(c4.int4_matmul(x, wp, scale), first)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 32, 300])
def test_moe_int4_experts_through_the_kernel(cuda_device, T):
    """One mixtral-8x7b MoE block (d 4096, ff 14336, 8 experts, top 2, int4
    gs 128) through ``_moe_mlp``: each expert's three matmuls launch the
    kernel on contiguous 2-D slices of the stacked ``[E, ...]`` weights
    (3 x 8 launches), and the block's bf16 output matches the same block
    through ``int4_matmul_plain`` (the same routing: the router is bf16,
    not quantized) within 1% of its largest value, a few bf16 ulps."""
    cfg = get_model_config("mixtral-8x7b").replace(quantization="int4",
                                                   num_layers=1)
    g = torch.Generator(device=cuda_device).manual_seed(16)
    lp = {k: t[0] for k, t in M.init_params(cfg, g, cuda_device)[
        "layers"].items()}
    x = _rn(g, torch.bfloat16, cuda_device, T, cfg.hidden_size)
    before = c4.launches
    got = M._moe_mlp(lp, cfg, x)
    assert c4.launches == before + 3 * cfg.num_experts
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Q, "int4_matmul", Q.int4_matmul_plain)
        ref = M._moe_mlp(lp, cfg, x)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                               atol=1e-2 * float(ref.float().abs().max()))


@pytest.mark.gpu
def test_int4_matmul_rejects(cuda_device):
    K, N = 128, 32
    x = torch.zeros(4, K, device=cuda_device, dtype=torch.bfloat16)
    wp = torch.zeros(K // 2, N, device=cuda_device, dtype=torch.int8)
    scale = torch.ones(K // 32, N, device=cuda_device)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        c4.int4_matmul(x.cpu(), wp.cpu(), scale.cpu())
    with pytest.raises(ValueError, match="whole number"):      # K % gs
        c4.int4_matmul(x, wp, torch.ones(3, N, device=cuda_device))
    with pytest.raises(ValueError, match="multiple of 16"):    # gs = 8
        c4.int4_matmul(x, wp, torch.ones(16, N, device=cuda_device))
    w8 = torch.zeros(K, N, device=cuda_device, dtype=torch.int8)
    with pytest.raises(ValueError, match="1-D scale"):    # the int8 layout
        c4.int4_matmul(x, w8, torch.ones(N, device=cuda_device))
    with pytest.raises(ValueError, match="do not pack"):
        c4.int4_matmul(x, w8, scale)
    with pytest.raises(ValueError, match="dtype"):
        c4.int4_matmul(x.half(), wp, scale)


# -- the KV transfer layer ---------------------------------------------------

def _swapper(device, host_pages=32, L=4, P=64, ps=16, kd=1024,
             dtype=torch.bfloat16):
    gen = torch.Generator(device=device).manual_seed(0)
    kv = KV.KVCache(k=_rn(gen, dtype, device, L, P, ps, kd),
                    v=_rn(gen, dtype, device, L, P, ps, kd))
    host = KV.HostKVPool(host_pages, L, ps, kd, dtype, pin=True)
    programs = StepPrograms({}, None, device, enabled=True)
    return kv, KV.KVSwapper(host, lambda: kv,
                            KV.KVTransferPrograms(device, programs, P))


@pytest.mark.gpu
def test_swap_round_trip_bit_identical(cuda_device):
    """bf16 pages out to the pinned host pool, overwritten on the card,
    back in to DIFFERENT pages: bit-identical, and the host pool drains."""
    kv, sw = _swapper(cuda_device)
    assert sw.host.k.is_pinned() and sw.host.v.is_pinned()
    out_pages = [3, 9, 10, 11, 40, 2]           # runs and single pages
    want_k, want_v = kv.k[:, out_pages].clone(), kv.v[:, out_pages].clone()
    hp = sw.swap_out(out_pages)
    assert torch.equal(sw.host.k[:, hp], want_k.cpu())
    assert torch.equal(sw.host.v[:, hp], want_v.cpu())
    kv.k[:, out_pages] = 0
    kv.v[:, out_pages] = 0
    in_pages = [50, 51, 5, 60, 61, 62]
    sw.swap_in(hp, in_pages)
    torch.cuda.synchronize()
    assert torch.equal(kv.k[:, in_pages], want_k)
    assert torch.equal(kv.v[:, in_pages], want_v)
    assert sw.host.num_in_use == 0


@pytest.mark.gpu
def test_sliced_host_buffers_scatter_bit_identical(cuda_device):
    """A chunk sliced out of a larger host buffer (the streamed prefix
    import) is not contiguous; it uploads layer by layer and lands bit for
    bit, from pinned and from pageable memory."""
    kv, sw = _swapper(cuda_device)
    io = KV.KVPageIO(lambda: kv, sw.programs)
    k, v = io.export_pages(list(range(10, 30)))
    assert k.is_pinned() and not k[:, 4:9].is_contiguous()
    for src_k, src_v in ((k, v), (k.clone(), v.clone())):
        io.import_pages(list(range(40, 45)), src_k[:, 4:9], src_v[:, 4:9])
        torch.cuda.synchronize()
        assert torch.equal(kv.k[:, 40:45], kv.k[:, 14:19])
        assert torch.equal(kv.v[:, 40:45], kv.v[:, 14:19])
        kv.k[:, 40:45] = 0
        kv.v[:, 40:45] = 0


@pytest.mark.gpu
def test_host_pages_reused_only_after_the_swap_in_read_them(cuda_device):
    """swap_in, then at once a reuse of the host pages it freed — by a
    swap-out of other pages, or by a host-side write (a peer's spill) —
    with the swap-in's copy queued behind a ~1 ms kernel so it has not
    started when the reuse comes. Over many rounds every restored page is
    what went out: the reuse waits for the copy's event."""
    kv, sw = _swapper(cuda_device, host_pages=8)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    pages = list(range(1, 33))
    for r in range(40):
        src, dst, other = pages[:8], pages[8:16], pages[16:24]
        kv.k[:, src] = _rn(gen, kv.k.dtype, cuda_device,
                           *kv.k[:, src].shape)
        want = kv.k[:, src].clone()
        hp = sw.swap_out(src)                   # every host page in use
        torch.cuda._sleep(2_000_000)
        sw.swap_in(hp, dst)
        if r % 2:
            kv.k[:, other] = -want
            reused = sw.swap_out(other)
        else:
            reused = sw.host.allocate(8)
            zeros = torch.zeros((kv.k.shape[0], 8) + tuple(kv.k.shape[2:]),
                                dtype=kv.k.dtype)
            sw.host.put(reused, zeros, zeros)
        assert sorted(reused) == sorted(hp)
        torch.cuda.synchronize()
        assert torch.equal(kv.k[:, dst], want), f"round {r}"
        sw.free_host(reused)
        pages = pages[8:] + pages[:8]


@pytest.mark.gpu
def test_transfer_keys_replayed_bit_equal_to_eager(cuda_device):
    """A gather and a scatter of five pages (key 8: three rows padded to
    ``SCRAP_PAGE``), captured at their first transfer and replayed at
    three more, on pages and host data that change every round: every
    gathered page equals the pool's, and the pool after every scatter
    equals, bit for bit, a twin pool served by the same bodies run
    eagerly (a cache built disabled, as ``enforce_eager``'s), with
    ``SCRAP_PAGE`` zero. Two graphs, replayed six times."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    host_gen = torch.Generator().manual_seed(4)
    L, P, ps, kd = 4, 64, 16, 1024
    kv = KV.KVCache(k=_rn(gen, torch.bfloat16, cuda_device, L, P, ps, kd),
                    v=_rn(gen, torch.bfloat16, cuda_device, L, P, ps, kd))
    twin = KV.KVCache(k=kv.k.clone(), v=kv.v.clone())
    captured = KV.KVTransferPrograms(
        cuda_device, StepPrograms({}, None, cuda_device, enabled=True), 32)
    eager = KV.KVTransferPrograms(
        cuda_device, StepPrograms({}, None, cuda_device, enabled=False), 32)
    for r in range(4):
        src = [3 + 11 * r, 40 - r, 5 + r, 60, 20 + 2 * r]
        dst = [50 - r, 7 + r, 30, 31, 12 + 3 * r]
        want = [t[:, src].cpu() for t in kv]
        for got in (captured.gather_pages(kv, src),
                    eager.gather_pages(twin, src)):
            assert all(torch.equal(g, w) for g, w in zip(got, want)), r
        hk, hv = (torch.randn((L, 5, ps, kd), generator=host_gen)
                  .to(torch.bfloat16) for _ in range(2))
        captured.scatter_pages(kv, dst, hk, hv)
        eager.scatter_pages(twin, dst, hk, hv)
        torch.cuda.synchronize()
        for got, ref in zip(kv, twin):
            assert torch.equal(got, ref), r
            assert not got[:, KV.SCRAP_PAGE].any()
        assert torch.equal(kv.k[:, dst].cpu(), hk)
    assert captured.programs.keys() == [("kv_gather", 8), ("kv_scatter", 8)]
    assert captured.programs.replays == 6
    assert eager.programs.keys() == []


def _tiny_cfg(num_pages=64, swap_gb=0.0):
    model = get_model_config("debug-tiny").replace(head_dim=64,
                                                   dtype="bfloat16")
    return EngineConfig(
        model=model, cache=CacheConfig(page_size=16, num_pages=num_pages,
                                       swap_space_gb=swap_gb),
        scheduler=SchedulerConfig(max_num_seqs=8, max_prefill_tokens=256,
                                  decode_buckets=(1, 2, 4, 8),
                                  prefill_buckets=(64, 128, 256),
                                  decode_window=4))


def _prompts(n, lo, hi, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(1, 500, (int(torch.randint(lo, hi, (1,),
                                                     generator=g)),),
                          generator=g).tolist() for _ in range(n)]


@pytest.mark.gpu
def test_import_request_of_a_cpu_state_on_the_card(cuda_device):
    """A held prefill exported from one card engine (pinned CPU tensors)
    imports into another card engine as it is, as a pageable copy and as
    numpy arrays; each decodes the colocated run's tokens."""
    a = LLMEngine(_tiny_cfg(), device=cuda_device)
    b = LLMEngine(_tiny_cfg(), params=a.params, device=cuda_device)
    prompt = _prompts(1, 60, 61)[0]
    sp = SamplingParams(max_tokens=12, temperature=0.0)
    ref = a.generate([prompt], sp)[0].output_token_ids
    for i, convert in enumerate((lambda t: t, lambda t: t.clone(),
                                 lambda t: t.float().numpy())):
        a.add_request(f"pf{i}", prompt, SamplingParams(max_tokens=1,
                                                       temperature=0.0),
                      hold_kv=True)
        while a.has_unfinished_requests():
            a.step()
        state = a.export_held(f"pf{i}")
        assert state["k"].device.type == "cpu" and state["dtype"] == \
            "bfloat16"
        if i == 2:      # numpy has no bfloat16: an fp32 copy must refuse
            with pytest.raises(ValueError, match="dtype"):
                b.import_request("bad", prompt, sp,
                                 dict(state, k=convert(state["k"]),
                                      v=convert(state["v"])))
            continue
        state = dict(state, k=convert(state["k"]), v=convert(state["v"]))
        b.import_request(f"dc{i}", prompt, sp, state)
        final = None
        while b.has_unfinished_requests():
            for o in b.step():
                if o.request_id == f"dc{i}" and o.finished:
                    final = o.output_token_ids
        assert final == ref
    alloc = b.scheduler.allocator
    assert alloc.num_free == alloc.num_pages - 1


@pytest.mark.gpu
def test_swap_engine_twice_identical_on_the_card(cuda_device):
    """A card engine whose pool the decode growth overflows preempts by
    swap; the same requests twice give identical tokens and both tiers
    drain."""
    eng = LLMEngine(_tiny_cfg(num_pages=24, swap_gb=0.01),
                    device=cuda_device)
    prompts = _prompts(6, 20, 80, seed=2)
    sp = SamplingParams(max_tokens=40, temperature=0.0)
    first = [o.output_token_ids for o in eng.generate(prompts, sp)]
    swaps = eng.scheduler.num_preemptions_by_kind["swap"]
    second = [o.output_token_ids for o in eng.generate(prompts, sp)]
    assert swaps > 0
    assert eng.scheduler.num_preemptions_by_kind["recompute"] == 0
    assert first == second
    assert eng.swapper.host.num_in_use == 0
    alloc = eng.scheduler.allocator
    assert alloc.num_free == alloc.num_pages - 1


_GRAPH_PARAMS = [
    SamplingParams(max_tokens=24, temperature=0.0),
    SamplingParams(max_tokens=24, temperature=0.9, seed=11),
    SamplingParams(max_tokens=24, temperature=0.7, top_k=20, top_p=0.9,
                   seed=12),
    SamplingParams(max_tokens=24, temperature=0.0, presence_penalty=0.5,
                   frequency_penalty=0.3, logit_bias={5: 2.0},
                   logprobs=True, top_logprobs=3),
]


def _graph_waves(eng):
    """Every bucket of ``_tiny_cfg`` (1, 2, 4, 8 rows), each with greedy
    rows alone and with every sampled kind mixed in; 24 tokens make five
    chained windows of 4 + 1 per request."""
    outs = []
    for n in (1, 2, 4, 8):
        prompts = _prompts(n, 10, 70, seed=20 + n)
        for params in ([_GRAPH_PARAMS[0]] * n,
                       [_GRAPH_PARAMS[i % 4] for i in range(1, n + 1)]):
            outs.append([(o.output_token_ids, o.output_logprobs)
                         for o in eng.generate(prompts, params)])
    return outs


@pytest.mark.gpu
def test_captured_windows_match_eager_per_bucket_and_variant(cuda_device):
    """The decode window captured once per (variant, bucket) and replayed
    gives the enforce_eager engine's tokens and logprobs in every bucket
    and variant (greedy, seeded sampled with and without filters,
    penalties with bias and top logprobs), and a second wave captures
    nothing new."""
    graph = LLMEngine(_tiny_cfg(num_pages=256), device=cuda_device)
    eager = LLMEngine(dataclasses.replace(_tiny_cfg(num_pages=256),
                                          enforce_eager=True),
                      params=graph.params, device=cuda_device)
    assert _graph_waves(graph) == _graph_waves(eager)
    progs = graph._programs
    assert progs.keys("greedy") + progs.keys("sampled") == [
        (v, b) for v in ("greedy", "sampled") for b in (1, 2, 4, 8)]
    assert progs.keys("prefill")
    built = graph.compiled_step_variants()
    assert built == len(progs.keys()) == len(progs.capture_seconds)
    assert eager.compiled_step_variants() == 0
    assert _graph_waves(graph) == _graph_waves(eager)
    assert graph.compiled_step_variants() == built


@pytest.mark.gpu
def test_captured_prefill_chunk_and_mixed_steps_match_eager(cuda_device):
    """Staggered arrivals on the card: a 450-token prompt alone (solo
    chunks of 256 and 194 over 16- and 32-page tables), then prompts of
    every sampling kind, the long ones chunked beside decoding rows. The prefill, solo-chunk
    and mixed programs give the enforce_eager engine's tokens and
    logprobs; the same arrivals again capture nothing new."""
    def wave(eng):
        outs = [eng.generate(_prompts(1, 450, 451, seed=40),
                             _GRAPH_PARAMS[3:4])]
        pending = [(f"m{i}", p, _GRAPH_PARAMS[i % 4]) for i, p in
                   enumerate(_prompts(6, 10, 480, seed=41))]
        final = {}
        while pending or eng.has_unfinished_requests():
            if pending:
                eng.add_request(*pending.pop(0))
            for o in eng.step():
                if o.finished:
                    final[o.request_id] = o
        outs.append([final[f"m{i}"] for i in range(6)])
        return [[(o.output_token_ids, o.output_logprobs) for o in group]
                for group in outs]

    graph = LLMEngine(_tiny_cfg(num_pages=256), device=cuda_device)
    eager = LLMEngine(dataclasses.replace(_tiny_cfg(num_pages=256),
                                          enforce_eager=True),
                      params=graph.params, device=cuda_device)
    assert wave(graph) == wave(eager)
    progs = graph._programs
    for family in ("prefill", "prefill_hist", "mixed"):
        assert progs.keys(family), family
    built = len(progs.capture_seconds)
    assert wave(graph) == wave(eager)
    assert len(progs.capture_seconds) == built


def _spec_cfg(draft=None, adaptive=False):
    base = _tiny_cfg(num_pages=256)
    return dataclasses.replace(base, scheduler=dataclasses.replace(
        base.scheduler, mixed_batch_enabled=True, spec_decode_enabled=True,
        num_speculative_tokens=4, spec_draft_model=draft,
        spec_adaptive_k=adaptive))


@pytest.mark.gpu
@pytest.mark.parametrize("draft", [None, "oracle"])
def test_captured_spec_steps_match_eager(cuda_device, draft):
    """Spec and spec×mixed steps (n-gram drafts, or the target drafting
    for itself under adaptive k through the draft runner's programs) on
    the card: repetitive prompts of every sampling kind arriving while
    others decode, the long ones chunked (beside verify rows where drafts
    exist). The captured engine gives the enforce_eager engine's tokens,
    logprobs and drafted / accepted totals; the verify kernel launched in
    both."""
    pattern = _prompts(1, 12, 13, seed=50)[0]

    def wave(eng):
        d0, a0 = eng.obs.spec_drafted_tokens, eng.obs.spec_accepted_tokens
        pending = [(f"s{i}", (pattern * 40)[i:i + n], _GRAPH_PARAMS[i % 4])
                   for i, n in enumerate((40, 300, 60, 420, 25, 90))]
        final = {}
        while pending or eng.has_unfinished_requests():
            if pending:
                eng.add_request(*pending.pop(0))
            for o in eng.step():
                if o.finished:
                    final[o.request_id] = o
        return ([(final[f"s{i}"].output_token_ids,
                  final[f"s{i}"].output_logprobs) for i in range(6)],
                eng.obs.spec_drafted_tokens - d0,
                eng.obs.spec_accepted_tokens - a0)

    from kubernetes_gpu_cluster_tpu_torch.engine.spec.draft_model import \
        DraftModelRunner
    cfg = _spec_cfg(adaptive=bool(draft))
    graph = LLMEngine(cfg, device=cuda_device)
    eager = LLMEngine(dataclasses.replace(cfg, enforce_eager=True),
                      params=graph.params, device=cuda_device)
    if draft:
        # The hd-64 model drafting for itself (no preset has its heads):
        # each runner registers its programs in its engine's cache.
        for eng in (graph, eager):
            eng.scheduler.spec_proposer = DraftModelRunner(
                eng.config, eng.model_config, params=graph.params,
                device=cuda_device, programs=eng._programs)
    runs = {}
    for tag, eng in (("graph", graph), ("eager", eager)):
        before = csv.launches
        runs[tag] = wave(eng)
        assert csv.launches > before, tag
    assert runs["graph"] == runs["eager"]
    assert runs["graph"][1] > 0
    kinds = graph.obs.step_kind_counts
    assert kinds["spec"] > 0, kinds
    progs = graph._programs
    families = [k for k in ("spec", "spec_mixed") if kinds[k]] + (
        ["draft_decode", "draft_prefill"] if draft else [])
    assert all(progs.keys(f) for f in families), progs.keys()
    assert len(progs.capture_seconds) == graph.compiled_step_variants()
    assert eager.compiled_step_variants() == 0


# One request at a time through one program per family, its flags flipped
# from request to request: every gate closed, then each stage open alone
# (each filter tier: top_k 20 resolves in the 128-wide window, 1000 in the
# 2048-wide one, 3000 and a top-p prefix of the flat random-weight
# distribution only in the full sort), then closed again.
_FLIPS = [
    SamplingParams(max_tokens=9, temperature=0.0),
    SamplingParams(max_tokens=9, temperature=0.0, logprobs=True,
                   top_logprobs=3),
    SamplingParams(max_tokens=9, temperature=0.0),
    SamplingParams(max_tokens=9, temperature=0.8, seed=3),
    SamplingParams(max_tokens=9, temperature=0.8, top_k=20, seed=4),
    SamplingParams(max_tokens=9, temperature=0.8, seed=5),
    SamplingParams(max_tokens=9, temperature=0.8, top_k=1000, seed=6),
    SamplingParams(max_tokens=9, temperature=0.8, top_k=3000, seed=7),
    SamplingParams(max_tokens=9, temperature=0.8, top_p=0.9, seed=8),
    SamplingParams(max_tokens=9, temperature=0.8, top_k=20, seed=9),
    SamplingParams(max_tokens=9, temperature=0.0, presence_penalty=0.5,
                   frequency_penalty=0.3),
    SamplingParams(max_tokens=9, temperature=0.0, logit_bias={5: 2.0}),
    SamplingParams(max_tokens=9, temperature=0.8, seed=10),
    SamplingParams(max_tokens=9, temperature=0.0),
]


def _flip_cfg(spec: bool = False):
    """_tiny_cfg at a vocabulary past the wide filter window (4096 >
    TOP_K_CAP_WIDE), so that every filter tier exists."""
    base = _tiny_cfg(num_pages=256)
    cfg = dataclasses.replace(base, model=base.model.replace(
        vocab_size=4096))
    if spec:
        cfg = dataclasses.replace(cfg, scheduler=dataclasses.replace(
            cfg.scheduler, mixed_batch_enabled=True,
            spec_decode_enabled=True, num_speculative_tokens=4))
    return cfg


def _flip_wave(eng, family: str):
    """``_FLIPS`` in order, one request each (a background greedy request
    decodes beside them for the mixed families): tokens, logprobs and top
    alternatives of each."""
    pattern = _prompts(1, 12, 13, seed=70)[0]
    prompt = {"window": _prompts(1, 40, 41, seed=71)[0],
              "solo_chunk": _prompts(1, 300, 301, seed=72)[0],
              "mixed": _prompts(1, 100, 101, seed=73)[0],
              "spec": (pattern * 8)[:40],
              "spec_mixed": (pattern * 30)[:300]}[family]
    outs = []
    for i, sp in enumerate(_FLIPS):
        if family in ("mixed", "spec_mixed"):
            eng.add_request(f"bg{i}", (pattern * 4)[:30],
                            SamplingParams(max_tokens=24, temperature=0.0))
            eng.step()
        eng.add_request(f"r{i}", prompt, sp)
        final = None
        while eng.has_unfinished_requests():
            for o in eng.step():
                if o.request_id == f"r{i}" and o.finished:
                    final = o
        outs.append((final.output_token_ids, final.output_logprobs,
                     final.output_top_logprobs))
    return outs


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["window", "solo_chunk", "mixed", "spec",
                                    "spec_mixed"])
def test_gated_programs_replay_flag_flips_like_eager(cuda_device, family):
    """Each family's programs (decode windows greedy and sampled and the
    prefill with ``window``; solo chunks; mixed steps; spec and spec×mixed
    verify steps) captured once, then replayed with their gate flags
    flipped from step to step: closed, each stage and each filter tier
    open, closed again. Every replay gives the enforce_eager twin's
    tokens, logprobs and top alternatives bit for bit, and a second pass
    of flips builds no program (kgct_jit_compiles_total unchanged)."""
    cfg = _flip_cfg(spec=family.startswith("spec"))
    graph = LLMEngine(cfg, device=cuda_device)
    eager = LLMEngine(dataclasses.replace(cfg, enforce_eager=True),
                      params=graph.params, device=cuda_device)
    if family.startswith("spec"):
        # The target drafting for itself: every step verifies drafts.
        from kubernetes_gpu_cluster_tpu_torch.engine.spec.draft_model \
            import DraftModelRunner
        for eng in (graph, eager):
            eng.scheduler.spec_proposer = DraftModelRunner(
                eng.config, eng.model_config, params=graph.params,
                device=cuda_device, programs=eng._programs)
    want = _flip_wave(eager, family)
    assert _flip_wave(graph, family) == want
    built = graph.compiled_step_variants()
    replays = graph._programs.replays
    assert _flip_wave(graph, family) == want
    assert graph.compiled_step_variants() == built
    assert graph._programs.replays > replays
    fams = {"window": ("greedy", "sampled", "prefill"),
            "solo_chunk": ("prefill_hist",), "mixed": ("mixed",),
            "spec": ("spec",), "spec_mixed": ("spec_mixed",)}[family]
    assert all(graph._programs.keys(f) for f in fams), graph._programs.keys()


@pytest.mark.gpu
def test_gate_two_branches_and_nested_tiers_replay_right(cuda_device):
    """The gate helper in a graph captured by hand: an if/else pair on an
    int32 flag and, inside its then-branch, nodes on bools the graph
    computes (taken and not taken, and a negated one); every flip of the
    flag replays to what the branches compute, and nothing of a branch
    that did not run is left behind."""
    from kubernetes_gpu_cluster_tpu_torch.ops import gates
    flag = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    x = torch.arange(8, dtype=torch.float32, device=cuda_device)
    out = torch.zeros(8, device=cuda_device)

    def then():
        out.copy_(x * 2)
        gates.when_device(torch.all(out >= 0), lambda: out.add_(1))
        big = torch.any(out > 100)
        gates.when_device(big, lambda: out.add_(100))
        gates.when_device(big, lambda: out.add_(1000), negate=True)
    pool = torch.cuda.graph_pool_handle()
    children = []
    g = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        with gates.capturing(cuda_device, pool, children):
            g.capture_begin(pool=pool, capture_error_mode="thread_local")
            gates.when("t", gates.Flag(True, flag), then,
                       lambda: out.fill_(-1))
            g.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    assert len(children) == 2
    for v in (0, 1, 0, 1, 1, 0):
        out.fill_(7)
        flag.fill_(v)
        g.replay()
        want = x * 2 + 1001 if v else torch.full_like(x, -1)
        assert torch.equal(out, want), v
    with pytest.raises(RuntimeError, match="captured program only"):
        gates.when_device(torch.all(x >= 0), lambda: None)


@pytest.mark.gpu
def test_a_host_read_in_a_closed_branch_fails_its_capture(cuda_device):
    """The capture records both branches of every gate, so a host read in
    a branch the warm-up's flags skipped still fails the program's capture
    with CaptureError; nothing runs eagerly in its place."""
    from kubernetes_gpu_cluster_tpu_torch.engine.step_programs import \
        CaptureError
    from kubernetes_gpu_cluster_tpu_torch.ops import gates
    eng = LLMEngine(_tiny_cfg(), device=cuda_device)
    bodies = eng._programs._bodies

    def leaky(body):
        def run(key, bufs):
            body(key, bufs)
            flags = bufs.flags(("any_sampled",))
            gates.when("leak", flags["any_sampled"],
                       lambda: int(bufs["out_tok"].reshape(-1)[0]))
        return run

    eng._programs._bodies = {f: leaky(b) for f, b in bodies.items()}
    with pytest.raises(CaptureError, match="capture of step program"):
        eng.generate(_prompts(1, 10, 20),
                     SamplingParams(max_tokens=12, temperature=0.0))
    assert eng.compiled_step_variants() == 0


@pytest.mark.gpu
def test_a_key_first_met_under_a_steady_trace_is_captured(cuda_device):
    """While a torch.profiler trace runs (started before, stopped after, as
    the server's /debug/profile does between steps), a key first met is
    captured with its gates' conditional nodes, as at any other time, and
    its replays give the enforce_eager engine's tokens and logprobs,
    under the trace and after it."""
    from torch.profiler import ProfilerActivity, profile
    graph = LLMEngine(_tiny_cfg(), device=cuda_device)
    eager = LLMEngine(dataclasses.replace(_tiny_cfg(), enforce_eager=True),
                      params=graph.params, device=cuda_device)
    prompts = _prompts(2, 10, 40, seed=80)
    sampled = SamplingParams(max_tokens=8, temperature=0.8, top_k=50,
                             seed=7, logprobs=True)
    greedy = SamplingParams(max_tokens=8, temperature=0.0, logprobs=True)

    def run(eng):
        return [(o.output_token_ids, o.output_logprobs)
                for sp in (greedy, sampled)
                for o in eng.generate(prompts, sp)]
    want = run(eager)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        got = run(graph)
        built = graph.compiled_step_variants()
    assert got == want
    assert built > 0
    assert graph._programs.replays > 0
    assert run(graph) == want
    assert graph.compiled_step_variants() == built


@pytest.mark.gpu
def test_no_collection_runs_inside_a_capture(cuda_device):
    """Each program's body runs twice at its key's first step: its warm-up
    with the cyclic collector on, its capture with the collector paused (a
    collection there could free a dead engine's graphs and pool, calls
    that void the capture). The collector is on again after."""
    import gc
    eng = LLMEngine(_tiny_cfg(), device=cuda_device)
    seen = []

    def watched(body):
        def run(key, bufs):
            seen.append((key, gc.isenabled()))
            body(key, bufs)
        return run

    eng._programs._bodies = {f: watched(b)
                             for f, b in eng._programs._bodies.items()}
    eng.generate(_prompts(4, 10, 70, seed=60),
                 SamplingParams(max_tokens=12, temperature=0.0))
    keys = eng._programs.keys()
    assert keys
    for key in keys:
        assert [on for k, on in seen if k == key] == [True, False], key
    assert gc.isenabled()


@pytest.mark.gpu
def test_a_host_read_in_the_window_fails_its_capture(cuda_device):
    """A window body that reads the device from the host raises
    CaptureError at its capture; the engine does not go on eagerly, and
    the caching allocator can release its memory after (a capture left
    open would keep every later free deferred)."""
    import gc
    from kubernetes_gpu_cluster_tpu_torch.engine.step_programs import \
        CaptureError
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    eng = LLMEngine(_tiny_cfg(), device=cuda_device)
    bodies = eng._programs._bodies

    def leaky(body):
        def run(key, bufs):
            body(key, bufs)
            return int(bufs["out_tok"].reshape(-1)[0])
        return run

    eng._programs._bodies = {f: leaky(b) for f, b in bodies.items()}
    with pytest.raises(CaptureError, match="capture of step program"):
        eng.generate(_prompts(1, 10, 20), SamplingParams(max_tokens=12))
    assert eng.compiled_step_variants() == 0
    torch.cuda.synchronize()
    del eng, bodies
    gc.collect()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved() <= before + (256 << 20)


def _sync_calls(fn):
    """(fn(), the synchronizing CUDA calls it made: one sync-debug warning
    each)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


@pytest.mark.gpu
def test_sanitizer_on_the_card_same_tokens_and_syncs(cuda_device,
                                                     monkeypatch):
    """The hooks read the host arrays the engine already holds: on the card
    KGCT_SANITIZE=1 changes no token and adds no synchronizing call (the
    count is live: a known synchronizing call is counted)."""
    base = _tiny_cfg(num_pages=24, swap_gb=0.01)
    cfg = dataclasses.replace(base, scheduler=dataclasses.replace(
        base.scheduler, spec_decode_enabled=True, num_speculative_tokens=4,
        mixed_batch_enabled=True))
    pattern = _prompts(1, 12, 13, seed=4)[0]
    prompts = _prompts(4, 20, 80, seed=3) + [pattern * 5, pattern * 4]
    sp = SamplingParams(max_tokens=40, temperature=0.0)
    monkeypatch.setenv("KGCT_SANITIZE", "1")
    on = LLMEngine(cfg, device=cuda_device)
    monkeypatch.delenv("KGCT_SANITIZE")
    off = LLMEngine(cfg, params=on.params, device=cuda_device)
    assert on._sanitizer is not None and off._sanitizer is None
    runs = {}
    for tag, eng in (("on", on), ("off", off)):
        # warm-up, under sync-debug too: torch warns once a process at one
        # site, which must not land in the first measured run
        _sync_calls(lambda e=eng: e.generate(prompts[:2], sp))
        outs, syncs = _sync_calls(lambda e=eng: e.generate(prompts, sp))
        runs[tag] = ([o.output_token_ids for o in outs], syncs)
    assert runs["on"][0] == runs["off"][0]
    assert runs["on"][1] == runs["off"][1]
    assert _sync_calls(lambda: torch.ones(1, device=cuda_device).item())[1] \
        >= 1
    assert on.scheduler.num_preemptions_by_kind["swap"] > 0
    assert on.obs.step_kind_counts["spec"] > 0
    assert on._sanitizer.checks > 0


@pytest.mark.gpu
def test_server_on_the_card_serves_streamed_and_plain(cuda_device):
    """The port's OpenAI server on the card at debug widths (bf16,
    hd 64): one plain and one streamed completion over a socket
    (``http.client``), the same greedy text both ways, with the attention
    kernels launched."""
    import asyncio
    import http.client
    import json

    from kubernetes_gpu_cluster_tpu_torch.serving import build_server
    from kubernetes_gpu_cluster_tpu_torch.serving.http import Server

    body = {"prompt": [5, 6, 7, 8] * 20, "max_tokens": 12,
            "temperature": 0.0}

    def call(port, stream):
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        c.request("POST", "/v1/completions",
                  json.dumps(dict(body, stream=stream)),
                  {"Content-Type": "application/json"})
        r = c.getresponse()
        raw = r.read().decode()
        c.close()
        if not stream:
            return r.status, json.loads(raw)["choices"][0]["text"]
        frames = [ln[6:] for ln in raw.splitlines()
                  if ln.startswith("data: ")]
        assert frames[-1] == "[DONE]"
        return r.status, "".join(json.loads(f)["choices"][0]["text"]
                                 for f in frames[:-1])

    async def go():
        api = build_server(_tiny_cfg(), device=cuda_device)
        srv = Server(api.build_app())
        await srv.start("127.0.0.1", 0)
        try:
            for mod in (cpd, cfp):
                mod.launches = 0
            plain = await asyncio.to_thread(call, srv.port, False)
            streamed = await asyncio.to_thread(call, srv.port, True)
            return plain, streamed, cpd.launches, cfp.launches
        finally:
            await srv.close()

    plain, streamed, n_decode, n_prefill = asyncio.run(go())
    assert plain[0] == streamed[0] == 200
    assert plain[1] == streamed[1]
    assert n_decode > 0 and n_prefill > 0


@pytest.mark.gpu
def test_handoff_frame_between_card_engines(cuda_device):
    """Disaggregated serving across the wire codec on the card: a held
    bf16 prefill exported from one card engine, encoded with integrity on,
    decoded and verified, imports into a second card engine page for page
    bit-equal, and decodes the colocated run's tokens."""
    from kubernetes_gpu_cluster_tpu_torch.serving.handoff import (
        decode_handoff, encode_handoff, verify_import_state)

    a = LLMEngine(_tiny_cfg(), device=cuda_device)
    b = LLMEngine(_tiny_cfg(), params=a.params, device=cuda_device)
    prompt = _prompts(1, 90, 91, seed=4)[0]
    sp = SamplingParams(max_tokens=16, temperature=0.0)
    ref = a.generate([prompt], sp)[0].output_token_ids
    a.add_request("pf", prompt, SamplingParams(max_tokens=1,
                                               temperature=0.0),
                  hold_kv=True)
    while a.has_unfinished_requests():
        a.step()
    sent = a.export_held("pf")
    frame = encode_handoff(sent, integrity=True)
    state = decode_handoff(bytes(frame), require_integrity=True)
    verify_import_state(state)
    assert state["k"].dtype == torch.bfloat16
    assert torch.equal(state["k"], sent["k"])
    assert torch.equal(state["v"], sent["v"])
    b.import_request("dc", prompt, sp, state)
    pages = b.scheduler.find_running("dc").pages
    n = state["k"].shape[1]
    torch.cuda.synchronize()
    assert torch.equal(b.kv_cache.k[:, pages[:n]].cpu(), sent["k"])
    assert torch.equal(b.kv_cache.v[:, pages[:n]].cpu(), sent["v"])
    final = None
    while b.has_unfinished_requests():
        for o in b.step():
            if o.request_id == "dc" and o.finished:
                final = o.output_token_ids
    assert final == ref
    alloc = b.scheduler.allocator
    assert alloc.num_free == alloc.num_pages - 1


# -- tensor parallelism on the card -------------------------------------------

TP_RANK = r'''
import json, os, sys
import torch
sys.path.insert(0, os.environ["KGCT_REPO"])
from kubernetes_gpu_cluster_tpu_torch.config import (
    CacheConfig, EngineConfig, ParallelConfig, SchedulerConfig,
    get_model_config)
from kubernetes_gpu_cluster_tpu_torch.engine import LLMEngine, SamplingParams
from kubernetes_gpu_cluster_tpu_torch.parallel import (
    initialize_distributed, mesh_from_config)
rank = int(os.environ["KGCT_PROCESS_ID"])
device = torch.device("cuda", int(os.environ["KGCT_TEST_DEVICES"].split(",")[rank]))
initialize_distributed(backend=os.environ["KGCT_TEST_BACKEND"], device=device,
                       timeout_s=120)
cfg = json.loads(os.environ["KGCT_TEST_CFG"])
par = ParallelConfig(tp=2, lockstep_check=True)
eng = LLMEngine(EngineConfig(
    model=get_model_config(cfg["model"]).replace(**cfg["over"]),
    cache=CacheConfig(page_size=16, num_pages=128),
    scheduler=SchedulerConfig(max_num_seqs=4, max_prefill_tokens=128),
    parallel=par), device=device, groups=mesh_from_config(par))
outs = eng.generate(cfg["prompts"], SamplingParams(max_tokens=16,
                                                   temperature=0.0))
print("TOKENS:" + json.dumps([o.output_token_ids for o in outs]), flush=True)
'''

# tinyllama-1.1b's heads (32 q, 4 kv, hd 64) at two layers, fp32: tp 2 puts
# 16 q and 2 kv heads on each rank.
TP_MODEL = dict(model="tinyllama-1.1b",
                over=dict(num_layers=2, dtype="float32"),
                prompts=[[5, 99, 23, 44, 17] * 4, list(range(1, 200)),
                         [7, 3, 9]])


@pytest.fixture(params=["nccl", "gloo"])
def tp_devices(request, cuda_device):
    """(backend, card per rank): NCCL needs two cards, one rank each; gloo
    runs both ranks on card 0."""
    if request.param == "nccl":
        if torch.cuda.device_count() < 2:
            pytest.skip("NCCL tp 2 needs two cards (NCCL refuses two ranks "
                        "on one device)")
        return "nccl", [0, 1]
    return "gloo", [0, 0]


@pytest.mark.gpu
def test_tp2_engine_on_the_card_matches_tp1(tp_devices, tmp_path):
    """Two ranks at tp 2 through the kernels give the one-card engine's
    greedy tokens (fp32, so summation order stays far from ties)."""
    backend, devices = tp_devices
    ref = LLMEngine(EngineConfig(
        model=get_model_config(TP_MODEL["model"]).replace(**TP_MODEL["over"]),
        cache=CacheConfig(page_size=16, num_pages=128),
        scheduler=SchedulerConfig(max_num_seqs=4, max_prefill_tokens=128)),
        device="cuda")
    want = [o.output_token_ids for o in ref.generate(
        TP_MODEL["prompts"], SamplingParams(max_tokens=16,
                                            temperature=0.0))]
    del ref
    torch.cuda.empty_cache()
    script = tmp_path / "rank.py"
    script.write_text(TP_RANK)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, KGCT_REPO=str(Path(__file__).parents[1]),
                   KGCT_COORDINATOR=f"127.0.0.1:{port}",
                   KGCT_NUM_PROCESSES="2", KGCT_PROCESS_ID=str(rank),
                   KGCT_TEST_DEVICES=",".join(map(str, devices)),
                   KGCT_TEST_BACKEND=backend, GLOO_SOCKET_IFNAME="lo",
                   KGCT_TEST_CFG=json.dumps(TP_MODEL))
        procs.append(subprocess.Popen([sys.executable, str(script)], env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        line = next(ln for ln in out.splitlines() if ln.startswith("TOKENS:"))
        assert json.loads(line[len("TOKENS:"):]) == want
