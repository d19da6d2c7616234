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
its own: its card cases hold page copies to bit equality, pin the host-page
reuse fence, and drive small card engines through swap and import.
"""

import pytest
import torch

from kubernetes_gpu_cluster_tpu_torch.config import (CacheConfig,
                                                     EngineConfig,
                                                     SchedulerConfig,
                                                     get_model_config)
from kubernetes_gpu_cluster_tpu_torch.engine import LLMEngine, SamplingParams
from kubernetes_gpu_cluster_tpu_torch.engine import kv_cache as KV
from kubernetes_gpu_cluster_tpu_torch.models import llama as M
from kubernetes_gpu_cluster_tpu_torch.ops import attention as A
from kubernetes_gpu_cluster_tpu_torch.ops import quant as Q
from kubernetes_gpu_cluster_tpu_torch.ops.cuda import flash_prefill as cfp
from kubernetes_gpu_cluster_tpu_torch.ops.cuda import flash_prefill_hist as cfh
from kubernetes_gpu_cluster_tpu_torch.ops.cuda import int4_matmul as c4
from kubernetes_gpu_cluster_tpu_torch.ops.cuda import paged_decode as cpd

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
            table.to(cuda_device), hist_len, hd ** -0.5)
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
            table.to(cuda_device), hist_len, hd ** -0.5)
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
            table.to(device), hist_len, hd ** -0.5)


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
    Each half equals its plain version (the verify half IS the plain
    version, fed row slices of the step's token axis); the chunk length
    computed once (``n_valid``) gives the same bits."""
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
            pos, kp, vp, table[None], hist_len, tables.to(cuda_device),
            ctx.to(cuda_device), scale)
    before = cfh.launches
    got = A.spec_mixed_attention(*args, n_prefill=Tp, layer=1)
    assert cfh.launches == before + 1
    torch.testing.assert_close(got[:Tp], A.prefill_history_attention_plain(
        q, k, v, seg_c, pos_c, kp, vp, table, hist_len, scale, layer=1),
        atol=TOL[dtype], rtol=0)
    torch.testing.assert_close(got[Tp:], A.spec_verify_attention_plain(
        qs, ks, vs, kp, vp, tables.to(cuda_device), ctx.to(cuda_device),
        scale, layer=1), atol=TOL[dtype], rtol=0)
    again = A.spec_mixed_attention(*args, n_prefill=Tp, layer=1,
                                   n_valid=cfh.valid_tokens(seg_c))
    assert torch.equal(got, again)


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
    return kv, KV.KVSwapper(host, lambda: kv, KV.KVTransferPrograms(device))


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
