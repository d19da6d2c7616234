"""The port's attention ops against the JAX package, on the CPU.

Every plain PyTorch version in ``kubernetes_gpu_cluster_tpu_torch.ops.attention``
is fed the same numpy inputs (made from a seed) as the JAX XLA oracle and
the JAX Pallas kernel in interpret mode, and must agree at fp32 atol 2e-5:
both sides compute in fp32 with different summation orders (einsum vs
flash-style online softmax), which moves results by a few ulps of values
of order 1 — 2e-5 is well above that and far below any masking or indexing
error (those move outputs by O(0.1)). ``write_kv_pages_all`` is a pure data
movement and must match exactly.

The CUDA kernels themselves cannot run here (no nvcc, no card): their
tests are in ``test_torch_kernels_gpu.py`` (marker ``gpu``) and
``chip_smoke.py`` holds them against these plain versions on the card.
Their host-side launch math (``kb_min``) is plain torch and is tested here,
and so is the wrappers' refusal of CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_gpu_cluster_tpu.ops import attention as JA
from kubernetes_gpu_cluster_tpu.ops.pallas.flash_prefill import \
    flash_ragged_prefill
from kubernetes_gpu_cluster_tpu.ops.pallas.flash_prefill_hist import \
    flash_prefill_history
from kubernetes_gpu_cluster_tpu.ops.pallas.paged_decode import \
    pallas_paged_decode
from kubernetes_gpu_cluster_tpu_torch.ops import attention as TA
from kubernetes_gpu_cluster_tpu_torch.ops.cuda import flash_prefill as cfp
from kubernetes_gpu_cluster_tpu_torch.ops.cuda import flash_prefill_hist as cfh
from kubernetes_gpu_cluster_tpu_torch.ops.cuda import paged_decode as cpd
from kubernetes_gpu_cluster_tpu_torch.ops.cuda import spec_verify as csv

torch.set_num_threads(2)

ATOL = 2e-5


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=0, atol=atol)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _segments(T, lens):
    seg = np.full(T, -1, np.int32)
    pos = np.zeros(T, np.int32)
    i = 0
    for s, n in enumerate(lens):
        seg[i:i + n] = s
        pos[i:i + n] = np.arange(n)
        i += n
    return seg, pos


class TestRaggedPrefill:
    @pytest.mark.parametrize("T,lens,nh,nkv,hd,block", [
        (50, [13, 20, 9], 4, 2, 32, 16),       # T not a multiple of 16
        (37, [5, 1, 17, 10], 8, 2, 64, 16),    # 4 segments, 1-token segment
        (64, [16, 16, 16, 16], 4, 4, 32, 32),  # no padding, MHA
    ])
    def test_matches_jax(self, T, lens, nh, nkv, hd, block):
        rng = np.random.default_rng(T)
        q = rng.standard_normal((T, nh, hd)).astype(np.float32)
        k = rng.standard_normal((T, nkv, hd)).astype(np.float32)
        v = rng.standard_normal((T, nkv, hd)).astype(np.float32)
        seg, pos = _segments(T, lens)
        scale = hd ** -0.5
        got = TA.ragged_prefill_attention_plain(
            _t(q), _t(k), _t(v), _t(seg), _t(pos), scale).numpy()
        xla = JA.ragged_prefill_attention_xla(q, k, v, seg, pos, scale)
        pallas = flash_ragged_prefill(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg),
            jnp.asarray(pos), scale, block_q=block, block_k=block,
            interpret=True)
        _close(got, xla)
        _close(got, pallas)
        # Padding rows emit zeros.
        assert np.all(got[seg < 0] == 0)

    def test_dispatcher_takes_plain_version_on_cpu(self):
        rng = np.random.default_rng(1)
        q = _t(rng.standard_normal((8, 2, 32)).astype(np.float32))
        k = _t(rng.standard_normal((8, 1, 32)).astype(np.float32))
        seg, pos = _segments(8, [3, 5])
        before = cfp.launches
        out = TA.ragged_prefill_attention(q, k, k, _t(seg), _t(pos), 0.2)
        ref = TA.ragged_prefill_attention_plain(q, k, k, _t(seg), _t(pos),
                                                0.2)
        assert torch.equal(out, ref)
        assert cfp.launches == before


class TestPrefillHistory:
    @pytest.mark.parametrize("hist_len,nh,nkv,hd,ps", [
        (0, 4, 2, 32, 8), (13, 8, 2, 64, 16), (40, 4, 2, 32, 8)])
    def test_matches_jax(self, hist_len, nh, nkv, hd, ps):
        T, n_valid, L, layer = 24, 19, 2, 1
        pps = -(-(hist_len + T) // ps) + 1
        P = pps + 3
        rng = np.random.default_rng(hist_len + ps)
        q = rng.standard_normal((T, nh, hd)).astype(np.float32)
        k = rng.standard_normal((T, nkv, hd)).astype(np.float32)
        v = rng.standard_normal((T, nkv, hd)).astype(np.float32)
        kp = rng.standard_normal((L, P, ps, nkv * hd)).astype(np.float32)
        vp = rng.standard_normal((L, P, ps, nkv * hd)).astype(np.float32)
        table = rng.permutation(np.arange(1, P))[:pps].astype(np.int32)
        seg = np.where(np.arange(T) < n_valid, 0, -1).astype(np.int32)
        pos = (hist_len + np.arange(T)).astype(np.int32)
        scale = hd ** -0.5
        got = TA.prefill_history_attention_plain(
            _t(q), _t(k), _t(v), _t(seg), _t(pos), _t(kp), _t(vp), _t(table),
            hist_len, scale, layer=layer).numpy()
        xla = JA.prefill_history_attention_xla(
            q, k, v, seg, pos, kp, vp, table, jnp.int32(hist_len), scale,
            layer=jnp.int32(layer))
        pallas = flash_prefill_history(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg),
            jnp.asarray(pos), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(table), jnp.int32(hist_len), scale,
            layer=jnp.int32(layer), block_q=8, block_k=8, interpret=True)
        _close(got, xla)
        _close(got, pallas)
        assert np.all(got[n_valid:] == 0)

    @pytest.mark.parametrize("hist_len", [0, 5, 29])
    def test_hist_len_tensor_matches_jax(self, hist_len):
        """``hist_len`` as the int32 [1] tensor the engine's programs pass
        (the kernel reads it on the device): the dispatcher's plain path
        against the JAX reference at the same value, and bit-equal to the
        int."""
        T, n_valid, L, layer, nh, nkv, hd, ps = 16, 11, 2, 0, 4, 2, 32, 8
        pps = 8
        P = pps + 2
        rng = np.random.default_rng(100 + hist_len)
        q = rng.standard_normal((T, nh, hd)).astype(np.float32)
        k = rng.standard_normal((T, nkv, hd)).astype(np.float32)
        v = rng.standard_normal((T, nkv, hd)).astype(np.float32)
        kp = rng.standard_normal((L, P, ps, nkv * hd)).astype(np.float32)
        vp = rng.standard_normal((L, P, ps, nkv * hd)).astype(np.float32)
        table = rng.permutation(np.arange(1, P))[:pps].astype(np.int32)
        seg = np.where(np.arange(T) < n_valid, 0, -1).astype(np.int32)
        pos = (hist_len + np.arange(T)).astype(np.int32)
        scale = hd ** -0.5
        args = (_t(q), _t(k), _t(v), _t(seg), _t(pos), _t(kp), _t(vp),
                _t(table))
        got = TA.prefill_history_attention(
            *args, torch.tensor([hist_len], dtype=torch.int32), scale,
            layer=layer).numpy()
        want = JA.prefill_history_attention_xla(
            q, k, v, seg, pos, kp, vp, table, jnp.int32(hist_len), scale,
            layer=jnp.int32(layer))
        _close(got, want)
        np.testing.assert_array_equal(got, TA.prefill_history_attention(
            *args, hist_len, scale, layer=layer).numpy())


class TestPagedDecode:
    @pytest.mark.parametrize("nh,nkv,hd,ps", [(4, 2, 32, 8), (8, 8, 64, 16)])
    def test_matches_jax(self, nh, nkv, hd, ps):
        B, pps, L, layer = 5, 4, 2, 1
        P = B * pps + 1
        rng = np.random.default_rng(ps + nh)
        q = rng.standard_normal((B, nh, hd)).astype(np.float32)
        kp = rng.standard_normal((L, P, ps, nkv * hd)).astype(np.float32)
        vp = rng.standard_normal((L, P, ps, nkv * hd)).astype(np.float32)
        kc = rng.standard_normal((B, nkv, hd)).astype(np.float32)
        vc = rng.standard_normal((B, nkv, hd)).astype(np.float32)
        tables = rng.permutation(np.arange(1, P)).reshape(B, pps).astype(
            np.int32)
        # ctx 1 (empty pool), partial pages, a padded row (ctx 0), full table.
        ctx = np.array([1, ps + 2, 2 * ps, 0, pps * ps], np.int32)
        tables[3] = 0                       # padded row: scrap-page table
        scale = hd ** -0.5
        got = TA.paged_decode_attention_plain(
            _t(q), _t(kp), _t(vp), _t(tables), _t(ctx), _t(kc), _t(vc), scale,
            layer=layer).numpy()
        xla = JA.paged_decode_attention_xla(
            q, kp, vp, tables, ctx, kc, vc, scale, layer=jnp.int32(layer))
        pallas = pallas_paged_decode(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(tables), jnp.asarray(ctx), jnp.asarray(kc),
            jnp.asarray(vc), scale, layer=layer, interpret=True)
        _close(got, xla)
        _close(got, pallas)
        assert np.all(np.isfinite(got))


def test_write_kv_pages_all_exact():
    L, P, ps, nkv, hd, T = 2, 6, 4, 2, 8, 7
    rng = np.random.default_rng(7)
    kk = rng.standard_normal((L, P, ps, nkv * hd)).astype(np.float32)
    vv = rng.standard_normal((L, P, ps, nkv * hd)).astype(np.float32)
    k_all = rng.standard_normal((L, T, nkv, hd)).astype(np.float32)
    v_all = rng.standard_normal((L, T, nkv, hd)).astype(np.float32)
    # Real slots on pages 2 and 5, no scrap-page duplicates (their winner
    # is unspecified on both sides).
    slots = np.array([8, 9, 10, 11, 20, 21, 3], np.int32)
    jk, jv = JA.write_kv_pages_all(jnp.asarray(kk), jnp.asarray(vv),
                                   jnp.asarray(k_all), jnp.asarray(v_all),
                                   jnp.asarray(slots))
    tk, tv = _t(kk.copy()), _t(vv.copy())
    out = TA.write_kv_pages_all(tk, tv, _t(k_all), _t(v_all), _t(slots))
    assert out[0] is tk and out[1] is tv          # in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_mixed_attention_matches_jax():
    nh, nkv, hd, ps, L, layer = 4, 2, 32, 8, 2, 0
    Tp, R, hist_len, chunk = 16, 4, 11, 13
    P = 24
    rng = np.random.default_rng(11)
    T = Tp + R
    q = rng.standard_normal((T, nh, hd)).astype(np.float32)
    k = rng.standard_normal((T, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((T, nkv, hd)).astype(np.float32)
    kp = rng.standard_normal((L, P, ps, nkv * hd)).astype(np.float32)
    vp = rng.standard_normal((L, P, ps, nkv * hd)).astype(np.float32)
    seg = np.full(T, -1, np.int32)
    seg[:chunk] = 0
    pos = np.zeros(T, np.int32)
    pos[:chunk] = hist_len + np.arange(chunk)
    pos[Tp:] = [3, 9, 17, 0]
    chunk_pt = np.array([[5, 6, 7, 8]], np.int32)
    tables = np.array([[1, 2, 0], [3, 4, 0], [9, 10, 11], [0, 0, 0]],
                      np.int32)
    ctx = np.array([4, 10, 18, 0], np.int32)
    scale = hd ** -0.5
    got = TA.mixed_attention(
        _t(q), _t(k), _t(v), _t(seg), _t(pos), _t(kp), _t(vp), _t(chunk_pt),
        hist_len, _t(tables), _t(ctx), scale, n_prefill=Tp,
        layer=layer).numpy()
    want = JA.mixed_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg),
        jnp.asarray(pos), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(chunk_pt), jnp.int32(hist_len), jnp.asarray(tables),
        jnp.asarray(ctx), scale, n_prefill=Tp, layer=jnp.int32(layer),
        use_pallas=False, use_pallas_hist=False)
    _close(got, want)


@pytest.mark.parametrize("lens,T", [([13, 20, 9], 50), ([100], 100),
                                    ([5, 40, 3, 70], 130)])
def test_kb_min_matches_tpu_window(lens, T):
    """The CUDA prefill wrapper's K-window starts equal the TPU kernel's
    (flash_prefill.py kb_min: change points + cummax, floored to tiles)."""
    seg, _ = _segments(T, lens)
    bq, bk = cfp.BLOCK_Q, cfp.BLOCK_K
    s = jnp.asarray(seg)
    idx = jnp.arange(T, dtype=jnp.int32)
    change = jnp.concatenate([jnp.ones((1,), bool), s[1:] != s[:-1]])
    starts = jax.lax.cummax(jnp.where(change, idx, 0))
    nq = -(-T // bq)
    first = jnp.minimum(jnp.arange(nq, dtype=jnp.int32) * bq, T - 1)
    want = np.asarray(starts[first] // bk)
    got = cfp.kb_min(_t(seg), bq, bk).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("B,n_kv", [(32, 8), (1, 8), (4, 1), (3, 16),
                                    (200, 8)])
@pytest.mark.parametrize("pps,ps", [(512, 16), (1, 8), (6, 16), (7, 128),
                                    (1024, 8), (33, 64)])
def test_paged_decode_plan_covers_every_token_once(B, n_kv, pps, ps):
    """The split-K plan is plain host math on the shapes and the SM count
    alone (no context length, no device value): the same shapes give the
    same plan, and for every context the blocks that run cover each pooled
    token exactly once, in order, in whole stages, within the grid."""
    p = cpd.plan(B, n_kv, pps, ps, 132)
    assert p == cpd.plan(B, n_kv, pps, ps, 132)
    assert p.min_split % cpd.STAGE_KEYS == 0
    assert 1 <= p.splits <= cpd.MAX_SPLITS
    width = pps * ps
    assert (p.splits - 1) * p.min_split < width        # no split always empty
    for n_tok in sorted({0, 1, ps - 1, ps, p.min_split - 1, p.min_split,
                         p.min_split + 1, width // 3, width - 1, width}):
        if not 0 <= n_tok <= width:
            continue
        ranges = cpd.split_ranges(p, n_tok)
        assert 1 <= len(ranges) <= p.splits
        assert [t for lo, hi in ranges for t in range(lo, hi)] == list(
            range(n_tok))
        assert all(lo % cpd.STAGE_KEYS == 0 for lo, _ in ranges)
        assert all(lo < hi for lo, hi in ranges) or n_tok == 0


def test_paged_decode_plan_engine_shape():
    """llama-3-8b (8 kv heads) on 132 SMs over the engine's decode table
    (512 pages of 16): the grid never passes two waves of two blocks per
    SM, so 2 splits per (sequence, kv head) at B 32, 8 at B 8 (a 4096-key
    context as eight splits of 512 keys, a 300-key one as one split), 16
    at B 1. The workspace holds one fp32 partial (o [g, hd], m, l) per
    split slot of the grid."""
    assert cpd.plan(32, 8, 512, 16, 132) == cpd.Plan(512, 2)
    p = cpd.plan(8, 8, 512, 16, 132)
    assert p == cpd.Plan(512, 8)
    assert cpd.split_ranges(p, 4095) == [(s, min(s + 512, 4095))
                                         for s in range(0, 4095, 512)]
    assert cpd.split_ranges(p, 300) == [(0, 300)]
    assert cpd.split_ranges(cpd.plan(32, 8, 512, 16, 132), 4095) == [
        (0, 2048), (2048, 4095)]
    assert cpd.plan(1, 8, 512, 16, 132) == cpd.Plan(512, 16)
    assert cpd.workspace_floats(p, 8, 8, 4, 128) == 8 * 8 * 8 * 4 * 130
    for B in (1, 2, 4, 8, 16, 32):
        assert B * 8 * cpd.plan(B, 8, 512, 16, 132).splits <= 4 * 132


# (nh, n_kv, hd, S, contexts per row (0: padding row), page size, table
# pages): verify rows over the WHOLE table, as a captured verify program
# takes it, ragged contexts from 1 to nearly the table's width.
WHOLE_TABLE_CASES = [
    (8, 2, 32, 5, [1, 37, 0, 120, 9, 0], 8, 16),
    (4, 4, 64, 9, [60, 3, 0, 2], 16, 8),
    (16, 1, 32, 2, [100, 0, 17], 8, 32),
]


@pytest.mark.parametrize("nh,nkv,hd,S,ctx,ps,pps", WHOLE_TABLE_CASES)
def test_spec_verify_plain_whole_table_matches_jax(nh, nkv, hd, S, ctx, ps,
                                                   pps):
    """The plain verify over the whole ``[R, pps]`` table (columns past a
    row's pages on the scrap page 0, padding rows all scrap) equals the
    JAX XLA verify on the same inputs: the pool's stale bytes past each
    row's history and the scrap page's garbage must not leak in."""
    rng = np.random.default_rng(len(ctx) + S)
    R = len(ctx)
    P = 1 + sum(-(-c // ps) for c in ctx) + 2
    perm = rng.permutation(np.arange(1, P)).astype(np.int32)
    tables = np.zeros((R, pps), np.int32)
    o = 0
    for r, c in enumerate(ctx):
        n = -(-c // ps)
        tables[r, :n] = perm[o:o + n]
        o += n
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa: E731
    args = dict(q=f(R * S, nh, hd), k=f(R * S, nkv, hd), v=f(R * S, nkv, hd),
                k_pool=f(2, P, ps, nkv * hd), v_pool=f(2, P, ps, nkv * hd),
                page_tables=tables, context_lens=np.array(ctx, np.int32))
    want = JA.spec_verify_attention_xla(
        **{k: jnp.asarray(v) for k, v in args.items()}, scale=hd ** -0.5,
        layer=1)
    got = TA.spec_verify_attention(**{k: _t(v) for k, v in args.items()},
                                   scale=hd ** -0.5, layer=1)
    _close(got.numpy(), want)
    pad = np.repeat(np.array(ctx) == 0, S)
    assert np.isfinite(got.numpy()[pad]).all()


@pytest.mark.parametrize("S,g", [(2, 1), (5, 4), (9, 4), (5, 7), (5, 8),
                                 (9, 16), (16, 16)])
def test_spec_verify_blocks_hold_every_query_once(S, g):
    """A (row, kv head)'s S * g queries in blocks of ``block_rows``: the
    fewest 16-row tiles that hold them, at most four, ``groups`` blocks
    covering them once."""
    M = S * g
    rows = csv.block_rows(M)
    assert rows in (16, 32, 64) and (rows >= M or rows == 64)
    assert rows == 16 or rows // 2 < M
    p = csv.plan(32, S, g, 8, 512, 16, 132)
    assert p.groups == -(-M // rows)
    covered = [q for grp in range(p.groups)
               for q in range(grp * rows, min((grp + 1) * rows, M))]
    assert covered == list(range(M))


@pytest.mark.parametrize("R,S,g,n_kv", [(32, 5, 4, 8), (1, 5, 4, 8),
                                        (4, 9, 16, 1), (8, 2, 1, 12)])
@pytest.mark.parametrize("pps,ps", [(512, 16), (1, 8), (33, 64)])
def test_spec_verify_plan_covers_every_token_once(R, S, g, n_kv, pps, ps):
    """The verify kernel's split plan, ``paged_decode``'s rule over its R *
    groups blocks of queries: host math on the shapes and the SM count
    alone, the grid within BLOCKS_PER_SM blocks an SM whenever it splits
    (the workspace's size), every pooled token in one split."""
    p = csv.plan(R, S, g, n_kv, pps, ps, 132)
    assert p == csv.plan(R, S, g, n_kv, pps, ps, 132)
    assert 1 <= p.splits <= csv.MAX_SPLITS
    assert p.min_split % csv.STAGE_KEYS == 0
    if p.splits > 1:
        assert p.splits * R * p.groups * n_kv <= csv.BLOCKS_PER_SM * 132
    width = pps * ps
    for n_tok in sorted({0, 1, ps, p.min_split + 1, width // 2, width}):
        ranges = csv.split_ranges(p, n_tok)
        assert 1 <= len(ranges) <= p.splits
        assert [t for lo, hi in ranges for t in range(lo, hi)] == list(
            range(n_tok))


def test_spec_verify_plan_engine_shape():
    """llama-3-8b (g 4, 8 kv heads) at the engine's 512-page table on 132
    SMs: 20 queries a (row, kv head) at k 4 take one block of two tiles;
    at R 32 the grid splits each row in 2, at R 1 in 16."""
    assert csv.plan(32, 5, 4, 8, 512, 16, 132) == csv.Plan(512, 2, 1)
    assert csv.plan(1, 5, 4, 8, 512, 16, 132) == csv.Plan(512, 16, 1)
    assert csv.plan(32, 9, 4, 8, 512, 16, 132) == csv.Plan(512, 2, 1)
    assert csv.plan(32, 5, 16, 1, 512, 16, 132).groups == 2


def test_history_valid_tokens():
    seg = torch.tensor([0] * 13 + [-1] * 3, dtype=torch.int32)
    n = TA.prefill_history_valid(seg)
    assert n.dtype == torch.int32 and n.tolist() == [13]
    assert cfh.valid_tokens(seg[:0]).tolist() == [0]


@pytest.mark.parametrize("fn,args", [
    (cpd.paged_decode, lambda: (
        torch.zeros(1, 2, 64), torch.zeros(2, 8, 64), torch.zeros(2, 8, 64),
        torch.zeros(1, 1, dtype=torch.int32), torch.ones(1, dtype=torch.int32),
        torch.zeros(1, 1, 64), torch.zeros(1, 1, 64), 0.1)),
    (cfp.flash_prefill, lambda: (
        torch.zeros(4, 2, 64), torch.zeros(4, 1, 64), torch.zeros(4, 1, 64),
        torch.zeros(4, dtype=torch.int32), torch.arange(4), 0.1)),
    (cfh.flash_prefill_hist, lambda: (
        torch.zeros(4, 2, 64), torch.zeros(4, 1, 64), torch.zeros(4, 1, 64),
        torch.zeros(4, dtype=torch.int32), torch.arange(4),
        torch.zeros(2, 8, 64), torch.zeros(2, 8, 64),
        torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32),
        0.1)),
    (csv.spec_verify, lambda: (
        torch.zeros(6, 2, 64), torch.zeros(6, 1, 64), torch.zeros(6, 1, 64),
        torch.zeros(2, 8, 64), torch.zeros(2, 8, 64),
        torch.zeros(2, 1, dtype=torch.int32),
        torch.ones(2, dtype=torch.int32), 0.1)),
])
def test_cuda_wrappers_refuse_cpu_tensors(fn, args):
    """A wrapper never falls back: a non-CUDA tensor is an error."""
    with pytest.raises(ValueError, match="CUDA"):
        fn(*args())
