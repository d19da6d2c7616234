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
    """A (row, kv head)'s S * g queries: bf16 in ``tile_groups`` 64-row
    wgmma tiles, the fewest that hold them (one up to 64 queries); fp32 in
    blocks of ``block_rows``, the fewest 16-row tiles, at most four. Each
    cover holds every query once."""
    M = S * g
    groups = csv.tile_groups(M)
    assert groups == -(-M // csv.TILE_ROWS) and (groups == 1) == (M <= 64)
    tiles = [list(range(grp * 64, min((grp + 1) * 64, M)))
             for grp in range(groups)]
    assert [x for t in tiles for x in t] == list(range(M))
    assert all(0 < len(t) <= csv.TILE_ROWS for t in tiles)
    rows = csv.block_rows(M)
    assert rows in (16, 32, 64) and (rows >= M or rows == 64)
    assert rows == 16 or rows // 2 < M
    covered = [q for grp in range(-(-M // rows))
               for q in range(grp * rows, min((grp + 1) * rows, M))]
    assert covered == list(range(M))


@pytest.mark.parametrize("R,S,g,n_kv", [(32, 5, 4, 8), (1, 5, 4, 8),
                                        (4, 9, 16, 1), (8, 2, 1, 12)])
@pytest.mark.parametrize("pps,ps", [(512, 16), (1, 8), (33, 64)])
def test_spec_verify_plan_covers_every_token_once(R, S, g, n_kv, pps, ps):
    """The verify kernel's cut, mirrored by ``schedule``: on 132 SMs at one
    block each, every segment's units (its 64-key stages, then the slice)
    taken once, in order, by the blocks the kernel's merge finds, each with
    units; every pooled token in one stage; each (block, slot) holds one
    partial; every block's share within one unit of the others'."""
    blocks = csv.plan(132, 1)
    width = pps * ps
    lens = [0, 1, 2, ps, ps + 1, 65, width // 2 + 1, width, width + 7]
    ctx = [lens[(i * 5) % len(lens)] for i in range(R)]
    groups = csv.tile_groups(S * g)
    segs = csv.schedule(ctx, width, n_kv, groups, blocks)
    assert len(segs) == R * n_kv * groups
    U = sum(s.units for s in segs)
    P = min(blocks, U)
    shares = [U * (c + 1) // P - U * c // P for c in range(P)]
    assert min(shares) >= 1 and max(shares) - min(shares) <= 1
    slots = set()
    for s in segs:
        n_tok = min(max(ctx[s.row] - 1, 0), width)
        assert s.units == -(-n_tok // 64) + 1
        assert s.blocks[0][2] == 0 and s.blocks[-1][3] == s.units
        assert all(x[3] == y[2] for x, y in zip(s.blocks, s.blocks[1:]))
        assert [c for c, *_ in s.blocks] == sorted(c for c, *_ in s.blocks)
        keys = [t for i in range(s.units - 1)
                for t in range(64 * i, min(64 * (i + 1), n_tok))]
        assert keys == list(range(n_tok))
        if len(s.blocks) > 1:
            slots.update((c, slot) for c, slot, *_ in s.blocks)
            assert all(slot in (2 * c, 2 * c + 1) for c, slot, *_ in s.blocks)
    assert len(slots) == sum(len(s.blocks) for s in segs
                             if len(s.blocks) > 1)


def test_spec_verify_plan_engine_shape():
    """llama-3-8b (g 4, 8 kv heads) at the engine's 512-page table on 132
    SMs at one block each: 132 blocks whatever R; 20 queries a (row, kv
    head) at k 4 in one tile, 36 at k 8, qwen2.5-7b's 35 (g 7) too, 256
    at g 16 x S 16 in four. At R 32 over contexts 512-2048 every block
    takes 43 or 44 units, about two segments' worth, and half the segments
    are cut in two, none in more; at R 1 and 8191 keys each of the row's 8
    segments is cut over 17 blocks."""
    assert csv.plan(132, 1) == 132
    assert [csv.tile_groups(M) for M in (20, 36, 35, 64, 65, 256)] == [
        1, 1, 1, 1, 2, 4]
    ctx = np.random.default_rng(0).integers(512, 2049, 32)
    segs = csv.schedule(ctx, 8192, 8, 1, 132)
    U = sum(s.units for s in segs)
    assert U == 8 * sum(-(-(int(c) - 1) // 64) + 1 for c in ctx)
    assert U // 132 == 43
    assert sum(len(s.blocks) > 1 for s in segs) == len(segs) // 2
    assert max(len(s.blocks) for s in segs) == 2
    segs = csv.schedule([8191], 8192, 8, 1, 132)
    assert {len(s.blocks) for s in segs} == {17}


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("ps", [8, 16, 32, 64, 128])
def test_spec_verify_tma_boxes_per_stage(ps, hd):
    """A stage of 64 keys as TMA boxes: a box is one page (or a 64-key
    piece of a larger page) by one 64-column half (128 bytes, the
    swizzle's line), whole 8-row atoms, so every box lands 1024-aligned;
    K's and V's boxes fit the producer warp's 32 lanes; the ring holds at
    least three stages in 96 KB."""
    br = csv.box_rows(ps)
    assert br % 8 == 0 and (ps % br == 0) and 64 % br == 0
    pieces = csv.stage_boxes(ps, hd) // (hd // 64)
    assert pieces * br == csv.STAGE_KEYS
    assert 2 * csv.stage_boxes(ps, hd) <= 32
    stage_bytes = 2 * csv.STAGE_KEYS * hd * 2
    assert csv.ring_stages(hd) >= 3
    assert csv.ring_stages(hd) * stage_bytes <= csv.RING_BYTES


@pytest.mark.parametrize("L,layer", [(1, 0), (2, 1), (32, 31)])
def test_spec_verify_layer_row_offset(L, layer):
    """The tensor map covers the stacked pool as rows of n_kv * hd:
    ``layer_row(layer, P, ps) + page * ps + t`` is pool[layer, page, t]."""
    P, ps, kd = 5, 16, 24
    pool = torch.arange(L * P * ps * kd).reshape(L, P, ps, kd)
    flat = pool.reshape(-1, kd)
    for page, t in ((0, 0), (3, 7), (P - 1, ps - 1)):
        row = csv.layer_row(layer, P, ps) + page * ps + t
        assert torch.equal(flat[row], pool[layer, page, t])


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
