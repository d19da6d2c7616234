"""The port's llama forward passes against the JAX package's, on the CPU.

One JAX weight set (``debug-tiny``, fp32, random from a seed) is carried
into the port with ``params_from_numpy``; both packages then run
``forward_prefill`` / ``forward_decode`` / ``forward_mixed`` /
``forward_prefill_hist`` on the same numpy inputs and the same starting KV
pool. Hidden states, logits and the written pool must agree at fp32 atol
1e-4: two layers of fp32 matmuls, norms and softmax summed in different
orders by XLA and by PyTorch drift by ~1e-6 on values of order 1; 1e-4
leaves room for that while any wrong mask, position, slot or layer index
moves outputs by O(0.1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_gpu_cluster_tpu.config import get_model_config as jax_model
from kubernetes_gpu_cluster_tpu.engine.kv_cache import KVCache as JKV
from kubernetes_gpu_cluster_tpu.models import llama as JM
from kubernetes_gpu_cluster_tpu_torch.config import get_model_config
from kubernetes_gpu_cluster_tpu_torch.engine.kv_cache import KVCache as TKV
from kubernetes_gpu_cluster_tpu_torch.models import llama as TM

torch.set_num_threads(2)

ATOL = 1e-4
PS = 8          # page size
P = 20          # pool pages (page 0 = scrap)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_model("debug-tiny")
    tcfg = get_model_config("debug-tiny")
    jp = JM.init_params(jcfg, jax.random.key(0))
    np_params = jax.tree.map(np.asarray, jp)
    tp = TM.params_from_numpy(np_params, tcfg, "cpu")
    rng = np.random.default_rng(0)
    kd = tcfg.num_kv_heads * tcfg.head_dim
    pool = [rng.standard_normal((tcfg.num_layers, P, PS, kd)).astype(
        np.float32) for _ in range(2)]
    return jcfg, tcfg, jp, tp, pool


def _pools(pool):
    return (JKV(k=jnp.asarray(pool[0]), v=jnp.asarray(pool[1])),
            TKV(k=torch.from_numpy(pool[0].copy()),
                v=torch.from_numpy(pool[1].copy())))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _check(jout, tout, jcfg, tcfg, jp, tp):
    (jn, jkv, jh), (tn, tkv, th) = jout, tout
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tkv.k.numpy(), np.asarray(jkv.k), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(tkv.v.numpy(), np.asarray(jkv.v), atol=ATOL,
                               rtol=0)
    jl = JM.compute_logits(jp, jcfg, jn, use_pallas=False)
    tl = TM.compute_logits(tp, tcfg, tn)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)


def test_forward_prefill_matches_jax(setup):
    jcfg, tcfg, jp, tp, pool = setup
    lens, T = [10, 17, 8], 40
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, tcfg.vocab_size, T).astype(np.int32)
    seg = np.full(T, -1, np.int32)
    pos = np.zeros(T, np.int32)
    slots = np.zeros(T, np.int32)          # padding -> scrap page 0
    last, o, page = [], 0, 1
    for s, n in enumerate(lens):
        seg[o:o + n] = s
        pos[o:o + n] = np.arange(n)
        slots[o:o + n] = page * PS + np.arange(n)
        page += -(-n // PS)
        last.append(o + n - 1)
        o += n
    last = np.array(last, np.int32)
    jkv, tkv = _pools(pool)
    jmeta = JM.PrefillMeta(jnp.asarray(seg), jnp.asarray(pos),
                           jnp.asarray(slots), jnp.asarray(last))
    tmeta = TM.PrefillMeta(_t(seg), _t(pos), _t(slots), _t(last))
    jout = JM.forward_prefill(jp, jcfg, jnp.asarray(tokens), jmeta, jkv,
                              use_pallas=False)
    tout = TM.forward_prefill(tp, tcfg, _t(tokens), tmeta, tkv)
    # Padding tokens all write the scrap page: compare real pages only.
    jn, jk, jh = jout
    jk = JKV(k=jk.k.at[:, 0].set(0), v=jk.v.at[:, 0].set(0))
    tout[1].k[:, 0] = 0
    tout[1].v[:, 0] = 0
    _check((jn, jk, jh), tout, jcfg, tcfg, jp, tp)


def test_forward_prefill_hoists_kernel_window(setup, monkeypatch):
    """forward_prefill computes the flash kernel's K-window starts once and
    hands the same tensor to every layer; it equals kb_min(seg_ids), and
    the forward is identical to one whose attention computes the window
    per call."""
    from kubernetes_gpu_cluster_tpu_torch.ops import attention as TA
    from kubernetes_gpu_cluster_tpu_torch.ops.cuda import flash_prefill as cfp
    _, tcfg, _, tp, pool = setup
    T = 150                     # three 64-row q tiles, a segment across two
    seg = np.full(T, -1, np.int32)
    seg[:70], seg[70:139] = 0, 1
    pos = np.zeros(T, np.int32)
    pos[:70], pos[70:139] = np.arange(70), np.arange(69)
    slots = np.zeros(T, np.int32)
    tokens = np.random.default_rng(7).integers(
        0, tcfg.vocab_size, T).astype(np.int32)
    meta = TM.PrefillMeta(_t(seg), _t(pos), _t(slots),
                          _t(np.array([69, 138], np.int32)))
    seen = []

    def hoisted(q, k, v, s, p, scale, window=None):
        seen.append(window)
        return TA.ragged_prefill_attention(q, k, v, s, p, scale, window)

    def per_call(q, k, v, s, p, scale, window=None):
        seen.append(cfp.kb_min(s))
        return TA.ragged_prefill_attention(q, k, v, s, p, scale)

    outs = []
    for fn in (hoisted, per_call):
        monkeypatch.setattr(TM, "ragged_prefill_attention", fn)
        outs.append(TM.forward_prefill(tp, tcfg, _t(tokens), meta,
                                       _pools(pool)[1]))
    L = tcfg.num_layers
    assert len(seen) == 2 * L
    assert all(w is seen[0] for w in seen[:L])     # one tensor, all layers
    want = cfp.kb_min(_t(seg))
    assert want.tolist() == [0, 0, 1]
    for w in seen:
        assert torch.equal(w, want)
    for a, b in zip(outs[0][::2], outs[1][::2]):
        assert torch.equal(a, b)


def _decode_inputs():
    B = 4
    tables = np.array([[1, 2, 3], [4, 5, 0], [6, 7, 8], [0, 0, 0]], np.int32)
    pos = np.array([5, 12, 20, 0], np.int32)    # row 3 is padding (ctx 0)
    ctx = np.array([6, 13, 21, 0], np.int32)
    slots = np.array([t[p // PS] * PS + p % PS
                      for t, p in zip(tables, pos)], np.int32)
    slots[3] = 0
    return B, tables, pos, ctx, slots


def test_forward_decode_matches_jax(setup):
    jcfg, tcfg, jp, tp, pool = setup
    B, tables, pos, ctx, slots = _decode_inputs()
    tokens = np.array([3, 77, 500, 0], np.int32)
    jkv, tkv = _pools(pool)
    jmeta = JM.DecodeMeta(jnp.asarray(pos), jnp.asarray(slots),
                          jnp.asarray(tables), jnp.asarray(ctx))
    tmeta = TM.DecodeMeta(_t(pos), _t(slots), _t(tables), _t(ctx))
    jout = JM.forward_decode(jp, jcfg, jnp.asarray(tokens), jmeta, jkv,
                             use_pallas=False)
    tout = TM.forward_decode(tp, tcfg, _t(tokens), tmeta, tkv)
    _check(jout, tout, jcfg, tcfg, jp, tp)


def _hist_case(vocab, hist_len):
    """One 13-token chunk padded to 16 over ``hist_len`` pooled tokens:
    (tokens, seg, pos, slots, last, table)."""
    T, n_valid = 16, 13
    pages = np.array([9, 10, 11, 12, 13], np.int32)
    table = np.zeros(8, np.int32)
    table[:len(pages)] = pages
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, vocab, T).astype(np.int32)
    seg = np.where(np.arange(T) < n_valid, 0, -1).astype(np.int32)
    pos = np.zeros(T, np.int32)
    pos[:n_valid] = hist_len + np.arange(n_valid)
    slots = np.zeros(T, np.int32)
    slots[:n_valid] = pages[pos[:n_valid] // PS] * PS + pos[:n_valid] % PS
    last = np.array([n_valid - 1], np.int32)
    return tokens, seg, pos, slots, last, table


@pytest.mark.parametrize("hist_len", [0, 19])
def test_forward_prefill_hist_matches_jax(setup, hist_len):
    jcfg, tcfg, jp, tp, pool = setup
    tokens, seg, pos, slots, last, table = _hist_case(tcfg.vocab_size,
                                                      hist_len)
    jkv, tkv = _pools(pool)
    jmeta = JM.PrefillMeta(jnp.asarray(seg), jnp.asarray(pos),
                           jnp.asarray(slots), jnp.asarray(last))
    tmeta = TM.PrefillMeta(_t(seg), _t(pos), _t(slots), _t(last))
    jout = JM.forward_prefill_hist(jp, jcfg, jnp.asarray(tokens), jmeta, jkv,
                                   jnp.asarray(table), jnp.int32(hist_len),
                                   use_pallas=False)
    tout = TM.forward_prefill_hist(tp, tcfg, _t(tokens), tmeta, tkv,
                                   _t(table), hist_len)
    jn, jk, jh = jout
    jk = JKV(k=jk.k.at[:, 0].set(0), v=jk.v.at[:, 0].set(0))
    tout[1].k[:, 0] = 0
    tout[1].v[:, 0] = 0
    _check((jn, jk, jh), tout, jcfg, tcfg, jp, tp)


def _mixed_case(vocab):
    """An 11-token chunk padded to 16 over 9 pooled tokens, then the four
    decode rows of ``_decode_inputs``: (tokens, seg, pos, slots,
    logits_idx, chunk_pt, hist_len, tables, ctx)."""
    Tp, chunk, hist_len = 16, 11, 9
    R, tables, dpos, ctx, dslots = _decode_inputs()
    T = Tp + R
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, vocab, T).astype(np.int32)
    chunk_pages = np.array([14, 15, 16], np.int32)
    chunk_pt = np.zeros((1, 4), np.int32)
    chunk_pt[0, :3] = chunk_pages
    seg = np.full(T, -1, np.int32)
    seg[:chunk] = 0
    pos = np.zeros(T, np.int32)
    pos[:chunk] = hist_len + np.arange(chunk)
    pos[Tp:] = dpos
    slots = np.zeros(T, np.int32)
    cp = pos[:chunk]
    slots[:chunk] = chunk_pages[cp // PS] * PS + cp % PS
    slots[Tp:] = dslots
    logits_idx = np.array([Tp, Tp + 1, Tp + 2, chunk - 1], np.int32)
    return tokens, seg, pos, slots, logits_idx, chunk_pt, hist_len, tables, ctx


def test_forward_mixed_matches_jax(setup):
    jcfg, tcfg, jp, tp, pool = setup
    (tokens, seg, pos, slots, logits_idx, chunk_pt, hist_len, tables,
     ctx) = _mixed_case(tcfg.vocab_size)
    jkv, tkv = _pools(pool)
    jmeta = JM.MixedMeta(
        jnp.asarray(seg), jnp.asarray(pos), jnp.asarray(slots),
        jnp.asarray(logits_idx), jnp.asarray(chunk_pt), jnp.int32(hist_len),
        jnp.asarray(tables), jnp.asarray(ctx))
    tmeta = TM.MixedMeta(_t(seg), _t(pos), _t(slots), _t(logits_idx),
                         _t(chunk_pt), hist_len, _t(tables), _t(ctx))
    jout = JM.forward_mixed(jp, jcfg, jnp.asarray(tokens), jmeta, jkv,
                            use_pallas=False, use_pallas_hist=False)
    tout = TM.forward_mixed(tp, tcfg, _t(tokens), tmeta, tkv)
    jn, jk, jh = jout
    jk = JKV(k=jk.k.at[:, 0].set(0), v=jk.v.at[:, 0].set(0))
    tout[1].k[:, 0] = 0
    tout[1].v[:, 0] = 0
    _check((jn, jk, jh), tout, jcfg, tcfg, jp, tp)


@pytest.mark.parametrize("forward", ["prefill_hist", "mixed"])
def test_forward_hoists_history_valid_count(setup, monkeypatch, forward):
    """forward_prefill_hist and forward_mixed compute the history kernel's
    chunk length n_valid once per forward (not once per layer) and hand the
    same tensor to every layer; it counts the chunk's tokens, and the
    forward is identical to one whose attention computes it per call."""
    from kubernetes_gpu_cluster_tpu_torch.ops import attention as TA
    _, tcfg, _, tp, pool = setup
    counted = []

    def count(seg_ids):
        counted.append(seg_ids)
        return TA.prefill_history_valid(seg_ids)

    monkeypatch.setattr(TM, "prefill_history_valid", count)
    if forward == "prefill_hist":
        tokens, seg, pos, slots, last, table = _hist_case(tcfg.vocab_size, 19)
        meta = TM.PrefillMeta(_t(seg), _t(pos), _t(slots), _t(last))
        name, want = "prefill_history_attention", 13
        base = TA.prefill_history_attention

        def run():
            return TM.forward_prefill_hist(tp, tcfg, _t(tokens), meta,
                                           _pools(pool)[1], _t(table), 19)
    else:
        (tokens, seg, pos, slots, logits_idx, chunk_pt, hist_len, tables,
         ctx) = _mixed_case(tcfg.vocab_size)
        meta = TM.MixedMeta(_t(seg), _t(pos), _t(slots), _t(logits_idx),
                            _t(chunk_pt), hist_len, _t(tables), _t(ctx))
        name, want = "mixed_attention", 11
        base = TA.mixed_attention

        def run():
            return TM.forward_mixed(tp, tcfg, _t(tokens), meta,
                                    _pools(pool)[1])
    seen = []

    def hoisted(*a, n_valid=None, **kw):
        seen.append(n_valid)
        return base(*a, n_valid=n_valid, **kw)

    def per_call(*a, n_valid=None, **kw):
        s = a[3] if forward == "prefill_hist" else a[3][:kw["n_prefill"]]
        seen.append(TA.prefill_history_valid(s))
        return base(*a, **kw)

    outs = []
    for fn in (hoisted, per_call):
        monkeypatch.setattr(TM, name, fn)
        outs.append(run())
    L = tcfg.num_layers
    assert len(counted) == 2                        # one per forward
    assert len(seen) == 2 * L
    assert all(n is seen[0] for n in seen[:L])      # one tensor, all layers
    for n in seen:
        assert n.dtype == torch.int32 and n.tolist() == [want]
    for a, b in zip(outs[0][::2], outs[1][::2]):
        assert torch.equal(a, b)


def test_init_params_layout_and_seed():
    """Random init is on the requested device, in the JAX stacked layout,
    and a function of the generator's seed."""
    cfg = get_model_config("debug-tiny")
    a = TM.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    b = TM.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    assert a["layers"]["wq"].shape == (cfg.num_layers, cfg.hidden_size,
                                       cfg.num_heads * cfg.head_dim)
    assert a["lm_head"].shape == (cfg.hidden_size, cfg.vocab_size)
    assert all(torch.equal(a["layers"][k], b["layers"][k])
               for k in a["layers"])
    assert a["embed"].dtype == cfg.torch_dtype


@pytest.mark.parametrize("name,feature", [
    ("qwen3-4b", "qk_norm"), ("opt-125m", "norm_type"),
    ("mixtral-8x7b", "MoE"), ("qwen2.5-7b", "attention_bias")])
def test_unported_features_raise(name, feature):
    with pytest.raises(NotImplementedError, match=feature):
        TM.check_supported(get_model_config(name))


@pytest.fixture(scope="module")
def bf16_setup():
    jcfg = jax_model("debug-tiny").replace(dtype="bfloat16")
    tcfg = get_model_config("debug-tiny").replace(dtype="bfloat16")
    jp = JM.init_params(jcfg, jax.random.key(1))
    tp = TM.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


def test_compute_logits_bf16_matches_jax(bf16_setup):
    """bf16 serving: the same bf16 hidden state gives the JAX package's fp32
    logits. Both sum exact bf16 products in fp32, in different orders
    (~1e-7 relative); logits rounded to bf16 on the way would miss by
    ~2^-9 relative, so the bound is 1e-5 of the largest logit."""
    jcfg, tcfg, jp, tp = bf16_setup
    rng = np.random.default_rng(4)
    jh = jnp.asarray(rng.standard_normal((6, tcfg.hidden_size)), jnp.bfloat16)
    th = torch.from_numpy(np.asarray(jh, np.float32)).to(torch.bfloat16)
    jl = np.asarray(JM.compute_logits(jp, jcfg, jh, use_pallas=False))
    tl = TM.compute_logits(tp, tcfg, th)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0,
                               atol=1e-5 * np.abs(jl).max())


def test_forward_prefill_bf16_matches_jax(bf16_setup):
    """The whole bf16 prefill + logits against JAX. bf16 rounds at other
    places in the two frameworks (XLA rounds a fused elementwise chain
    once, eager PyTorch after every op): ~1 bf16 ulp (2^-8 relative) here
    and there, carried through two layers. Measured 0.9% of the largest
    logit; the bound is 2%, and the greedy tokens must agree."""
    jcfg, tcfg, jp, tp = bf16_setup
    lens, T = [10, 17, 8], 40
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, tcfg.vocab_size, T).astype(np.int32)
    seg = np.full(T, -1, np.int32)
    pos = np.zeros(T, np.int32)
    slots = np.zeros(T, np.int32)
    last, o, page = [], 0, 1
    for s, n in enumerate(lens):
        seg[o:o + n] = s
        pos[o:o + n] = np.arange(n)
        slots[o:o + n] = page * PS + np.arange(n)
        page += -(-n // PS)
        last.append(o + n - 1)
        o += n
    last = np.array(last, np.int32)
    shape = (tcfg.num_layers, P, PS, tcfg.num_kv_heads * tcfg.head_dim)
    jkv = JKV(k=jnp.zeros(shape, jnp.bfloat16), v=jnp.zeros(shape,
                                                            jnp.bfloat16))
    tkv = TKV(k=torch.zeros(shape, dtype=torch.bfloat16),
              v=torch.zeros(shape, dtype=torch.bfloat16))
    jn, _, _ = JM.forward_prefill(
        jp, jcfg, jnp.asarray(tokens),
        JM.PrefillMeta(*map(jnp.asarray, (seg, pos, slots, last))), jkv,
        use_pallas=False)
    tn, _, _ = TM.forward_prefill(
        tp, tcfg, _t(tokens), TM.PrefillMeta(*map(_t, (seg, pos, slots, last))),
        tkv)
    jl = np.asarray(JM.compute_logits(jp, jcfg, jn, use_pallas=False))
    tl = TM.compute_logits(tp, tcfg, tn).numpy()
    np.testing.assert_allclose(tl, jl, rtol=0, atol=2e-2 * np.abs(jl).max())
    assert (tl.argmax(-1) == jl.argmax(-1)).all()
