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

The same checks run on the other model families of the JAX presets, at
debug widths (``VARIANTS``): qwen2-like (q/k/v bias), qwen3-like (qk-norm,
tied embeddings, q width 192 != d 128), OPT-like (LayerNorm, learned
positions, a biased fc1/act/fc2 MLP with relu and with exact gelu, every
bias, tied embeddings, MHA) and ``debug-moe``. The JAX init sets biases to
zero and norm weights to one, where a missing term would go unseen, so
the shared weight set draws them at random (``variant_params``) and
``test_variant_every_term_moves_the_output`` proves each one counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_gpu_cluster_tpu.config import get_model_config as jax_model
from kubernetes_gpu_cluster_tpu.engine.kv_cache import KVCache as JKV
from kubernetes_gpu_cluster_tpu.models import llama as JM
from kubernetes_gpu_cluster_tpu_torch.config import (MODEL_PRESETS,
                                                     get_model_config)
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


# Model families of the JAX presets at debug widths: (preset, overrides).
_OPT = dict(num_kv_heads=4, norm_type="layernorm", pos_embedding="learned",
            mlp_type="mlp", linear_bias=True, attention_bias=True,
            tie_word_embeddings=True)
VARIANTS = {
    "qwen2": ("debug-tiny", dict(attention_bias=True)),
    "qwen3": ("debug-tiny", dict(qk_norm=True, tie_word_embeddings=True,
                                 num_heads=6)),
    "opt-relu": ("debug-tiny", dict(_OPT, mlp_act="relu")),
    "opt-gelu": ("debug-tiny", dict(_OPT, mlp_act="gelu")),
    "moe": ("debug-moe", {}),
}
# Weights the JAX init sets to zero (biases) or one (norms).
BIASES = ("bq", "bk", "bv", "bo", "b_up", "b_down", "input_norm_b",
          "post_attn_norm_b", "final_norm_b")
NORMS = ("input_norm", "post_attn_norm", "final_norm", "q_norm", "k_norm")


def variant_cfgs(name, **overrides):
    """(JAX config, port config) of a variant."""
    preset, kw = VARIANTS[name]
    kw = {**kw, **overrides}
    return (jax_model(preset).replace(**kw),
            get_model_config(preset).replace(**kw))


def variant_params(jcfg, seed):
    """The JAX init of ``jcfg`` as numpy, with every bias drawn from
    N(0, 0.2^2) and every norm weight from N(1, 0.2^2) (fp32 draws, cast
    to the model dtype by each package)."""
    np_params = jax.tree.map(np.asarray, JM.init_params(
        jcfg, jax.random.key(seed)))
    rng = np.random.default_rng(seed + 100)
    for store in (np_params["layers"], np_params):
        for name in BIASES + NORMS:
            if name in store:
                noise = 0.2 * rng.standard_normal(store[name].shape)
                store[name] = (noise + (name in NORMS)).astype(np.float32)
    return np_params


def both_packages(jcfg, tcfg, np_params):
    """The numpy weight set in each package, float weights in the model
    dtype (f32 scales and int8 codes as they are)."""
    def jax_leaf(path, a):
        if a.dtype == np.float32 and not path[-1].key.endswith("_scale"):
            return jnp.asarray(a, jcfg.jnp_dtype)
        return jnp.asarray(a)
    return (jax.tree_util.tree_map_with_path(jax_leaf, np_params),
            TM.params_from_numpy(np_params, tcfg, "cpu"))


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def variant(request):
    jcfg, tcfg = variant_cfgs(request.param)
    jp, tp = both_packages(jcfg, tcfg, variant_params(jcfg, 0))
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
    _prefill_matches(setup)


def _prefill_matches(setup):
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
    _decode_matches(setup)


def _decode_matches(setup):
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
    _hist_matches(setup, hist_len)


def _hist_matches(setup, hist_len):
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
    _mixed_matches(setup)


def _mixed_matches(setup):
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


@pytest.mark.parametrize("kind", ["prefill", "decode", "hist0", "hist19",
                                  "mixed"])
def test_variant_forward_matches_jax(variant, kind):
    """Every forward and compute_logits of each model family against JAX
    at fp32 atol 1e-4, with random biases and norm weights."""
    if kind.startswith("hist"):
        _hist_matches(variant, int(kind[4:]))
    else:
        {"prefill": _prefill_matches, "decode": _decode_matches,
         "mixed": _mixed_matches}[kind](variant)


def test_variant_every_term_moves_the_output(variant):
    """Setting any randomised bias or norm weight back to the JAX init's
    value (0 or 1) moves the port's decode logits by far more than the
    parity tolerance: the parity tests above see every term."""
    _, tcfg, _, tp, pool = variant
    B, tables, pos, ctx, slots = _decode_inputs()
    meta = TM.DecodeMeta(_t(pos), _t(slots), _t(tables), _t(ctx))
    tokens = _t(np.array([3, 77, 500, 0], np.int32))

    def logits(params):
        h, _, _ = TM.forward_decode(params, tcfg, tokens, meta,
                                    _pools(pool)[1])
        return TM.compute_logits(params, tcfg, h)[:3]

    base = logits(tp)
    moved = []
    for top in (False, True):
        store = tp if top else tp["layers"]
        for name in BIASES + NORMS:
            if name not in store:
                continue
            edited = {**tp, "layers": dict(tp["layers"])}
            (edited if top else edited["layers"])[name] = (
                torch.ones_like if name in NORMS else torch.zeros_like)(
                    store[name])
            moved.append((name, float((logits(edited) - base).abs().max())))
    assert len(moved) >= 3 and all(d > 100 * ATOL for _, d in moved), moved


@pytest.mark.parametrize("quantization", [None, "int8", "int4"])
def test_every_preset_is_served(quantization):
    """check_supported accepts every preset under every quantization; only
    an unknown method (or activation) is refused."""
    for name, cfg in MODEL_PRESETS.items():
        TM.check_supported(cfg.replace(quantization=quantization))
    cfg = get_model_config("debug-tiny")
    with pytest.raises(ValueError, match="quantization"):
        TM.check_supported(cfg.replace(quantization="fp8"))
    with pytest.raises(ValueError, match="activation"):
        TM.check_supported(cfg.replace(mlp_type="mlp", mlp_act="swish"))


@pytest.mark.parametrize("quantization", [None, "int8", "int4"])
def test_param_layouts_match_jax_init(quantization):
    """For every preset, the port's stored layout (names, shapes, kinds) is
    the JAX package's init's, so params_from_numpy carries any JAX weight
    set across (shapes only: ``jax.eval_shape`` allocates nothing)."""
    for name in MODEL_PRESETS:
        jcfg = jax_model(name).replace(quantization=quantization)
        want = jax.eval_shape(lambda: JM.init_params(jcfg,
                                                     jax.random.key(0)))

        def kinds(tree):
            return {k: (tuple(a.shape), "int8" if a.dtype == jnp.int8 else
                        "scale" if k.endswith("_scale") else "float")
                    for k, a in tree.items() if k != "layers"}

        layers, top = TM.param_layouts(get_model_config(name).replace(
            quantization=quantization))
        assert layers == kinds(want["layers"]), name
        assert top == kinds(want), name


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
    _prefill_bf16_matches(*bf16_setup)


@pytest.mark.parametrize("name", ["qwen3", "opt-relu"])
def test_variant_forward_prefill_bf16_matches_jax(name):
    """bf16 qk-norm (qwen3) and LayerNorm with learned positions and
    biases (OPT) through the whole prefill + tied logits, under the bound
    of the llama bf16 case above."""
    jcfg, tcfg = variant_cfgs(name, dtype="bfloat16")
    _prefill_bf16_matches(jcfg, tcfg, *both_packages(jcfg, tcfg,
                                             variant_params(jcfg, 1)))


def test_norms_bf16_bit_identical_to_jax():
    """LayerNorm and the per-head RMSNorm of qk-norm at bf16 round where
    JAX rounds (normalise in fp32, cast, then the affine in bf16): the
    same bits. ``F.layer_norm`` rounds once after an fp32 affine and gives
    other bits, so the port does not use it."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((64, 128)) * 3 + 0.5
    w = 1 + 0.2 * rng.standard_normal(128)
    b = 0.2 * rng.standard_normal(128)
    j = [jnp.asarray(a, jnp.bfloat16) for a in (x, w, b)]
    t = [torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
         for a in j]
    want = np.asarray(JM.layer_norm(*j, 1e-5), np.float32)
    got = TM.layer_norm(*t, 1e-5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    fused = torch.nn.functional.layer_norm(t[0], (128,), t[1], t[2], 1e-5)
    assert not np.array_equal(fused.float().numpy(), want)
    heads = (j[0].reshape(64, 4, 32), j[1][:32])
    want = np.asarray(JM.rms_norm(*heads, 1e-6), np.float32)
    got = TM.rms_norm(t[0].reshape(64, 4, 32), t[1][:32], 1e-6)
    np.testing.assert_array_equal(got.float().numpy(), want)


def _prefill_bf16_matches(jcfg, tcfg, jp, tp):
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
