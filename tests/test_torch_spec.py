"""The port's speculative decoding against the JAX package, on the CPU.

One JAX weight set per model is carried into the port (``both_packages``);
both packages then run the same inputs:

- verify attention (``spec_verify_attention_plain``) and the spec×mixed
  split (``spec_mixed_attention``) on random fp32 inputs: max-abs 1e-5
  (one fp32 softmax over at most a few hundred keys, summed in another
  order);
- ``forward_spec_verify`` / ``forward_spec_mixed`` on debug-tiny and every
  ``VARIANTS`` family: hidden states, logits and the written pool within
  1e-5 of the largest reference value (two fp32 layers drift ~1e-7
  relative; a wrong mask, slot or position moves them by O(1));
- ``spec_verify_sample`` on greedy rows: tokens and ``n_accepted`` equal,
  logprobs within 1e-6;
- the engine, greedy, on a staggered workload (spec steps, chunked
  prompts, spec×mixed steps): token-identical to the JAX engine with spec
  on and to the port with spec off, drafted/accepted totals equal to the
  JAX engine's.

Seeded sampling cannot match threefry bit for bit; its contract (the
emitted token is distributed as the target, a seeded row's outcome depends
on its seed and position only) is held by a chi-square test and by
grouping-independence tests. The reference's spec tests that need no HTTP
server run here against the port. Also here: out-of-range token ids and
positions gather as JAX's clamped gather does (the engine does not fault).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_gpu_cluster_tpu.config import CacheConfig as JCache
from kubernetes_gpu_cluster_tpu.config import EngineConfig as JEngineConfig
from kubernetes_gpu_cluster_tpu.config import SchedulerConfig as JSched
from kubernetes_gpu_cluster_tpu.config import get_model_config as jax_model
from kubernetes_gpu_cluster_tpu.engine import LLMEngine as JaxEngine
from kubernetes_gpu_cluster_tpu.engine import SamplingParams as JaxParams
from kubernetes_gpu_cluster_tpu.engine.kv_cache import KVCache as JKV
from kubernetes_gpu_cluster_tpu.models import llama as JM
from kubernetes_gpu_cluster_tpu.ops import attention as JA
from kubernetes_gpu_cluster_tpu.ops import sampling as JS
from kubernetes_gpu_cluster_tpu_torch.config import (CacheConfig,
                                                     EngineConfig,
                                                     ParallelConfig,
                                                     SchedulerConfig,
                                                     get_model_config)
from kubernetes_gpu_cluster_tpu_torch.engine import (LLMEngine,
                                                     SamplingParams,
                                                     Sequence)
from kubernetes_gpu_cluster_tpu_torch.engine.kv_cache import KVCache as TKV
from kubernetes_gpu_cluster_tpu_torch.engine.spec import (AdaptiveK,
                                                          DraftProposer,
                                                          NgramProposer)
from kubernetes_gpu_cluster_tpu_torch.engine.spec.draft_model import (
    DraftModelRunner, build_draft_runner)
from kubernetes_gpu_cluster_tpu_torch.models import llama as TM
from kubernetes_gpu_cluster_tpu_torch.ops import attention as TA
from kubernetes_gpu_cluster_tpu_torch.ops import sampling as TS
from test_torch_model import (VARIANTS, both_packages, variant_cfgs,
                              variant_params)

torch.set_num_threads(2)

# The JAX references, jitted: one compile per shape instead of one per
# primitive.
_J_VERIFY = jax.jit(JA.spec_verify_attention_xla,
                    static_argnames=("scale", "layer"))
_J_MIXED = jax.jit(JA.spec_mixed_attention, static_argnames=(
    "scale", "n_prefill", "layer", "use_pallas", "use_pallas_hist"))
_J_FWD_VERIFY = jax.jit(JM.forward_spec_verify, static_argnums=(1,),
                        static_argnames=("use_pallas",))
_J_FWD_MIXED = jax.jit(JM.forward_spec_mixed, static_argnums=(1, 5),
                       static_argnames=("use_pallas", "use_pallas_hist"))
_J_SAMPLE = jax.jit(JS.spec_verify_sample)

ATTN_ATOL = 1e-5
REL = 1e-5
PS = 8
REPETITIVE = [7, 3, 9, 11] * 8          # n-gram matches everywhere
PLAIN = [5, 99, 23, 44, 17, 301, 12]    # no lookup structure


def _t(a):
    return torch.from_numpy(np.array(a))          # a writable copy


def _close(got, want, rel=REL):
    """Max-abs difference within ``rel`` of the reference's largest value."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bound = rel * max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= bound, (err, bound)


# ---------------------------------------------------------------------------
# C1: out-of-range ids gather as JAX's clamped gather does
# ---------------------------------------------------------------------------

def test_rows_wrap_negative_once_then_clamp():
    table = torch.arange(10.0)[:, None]
    idx = torch.tensor([-1, -10, -11, -25, 0, 9, 10, 1000])
    got = TM._rows(table, idx)[:, 0]
    want = np.asarray(jnp.arange(10.0)[:, None][jnp.asarray(idx.numpy())])
    assert got.tolist() == want[:, 0].tolist() == [9, 0, 0, 0, 0, 9, 9, 9]


def _c1_case(name):
    """(JAX config, port config, numpy params, EngineConfig kwargs, prompts,
    max_tokens) of the two C1 cases."""
    if name == "debug-tiny":
        jcfg, tcfg = jax_model("debug-tiny"), get_model_config("debug-tiny")
        V = jcfg.vocab_size
        np_params = jax.tree.map(np.asarray, JM.init_params(
            jcfg, jax.random.key(3)))
        return (jcfg, tcfg, np_params, {},
                [[5, V + 10, 17, -1, 40], [V + 10], [-1, 3]], 5)
    jcfg, tcfg = variant_cfgs("opt-relu", max_model_len=32)
    return (jcfg, tcfg, variant_params(jcfg, 4), dict(max_model_len=64),
            [[int(t) for t in np.arange(3, 23)]], 30)


@pytest.mark.parametrize("name", ["debug-tiny", "opt"])
def test_out_of_range_ids_and_positions_match_jax_engine(name):
    """Token ids outside the vocabulary (V+10, -1) and OPT positions past
    its learned table (model length 32 served at 64): the port's greedy
    output equals the JAX engine's, where torch's indexing used to raise
    (on the card: a device-side assert ending the CUDA context)."""
    jcfg, tcfg, np_params, ekw, prompts, n = _c1_case(name)
    jp, tp = both_packages(jcfg, tcfg, np_params)
    sched = dict(max_num_seqs=4, max_prefill_tokens=32, decode_buckets=(4,),
                 prefill_buckets=(32,), decode_window=4,
                 mixed_batch_enabled=False)
    jeng = JaxEngine(JEngineConfig(model=jcfg, cache=JCache(page_size=8,
                                                            num_pages=48),
                                   scheduler=JSched(**sched), **ekw),
                     params=jp)
    want = [o.output_token_ids for o in jeng.generate(
        prompts, JaxParams(max_tokens=n, temperature=0.0))]
    eng = LLMEngine(EngineConfig(model=tcfg, cache=CacheConfig(page_size=8,
                                                               num_pages=48),
                                 scheduler=SchedulerConfig(**sched), **ekw),
                    params=tp, device="cpu")
    got = [o.output_token_ids for o in eng.generate(
        prompts, SamplingParams(max_tokens=n, temperature=0.0))]
    assert got == want
    assert all(len(t) == n for t in got)


# ---------------------------------------------------------------------------
# Verify attention
# ---------------------------------------------------------------------------

# name -> (nh, n_kv, hd, stacked pool layers (0: one layer), context_lens
# per row (0: padding row), S)
VERIFY_CASES = {
    "gqa": (8, 2, 16, 0, [9, 30, 17], 3),
    "mha_one_layer": (4, 4, 8, 0, [5, 12], 5),
    "stacked_layer": (6, 2, 16, 3, [25, 2, 40, 11], 2),
    "context_1_and_padding": (8, 4, 16, 2, [1, 14, 0, 0], 4),
}


def _verify_inputs(case, seed=0):
    nh, n_kv, hd, L, ctx, S = VERIFY_CASES[case]
    rng = np.random.default_rng(seed)
    B = len(ctx)
    pps = -(-(max(ctx) + S) // PS)
    P = B * pps + 1
    tables = (rng.permutation(P - 1)[:B * pps] + 1).reshape(B, pps)
    tables[np.array(ctx) == 0] = 0
    pool_shape = ((L,) if L else ()) + (P, PS, n_kv * hd)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(q=f(B * S, nh, hd), k=f(B * S, n_kv, hd),
                v=f(B * S, n_kv, hd), k_pool=f(*pool_shape),
                v_pool=f(*pool_shape), page_tables=tables.astype(np.int32),
                context_lens=np.array(ctx, np.int32), scale=hd ** -0.5,
                layer=L - 1 if L else None)


def _jax_verify(a):
    j = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
         for k, v in a.items()}
    return np.asarray(_J_VERIFY(**j))


@pytest.mark.parametrize("case", sorted(VERIFY_CASES))
def test_spec_verify_attention_matches_jax(case):
    a = _verify_inputs(case)
    want = _jax_verify(a)
    got = TA.spec_verify_attention_plain(
        **{k: (_t(v) if isinstance(v, np.ndarray) else v)
           for k, v in a.items()})
    np.testing.assert_allclose(got.numpy(), want, atol=ATTN_ATOL, rtol=0)


@pytest.mark.parametrize("case", sorted(VERIFY_CASES))
def test_spec_verify_dispatcher_row_groups_and_table_cut(case, monkeypatch):
    """The CPU dispatcher's row groups (a gather budget of one row) over
    the whole table give the plain version's result: no caller cuts the
    table any more (a captured verify program takes it whole; the kernel
    reads each row's context on the device)."""
    a = {k: (_t(v) if isinstance(v, np.ndarray) else v)
         for k, v in _verify_inputs(case, seed=1).items()}
    want = TA.spec_verify_attention_plain(**a)
    layer = a.pop("layer")
    monkeypatch.setattr(TA, "VERIFY_GATHER_BYTES", 1)
    assert not hasattr(TA, "verify_table_width")
    got = TA.spec_verify_attention(**a, layer=layer)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)


def test_spec_mixed_attention_matches_jax():
    """A 16-slot chunk (11 real tokens over a 13-token history) and three
    verify rows (one padding) of S 3, GQA, stacked pool."""
    rng = np.random.default_rng(2)
    nh, n_kv, hd, L, P = 8, 2, 16, 2, 24
    Tp, n_real, hist = 16, 11, 13
    ctx, S = [9, 20, 0], 3
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    T = Tp + len(ctx) * S
    seg = np.full(T, -1, np.int32)
    seg[:n_real] = 0
    seg[Tp:Tp + 2 * S] = np.repeat([0, 1], S)          # verify row ids
    pos = np.zeros(T, np.int32)
    pos[:n_real] = hist + np.arange(n_real)
    chunk_table = np.array([[1, 2, 3, 4, 0, 0, 0, 0]], np.int32)
    tables = np.array([[5, 6, 0], [7, 8, 9], [0, 0, 0]], np.int32)
    args = dict(q=f(T, nh, hd), k=f(T, n_kv, hd), v=f(T, n_kv, hd),
                seg_ids=seg, positions=pos, k_pool=f(L, P, PS, n_kv * hd),
                v_pool=f(L, P, PS, n_kv * hd), chunk_page_table=chunk_table,
                hist_len=hist, page_tables=tables,
                context_lens=np.array(ctx, np.int32), scale=hd ** -0.5)
    want = _J_MIXED(
        **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in args.items()}, n_prefill=Tp, layer=1,
        use_pallas=False, use_pallas_hist=False)
    got = TA.spec_mixed_attention(
        **{k: (_t(v) if isinstance(v, np.ndarray) else v)
           for k, v in args.items()}, n_prefill=Tp, layer=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATTN_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# Forwards
# ---------------------------------------------------------------------------

P_POOL = 24


def _family(name):
    if name == "debug-tiny":
        jcfg, tcfg = jax_model("debug-tiny"), get_model_config("debug-tiny")
        return jcfg, tcfg, both_packages(jcfg, tcfg, jax.tree.map(
            np.asarray, JM.init_params(jcfg, jax.random.key(0))))
    jcfg, tcfg = variant_cfgs(name)
    return jcfg, tcfg, both_packages(jcfg, tcfg, variant_params(jcfg, 0))


def _verify_slices(rng, ctx, S, base, tokens, seg, pos, slots, tables, V):
    """Rows of ``ctx`` committed tokens (0: padding), each on its own pages
    from page 1 up, laid out from token ``base`` as the verifier does."""
    page = 1
    for r, c in enumerate(ctx):
        o = base + r * S
        if c == 0:
            slots[o:o + S] = np.arange(o, o + S) % PS     # scrap page
            continue
        n_pages = -(-(c - 1 + S) // PS)
        pages = list(range(page, page + n_pages))
        page += n_pages
        tables[r, :n_pages] = pages
        tokens[o:o + S] = rng.integers(0, V, S)
        seg[o:o + S] = r
        p = c - 1 + np.arange(S)
        pos[o:o + S] = p
        slots[o:o + S] = [pages[x // PS] * PS + x % PS for x in p]
    return page


def _pools(tcfg, rng):
    kd = tcfg.num_kv_heads * tcfg.head_dim
    pool = [rng.standard_normal((tcfg.num_layers, P_POOL, PS, kd)).astype(
        np.float32) for _ in range(2)]
    return (JKV(k=jnp.asarray(pool[0]), v=jnp.asarray(pool[1])),
            TKV(k=_t(pool[0]), v=_t(pool[1])))


def _check_forward(jout, tout, jcfg, tcfg, jp, tp):
    (jn, jkv, jh), (tn, tkv, th) = jout, tout
    jk, jv = np.array(jkv.k), np.array(jkv.v)
    jk[:, 0] = jv[:, 0] = 0                  # padding slots: the scrap page
    tkv.k[:, 0] = tkv.v[:, 0] = 0
    for got, want in ((th, jh), (tn, jn), (tkv.k, jk), (tkv.v, jv)):
        _close(got.numpy(), np.asarray(want))
    _close(TM.compute_logits(tp, tcfg, tn).numpy(),
           np.asarray(JM.compute_logits(jp, jcfg, jn, use_pallas=False)))


FAMILIES = ["debug-tiny"] + sorted(VARIANTS)


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_spec_verify_matches_jax(name):
    jcfg, tcfg, (jp, tp) = _family(name)
    rng = np.random.default_rng(3)
    ctx, S = [1, 13, 22, 0], 3
    T = len(ctx) * S
    tokens, seg = np.zeros(T, np.int32), np.full(T, -1, np.int32)
    pos, slots = np.zeros(T, np.int32), np.zeros(T, np.int32)
    tables = np.zeros((len(ctx), 4), np.int32)
    _verify_slices(rng, ctx, S, 0, tokens, seg, pos, slots, tables,
                   tcfg.vocab_size)
    ctx = np.array(ctx, np.int32)
    jkv, tkv = _pools(tcfg, rng)
    jout = _J_FWD_VERIFY(
        jp, jcfg, jnp.asarray(tokens),
        JM.SpecMeta(*map(jnp.asarray, (seg, pos, slots, tables, ctx))), jkv,
        use_pallas=False)
    tout = TM.forward_spec_verify(
        tp, tcfg, _t(tokens), TM.SpecMeta(*map(_t, (seg, pos, slots, tables,
                                                    ctx))), tkv)
    assert tout[0].shape[0] == T
    _check_forward(jout, tout, jcfg, tcfg, jp, tp)


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_spec_mixed_matches_jax(name):
    """A 16-slot chunk (12 real tokens over a 9-token history) and two
    verify rows plus a padding row of S 3."""
    jcfg, tcfg, (jp, tp) = _family(name)
    rng = np.random.default_rng(4)
    Tp, n_real, hist, ctx, S = 16, 12, 9, [6, 19, 0], 3
    T = Tp + len(ctx) * S
    tokens, seg = np.zeros(T, np.int32), np.full(T, -1, np.int32)
    pos, slots = np.zeros(T, np.int32), np.zeros(T, np.int32)
    tables = np.zeros((len(ctx), 4), np.int32)
    page = _verify_slices(rng, ctx, S, Tp, tokens, seg, pos, slots, tables,
                          tcfg.vocab_size)
    chunk_pages = list(range(page, page + -(-(hist + n_real) // PS)))
    tokens[:n_real] = rng.integers(0, tcfg.vocab_size, n_real)
    seg[:n_real] = 0
    p = hist + np.arange(n_real)
    pos[:n_real] = p
    slots[:n_real] = [chunk_pages[x // PS] * PS + x % PS for x in p]
    slots[n_real:Tp] = np.arange(n_real, Tp) % PS
    chunk_table = np.zeros((1, 4), np.int32)
    chunk_table[0, :len(chunk_pages)] = chunk_pages
    logits_idx = np.append(Tp + np.arange(len(ctx) * S), n_real - 1).astype(
        np.int32)
    ctx = np.array(ctx, np.int32)
    arrays = (seg, pos, slots, logits_idx, chunk_table)
    jkv, tkv = _pools(tcfg, rng)
    jout = _J_FWD_MIXED(
        jp, jcfg, jnp.asarray(tokens),
        JM.MixedMeta(*map(jnp.asarray, arrays), jnp.int32(hist),
                     jnp.asarray(tables), jnp.asarray(ctx)), jkv, S,
        use_pallas=False, use_pallas_hist=False)
    tout = TM.forward_spec_mixed(
        tp, tcfg, _t(tokens),
        TM.MixedMeta(*map(_t, arrays), hist, _t(tables), _t(ctx)), tkv, S)
    assert tout[0].shape[0] == len(ctx) * S + 1
    _check_forward(jout, tout, jcfg, tcfg, jp, tp)


# ---------------------------------------------------------------------------
# Acceptance sampling
# ---------------------------------------------------------------------------

def _sample_args(B, V, temperature=0.0, seed=-1, counts=None):
    f = np.full
    return dict(seed=f(B, seed, np.int32),
                temperature=f(B, temperature, np.float32),
                top_k=np.zeros(B, np.int32), top_p=np.ones(B, np.float32),
                presence=np.zeros(B, np.float32),
                frequency=np.zeros(B, np.float32),
                counts=(np.zeros((B, V), np.int32) if counts is None
                        else counts))


def _port_sample(logits, drafts, pos0, step_key=0, *, with_top=False, **kw):
    a = {k: _t(v) for k, v in _sample_args(*logits.shape[::2], **kw).items()}
    any_pen = bool((a["presence"] != 0).any() or (a["frequency"] != 0).any())
    return TS.spec_verify_sample(
        _t(logits), _t(drafts), _t(pos0), step_key, a["seed"],
        a["temperature"], a["top_k"], a["top_p"], a["presence"],
        a["frequency"], a["counts"] if any_pen else None,
        any_sampled=bool((a["temperature"] > 0).any()), needs_filter=False,
        any_pen=any_pen, with_top=with_top)


def _planted(rng, B, S, V):
    """Logits and drafts: row 0 all right, row 1 first wrong, row 2 second
    wrong, row 3 all wrong, row 4 one draft outside the vocabulary."""
    logits = rng.standard_normal((B, S, V)).astype(np.float32)
    am = logits.argmax(-1)
    drafts = am[:, :-1].copy()
    drafts[1, 0] = (am[1, 0] + 1) % V
    drafts[2, 1] = (am[2, 1] + 1) % V
    drafts[3] = (am[3, :-1] + 1) % V
    drafts[4, 0] = V + 3
    return logits, drafts.astype(np.int32), am


def test_greedy_spec_verify_sample_matches_jax():
    rng = np.random.default_rng(1)
    B, S, V = 5, 4, 32
    logits, drafts, am = _planted(rng, B, S, V)
    pos0 = np.arange(B, dtype=np.int32) * 7
    j = {k: jnp.asarray(v) for k, v in _sample_args(B, V).items()}
    want = _J_SAMPLE(
        jnp.asarray(logits), jnp.asarray(drafts), jnp.asarray(pos0),
        jax.random.key(0), j["seed"], j["temperature"], j["top_k"],
        j["top_p"], j["presence"], j["frequency"], j["counts"],
        with_top=jnp.asarray(True))
    got = _port_sample(logits, drafts, pos0, with_top=True)
    n_acc = got[1].numpy()
    assert n_acc.tolist() == np.asarray(want[1]).tolist() == [3, 0, 1, 0, 0]
    for r in range(B):       # columns past the first rejection are garbage
        used = n_acc[r] + 1
        assert got[0][r, :used].tolist() == np.asarray(
            want[0])[r, :used].tolist() == am[r, :used].tolist()
        np.testing.assert_allclose(got[2][r, :used].numpy(),
                                   np.asarray(want[2])[r, :used], atol=1e-6)
        assert got[3][r, :used].tolist() == np.asarray(
            want[3])[r, :used].tolist()
        np.testing.assert_allclose(got[4][r, :used].numpy(),
                                   np.asarray(want[4])[r, :used], atol=1e-6)


def test_sample_tokens_is_the_sampled_ids():
    """``sample_tokens`` (the JAX package's export) returns
    ``sample_and_logprobs``' ids; greedy rows take the argmax."""
    rng = np.random.default_rng(6)
    logits = _t(rng.standard_normal((4, 50)).astype(np.float32))
    keys = TS.row_sample_keys(3, torch.tensor([1, -1, 5, -1]),
                              torch.arange(4))
    args = (logits, keys, torch.tensor([0.0, 0.7, 1.0, 0.0]),
            torch.tensor([0, 5, 0, 0]), torch.tensor([1.0, 1.0, 0.9, 1.0]))
    got = TS.sample_tokens(*args, any_sampled=True, needs_filter=True)
    want = TS.sample_and_logprobs(*args, any_sampled=True,
                                  needs_filter=True)[0]
    assert torch.equal(got, want)
    assert got[0] == logits[0].argmax() and got[3] == logits[3].argmax()


def test_rejection_sampling_chi_square():
    """The first emitted token of a verify step is distributed exactly as
    the target softmax whatever the draft: 12000 independent draws on a
    16-token vocabulary, chi-square against the analytic target (df 15; 60
    is ~8 sigma above its mean), and the acceptance rate within 4 sigma of
    p(draft)."""
    rng = np.random.default_rng(0)
    B, S, V = 12000, 2, 16
    row = (rng.standard_normal(V) * 1.5).astype(np.float32)
    target = np.exp(row - row.max())
    target /= target.sum()
    draft_tok = int(np.argsort(target)[-2])         # second most likely
    logits = np.broadcast_to(row, (B, S, V)).copy()
    drafts = np.full((B, S - 1), draft_tok, np.int32)
    tokens, n_acc, *_ = _port_sample(logits, drafts, np.zeros(B, np.int32),
                                     step_key=123, temperature=1.0)
    counts = np.bincount(tokens[:, 0].numpy(), minlength=V).astype(float)
    expected = target * B
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 60.0, (chi2, counts, expected)
    p_d = float(target[draft_tok])
    acc = float(n_acc.float().mean())
    assert abs(acc - p_d) < 4 * (p_d * (1 - p_d) / B) ** 0.5, (acc, p_d)


def test_seeded_verify_outcome_depends_on_seed_and_position_only():
    """A seeded sampled row gives the same tokens and acceptance alone, in
    a batch of other rows, under another step key and at another row index;
    another seed gives another stream."""
    rng = np.random.default_rng(5)
    S, V = 5, 64
    logits = rng.standard_normal((4, S, V)).astype(np.float32) * 2
    logits[2] = logits[0]
    drafts = logits[:, :-1].argmax(-1).astype(np.int32)
    drafts[:, 2] = (drafts[:, 2] + 1) % V
    pos0 = np.array([40, 11, 40, 40], np.int32)
    seeds = np.array([9, 2, 9, 10], np.int32)

    def run(rows, step_key):
        a = {k: _t(v) for k, v in _sample_args(len(rows), V, 0.9).items()}
        return TS.spec_verify_sample(
            _t(logits[rows]), _t(drafts[rows]), _t(pos0[rows]), step_key,
            _t(seeds[rows]), a["temperature"], a["top_k"], a["top_p"],
            a["presence"], a["frequency"], None, any_sampled=True,
            needs_filter=False, any_pen=False)

    alone = run([0], 1)
    batch = run([1, 0, 3], 77)
    assert torch.equal(alone[0][0], batch[0][1])
    assert int(alone[1][0]) == int(batch[1][1])
    third = run([2], 5)            # row 2: row 0's seed, position, logits
    assert torch.equal(third[0][0], alone[0][0])
    draws = set()
    for seed in range(20, 28):
        seeds[0] = seed
        draws.add(tuple(run([0], 1)[0][0].tolist()))
    assert len(draws) >= 2


# ---------------------------------------------------------------------------
# The engine against the JAX engine
# ---------------------------------------------------------------------------

SCHED = dict(max_num_seqs=4, max_prefill_tokens=32, decode_buckets=(4,),
             prefill_buckets=(32,), decode_window=4,
             num_speculative_tokens=4)
# (arrival step, request id, prompt): draftable and plain sessions, then a
# chunked prompt and two short ones while the first ones decode.
ARRIVALS = [(0, "a", REPETITIVE), (0, "p", PLAIN), (3, "b", REPETITIVE * 3),
            (3, "c", [2, 4] * 6), (6, "d", REPETITIVE)]
# name -> (model ("int4": debug-tiny int4 gs 32), SchedulerConfig
# overrides, draft weights ("target": the target's, a seed: JAX's init of
# debug-tiny from it, None: no draft model)).
SPEC_CASES = {
    "ngram": ("debug-tiny", dict(mixed_batch_enabled=False), None),
    "ngram_mixed_adaptive": ("debug-tiny", dict(mixed_batch_enabled=True,
                                                spec_adaptive_k=True), None),
    "oracle_draft": ("debug-tiny", dict(mixed_batch_enabled=False,
                                        spec_draft_model="debug-tiny"),
                     "target"),
    "mismatched_draft": ("debug-tiny", dict(mixed_batch_enabled=False,
                                            spec_draft_model="debug-tiny"),
                         123),
    "int4": ("int4", dict(mixed_batch_enabled=False), None),
}


def _drive(engine, max_tokens=16):
    """Serve ARRIVALS greedily (arrivals by step index, so every engine sees
    the same batches): (tokens by request, step kinds, (drafted,
    accepted))."""
    pending = sorted(ARRIVALS, key=lambda r: r[0])
    params_cls = JaxParams if isinstance(engine, JaxEngine) else \
        SamplingParams
    sp = params_cls(max_tokens=max_tokens, temperature=0.0)
    outs, step = {}, 0
    while pending or engine.has_unfinished_requests():
        while pending and pending[0][0] <= step:
            _, rid, prompt = pending.pop(0)
            engine.add_request(rid, list(prompt), sp)
        for o in engine.step():
            if o.finished:
                outs[o.request_id] = o.output_token_ids
        step += 1
    obs = engine.obs
    return (outs, dict(obs.step_kind_counts),
            (obs.spec_drafted_tokens, obs.spec_accepted_tokens))


def _case_weights(model, draft):
    """(JAX config, port config, (jax, port) params, (jax, port) draft
    params or (None, None))."""
    jcfg, tcfg = jax_model("debug-tiny"), get_model_config("debug-tiny")
    if model == "int4":
        kw = dict(quantization="int4", quant_group_size=32)
        jcfg, tcfg = jcfg.replace(**kw), tcfg.replace(**kw)
    weights = both_packages(jcfg, tcfg, jax.tree.map(
        np.asarray, JM.init_params(jcfg, jax.random.key(7))))
    if draft is None:
        return jcfg, tcfg, weights, (None, None)
    if draft == "target":
        return jcfg, tcfg, weights, weights
    dcfg = jax_model("debug-tiny")
    return jcfg, tcfg, weights, both_packages(
        dcfg, get_model_config("debug-tiny"), jax.tree.map(
            np.asarray, JM.init_params(dcfg, jax.random.key(draft))))


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_spec_engine_matches_jax_engine(case):
    model, sched, draft = SPEC_CASES[case]
    jcfg, tcfg, (jp, tp), (jd, td) = _case_weights(model, draft)
    cache = dict(page_size=8, num_pages=96)
    sc = dict(SCHED, spec_decode_enabled=True, **sched)
    jeng = JaxEngine(JEngineConfig(model=jcfg, cache=JCache(**cache),
                                   scheduler=JSched(**sc)), params=jp,
                     draft_params=jd)
    want, jkinds, jspec = _drive(jeng)
    eng = LLMEngine(EngineConfig(model=tcfg, cache=CacheConfig(**cache),
                                 scheduler=SchedulerConfig(**sc)),
                    params=tp, device="cpu", draft_params=td)
    got, kinds, spec = _drive(eng)
    assert got == want
    assert kinds == jkinds and spec == jspec
    assert kinds["spec"] > 0 and spec[0] > 0
    if sched["mixed_batch_enabled"]:
        assert kinds["spec_mixed"] > 0
    if draft == "target":
        assert spec[1] / spec[0] > 0.9
    off = LLMEngine(EngineConfig(model=tcfg, cache=CacheConfig(**cache),
                                 scheduler=SchedulerConfig(**{
                                     **sc, "spec_decode_enabled": False,
                                     "spec_draft_model": None})),
                    params=tp, device="cpu")
    assert _drive(off)[0] == got
    alloc = eng.scheduler.allocator
    assert alloc.num_free == alloc.num_pages - 1


# ---------------------------------------------------------------------------
# The reference's spec tests, against the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def params():
    """The reference tests' weights: JAX's init of debug-tiny from key 7."""
    return TM.params_from_numpy(jax.tree.map(np.asarray, JM.init_params(
        jax_model("debug-tiny"), jax.random.key(7))),
        get_model_config("debug-tiny"), "cpu")


def _cfg(spec, k=4, num_pages=128, mixed=False, max_prefill=256, draft=None,
         adaptive=False, decode_window=8):
    return EngineConfig(
        model=get_model_config("debug-tiny"),
        cache=CacheConfig(page_size=8, num_pages=num_pages),
        scheduler=SchedulerConfig(
            max_num_seqs=4, max_prefill_tokens=max_prefill,
            decode_buckets=(1, 2, 4), prefill_buckets=(32, 64, 128, 256),
            decode_window=decode_window, mixed_batch_enabled=mixed,
            spec_decode_enabled=spec, num_speculative_tokens=k,
            spec_draft_model=draft, spec_adaptive_k=adaptive))


def make_engine(params, spec, draft_params=None, **kw):
    return LLMEngine(_cfg(spec, **kw), params=params, device="cpu",
                     draft_params=draft_params)


class _GarbageProposer(DraftProposer):
    """Always drafts the same (almost surely wrong) token."""

    def __init__(self, k, token=1):
        super().__init__(k)
        self.token = token

    def propose(self, token_ids):
        return [self.token] * self.k


def _greedy(n):
    return SamplingParams(max_tokens=n, temperature=0.0)


class TestNgramProposer:
    def test_matches_most_recent_continuation(self):
        p = NgramProposer(k=3, ngram_max=2, ngram_min=1)
        assert p.propose([1, 2, 7, 8, 9, 5, 1, 2]) == [7, 8, 9]

    def test_prefers_longer_ngram(self):
        p = NgramProposer(k=2, ngram_max=3, ngram_min=1)
        assert p.propose([1, 2, 3, 10, 11, 3, 99, 1, 2, 3]) == [10, 11]

    def test_most_recent_occurrence_wins(self):
        p = NgramProposer(k=1, ngram_max=1, ngram_min=1)
        assert p.propose([5, 1, 5, 2, 5, 3, 5]) == [3]

    def test_no_match_returns_empty(self):
        p = NgramProposer(k=4)
        assert p.propose([1, 2, 3, 4, 5]) == []
        assert p.propose([1]) == []

    def test_continuation_may_cover_the_suffix_again(self):
        p = NgramProposer(k=8, ngram_max=1, ngram_min=1)
        assert p.propose([4, 9, 4]) == [9, 4]

    def test_validation(self):
        with pytest.raises(ValueError):
            NgramProposer(k=0)
        with pytest.raises(ValueError):
            NgramProposer(k=2, ngram_max=1, ngram_min=2)


class TestGreedyByteIdentity:
    def test_all_rejected_drafts_identical(self, params):
        prompts = [list(REPETITIVE), list(PLAIN)]
        ref = [o.output_token_ids
               for o in make_engine(params, False).generate(prompts,
                                                            _greedy(16))]
        eng = make_engine(params, True)
        eng.scheduler.spec_proposer = _GarbageProposer(4, token=1)
        got = [o.output_token_ids for o in eng.generate(prompts,
                                                        _greedy(16))]
        assert got == ref
        assert eng.obs.step_kind_counts["spec"] > 0
        assert eng.obs.spec_accepted_tokens <= eng.obs.spec_drafted_tokens / 4

    @pytest.mark.parametrize("draft", [False, True])
    def test_eos_mid_spec_window_stops_exactly(self, params, draft):
        """A stop token inside the emitted window truncates it exactly as
        the decode path does. With the oracle draft model every step after
        the prefill is a spec step emitting up to k+1 tokens, and the stop
        token is the first new token at output index 2 or later."""
        probe = make_engine(params, False).generate([list(REPETITIVE)],
                                                    _greedy(8))[0]
        ids = probe.output_token_ids
        eos = (next(ids[i] for i in range(2, 8) if ids[i] not in ids[:i])
               if draft else ids[4])
        ref_eng = make_engine(params, False)
        ref_eng.eos_token_id = eos
        ref = ref_eng.generate([list(REPETITIVE)], _greedy(24))[0]
        eng = make_engine(params, True, draft="debug-tiny" if draft else None,
                          draft_params=params if draft else None)
        eng.eos_token_id = eos
        out = eng.generate([list(REPETITIVE)], _greedy(24))[0]
        assert out.output_token_ids == ref.output_token_ids
        assert out.finish_reason == ref.finish_reason == "stop"
        if draft:
            assert eng.obs.step_kind_counts["spec"] > 0


class TestRollback:
    def test_state_rewinds_and_slots_reused(self, params):
        eng = make_engine(params, True, k=3)
        eng.scheduler.spec_proposer = _GarbageProposer(3, token=2)
        eng.add_request("r", list(REPETITIVE), _greedy(20))
        seq = eng.scheduler.waiting[0]
        while eng.has_unfinished_requests():
            eng.step()
        assert eng.obs.step_kind_counts["spec"] > 0
        ref = make_engine(params, False).generate([list(REPETITIVE)],
                                                  _greedy(20))[0]
        assert seq.output_token_ids == ref.output_token_ids
        alloc = eng.scheduler.allocator
        assert alloc.num_free == alloc.num_pages - 1

    def test_verify_kv_append_matches_oracle_pool(self, params):
        """A teacher-forced prefill of prompt + spec output predicts the
        same next token as a plain engine continuing it: the verify steps'
        multi-token append put the right vectors in the right slots. The
        oracle draft model makes every step after the prefill a spec step
        with accepted drafts."""
        eng = make_engine(params, True, draft="debug-tiny",
                          draft_params=params)
        out = eng.generate([list(REPETITIVE)], _greedy(12))[0]
        assert eng.obs.spec_accepted_tokens > 0
        ids = list(REPETITIVE) + out.output_token_ids
        cfg = get_model_config("debug-tiny")
        n = len(ids)
        kv = TKV(*(torch.zeros(cfg.num_layers, -(-n // 8) + 1, 8,
                               cfg.num_kv_heads * cfg.head_dim)
                   for _ in range(2)))
        meta = TM.PrefillMeta(torch.zeros(n, dtype=torch.int32),
                              torch.arange(n, dtype=torch.int32),
                              torch.arange(n, dtype=torch.int32) + 8,
                              torch.tensor([n - 1], dtype=torch.int32))
        h, _, _ = TM.forward_prefill(params, cfg, torch.tensor(ids), meta, kv)
        want = int(TM.compute_logits(params, cfg, h).argmax())
        cont = make_engine(params, False).generate([ids], _greedy(1))[0]
        assert cont.output_token_ids[0] == want


class TestSampledEngineRuns:
    def test_seeded_sampled_reproducible_with_spec(self, params):
        sp = SamplingParams(max_tokens=12, temperature=0.9, seed=5)
        a = make_engine(params, True).generate([list(REPETITIVE)], sp)[0]
        b = make_engine(params, True).generate([list(REPETITIVE)], sp)[0]
        assert a.output_token_ids == b.output_token_ids

    def test_sampled_with_penalties_filters_and_top_logprobs(self, params):
        sp = SamplingParams(max_tokens=12, temperature=0.8, seed=3,
                            top_k=20, top_p=0.9, frequency_penalty=1.0,
                            presence_penalty=0.5, logprobs=True,
                            top_logprobs=2)
        eng = make_engine(params, True, draft="debug-tiny",
                          draft_params=params)
        out = eng.generate([list(REPETITIVE)], sp)[0]
        assert len(out.output_token_ids) == 12
        assert eng.obs.step_kind_counts["spec"] > 0
        assert len(out.output_logprobs) == 12
        assert all(2 <= len(t) <= 3 for t in out.output_top_logprobs)

    def test_forced_logit_bias_through_spec(self, params):
        sp = SamplingParams(max_tokens=6, temperature=0.0,
                            logit_bias={7: 100.0})
        out = make_engine(params, True).generate([list(REPETITIVE)], sp)[0]
        assert out.output_token_ids == [7] * 6


class TestObservability:
    def test_spec_metrics_and_trace(self, params):
        eng = make_engine(params, True)
        eng.generate([list(REPETITIVE)], _greedy(24))
        assert eng.obs.step_kind_counts["spec"] > 0
        text = "\n".join(eng.obs.render_prometheus())
        for name in ("kgct_spec_drafted_tokens_total",
                     "kgct_spec_accepted_tokens_total",
                     "kgct_spec_acceptance_ratio"):
            assert name in text
        ratio = eng.obs.spec_acceptance_ratio()
        assert ratio is not None and 0.0 < ratio <= 1.0
        ev = next(e for e in eng.obs.tracer.events() if e.kind == "spec")
        assert ev.args["drafted"] > 0 and "accepted" in ev.args

    def test_fresh_engine_renders_no_ratio(self, params):
        text = "\n".join(make_engine(params, True).obs.render_prometheus())
        assert "kgct_spec_drafted_tokens_total 0" in text
        assert "kgct_spec_acceptance_ratio " not in text


class TestInterop:
    def test_spec_with_mixed_batching_prefills_never_drafted(self, params):
        prompts = [REPETITIVE * 3, list(REPETITIVE)]
        ref = [o.output_token_ids for o in make_engine(
            params, False, k=3, mixed=True, max_prefill=32).generate(
                prompts, _greedy(12))]
        eng = make_engine(params, True, k=3, mixed=True, max_prefill=32)
        got = [o.output_token_ids for o in eng.generate(prompts,
                                                        _greedy(12))]
        assert got == ref
        assert eng.obs.step_kind_counts["spec"] > 0

    def test_spec_engine_constructs_other_options_still_raise(self, params):
        """Spec decoding serves with and without a draft model (the async
        front door passes the draft weights through); swap builds its host
        tier; under pp (a stage's layout, here rank 0 of pp 2) spec is
        turned off with the JAX package's warning, and tp needs the
        process group."""
        from kubernetes_gpu_cluster_tpu_torch.serving.async_engine import \
            AsyncLLMEngine
        aeng = AsyncLLMEngine(_cfg(True, draft="debug-tiny"), params=params,
                              device="cpu", draft_params=params)
        runner = aeng.engine.scheduler.spec_proposer
        assert isinstance(runner, DraftModelRunner)
        assert runner.params is params
        assert isinstance(make_engine(params, True).scheduler.spec_proposer,
                          NgramProposer)
        swap = LLMEngine(EngineConfig(model=get_model_config("debug-tiny"),
                                      cache=CacheConfig(swap_space_gb=0.1)),
                         params=params, device="cpu")
        assert swap.swapper is not None
        import dataclasses
        from unittest import mock

        from kubernetes_gpu_cluster_tpu_torch.engine import engine as E
        from kubernetes_gpu_cluster_tpu_torch.parallel import make_mesh
        with mock.patch.object(E.logger, "warning") as warn:
            pp = LLMEngine(dataclasses.replace(
                _cfg(True), parallel=ParallelConfig(pp=2)), params=params,
                device="cpu", groups=make_mesh(pp=2, rank=0))
        assert any("spec decode disabled" in c.args[0]
                   for c in warn.call_args_list)
        assert not pp.scheduler.spec_enabled
        assert pp.kv_cache.k.shape[0] == 1          # stage 0's one layer
        with pytest.raises(RuntimeError, match="initialize_distributed"):
            LLMEngine(EngineConfig(model=get_model_config("debug-tiny"),
                                   parallel=ParallelConfig(tp=2)),
                      params=params, device="cpu")


class TestDraftModel:
    def test_mismatched_draft_greedy_identical(self, params):
        prompts = [list(REPETITIVE), list(PLAIN)]
        ref = [o.output_token_ids for o in make_engine(
            params, False).generate(prompts, _greedy(16))]
        eng = make_engine(params, True, draft="debug-tiny")
        eng.scheduler.spec_proposer = build_draft_runner(
            eng.config, "debug-tiny", seed=123, device="cpu")
        got = [o.output_token_ids for o in eng.generate(prompts,
                                                        _greedy(16))]
        assert got == ref
        ratio = eng.obs.spec_acceptance_ratio()
        assert ratio is not None and ratio < 0.5

    def test_seeded_sampled_reproducible_with_draft_model(self, params):
        sp = SamplingParams(max_tokens=12, temperature=0.9, seed=5)
        a, b = (make_engine(params, True, draft="debug-tiny",
                            draft_params=params).generate(
                                [list(REPETITIVE)], sp)[0]
                for _ in range(2))
        assert a.output_token_ids == b.output_token_ids


class TestDraftRunnerSync:
    """The runner's valid/tail bookkeeping, driven directly with real
    Sequence objects."""

    @staticmethod
    def _runner(params, k=4):
        return DraftModelRunner(_cfg(True, draft="debug-tiny", k=k),
                                get_model_config("debug-tiny"),
                                params=params, device="cpu")

    def test_first_round_resets_then_steady_state_is_one_feed(self, params):
        r = self._runner(params)
        seq = Sequence("r", list(REPETITIVE), SamplingParams())
        d1 = r.propose_batch([seq], 4)[0]
        assert len(d1) == 4
        resets = r.num_reset_prefills
        assert resets >= 1
        V = get_model_config("debug-tiny").vocab_size
        seq.append_token(d1[0])
        seq.append_token(d1[1])
        seq.append_token((d1[2] + 1) % V)
        assert len(r.propose_batch([seq], 4)[0]) == 4
        assert r.num_reset_prefills == resets

    def test_all_accepted_plus_bonus_keeps_sync(self, params):
        r = self._runner(params)
        seq = Sequence("r", list(REPETITIVE), SamplingParams())
        d1 = r.propose_batch([seq], 4)[0]
        for t in d1:
            seq.append_token(t)
        seq.append_token((d1[-1] + 3) % get_model_config(
            "debug-tiny").vocab_size)
        resets = r.num_reset_prefills
        assert len(r.propose_batch([seq], 4)[0]) == 3
        assert r.num_reset_prefills == resets

    def test_drafts_equal_a_greedy_forward_of_the_history(self, params):
        """Each draft is the draft model's argmax after the committed
        tokens and the drafts before it (a prefill of the whole history),
        across a reset and a steady-state round."""
        cfg = get_model_config("debug-tiny")
        r = self._runner(params)
        seq = Sequence("r", list(REPETITIVE), SamplingParams())
        eng = make_engine(params, False)

        def greedy_after(ids, n):
            return eng.generate([list(ids)], _greedy(n))[0].output_token_ids

        d1 = r.propose_batch([seq], 4)[0]
        assert d1 == greedy_after(seq.all_token_ids, 4)
        seq.append_token(d1[0])
        seq.append_token((d1[1] + 1) % cfg.vocab_size)
        d2 = r.propose_batch([seq], 4)[0]
        assert d2 == greedy_after(seq.all_token_ids, 4)

    def test_legacy_window_gap_triggers_reset(self, params):
        r = self._runner(params, k=3)
        seq = Sequence("r", list(REPETITIVE), SamplingParams())
        r.propose_batch([seq], 3)
        resets = r.num_reset_prefills
        V = get_model_config("debug-tiny").vocab_size
        for t in range(8):
            seq.append_token((t * 13 + 5) % V)
        assert len(r.propose_batch([seq], 3)[0]) == 3
        assert r.num_reset_prefills > resets

    def test_retain_frees_dropped_rows_pages(self, params):
        r = self._runner(params)
        seqs = [Sequence(f"r{i}", list(REPETITIVE), SamplingParams())
                for i in range(3)]
        r.propose_batch(seqs, 4)
        free_mid = r.allocator.num_free
        assert free_mid < r.allocator.num_pages - 1
        r.retain(["r0"])
        assert r.allocator.num_free > free_mid
        r.retain([])
        assert r.allocator.num_free == r.allocator.num_pages - 1

    def test_vocab_mismatch_rejected(self):
        with pytest.raises(ValueError, match="vocab"):
            DraftModelRunner(_cfg(True, draft="opt-125m"),
                             get_model_config("opt-125m"), device="cpu")


class TestAdaptiveK:
    def test_ladder_and_moves(self):
        c = AdaptiveK(k_max=6, window=2)
        assert c.ladder == (0, 1, 2, 4, 6)
        assert c.current_k == 6
        c.observe(12, 0)
        c.observe(12, 0)
        assert c.current_k == 4
        for _ in range(3 * 2):
            c.observe(12, 0)
        assert c.current_k == 0
        for _ in range(c.cooldown):
            c.tick_idle()
        assert c.current_k == 1
        c.observe(10, 10)
        c.observe(10, 10)
        assert c.current_k == 2

    def test_engine_garbage_draft_decays_to_zero_and_recovers(self, params):
        ref = make_engine(params, False).generate([list(REPETITIVE)],
                                                  _greedy(72))[0]
        eng = make_engine(params, True, adaptive=True)
        eng.scheduler.spec_proposer = _GarbageProposer(4, token=1)
        ctrl = eng.scheduler.spec_controller
        ctrl.window, ctrl.cooldown = 3, 6
        out = eng.generate([list(REPETITIVE)], _greedy(72))[0]
        assert out.output_token_ids == ref.output_token_ids
        assert ctrl.num_steps_down >= 3
        assert eng.obs.step_kind_counts["decode"] > 0
        assert eng.obs.spec_current_k == ctrl.current_k
        ctrl.current_k, ctrl._idle_ticks = 0, 0
        eng.scheduler.spec_proposer = build_draft_runner(
            eng.config, "debug-tiny", params=params, device="cpu")
        out2 = eng.generate([list(REPETITIVE)], _greedy(72))[0]
        assert out2.output_token_ids == ref.output_token_ids
        assert ctrl.current_k >= 1 and ctrl.num_steps_up >= 1


class TestSpecMixedInterop:
    @staticmethod
    def _staggered(eng):
        outs = {}
        eng.add_request("a", list(REPETITIVE), _greedy(20))
        for _ in range(10):
            for o in eng.step():
                if o.finished:
                    outs[o.request_id] = o.output_token_ids
        eng.add_request("b", REPETITIVE * 3, _greedy(20))
        eng.add_request("c", list(REPETITIVE), _greedy(20))
        while eng.has_unfinished_requests():
            for o in eng.step():
                if o.finished:
                    outs[o.request_id] = o.output_token_ids
        return outs

    def test_chunk_plus_verify_slices_in_one_step(self, params):
        ref = self._staggered(make_engine(params, False, mixed=True,
                                          max_prefill=32))
        eng = make_engine(params, True, mixed=True, max_prefill=32,
                          draft="debug-tiny", draft_params=params)
        assert self._staggered(eng) == ref
        assert eng.obs.step_kind_counts["spec_mixed"] > 0
        assert eng.obs.mixed_step_ratio() > 0
        alloc = eng.scheduler.allocator
        assert alloc.num_free == alloc.num_pages - 1

    def test_seeded_sampled_step_grouping_independent(self, params):
        """Seeded verify draws derive from (seed, position) and a greedy
        draft model's proposals from the state only, so how steps group
        (verify slices sharing a chunk's step or not) leaves a seeded
        stream unchanged."""
        sp = SamplingParams(max_tokens=16, temperature=0.8, seed=11)
        prompts = [REPETITIVE * 3, list(REPETITIVE)]
        ref = [o.output_token_ids for o in make_engine(
            params, True, max_prefill=32, draft="debug-tiny",
            draft_params=params).generate(prompts, sp)]
        eng = make_engine(params, True, mixed=True, max_prefill=32,
                          draft="debug-tiny", draft_params=params)
        got = [o.output_token_ids for o in eng.generate(prompts, sp)]
        assert got == ref
        assert eng.obs.step_kind_counts["spec_mixed"] > 0

    def test_abort_mid_chunk_with_spec_rows(self, params):
        eng = make_engine(params, True, mixed=True, max_prefill=32,
                          draft="debug-tiny", draft_params=params)
        eng.add_request("a", list(REPETITIVE), _greedy(24))
        for _ in range(6):
            eng.step()
        free0 = eng.scheduler.allocator.num_free
        eng.add_request("long", REPETITIVE * 3, _greedy(24))
        eng.step()
        head = eng.scheduler.waiting[0]
        assert head.request_id == "long" and head.num_prefilled > 0
        held = len(head.pages)
        free_mid = eng.scheduler.allocator.num_free
        assert held > 0
        assert eng.abort_request("long")
        assert eng.scheduler.allocator.num_free == free_mid + held
        while eng.has_unfinished_requests():
            eng.step()
        alloc = eng.scheduler.allocator
        assert alloc.num_free == alloc.num_pages - 1
        assert free0 <= alloc.num_free


class TestSpecDraftObservability:
    def test_current_k_gauge_and_draft_counters(self, params):
        eng = make_engine(params, True, draft="debug-tiny",
                          draft_params=params)
        text = "\n".join(eng.obs.render_prometheus())
        assert "kgct_spec_current_k 4" in text
        assert "kgct_spec_draft_tokens_total 0" in text
        assert "kgct_spec_draft_seconds" in text
        eng.generate([list(REPETITIVE)], _greedy(16))
        text = "\n".join(eng.obs.render_prometheus())
        assert "kgct_spec_draft_tokens_total 0" not in text
        assert eng.obs.spec_draft_tokens > 0

    def test_current_k_absent_when_spec_off(self, params):
        text = "\n".join(make_engine(params, False).obs.render_prometheus())
        assert "kgct_spec_current_k" not in text
        assert "kgct_spec_draft_tokens_total 0" in text

    def test_spec_trace_events_carry_phase_attribution(self, params):
        eng = make_engine(params, True, draft="debug-tiny",
                          draft_params=params)
        eng.generate([list(REPETITIVE)], _greedy(16))
        evs = [e for e in eng.obs.tracer.events() if e.kind == "spec"]
        assert evs
        assert "draft_ms" in evs[0].args and "verify_ms" in evs[0].args
