"""The port's sampling ops against the JAX package's, on the CPU.

Same logits (numpy, from a seed) into both packages:

- greedy ids must match exactly and chosen-token logprobs at fp32 atol
  1e-5 (one max, one logsumexp per row: a few ulps apart);
- penalties, logit bias, the output-token histogram and the top-k/top-p
  filters (every tier: the 128 window, the 2048 wide window, the full
  sort) must match at atol 1e-6 / exactly (elementwise arithmetic and the
  same kept set);
- seeded sampling cannot match JAX bit for bit (threefry there, a
  counter-based hash + Gumbel-max here), so it is held by its properties:
  the same (seed, position) gives the same token in any batch, and the
  draws follow the target softmax (chi-square, the same pin as the JAX
  package's rejection-sampling test: df = 15, bound 60 ≈ 8 sigma);
- the gated stages (``ops/gates.py``, the JAX functions' ``lax.cond``s):
  with flags from the JAX conditions on the same rows, each eager stage
  runs exactly where its condition holds, and skipped alternatives are
  the JAX false branch's zeros.
"""

import collections
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_gpu_cluster_tpu.ops import sampling as JS
from kubernetes_gpu_cluster_tpu_torch.ops import sampling as TS

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _logits(B, V, seed=0, scale=3.0):
    return (np.random.default_rng(seed).standard_normal((B, V)) * scale
            ).astype(np.float32)


def test_greedy_ids_exact_and_logprobs():
    B, V = 6, 512
    logits = _logits(B, V)
    zeros = np.zeros(B, np.float32)
    j_ids, j_lps, j_tid, j_tlp = JS.sample_and_logprobs(
        jnp.asarray(logits), jax.random.key(0), jnp.asarray(zeros),
        jnp.zeros(B, jnp.int32), jnp.ones(B, jnp.float32),
        with_top=jnp.asarray(True))
    t_ids, t_lps, t_tid, t_tlp = TS.sample_and_logprobs(
        _t(logits), torch.zeros(B, dtype=torch.int64), _t(zeros),
        torch.zeros(B, dtype=torch.int32), torch.ones(B),
        any_sampled=False, needs_filter=False, with_top=True)
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    np.testing.assert_allclose(t_lps.numpy(), np.asarray(j_lps), atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(t_tid.numpy(), np.asarray(j_tid))
    np.testing.assert_allclose(t_tlp.numpy(), np.asarray(j_tlp), atol=1e-5,
                               rtol=0)
    # token_logprobs (the greedy decode window's readout) agrees too.
    np.testing.assert_allclose(
        TS.token_logprobs(_t(logits), t_ids).numpy(),
        np.asarray(JS.token_logprobs(jnp.asarray(logits), j_ids)),
        atol=1e-5, rtol=0)


def test_sampled_rows_report_scaled_logprobs_and_greedy_rows_argmax():
    B, V = 4, 300
    logits = _logits(B, V, seed=1)
    temp = np.array([0.0, 0.7, 1.3, 0.0], np.float32)
    keys = TS.row_sample_keys(0, torch.tensor([3, 4, -1, 5]),
                              torch.tensor([10, 11, 12, 13]))
    ids, lps, _, _ = TS.sample_and_logprobs(
        _t(logits), keys, _t(temp), torch.zeros(B, dtype=torch.int32),
        torch.ones(B), any_sampled=True, needs_filter=False)
    assert ids[0] == int(np.argmax(logits[0]))
    assert ids[3] == int(np.argmax(logits[3]))
    safe = np.where(temp <= 0, 1.0, temp)
    want = JS._chosen_logprobs(jnp.asarray(logits / safe[:, None]),
                               jnp.asarray(ids.numpy()))
    np.testing.assert_allclose(lps.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("V,top_k,top_p", [
    (512, [0, 5, 50, 0, 200, 1], [1.0, 1.0, 0.9, 0.5, 0.95, 0.3]),
    # k beyond the 128 window: the wide (2048) tier.
    (4096, [1000, 0, 300, 7], [1.0, 1.0, 1.0, 0.8]),
    # k beyond the wide window: the full sort.
    (4096, [3000, 2500, 0, 0], [1.0, 0.97, 1.0, 1.0]),
    (100, [0, 10, 3], [0.7, 1.0, 1.0]),       # V <= 128: sort only
])
def test_filters_match_jax(V, top_k, top_p):
    B = len(top_k)
    # Flat-ish rows (scale 0.3) make top-p prefixes wide, forcing the
    # higher tiers; peaked rows resolve in the first window.
    logits = _logits(B, V, seed=V, scale=0.3 if V == 4096 else 3.0)
    tk = np.asarray(top_k, np.int32)
    tp = np.asarray(top_p, np.float32)
    want = np.asarray(JS._apply_filters(jnp.asarray(logits), jnp.asarray(tk),
                                        jnp.asarray(tp)))
    got = TS._apply_filters(_t(logits), _t(tk), _t(tp)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    keep = ~np.isneginf(want)
    np.testing.assert_allclose(got[keep], want[keep], atol=1e-6, rtol=0)


def test_penalties_bias_and_counts_match_jax():
    B, V, cap = 3, 64, 10
    logits = _logits(B, V, seed=3)
    rng = np.random.default_rng(4)
    out_tokens = rng.integers(0, V, (B, cap)).astype(np.int32)
    out_tokens[0, 6:] = -1
    out_tokens[2, :] = -1
    presence = np.array([0.5, 0.0, 1.5], np.float32)
    frequency = np.array([0.25, 1.0, 0.0], np.float32)
    bias_ids = np.full((B, 4), -1, np.int32)
    bias_vals = np.zeros((B, 4), np.float32)
    bias_ids[0, :2] = [5, 9]
    bias_vals[0, :2] = [3.0, -100.0]
    bias_ids[1, :3] = [7, 7, 2]               # duplicates accumulate
    bias_vals[1, :3] = [1.0, 2.0, -0.5]

    j_counts = JS.build_counts(jnp.asarray(out_tokens), V)
    t_counts = TS.build_counts(_t(out_tokens), V)
    np.testing.assert_array_equal(t_counts.numpy(), np.asarray(j_counts))
    toks = np.array([1, 63, 0], np.int32)
    np.testing.assert_array_equal(
        TS.bump_counts(t_counts, _t(toks)).numpy(),
        np.asarray(JS.bump_counts(j_counts, jnp.asarray(toks))))
    np.testing.assert_allclose(
        TS.apply_penalties(_t(logits), t_counts, _t(presence),
                           _t(frequency)).numpy(),
        np.asarray(JS.apply_penalties(jnp.asarray(logits), j_counts,
                                      jnp.asarray(presence),
                                      jnp.asarray(frequency))),
        atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        TS.apply_logit_bias(_t(logits), _t(bias_ids), _t(bias_vals)).numpy(),
        np.asarray(JS.apply_logit_bias(jnp.asarray(logits),
                                       jnp.asarray(bias_ids),
                                       jnp.asarray(bias_vals))),
        atol=1e-6, rtol=0)


def _draw(logits, seeds, positions, temperature=1.0, top_k=0, top_p=1.0):
    B = logits.shape[0]
    keys = TS.row_sample_keys(77, _t(np.asarray(seeds, np.int32)),
                              _t(np.asarray(positions, np.int32)))
    ids, _, _, _ = TS.sample_and_logprobs(
        _t(logits), keys, torch.full((B,), temperature),
        torch.full((B,), top_k, dtype=torch.int32), torch.full((B,), top_p),
        any_sampled=True, needs_filter=(top_k > 0 or top_p < 1.0))
    return ids.numpy()


def test_seeded_rows_invariant_across_batch_composition():
    V = 256
    row = _logits(1, V, seed=9, scale=1.0)[0]
    alone = _draw(row[None], [42], [17])
    others = _logits(5, V, seed=10)
    batch = np.concatenate([others[:2], row[None], others[2:]])
    mixed = _draw(batch, [-1, 3, 42, -1, 8, 42], [5, 17, 17, 9, 17, 16])
    assert mixed[2] == alone[0]
    # Different position or seed: a fresh draw (not necessarily a different
    # token, but the keys differ).
    k = TS.row_sample_keys(0, torch.tensor([42, 42, 43]),
                           torch.tensor([17, 16, 17]))
    assert len(set(k.tolist())) == 3
    # Unseeded rows follow the step key.
    k1 = TS.row_sample_keys(1, torch.tensor([-1]), torch.tensor([5]))
    k2 = TS.row_sample_keys(2, torch.tensor([-1]), torch.tensor([5]))
    assert int(k1) != int(k2)


@pytest.mark.parametrize("top_k", [0, 6])
def test_seeded_draws_follow_target_chi_square(top_k):
    """>= 10k seeded draws (one seed, consecutive positions) of a 16-token
    distribution against its softmax (renormalized over the top-k when
    filtering): chi-square < 60 at df = 15 (~8 sigma above 15)."""
    B, V = 12000, 16
    row = (np.random.default_rng(0).standard_normal(V) * 1.5).astype(
        np.float32)
    target = np.exp(row - row.max())
    if top_k:
        target[np.argsort(target)[:-top_k]] = 0.0
    target /= target.sum()
    ids = _draw(np.broadcast_to(row, (B, V)).copy(), np.full(B, 123),
                np.arange(B), top_k=top_k)
    counts = np.bincount(ids, minlength=V).astype(np.float64)
    assert counts[target == 0].sum() == 0
    keep = target > 0
    expected = target[keep] * B
    chi2 = float(((counts[keep] - expected) ** 2 / expected).sum())
    assert chi2 < 60.0, (chi2, counts, expected)


# -- gated stages (ops/gates.py): the JAX functions' lax.cond conditions ---

# name -> (temperature, top_k, top_p, top_n) of a batch's rows
_GATE_ROWS = {
    "all_greedy": ([0.0, 0.0, 0.0], [0, 0, 0], [1.0, 1.0, 1.0], [0, 0, 0]),
    "greedy_top": ([0.0, 0.0, 0.0], [0, 0, 0], [1.0, 1.0, 1.0], [0, 2, 0]),
    "sampled": ([0.0, 0.8, 0.0], [0, 0, 0], [1.0, 1.0, 1.0], [0, 0, 0]),
    "top_k_50": ([0.7, 0.8, 0.0], [50, 0, 0], [1.0, 1.0, 1.0], [0, 0, 0]),
    "top_p": ([0.7, 0.0, 0.0], [0, 0, 0], [1.0, 0.95, 1.0], [0, 0, 1]),
    "top_k_past_cap": ([0.9, 0.9, 0.9], [0, 300, 0], [1.0, 1.0, 1.0],
                       [0, 0, 0]),
    "greedy_with_filter": ([0.0, 0.0, 0.0], [5, 0, 0], [1.0, 1.0, 1.0],
                           [0, 0, 0]),
}


def _jax_gates(temp, top_k, top_p, top_n) -> dict:
    """The conditions of ``sample_and_logprobs``' ``lax.cond``s, by the JAX
    expressions on the same arrays (``needs_filter`` is evaluated inside
    the sampled path there)."""
    t, k, p = jnp.asarray(temp), jnp.asarray(top_k), jnp.asarray(top_p)
    return {"any_sampled": bool(jnp.any(t > 0)),
            "needs_filter": bool(jnp.any((k > 0) | (p < 1.0))),
            "with_top": bool(jnp.any(jnp.asarray(top_n) > 0))}


@contextlib.contextmanager
def counting_stages():
    """Each gated stage's eager runs of its ``then``, by stage name, while
    open: the port's ``gates.when`` wrapped where the engine and the
    sampling ops call it."""
    from kubernetes_gpu_cluster_tpu_torch.engine import engine as TE
    from kubernetes_gpu_cluster_tpu_torch.ops import gates
    counts = collections.Counter()

    def counted(name, flag, then, otherwise=None):
        def run():
            counts[name] += 1
            then()
        gates.when(name, flag, run, otherwise)
    try:
        TE.when = TS.when = counted
        yield counts
    finally:
        TE.when = TS.when = gates.when


def _flags(values: dict) -> dict:
    """``gates.Flag``s of host values (device copies set to the opposite,
    which an eager call must never read)."""
    from kubernetes_gpu_cluster_tpu_torch.ops.gates import Flag
    return {k: Flag(v, torch.tensor([int(not v)], dtype=torch.int32))
            for k, v in values.items()}


@pytest.mark.parametrize("kind", sorted(_GATE_ROWS))
def test_gated_sampling_runs_each_stage_where_the_jax_condition_holds(kind):
    """``sample_and_logprobs`` with its flags as ``Flag``s from the JAX
    conditions on the same rows: the eager stages run exactly where those
    hold (``counting_stages``); greedy ids and every row's logprobs agree with
    the JAX function; alternatives agree where asked for, and are the JAX
    false branch's zeros where not."""
    temp, top_k, top_p, top_n = (np.asarray(a) for a in _GATE_ROWS[kind])
    temp, top_p = temp.astype(np.float32), top_p.astype(np.float32)
    top_k = top_k.astype(np.int32)
    B, V = 3, 512
    logits = _logits(B, V, seed=5)
    cond = _jax_gates(temp, top_k, top_p, top_n)
    keys = TS.row_sample_keys(0, torch.tensor([1, 2, 3]),
                              torch.tensor([7, 8, 9]))
    with counting_stages() as taken:
        ids, lps, tid, tlp = TS.sample_and_logprobs(
            _t(logits), keys, _t(temp), _t(top_k), _t(top_p),
            **_flags(cond))
    ran = {k: taken[k] for k in ("sampled", "filters", "top_logprobs")}
    assert ran == {"sampled": int(cond["any_sampled"]),
                   "filters": int(cond["any_sampled"]
                                  and cond["needs_filter"]),
                   "top_logprobs": int(cond["with_top"])}
    j_ids, j_lps, j_tid, j_tlp = JS.sample_and_logprobs(
        jnp.asarray(logits), jax.random.key(0), jnp.asarray(temp),
        jnp.asarray(top_k), jnp.asarray(top_p),
        with_top=jnp.asarray(cond["with_top"]))
    greedy = temp <= 0
    np.testing.assert_array_equal(ids.numpy()[greedy],
                                  np.asarray(j_ids)[greedy])
    want_lps = JS._chosen_logprobs(
        jnp.asarray(logits / np.where(greedy, 1.0, temp)[:, None]),
        jnp.asarray(ids.numpy()))
    np.testing.assert_allclose(lps.numpy(), np.asarray(want_lps),
                               atol=1e-5, rtol=0)
    if cond["with_top"]:
        np.testing.assert_array_equal(tid.numpy(), np.asarray(j_tid))
        np.testing.assert_allclose(tlp.numpy(), np.asarray(j_tlp),
                                   atol=1e-5, rtol=0)
    else:
        assert not tid.any() and not tlp.any()
        assert not np.asarray(j_tid).any() and not np.asarray(j_tlp).any()


@pytest.mark.parametrize("pen", [False, True])
def test_gated_verify_runs_each_stage_at_every_position(pen):
    """``spec_verify_sample`` on greedy rows with flags from the JAX
    function's own conditions: tokens and accepted counts equal the JAX
    function's; penalties, the count bump and the filters run at every
    position where their condition holds, the sampled decision at none
    (all rows greedy), and alternatives are zero-filled as the JAX false
    branch returns them."""
    rng = np.random.default_rng(9)
    B, S, V = 3, 4, 256
    logits = (rng.standard_normal((B, S, V)) * 3).astype(np.float32)
    drafts = logits[:, :-1].argmax(-1).astype(np.int32)
    drafts[1, 1] = (drafts[1, 1] + 1) % V
    pos0 = np.array([10, 20, 30], np.int32)
    presence = np.full(B, 0.7 if pen else 0.0, np.float32)
    frequency = np.zeros(B, np.float32)
    counts = rng.integers(0, 3, (B, V)).astype(np.int32)
    temp = np.zeros(B, np.float32)
    top_k = np.array([0, 40, 0], np.int32)
    top_p = np.ones(B, np.float32)
    seed = np.full(B, -1, np.int32)
    cond = {"any_sampled": bool(jnp.any(jnp.asarray(temp) > 0)),
            "needs_filter": bool(jnp.any((jnp.asarray(top_k) > 0)
                                         | (jnp.asarray(top_p) < 1.0))),
            "any_pen": bool(jnp.any((jnp.asarray(presence) != 0.0)
                                    | (jnp.asarray(frequency) != 0.0))),
            "with_top": False}
    with counting_stages() as taken:
        toks, n_acc, lps, tids, tlps = TS.spec_verify_sample(
            _t(logits), _t(drafts), _t(pos0), 0, _t(seed), _t(temp),
            _t(top_k), _t(top_p), _t(presence), _t(frequency), _t(counts),
            **_flags(cond))
    ran = {k: taken[k] for k in ("penalties", "count_bump", "counts",
                                 "filters", "sampled", "top_logprobs")}
    assert ran == {"penalties": S * pen, "count_bump": (S - 1) * pen,
                   "counts": int(pen), "filters": S, "sampled": 0,
                   "top_logprobs": 0}
    j = JS.spec_verify_sample(
        jnp.asarray(logits), jnp.asarray(drafts), jnp.asarray(pos0),
        jax.random.key(0), jnp.asarray(seed), jnp.asarray(temp),
        jnp.asarray(top_k), jnp.asarray(top_p), jnp.asarray(presence),
        jnp.asarray(frequency), jnp.asarray(counts),
        with_top=jnp.asarray(False))
    np.testing.assert_array_equal(n_acc.numpy(), np.asarray(j[1]))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(j[0]))
    assert not tids.any() and not tlps.any()
    assert not np.asarray(j[3]).any() and not np.asarray(j[4]).any()
