"""The port's entry twin (``kubernetes_gpu_cluster_tpu_torch/graft_entry.py``)
against the JAX package's root ``__graft_entry__.py``, on the CPU.

- ``entry(model="debug-tiny", device="cpu")`` on the JAX weights (carried
  by ``params_from_numpy``) gives the next tokens of the JAX step that
  ``__graft_entry__.entry`` builds, rebuilt here at debug-tiny from the JAX
  package's functions, and writes the same K/V into its pool in place;
- ``dryrun_multichip(4)`` passes over four gloo ranks and prints the JAX
  dry run's progress lines;
- the layout split is the JAX ``_factors``.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_gpu_cluster_tpu.config import CacheConfig as JCache
from kubernetes_gpu_cluster_tpu.config import get_model_config as jax_model
from kubernetes_gpu_cluster_tpu.engine.kv_cache import allocate_kv_cache
from kubernetes_gpu_cluster_tpu.models import llama as JM
from kubernetes_gpu_cluster_tpu.ops.sampling import sample_tokens
from kubernetes_gpu_cluster_tpu_torch import graft_entry
from kubernetes_gpu_cluster_tpu_torch.config import get_model_config
from kubernetes_gpu_cluster_tpu_torch.models import llama as TM

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent


def _jax_entry_module():
    spec = importlib.util.spec_from_file_location(
        "jax_graft_entry", ROOT / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_step(model: str):
    """``__graft_entry__.entry``'s decode step and inputs at ``model``
    (on the CPU: the XLA attention, as the JAX entry off a TPU)."""
    cfg = jax_model(model)
    params = JM.init_params(cfg, jax.random.key(0))
    kv = allocate_kv_cache(cfg, JCache(page_size=16, num_pages=129), 129)
    B, pages_per_seq = 8, 8
    meta = JM.DecodeMeta(
        positions=jnp.full((B,), 5, jnp.int32),
        slot_mapping=jnp.asarray(
            np.arange(B, dtype=np.int32) * pages_per_seq * 16 + 16 + 5),
        page_tables=jnp.asarray(1 + np.arange(
            B * pages_per_seq, dtype=np.int32).reshape(B, pages_per_seq)),
        context_lens=jnp.full((B,), 6, jnp.int32))
    tokens = jnp.asarray(np.arange(B, dtype=np.int32) + 7)
    hidden, kv, _ = JM.forward_decode(params, cfg, tokens, meta, kv,
                                      use_pallas=False)
    logits = JM.compute_logits(params, cfg, hidden)
    nxt = sample_tokens(logits, jax.random.key(1),
                        jnp.zeros((B,), jnp.float32),
                        jnp.zeros((B,), jnp.int32), jnp.ones((B,), jnp.float32))
    return params, np.asarray(nxt), kv


def test_entry_step_matches_the_jax_entry_step():
    """The port's step on the JAX weights: the JAX step's next tokens, and
    its pool written in place with the JAX pool's K/V (fp32, 1e-5); a
    second call on the same inputs gives the same tokens."""
    jparams, want, jkv = _jax_step("debug-tiny")
    fn, args = graft_entry.entry(model="debug-tiny", device="cpu")
    params = TM.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                  get_model_config("debug-tiny"), "cpu")
    args = (params, *args[1:])
    kv = args[1]
    got, out_kv = fn(*args)
    assert out_kv.k is kv.k and out_kv.v is kv.v          # in place
    assert got.dtype == torch.int32 and got.tolist() == want.tolist()
    for t, j in zip(kv, jkv):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)
    assert kv.k[:, 1].abs().sum() > 0       # the new token's slot
    again, _ = fn(*args)
    assert again.tolist() == got.tolist()


def test_entry_inputs_are_the_jax_entry_inputs():
    """Batch 8, 8 pages a sequence of 16 tokens, 129 pages, positions 5,
    context 6, tokens 7..14, greedy: as ``__graft_entry__.entry``."""
    _, args = graft_entry.entry(model="debug-tiny", device="cpu")
    _, kv, tokens, meta, key, temperature, top_k, top_p = args
    assert kv.k.shape[1:3] == (129, 16)
    assert tokens.tolist() == list(range(7, 15))
    assert meta.positions.tolist() == [5] * 8
    assert meta.context_lens.tolist() == [6] * 8
    assert meta.slot_mapping.tolist() == [b * 128 + 21 for b in range(8)]
    assert meta.page_tables.tolist() == [
        list(range(1 + 8 * b, 9 + 8 * b)) for b in range(8)]
    assert key.tolist() == [1]
    assert not temperature.any() and not top_k.any() and top_p.all()


@pytest.mark.parametrize("n", range(1, 9))
def test_factors_match_the_jax_split(n):
    jent = _jax_entry_module()
    for allow_pp in (False, True):
        assert graft_entry._factors(n, allow_pp) == jent._factors(n, allow_pp)


def test_dryrun_multichip_passes_on_four_gloo_ranks(capsys):
    """Every phase of the dry run over four ranks: (a) ep 2 × tp 2
    through the engine on debug-moe, (b) pp 2 × tp 2 through the engine,
    (b2) the pipeline forward, (b3) paged decode at tp 2 × dp 2 against
    the oracle, (c) the sp 4 engine and ring attention."""
    graft_entry.dryrun_multichip(4)
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "[dryrun] all multichip paths OK on 4 ranks"
    assert sum(line.endswith(" OK") for line in lines) == 6, lines
    assert "[dryrun] PP engine step on layout {'tp': 2, 'pp': 2, 'dp': 1}" \
        in lines
