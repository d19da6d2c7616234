"""The JAX package's engine-core tests, carried to the port's copies of
``engine/{scheduler,kv_cache,mixed_batch,sequence,qos}.py``,
``observability/`` and the engine.

Each reference file is loaded from ``tests/`` with its imports re-pointed
from ``kubernetes_gpu_cluster_tpu`` to ``kubernetes_gpu_cluster_tpu_torch``
and its engines built on the CPU, so a change to either copy is held by
the same cases; nothing is copied by hand. The seams where the port's API
differs are adapted by exact substitutions (each must still match, or the
load fails):

- ``derive_num_pages(free_bytes=)`` (the JAX name is ``hbm_free_bytes``);
- ``allocate_kv_cache`` and ``init_params`` take a device (and a
  ``torch.Generator`` in place of a JAX key);
- ``test_engine.py``'s teacher forcing and its logprob oracle run through
  the port's ``forward_prefill`` and ``kv_cache``;
- ``test_qos.py`` contributes ``TestTierParsing``,
  ``TestFairShareScheduling``, ``TestEngineFairness`` and
  ``TestByteIdentity``; its server classes are carried in
  ``test_torch_resilience.py``, ``test_torch_fleet.py`` and
  ``test_torch_router.py``.

The carried cases keep their names, prefixed by their file:
``TestScheduler_Admission``, ``test_kv_cache__allocator_basic``.
"""

from __future__ import annotations

import functools
import types

import numpy as np
import torch

from kubernetes_gpu_cluster_tpu_torch.config import CacheConfig
from kubernetes_gpu_cluster_tpu_torch.engine.kv_cache import \
    allocate_kv_cache
from kubernetes_gpu_cluster_tpu_torch.models import llama as TM
from torch_carry import PORT, carry, expose

torch.set_num_threads(2)


def _port_prefill_whole(cfg, params, seq):
    """The teacher-forcing oracle: one prefill of the whole sequence
    through the port's forward; (logits of the last token, None, None)."""
    n, ps = len(seq), 8
    up = lambda a: torch.from_numpy(np.asarray(a, np.int32))  # noqa: E731
    kv = allocate_kv_cache(cfg, CacheConfig(page_size=ps), n // ps + 2,
                           "cpu")
    meta = TM.PrefillMeta(up(np.zeros(n)), up(np.arange(n)),
                          up(np.arange(n) + ps), up([n - 1]))
    h, _, _ = TM.forward_prefill(params, cfg, up(seq), meta, kv)
    return TM.compute_logits(params, cfg, h)[0], None, None


# What the carried logprob and window cases call ``jax``/``jnp``: the same
# operations on torch tensors.
_torch_jnp = types.SimpleNamespace(
    asarray=lambda a, dtype=None: torch.from_numpy(np.asarray(a, dtype)),
    int32=np.int32, argmax=torch.argmax)
_torch_jax = types.SimpleNamespace(
    random=types.SimpleNamespace(
        key=lambda seed: torch.Generator().manual_seed(seed)),
    nn=types.SimpleNamespace(log_softmax=lambda x: torch.log_softmax(x, -1)))

# file -> (exact substitutions, names carried (None: every test))
CARRIED = {
    "test_scheduler": ([
        ('        eng = LLMEngine(cfg)\n        seq = _seq("grown", 6)',
         '        eng = LLMEngine(cfg, device="cpu")\n'
         '        seq = _seq("grown", 6)'),
    ], None),
    "test_kv_cache": ([
        ("hbm_free_bytes=per_page * 100", "free_bytes=per_page * 100"),
        ("allocate_kv_cache(model, cache, 16)",
         'allocate_kv_cache(model, cache, 16, "cpu")'),
    ], None),
    "test_prefix_cache": ([], None),
    "test_mixed_batch": ([], None),
    "test_chunked_prefill": ([], None),
    "test_observability": ([], None),
    "test_engine": ([
        ("    import jax.numpy as jnp\n"
         "    from tests.test_model import _prefill_whole\n",
         "    jnp = _torch_jnp\n"
         "    _prefill_whole = _port_prefill_whole\n"),
        ("        import jax\n        from " + PORT + ".models import llama "
         "as model_lib\n",
         "        jax = _torch_jax\n        from " + PORT + ".models import "
         "llama as model_lib\n"),
        ('model_lib.init_params(base["model"], jax.random.key(7))',
         'model_lib.init_params(base["model"], jax.random.key(7), "cpu")'),
        ("        import jax\n        import jax.numpy as jnp\n",
         "        jax, jnp = _torch_jax, _torch_jnp\n\n"),
        ("model_lib.init_params(cfg.model, jax.random.key(0))",
         'model_lib.init_params(cfg.model, jax.random.key(0), "cpu")'),
        ("allocate_kv_cache(cfg.model, cfg.cache, 33)",
         'allocate_kv_cache(cfg.model, cfg.cache, 33, "cpu")'),
    ], None),
    "test_qos": ([], ("TestTierParsing", "TestFairShareScheduling",
                      "TestEngineFairness", "TestByteIdentity",
                      "qos_engine")),
}


def _carry(name: str, fixes: list) -> types.ModuleType:
    """``tests/<name>.py`` re-pointed at the port, engines on the CPU."""
    mod = carry(name, fixes, _port_prefill_whole=_port_prefill_whole,
                _torch_jnp=_torch_jnp, _torch_jax=_torch_jax)
    if "LLMEngine" in mod.__dict__:
        mod.LLMEngine = functools.partial(mod.LLMEngine, device="cpu")
    return mod


for _name, (_fixes, _keep) in CARRIED.items():
    expose(_name, _carry(_name, _fixes), _keep, globals())
