"""Tensor and expert parallelism on ``torch.distributed``.

- ``mesh.py``: the rank layout over the JAX package's axes
  ``("dp", "pp", "ep", "sp", "tp")`` (tp innermost), the tp / ep / moe
  process groups of one rank (``ParallelGroups``), and the bootstrap from
  the ``KGCT_*`` environment.
- ``sharding.py``: the Megatron rules that slice the full parameter dict
  into one rank's tensors, and the per-rank KV geometry.
- ``ep.py``: the MoE block over a rank's experts.

The collectives themselves sit in ``models/llama.py`` (one all-reduce
after ``wo``, one after ``w_down`` or the MoE combine, the embedding's
all-reduce and the logits' all-gather). Ranks step in lockstep under
``serving/multihost.py``. pp (ROADMAP A7b) and sp (A7c) are refused.
"""

from .mesh import (MESH_AXES, ParallelGroups, initialize_distributed,
                   make_mesh, mesh_from_config)
from .sharding import local_kv_config, shard_params

__all__ = ["MESH_AXES", "ParallelGroups", "initialize_distributed",
           "make_mesh", "mesh_from_config", "local_kv_config",
           "shard_params"]
