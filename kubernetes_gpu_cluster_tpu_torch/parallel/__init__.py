"""Tensor, expert, pipeline and sequence parallelism on
``torch.distributed``.

- ``mesh.py``: the rank layout over the JAX package's axes
  ``("dp", "pp", "ep", "sp", "tp")`` (tp innermost), the tp / ep / moe /
  pp / sp process groups of one rank (``ParallelGroups``), the stage's
  point-to-point and broadcast helpers, and the bootstrap from the
  ``KGCT_*`` environment.
- ``sharding.py``: the Megatron rules and the stage split that slice the
  full parameter dict into one rank's tensors, and the per-rank KV
  geometry.
- ``ep.py``: the MoE block over a rank's experts.
- ``pp.py``: the GPipe schedule of one step over the pipeline stages.
- ``sp.py``: ring attention for ragged prefill over the sp ranks.

The tp/ep collectives sit in ``models/llama.py`` (one all-reduce after
``wo``, one after ``w_down`` or the MoE combine, the embedding's
all-reduce and the logits' all-gather). Ranks step in lockstep under
``serving/multihost.py``.
"""

from .mesh import (MESH_AXES, ParallelGroups, initialize_distributed,
                   make_mesh, mesh_from_config)
from .sharding import local_kv_config, shard_params

__all__ = ["MESH_AXES", "ParallelGroups", "initialize_distributed",
           "make_mesh", "mesh_from_config", "local_kv_config",
           "shard_params"]
