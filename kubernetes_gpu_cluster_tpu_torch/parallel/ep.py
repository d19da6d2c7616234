"""Expert parallelism for the mixtral-class MoE block.

The JAX package shards the expert axis over ``ep`` (and each expert's ffn
over ``tp``) and lets the combine einsum's contraction become a psum; its
``moe_block_ep`` runs the block standalone under ``shard_map``. Here a
rank holds ``E / ep`` experts (``parallel/sharding.py``), evaluates them
over every token, takes its slice of the ``[T, E]`` combine weights, and
the fp32 partials are all-reduced over ep and tp together before the one
cast (``models/llama.py::_moe_mlp``). Dense dispatch keeps every rank's
work the same shape: no all-to-all, no capacity drops.
"""

from __future__ import annotations

import torch

from ..config import ModelConfig
from ..models.llama import _moe_mlp


def moe_block_ep(groups, cfg: ModelConfig, layer_params: dict,
                 x: torch.Tensor) -> torch.Tensor:
    """One MoE block with this rank's experts. ``layer_params`` holds one
    layer's LOCAL ``router`` / ``w_gate`` / ``w_up`` / ``w_down`` (and
    scales; no leading L axis), as ``parallel.sharding`` slices them.
    x: [T, d], the same on every rank; returns the reduced [T, d]."""
    if cfg.num_experts % groups.ep != 0:
        raise ValueError(f"num_experts={cfg.num_experts} not divisible by "
                         f"ep={groups.ep}")
    return _moe_mlp(layer_params, cfg, x, groups)
