"""Model registry: the reference's ``modelURL`` semantics.

A modelSpec's ``modelURL`` is either an HF-style id mapped to a preset, or a
local checkpoint directory staged on the node beforehand. ``resolve()``
turns that one string into what the engine needs: an architecture config, a
weights source and a tokenizer source. Every family shares one decoder
(``models/llama.py``), specialised by ``ModelConfig`` alone.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..config.model_config import (MODEL_PRESETS,  # noqa: F401
                                   ModelConfig, get_model_config)


@dataclasses.dataclass(frozen=True)
class ResolvedModel:
    config: ModelConfig
    weights_path: Optional[str]     # None -> random init (debug/bench)
    tokenizer_path: Optional[str]   # None -> byte tokenizer


def resolve(model_url: str, name: Optional[str] = None) -> ResolvedModel:
    """modelURL (HF id, preset name, or local checkpoint dir) ->
    ResolvedModel."""
    from ..engine.weights import resolve_model

    cfg, weights, tokenizer = resolve_model(model_url, name)
    return ResolvedModel(config=cfg, weights_path=weights,
                         tokenizer_path=tokenizer)


def load(resolved: ResolvedModel, device: torch.device | str = "cuda"):
    """The params of a resolved model on ``device`` (the card unless the
    caller asks for the CPU): the checkpoint's weights when it has one,
    None otherwise (the engine then draws random weights)."""
    if resolved.weights_path is None:
        return None
    from ..engine.weights import load_weights

    return load_weights(resolved.weights_path, resolved.config,
                        device=device)


def list_models() -> list[str]:
    return sorted(MODEL_PRESETS)
