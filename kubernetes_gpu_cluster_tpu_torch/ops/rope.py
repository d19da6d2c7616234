"""Rotary position embeddings (half-split convention, matching HF llama/qwen).

Computed on the fly from integer positions — no precomputed cos/sin table
to keep resident or re-slice.

Scaling: Llama-3.1/3.2 checkpoints ship ``rope_scaling`` (type "llama3") —
piecewise frequency rescaling that stretches low-frequency components by
``factor`` with a smooth ramp between the high/low wavelength cutoffs.
"linear" (positions / factor everywhere) is also supported. Both are
static transforms of ``inv_freq``.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch


def scaled_inv_freq(head_dim: int, theta: float,
                    scaling: Optional[dict] = None) -> np.ndarray:
    """Per-pair inverse frequencies [head_dim//2], with HF ``rope_scaling``
    applied. Pure numpy on static config."""
    half = head_dim // 2
    inv_freq = theta ** -(np.arange(half, dtype=np.float32) / half)
    if not scaling:
        return inv_freq
    kind = scaling.get("rope_type") or scaling.get("type")
    factor = float(scaling.get("factor", 1.0))
    if kind == "linear":
        return inv_freq / factor
    if kind == "llama3":
        lo_f = float(scaling.get("low_freq_factor", 1.0))
        hi_f = float(scaling.get("high_freq_factor", 4.0))
        orig = float(scaling.get("original_max_position_embeddings", 8192))
        wavelen = 2.0 * np.pi / inv_freq
        # Wavelengths shorter than orig/hi_f keep full resolution; longer than
        # orig/lo_f are stretched by `factor`; in between, interpolate.
        ramp = (orig / wavelen - lo_f) / (hi_f - lo_f)
        smooth = np.clip(ramp, 0.0, 1.0)
        scaled = inv_freq * (smooth + (1.0 - smooth) / factor)
        return scaled.astype(np.float32)
    raise ValueError(f"unsupported rope_scaling type {kind!r} "
                     "(supported: llama3, linear)")


@functools.lru_cache(maxsize=None)
def _inv_freq_table(head_dim: int, theta: float, scaling: Optional[tuple],
                    device: torch.device) -> torch.Tensor:
    """``scaled_inv_freq`` as an fp32 tensor on ``device``, uploaded once:
    a forward captured in a CUDA graph may not copy from pageable host
    memory, and the table is the same for every forward of a model."""
    return torch.from_numpy(scaled_inv_freq(
        head_dim, theta, dict(scaling) if scaling else None)).to(device)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 scaling: Optional[dict] = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """positions: [...] int -> fp32 cos/sin of shape [..., head_dim//2]."""
    inv_freq = _inv_freq_table(
        head_dim, float(theta),
        tuple(sorted(scaling.items())) if scaling else None,
        positions.device)
    angles = positions.to(torch.float32)[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: [..., n_heads, head_dim]; cos/sin: [..., head_dim//2] (broadcast
    over the heads axis). Half-split rotation:
    (x1, x2) -> (x1*c - x2*s, x2*c + x1*s), in fp32, cast back to x's dtype.
    """
    half = x.shape[-1] // 2
    x1 = x[..., :half]
    x2 = x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)
