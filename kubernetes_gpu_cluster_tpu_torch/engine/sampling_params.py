"""Per-request sampling parameters (OpenAI-API-compatible subset).

Matches the request surface the reference's vLLM router exposed on
:30080 (reference ``old_README.md:1472-1476``): temperature, top_p, top_k,
max_tokens, stop, greedy when temperature == 0, presence/frequency
penalties over the generated text (vLLM semantics: output tokens only,
applied before temperature scaling), and a per-request ``seed`` for
reproducible sampling.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

# OpenAI's logit_bias key cap; also sizes the engine's device-side sparse
# bias buffers (engine/engine.py).
LOGIT_BIAS_CAP = 300


@dataclasses.dataclass
class SamplingParams:
    max_tokens: int = 128
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0                 # 0 = disabled
    stop_token_ids: Sequence[int] = ()
    ignore_eos: bool = False
    logprobs: bool = False
    presence_penalty: float = 0.0   # [-2, 2]; flat penalty on seen tokens
    frequency_penalty: float = 0.0  # [-2, 2]; scales with occurrence count
    seed: Optional[int] = None      # reproducible sampling per request
    # OpenAI logit_bias: token id -> additive bias [-100, 100], <= 300 keys.
    logit_bias: Optional[dict] = None
    # OpenAI completions logprobs=N alternatives (0..5); requires logprobs.
    top_logprobs: int = 0
    # Multi-tenant QoS tier (priority class) this request belongs to —
    # resolved and VALIDATED at the serving layer (header > user pin >
    # default) against the engine's configured tiers; None when QoS is off
    # or unresolved (the scheduler then applies its default tier). Rides
    # to_state/from_state so a migrated stream keeps its class.
    qos_tier: Optional[str] = None

    def __post_init__(self):
        if self.max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if not (0 < self.top_p <= 1.0):
            raise ValueError("top_p must be in (0, 1]")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0")
        if not (-2.0 <= self.presence_penalty <= 2.0):
            raise ValueError("presence_penalty must be in [-2, 2]")
        if not (-2.0 <= self.frequency_penalty <= 2.0):
            raise ValueError("frequency_penalty must be in [-2, 2]")
        if self.seed is not None and not isinstance(self.seed, int):
            raise ValueError("seed must be an integer")
        if self.qos_tier is not None and not isinstance(self.qos_tier, str):
            raise ValueError("qos_tier must be a string tier name")
        if not (0 <= self.top_logprobs <= 5):
            raise ValueError("top_logprobs must be in [0, 5]")
        if self.top_logprobs and not self.logprobs:
            raise ValueError("top_logprobs requires logprobs")
        if self.logit_bias is not None:
            if not isinstance(self.logit_bias, dict):
                raise ValueError("logit_bias must be a map of token id -> "
                                 "bias")
            if len(self.logit_bias) > LOGIT_BIAS_CAP:
                raise ValueError(
                    f"logit_bias supports at most {LOGIT_BIAS_CAP} tokens")
            clean = {}
            for k, v in self.logit_bias.items():
                try:
                    tok, bias = int(k), float(v)
                except (TypeError, ValueError):
                    raise ValueError(
                        "logit_bias keys must be token ids and values "
                        "numbers") from None
                if tok < 0:
                    raise ValueError("logit_bias token ids must be >= 0")
                if not (-100.0 <= bias <= 100.0):
                    raise ValueError("logit_bias values must be in "
                                     "[-100, 100]")
                clean[tok] = bias
            self.logit_bias = clean

    def to_state(self) -> dict:
        """JSON-serializable snapshot for the live-migration export: the
        byte-identity of a resumed stream depends on EVERY sampling knob
        (seed, penalties, bias, stop set) surviving the hop."""
        d = dataclasses.asdict(self)
        d["stop_token_ids"] = list(self.stop_token_ids)
        return d

    @staticmethod
    def from_state(d: dict) -> "SamplingParams":
        """Inverse of :meth:`to_state`. JSON round-trips logit_bias keys to
        strings; __post_init__ re-ints them."""
        kw = dict(d)
        kw["stop_token_ids"] = tuple(kw.get("stop_token_ids") or ())
        return SamplingParams(**kw)
