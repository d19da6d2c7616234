"""Draft proposers for speculative decoding.

A proposer is HOST-side and must be cheap: it runs once per running
sequence per spec step, on the critical path between device dispatches.
The contract is deliberately loose — any callable object with
``propose(token_ids) -> list[int]`` works — so a draft-model proposer can
slot in later without touching the verifier or the device program.

Losslessness does NOT depend on draft quality: the verifier's
accept/resample rule preserves the target distribution for ANY proposed
tokens (a one-hot draft distribution q makes the Leviathan residual
``norm(max(p - q, 0))`` collapse to "p with the draft masked out", and
``p(d) + (1 - p(d)) * p(t)/(1 - p(d)) = p(t)`` for every t != d). Bad
drafts only cost acceptance rate, never correctness.
"""

from __future__ import annotations


class DraftProposer:
    """Base proposer interface. ``propose`` returns UP TO ``k`` draft
    token ids continuing ``token_ids`` (fewer — including zero — is fine;
    the verifier pads the slice). ``self.k`` is the proposer's CEILING;
    the verifier may ask for fewer via ``propose_batch(seqs, k)`` when the
    acceptance-adaptive controller has throttled the step's depth."""

    def __init__(self, k: int):
        if k < 1:
            raise ValueError(f"num_speculative_tokens must be >= 1, got {k}")
        self.k = k

    def propose(self, token_ids: list[int]) -> list[int]:
        raise NotImplementedError

    def propose_batch(self, seqs, k: int) -> list[list[int]]:
        """Drafts for every scheduled row of one spec step, ``k <= self.k``
        tokens each. Host-side proposers derive this from per-row
        ``propose``; the draft-model runner OVERRIDES it (its k decode
        dispatches are batched across rows, and it needs request identity
        to keep its own KV pool in sync)."""
        return [self.propose(seq.all_token_ids)[:k] for seq in seqs]

    def retain(self, live_request_ids) -> None:
        """Lifecycle seam, called once per spec round with the scheduler's
        RUNNING request ids: stateful proposers drop (and free) per-request
        state for anything no longer running. No-op for host-side
        proposers. This — like every ``propose*`` call — is part of the
        ONE sanctioned seam through which engine/scheduler code touches
        draft state (the KGCT017 draft-state-boundary lint rule polices
        direct reaches into the draft pool)."""


class NgramProposer(DraftProposer):
    """Prompt-lookup / n-gram drafting: match the sequence's trailing
    n-gram (n from ``ngram_max`` down to ``ngram_min``) against its OWN
    prompt+output history and draft the k tokens that followed the most
    recent earlier occurrence. Zero model weights, high acceptance on
    extractive/repetitive continuations (summarization, code edits,
    structured output), useless-but-harmless on fresh text.
    """

    def __init__(self, k: int, ngram_max: int = 3, ngram_min: int = 1):
        super().__init__(k)
        if not (1 <= ngram_min <= ngram_max):
            raise ValueError(
                f"need 1 <= ngram_min <= ngram_max, got "
                f"({ngram_min}, {ngram_max})")
        self.ngram_max = ngram_max
        self.ngram_min = ngram_min

    def propose(self, token_ids: list[int]) -> list[int]:
        L = len(token_ids)
        for n in range(min(self.ngram_max, L - 1), self.ngram_min - 1, -1):
            suffix = token_ids[L - n:]
            # Most recent earlier occurrence: scan match starts right to
            # left. The suffix occurrence at L-n itself is excluded (its
            # continuation is the future we are trying to predict).
            for start in range(L - n - 1, -1, -1):
                if token_ids[start:start + n] == suffix:
                    cont = token_ids[start + n:start + n + self.k]
                    if cont:
                        return list(cont)
        return []


def build_proposer(scheduler_config) -> DraftProposer:
    """HOST-side proposer for a SchedulerConfig. The draft-MODEL proposer
    (``spec_draft_model``) is installed by the ENGINE over this one —
    building it needs model params, the KV geometry and the jit policy,
    none of which the scheduler owns (engine/spec/draft_model.py)."""
    return NgramProposer(scheduler_config.effective_spec_k_max,
                         ngram_max=scheduler_config.spec_ngram_max,
                         ngram_min=scheduler_config.spec_ngram_min)
