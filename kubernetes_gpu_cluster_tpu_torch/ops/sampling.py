"""Token sampling on the engine's device: greedy / temperature / top-k / top-p.

Runs on the same device as the forward step, so no [B, V] logits cross to
the host. All sampling params are per-row tensors, so one step serves
heterogeneous requests. What a batch needs (any sampled row, any filter,
alternatives) is decided by the caller from the HOST copy of those params
and passed as Python flags: the device never has to report back before
sampling.

Seeded rows: the JAX package derives per-row keys with threefry
``fold_in(seed, position)``. Here each row's noise comes from a
counter-based integer hash of (seed, absolute position of the sampled
token, vocab index), and the draw is Gumbel-max: ``argmax(logits + g)``
with ``g = -log(-log(u))`` is an exact sample of ``softmax(logits)``. The
same seed and position give the same token in any batch, on any engine
(same property as the JAX draw; not the same bits). Speculative
verification (``spec_verify_sample``) draws its acceptance uniform and its
residual/bonus noise from two further streams of the same row key, so a
seeded row's outcome at a position is as independent of the batch.
"""

from __future__ import annotations

from typing import Optional

import torch

# Width of the first top-k window. Serving-realistic top_k values and top-p
# prefixes of peaked distributions fit; wider rows go to the wide window,
# then to the exact full sort (see _apply_filters).
TOP_K_CAP = 128
# Second-tier window for rows the 128-wide pass cannot resolve: on 128k
# vocabularies it replaces a full [B, V] sort with one more top-k.
TOP_K_CAP_WIDE = 2048

# OpenAI completions expose at most 5 alternatives per token.
TOP_LOGPROBS = 5

_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """32-bit avalanche hash of int64 tensors holding values in [0, 2^32).
    Both multipliers are below 2^31, so no product leaves int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x1B873593) & _M32
    return x ^ (x >> 16)


def row_sample_keys(step_key: int, seed: torch.Tensor,
                    pos_next: torch.Tensor) -> torch.Tensor:
    """Per-row 32-bit keys [B] (int64). Rows with seed >= 0 derive from
    (seed, absolute position of the sampled token) only — the same request
    with the same seed reproduces its tokens across engines, batches and
    window boundaries. Rows with seed < 0 derive from the engine's
    per-step ``step_key`` (drawn from its torch.Generator), the row and the
    position — fresh randomness every step."""
    seed = seed.to(torch.int64)
    pos = pos_next.to(torch.int64) & _M32
    rows = torch.arange(seed.shape[0], device=seed.device, dtype=torch.int64)
    seeded = _mix32(_mix32((seed.clamp(min=0) & _M32) ^ 0x5EED1234) ^ pos)
    unseeded = _mix32(_mix32((int(step_key) & _M32) ^ _mix32(rows + 0x632BE5AB))
                      ^ pos)
    return torch.where(seed >= 0, seeded, unseeded)


# Stream salts of a verify step's two draws from one row key: the
# acceptance uniform and the residual (or bonus) Gumbel noise.
_ACCEPT_SALT = 0x0ACC3E77
_RESIDUAL_SALT = 0x5E5D0A11


def _unit_uniform(bits: torch.Tensor) -> torch.Tensor:
    """32-bit hashes -> fp32 uniforms in (0, 1): the top 24 bits, centred."""
    return ((bits >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def gumbel_noise(keys: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """[B, V] fp32 standard Gumbel noise, a pure function of (row key,
    vocab index)."""
    cols = _mix32(torch.arange(vocab_size, device=keys.device,
                               dtype=torch.int64) + 0x2545F491)
    bits = _mix32(keys.to(torch.int64)[:, None] ^ cols)
    return -torch.log(-torch.log(_unit_uniform(bits)))


def _filter_thresholds_sorted(sorted_logits: torch.Tensor, k: torch.Tensor,
                              top_p: torch.Tensor, lse: torch.Tensor):
    """Shared top-k/top-p threshold math on DESCENDING-sorted (or top-W
    truncated) logits. ``lse`` is the logsumexp of the post-top-k row (the
    renormalizer of the post-top-k distribution, vLLM order). Returns
    (k_thresh, p_thresh, cum_mass_covered)."""
    W = sorted_logits.shape[-1]
    k_idx = (torch.clamp(k, 1, W) - 1).to(torch.int64)
    k_thresh_w = torch.gather(sorted_logits, 1, k_idx[:, None])
    neg_inf = torch.full_like(k_thresh_w, float("-inf"))
    # Rows whose k exceeds the window have no in-window threshold.
    k_thresh = torch.where(k[:, None] <= W, k_thresh_w, neg_inf)
    pos = torch.arange(W, device=sorted_logits.device)[None, :]
    k_sorted = torch.where(pos < k[:, None], sorted_logits,
                           torch.full_like(sorted_logits, float("-inf")))
    sorted_probs = torch.exp(k_sorted - lse[:, None])
    cumsum = torch.cumsum(sorted_probs, dim=-1)
    # Number of tokens needed to reach mass top_p (always keep >= 1).
    keep = torch.clamp(
        torch.sum(cumsum - sorted_probs < top_p[:, None], dim=-1), 1, W)
    p_thresh = torch.gather(k_sorted, 1, (keep - 1)[:, None].to(torch.int64))
    # A disabled row (top_p >= 1) must not be clamped to the window width.
    p_thresh = torch.where(top_p[:, None] >= 1.0, neg_inf, p_thresh)
    return k_thresh, p_thresh, cumsum[:, -1]


def _apply_filters(scaled: torch.Tensor, top_k: torch.Tensor,
                   top_p: torch.Tensor) -> torch.Tensor:
    """Top-k + top-p filtering (masked entries -> -inf). top_k: [B] int, 0 =>
    disabled; top_p: [B] float, 1.0 => disabled.

    First tier: one ``topk`` to TOP_K_CAP plus a full-row logsumexp, so the
    top-p mass is measured against the EXACT post-top-k distribution. When
    some row needs tokens beyond the window (top_k > cap, or a top-p prefix
    wider than the cap) the wide window is tried, then the full sort. The
    choice between tiers reads one flag back from the device; it is made
    only for batches that filter at all."""
    V = scaled.shape[-1]
    k = torch.clamp(torch.where(top_k <= 0, torch.full_like(top_k, V), top_k),
                    1, V)
    neg_inf = float("-inf")

    def full_sort(s):
        sorted_logits = torch.sort(s, dim=-1, descending=True).values
        pos = torch.arange(V, device=s.device)[None, :]
        lse = torch.logsumexp(
            torch.where(pos < k[:, None], sorted_logits,
                        torch.full_like(sorted_logits, neg_inf)), dim=-1)
        k_t, p_t, _ = _filter_thresholds_sorted(sorted_logits, k, top_p, lse)
        return torch.maximum(k_t, p_t)

    def cut(s, thresh):
        return torch.where(s < thresh, torch.full_like(s, neg_inf), s)

    if V <= TOP_K_CAP:
        return cut(scaled, full_sort(scaled))

    def window_thresholds(s, W):
        top_vals = torch.topk(s, W, dim=-1).values             # [B, W] desc
        k_in = k <= W
        pos = torch.arange(W, device=s.device)[None, :]
        lse_win = torch.logsumexp(
            torch.where(pos < k[:, None], top_vals,
                        torch.full_like(top_vals, neg_inf)), dim=-1)
        lse = torch.where(k_in, lse_win, torch.logsumexp(s, dim=-1))
        k_t, p_t, covered = _filter_thresholds_sorted(top_vals, k, top_p, lse)
        ok = torch.all((k_in | (k >= V))
                       & ((top_p >= 1.0) | (covered >= top_p)))
        return torch.maximum(k_t, p_t), bool(ok)

    thresh, ok = window_thresholds(scaled, TOP_K_CAP)
    if ok:
        return cut(scaled, thresh)
    if V > TOP_K_CAP_WIDE:
        thresh, ok = window_thresholds(scaled, TOP_K_CAP_WIDE)
        if ok:
            return cut(scaled, thresh)
    return cut(scaled, full_sort(scaled))


def apply_penalties(logits: torch.Tensor, counts: torch.Tensor,
                    presence: torch.Tensor,
                    frequency: torch.Tensor) -> torch.Tensor:
    """OpenAI/vLLM presence+frequency penalties over the GENERATED text
    (output tokens only), applied to the raw logits before temperature.
    counts: [B, V] int occurrence counts of output tokens so far."""
    c = counts.to(logits.dtype)
    return (logits - presence[:, None] * (c > 0).to(logits.dtype)
            - frequency[:, None] * c)


def apply_logit_bias(logits: torch.Tensor, bias_ids: torch.Tensor,
                     bias_vals: torch.Tensor) -> torch.Tensor:
    """OpenAI ``logit_bias``: per-request sparse additive bias on the raw
    logits. bias_ids [B, K] (-1 = empty slot), bias_vals [B, K]."""
    valid = bias_ids >= 0
    ids = torch.where(valid, bias_ids, torch.zeros_like(bias_ids))
    vals = torch.where(valid, bias_vals, torch.zeros_like(bias_vals))
    return logits.scatter_add(1, ids.to(torch.int64), vals.to(logits.dtype))


def build_counts(out_tokens: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """[B, CAP] -1-padded output-token ids -> [B, V] int32 counts."""
    valid = out_tokens >= 0
    ids = torch.where(valid, out_tokens, torch.zeros_like(out_tokens))
    zeros = torch.zeros((out_tokens.shape[0], vocab_size), dtype=torch.int32,
                        device=out_tokens.device)
    return zeros.scatter_add(1, ids.to(torch.int64), valid.to(torch.int32))


def bump_counts(counts: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Register one freshly sampled token per row."""
    return counts.scatter_add(
        1, tokens.to(torch.int64)[:, None],
        torch.ones((tokens.shape[0], 1), dtype=counts.dtype,
                   device=counts.device))


def _chosen_logprobs(logits: torch.Tensor,
                     tokens: torch.Tensor) -> torch.Tensor:
    """log softmax(logits)[tokens]: [B, V] f32, [B] int -> [B] f32."""
    shifted = logits - torch.max(logits, dim=-1, keepdim=True).values
    lse = torch.log(torch.sum(torch.exp(shifted), dim=-1))
    chosen = torch.gather(shifted, 1, tokens.to(torch.int64)[:, None])[:, 0]
    return chosen - lse


def top_logprobs(logits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(ids [B, TOP_LOGPROBS] int32, logprobs [B, TOP_LOGPROBS] f32) of the
    most likely tokens under log-softmax(logits)."""
    lps = torch.log_softmax(logits.to(torch.float32), dim=-1)
    vals, ids = torch.topk(lps, TOP_LOGPROBS, dim=-1)
    return ids.to(torch.int32), vals


def gated_top_logprobs(logits: torch.Tensor, want: bool):
    """top_logprobs when some row asked for alternatives, else zero-fills
    the host never reads."""
    if want:
        return top_logprobs(logits)
    B = logits.shape[0]
    return (torch.zeros((B, TOP_LOGPROBS), dtype=torch.int32,
                        device=logits.device),
            torch.zeros((B, TOP_LOGPROBS), dtype=torch.float32,
                        device=logits.device))


def token_logprobs(logits: torch.Tensor, tokens: torch.Tensor,
                   temperature: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Log-probability of each chosen token under the unfiltered,
    temperature-scaled distribution (raw for temperature <= 0)."""
    if temperature is not None:
        safe = torch.where(temperature <= 0, torch.ones_like(temperature),
                           temperature)
        logits = logits / safe[:, None]
    return _chosen_logprobs(logits, tokens)


def sample_and_logprobs(
    logits: torch.Tensor,        # [B, V]
    keys: torch.Tensor,          # [B] row keys (row_sample_keys)
    temperature: torch.Tensor,   # [B] float; 0 => greedy
    top_k: torch.Tensor,         # [B] int; 0 => disabled
    top_p: torch.Tensor,         # [B] float; 1.0 => disabled
    *,
    any_sampled: bool,
    needs_filter: bool,
    with_top: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (token ids [B] int32, chosen-token logprobs [B] f32,
    top ids [B, 5], top logprobs [B, 5]).

    Greedy rows (temperature <= 0) ignore the noise and report logprobs of
    the raw distribution; sampled rows report logprobs under the
    temperature-scaled (pre-truncation, vLLM-order) distribution. A batch
    with no sampled row (``any_sampled`` False, from the host copy of the
    params) pays for an argmax and one logsumexp only: no sort, no noise.
    ``needs_filter`` gates the top-k/top-p stage the same way."""
    logits = logits.to(torch.float32)
    greedy_ids = torch.argmax(logits, dim=-1).to(torch.int32)
    if not any_sampled:
        return (greedy_ids, _chosen_logprobs(logits, greedy_ids),
                *gated_top_logprobs(logits, with_top))
    safe_temp = torch.where(temperature <= 0, torch.ones_like(temperature),
                            temperature)
    scaled = logits / safe_temp[:, None]
    filtered = _apply_filters(scaled, top_k, top_p) if needs_filter else scaled
    ids = torch.argmax(filtered + gumbel_noise(keys, logits.shape[-1]),
                       dim=-1).to(torch.int32)
    ids = torch.where(temperature <= 0, greedy_ids, ids)
    return (ids, _chosen_logprobs(scaled, ids),
            *gated_top_logprobs(scaled, with_top))


def sample_tokens(logits: torch.Tensor, keys: torch.Tensor,
                  temperature: torch.Tensor, top_k: torch.Tensor,
                  top_p: torch.Tensor, *, any_sampled: bool,
                  needs_filter: bool) -> torch.Tensor:
    """Sampled token ids only (``sample_and_logprobs`` without the
    logprobs)."""
    return sample_and_logprobs(logits, keys, temperature, top_k, top_p,
                               any_sampled=any_sampled,
                               needs_filter=needs_filter)[0]


def spec_verify_sample(
    logits: torch.Tensor,        # [B, S, V] f32, bias already applied
    drafts: torch.Tensor,        # [B, S-1] int draft tokens d_1..d_k
    pos0: torch.Tensor,          # [B] absolute position of the first emitted token
    step_key: int,               # the engine's per-step key
    seed: torch.Tensor,          # [B] int; -1 = unseeded
    temperature: torch.Tensor,   # [B]; 0 => greedy (exact-match acceptance)
    top_k: torch.Tensor,         # [B]; 0 => disabled
    top_p: torch.Tensor,         # [B]; 1.0 => disabled
    presence: torch.Tensor,      # [B]
    frequency: torch.Tensor,     # [B]
    counts: Optional[torch.Tensor],  # [B, V] output-token histogram, or None
    *,
    any_sampled: bool,
    needs_filter: bool,
    any_pen: bool,
    with_top: bool = False,
) -> tuple[torch.Tensor, ...]:
    """Lossless draft acceptance over one verify step's logits.

    Position j's logits define the target distribution p_j through the
    non-spec pipeline: penalties on the raw logits (counts advanced with
    each emitted token, as the decode window bumps them per substep),
    temperature, then top-k/top-p. For j = 0..k-1 while a row's chain is
    alive:

    - greedy rows accept d_{j+1} iff it is the argmax; on a mismatch the
      argmax is emitted (identical to non-spec greedy);
    - sampled rows accept with probability p_j(d_{j+1}) (one-hot drafts:
      Leviathan's min(1, p/q) is p(d)); on rejection they emit a sample of
      p_j with the draft masked out. Either way the token is distributed
      exactly as p_j. The uniform and the residual's Gumbel noise come
      from two streams of the row's key at position ``pos0 + j``
      (``row_sample_keys``), so a seeded row's outcome depends on its seed
      and position only.

    The first rejection ends the chain (later columns are garbage the host
    discards). A chain that survives all k drafts draws one bonus token
    from the last position (the residual stream, nothing masked). A draft
    outside the vocabulary is never accepted.

    The flags (any sampled row, any filter, any penalty, alternatives
    wanted) come from the host copy of the params, as in
    ``sample_and_logprobs``. Returns (tokens [B, S] int32, n_accepted [B]
    int32, logprobs [B, S], top ids [B, S, 5], top logprobs [B, S, 5]),
    logprobs under the temperature-scaled pre-truncation distribution
    (raw for greedy rows)."""
    B, S, V = logits.shape
    logits = logits.to(torch.float32)
    is_greedy = temperature <= 0
    safe_temp = torch.where(is_greedy, torch.ones_like(temperature),
                            temperature)
    vocab = torch.arange(V, device=logits.device)

    def target(raw, counts):
        pen = (apply_penalties(raw, counts, presence, frequency)
               if any_pen else raw)
        scaled = pen / safe_temp[:, None]
        filtered = (_apply_filters(scaled, top_k, top_p) if needs_filter
                    else scaled)
        return pen, scaled, filtered

    def residual_noise(keys):
        return gumbel_noise(_mix32(keys ^ _RESIDUAL_SALT), V)

    alive = torch.ones(B, dtype=torch.bool, device=logits.device)
    n_acc = torch.zeros(B, dtype=torch.int32, device=logits.device)
    toks, lps, tids, tlps = [], [], [], []
    for j in range(S - 1):
        pen, scaled, filtered = target(logits[:, j], counts)
        greedy_ids = torch.argmax(pen, dim=-1).to(torch.int32)
        d = drafts[:, j].to(torch.int32)
        accept = d == greedy_ids
        replacement = greedy_ids
        if any_sampled:
            keys = row_sample_keys(step_key, seed, pos0 + j)
            is_d = vocab[None, :] == d[:, None].to(torch.int64)   # [B, V]
            p_d = torch.sum(torch.softmax(filtered, dim=-1) * is_d, dim=-1)
            u = _unit_uniform(_mix32(keys ^ _ACCEPT_SALT))
            residual = filtered.masked_fill(is_d, float("-inf"))
            res_ids = torch.argmax(residual + residual_noise(keys),
                                   dim=-1).to(torch.int32)
            # The draft held all the remaining mass (a +100 logit_bias, say):
            # rejection has probability ~0; keep the draft.
            res_ok = torch.isfinite(torch.max(residual, dim=-1).values)
            accept = torch.where(is_greedy, accept, u < p_d)
            replacement = torch.where(
                is_greedy, greedy_ids, torch.where(res_ok, res_ids, d))
        accept = accept & alive
        emitted = torch.where(accept, d, replacement)
        if any_pen:
            counts = counts.scatter_add(
                1, emitted.to(torch.int64)[:, None],
                alive.to(counts.dtype)[:, None])
        toks.append(emitted)
        lps.append(_chosen_logprobs(scaled, emitted))
        tid, tlp = gated_top_logprobs(scaled, with_top)
        tids.append(tid)
        tlps.append(tlp)
        alive = accept
        n_acc = n_acc + accept.to(torch.int32)

    # Bonus token from the last position (used only where the whole chain
    # survived; the host discards it otherwise).
    pen, scaled, filtered = target(logits[:, -1], counts)
    bonus = torch.argmax(pen, dim=-1).to(torch.int32)
    if any_sampled:
        keys = row_sample_keys(step_key, seed, pos0 + (S - 1))
        sampled = torch.argmax(filtered + residual_noise(keys),
                               dim=-1).to(torch.int32)
        bonus = torch.where(is_greedy, bonus, sampled)
    toks.append(bonus)
    lps.append(_chosen_logprobs(scaled, bonus))
    tid, tlp = gated_top_logprobs(scaled, with_top)
    tids.append(tid)
    tlps.append(tlp)
    return (torch.stack(toks, dim=1), n_acc, torch.stack(lps, dim=1),
            torch.stack(tids, dim=1), torch.stack(tlps, dim=1))
