"""Token sampling on the engine's device: greedy / temperature / top-k / top-p.

Runs on the same device as the forward step, so no [B, V] logits cross to
the host. All sampling params are per-row tensors, so one step serves
heterogeneous requests. What a batch needs (any sampled row, any filter,
any penalty, alternatives) is decided from the HOST copy of those params,
by the JAX programs' own conditions, and passed as flags: host bools (a
Python branch) or ``gates.Flag``s, which a captured step program turns into
CUDA-graph conditional nodes on the flags' device copies (``ops/gates.py``),
so one program skips a stage whenever the step's flag says so, as the JAX
program's ``lax.cond`` does. Nothing here reads a device value on the
host: a captured graph could not.

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

from typing import Optional, Union

import torch

from . import gates
from .gates import Flag, when

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


def row_sample_keys(step_key: int | torch.Tensor, seed: torch.Tensor,
                    pos_next: torch.Tensor) -> torch.Tensor:
    """Per-row 32-bit keys [B] (int64). Rows with seed >= 0 derive from
    (seed, absolute position of the sampled token) only — the same request
    with the same seed reproduces its tokens across engines, batches and
    window boundaries. Rows with seed < 0 derive from the engine's
    per-step ``step_key`` (drawn from its torch.Generator), the row and the
    position — fresh randomness every step. ``step_key`` is a Python int
    or a one-element integer tensor on the rows' device (a captured
    window's static input, refilled before every replay: a Python int
    would be a constant of the graph); both give the same keys."""
    seed = seed.to(torch.int64)
    pos = pos_next.to(torch.int64) & _M32
    rows = torch.arange(seed.shape[0], device=seed.device, dtype=torch.int64)
    if isinstance(step_key, torch.Tensor):
        step_key = step_key.to(torch.int64)
    seeded = _mix32(_mix32((seed.clamp(min=0) & _M32) ^ 0x5EED1234) ^ pos)
    unseeded = _mix32(_mix32((step_key & _M32) ^ _mix32(rows + 0x632BE5AB))
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


def _filter_thresholds(scaled: torch.Tensor, top_k: torch.Tensor,
                       top_p: torch.Tensor) -> torch.Tensor:
    """[B, 1] top-k + top-p cut of each row: entries below it are filtered.
    top_k: [B] int, 0 => disabled; top_p: [B] float, 1.0 => disabled.

    First tier: one ``topk`` to TOP_K_CAP plus a full-row logsumexp, so the
    top-p mass is measured against the EXACT post-top-k distribution. When
    some row needs tokens beyond the window (top_k > cap, or a top-p prefix
    wider than the cap) the wide window is taken, then the full sort. The
    choice is made on the device, for the batch as a whole, as the JAX
    ``lax.cond``s on ``ok`` and ``ok_w`` make it: inside a captured program
    each later tier is a conditional node on the tier before it
    (``gates.when_device``), so the [B, V] sort runs only in a step that
    needs it; eagerly every tier is computed and ``torch.where`` on each
    tier's all-rows flag picks the thresholds (the same cut, no read-back)."""
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

    if V <= TOP_K_CAP:
        return full_sort(scaled)

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
        return torch.maximum(k_t, p_t), ok

    if gates.in_capture():
        thresh, ok = window_thresholds(scaled, TOP_K_CAP)

        def wide_tier():
            if V <= TOP_K_CAP_WIDE:
                thresh.copy_(full_sort(scaled))
                return
            wide, ok_w = window_thresholds(scaled, TOP_K_CAP_WIDE)
            thresh.copy_(wide)
            gates.when_device(ok_w, lambda: thresh.copy_(full_sort(scaled)),
                              negate=True)
        gates.when_device(ok, wide_tier, negate=True)
        return thresh
    thresh = full_sort(scaled)
    if V > TOP_K_CAP_WIDE:
        wide, ok = window_thresholds(scaled, TOP_K_CAP_WIDE)
        thresh = torch.where(ok, wide, thresh)
    narrow, ok = window_thresholds(scaled, TOP_K_CAP)
    return torch.where(ok, narrow, thresh)


def _apply_filters(scaled: torch.Tensor, top_k: torch.Tensor,
                   top_p: torch.Tensor) -> torch.Tensor:
    """Top-k + top-p filtering (masked entries -> -inf) by
    ``_filter_thresholds``."""
    thresh = _filter_thresholds(scaled, top_k, top_p)
    return torch.where(scaled < thresh, torch.full_like(scaled, float("-inf")),
                       scaled)


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


def write_top_logprobs(logits: torch.Tensor, want: Union[bool, Flag],
                       ids: torch.Tensor, lps: torch.Tensor) -> None:
    """``top_logprobs`` into ``ids`` / ``lps`` where some row asked for
    alternatives, else the zeros the JAX false branch returns (the host
    never reads them)."""
    def top():
        i, v = top_logprobs(logits)
        ids.copy_(i)
        lps.copy_(v)

    def zeros():
        ids.zero_()
        lps.zero_()
    when("top_logprobs", want, top, zeros)


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
    any_sampled: Union[bool, Flag],
    needs_filter: Union[bool, Flag],
    with_top: Union[bool, Flag] = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (token ids [B] int32, chosen-token logprobs [B] f32,
    top ids [B, 5], top logprobs [B, 5]).

    Greedy rows (temperature <= 0) ignore the noise and report logprobs of
    the raw distribution; sampled rows report logprobs under the
    temperature-scaled (pre-truncation, vLLM-order) distribution. The
    stages are gated as the JAX function's ``lax.cond``s gate them: a batch
    with no sampled row (``any_sampled``) pays for an argmax and one
    logsumexp only, no sort and no noise; ``needs_filter`` gates the
    top-k/top-p stage inside the sampled path, ``with_top`` the
    alternatives. Flags are host bools (a static branch) or ``Flag``s (a
    conditional node inside a captured program, ``ops/gates.py``)."""
    logits = logits.to(torch.float32)
    B, V = logits.shape
    dev = logits.device
    ids = torch.empty(B, dtype=torch.int32, device=dev)
    lps = torch.empty(B, dtype=torch.float32, device=dev)
    tids = torch.empty((B, TOP_LOGPROBS), dtype=torch.int32, device=dev)
    tlps = torch.empty((B, TOP_LOGPROBS), dtype=torch.float32, device=dev)

    def greedy_path():
        greedy_ids = torch.argmax(logits, dim=-1).to(torch.int32)
        ids.copy_(greedy_ids)
        lps.copy_(_chosen_logprobs(logits, greedy_ids))
        write_top_logprobs(logits, with_top, tids, tlps)

    def sampled_path():
        greedy_ids = torch.argmax(logits, dim=-1).to(torch.int32)
        safe_temp = torch.where(temperature <= 0,
                                torch.ones_like(temperature), temperature)
        scaled = logits / safe_temp[:, None]
        # argmax(filtered + g): the noise is added first and the filter's
        # cut masks the sum (-inf either way), so the filter stage can be
        # a node of its own.
        noisy = scaled + gumbel_noise(keys, V)
        when("filters", needs_filter, lambda: noisy.masked_fill_(
            scaled < _filter_thresholds(scaled, top_k, top_p),
            float("-inf")))
        drawn = torch.argmax(noisy, dim=-1).to(torch.int32)
        drawn = torch.where(temperature <= 0, greedy_ids, drawn)
        ids.copy_(drawn)
        lps.copy_(_chosen_logprobs(scaled, drawn))
        write_top_logprobs(scaled, with_top, tids, tlps)
    when("sampled", any_sampled, sampled_path, greedy_path)
    return ids, lps, tids, tlps


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
    step_key: int | torch.Tensor,  # the engine's per-step key (an int32
                                   # [1] tensor inside a captured program)
    seed: torch.Tensor,          # [B] int; -1 = unseeded
    temperature: torch.Tensor,   # [B]; 0 => greedy (exact-match acceptance)
    top_k: torch.Tensor,         # [B]; 0 => disabled
    top_p: torch.Tensor,         # [B]; 1.0 => disabled
    presence: torch.Tensor,      # [B]
    frequency: torch.Tensor,     # [B]
    counts: Optional[torch.Tensor],  # [B, V] output-token histogram, or None
    *,
    any_sampled: Union[bool, Flag],
    needs_filter: Union[bool, Flag],
    any_pen: Union[bool, Flag],
    with_top: Union[bool, Flag] = False,
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
    wanted) gate the stages where the JAX function's ``lax.cond``s gate
    them: penalties and the count bump at every position on ``any_pen``,
    the filter thresholds on ``needs_filter``, the sampled decision (and
    the sampled bonus) on ``any_sampled``, the alternatives on
    ``with_top``. ``counts`` may be None when ``any_pen`` is False; it is
    not written. Returns (tokens [B, S] int32, n_accepted [B] int32,
    logprobs [B, S], top ids [B, S, 5], top logprobs [B, S, 5]), logprobs
    under the temperature-scaled pre-truncation distribution (raw for
    greedy rows)."""
    B, S, V = logits.shape
    dev = logits.device
    logits = logits.to(torch.float32)
    is_greedy = temperature <= 0
    safe_temp = torch.where(is_greedy, torch.ones_like(temperature),
                            temperature)
    vocab = torch.arange(V, device=dev)
    neg_inf = float("-inf")
    cnt = None
    if counts is not None:
        cnt = torch.empty_like(counts)
        when("counts", any_pen, lambda: cnt.copy_(counts))
    toks = torch.empty((B, S), dtype=torch.int32, device=dev)
    lps = torch.empty((B, S), dtype=torch.float32, device=dev)
    tids = torch.empty((B, S, TOP_LOGPROBS), dtype=torch.int32, device=dev)
    tlps = torch.empty((B, S, TOP_LOGPROBS), dtype=torch.float32, device=dev)

    def target(j):
        """(penalized raw, scaled, the filter's cut [B, 1], -inf when no
        filter ran) at position j."""
        raw = logits[:, j]
        pen = torch.empty_like(raw)
        when("penalties", any_pen,
             lambda: pen.copy_(apply_penalties(raw, cnt, presence,
                                               frequency)),
             lambda: pen.copy_(raw))
        scaled = pen / safe_temp[:, None]
        thresh = torch.full((B, 1), neg_inf, device=dev)
        when("filters", needs_filter, lambda: thresh.copy_(
            _filter_thresholds(scaled, top_k, top_p)))
        return pen, scaled, thresh

    def cut(scaled, thresh):
        return torch.where(scaled < thresh, torch.full_like(scaled, neg_inf),
                           scaled)

    def residual_noise(keys):
        return gumbel_noise(_mix32(keys ^ _RESIDUAL_SALT), V)

    def emit(j, token, scaled):
        toks[:, j] = token
        lps[:, j] = _chosen_logprobs(scaled, token)
        write_top_logprobs(scaled, with_top, tids[:, j], tlps[:, j])

    alive = torch.ones(B, dtype=torch.bool, device=dev)
    n_acc = torch.zeros(B, dtype=torch.int32, device=dev)
    for j in range(S - 1):
        pen, scaled, thresh = target(j)
        greedy_ids = torch.argmax(pen, dim=-1).to(torch.int32)
        d = drafts[:, j].to(torch.int32)
        acc = torch.empty(B, dtype=torch.bool, device=dev)
        repl = torch.empty(B, dtype=torch.int32, device=dev)

        def sampled_decision(j=j, scaled=scaled, thresh=thresh, d=d,
                             acc=acc, repl=repl):
            keys = row_sample_keys(step_key, seed, pos0 + j)
            filtered = cut(scaled, thresh)
            is_d = vocab[None, :] == d[:, None].to(torch.int64)   # [B, V]
            p_d = torch.sum(torch.softmax(filtered, dim=-1) * is_d, dim=-1)
            u = _unit_uniform(_mix32(keys ^ _ACCEPT_SALT))
            residual = filtered.masked_fill(is_d, neg_inf)
            res_ids = torch.argmax(residual + residual_noise(keys),
                                   dim=-1).to(torch.int32)
            # The draft held all the remaining mass (a +100 logit_bias,
            # say): rejection has probability ~0; keep the draft.
            res_ok = torch.isfinite(torch.max(residual, dim=-1).values)
            acc.copy_(u < p_d)
            repl.copy_(torch.where(res_ok, res_ids, d))

        def greedy_only(d=d, greedy_ids=greedy_ids, acc=acc, repl=repl):
            acc.copy_(d == greedy_ids)
            repl.copy_(greedy_ids)
        when("sampled", any_sampled, sampled_decision, greedy_only)
        accept = torch.where(is_greedy, d == greedy_ids, acc) & alive
        emitted = torch.where(accept, d,
                              torch.where(is_greedy, greedy_ids, repl))
        when("count_bump", any_pen, lambda emitted=emitted, alive=alive:
             cnt.scatter_add_(1, emitted.to(torch.int64)[:, None],
                              alive.to(cnt.dtype)[:, None]))
        emit(j, emitted, scaled)
        alive = accept
        n_acc = n_acc + accept.to(torch.int32)

    # Bonus token from the last position (used only where the whole chain
    # survived; the host discards it otherwise).
    pen, scaled, thresh = target(S - 1)
    greedy_ids = torch.argmax(pen, dim=-1).to(torch.int32)
    bonus = torch.empty(B, dtype=torch.int32, device=dev)

    def sampled_bonus():
        keys = row_sample_keys(step_key, seed, pos0 + (S - 1))
        drawn = torch.argmax(cut(scaled, thresh) + residual_noise(keys),
                             dim=-1).to(torch.int32)
        bonus.copy_(torch.where(is_greedy, greedy_ids, drawn))
    when("sampled", any_sampled, sampled_bonus,
         lambda: bonus.copy_(greedy_ids))
    emit(S - 1, bonus, scaled)
    return toks, n_acc, lps, tids, tlps
