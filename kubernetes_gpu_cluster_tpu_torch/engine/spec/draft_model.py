"""Draft-MODEL proposer: two-model speculative decoding (Leviathan et al.).

The n-gram prompt-lookup proposer (proposer.py) is free but only drafts
where the sequence's own history repeats. A small DRAFT MODEL (e.g.
tinyllama drafting for llama-3-8b; the engine serves both) drafts
everywhere the two models agree, at a per-token cost of the small model's
decode step.

:class:`DraftModelRunner` runs that second model inside the SAME engine
process, on the engine's device, as a :class:`~.proposer.DraftProposer`:

- **Own paged KV pool.** The draft model keeps its own ``KVCache`` + page
  allocator (the target pool's page size, pages for max_num_seqs full
  sequences, capped on the card at half of the device memory left once the
  target pool exists). Nothing outside this module touches it: the engine
  and scheduler reach draft state only through the proposer seam
  (``propose_batch`` / ``retain``).

- **k batched decode dispatches per spec round.** One greedy single-token
  ``forward_decode`` over every spec row (padded to the target's decode
  bucket), k times a round. Everything a dispatch needs except its input
  tokens (positions, write slots, context lengths, committed tokens still
  to replay) is known on the host before the round, so the k dispatches are
  enqueued back to back, each feeding the previous one's argmax forward on
  the device, and the round's drafts cross to the host once. Greedy
  drafting keeps the proposal distribution q ONE-HOT, which is the case the
  verifier's lossless accept/resample rule is written for: draft quality
  moves the acceptance rate, never correctness. On the card the
  dispatches run the ``paged_decode`` kernel against the draft pool, the
  same wrapper the target's decode steps use against theirs.

- **Rollback-consistent draft KV.** The draft pool follows the target
  pool's append-only contract: per row, ``valid`` (the leading positions
  whose KV matches the target's COMMITTED tokens) and ``tail`` (draft
  tokens fed past it). The next round absorbs the tail by prefix-matching
  it against what the verifier committed: accepted drafts' KV is kept, and
  every rejected-draft slot sits at a position >= the next feed point, so
  it is overwritten before any dispatch reads it (reads stop at
  ``context_lens``). No draft KV is ever copied or rolled back.

- **Catch-up and reset.** Tokens committed by paths the draft never saw
  (prompt prefill, plain decode windows, resampled/bonus tokens) leave a
  gap ``g = num_tokens - valid``. Gaps up to k are absorbed by the round's
  own dispatches: the first g feeds replay committed tokens (their outputs
  are discarded but the last, which is the first draft) and the remaining
  outputs are drafts. Larger gaps re-ingest the whole history through
  ``forward_prefill_hist`` (one row per call, in chunks; on the card the
  ``flash_prefill_hist`` kernel against the draft pool) — first sight of a
  sequence, or recovery after speculation was off.

Not ported from the JAX package: the sanitizer's draft-pool shadow (the
runtime sanitizers are not ported yet).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ...config import CacheConfig, EngineConfig, ModelConfig, get_model_config
from ...models import llama as model_lib
from ...models.llama import DecodeMeta, PrefillMeta
from ...utils import cdiv, get_logger
from ...utils.math import next_power_of_2
from ..kv_cache import (PageAllocator, allocate_kv_cache,
                        kv_cache_bytes_per_page)
from .proposer import DraftProposer

logger = get_logger("spec.draft_model")


class _Row:
    """Per-request draft-pool state. ``owner`` guards request-id recycling:
    state must die with its Sequence object, not haunt a new request
    wearing the same id."""

    __slots__ = ("owner", "pages", "valid", "tail")

    def __init__(self, owner):
        self.owner = owner
        self.pages: list[int] = []
        self.valid = 0            # positions [0, valid) hold committed-matching KV
        self.tail: list[int] = []  # tokens fed at positions valid, valid+1, ...


def _common_prefix(a: list[int], b: list[int]) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def draft_pool_pages(want: int, free_bytes: Optional[int], page_bytes: int,
                     groups=None) -> int:
    """Pages of the draft KV pool: ``want`` (full coverage), capped on the
    card by half of the free memory ``free_bytes`` (None on the CPU: no
    cap). With ``groups`` the free bytes are the MIN over every rank, as
    the target pool's are (``derive_num_pages``): ranks that share a card
    read different free memory, and two draft pools of different sizes
    would run out of pages at different steps and leave lockstep."""
    if free_bytes is None:
        return want
    if groups is not None:
        free_bytes = groups.world_min(free_bytes)
    fit = (free_bytes // 2) // page_bytes
    if fit < want:
        logger.warning(
            "draft KV pool capped by free device memory: %d pages "
            "(full coverage wants %d); rows beyond the cap skip "
            "drafting", fit, want)
    return max(min(want, fit), 2)


class DraftModelRunner(DraftProposer):
    """See module docstring. Construct via :func:`build_draft_runner`."""

    def __init__(self, config: EngineConfig, draft_config: ModelConfig,
                 params=None, seed: Optional[int] = None,
                 device: torch.device | str = "cuda", groups=None):
        from ..engine import resolve_device

        target = config.model
        if draft_config.vocab_size != target.vocab_size:
            raise ValueError(
                f"draft model {draft_config.name!r} vocab "
                f"{draft_config.vocab_size} != target {target.name!r} vocab "
                f"{target.vocab_size} — drafts are target token ids")
        sc = config.scheduler
        super().__init__(sc.effective_spec_k_max)
        self.device = resolve_device(device)
        self.config = config
        self.draft_config = draft_config
        self.page_size = config.cache.page_size
        # Positions past the draft's own context window would run off its
        # position table; the draft horizon is the shorter of the two (feeds
        # beyond it route to the scrap page: lossless, the verify step just
        # sees poor drafts near the cap).
        self.max_len = min(config.effective_max_len,
                           draft_config.max_model_len)
        self.pages_bucket = cdiv(self.max_len, self.page_size)
        # Reset-prefill chunk widths: the runner's own pow-2 buckets, not the
        # target's prefill grid, which can be as coarse as (4096,); padding a
        # 60-token catch-up to 4096 tokens would cost two orders of
        # magnitude more than the history it ingests.
        self.chunk_buckets = tuple(
            b for b in (16, 32, 64, 128, 256, 512)
            if b <= max(next_power_of_2(self.max_len), 16))
        draft_cache = CacheConfig(page_size=self.page_size)
        # Full coverage (max_num_seqs full-horizon sequences), capped on the
        # card by half of the memory the target pool left: at a production
        # pairing full coverage would be tens of GB, and rows the pool
        # cannot hold sit spec rounds out (no drafts: lossless).
        num_pages = draft_pool_pages(
            sc.max_num_seqs * self.pages_bucket + 1,
            (torch.cuda.mem_get_info(self.device)[0]
             if self.device.type == "cuda" else None),
            kv_cache_bytes_per_page(draft_config, draft_cache), groups)
        self.kv_cache = allocate_kv_cache(draft_config, draft_cache,
                                          num_pages, self.device)
        self.allocator = PageAllocator(num_pages, self.page_size)
        if params is None:
            # Random weights in the draft's own dtype, from the seed, like
            # the target engine's.
            gen = torch.Generator(device=self.device).manual_seed(
                config.seed if seed is None else seed)
            params = model_lib.init_params(draft_config, gen, self.device)
        self.params = params
        self._rows: dict[str, _Row] = {}
        # Cumulative draft-model decode dispatches and reset prefills.
        self.num_dispatches = 0
        self.num_reset_prefills = 0
        logger.info("draft model %s: %d pages x %d tokens (draft KV pool)",
                    draft_config.name, num_pages, self.page_size)

    def _up(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- proposer seam -------------------------------------------------------

    def retain(self, live_request_ids) -> None:
        """Drop draft state (and free its pages) for requests no longer
        running. Preempted sequences are dropped too: they may be gone for
        many rounds, and their pages could starve the live rows; their
        return pays one reset prefill."""
        live = set(live_request_ids)
        for rid in [r for r in self._rows if r not in live]:
            row = self._rows.pop(rid)
            if row.pages:
                self.allocator.free(row.pages)

    def propose(self, token_ids: list[int]) -> list[int]:
        raise NotImplementedError(
            "DraftModelRunner drafts per batch (propose_batch) — per-row "
            "propose has no request identity to keep the draft pool in sync")

    def propose_batch(self, seqs, k: int) -> list[list[int]]:
        """Drafts for one spec round: sync each row's draft KV with the
        target's committed history, then k batched greedy decode
        dispatches (see the module docstring for the catch-up/absorb
        bookkeeping)."""
        from ..scheduler import _bucket

        k = min(int(k), self.k)
        if k < 1 or not seqs:
            return [[] for _ in seqs]
        ps = self.page_size
        max_len = self.max_len

        # -- absorb + plan ---------------------------------------------------
        active: list[int] = []
        queues: dict[int, list[int]] = {}
        for i, seq in enumerate(seqs):
            row = self._rows.get(seq.request_id)
            if row is None or row.owner is not seq:
                if row is not None and row.pages:   # recycled request id
                    self.allocator.free(row.pages)
                row = _Row(seq)
                self._rows[seq.request_id] = row
            ids = seq.all_token_ids
            n = seq.num_tokens
            if row.tail:
                row.valid += _common_prefix(row.tail, ids[row.valid:])
                row.tail = []
            row.valid = min(row.valid, n - 1)
            inert = False
            if n - row.valid > k:
                # Gap too wide for the round's own dispatches: re-ingest
                # through the chunked prefill. A full draft pool, or a
                # sequence past the draft's horizon, sits the round out (no
                # drafts; the verifier pads with lossless filler).
                inert = (not self._reset_row(seq, row)
                         or n - row.valid > k)
            if not inert:
                inert = not self._grow(row, min(row.valid + k, max_len))
            if not inert:
                active.append(i)
                queues[i] = list(ids[row.valid:n])

        drafts: list[list[int]] = [[] for _ in seqs]
        if not active:
            return drafts

        # -- the round's plan: dispatch j feeds position valid + j ----------
        B_pad = _bucket(len(active), self.config.scheduler.decode_buckets)
        forced = np.zeros((k, B_pad), np.int32)     # committed tokens to replay
        replay = np.zeros((k, B_pad), bool)
        replay[0] = True                            # padding rows: token 0
        positions = np.zeros((k, B_pad), np.int32)
        slots = np.zeros((k, B_pad), np.int32)      # padding -> scrap page
        context_lens = np.zeros((k, B_pad), np.int32)
        tables = np.zeros((B_pad, self.pages_bucket), np.int32)
        for b, i in enumerate(active):
            row, queue = self._rows[seqs[i].request_id], queues[i]
            tables[b, :len(row.pages)] = row.pages
            forced[:len(queue), b] = queue
            replay[:len(queue), b] = True
            for j in range(k):
                pos = row.valid + j
                pos_c = min(pos, max_len - 1)
                positions[j, b] = pos_c
                slots[j, b] = (row.pages[pos_c // ps] * ps + pos_c % ps
                               if pos < max_len else pos % ps)
                context_lens[j, b] = pos_c + 1
        out = self._dispatch(forced, replay, positions, slots, context_lens,
                             tables)

        for b, i in enumerate(active):
            row = self._rows[seqs[i].request_id]
            g = len(queues[i])
            n = seqs[i].num_tokens
            # Dispatch g-1 fed the last committed token: its output and all
            # later ones are drafts. Feeds past position n-1 (the k-g draft
            # feeds) form the tail the next round checks against what
            # committed.
            drafts[i] = [int(t) for t in out[g - 1:, b]]
            row.tail = drafts[i][:k - g]
            row.valid = n
        return drafts

    # -- internals -----------------------------------------------------------

    def _dispatch(self, forced, replay, positions, slots, context_lens,
                  tables) -> np.ndarray:
        """k greedy decode dispatches [k, B_pad] -> argmax ids [k, B_pad]:
        dispatch j's input token is ``forced[j]`` where ``replay[j]``, else
        dispatch j-1's output, chosen on the device. One fetch at the end."""
        cfg = self.draft_config
        forced, replay = self._up(forced), self._up(replay)
        positions, slots = self._up(positions), self._up(slots)
        context_lens, tables = self._up(context_lens), self._up(tables)
        outs = []
        tokens = forced[0]
        for j in range(forced.shape[0]):
            if j:
                tokens = torch.where(replay[j], forced[j], outs[-1])
            meta = DecodeMeta(positions=positions[j], slot_mapping=slots[j],
                              page_tables=tables,
                              context_lens=context_lens[j])
            hidden, _, _ = model_lib.forward_decode(
                self.params, cfg, tokens, meta, self.kv_cache)
            logits = model_lib.compute_logits(self.params, cfg, hidden)
            outs.append(torch.argmax(logits, dim=-1).to(torch.int32))
            self.num_dispatches += 1
        return torch.stack(outs).cpu().numpy()

    def _grow(self, row: _Row, end_tokens: int) -> bool:
        """Pages covering positions [0, min(end_tokens, max_len))."""
        need = cdiv(min(end_tokens, self.max_len), self.page_size) \
            - len(row.pages)
        if need <= 0:
            return True
        if not self.allocator.can_allocate(need):
            return False
        row.pages.extend(self.allocator.allocate(need))
        return True

    def _reset_row(self, seq, row: _Row) -> bool:
        """Re-ingest tokens [valid, num_tokens-1) through
        ``forward_prefill_hist`` (history attention against the row's own
        draft pages), in chunks padded to ``chunk_buckets``. After this the
        row is one catch-up feed away from drafting. False when the pool
        cannot hold the history (the caller sits the row out)."""
        from ..scheduler import _bucket

        ids = seq.all_token_ids
        n_hist = min(seq.num_tokens - 1, self.max_len)
        if n_hist <= row.valid:
            return True
        if not self._grow(row, n_hist):
            return False
        ps = self.page_size
        cfg = self.draft_config
        pages = np.asarray(row.pages, np.int64)
        width = min(next_power_of_2(max(len(row.pages), 1)),
                    self.pages_bucket)
        table = np.zeros(width, np.int32)
        table[:len(row.pages)] = row.pages
        table = self._up(table)
        start = row.valid
        while start < n_hist:
            end = min(start + self.chunk_buckets[-1], n_hist)
            chunk = end - start
            T = _bucket(chunk, self.chunk_buckets)
            tokens = np.zeros(T, np.int32)
            seg = np.full(T, -1, np.int32)
            pos = np.zeros(T, np.int32)
            slot = np.zeros(T, np.int32)             # padding -> scrap page
            tokens[:chunk] = ids[start:end]
            seg[:chunk] = 0
            p = np.arange(start, end)
            pos[:chunk] = p
            slot[:chunk] = pages[p // ps] * ps + p % ps
            meta = PrefillMeta(seg_ids=self._up(seg), positions=self._up(pos),
                               slot_mapping=self._up(slot),
                               logits_indices=self._up(np.zeros(1, np.int32)))
            model_lib.forward_prefill_hist(self.params, cfg, self._up(tokens),
                                           meta, self.kv_cache, table, start)
            self.num_reset_prefills += 1
            start = end
        row.valid = n_hist
        row.tail = []
        return True


def build_draft_runner(config: EngineConfig, draft_model: str,
                       params=None, seed: Optional[int] = None,
                       device: torch.device | str = "cuda", groups=None
                       ) -> DraftModelRunner:
    """The engine's construction seam (mirrors ``build_proposer``): resolve
    the draft preset and build the runner. ``params`` injects loaded draft
    weights; None draws them from ``seed`` (default: the config's).
    ``groups``: the engine's ``ParallelGroups``, over which the pool's
    size is agreed (``draft_pool_pages``)."""
    draft_cfg = get_model_config(draft_model)
    if draft_cfg.dtype != config.model.dtype:
        # Keep the draft in the target's serving dtype: only its argmax
        # leaves the runner.
        draft_cfg = dataclasses.replace(draft_cfg, dtype=config.model.dtype)
    return DraftModelRunner(config, draft_cfg, params=params, seed=seed,
                            device=device, groups=groups)
