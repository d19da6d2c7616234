"""Continuous-batching scheduler.

The serving hot loop the reference only shaped via ``gpuMemoryUtilization`` /
``maxModelLen`` knobs (SURVEY §3.4 "HOT LOOP (external, in vLLM)") is native
here. vLLM-v0-style policy:

- Prefills are prioritized: waiting sequences are admitted (FCFS) up to a token
  budget and batched into one ragged prefill step.
- Otherwise all running sequences take one decode step.
- Under KV-page pressure the youngest running sequence is preempted: by
  SWAP when the two-tier KV cache is on (committed pages move to host DRAM
  in one batched gather; readmission scatters them back and resumes decode
  directly — ``num_prefilled`` and the whole generation state survive), by
  RECOMPUTE otherwise or when the host pool is full / a swap-out fails
  (pages freed, sequence re-prefills from scratch) — the engine-level
  analogue of the reference's reset-then-converge recovery property
  (SURVEY §1 L1).

Shape discipline: every batch is padded to bucketed shapes (batch size, token
count, pages-per-seq) so the number of distinct XLA compilations is small and
bounded — this is what keeps continuous batching recompilation-storm-free
under jit (SURVEY §7 hard part (b)).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np

from ..config import EngineConfig
from ..observability import Observability
from ..utils import cdiv, get_logger
from ..utils.math import next_power_of_2
from .kv_cache import (CachingPageAllocator, KVTransferRefused,
                       PageAllocator)
from .qos import build_qos
from .sequence import FinishReason, Sequence, SequenceStatus

logger = get_logger("scheduler")


@dataclasses.dataclass
class ScheduledBatch:
    """One device step's worth of work, already laid out as padded numpy
    arrays matching models.PrefillMeta / models.DecodeMeta / models.MixedMeta."""
    kind: str                      # "prefill" | "decode" | "mixed"
    seqs: list[Sequence]           # the B real sequences (unpadded count);
                                   # mixed: decode seqs then the chunk seq last
    tokens: np.ndarray             # prefill: [T]; decode: [B_pad];
                                   # mixed: [Tp_bucket + R_pad]
    positions: np.ndarray
    slot_mapping: np.ndarray
    # prefill + mixed
    seg_ids: Optional[np.ndarray] = None
    logits_indices: Optional[np.ndarray] = None   # [B_pad]
    # decode + mixed (decode rows)
    page_tables: Optional[np.ndarray] = None      # [B_pad, pages_bucket]
    context_lens: Optional[np.ndarray] = None     # [B_pad]
    # chunked prefill only (solo batch): history length + this seq's pages
    # (in page_tables [1, pages_bucket]); partial = prompt not yet complete
    # after this chunk (the sampled token is discarded).
    hist_len: Optional[int] = None
    partial: bool = False
    # mixed only: the chunk sequence's page table (history attention) and
    # the actual (unpadded) chunk token count for stats/observability.
    chunk_page_table: Optional[np.ndarray] = None  # [1, hist_width]
    prefill_token_count: int = 0
    # spec + spec_mixed: per-row count of REAL proposals (rows short of k
    # were padded with filler drafts; the split feeds acceptance metrics),
    # the step's verify-slice width S = k+1 (adaptive k varies it between
    # steps), and the draft phase's wall time (trace attribution).
    draft_lens: Optional[np.ndarray] = None        # [B_pad]
    spec_S: Optional[int] = None
    draft_time_s: float = 0.0
    # spec_mixed only: the DEVICE sampling row of the chunk sequence
    # (seqs[-1]). The chunk rides row R_pad — after the R_pad bucketed spec
    # rows — while seqs holds only the D real decode rows + the chunk, so
    # host-side per-seq arrays (bias, penalty out_tokens, sampling params)
    # must target this row for the chunk instead of index D.
    chunk_device_row: Optional[int] = None

    def device_seq_rows(self):
        """(device row, seq) pairs — identity except for the spec_mixed
        chunk row remap. The seam engine-side per-seq array builders
        iterate so one spelling serves every batch kind."""
        for s, seq in enumerate(self.seqs):
            if (self.chunk_device_row is not None
                    and s == len(self.seqs) - 1):
                yield self.chunk_device_row, seq
            else:
                yield s, seq
    # sampling arrays [B_pad]
    temperature: Optional[np.ndarray] = None
    top_k: Optional[np.ndarray] = None
    top_p: Optional[np.ndarray] = None
    presence: Optional[np.ndarray] = None
    frequency: Optional[np.ndarray] = None
    seed: Optional[np.ndarray] = None      # -1 = unseeded
    prompt_lens: Optional[np.ndarray] = None  # output boundary (penalties)
    top_n: Optional[np.ndarray] = None     # logprobs alternatives requested

    @property
    def num_seqs(self) -> int:
        return len(self.seqs)


def _bucket(value: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if value <= b:
            return b
    return next_power_of_2(value)


class Scheduler:
    def __init__(self, config: EngineConfig, num_pages: int,
                 obs: Optional[Observability] = None):
        # The engine shares its Observability so scheduler-side lifecycle
        # events (queued/scheduled/chunk/preempt/terminal) land in the same
        # trace ring as the step loop's; standalone construction (tests)
        # gets a private one.
        self.obs = obs if obs is not None else Observability()
        self.config = config
        sc = config.scheduler
        self.max_num_seqs = sc.max_num_seqs
        self.max_prefill_tokens = sc.max_prefill_tokens
        # Stall-free mixed prefill/decode batching (engine/mixed_batch.py).
        # The engine may clear this after construction when the mesh regime
        # has no mixed forward path (pp/sp).
        self.mixed_enabled = sc.mixed_batch_enabled
        # Speculative decoding (engine/spec/): pure-decode steps become
        # batched draft-verification steps. The engine may clear this after
        # construction (pp/sp meshes have no spec forward path).
        self.spec_enabled = sc.spec_decode_enabled
        # Spec×mixed composition: mixed steps carry verify slices when both
        # features are on. The engine clears this (keeping spec and mixed
        # individually alive) only if the combined program cannot build.
        self.spec_mixed_enabled = True
        self.spec_proposer = None
        self.spec_controller = None
        if sc.spec_decode_enabled:
            from .spec.proposer import build_proposer
            # Host-side n-gram proposer by default; the ENGINE installs the
            # draft-model runner over it when spec_draft_model is set
            # (engine/spec/draft_model.py — building it needs params).
            self.spec_proposer = build_proposer(sc)
            if sc.spec_adaptive_k:
                from .spec.adaptive import AdaptiveK
                self.spec_controller = AdaptiveK(sc.effective_spec_k_max)
        self.decode_buckets = sc.decode_buckets
        self.prefill_buckets = sc.prefill_buckets
        self.page_size = config.cache.page_size
        if sc.enable_prefix_caching:
            self.allocator = CachingPageAllocator(num_pages, self.page_size)
            self.prefix_cache = self.allocator.prefix_cache
        else:
            self.allocator = PageAllocator(num_pages, self.page_size)
            self.prefix_cache = None
        self.waiting: deque[Sequence] = deque()
        self.running: list[Sequence] = []
        # Two-tier KV cache: sequences preempted BY SWAP wait here with
        # their committed KV parked in host DRAM (seq.host_pages), separate
        # from ``waiting`` so none of its invariants (mid-chunk head, chunk
        # scheduling, prefix lookups) ever see a swapped sequence. FIFO:
        # the head keeps first claim on freed device pages. The engine
        # attaches the swapper after construction; None = swap disabled and
        # every preemption recomputes (byte-identical to the single tier).
        self.swapped: deque[Sequence] = deque()
        self.swapper = None
        # Multi-tenant QoS (engine/qos.py): weighted fair sharing across
        # priority classes + priority-aware preemption. None (no tiers
        # configured) disables every QoS branch — the scheduler is then
        # byte-identical to the tier-less engine, admission order, charge
        # accounting, and victim selection included.
        self.qos = build_qos(sc)
        # Sequences terminated by the scheduler itself (grown past pool
        # capacity) — the engine drains these into RequestOutputs so a client
        # waiting on the request still sees a finished event.
        self.terminally_finished: list[Sequence] = []
        # Disaggregated prefill/decode: finished sequences whose pages are
        # HELD for the KV export seam (seq.hold_kv) — the engine's
        # export_held/discard_held own the release. Aborts and capacity
        # terminations release normally and never land here.
        self.held: dict[str, Sequence] = {}
        # Monotone high-water marks for padded shapes (stats/debug).
        self.num_preemptions = 0
        self.num_preemptions_by_kind = {"recompute": 0, "swap": 0}

    def attach_swapper(self, swapper) -> None:
        """Enable preempt-by-swap (engine/kv_cache.KVSwapper)."""
        self.swapper = swapper

    # -- queue management ---------------------------------------------------

    def add(self, seq: Sequence) -> None:
        if seq.num_prompt_tokens == 0:
            raise ValueError("prompt must contain at least one token")
        # Prompts longer than the prefill token budget are CHUNKED across
        # steps (vLLM chunked prefill); the model length cap still applies.
        max_prompt = self.config.effective_max_len - 1
        if seq.num_prompt_tokens > max_prompt:
            raise ValueError(
                f"prompt of {seq.num_prompt_tokens} tokens exceeds limit {max_prompt}")
        # A prompt that cannot fit the page pool even when it is empty would
        # never become schedulable — reject it up front instead of spinning.
        usable_pages = self.allocator.num_pages - 1  # page 0 is scrap
        need = cdiv(seq.num_prompt_tokens, self.page_size)
        if need > usable_pages:
            raise ValueError(
                f"prompt needs {need} KV pages but the pool has {usable_pages}")
        self.waiting.append(seq)
        self.obs.on_queued(seq, depth=len(self.waiting))

    def abort(self, request_id: str) -> bool:
        for queue in (self.waiting, self.swapped):
            for seq in list(queue):
                if seq.request_id == request_id:
                    queue.remove(seq)
                    seq.status = SequenceStatus.FINISHED
                    seq.finish_reason = FinishReason.ABORT
                    self._release(seq)   # device pages AND host pages
                    self.obs.on_finish(seq, FinishReason.ABORT)
                    return True
        for seq in self.running:
            if seq.request_id == request_id:
                self.running.remove(seq)
                seq.status = SequenceStatus.FINISHED
                seq.finish_reason = FinishReason.ABORT
                self._release(seq)
                self.obs.on_finish(seq, FinishReason.ABORT)
                return True
        return False

    def has_work(self) -> bool:
        return bool(self.waiting or self.running or self.swapped)

    def find_running(self, request_id: str) -> Optional[Sequence]:
        """The RUNNING sequence under ``request_id``, else None. The
        live-migration export seam (engine.export_running) migrates running
        decodes only: waiting/swapped sequences have no committed device
        pages worth shipping and keep the wait-it-out drain path."""
        for seq in self.running:
            if seq.request_id == request_id:
                return seq
        return None

    def _release(self, seq: Sequence) -> None:
        if seq.pages:
            self.allocator.free(seq.pages)
            seq.pages = []
        if seq.host_pages and self.swapper is not None:
            self.swapper.free_host(seq.host_pages)
            seq.host_pages = []

    def finish(self, seq: Sequence, reason) -> None:
        seq.status = SequenceStatus.FINISHED
        seq.finish_reason = reason
        if (seq.hold_kv and reason != FinishReason.ABORT and seq.pages):
            # Disaggregated prefill: the committed KV outlives the finish so
            # the export seam can gather it for the decode replica. Only the
            # device pages are held (they carry the KV); any host-tier copy
            # is released — a held sequence never resumes locally.
            if seq.host_pages and self.swapper is not None:
                self.swapper.free_host(seq.host_pages)
                seq.host_pages = []
            self.held[seq.request_id] = seq
        else:
            self._release(seq)
        if seq in self.running:
            self.running.remove(seq)
        self.obs.on_finish(seq, reason)

    def _preempt_youngest(self) -> bool:
        """Evict the most recently admitted running sequence — by SWAP when
        the host tier can take its committed pages, by RECOMPUTE otherwise.
        Returns False if nothing can be preempted."""
        if not self.running:
            return False
        victim = self.running.pop()  # admission order => last is youngest
        return self._evict(victim)

    def _evict(self, victim: Sequence, behind_head: bool = False) -> bool:
        """Shared eviction tail: the caller already removed ``victim`` from
        ``running``; swap it out, or fall back to recompute-requeue
        (``behind_head`` = QoS make-room: the victim lands behind its
        beneficiary), with the preemption accounting all paths share."""
        if self._swap_out(victim):
            return True
        self._requeue_for_recompute(victim, behind_head=behind_head)
        self.num_preemptions += 1
        self.num_preemptions_by_kind["recompute"] += 1
        self.obs.on_preempt(victim, kind="recompute")
        logger.warning("preempted %s (%s; free=%d)",
                       victim.request_id,
                       "higher-priority admission" if behind_head
                       else "KV pages exhausted", self.allocator.num_free,
                       extra={"request_id": victim.request_id})
        return True

    def _preempt_victim(self, from_idx: int) -> bool:
        """Decode-growth preemption with tier awareness. QoS off keeps the
        exact legacy choice (pop the youngest). QoS on picks, among the
        not-yet-granted ``running[from_idx:]`` (earlier indices already got
        this window's pages), a victim from the LOWEST-priority tier
        strictly below the requester's — youngest within it, preserving
        the single-tier churn properties — else the youngest of the
        requester's OWN tier; a higher-priority sequence is never evicted
        for a lower one (the batch job waits instead). Returns False when
        no admissible victim exists — the caller stops growing."""
        if self.qos is None:
            return self._preempt_youngest()
        cands = self.running[from_idx:]
        if not cands:
            return False
        rp = self.qos.priority_of(self.running[from_idx])
        lower = [s for s in cands if self.qos.priority_of(s) < rp]
        if lower:
            floor = min(self.qos.priority_of(s) for s in lower)
            victim = [s for s in lower
                      if self.qos.priority_of(s) == floor][-1]
        else:
            same = [s for s in cands if self.qos.priority_of(s) == rp]
            if not same:
                return False
            victim = same[-1]
        self.running.remove(victim)
        return self._evict(victim)

    def _requeue_for_recompute(self, seq: Sequence,
                               behind_head: bool = False) -> None:
        """Recompute-style readmission: pages (device AND any host copy) are
        released and on readmission the prefill replays all_token_ids
        (prompt + generated so far) so the prompt/output split — and with it
        max_tokens accounting — is kept. INVARIANT: a mid-chunk sequence
        (holding pages) is only ever at waiting[0] — chunk scheduling runs
        on the head alone, so displacing it would strand its pages forever;
        requeued sequences slot in behind. Shared by recompute-preemption
        and every swap path that degrades to it. ``behind_head``: QoS
        make-room eviction — the victim must land BEHIND the waiting head
        it was evicted for, or the very next admission pass would readmit
        the victim ahead of its beneficiary."""
        self._release(seq)
        seq.status = SequenceStatus.PREEMPTED
        seq.num_prefilled = 0        # pages gone: chunk progress recomputes
        seq.prefix_checked = False   # re-lookup on readmission (cheap TTFT
                                     # recovery when the prefix is cached)
        if self.waiting and (behind_head
                             or self.waiting[0].num_prefilled > 0):
            self.waiting.insert(1, seq)
        else:
            self.waiting.appendleft(seq)

    def _swap_degraded_to_recompute(self) -> None:
        """A preemption counted as swap whose RECOVERY fell back to
        recompute (failed swap-in / unrestorable head): reclassify it so
        kgct_preemptions_total{kind=…} — the swap-sizing signal — reflects
        the recovery that actually happened."""
        self.num_preemptions_by_kind["swap"] -= 1
        self.num_preemptions_by_kind["recompute"] += 1

    def _swap_out(self, victim: Sequence) -> bool:
        """Preempt-by-swap: gather the victim's COMMITTED pages (positions
        [0, num_tokens-1) — the window-growth tail past them holds only
        scratch) to host, free all its device pages, park it on ``swapped``.
        False (caller falls back to recompute) when swap is off, the host
        pool is full, or the chaos site ``kv_swap_fail`` fires — a refused
        swap must never wedge the victim."""
        if self.swapper is None:
            return False
        n = cdiv(victim.num_tokens - 1, self.page_size)
        if n < 1 or n > len(victim.pages):
            return False
        try:
            # The copy completes inside swap_out, BEFORE the release below
            # can hand the pages to the next allocation. Only a refused
            # swap degrades; a device fault propagates.
            host_pages = self.swapper.swap_out(victim.pages[:n],
                                               request_id=victim.request_id)
        except KVTransferRefused as e:
            logger.warning("swap-out of %s failed (%s); falling back to "
                           "recompute preemption", victim.request_id, e,
                           extra={"request_id": victim.request_id})
            return False
        self._release(victim)
        victim.status = SequenceStatus.PREEMPTED
        victim.host_pages = host_pages
        # num_prefilled / prefix_checked survive: readmission restores the
        # pages and resumes decode — no prefill replay, no prefix re-lookup.
        self.swapped.append(victim)
        self.num_preemptions += 1
        self.num_preemptions_by_kind["swap"] += 1
        self.obs.on_preempt(victim, kind="swap")
        logger.warning("swap-preempted %s (%d pages -> host; host free=%d)",
                       victim.request_id, n, self.swapper.host.num_free,
                       extra={"request_id": victim.request_id})
        return True

    def _restore_swapped(self) -> None:
        """Readmit swapped sequences (FIFO): allocate device pages covering
        the committed KV, scatter the host copy back, and rejoin ``running``
        directly — the next decode/mixed/spec batch carries the sequence as
        if it never left. A blocked head keeps first claim on freed pages
        (this runs before any admission on every schedule call). A failed
        swap-in degrades to recompute-preemption rather than wedging."""
        while self.swapped:
            seq = self.swapped[0]
            if len(self.running) >= self.max_num_seqs:
                return
            if self.qos is not None and self._qos_defer_restore(seq):
                # A higher-priority tier is owed admission first: restoring
                # this victim would grab the very pages its beneficiary
                # needs and thrash the pair through the host tier.
                return
            need = cdiv(seq.num_tokens - 1, self.page_size)
            # Gate on pages for the committed KV PLUS the next decode
            # window: a bare-committed restore would be the very next
            # growth call's youngest victim, thrashing the same pages
            # through the host tier every step while starving the transfer
            # bus. (Growth still does the actual window allocation.)
            last = seq.last_window_pos(seq.num_tokens - 1,
                                       self.config.scheduler.decode_window,
                                       self.config.effective_max_len)
            want = max(need, cdiv(last + 1, self.page_size))
            if want > self.allocator.num_pages - 1:
                # Permanently unrestorable: the gate exceeds TOTAL pool
                # capacity (num_tokens is frozen while swapped, so this
                # never heals). Degrade to recompute-readmission — the
                # waiting path's capacity machinery then owns the outcome
                # (churn or LENGTH-terminate), exactly as with swap off;
                # leaving it on `swapped` would spin schedule() forever.
                self.swapped.popleft()
                self._requeue_for_recompute(seq)   # drops the host copy too
                self._swap_degraded_to_recompute()
                logger.warning(
                    "%s unrestorable by swap (%d pages > pool %d); "
                    "recompute", seq.request_id, want,
                    self.allocator.num_pages - 1,
                    extra={"request_id": seq.request_id})
                continue
            if not self.allocator.can_allocate(want):
                return
            pages = self.allocator.allocate(need)
            try:
                self.swapper.swap_in(seq.host_pages, pages,
                                     request_id=seq.request_id)
            except KVTransferRefused as e:
                logger.warning("swap-in of %s failed (%s); recompute",
                               seq.request_id, e,
                               extra={"request_id": seq.request_id})
                self.allocator.free(pages)
                self.swapped.popleft()
                self._requeue_for_recompute(seq)   # drops the host copy too
                self._swap_degraded_to_recompute()
                continue
            self.swapped.popleft()
            seq.pages = pages
            seq.host_pages = []
            seq.status = SequenceStatus.RUNNING
            self.running.append(seq)
            self.swapper.notify_restored(seq)
            self.obs.on_scheduled(seq, 1)    # emits the "resume" event

    # -- QoS: weighted fair sharing + priority preemption --------------------
    # Every method below is reachable only with ``self.qos`` set (tiers
    # configured); the tier-less scheduler never enters them. Virtual-token
    # clocks are mutated ONLY through qos.charge/sync_active from this
    # seam (KGCT015 tenant-accounting-safety).

    def _qos_fresh_waiting(self):
        """(seq, tier name) for waiting sequences that can be freely
        reordered: no chunk progress and no pages held — a mid-chunk head
        must stay at waiting[0] (chunk scheduling runs on the head alone)."""
        for seq in self.waiting:
            if seq.num_prefilled == 0 and not seq.pages:
                yield seq, self.qos.resolve(seq.params.qos_tier)

    def _qos_pass(self) -> None:
        """Once per schedule() — on EVERY call, waiting-empty included:
        sync the tier activity set first (a tier's departure during a
        pure-decode stretch must be observed, or its later return would
        skip the idle catch-up and spend arbitrarily large banked
        credit), then promote the owed tier's first fresh waiting
        sequence to the queue head, then make room for it by priority
        preemption when seats/pages block its admission."""
        qos = self.qos
        qos.sync_active(
            qos.resolve(s.params.qos_tier)
            for bucket in (self.waiting, self.running, self.swapped)
            for s in bucket)
        if not self.waiting:
            return
        self._qos_promote()
        self._qos_make_room()

    def _qos_promote(self) -> None:
        """Weighted-fair admission order: move the first fresh waiting
        sequence of the tier with the smallest virtual clock to the queue
        head. FCFS is preserved WITHIN a tier (always the tier's first
        sequence); a mid-chunk or page-holding head is never displaced."""
        if len(self.waiting) < 2:
            return
        head = self.waiting[0]
        if head.num_prefilled > 0 or head.pages:
            return
        fresh = list(self._qos_fresh_waiting())
        want = self.qos.pick_tier(name for _, name in fresh)
        if want is None or self.qos.resolve(head.params.qos_tier) == want:
            return
        for seq, name in fresh:
            if name == want:
                self.waiting.remove(seq)
                self.waiting.appendleft(seq)
                return

    def _qos_make_room(self) -> None:
        """Priority admission preemption: when the (promoted) fresh head is
        blocked by seats or pages, evict strictly-LOWER-priority running
        sequences (lowest tier first, youngest within it) until it fits or
        no admissible victim remains — by swap when the host tier is on
        (the cheap path the two-tier KV cache exists for), by recompute
        otherwise, with the victim requeued BEHIND its beneficiary. Same-
        or higher-priority running work is never touched: within a tier
        the no-preempt-for-admission invariant (and its churn rationale)
        still holds."""
        if not self.waiting:
            return
        head = self.waiting[0]
        if head.num_prefilled > 0 or head.pages:
            return
        hp = self.qos.priority_of(head)
        need = min(cdiv(head.num_tokens, self.page_size),
                   cdiv(self.max_prefill_tokens, self.page_size))
        while (len(self.running) >= self.max_num_seqs
               or not self.allocator.can_allocate(need)):
            victim = None
            floor = hp
            for s in self.running:
                p = self.qos.priority_of(s)
                if p < floor or (victim is not None
                                 and p == floor):
                    # < floor: strictly lower tier found; == floor after a
                    # first hit: later admission = younger within the tier.
                    victim = s
                    floor = p
            if victim is None:
                return
            self.running.remove(victim)
            self._evict(victim, behind_head=True)

    def _qos_defer_chunk(self, head: Sequence) -> bool:
        """Chunk-gate: pause the mid-chunk head's next chunk when a fresh
        PACKABLE waiting sequence of a strictly-HIGHER-priority tier is
        owed service (the head's tier clock has run ahead of the waiter's)
        — the admission pass below then schedules the waiter instead,
        bounding how far a batch-tier long prompt can push an interactive
        request's first schedule (its deficit bound: at most the chunk in
        flight when the waiter arrived). Self-releasing: serving the
        waiter advances its clock until the comparison flips, so the
        paused chunk never starves. Only waiters the packed admission loop
        CAN admit (num_tokens <= max_prefill_tokens) qualify: a chunkable
        waiter runs solo from waiting[0] only, so deferring the head for
        it would schedule neither sequence and freeze both clocks — a
        permanent stall, not a fairness win."""
        head_tier = self.qos.resolve(head.params.qos_tier)
        head_prio = self.qos.priority_of(head)
        for seq, name in self._qos_fresh_waiting():
            if (seq.num_tokens <= self.max_prefill_tokens
                    and self.qos.tiers[name].priority > head_prio
                    and self.qos.owes(head_tier, name)):
                return True
        return False

    def _qos_defer_restore(self, seq: Sequence) -> bool:
        """Restore-gate (mirror of the chunk gate for the swapped queue):
        hold a swapped victim's readmission while a fresh waiting sequence
        of a strictly-higher-priority tier is owed service — restoring
        first would hand the victim the pages its beneficiary was evicted
        to free."""
        victim_tier = self.qos.resolve(seq.params.qos_tier)
        victim_prio = self.qos.priority_of(seq)
        for waiter, name in self._qos_fresh_waiting():
            # Same packability restriction as the chunk gate: a chunkable
            # waiter is served from waiting[0] via the chunk path, which a
            # deferred restore cannot unblock — only waiters the packed
            # loop can admit justify holding the restore.
            if (waiter.num_tokens <= self.max_prefill_tokens
                    and self.qos.tiers[name].priority > victim_prio
                    and self.qos.owes(victim_tier, name)):
                return True
        return False

    def _qos_charge_batch(self, batch: ScheduledBatch) -> None:
        """THE service-accounting site: every scheduled batch charges its
        granted tokens to its sequences' tier clocks here, once, at the
        single exit of schedule(). Prefill charges prompt/chunk tokens,
        decode charges the window each row may advance, mixed charges one
        token per decode row plus the chunk, spec charges the verify width
        per row — relative shares are what fairness runs on."""
        qos = self.qos
        sc = self.config.scheduler
        if batch.kind == "prefill":
            if batch.hist_len is not None:
                seq = batch.seqs[0]
                qos.charge(qos.resolve(seq.params.qos_tier),
                           seq.num_prefilled - batch.hist_len)
            else:
                for seq in batch.seqs:
                    qos.charge(qos.resolve(seq.params.qos_tier),
                               seq.num_tokens)
        elif batch.kind == "decode":
            for seq in batch.seqs:
                qos.charge(qos.resolve(seq.params.qos_tier),
                           sc.decode_window)
        elif batch.kind == "mixed":
            for seq in batch.seqs[:-1]:
                qos.charge(qos.resolve(seq.params.qos_tier), 1)
            chunk_seq = batch.seqs[-1]
            qos.charge(qos.resolve(chunk_seq.params.qos_tier),
                       max(batch.prefill_token_count, 1))
        elif batch.kind == "spec":
            for seq in batch.seqs:
                qos.charge(qos.resolve(seq.params.qos_tier),
                           batch.spec_S or sc.num_speculative_tokens + 1)
        elif batch.kind == "spec_mixed":
            # Verify slices charge their full width (the forward really runs
            # S tokens per row); the chunk charges like a mixed chunk.
            for seq in batch.seqs[:-1]:
                qos.charge(qos.resolve(seq.params.qos_tier),
                           batch.spec_S or sc.num_speculative_tokens + 1)
            chunk_seq = batch.seqs[-1]
            qos.charge(qos.resolve(chunk_seq.params.qos_tier),
                       max(batch.prefill_token_count, 1))

    # -- scheduling ---------------------------------------------------------

    def schedule(self) -> Optional[ScheduledBatch]:
        batch = self._schedule_inner()
        if self.qos is not None and batch is not None:
            self._qos_charge_batch(batch)
        return batch

    def _schedule_inner(self) -> Optional[ScheduledBatch]:
        # Swap-readmission first: restored sequences rejoin ``running`` and
        # ride whatever batch this very call builds — resumption is a
        # memcpy plus a decode step, never a prefill.
        if self.swapped:
            self._restore_swapped()
        # Multi-tenant QoS: activity sync runs every call (idle tracking);
        # fair-share promotion + priority make-room run before any
        # admission path looks at the queue.
        if self.qos is not None:
            self._qos_pass()
        # Acceptance-adaptive speculation at the k=0 floor: tick the idle
        # cooldown ONCE per schedule call (both the spec and spec-mixed
        # builders read current_k; ticking inside them would double-count
        # or — under a long mixed streak — never run at all).
        if (self.spec_enabled and self.spec_controller is not None
                and self.spec_controller.current_k == 0):
            self.spec_controller.tick_idle()
        # Stall-free mixing: when running decodes and waiting prefill work
        # coexist, one device step carries both (engine/mixed_batch.py).
        # With spec decode also on, the step carries every running row's
        # VERIFY SLICE instead of a single decode token (spec×mixed — spec
        # no longer forfeits the mixed TTFT win); its bow-outs (k throttled
        # to 0, nothing proposed, rows out of the bucket grid) fall through
        # to the plain mixed step, then the legacy prefill-else-decode
        # policy unchanged.
        if self.mixed_enabled and self.running and self.waiting:
            from .mixed_batch import build_mixed_batch, build_spec_mixed_batch
            if self.spec_enabled and self.spec_mixed_enabled:
                batch = build_spec_mixed_batch(self)
                if batch is not None:
                    return batch
            batch = build_mixed_batch(self)
            if batch is not None:
                return batch
        batch = self._schedule_prefills()
        if batch is not None:
            return batch
        # Speculative decoding replaces the pure decode step when enabled:
        # every running sequence's drafts verify in one dispatched program.
        # Chunked prefill rows are never drafted (they never reach here —
        # prefill work schedules above), and a bow-out (no proposals, rows
        # out of the bucket grid, no pages) falls through to a legacy
        # decode window — unchained while spec is enabled, so eligibility
        # is re-checked every window (see engine._step).
        if self.spec_enabled and self.running:
            from .spec.verifier import build_spec_batch
            batch = build_spec_batch(self)
            if batch is not None:
                return batch
        return self._schedule_decode()

    # Bounded lookahead past a blocked queue head: fills the batch with
    # later sequences that DO fit (no reordering — skipped sequences keep
    # their place, so the head still goes first next round). Kills the
    # head-of-line blocking where one large prompt stalled every small one
    # behind it, while the bound prevents unbounded queue scans.
    PREFILL_LOOKAHEAD = 8

    def _schedule_prefills(self) -> Optional[ScheduledBatch]:
        # A sequence larger than the prefill token budget streams through in
        # chunks, admitted solo (its chunk attends to its pool history).
        # When the chunk is BLOCKED (no pages / batch full), fall through to
        # lookahead admission — the head keeps first claim on freed pages
        # (this branch runs before any admission on every schedule call), so
        # small prompts behind it progress without starving it.
        if self.waiting:
            head = self.waiting[0]
            self._try_prefix_reuse(head)
            if head.num_prefilled > 0 or head.num_tokens > self.max_prefill_tokens:
                # QoS chunk-gate: a mid-chunk lower-priority head yields
                # this step's prefill budget to an owed higher-priority
                # waiter (admitted by the lookahead loop below); the head
                # keeps its pages and resumes chunking once the waiter's
                # clock catches up.
                if not (self.qos is not None
                        and self._qos_defer_chunk(head)):
                    batch = self._schedule_chunk(head)
                    if batch is not None:
                        return batch

        admitted: list[Sequence] = []
        total_tokens = 0
        skipped = 0
        i = 0
        while i < len(self.waiting) and skipped <= self.PREFILL_LOOKAHEAD:
            seq = self.waiting[i]
            if len(self.running) + len(admitted) >= self.max_num_seqs:
                break
            if seq.num_prefilled > 0 or seq.pages:
                # Mid-chunk / prefix-held sequences advance ONLY through
                # the chunk path on the head: admitting one here would
                # assign fresh pages over its held (possibly cache-shared)
                # list, leaking the refcounted prefix pages. Unreachable
                # with QoS off (a blocked chunk implies this loop's
                # stricter seat/page checks also fail); the QoS chunk-defer
                # gate makes it reachable with pages plentiful.
                skipped += 1
                i += 1
                continue
            if seq.num_tokens > self.max_prefill_tokens:
                # Chunkable sequence mid-queue: solo-only, skip for this batch.
                skipped += 1
                i += 1
                continue
            fits_budget = (not admitted or
                           total_tokens + seq.num_tokens <= self.max_prefill_tokens)
            need = cdiv(seq.num_tokens, self.page_size)
            # Budget first: can_allocate may EVICT prefix-cache entries to
            # satisfy the probe, which must not happen for candidates the
            # token budget rejects anyway.
            fits_pages = fits_budget and self.allocator.can_allocate(need)
            if not fits_pages and i == 0 and not self.running and not admitted:
                # Pool is empty and the head still doesn't fit: it has grown
                # (via preempt-recompute) past total capacity and can never be
                # scheduled — terminate it at capacity.
                self.waiting.popleft()
                self._release(seq)
                seq.status = SequenceStatus.FINISHED
                seq.finish_reason = FinishReason.LENGTH
                self.terminally_finished.append(seq)
                self.obs.on_finish(seq, FinishReason.LENGTH)
                logger.warning(
                    "%s needs %d pages > pool capacity %d; finishing at "
                    "length %d", seq.request_id, need,
                    self.allocator.num_pages - 1, seq.num_tokens)
                continue
            if not (fits_budget and fits_pages):
                # Never preempt running sequences to admit waiting ones — the
                # victim would re-enter the waiting queue ahead of this
                # sequence and immediately re-take the freed pages, churning
                # full-recompute prefills while starving decode.
                skipped += 1
                i += 1
                continue
            seq.pages = self.allocator.allocate(need)
            del self.waiting[i]
            admitted.append(seq)
            total_tokens += seq.num_tokens
            self._register_prefix(seq)
        if not admitted:
            return None

        T = _bucket(total_tokens, self.prefill_buckets)
        B = _bucket(len(admitted), self.decode_buckets)
        tokens = np.zeros(T, np.int32)
        seg_ids = np.full(T, -1, np.int32)
        positions = np.zeros(T, np.int32)
        slot_mapping = np.zeros(T, np.int32)   # scrap page slots for padding
        logits_indices = np.zeros(B, np.int32)
        i = 0
        for s, seq in enumerate(admitted):
            n = seq.num_tokens
            tokens[i:i + n] = seq.all_token_ids
            seg_ids[i:i + n] = s
            positions[i:i + n] = np.arange(n)
            page_arr = np.asarray(seq.pages, np.int64)
            tok_pos = np.arange(n)
            slot_mapping[i:i + n] = (page_arr[tok_pos // self.page_size] *
                                     self.page_size + tok_pos % self.page_size)
            i += n
            logits_indices[s] = i - 1
            seq.status = SequenceStatus.RUNNING
            self.running.append(seq)
            self.obs.on_scheduled(seq, len(admitted))

        return ScheduledBatch(
            kind="prefill", seqs=admitted, tokens=tokens, positions=positions,
            slot_mapping=slot_mapping, seg_ids=seg_ids,
            logits_indices=logits_indices, **self._sampling_arrays(admitted, B))

    def _schedule_chunk(self, seq: Sequence) -> Optional[ScheduledBatch]:
        """One chunk of a long prompt, admitted solo: tokens
        [num_prefilled, num_prefilled + chunk) run as a prefill attending to
        the sequence's committed pool history. On the final chunk the
        sequence joins running (its sampled token is the first generation);
        earlier chunks leave it at the queue head with progress advanced."""
        remaining = seq.num_tokens - seq.num_prefilled
        chunk = min(remaining, self.max_prefill_tokens)
        if len(self.running) >= self.max_num_seqs:
            return None
        end = seq.num_prefilled + chunk
        need = cdiv(end, self.page_size) - len(seq.pages)
        if need > 0 and not self.allocator.can_allocate(need):
            usable = self.allocator.num_pages - 1
            if not self.running and cdiv(end, self.page_size) > usable:
                # Can never fit even an empty pool: capacity-terminate.
                self.waiting.popleft()
                self._release(seq)
                seq.status = SequenceStatus.FINISHED
                seq.finish_reason = FinishReason.LENGTH
                self.terminally_finished.append(seq)
                self.obs.on_finish(seq, FinishReason.LENGTH)
                logger.warning("%s chunked prefill exceeds pool capacity "
                               "(%d pages); finishing", seq.request_id, usable,
                               extra={"request_id": seq.request_id})
            return None        # wait for decode finishes to free pages
        if need > 0:
            seq.pages.extend(self.allocator.allocate(need))

        partial = end < seq.num_tokens
        T = _bucket(chunk, self.prefill_buckets)
        tokens = np.zeros(T, np.int32)
        seg_ids = np.full(T, -1, np.int32)
        positions = np.zeros(T, np.int32)
        slot_mapping = np.zeros(T, np.int32)
        tokens[:chunk] = seq.all_token_ids[seq.num_prefilled:end]
        seg_ids[:chunk] = 0
        tok_pos = np.arange(seq.num_prefilled, end)
        positions[:chunk] = tok_pos
        page_arr = np.asarray(seq.pages, np.int64)
        slot_mapping[:chunk] = (page_arr[tok_pos // self.page_size] *
                                self.page_size + tok_pos % self.page_size)
        page_table = self._chunk_page_table(seq)
        B = _bucket(1, self.decode_buckets)
        logits_indices = np.zeros(B, np.int32)
        logits_indices[0] = chunk - 1

        hist_len = seq.num_prefilled
        seq.num_prefilled = end
        if seq.scheduled_time is None or (
                seq.status == SequenceStatus.PREEMPTED and hist_len == 0):
            # Queue wait ends at the FIRST chunk's scheduling (later chunks
            # are prefill progress, not queueing); a preempted readmission's
            # first recompute chunk emits its "resume" event here.
            self.obs.on_scheduled(seq, 1)
        self.obs.on_prefill_chunk(seq, hist_len, end, seq.num_tokens)
        if partial:
            logger.info("%s prefill chunk [%d:%d) of %d", seq.request_id,
                        hist_len, end, seq.num_tokens,
                        extra={"request_id": seq.request_id})
        else:
            self.waiting.popleft()
            seq.status = SequenceStatus.RUNNING
            self.running.append(seq)
            self._register_prefix(seq)

        return ScheduledBatch(
            kind="prefill", seqs=[seq], tokens=tokens, positions=positions,
            slot_mapping=slot_mapping, seg_ids=seg_ids,
            logits_indices=logits_indices, page_tables=page_table,
            hist_len=hist_len, partial=partial,
            **self._sampling_arrays([seq], B))

    def _chunk_page_table(self, seq: Sequence) -> np.ndarray:
        """[1, width] page table for a chunk's history attention. Width
        buckets to the ACTUAL context (few power-of-2 compile shapes), not
        the model cap — the attention materializes [heads, T, width*ps]
        scores, so a max-len-wide table would make every small chunk pay
        max-model-len memory/FLOPs. Single source for the solo-chunk and
        mixed paths so their compile-shape families cannot diverge."""
        max_pages = cdiv(self.config.effective_max_len, self.page_size)
        width = min(next_power_of_2(max(len(seq.pages), 1)), max_pages)
        table = np.zeros((1, width), np.int32)
        table[0, :len(seq.pages)] = seq.pages
        return table

    def _fill_decode_row(self, seq: Sequence, row: int, offset: int,
                         tokens, positions, slot_mapping,
                         page_tables, context_lens) -> None:
        """One decode row's step inputs (token slot ``offset + row``, table
        row ``row``): shared by the pure decode and mixed layouts."""
        pos = seq.num_tokens - 1
        tokens[offset + row] = (seq.output_token_ids[-1]
                                if seq.output_token_ids
                                else seq.prompt_token_ids[-1])
        positions[offset + row] = pos
        slot_mapping[offset + row] = (seq.pages[pos // self.page_size] *
                                      self.page_size + pos % self.page_size)
        page_tables[row, :len(seq.pages)] = seq.pages
        context_lens[row] = seq.num_tokens

    def _try_prefix_reuse(self, seq: Sequence) -> None:
        """Prefix-cache reuse rides the chunked-prefill machinery: a cached
        page-aligned prefix becomes "already prefilled history" and only the
        tail is computed. At most one lookup per (re)admission; the match is
        capped to num_tokens-1 so >=1 token remains to prefill (sampling
        reads the last prompt token's hidden state)."""
        if (self.prefix_cache is None or seq.prefix_checked
                or seq.num_prefilled > 0 or seq.pages):
            return
        seq.prefix_checked = True
        pages, matched = self.prefix_cache.lookup(
            seq.all_token_ids, max_tokens=seq.num_tokens - 1)
        if matched > 0:
            seq.pages = pages
            seq.num_prefilled = matched
            logger.info("%s: prefix cache hit, %d/%d tokens reused",
                        seq.request_id, matched, seq.num_tokens)

    def prefix_peek(self, token_ids: list[int]) -> int:
        """Tokens of ``token_ids`` already covered by the local prefix
        cache (device OR host tier), capped like admission's reuse at
        ``len(token_ids) - 1`` so the count means "tokens a local admission
        would NOT recompute". 0 when prefix caching is off. Read-only —
        the fleet-cache pull gate calls this from the worker seam to price
        a remote pull against what is already here."""
        if self.prefix_cache is None or len(token_ids) < 2:
            return 0
        return self.prefix_cache.peek(token_ids,
                                      max_tokens=len(token_ids) - 1)

    def _register_prefix(self, seq: Sequence) -> None:
        """Content-address this sequence's full PROMPT pages so later
        requests sharing the prefix reuse them. Called at prompt-prefill
        scheduling time — the KV is committed before any later schedule()
        can hand the pages to another request (single-threaded step loop)."""
        if self.prefix_cache is None:
            return
        full = seq.num_prompt_tokens // self.page_size
        if full:
            self.prefix_cache.register(seq.prompt_token_ids,
                                       seq.pages[:full])

    def _grow_decode_pages(self, window: int) -> list[Sequence]:
        """Ensure every running seq has pages covering a ``window``-step
        decode (the device writes ``window`` new KV entries before the host
        sees any token); preempt the youngest until the rest fit. Returns
        the sequences whose pages now cover the window — the decode rows of
        this step. Shared by the pure decode path (window = decode_window)
        and the mixed path (window = 1: mixed steps advance decode by one
        token, since the chunk in the same program runs once)."""
        scheduled: list[Sequence] = []
        idx = 0
        while idx < len(self.running):
            seq = self.running[idx]
            # Window inputs occupy positions num_tokens-1 .. num_tokens+W-2
            # (see Sequence.last_window_pos for the clamp rationale).
            last_pos = seq.last_window_pos(
                seq.num_tokens - 1, window, self.config.effective_max_len)
            pages_needed = cdiv(last_pos + 1, self.page_size)
            grow = pages_needed - len(seq.pages)
            if grow > 0:
                if self.allocator.can_allocate(grow):
                    seq.pages.extend(self.allocator.allocate(grow))
                else:
                    # Victim selection: legacy youngest-last when QoS is
                    # off; tier-aware (lowest-priority-first, never a
                    # higher tier for a lower requester) when on — always
                    # among running[idx:], the not-yet-granted tail.
                    if not self._preempt_victim(idx):
                        break
                    continue  # retry same index (list shrank behind idx)
            scheduled.append(seq)
            idx += 1
        return scheduled

    def _schedule_decode(self) -> Optional[ScheduledBatch]:
        if not self.running:
            return None
        scheduled = self._grow_decode_pages(self.config.scheduler.decode_window)
        if not scheduled:
            return None

        B = _bucket(len(scheduled), self.decode_buckets)
        # Static page-table width: sized for max_model_len once, so the jitted
        # decode program never recompiles as contexts grow. Costless on the
        # device side — the Pallas decode kernel streams only the valid pages;
        # the table upload is B * pages_max * 4 bytes.
        pages_bucket = cdiv(self.config.effective_max_len, self.page_size)
        tokens = np.zeros(B, np.int32)
        positions = np.zeros(B, np.int32)
        slot_mapping = np.zeros(B, np.int32)
        page_tables = np.zeros((B, pages_bucket), np.int32)
        context_lens = np.zeros(B, np.int32)
        for s, seq in enumerate(scheduled):
            self._fill_decode_row(seq, s, 0, tokens, positions, slot_mapping,
                                  page_tables, context_lens)

        return ScheduledBatch(
            kind="decode", seqs=scheduled, tokens=tokens, positions=positions,
            slot_mapping=slot_mapping, page_tables=page_tables,
            context_lens=context_lens, **self._sampling_arrays(scheduled, B))

    def _sampling_arrays(self, seqs: list[Sequence], B: int,
                         rows: Optional[list[int]] = None) -> dict:
        """Per-row sampling parameter arrays [B]. ``rows`` maps seqs[i] to a
        device row other than i (spec_mixed: the chunk rides row R_pad past
        the bucketed spec rows); padding rows keep the greedy/no-op
        defaults."""
        arrays = dict(
            temperature=np.zeros(B, np.float32),  # padding samples greedily
            top_k=np.zeros(B, np.int32),
            top_p=np.ones(B, np.float32),
            presence=np.zeros(B, np.float32),
            frequency=np.zeros(B, np.float32),
            seed=np.full(B, -1, np.int32),
            prompt_lens=np.zeros(B, np.int32),
            top_n=np.zeros(B, np.int32))
        for s, seq in enumerate(seqs):
            self._fill_sampling_row(arrays, rows[s] if rows else s, seq)
        return arrays

    @staticmethod
    def _fill_sampling_row(arrays: dict, row: int, seq: Sequence) -> None:
        p = seq.params
        arrays["temperature"][row] = p.temperature
        arrays["top_k"][row] = p.top_k
        arrays["top_p"][row] = p.top_p
        arrays["presence"][row] = p.presence_penalty
        arrays["frequency"][row] = p.frequency_penalty
        arrays["prompt_lens"][row] = seq.num_prompt_tokens
        arrays["top_n"][row] = p.top_logprobs
        if p.seed is not None:
            # OpenAI accepts any integer seed; the device key derivation
            # wants a non-negative int32, so fold into 31 bits here.
            arrays["seed"][row] = p.seed & 0x7fffffff
