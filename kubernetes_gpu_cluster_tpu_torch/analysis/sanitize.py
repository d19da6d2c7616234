"""Runtime sanitizers (``KGCT_SANITIZE=1``): dynamic hot-path invariants.

Static rules (analysis/rules/) prove what syntax can prove; two invariants
are dynamic by nature and get a runtime shadow instead, armed by env var
exactly like the ``KGCT_FAULT`` chaos harness that tests them:

- **Step-output guard**: every engine step's fetched token ids and
  logprobs are checked — NaN/inf logprobs and out-of-vocab ids raise
  :class:`SanitizerError` at the step that produced them instead of
  surfacing as corrupt JSON three services downstream.
- **KV-slot shadow**: the spec-decode rollback contract
  (engine/spec/verifier.py) — no KV write into a sequence's committed
  history, and every rejected-draft slot overwritten before any read —
  checked against a host-side shadow of slot states on every spec/decode
  dispatch.

Cost model: OFF (default) the engine holds ``None`` and pays one
``is None`` test per hook — outputs are byte-identical with the sanitizer
absent (tests pin this). ON, checks are numpy-vectorized host work in step
scope; sanitize mode is for chaos tests, canary replicas and incident
reproduction, not steady-state serving. Every hook takes HOST arrays (the
engine's numpy batch fields and fetched outputs): ``np.asarray`` of a CUDA
tensor raises, and a copy inside a hook would add a device sync.

Scope: the shadow covers the pure-decode and spec-verify dispatch paths,
where the committed-length invariant (``writes only at positions >=
num_tokens - 1``) holds by construction, and a mixed step's decode rows
(the engine reports them as one-token decode windows). Prefill and chunk
writes legitimately target positions below ``num_tokens`` (the prompt is
not yet committed) and are guarded statically by KGCT005 instead.
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Optional

import numpy as np


class SanitizerError(AssertionError):
    """A runtime invariant guarded by KGCT_SANITIZE was violated."""


def sanitize_enabled() -> bool:
    return os.environ.get("KGCT_SANITIZE", "").strip() not in ("", "0")


def interleave_enabled() -> bool:
    return (os.environ.get("KGCT_SANITIZE_INTERLEAVE", "").strip()
            not in ("", "0"))


def build_interleave_sanitizer() -> Optional["InterleaveSanitizer"]:
    """AsyncLLMEngine's construction seam: None (zero-cost hooks) unless
    ``KGCT_SANITIZE_INTERLEAVE=1``; ``KGCT_INTERLEAVE_SEED`` picks the
    schedule (default 0)."""
    if not interleave_enabled():
        return None
    return InterleaveSanitizer(
        int(os.environ.get("KGCT_INTERLEAVE_SEED", "0") or "0"))


class InterleaveSanitizer:
    """Deterministic yield-point injection at the sanctioned loop/worker
    seam crossings — the runtime counterpart of KGCT019–021.

    The static rules prove the await-window/ownership/lock invariants
    syntactically; this sanitizer makes the chaos tests EXERCISE them:
    every hook site (request submit, stream relay, worker wake, pre-step)
    asks :meth:`decide` whether to yield, and the decision is a pure
    function of ``(seed, site, per-site counter)`` — same seed, same
    workload ⇒ the same interleaving replays exactly, so a race the
    rules claim is closed can be hunted at every seeded schedule and a
    failure reproduces from its seed alone.

    Threading: each site string is touched from exactly ONE thread
    (``generate.*`` on the event loop, ``worker.*`` on the engine worker
    thread), so the per-site counters need no lock and the decision
    sequence per site is deterministic regardless of cross-thread
    timing. ``trace`` records (site, n, yielded) for test assertions;
    appends are GIL-atomic.

    Loop-side hooks call :meth:`decide` and ``await asyncio.sleep(0)``
    themselves (a sanitizer cannot await); worker-side hooks use
    :meth:`worker_yield`, a bounded ``time.sleep`` that widens the
    windows the await-atomicity rule polices.
    """

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._counters: dict = {}
        self.trace: list = []     # (site, n, yielded) in decision order

    def decide(self, site: str) -> tuple:
        """(yielded, delay seconds) for this site's next crossing."""
        n = self._counters.get(site, 0)
        self._counters[site] = n + 1
        h = int.from_bytes(
            hashlib.blake2b(f"{self.seed}:{site}:{n}".encode(),
                            digest_size=8).digest(), "big")
        yielded = (h & 3) == 0            # perturb ~25% of crossings
        delay = ((h >> 2) & 3) * 2e-4     # 0 / 0.2 / 0.4 / 0.6 ms
        self.trace.append((site, n, yielded))
        return yielded, delay

    def worker_yield(self, site: str) -> None:
        """Worker-thread yield point: sleep long enough for the event
        loop to run coroutines into any window left open here. Never
        called under ``_cv`` — sleeping under a loop-contended lock is
        exactly the bug KGCT021 exists to reject."""
        yielded, delay = self.decide(site)
        if yielded:
            time.sleep(delay if delay > 0 else 1e-4)


def build_step_sanitizer(page_size: int) -> Optional["StepSanitizer"]:
    """The engine's construction seam: None (zero-cost hooks) unless
    ``KGCT_SANITIZE=1`` is set in the environment."""
    return StepSanitizer(page_size) if sanitize_enabled() else None


class StepSanitizer:
    def __init__(self, page_size: int):
        self.page_size = page_size
        # request_id -> {position: slot} for KV slots written by a spec
        # step but REJECTED at verification: garbage until overwritten.
        self._stale: dict = {}
        # request_id -> [(position, slot)] written by the in-flight spec
        # dispatch (consumed by on_spec_commit).
        self._spec_writes: dict = {}
        # request_id -> the Sequence OBJECT the shadow state belongs to.
        # Request ids recycle (generate() numbers from zero per call, a
        # restarted client may resend one): shadow state must die with its
        # sequence, not haunt the next request wearing the same id.
        self._owner: dict = {}
        self.checks = 0           # observability: hooks that ran

    # -- step-output guard ---------------------------------------------------

    def check_outputs(self, next_tokens, logprobs, emit_counts,
                      vocab_size: int, num_seqs: int) -> None:
        """NaN/inf logprobs or out-of-vocab token ids in the columns the
        host will actually consume (``emit_counts`` caps spec rows; padding
        rows past ``num_seqs`` are never read and never checked)."""
        self.checks += 1
        toks = np.asarray(next_tokens)[:num_seqs]
        lps = np.asarray(logprobs, dtype=np.float64)[:num_seqs]
        if toks.ndim == 1:
            toks, lps = toks[:, None], lps[:, None]
        width = toks.shape[1]
        if emit_counts is None:
            mask = np.ones(toks.shape, bool)
        else:
            counts = np.asarray(emit_counts)[:num_seqs]
            mask = np.arange(width)[None, :] < counts[:, None]
        bad_tok = mask & ((toks < 0) | (toks >= vocab_size))
        if bad_tok.any():
            r, c = np.argwhere(bad_tok)[0]
            raise SanitizerError(
                f"step output sanitizer: token id {int(toks[r, c])} out of "
                f"vocab [0, {vocab_size}) at row {r} col {c}")
        bad_lp = mask & ~np.isfinite(lps)
        if bad_lp.any():
            r, c = np.argwhere(bad_lp)[0]
            raise SanitizerError(
                f"step output sanitizer: non-finite logprob "
                f"{lps[r, c]!r} at row {r} col {c} — NaN/inf escaped the "
                "step")

    # -- KV-slot shadow ------------------------------------------------------

    def _sync_batch(self, seqs) -> None:
        """Align shadow state with a full-decode/spec batch's live
        sequences. Absent ids are finished or preempted (pages released
        either way); a PRESENT id owned by a DIFFERENT Sequence object is
        a recycled request id — both ways the old shadow state is
        meaningless and must not alias onto reallocated pages."""
        live = {s.request_id: s for s in seqs}
        for d in (self._stale, self._spec_writes, self._owner):
            for rid in [r for r in d if r not in live]:
                del d[rid]
        for rid, seq in live.items():
            if self._owner.get(rid) is not seq:
                self._stale.pop(rid, None)
                self._spec_writes.pop(rid, None)
                self._owner[rid] = seq

    def on_spec_dispatch(self, batch, seqs=None, token_start: int = 0) -> None:
        """Pre-dispatch check of a spec-verify batch's explicit
        ``slot_mapping``: (a) no write into ANY sequence's committed KV
        region — the slot is resolved through a batch-wide page-ownership
        map, so a mis-AIMED slot is caught whether it lands in the writing
        row's own history or another sequence's (the claimed position
        looks legal either way); (b) no committed-region read while a
        rejected-draft slot in that region is still stale.

        ``seqs``/``token_start``: the spec×mixed step carries its verify
        slices at a token-axis OFFSET past the prefill chunk, whose writes
        legitimately target uncommitted prompt positions (guarded
        statically by KGCT005, like every prefill) — the caller passes the
        verify rows and where their slots start, and only that region is
        shadow-checked."""
        self.checks += 1
        ps = self.page_size
        seqs = batch.seqs if seqs is None else seqs
        self._sync_batch(seqs)
        # page -> (owning seq, page index in its list). Prefix-cache pages
        # shared by several sequences keep one owner; shared pages are
        # fully committed prompt prefix for every sharer, so any owner's
        # committed bound is a valid (possibly under-) approximation.
        page_owner: dict = {}
        for seq in seqs:
            for idx, page in enumerate(seq.pages):
                page_owner.setdefault(page, (seq, idx))
        seg_ids = np.asarray(batch.seg_ids)[token_start:]
        positions = np.asarray(batch.positions)[token_start:]
        slots = np.asarray(batch.slot_mapping)[token_start:]
        writes: dict = {s.request_id: [] for s in seqs}
        for i in range(len(slots)):
            row = int(seg_ids[i])
            if row < 0 or row >= len(seqs):
                continue
            slot = int(slots[i])
            if slot < ps:
                continue                      # scrap-page routing
            seq = seqs[row]
            committed = seq.num_tokens - 1    # KV valid for [0, n-1)
            owner = page_owner.get(slot // ps)
            linear = None
            if owner is not None:
                o_seq, idx = owner
                o_linear = idx * ps + slot % ps
                if o_linear < o_seq.num_tokens - 1:
                    whose = ("" if o_seq is seq
                             else f" owned by {o_seq.request_id}")
                    raise SanitizerError(
                        f"KV shadow: spec write from {seq.request_id} into "
                        f"COMMITTED slot {slot} (position {o_linear} < "
                        f"committed {o_seq.num_tokens - 1}{whose}) — "
                        "rollback contract violated")
                if o_seq is seq:
                    linear = o_linear
            if int(positions[i]) < committed:
                raise SanitizerError(
                    f"KV shadow: spec write claims committed position "
                    f"{int(positions[i])} < {committed} of {seq.request_id}")
            writes[seq.request_id].append(
                (linear if linear is not None else int(positions[i]), slot))
        for seq in seqs:
            rid = seq.request_id
            written = {p for p, _ in writes[rid]}
            committed = seq.num_tokens - 1
            for pos in list(self._stale.get(rid, ())):
                if pos < committed and pos not in written:
                    raise SanitizerError(
                        f"KV shadow: committed region of {rid} reaches "
                        f"position {pos} whose rejected-draft slot was "
                        "never overwritten — stale KV served as context")
                if pos in written:
                    del self._stale[rid][pos]
            self._spec_writes[rid] = writes[rid]

    def on_spec_commit(self, batch, emit_counts) -> None:
        """Post-verification: writes past each row's accepted prefix are
        rejected drafts — record them stale until a later dispatch
        overwrites them (positions are append-only, so the very next write
        lands on the first stale slot)."""
        for s, seq in enumerate(batch.seqs):
            rid = seq.request_id
            bound = seq.num_tokens - 1 + int(emit_counts[s])
            for pos, slot in self._spec_writes.pop(rid, ()):
                if pos >= bound:
                    self._stale.setdefault(rid, {})[pos] = slot

    def on_swap_restore(self, seq) -> None:
        """Two-tier KV cache: a sequence restored from the host tier holds
        ONLY committed history — swap-out copies exactly the pages covering
        positions [0, num_tokens-1), so any rejected-draft slots (always at
        or past the committed length) died with the discarded device pages.
        Clear their shadow records or the next decode dispatch would flag
        positions that no longer exist as unconsumed stale KV."""
        self.checks += 1
        rid = seq.request_id
        self._stale.pop(rid, None)
        self._spec_writes.pop(rid, None)
        self._owner[rid] = seq

    def on_decode_dispatch(self, seqs, positions, window: int) -> None:
        """Decode-window dispatch: writes cover ``[pos0, pos0 + window)``
        per row. The committed check is position-based (slots are computed
        on device); stale slots inside the write range are being
        overwritten, stale slots BELOW the window's start are context this
        window reads."""
        self.checks += 1
        self._sync_batch(seqs)
        for s, seq in enumerate(seqs):
            if seq.is_finished:
                continue                      # zombie rows of a chain
            rid = seq.request_id
            pos0 = int(positions[s])
            if pos0 < seq.num_tokens - 1:
                raise SanitizerError(
                    f"KV shadow: decode window of {rid} starts at position "
                    f"{pos0} inside committed history "
                    f"(< {seq.num_tokens - 1})")
            stale = self._stale.get(rid)
            if not stale:
                continue
            for pos in list(stale):
                if pos0 <= pos < pos0 + window:
                    del stale[pos]            # overwritten by this window
                elif pos < pos0:
                    raise SanitizerError(
                        f"KV shadow: decode window of {rid} reads context "
                        f"through position {pos0} but rejected-draft slot "
                        f"at position {pos} is still stale")
