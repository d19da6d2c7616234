"""LLMEngine: the single-device serving engine (continuous batching), in
PyTorch.

The JAX package's ``engine/engine.py`` step for step:

- owns model params, the paged KV cache (updated in place by every step)
  and the scheduler;
- runs each scheduled batch as one prefill, chunked-prefill, mixed,
  speculative-verification (``spec``), spec×mixed or W-substep
  decode-window step, with sampling on the device so only the sampled token
  ids (and their logprobs) cross to the host;
- keeps a decode window's tokens on the device (each substep feeds the
  previous one's output back) with ONE download per window, and chains
  windows speculatively: window w+1 is enqueued before window w's tokens are
  fetched. The fetch of w is a non-blocking copy into pinned host memory
  enqueued right behind w's kernels plus an event, so waiting for it never
  waits for w+1.

Weights: ``params`` as ``engine/weights.load_weights`` returns them (a
local HF checkpoint, quantized on the host when
``ModelConfig.quantization`` is "int8" or "int4"), or ``None`` for random
weights from ``config.seed``, drawn directly in the quantized layout when
quantization is set. The page pool is sized from the device's free memory
after the weights exist, so a quantized model's smaller footprint leaves
room for more KV pages; nothing else in the engine depends on the rung.

Step programs (``engine/step_programs.py``), the counterpart of the JAX
engine's bucketed jit programs: on one card the decode window (one program
per (greedy|sampled, decode bucket)), the ragged prefill (per (prefill
bucket, row bucket)), the solo chunk (per (prefill bucket, history
width)), the mixed step (per (prefill bucket, row bucket, history width)),
the spec verify step (per (row bucket, S)), the spec×mixed step (per
(prefill bucket, row bucket, history width, S)) and the draft runner's
decode dispatch and reset chunk are each captured into a CUDA graph at
their key's first step and replayed, keyed as the JAX jit caches are; the
dispatcher fills the program's static inputs from pinned host buffers
before each replay and starts the one fetch after it.
The KV transfers (swap, prefix spill and restore, handoff export and
import) are the cache's ``kv_gather`` and ``kv_scatter`` programs, keyed
by the page count's power of two as the JAX gather and scatter jit caches
(``engine/kv_cache.py``). ``compiled_step_variants`` counts the programs
built (on the CPU the same keys around the eager bodies).
``EngineConfig.enforce_eager`` turns capture off, as in the JAX package,
and runs the same bodies. Eager on purpose: every step of a rank under
torch.distributed (tp, ep, pp, sp: gloo's host-staged collectives cannot
be captured; sp's ring prefill and pp's pipeline forward run inside the
same bodies), whose engine builds no program. The JAX package's donation
bookkeeping and probe-and-fall-back kernel logic have no counterpart: on a
CUDA device the attention runs the hand-written kernels (``ops/cuda``) or
raises.

Speculative decoding (``SchedulerConfig.spec_decode_enabled``): the
scheduler's proposer (n-gram lookup, or with ``spec_draft_model`` a draft
model with its own KV pool, ``engine/spec/draft_model.py``) drafts k tokens
per running sequence and one step verifies them all; decode windows never
chain while it is on.

The KV transfer layer (``engine/kv_cache.py``): with
``CacheConfig.swap_space_gb`` > 0 a host KV tier takes swap preemptions
and prefix-cache spills; the export/import seams (``export_held``,
``export_running``, ``import_request``, ``export_prefix`` and the streamed
prefix import, ``accept_remote_spill``) move committed pages between
replicas as host-buffer state dicts that read the same as the JAX
package's. The wire codec (``serving/handoff.py`` in the JAX package)
will sit on these dicts.

Tensor and expert parallelism (``parallel/``): with ``groups`` (one
rank's ``ParallelGroups``, e.g. ``mesh_from_config(config.parallel)``
once ``torch.distributed`` is up) the engine holds this rank's slices of the
weights (random init draws each full tensor from the seed and keeps the
slice) and a pool of its local kv heads, sized by the MIN of every rank's
free memory. Every rank samples from the same all-gathered logits with the
same generators, so ranks fed the same requests in the same order
(``serving/multihost.py``) step in lockstep.

Pipeline and sequence parallelism (``parallel/pp.py``, ``parallel/sp.py``),
as the JAX engine: under pp each rank holds its stage's layers and their
slab of the pool, and prefill, decode substeps and history chunks run
through ``pipeline_forward``; under sp every rank holds the tp slices and
the whole pool, prefill attention runs around the sp ring, and decode and
history chunks run on every rank. Neither has a mixed or a spec-verify
forward, so both turn off mixed batching and speculative decoding (with
the JAX package's warnings), and they do not combine with each other.

Runtime sanitizers (``KGCT_SANITIZE=1``, ``analysis/sanitize.py``), at
the JAX engine's sites: the KV-slot shadow checks every spec, spec×mixed
and decode-window dispatch before its inputs are uploaded and learns of
swap restores and imports; the step-output guard checks every fetched
window. Each hook is handed the host arrays the step already holds
(``batch.*`` before a program's static inputs are filled, the fetched
``toks_np`` / ``lps_np``), so the sanitizer adds no device->host
synchronization. Off, the engine holds
``None`` and each hook is one ``is None`` test.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import time
from typing import Optional

import numpy as np
import torch

from ..analysis.sanitize import build_step_sanitizer
from ..config import EngineConfig
from ..models import llama as model_lib
from ..observability import Observability
from ..ops.gates import when
from ..ops.sampling import (TOP_LOGPROBS, apply_logit_bias, apply_penalties,
                            build_counts, row_sample_keys,
                            sample_and_logprobs, spec_verify_sample,
                            token_logprobs, write_top_logprobs)
from ..parallel.pp import pipeline_forward
from ..parallel.sharding import (init_shard_fn, local_kv_config,
                                 shard_params, validate)
from ..parallel.sp import ring_prefill_attention
from ..resilience.faults import inject as _inject_fault
from ..utils import cdiv, get_logger
from .kv_cache import (KVPageIO, KVTransferPrograms, KVTransferRefused,
                       allocate_kv_cache, build_kv_swapper, derive_num_pages,
                       dtype_name, host_tensor, transfer_bytes,
                       transfer_pages)
from .sampling_params import LOGIT_BIAS_CAP, SamplingParams
from .scheduler import ScheduledBatch, Scheduler, _bucket
from .sequence import FinishReason, Sequence, SequenceStatus
from .step_programs import StepPrograms, program_bytes

logger = get_logger("engine")

DEFAULT_PAGE_SIZE = 16

# A step program's int32 input ``flags``, in this order: the conditions of
# the JAX programs' ``lax.cond`` stages (``step_flags``). The ``chunk_*``
# flags are a spec×mixed step's chunk row's, beside its verify rows'.
STEP_FLAGS = ("any_sampled", "needs_filter", "any_pen", "any_bias",
              "any_top", "chunk_sampled", "chunk_filter", "chunk_pen")


def step_flags(batch, bias_ids: np.ndarray,
               verify_rows: Optional[int] = None) -> np.ndarray:
    """``STEP_FLAGS`` of a step, as its JAX program computes them on the
    device from the same arrays, padding rows included:
    ``any(temperature > 0)``, ``any((top_k > 0) | (top_p < 1))``,
    ``any((presence != 0) | (frequency != 0))``, ``any(bias_ids >= 0)``
    and ``any(top_n > 0)``. With ``verify_rows`` (a spec×mixed step) the
    first three cover those rows and the ``chunk_*`` ones the rest;
    bias and alternatives cover every row, as one ``_maybe_bias`` and one
    ``any_top`` do there."""
    def rows(sl):
        return {"sampled": np.any(batch.temperature[sl] > 0),
                "filter": np.any((batch.top_k[sl] > 0)
                                 | (batch.top_p[sl] < 1.0)),
                "pen": np.any((batch.presence[sl] != 0)
                              | (batch.frequency[sl] != 0))}
    main = rows(slice(verify_rows))
    flags = {"any_sampled": main["sampled"], "needs_filter": main["filter"],
             "any_pen": main["pen"], "any_bias": np.any(bias_ids >= 0),
             "any_top": np.any(batch.top_n > 0)}
    if verify_rows is not None:
        chunk = rows(slice(verify_rows, None))
        flags.update(chunk_sampled=chunk["sampled"],
                     chunk_filter=chunk["filter"], chunk_pen=chunk["pen"])
    return np.array([bool(flags.get(name, False)) for name in STEP_FLAGS],
                    np.int32)


@dataclasses.dataclass
class EngineStats:
    """Aggregate serving counters."""
    tokens_generated: int = 0
    requests_finished: int = 0
    prefill_tokens: int = 0
    steps: int = 0


@dataclasses.dataclass
class RequestOutput:
    request_id: str
    prompt_token_ids: list[int]
    output_token_ids: list[int]
    finished: bool
    finish_reason: Optional[str] = None
    new_token_ids: Optional[list[int]] = None  # tokens produced this step
    new_logprobs: Optional[list[float]] = None  # chosen-token logprobs, ditto
    output_logprobs: Optional[list[float]] = None  # full per-token record
    # OpenAI logprobs=N alternatives: per new token, [(token_id, logprob)]
    # of the N most likely tokens (N = SamplingParams.top_logprobs).
    new_top_logprobs: Optional[list[list[tuple[int, float]]]] = None
    output_top_logprobs: Optional[list[list[tuple[int, float]]]] = None


def resolve_device(device) -> torch.device:
    """The engine's device. CUDA unless the caller asks for the CPU; a CUDA
    request on a host without a card raises (no CPU continuation)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the engine runs on the card "
                "(pass device='cpu' to run the plain PyTorch path)")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


def device_memory_stats(device: torch.device) -> tuple:
    """(bytes total, bytes allocated) of ``device`` — the
    ``kgct_hbm_bytes_{limit,in_use}`` gauges. The card's total memory from
    ``torch.cuda.mem_get_info`` and the caching allocator's live bytes
    from ``torch.cuda.memory_allocated``, both host-side queries that
    never synchronize the device; (0, 0) on the CPU, so a scrape stays
    nan-free."""
    if device.type != "cuda":
        return (0, 0)
    return (int(torch.cuda.mem_get_info(device)[1]),
            int(torch.cuda.memory_allocated(device)))


def validate_layout(config: EngineConfig, sizes: dict) -> None:
    """The JAX engine's refusals of a parallel layout, before any rank
    starts: sp and pp together, prefill buckets that the sp ring cannot
    split, ep on a dense model, and (``parallel.sharding.validate``) a
    model the tp, ep or pp split does not divide."""
    sp, pp, ep = sizes["sp"], sizes["pp"], sizes["ep"]
    if sp > 1:
        if pp > 1:
            raise ValueError("sp and pp cannot combine in one mesh")
        bad = [b for b in config.scheduler.prefill_buckets if b % sp]
        if bad:
            raise ValueError(
                f"prefill buckets {bad} not divisible by sp={sp}"
                " (ring attention shards the token axis)")
    if ep > 1 and not config.model.is_moe:
        raise ValueError(f"ep={ep} requires an MoE model; "
                         f"{config.model.name} is dense")
    validate(config.model, sizes["tp"], ep, pp)


def resolve_groups(config: EngineConfig, groups):
    """The engine's ``ParallelGroups``: ``groups`` (None at world size 1),
    after ``validate_layout``; a parallel config without ``groups`` is
    refused rather than run on one rank."""
    validate_layout(config, groups.sizes if groups is not None
                    else dataclasses.asdict(config.parallel))
    if groups is None:
        if config.parallel.world_size > 1:
            raise RuntimeError(
                f"parallel config {config.parallel} needs this rank's "
                "groups: call parallel.initialize_distributed, then pass "
                "groups=parallel.mesh_from_config(config.parallel)")
        return None
    return groups if groups.world_size > 1 else None


class LLMEngine:
    def __init__(self, config: EngineConfig, params=None,
                 eos_token_id: Optional[int] = None,
                 device: torch.device | str = "cuda", draft_params=None,
                 groups=None):
        """``draft_params``: the draft model's weights when
        ``SchedulerConfig.spec_draft_model`` is set (random from the seed
        when None; the draft model stays whole on every rank).
        ``groups``: this rank's ``parallel.ParallelGroups`` (None at world
        size 1). ``params``
        may be the full weights or this rank's slices."""
        self.device = resolve_device(device)
        sc = config.scheduler
        groups = resolve_groups(config, groups)
        self.groups = groups
        if groups is not None and self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        model_lib.check_supported(config.model)
        if config.cache.page_size is None:
            config = dataclasses.replace(config, cache=dataclasses.replace(
                config.cache, page_size=DEFAULT_PAGE_SIZE))
        self.config = config
        self.model_config = config.model
        self.eos_token_id = eos_token_id
        # Host-side generator for per-step keys of unseeded sampled rows.
        self._generator = torch.Generator().manual_seed(config.seed)

        if params is None:
            logger.info("initializing random weights for %s%s",
                        config.model.name,
                        f" (rank {groups.rank} of {groups.sizes})"
                        if groups is not None else "")
            gen = torch.Generator(device=self.device).manual_seed(config.seed)
            params = model_lib.init_params(
                config.model, gen, self.device,
                shard=(init_shard_fn(config.model, groups)
                       if groups is not None else None))
        elif groups is not None:
            params = shard_params(params, config.model, groups)
        self.params = params
        # This rank's pool geometry (its kv heads); the whole model's
        # without groups.
        kv_model = local_kv_config(config.model, groups)

        free = (torch.cuda.mem_get_info(self.device)[0]
                if self.device.type == "cuda" else None)
        programs = not config.enforce_eager and groups is None
        # The largest program's working memory stays in the graphs' shared
        # pool once captured, and the KV transfer programs' staging sits at
        # one address for every replay: both kept out of the pages, the
        # draft pool's too. Without programs nothing is reckoned.
        reserve = 0
        if free is not None and programs:
            draft = None
            if sc.spec_decode_enabled and sc.spec_draft_model:
                from .spec.draft_model import resolve_draft_config
                draft = resolve_draft_config(config, sc.spec_draft_model)
            reserve = (program_bytes(config, draft)
                       + transfer_bytes(kv_model, config.cache,
                                        config.effective_max_len))
            free -= reserve
        num_pages = derive_num_pages(
            kv_model, config.cache, config.effective_max_len,
            sc.max_num_seqs, free, groups=groups)
        # Cap: no point holding more pages than max_num_seqs full sequences.
        cap = sc.max_num_seqs * cdiv(config.effective_max_len,
                                     config.cache.page_size) + 1
        num_pages = min(num_pages, cap)
        logger.info("KV cache: %d pages x %d tokens (page pool)",
                    num_pages, config.cache.page_size)

        # One Observability per engine, shared with the scheduler.
        self.obs = Observability()
        self.scheduler = Scheduler(config, num_pages, obs=self.obs)
        if self.scheduler.qos is not None:
            self.obs.configure_qos_tiers(
                sc.qos_tiers, self.scheduler.qos.default_tier,
                fallback_budget_ms=config.resilience.default_ttft_budget_ms)
        self.kv_cache = allocate_kv_cache(kv_model, config.cache,
                                          num_pages, self.device)
        self.pp_size = groups.pp if groups is not None else 1
        self.sp_size = groups.sp if groups is not None else 1
        self._prefill_attn = None
        if self.sp_size > 1:
            self._prefill_attn = functools.partial(ring_prefill_attention,
                                                   groups=groups)
        if self.pp_size > 1 or self.sp_size > 1:
            # No mixed or spec-verify forward runs through the pipeline or
            # the ring: those layouts keep the prefill-else-decode policy.
            if self.scheduler.mixed_enabled:
                logger.warning(
                    "mixed batching disabled: no mixed forward path under "
                    "pp=%d/sp=%d meshes", self.pp_size, self.sp_size)
                self.scheduler.mixed_enabled = False
            if self.scheduler.spec_enabled:
                logger.warning(
                    "spec decode disabled: no spec-verify forward path under "
                    "pp=%d/sp=%d meshes", self.pp_size, self.sp_size)
                self.scheduler.spec_enabled = False
            self.scheduler.spec_mixed_enabled = False
        # The step programs, keyed per family as the JAX jit caches:
        # captured on the card, keyed around the eager bodies on the CPU,
        # none with enforce_eager or under torch.distributed (see
        # step_programs). The draft runner registers its families here.
        self._programs = StepPrograms(
            {"greedy": self._window_body, "sampled": self._window_body,
             "prefill": self._prefill_body,
             "prefill_hist": self._prefill_hist_body,
             "mixed": self._mixed_body, "spec": self._spec_body,
             "spec_mixed": self._spec_mixed_body},
            self._program_layout, self.device, enabled=programs)
        if self.scheduler.spec_enabled:
            if sc.spec_draft_model:
                # Built after the target pool: its own pool takes at most
                # half of the memory left beside the programs' reckoning.
                # The one installation site; the engine and scheduler reach
                # draft state only through the proposer seam.
                from .spec.draft_model import build_draft_runner
                self.scheduler.spec_proposer = build_draft_runner(
                    config, sc.spec_draft_model, params=draft_params,
                    device=self.device, groups=groups,
                    programs=self._programs, reserve_bytes=reserve)
            ctrl = self.scheduler.spec_controller
            self.obs.spec_current_k = (ctrl.current_k if ctrl is not None
                                       else sc.effective_spec_k_max)
        if self.scheduler.mixed_enabled:
            budget = sc.decode_priority_token_budget
            if budget is not None and budget < 2:
                raise ValueError(
                    f"decode_priority_token_budget={budget} can never fit a "
                    "decode row plus a chunk token; mixing would never engage")
            if budget is not None and budget < sc.max_num_seqs + 1:
                logger.warning(
                    "mixed batching: decode_priority_token_budget=%d is below"
                    " max_num_seqs+1=%d — a full batch's decode rows alone "
                    "exhaust it, so high-occupancy steps keep the legacy "
                    "policy", budget, sc.max_num_seqs + 1)
            if sc.max_num_seqs > sc.decode_buckets[-1]:
                logger.warning(
                    "mixed batching: max_num_seqs=%d exceeds the decode "
                    "bucket grid (max %d); steps with more running sequences"
                    " than the grid covers keep the legacy policy",
                    sc.max_num_seqs, sc.decode_buckets[-1])
        # Runtime sanitizers (KGCT_SANITIZE=1, analysis/sanitize.py):
        # step-output NaN/vocab guard + KV-slot shadow for the spec-decode
        # rollback contract. None when off — every hook is one is-None
        # test and outputs are byte-identical with the sanitizer absent.
        self._sanitizer = build_step_sanitizer(config.cache.page_size)
        # Two-tier KV cache (CacheConfig.swap_space_gb > 0): a pinned host
        # page pool; the scheduler preempts by swap instead of recompute,
        # and the prefix cache spills evicted pages for a second-chance
        # restore. None when off. One gather/scatter pair serves both
        # transfer seams (host tier and cross-replica handoff), two program
        # families of the engine's cache; both write into self.kv_cache in
        # place, so the pool is never rebound.
        self._kv_programs = KVTransferPrograms(
            self.device, self._programs,
            max_pages=transfer_pages(config.effective_max_len,
                                     config.cache.page_size))
        self.swapper = build_kv_swapper(
            kv_model, config.cache, self.kv_cache,
            get_kv=lambda: self.kv_cache, programs=self._kv_programs,
            obs=self.obs)
        if self.swapper is not None:
            self.scheduler.attach_swapper(self.swapper)
            if self.scheduler.prefix_cache is not None:
                self.scheduler.prefix_cache.attach_swapper(self.swapper)
            if self._sanitizer is not None:
                # The KV-slot shadow learns that a swapped-in slot is
                # committed history (stale spec slots died with the swap).
                self.swapper.on_restored = self._sanitizer.on_swap_restore
        self.kv_io = KVPageIO(get_kv=lambda: self.kv_cache,
                              programs=self._kv_programs)
        self.stats = EngineStats()
        self.step_count = 0
        # Speculative decode-window chain state (see _step).
        self._inflight: Optional[dict] = None
        # Set when an import joins ``running`` outside schedule(): a chained
        # window's batch no longer covers every runner, so the chain breaks
        # at the next step.
        self._batch_stale = False
        self._deferred_release: list[Sequence] = []
        # Streamed fleet-prefix imports in flight (begin_prefix_import):
        # handle -> {pages, token_ids, start_page, filled}; pages are
        # released on commit/abort.
        self._prefix_imports: dict[str, dict] = {}
        self._prefix_import_seq = 0
        self._last_step_info = None
        self._ttft_transfer_s: Optional[float] = None
        # Width of the host->device output-token resync buffer for the
        # penalty histogram (outputs are bounded by the model length).
        self._out_cap = config.effective_max_len
        self.obs.flight.set_snapshot_source(self._flight_snapshot)

    def _flight_snapshot(self) -> dict:
        sched = self.scheduler
        alloc = sched.allocator
        snap = {"waiting": len(sched.waiting), "running": len(sched.running),
                "swapped": len(sched.swapped), "step": self.step_count,
                "kv_pages_free": alloc.num_free,
                "kv_pages_total": alloc.num_pages}
        if self.swapper is not None:
            snap["host_pages_in_use"] = self.swapper.host.num_in_use
            snap["host_pages_total"] = self.swapper.host.num_pages
        return snap

    # -- host <-> device ----------------------------------------------------

    def _up(self, a) -> torch.Tensor:
        """A host array on the engine's device. On the card it is staged in
        pinned memory and copied without blocking: a copy from pageable
        memory waits for the stream, so a chained window's inputs would
        wait for the window before it. PyTorch's pinned allocator keeps the
        staging block from reuse until its copy has run."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _start_fetch(self, *tensors: torch.Tensor):
        """Enqueue device->host copies of ``tensors`` right behind the work
        that produces them; returns (host tensors, event). Waiting on the
        event waits for these copies only, not for work enqueued later."""
        if self.device.type != "cuda":
            return [t.clone() for t in tensors], None
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in tensors]
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return host, event

    @staticmethod
    def _finish_fetch(fetch) -> list[np.ndarray]:
        host, event = fetch
        if event is not None:
            event.synchronize()
        return [h.numpy() for h in host]

    @staticmethod
    def _bias_arrays(batch: ScheduledBatch) -> tuple[np.ndarray, np.ndarray]:
        """[B, LOGIT_BIAS_CAP] token ids (-1 = empty slot) and values of
        every device row's ``logit_bias``."""
        B = len(batch.temperature)
        ids = np.full((B, LOGIT_BIAS_CAP), -1, np.int32)
        vals = np.zeros((B, LOGIT_BIAS_CAP), np.float32)
        for s, seq in batch.device_seq_rows():
            for j, (tok, b) in enumerate((seq.params.logit_bias
                                          or {}).items()):
                ids[s, j] = tok
                vals[s, j] = b
        return ids, vals

    def _penalty_out_tokens(self, batch: ScheduledBatch) -> torch.Tensor:
        """[B, out_cap] -1-padded output-token ids for the device-side
        penalty histogram."""
        out = np.full((len(batch.temperature), self._out_cap), -1, np.int32)
        for s, seq in batch.device_seq_rows():
            ids = seq.output_token_ids[:self._out_cap]
            out[s, :len(ids)] = ids
        return self._up(out)

    def _next_step_key(self) -> int:
        return int(torch.randint(0, 2 ** 31 - 1, (1,),
                                 generator=self._generator))

    # -- public API ---------------------------------------------------------

    def add_request(self, request_id: str, prompt_token_ids: list[int],
                    params: Optional[SamplingParams] = None,
                    hold_kv: bool = False,
                    arrival_t0: Optional[float] = None,
                    resume_outputs: Optional[list[int]] = None) -> None:
        """``hold_kv``: disaggregated-prefill mode — when the request
        finishes (normally with max_tokens=1 on a prefill replica), its
        committed KV pages are HELD for :meth:`export_held` instead of
        released; the caller owns the export-or-discard.
        ``arrival_t0``: backdated ``time.monotonic()`` arrival stamp.
        ``resume_outputs``: token-replay resume — tokens already generated
        elsewhere are pre-seeded as OUTPUT history and replayed through the
        recompute prefill; greedy and seeded continuations are identical to
        the uninterrupted run. Raises ValueError when the replayed history
        already satisfies a stop condition."""
        params = params or SamplingParams()
        if params.logit_bias:
            V = self.model_config.vocab_size
            bad = [t for t in params.logit_bias if t >= V]
            if bad:
                raise ValueError(
                    f"logit_bias token ids {bad[:5]} out of range for "
                    f"vocab_size {V}")
        seq = Sequence(request_id, prompt_token_ids, params,
                       eos_token_id=self.eos_token_id)
        seq.hold_kv = hold_kv
        if arrival_t0 is not None:
            seq.arrival_time = min(arrival_t0, seq.arrival_time)
        if resume_outputs:
            for tok in resume_outputs:
                seq.append_token(int(tok))
            if seq.check_stop(self.config.effective_max_len) is not None:
                raise ValueError(
                    f"resume history of {len(resume_outputs)} tokens "
                    "already satisfies a stop condition; nothing to resume")
        self.obs.on_arrival(seq)
        try:
            self.scheduler.add(seq)
        except Exception:
            # Admission rejected: close the just-opened trace span.
            self.obs.on_finish(seq, FinishReason.ABORT)
            raise

    def abort_request(self, request_id: str) -> bool:
        # A sequence in the in-flight window still has device KV writes
        # pending against its pages: finish it but defer the page release
        # until the chain drains.
        if self._inflight is not None:
            for seq in self._inflight["batch"].seqs:
                if seq.request_id == request_id and not seq.is_finished:
                    seq.status = SequenceStatus.FINISHED
                    seq.finish_reason = FinishReason.ABORT
                    if seq in self.scheduler.running:
                        self.scheduler.running.remove(seq)
                    self._inflight["zombies"].add(request_id)
                    self._deferred_release.append(seq)
                    self.stats.requests_finished += 1
                    self.obs.on_finish(seq, FinishReason.ABORT)
                    return True
        if self.scheduler.abort(request_id):
            self.stats.requests_finished += 1
            return True
        if request_id in self.scheduler.held:
            # A held prefill whose exporter died between finish and export:
            # the sequence already counted as finished, only its parked
            # pages remain, and no other abort path scans ``held``.
            self.discard_held(request_id)
            return True
        return False

    def has_unfinished_requests(self) -> bool:
        # An in-flight window must be drained even if every sequence
        # finished (its deferred page releases happen at drain time).
        return self.scheduler.has_work() or self._inflight is not None

    def compiled_step_variants(self) -> int:
        """Step programs built so far, every family's captured graphs (on
        the CPU the same keys around the eager bodies): the decode window
        at most two per decode bucket, the prefill, solo-chunk, mixed,
        spec and spec×mixed steps, the draft runner's two families and
        the KV gather and scatter one per key of the JAX bucket grid (the
        transfers one per power of two of pages, as the JAX engine counts
        its gather and scatter jit caches). 0 with ``enforce_eager`` and on
        a rank under torch.distributed, which capture nothing. Exported as
        ``kgct_jit_compiles_total``: a steady serving process holds it
        flat, as the JAX engine's jit cache count."""
        return len(self._programs)

    # -- KV handoff seams (disaggregated prefill/decode, live migration) ----
    #
    # A state dict: "model", "page_size", "dtype" (the JAX package's
    # spelling, e.g. "bfloat16"), the token/logprob history, "sampling",
    # and "k"/"v", CPU tensors [L, n, ps, kd] of the committed pages. The
    # importers also take numpy arrays there, so a state decoded by the JAX
    # package's wire codec imports as it is.

    def _export_state(self, seq: Sequence, k, v) -> dict:
        """The cross-replica sequence state, built from COMMITTED
        quantities only: the host-known token/logprob history and the
        already-fetched committed-page buffers — nothing of an in-flight
        window."""
        return {
            "model": self.model_config.name,
            "page_size": self.config.cache.page_size,
            "dtype": dtype_name(self.kv_cache.k.dtype),
            "prompt_token_ids": list(seq.prompt_token_ids),
            "output_token_ids": list(seq.output_token_ids),
            "output_logprobs": list(seq.output_logprobs),
            "output_top_logprobs": [
                [[int(t), float(lp)] for t, lp in top]
                for top in seq.output_top_logprobs],
            "sampling": seq.params.to_state(),
            "k": k, "v": v,
        }

    def export_held(self, request_id: str) -> dict:
        """Serialize a held finished prefill (``add_request(hold_kv=True)``)
        into one state dict: its committed KV pages (positions [0,
        num_tokens-1) — the last sampled token's KV is written by the
        decode side's first step, exactly like a swap restore) plus the
        generation state a decode replica needs to resume identically.
        Pages are released here; raises KeyError when nothing is held under
        ``request_id`` — the caller degrades to local recompute."""
        seq = self.scheduler.held.pop(request_id, None)
        if seq is None:
            raise KeyError(f"no held KV for request {request_id!r}")
        n = cdiv(seq.num_tokens - 1, self.config.cache.page_size)
        k, v = self.kv_io.export_pages(seq.pages[:n])
        # The copy completed above; only now may the pages return.
        self.scheduler.allocator.free(seq.pages)
        seq.pages = []
        return self._export_state(seq, k, v)

    def export_running(self, request_id: str) -> dict:
        """Live migration: snapshot a RUNNING sequence mid-decode into the
        state :meth:`export_held` produces and retire it locally
        (FinishReason.MIGRATE: terminal, but the stream continues on the
        peer). Greedy and seeded continuations on the importer are
        identical to the uninterrupted run.

        Safe against the decode-window chain: a sequence in the in-flight
        window becomes a ZOMBIE (its unfetched window tokens are dropped;
        the peer regenerates them) and its pages are released only when
        the chain drains. The gather is queued behind the in-flight window
        on the stream and reads only committed positions' pages.

        Raises KeyError when no RUNNING sequence owns ``request_id`` and
        RuntimeError when nothing is committed yet."""
        seq = self.scheduler.find_running(request_id)
        if seq is None:
            raise KeyError(f"no running sequence {request_id!r}")
        n = cdiv(seq.num_tokens - 1, self.config.cache.page_size)
        if n < 1 or n > len(seq.pages) or not seq.output_token_ids:
            raise RuntimeError(
                f"{request_id!r} has no committed KV to migrate")
        k, v = self.kv_io.export_pages(seq.pages[:n])
        state = self._export_state(seq, k, v)
        state["mid_stream"] = True
        self.scheduler.running.remove(seq)
        seq.status = SequenceStatus.FINISHED
        seq.finish_reason = FinishReason.MIGRATE
        inflight = self._inflight
        if inflight is not None and seq in inflight["batch"].seqs:
            inflight["zombies"].add(request_id)
            self._deferred_release.append(seq)
        elif seq.pages:
            self.scheduler.allocator.free(seq.pages)
            seq.pages = []
        self.stats.requests_finished += 1
        self.obs.on_finish(seq, FinishReason.MIGRATE)
        self.obs.tracer.emit("migrate", request_id, side="export", pages=n,
                             tokens=len(state["output_token_ids"]))
        return state

    def discard_held(self, request_id: str) -> None:
        """Release a held prefill whose export never happened. Idempotent."""
        seq = self.scheduler.held.pop(request_id, None)
        if seq is not None:
            self.scheduler._release(seq)

    def _check_kv_buffers(self, k, v, n_pages: int, what: str) -> None:
        """Raise ValueError unless ``k``/``v`` are buffers [L, n_pages, ps,
        kd] in the pool's dtype (they arrive from another replica)."""
        try:
            shapes = (tuple(k.shape), tuple(v.shape))
            dtypes = (dtype_name(k.dtype), dtype_name(v.dtype))
        except AttributeError as e:
            raise ValueError(f"{what} KV buffers malformed: {e}") from None
        L, _, ps, kd = self.kv_cache.k.shape
        want = (L, n_pages, ps, kd)
        if shapes != (want, want):
            raise ValueError(f"{what} KV shape {shapes[0]} != {want}")
        pool = dtype_name(self.kv_cache.k.dtype)
        if dtypes != (pool, pool):
            raise ValueError(f"{what} KV dtype {dtypes[0]} != {pool}")

    def import_request(self, request_id: str, prompt_token_ids: list[int],
                       params: SamplingParams, state: dict
                       ) -> list[RequestOutput]:
        """Admit an exported state as COMMITTED history: allocate pages,
        scatter the transferred KV in (the swap-in path, no prefill
        replay), and join ``running`` directly. Returns the RequestOutput
        carrying the already-generated token(s). Raises on any mismatch or
        capacity shortfall before a page is allocated — the caller falls
        back to local recompute (``add_request``), which gives the same
        tokens, slower."""
        # Serving-layer stamp of when the handoff began: now - t0 is the
        # replica-observed TTFT (remote prefill + transfer + import).
        ttft_t0 = state.pop("_ttft_t0", None)
        mid_stream = bool(state.pop("mid_stream", False))
        state.pop("sampling", None)
        ps = self.config.cache.page_size
        if state.get("model") != self.model_config.name:
            raise ValueError(f"handoff model {state.get('model')!r} != "
                             f"{self.model_config.name!r}")
        if state.get("page_size") != ps:
            raise ValueError(f"handoff page_size {state.get('page_size')} "
                             f"!= {ps}")
        if list(state["prompt_token_ids"]) != list(prompt_token_ids):
            raise ValueError("handoff prompt does not match the request")
        try:
            out_ids = [int(t) for t in state["output_token_ids"]]
            lps = [float(x) for x in (state.get("output_logprobs") or [])]
            tops = [[(int(t), float(p)) for t, p in row]
                    for row in (state.get("output_top_logprobs") or [])]
        except (TypeError, ValueError) as e:
            raise ValueError(f"malformed handoff output state: {e}") from e
        if not out_ids:
            raise ValueError("handoff carries no generated token")
        num_tokens = len(prompt_token_ids) + len(out_ids)
        need = cdiv(num_tokens - 1, ps)
        self._check_kv_buffers(state["k"], state["v"], need, "handoff")
        k, v = host_tensor(state["k"]), host_tensor(state["v"])
        sched = self.scheduler
        if len(sched.running) >= sched.max_num_seqs:
            raise KVTransferRefused("no batch seat for imported sequence")
        if not sched.allocator.can_allocate(need):
            raise KVTransferRefused(
                f"no KV pages for imported sequence (want {need}, "
                f"free {sched.allocator.num_free})")
        seq = Sequence(request_id, prompt_token_ids, params,
                       eos_token_id=self.eos_token_id)
        pages = sched.allocator.allocate(need)
        try:
            self.kv_io.import_pages(pages, k, v)
        except BaseException:
            sched.allocator.free(pages)
            raise
        seq.pages = pages
        seq.num_prefilled = seq.num_prompt_tokens
        seq.prefix_checked = True
        want_lps = params.logprobs
        want_top = params.top_logprobs
        for j, tok in enumerate(out_ids):
            lp = lps[j] if want_lps and j < len(lps) else None
            top = tops[j] if want_top and j < len(tops) else None
            seq.append_token(tok, lp, top)
        seq.status = SequenceStatus.RUNNING
        sched.running.append(seq)
        self.obs.on_arrival(seq)
        self.obs.on_scheduled(seq, 1)
        if ttft_t0 is not None and not mid_stream:
            # step() never fires on_first_token for an imported sequence
            # (append_token above stamped first_token_time).
            self.obs.on_handoff_first_token(
                seq, max(time.monotonic() - ttft_t0, 0.0))
        self.obs.tracer.emit("migrate" if mid_stream else "handoff",
                             request_id, side="import",
                             pages=need, tokens=len(out_ids))
        if self._sanitizer is not None:
            # The KV-slot shadow learns the imported slots are committed
            # history — same contract as a swap restore.
            self._sanitizer.on_swap_restore(seq)
        reason = seq.check_stop(self.config.effective_max_len)
        if reason is not None:
            sched.finish(seq, reason)
            self.stats.requests_finished += 1
        else:
            # A chained decode window's batch predates this sequence.
            self._batch_stale = True
        return [RequestOutput(
            request_id=request_id,
            prompt_token_ids=list(prompt_token_ids),
            output_token_ids=list(seq.output_token_ids),
            finished=seq.is_finished,
            finish_reason=(seq.finish_reason.value
                           if seq.finish_reason else None),
            new_token_ids=out_ids,
            new_logprobs=(list(lps) if want_lps else None),
            output_logprobs=(list(seq.output_logprobs)
                             if want_lps else None),
            new_top_logprobs=(list(seq.output_top_logprobs)
                              if want_top else None),
            output_top_logprobs=(list(seq.output_top_logprobs)
                                 if want_top else None))]

    # -- fleet-wide prefix cache (KV reuse over the handoff seam) -----------

    def prefix_peek(self, token_ids: list[int]) -> int:
        """Tokens already covered by the LOCAL prefix cache (either tier).
        Read-only."""
        return self.scheduler.prefix_peek(token_ids)

    def export_prefix(self, token_ids: list[int],
                      skip_tokens: int = 0) -> dict:
        """Serve a peer's fetch: the longest cached prefix of ``token_ids``
        — live entries gathered through the ``KVPageIO`` seam, host-tier
        spills READ IN PLACE (never restored, no LRU touch, no counters) —
        as one contiguous host buffer pair. ``skip_tokens``: what the
        puller already holds (floored to a page); only pages beyond it are
        exported, though the chain walk runs from token 0. Raises KeyError
        when prefix caching is off, nothing matches, or the match does not
        extend past ``skip_tokens``. Capped at ``len(token_ids) - 1`` like
        admission reuse."""
        pc = self.scheduler.prefix_cache
        if pc is None:
            raise KeyError("prefix caching is off on this replica")
        ps = self.config.cache.page_size
        skip_pages = max(int(skip_tokens), 0) // ps
        entries, matched = pc.export_walk(token_ids, len(token_ids) - 1)
        dev_pages = [p for kind, p in entries if kind == "dev"]
        try:
            if matched <= skip_pages * ps:
                raise KeyError(
                    "no cached prefix beyond the peer's local coverage"
                    if matched else "no cached prefix for this prompt")
            send = entries[skip_pages:]
            dev_ix = [i for i, (kind, _) in enumerate(send) if kind == "dev"]
            host_ix = [i for i, (kind, _) in enumerate(send)
                       if kind == "host"]
            if not host_ix:
                # One gather; the copy completes inside export_pages,
                # before the forked references are released below.
                k, v = self.kv_io.export_pages([p for _, p in send])
            else:
                L, _, _, kd = self.kv_cache.k.shape
                k = torch.empty((L, len(send), ps, kd),
                                dtype=self.kv_cache.k.dtype)
                v = torch.empty_like(k)
                parts = [(host_ix, self.swapper.host.get(
                    [send[i][1] for i in host_ix]))]
                if dev_ix:
                    parts.append((dev_ix, self.kv_io.export_pages(
                        [send[i][1] for i in dev_ix])))
                for ix, (pk, pv) in parts:
                    ix = torch.tensor(ix, dtype=torch.int64)
                    k.index_copy_(1, ix, pk)
                    v.index_copy_(1, ix, pv)
        finally:
            if dev_pages:
                self.scheduler.allocator.free(dev_pages)
        return {
            "model": self.model_config.name,
            "page_size": ps,
            "dtype": dtype_name(self.kv_cache.k.dtype),
            "matched_tokens": matched,
            "start_tokens": skip_pages * ps,
            "prompt_token_ids": list(token_ids[:matched]),
            "k": k, "v": v,
        }

    def _validate_prefix_header(self, header: dict) -> tuple:
        """Shared header validation of the streamed prefix import: returns
        (token_ids, start page, page count) or raises ValueError before a
        page is allocated."""
        ps = self.config.cache.page_size
        if header.get("model") != self.model_config.name:
            raise ValueError(f"prefix import model {header.get('model')!r} "
                             f"!= {self.model_config.name!r}")
        if header.get("page_size") != ps:
            raise ValueError(f"prefix import page_size "
                             f"{header.get('page_size')} != {ps}")
        pool = dtype_name(self.kv_cache.k.dtype)
        if str(header.get("dtype")) != pool:
            raise ValueError(f"prefix import dtype {header.get('dtype')} "
                             f"!= {pool}")
        try:
            ids = [int(t) for t in header["prompt_token_ids"]]
            matched = int(header["matched_tokens"])
            start = int(header.get("start_tokens", 0))
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"malformed prefix import header: {e}") from e
        if matched < ps or matched % ps or len(ids) != matched:
            raise ValueError(
                f"prefix import carries {matched} matched tokens over "
                f"{len(ids)} ids (need a page-aligned, page-covered match)")
        if start < 0 or start % ps or start >= matched:
            raise ValueError(
                f"prefix import start_tokens {start} invalid for "
                f"{matched} matched tokens")
        return ids, start // ps, (matched - start) // ps

    def begin_prefix_import(self, header: dict) -> str:
        """Open a STREAMED prefix import: validate the header, allocate the
        destination pages, and return an opaque handle. The caller then
        scatters the pulled pages in chunks (:meth:`import_prefix_chunk`)
        and registers the chain (:meth:`commit_prefix_import`), or
        releases it (:meth:`abort_prefix_import`)."""
        if self.scheduler.prefix_cache is None:
            raise ValueError("prefix caching is off on this replica")
        ids, start_page, need = self._validate_prefix_header(header)
        alloc = self.scheduler.allocator
        if not alloc.can_allocate(need):
            raise KVTransferRefused(
                f"no KV pages for prefix import (want {need}, "
                f"free {alloc.num_free})")
        self._prefix_import_seq += 1
        handle = f"pfimp-{self._prefix_import_seq}"
        self._prefix_imports[handle] = {
            "pages": alloc.allocate(need), "token_ids": ids,
            "start_page": start_page, "filled": 0}
        return handle

    def import_prefix_chunk(self, handle: str, k, v) -> None:
        """Scatter one chunk ``[L, n, ps, kd]`` of pulled pages into the
        next slice of the handle's destination pages. A malformed chunk
        aborts the whole import."""
        st = self._prefix_imports.get(handle)
        if st is None:
            raise ValueError(f"unknown prefix import handle {handle!r}")
        n = k.shape[1] if len(k.shape) == 4 else -1
        try:
            if n < 1 or st["filled"] + n > len(st["pages"]):
                raise ValueError(f"{n} pages at offset {st['filled']}")
            self._check_kv_buffers(k, v, n, "prefix import chunk")
        except ValueError as e:
            self.abort_prefix_import(handle)
            raise ValueError(
                f"prefix import chunk shape {tuple(k.shape)} invalid at "
                f"offset {st['filled']}/{len(st['pages'])} pages: {e}"
            ) from None
        self.kv_io.import_pages(
            st["pages"][st["filled"]:st["filled"] + n], k, v)
        st["filled"] += n

    def commit_prefix_import(self, handle: str) -> int:
        """Close a streamed import: every destination page must be filled;
        the chain registers into the prefix cache (which forks its own
        reference per new digest) and the import's references are released
        — pages whose digest was already registered return to the pool.
        Returns the matched token count now served from the local cache."""
        st = self._prefix_imports.pop(handle, None)
        if st is None:
            raise ValueError(f"unknown prefix import handle {handle!r}")
        if st["filled"] != len(st["pages"]):
            self.scheduler.allocator.free(st["pages"])
            raise ValueError(
                f"prefix import truncated: {st['filled']}/"
                f"{len(st['pages'])} pages arrived")
        self.scheduler.prefix_cache.register(
            st["token_ids"], st["pages"], start_page=st["start_page"])
        self.scheduler.allocator.free(st["pages"])
        return len(st["token_ids"])

    def abort_prefix_import(self, handle: str) -> None:
        """Release a streamed import that will not complete. Idempotent."""
        st = self._prefix_imports.pop(handle, None)
        if st is not None:
            self.scheduler.allocator.free(st["pages"])

    def accept_remote_spill(self, digest_hex: str, k, v) -> bool:
        """Receive one remote-spilled prefix page ``[L, 1, ps, kd]`` into
        the local HOST tier (``PrefixCache.accept_host_entry``): a peer's
        cold prefix takes no device page until a local lookup
        second-chances it. False when the host tier is off or full, or the
        page does not match this pool's geometry."""
        pc = self.scheduler.prefix_cache
        if pc is None:
            return False
        try:
            self._check_kv_buffers(k, v, 1, "spill")
            k, v = host_tensor(k), host_tensor(v)
            digest = bytes.fromhex(digest_hex)
        except ValueError:
            return False
        return pc.accept_host_entry(digest, k, v)

    def enable_fleet_spill(self, sink) -> bool:
        """Arm the remote-spill eviction rung: ``sink(digest_hex, k, v) ->
        bool`` receives each evicted page the local host tier could not
        take (called mid-eviction, so it must only enqueue). The gather
        completes before the eviction frees the page. False when prefix
        caching is off."""
        pc = self.scheduler.prefix_cache
        if pc is None:
            return False

        def hook(digest: bytes, page: int) -> bool:
            k, v = self.kv_io.export_pages([page])
            try:
                return bool(sink(digest.hex(), k, v))
            except Exception:
                logger.exception("fleet spill sink failed; dropping page")
                return False

        pc.fleet_spill = hook
        return True

    def step(self) -> list[RequestOutput]:
        # Chaos site: KGCT_FAULT=step_stall:delay=N sleeps here, simulating a
        # hung device dispatch for the watchdog to catch.
        _inject_fault("step_stall")
        self.obs.phases.start_step()
        # Set by _step when a device step actually ran this iteration:
        # (kind, batch_size, decode_mode[, extras]).
        self._last_step_info = None
        self._ttft_transfer_s = None
        t0 = time.perf_counter()
        outs = self._step()
        dt = time.perf_counter() - t0
        self.stats.steps += 1
        if self.groups is not None and self.config.parallel.lockstep_check:
            self._check_lockstep(outs)
        info = self._last_step_info
        if info is None:
            self.obs.phases.discard_step()
        else:
            kind, bsize, mode = info[:3]
            extra = info[3] if len(info) > 3 else {}
            self.obs.on_step(
                step=self.step_count, kind=kind, batch=bsize, duration_s=dt,
                new_tokens=sum(len(o.new_token_ids or []) for o in outs),
                mode=mode, **extra)
        return outs

    def _check_lockstep(self, outs: list[RequestOutput]) -> None:
        """Debug (``ParallelConfig.lockstep_check``): every rank hashes this
        step's (request, tokens) pairs and the world compares the hashes;
        a difference means the ranks' schedulers or samplers diverged."""
        digest = hashlib.blake2b(repr(sorted(
            (o.request_id, tuple(o.new_token_ids or ()), o.finished)
            for o in outs)).encode(), digest_size=8).digest()
        if not self.groups.world_agree(
                int.from_bytes(digest, "little") >> 1):
            raise RuntimeError(f"rank {self.groups.rank}: step "
                               f"{self.step_count} tokens differ across "
                               "ranks (lockstep lost)")

    def _step(self) -> list[RequestOutput]:
        """Run one engine iteration and return outputs for sequences that
        advanced.

        Decode windows are SPECULATIVELY CHAINED: before window w's tokens
        are fetched, window w+1 is enqueued with its input tokens taken from
        w's device-resident output column, so the fetch of w overlaps w+1's
        execution. The chain breaks when a prefill is waiting or any
        sequence finished (the already-enqueued successor then runs with the
        finished rows as zombies; their pages are only released once the
        chain drains, so in-flight KV writes never touch reused pages)."""
        ph = self.obs.phases.phase
        inflight = self._inflight
        if inflight is None:
            with ph("schedule"):
                batch = self.scheduler.schedule()
            self._batch_stale = False
            drained = self._drain_terminally_finished()
            if batch is None:
                return drained
            self.step_count += 1
            if batch.kind == "mixed":
                return drained + self._step_mixed(batch)
            if batch.kind == "spec":
                return drained + self._step_spec(batch)
            if batch.kind == "spec_mixed":
                return drained + self._step_spec_mixed(batch)
            if batch.kind == "prefill":
                return drained + self._step_prefill(batch)
            inflight = self._dispatch_window(batch, batch.positions)
            inflight["drained"] = drained

        successor = None
        # With spec decode on, windows never chain: verification is the
        # speculation, and a chained successor would hold the engine in
        # plain decode after drafts become available (schedule() decides
        # spec eligibility only between chains).
        if (not self.scheduler.waiting and not inflight["zombies"]
                and not self._batch_stale
                and not self.scheduler.spec_enabled):
            successor = self._advance_window(inflight)

        with ph("device_fetch"):
            toks, lps, *tops = self._finish_fetch(inflight["fetch"])
            top_i, top_l = tops if tops else (None, None)
        self._inflight = successor
        with ph("postproc"):
            outputs = inflight.pop("drained", []) + self._process_window(
                inflight["batch"], toks, lps, inflight["zombies"],
                defer=successor is not None, top_ids=top_i, top_lps=top_l)
            if successor is not None:
                successor["zombies"].update(
                    s.request_id for s in inflight["batch"].seqs
                    if s.is_finished)
            else:
                self._drain_deferred()
        self._last_step_info = (
            "decode", inflight["batch"].num_seqs,
            "greedy" if inflight["greedy"] else "sampled")
        return outputs

    def _step_prefill(self, batch: ScheduledBatch) -> list[RequestOutput]:
        """One ragged prefill, or one solo chunk of a long prompt
        (``batch.hist_len`` set) attending to its pool history, through
        its program. A partial chunk's sampled row is never read: its KV
        is committed and nothing is fetched."""
        if batch.hist_len is not None:
            self.stats.prefill_tokens += int(np.sum(batch.seg_ids >= 0))
        else:
            self.stats.prefill_tokens += sum(s.num_tokens for s in batch.seqs)
        pending = self._dispatch_step(batch)
        self._last_step_info = ("prefill", batch.num_seqs, None)
        if pending is None:
            return []
        toks_np, lps_np, top_i, top_l = self._fetch_step(pending)
        with self.obs.phases.phase("postproc"):
            return self._process_window(batch, toks_np, lps_np, set(),
                                        defer=False, top_ids=top_i,
                                        top_lps=top_l)

    def _step_mixed(self, batch: ScheduledBatch) -> list[RequestOutput]:
        """Execute one mixed step through its program: every decode row's
        sampled token appends (with stop checks), the chunk's KV commits in
        the forward's scatter, and the chunk row's sampled token is the
        sequence's first generated token on a FINAL chunk — or discarded
        (zombie row) while the prompt is partial. Mixed steps are
        synchronous (the next step's batch depends on this one's chunk
        progress), so finished rows release pages immediately."""
        chunk_seq = batch.seqs[-1]
        if self._sanitizer is not None:
            # Every decode row writes one KV slot, at its next position: a
            # one-token decode window for the KV shadow, which so learns of
            # the rejected-draft slots these writes overwrite. (The JAX
            # engine has no hook here, and its shadow then flags such a
            # slot as stale at the next spec step.)
            Tp = len(batch.tokens) - batch.page_tables.shape[0]
            D = len(batch.seqs) - 1
            self._sanitizer.on_decode_dispatch(
                batch.seqs[:D], batch.positions[Tp:Tp + D], 1)
        self.stats.prefill_tokens += batch.prefill_token_count
        toks_np, lps_np, top_i, top_l = self._fetch_step(
            self._dispatch_step(batch))
        # A partial chunk's sampled row is meaningless (prompt unfinished):
        # route it through the zombie set so _process_window skips it.
        zombies = {chunk_seq.request_id} if batch.partial else set()
        with self.obs.phases.phase("postproc"):
            outs = self._process_window(batch, toks_np, lps_np, zombies,
                                        defer=False, top_ids=top_i,
                                        top_lps=top_l)
        self._last_step_info = (
            "mixed", batch.num_seqs, None,
            {"prefill_tokens": batch.prefill_token_count,
             "decode_tokens": batch.num_seqs - 1})
        return outs

    def _forward(self, kind: str, tokens, meta, page_table=None,
                 hist_len=None) -> torch.Tensor:
        """The normed rows of a "prefill", "decode" or "prefill_hist" step
        that feed sampling: through the pipeline under pp, with ring
        attention for a prefill under sp, else the plain forward."""
        cfg = self.model_config
        extra = (page_table, hist_len) if kind == "prefill_hist" else ()
        if self.pp_size > 1:
            return pipeline_forward(kind, self.params, cfg, tokens, meta,
                                    self.kv_cache, self.groups, *extra)[0]
        if kind == "prefill":
            return model_lib.forward_prefill(
                self.params, cfg, tokens, meta, self.kv_cache,
                groups=self.groups, attn_impl=self._prefill_attn)[0]
        fwd = (model_lib.forward_decode if kind == "decode"
               else model_lib.forward_prefill_hist)
        return fwd(self.params, cfg, tokens, meta, self.kv_cache, *extra,
                   groups=self.groups)[0]

    # -- the prefill, solo-chunk, mixed, spec and spec×mixed programs --------

    @staticmethod
    def _step_program_key(batch: ScheduledBatch) -> tuple:
        """The program of a prefill, solo-chunk, mixed, spec or spec×mixed
        batch, keyed by the shapes the JAX jit caches key it by:
        ("prefill", T, B), ("prefill_hist", T, W), ("mixed", Tp, R, W),
        ("spec", R, S), ("spec_mixed", Tp, R, W, S); every one a bucket the
        scheduler already chose (S the adaptive ladder's rung)."""
        T = batch.tokens.shape[0]
        R = batch.temperature.shape[0]
        if batch.kind in ("spec", "spec_mixed"):
            R = batch.page_tables.shape[0]
            S = batch.spec_S
            if batch.kind == "spec":
                return ("spec", R, S)
            return ("spec_mixed", T - R * S, R,
                    batch.chunk_page_table.shape[1], S)
        if batch.kind == "mixed":
            return ("mixed", T - R, R, batch.chunk_page_table.shape[1])
        if batch.hist_len is not None:
            return ("prefill_hist", T, batch.page_tables.shape[1])
        return ("prefill", T, R)

    def _program_layout(self, key) -> tuple[dict, dict]:
        return (self._window_layout(key) if key[0] in ("greedy", "sampled")
                else self._step_layout(key))

    def _step_layout(self, key) -> tuple[dict, dict]:
        """The (inputs, state) buffers of a prefill, solo-chunk, mixed,
        spec or spec×mixed program: the token axis, the sampled rows'
        parameters and bias slots (-1 when empty), the step key, and the
        family's own inputs (prompt lengths for the prefill's in-batch
        penalty counts; a chunk's history length and table; the verify
        rows' whole ``[R, pps]`` tables and context lengths; a spec×mixed
        step samples R verify rows and the chunk's row R). State is the
        ``[rows, out_cap]`` penalty history of every family but the
        prefill, written only when a row has penalties, and the outputs
        every run overwrites (a verify step's ``[R, S]`` tokens and
        logprobs, ``[R, S, 5]`` alternatives and ``[R]`` accepted counts;
        spec×mixed adds the chunk row's ``out_c*``)."""
        family = key[0]
        S = 1
        if family == "prefill":
            _, n, R = key
        elif family == "prefill_hist":
            _, n, W = key
            R = _bucket(1, self.config.scheduler.decode_buckets)
        elif family == "mixed":
            _, Tp, R, W = key
            n = Tp + R
        elif family == "spec":
            _, R, S = key
            n = R * S
        else:
            _, Tp, R, W, S = key
            n = Tp + R * S
        rows = R + 1 if family == "spec_mixed" else R
        i32, f32 = torch.int32, torch.float32
        inputs = {name: ((n,), i32) for name in (
            "tokens", "seg_ids", "positions", "slot_mapping")}
        inputs.update(
            {name: ((rows,), i32) for name in ("top_k", "seed")},
            step_key=((1,), i32), flags=((len(STEP_FLAGS),), i32),
            bias_ids=((rows, LOGIT_BIAS_CAP), i32),
            bias_vals=((rows, LOGIT_BIAS_CAP), f32),
            **{name: ((rows,), f32) for name in (
                "temperature", "top_p", "presence", "frequency")})
        outs = (R, S) if family in ("spec", "spec_mixed") else (R,)
        state = {"out_tok": (outs, i32), "out_lp": (outs, f32),
                 "out_tid": (outs + (TOP_LOGPROBS,), i32),
                 "out_tlp": (outs + (TOP_LOGPROBS,), f32)}
        if family == "prefill":
            inputs.update(logits_indices=((R,), i32), prompt_lens=((R,), i32))
            return inputs, state
        state["out_tokens"] = ((rows, self._out_cap), i32)
        if family == "prefill_hist":
            inputs.update(logits_indices=((R,), i32), hist_len=((1,), i32),
                          page_table=((1, W), i32))
            return inputs, state
        pps = cdiv(self.config.effective_max_len, self.config.cache.page_size)
        inputs.update(page_tables=((R, pps), i32), context_lens=((R,), i32))
        if family != "spec":
            sampled = R * S + 1 if family == "spec_mixed" else R
            inputs.update(logits_indices=((sampled,), i32),
                          hist_len=((1,), i32),
                          chunk_page_table=((1, W), i32))
        if family in ("spec", "spec_mixed"):
            state["out_n_acc"] = ((R,), i32)
        if family == "spec_mixed":
            state.update(out_ctok=((1,), i32), out_clp=((1,), f32),
                         out_ctid=((1, TOP_LOGPROBS), i32),
                         out_ctlp=((1, TOP_LOGPROBS), f32))
        return inputs, state

    def _prefill_meta(self, bufs) -> "model_lib.PrefillMeta":
        return model_lib.PrefillMeta(
            seg_ids=bufs["seg_ids"], positions=bufs["positions"],
            slot_mapping=bufs["slot_mapping"],
            logits_indices=bufs["logits_indices"])

    def _mixed_meta(self, bufs) -> "model_lib.MixedMeta":
        return model_lib.MixedMeta(
            seg_ids=bufs["seg_ids"], positions=bufs["positions"],
            slot_mapping=bufs["slot_mapping"],
            logits_indices=bufs["logits_indices"],
            chunk_page_table=bufs["chunk_page_table"],
            hist_len=bufs["hist_len"], page_tables=bufs["page_tables"],
            context_lens=bufs["context_lens"])

    def _prefill_body(self, key, bufs) -> None:
        """One ragged prefill of program ``key`` over its static buffers:
        the forward, then ``_sample_step`` with the in-batch penalty
        counts. Like every body a program captures, nothing here reads a
        device value on the host, branches on one or uploads (KGCT001)."""
        hidden = self._forward("prefill", bufs["tokens"],
                               self._prefill_meta(bufs))
        self._sample_step(bufs, hidden, lambda: self._prefill_counts(bufs))

    def _prefill_hist_body(self, key, bufs) -> None:
        """One solo chunk of program ``key``: the chunk over its history
        (``hist_len`` read on the device by every layer's kernel), then
        ``_sample_step`` with counts from the penalty history."""
        hidden = self._forward("prefill_hist", bufs["tokens"],
                               self._prefill_meta(bufs),
                               bufs["page_table"][0], bufs["hist_len"])
        self._sample_step(bufs, hidden, lambda: build_counts(
            bufs["out_tokens"], self.model_config.vocab_size))

    def _mixed_body(self, key, bufs) -> None:
        """One mixed step of program ``key``: the chunk and the decode rows
        in one forward, then ``_sample_step`` on every row, the chunk's
        included, with counts from the penalty history."""
        hidden, _, _ = model_lib.forward_mixed(
            self.params, self.model_config, bufs["tokens"],
            self._mixed_meta(bufs), self.kv_cache, groups=self.groups)
        self._sample_step(bufs, hidden, lambda: build_counts(
            bufs["out_tokens"], self.model_config.vocab_size))

    def _spec_body(self, key, bufs) -> None:
        """One verify step of program ``key`` = ("spec", R, S): every row's
        ``[last token, k drafts]`` slice in one forward (the verify
        attention reads each row's context length on the device, over the
        whole table), the logits of every slot, then ``_verify_rows``."""
        _, R, S = key
        meta = model_lib.SpecMeta(
            seg_ids=bufs["seg_ids"], positions=bufs["positions"],
            slot_mapping=bufs["slot_mapping"],
            page_tables=bufs["page_tables"],
            context_lens=bufs["context_lens"])
        hidden, _, _ = model_lib.forward_spec_verify(
            self.params, self.model_config, bufs["tokens"], meta,
            self.kv_cache, groups=self.groups)
        logits = model_lib.compute_logits(self.params, self.model_config,
                                          hidden, groups=self.groups)
        flags = bufs.flags(STEP_FLAGS)
        when("bias", flags["any_bias"], lambda: logits.copy_(apply_logit_bias(
            logits, bufs["bias_ids"].repeat_interleave(S, dim=0),
            bufs["bias_vals"].repeat_interleave(S, dim=0))))
        self._verify_rows(bufs, logits, bufs["tokens"], R, S, flags)

    def _spec_mixed_body(self, key, bufs) -> None:
        """One spec×mixed step of program ``key`` = ("spec_mixed", Tp, R,
        W, S): the chunk and the R verify slices in one forward, then
        ``_verify_rows`` on the verify slots and, on the chunk's
        last-token logits, the mixed step's one sampled row (device row
        R), with counts from its penalty history."""
        _, Tp, R, _, S = key
        hidden, _, _ = model_lib.forward_spec_mixed(
            self.params, self.model_config, bufs["tokens"],
            self._mixed_meta(bufs), self.kv_cache, S, groups=self.groups)
        logits = model_lib.compute_logits(self.params, self.model_config,
                                          hidden, groups=self.groups)
        flags = bufs.flags(STEP_FLAGS)
        # One bias stage over the verify slots and the chunk row, as the
        # JAX program's one _maybe_bias.
        when("bias", flags["any_bias"], lambda: logits.copy_(apply_logit_bias(
            logits, torch.cat([bufs["bias_ids"][:R].repeat_interleave(
                S, dim=0), bufs["bias_ids"][R:]]),
            torch.cat([bufs["bias_vals"][:R].repeat_interleave(S, dim=0),
                       bufs["bias_vals"][R:]]))))
        self._verify_rows(bufs, logits[:R * S], bufs["tokens"][Tp:], R, S,
                          flags)
        chunk = slice(R, R + 1)
        idx = bufs["logits_indices"][R * S:].to(torch.int64)
        tok, lp, tid, tlp = self._sample_rows(
            bufs, logits[R * S:], lambda: build_counts(
                bufs["out_tokens"][chunk], self.model_config.vocab_size),
            flags, bufs["positions"][idx] + 1, chunk)
        bufs["out_ctok"].copy_(tok)
        bufs["out_clp"].copy_(lp)
        bufs["out_ctid"].copy_(tid)
        bufs["out_ctlp"].copy_(tlp)

    def _verify_rows(self, bufs, logits: torch.Tensor,
                     drafts_flat: torch.Tensor, R: int, S: int,
                     flags: dict) -> None:
        """Acceptance over the R verify rows' logits [R*S, V] (biased
        already) into the program's outputs: ``spec_verify_sample`` with
        counts from the penalty history (spec steps are synchronous, so the
        host knows every output token), built only under ``any_pen`` (else
        the zeros of the JAX false branch), its stages gated by the step's
        flags."""
        V = logits.shape[-1]
        rows = slice(0, R)
        counts = torch.empty((R, V), dtype=torch.int32, device=logits.device)
        when("counts", flags["any_pen"],
             lambda: counts.copy_(build_counts(bufs["out_tokens"][rows], V)),
             counts.zero_)
        toks, n_acc, lps, tids, tlps = spec_verify_sample(
            logits.reshape(R, S, V), drafts_flat.reshape(R, S)[:, 1:],
            bufs["context_lens"], bufs["step_key"], bufs["seed"][rows],
            bufs["temperature"][rows], bufs["top_k"][rows],
            bufs["top_p"][rows], bufs["presence"][rows],
            bufs["frequency"][rows], counts,
            any_sampled=flags["any_sampled"],
            needs_filter=flags["needs_filter"], any_pen=flags["any_pen"],
            with_top=flags["any_top"])
        bufs["out_tok"].copy_(toks)
        bufs["out_n_acc"].copy_(n_acc)
        bufs["out_lp"].copy_(lps)
        bufs["out_tid"].copy_(tids)
        bufs["out_tlp"].copy_(tlps)

    def _sample_step(self, bufs, hidden: torch.Tensor, counts) -> None:
        """The logits of a step's sampled rows and their draw into the
        program's outputs, on every row, as the JAX programs sample
        whether the host reads a row or not; ``counts()`` builds the
        penalty histogram, inside the penalties stage."""
        logits = model_lib.compute_logits(self.params, self.model_config,
                                          hidden, groups=self.groups)
        idx = bufs["logits_indices"].to(torch.int64)
        toks, lps, tids, tlps = self._sample_rows(
            bufs, logits, counts, bufs.flags(STEP_FLAGS),
            bufs["positions"][idx] + 1)
        bufs["out_tok"].copy_(toks)
        bufs["out_lp"].copy_(lps)
        bufs["out_tid"].copy_(tids)
        bufs["out_tlp"].copy_(tlps)

    def _prefill_counts(self, bufs) -> torch.Tensor:
        """Output-token histogram [R, V] at the PREFILL sampling point. A
        recompute-preemption re-prefill carries the sequence's generated
        tokens IN the batch, so tokens at positions >= the row's prompt
        length are outputs; fresh admissions count nothing. One flat
        ``scatter_add_`` (an accumulating ``index_put_`` may not be
        captured); ids outside the vocabulary count nowhere."""
        V = self.model_config.vocab_size
        R = bufs["prompt_lens"].shape[0]
        seg = bufs["seg_ids"].to(torch.int64)
        tok = bufs["tokens"].to(torch.int64)
        row = torch.clamp(seg, 0, R - 1)
        out = ((seg >= 0) & (bufs["positions"] >= bufs["prompt_lens"][row])
               & (tok >= 0) & (tok < V))
        counts = torch.zeros(R * V, dtype=torch.int32, device=tok.device)
        counts.scatter_add_(0, torch.where(out, row * V + tok, 0),
                            out.to(torch.int32))
        return counts.view(R, V)

    def _dispatch_step(self, batch: ScheduledBatch) -> Optional[tuple]:
        """Run a prefill, solo-chunk, mixed, spec or spec×mixed batch
        through its program: fill its static inputs (one pinned upload per
        dtype) and, when a row of a family with a penalty history has
        penalties, that history (rebuilt from the host-known outputs, as
        ``_dispatch_window`` rebuilds its counts; otherwise its stale
        contents meet zero penalties and change no bit); run or replay it;
        then, unless nothing of the step is read (a partial solo chunk),
        record the compute's end and enqueue the one device->host copy of
        the outputs the batch reads. Returns (event, fetch) or None."""
        ph = self.obs.phases.phase
        key = self._step_program_key(batch)
        family = key[0]
        bufs = self._programs.buffers(key)
        step_key = self._next_step_key()
        with ph("host_prep"):
            ids, vals = self._bias_arrays(batch)
            inputs = {name: getattr(batch, name) for name in (
                "tokens", "seg_ids", "positions", "slot_mapping", "top_k",
                "seed", "temperature", "top_p", "presence", "frequency")}
            inputs.update(step_key=[step_key], bias_ids=ids, bias_vals=vals,
                          flags=step_flags(batch, ids, key[2] if family ==
                                           "spec_mixed" else None))
            if family != "spec":
                inputs["logits_indices"] = batch.logits_indices
            if family == "prefill":
                inputs["prompt_lens"] = batch.prompt_lens
            elif np.any(batch.presence) or np.any(batch.frequency):
                bufs["out_tokens"].copy_(self._penalty_out_tokens(batch))
            if family == "prefill_hist":
                inputs.update(hist_len=[batch.hist_len],
                              page_table=batch.page_tables)
            elif family != "prefill":
                inputs.update(page_tables=batch.page_tables,
                              context_lens=batch.context_lens)
            if family in ("mixed", "spec_mixed"):
                inputs.update(hist_len=[batch.hist_len],
                              chunk_page_table=batch.chunk_page_table)
            bufs.upload(inputs)
        with ph("device_dispatch"):
            self._programs.run(key)
            if batch.kind == "prefill" and batch.partial:
                return None
            done = self._record_event()
            outs = ["out_tok", "out_lp"]
            if family in ("spec", "spec_mixed"):
                outs.append("out_n_acc")
            if family == "spec_mixed":
                outs += ["out_ctok", "out_clp"]
            if any(s.params.top_logprobs for s in batch.seqs):
                outs += ["out_tid", "out_tlp"]
                if family == "spec_mixed":
                    outs += ["out_ctid", "out_ctlp"]
            return done, self._start_fetch(*(bufs[name] for name in outs))

    def _record_event(self) -> Optional["torch.cuda.Event"]:
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return event

    def _wait_step(self, pending: tuple) -> list[np.ndarray]:
        """Wait for a dispatched step's outputs (in ``_dispatch_step``'s
        order), split into device compute (its event) and the copy itself
        for the TTFT decomposition ("prefill" carries the compute,
        "first_fetch" only the transfer)."""
        done, fetch = pending
        with self.obs.phases.phase("device_fetch"):
            t0f = time.perf_counter()
            if done is not None:
                done.synchronize()
            compute_s = time.perf_counter() - t0f
            arrays = self._finish_fetch(fetch)
        self._ttft_transfer_s = max(
            self.obs.phases.current_durs.get("device_fetch", 0.0)
            - compute_s, 0.0)
        return arrays

    def _fetch_step(self, pending: tuple):
        """A prefill, solo-chunk or mixed step's outputs: tokens and
        logprobs [R, 1] and the alternatives [R, 1, 5] (None when the
        batch asked for none)."""
        toks, lps, *tops = self._wait_step(pending)
        top_i, top_l = ((t[:, None] for t in tops) if tops
                        else (None, None))
        return toks[:, None], lps[:, None], top_i, top_l

    def _spec_outcome(self, batch: ScheduledBatch, n_acc: np.ndarray,
                      D: int, S: int) -> tuple[np.ndarray, int, int]:
        """(tokens each of the D verify rows emits: accepted + 1, at most
        S; drafted; accepted). Both tallies count real proposals only:
        rows short of k were padded with filler drafts, which are lossless
        but were never proposed."""
        emit = np.minimum(n_acc[:D] + 1, S)
        draft_lens = batch.draft_lens[:D]
        drafted = int(draft_lens.sum())
        accepted = int(np.minimum(n_acc[:D], draft_lens).sum())
        self._observe_spec_outcome(drafted, accepted)
        return emit, drafted, accepted

    def _step_spec(self, batch: ScheduledBatch) -> list[RequestOutput]:
        """One speculative-verification step through its program: every
        row advances by ``accepted + 1`` tokens through the regular
        stop-check loop, so EOS and max_tokens inside the accepted prefix
        truncate exactly as in the decode path. Synchronous (the next
        drafts depend on this step's tokens), so finished rows release
        pages at once. Rejected drafts' K/V sit past the new committed
        length: verify reads history only below ``context_lens - 1`` and
        the next step's append overwrites them before any read, so nothing
        is rolled back on the device."""
        S = batch.spec_S
        # Chaos site: KGCT_FAULT=kv_commit_stomp corrupts one KV write slot
        # BEFORE the static inputs are filled (a later change would never
        # reach the card), so the device really would stomp committed
        # history — the KV shadow (KGCT_SANITIZE=1) must catch it here.
        if _inject_fault("kv_commit_stomp"):
            _stomp_committed_slot(batch, self.config.cache.page_size, S)
        if self._sanitizer is not None:
            self._sanitizer.on_spec_dispatch(batch)
        toks_np, lps_np, n_acc_np, *tops = self._wait_step(
            self._dispatch_step(batch))
        top_i, top_l = tops if tops else (None, None)
        B = batch.num_seqs
        emit, drafted, accepted = self._spec_outcome(batch, n_acc_np, B, S)
        greedy = bool(np.all(batch.temperature[:B] <= 0))
        if self._sanitizer is not None:
            # Before _process_window appends tokens: rejected-draft slots
            # (past each row's accepted prefix) become stale in the shadow.
            self._sanitizer.on_spec_commit(batch, emit)
        with self.obs.phases.phase("postproc"):
            outs = self._process_window(batch, toks_np, lps_np, set(),
                                        defer=False, top_ids=top_i,
                                        top_lps=top_l, emit_counts=emit)
        self._last_step_info = (
            "spec", B, "greedy" if greedy else "sampled",
            {"drafted_tokens": drafted, "accepted_tokens": accepted,
             "draft_s": batch.draft_time_s})
        return outs

    def _observe_spec_outcome(self, drafted: int, accepted: int) -> None:
        """Feed the acceptance-adaptive controller (no-op when k is static)
        and mirror its rung to the kgct_spec_current_k gauge."""
        ctrl = self.scheduler.spec_controller
        if ctrl is None:
            return
        ctrl.observe(drafted, accepted)
        self.obs.spec_current_k = ctrl.current_k

    def _step_spec_mixed(self, batch: ScheduledBatch) -> list[RequestOutput]:
        """One spec×mixed step through its program: every running row
        advances by ``accepted + 1`` tokens (the spec step's commit) and
        the queue-head prompt by one chunk (the mixed step's commit), in
        one forward. The chunk row samples on device row R_pad: its token
        is the sequence's first on a final chunk and is dropped (zombie
        row) while the prompt is partial. Synchronous, like both."""
        chunk_seq = batch.seqs[-1]
        D = len(batch.seqs) - 1
        R_pad = batch.page_tables.shape[0]
        S = batch.spec_S
        Tp = len(batch.tokens) - R_pad * S
        if _inject_fault("kv_commit_stomp"):
            _stomp_committed_slot(batch, self.config.cache.page_size, S,
                                  token_start=Tp)
        if self._sanitizer is not None:
            # Verify slices only: the chunk half's writes target
            # uncommitted prompt positions by design (KGCT005's static
            # scope), exactly like the plain mixed step.
            self._sanitizer.on_spec_dispatch(batch, seqs=batch.seqs[:D],
                                             token_start=Tp)
        self.stats.prefill_tokens += batch.prefill_token_count
        toks, lps, n_acc_np, ctok, clp, *tops = self._wait_step(
            self._dispatch_step(batch))
        # Host rows: the D real verify rows, then the chunk's row with its
        # one token in column 0 (its emit count is 1).
        toks_np = np.zeros((D + 1, S), np.int64)
        lps_np = np.zeros((D + 1, S), np.float32)
        toks_np[:D], toks_np[D, 0] = toks[:D], ctok[0]
        lps_np[:D], lps_np[D, 0] = lps[:D], clp[0]
        top_i = top_l = None
        if tops:
            tids, tlps, ctid, ctlp = tops
            top_i = np.zeros((D + 1,) + tids.shape[1:], np.int64)
            top_l = np.zeros(top_i.shape, np.float32)
            top_i[:D], top_l[:D] = tids[:D], tlps[:D]
            top_i[D, 0], top_l[D, 0] = ctid[0], ctlp[0]
        emit = np.ones(D + 1, np.int64)
        emit[:D], drafted, accepted = self._spec_outcome(batch, n_acc_np, D,
                                                         S)
        greedy = bool(np.all(batch.temperature <= 0))
        if self._sanitizer is not None:
            self._sanitizer.on_spec_commit(batch, emit)
        zombies = {chunk_seq.request_id} if batch.partial else set()
        with self.obs.phases.phase("postproc"):
            outs = self._process_window(batch, toks_np, lps_np, zombies,
                                        defer=False, top_ids=top_i,
                                        top_lps=top_l, emit_counts=emit)
        self._last_step_info = (
            "spec_mixed", batch.num_seqs, "greedy" if greedy else "sampled",
            {"prefill_tokens": batch.prefill_token_count,
             "decode_tokens": int(emit[:D].sum()),
             "drafted_tokens": drafted, "accepted_tokens": accepted,
             "draft_s": batch.draft_time_s})
        return outs

    def _substep_meta(self, page_tables: torch.Tensor,
                      pos: torch.Tensor) -> "model_lib.DecodeMeta":
        """Per-substep decode metadata, computed on the device from the
        positions and page tables. Window substeps past the model length cap
        produce tokens the host discards, but their KV writes still happen:
        they go to the scrap page (page 0) at ``pos % ps`` instead of
        clamping into the sequence's real pages, where the write would wrap
        and overwrite earlier KV."""
        ps = self.config.cache.page_size
        max_len = self.config.effective_max_len
        pos_c = torch.clamp(pos, max=max_len - 1)
        page_idx = (pos_c // ps).to(torch.int64)
        page = torch.gather(page_tables, 1, page_idx[:, None])[:, 0]
        in_range = pos < max_len
        slot = torch.where(in_range, page * ps + pos_c % ps, pos % ps)
        return model_lib.DecodeMeta(positions=pos_c, slot_mapping=slot,
                                    page_tables=page_tables,
                                    context_lens=pos_c + 1)

    def _window_layout(self, key) -> tuple[dict, dict]:
        """The (inputs, state) buffers of decode program ``key`` = (variant,
        B): inputs are uploaded before every window; state is the first
        tokens (from the host, or the chained window's last column), the
        penalty counts the sampled program carries across chained windows,
        and the outputs each window overwrites."""
        variant, B = key
        cfg = self.config
        W = cfg.scheduler.decode_window
        pps = cdiv(cfg.effective_max_len, cfg.cache.page_size)
        i32, f32 = torch.int32, torch.float32
        inputs = {"positions": ((B,), i32), "page_tables": ((B, pps), i32),
                  "flags": ((len(STEP_FLAGS),), i32)}
        state = {"tokens0": ((B,), i32), "out_tok": ((B, W), i32),
                 "out_lp": ((B, W), f32),
                 "out_tid": ((B, W, TOP_LOGPROBS), i32),
                 "out_tlp": ((B, W, TOP_LOGPROBS), f32)}
        if variant == "sampled":
            inputs.update(
                {name: ((B,), i32) for name in ("top_k", "seed")},
                step_key=((1,), i32),
                bias_ids=((B, LOGIT_BIAS_CAP), i32),
                bias_vals=((B, LOGIT_BIAS_CAP), f32),
                **{name: ((B,), f32) for name in (
                    "temperature", "top_p", "presence", "frequency")})
            state["counts"] = ((B, self.model_config.vocab_size), i32)
        return inputs, state

    def _sample_rows(self, bufs, logits: torch.Tensor, counts, flags: dict,
                     pos_next: torch.Tensor,
                     rows: slice = slice(None)) -> tuple:
        """The sampled programs' stage over the buffers' ``rows`` (every
        row by default; a spec×mixed step's chunk row, whose logits are
        biased already and whose flags are ``chunk_*``), each stage gated
        as the JAX program gates it: the bias on ``any_bias``, the
        penalties on ``any_pen`` (``counts()`` builds or reads the
        histogram inside that stage), then ``sample_and_logprobs`` on
        ``any_sampled``, ``needs_filter`` and ``any_top``. The rows'
        own parameters decide inside a stage that runs (temperature 0 takes
        the argmax, top_k 0 and top_p 1 cut nothing, zero penalties and
        empty bias slots add exact zeros). ``logits`` is rewritten in
        place. Returns (tokens, logprobs, top ids, top logprobs)."""
        p = {name: bufs[name][rows] for name in (
            "bias_ids", "bias_vals", "presence", "frequency", "seed",
            "temperature", "top_k", "top_p")}
        chunk = rows != slice(None)
        if not chunk:
            when("bias", flags["any_bias"], lambda: logits.copy_(
                apply_logit_bias(logits, p["bias_ids"], p["bias_vals"])))
        when("penalties", flags["chunk_pen" if chunk else "any_pen"],
             lambda: logits.copy_(apply_penalties(
                 logits, counts(), p["presence"], p["frequency"])))
        keys = row_sample_keys(bufs["step_key"], p["seed"], pos_next)
        return sample_and_logprobs(
            logits, keys, p["temperature"], p["top_k"], p["top_p"],
            any_sampled=flags["chunk_sampled" if chunk else "any_sampled"],
            needs_filter=flags["chunk_filter" if chunk else "needs_filter"],
            with_top=flags["any_top"])

    def _window_body(self, key, bufs) -> None:
        """One W-substep decode window of program ``key`` over its static
        buffers: every substep's sampled tokens feed the next; positions,
        slots and context lengths are recomputed per substep from the page
        tables. The function a program captures, so nothing here reads a
        device value on the host, branches on one or uploads (KGCT001):
        the greedy variant is argmax-only, its alternatives gated on
        ``any_top``; the sampled one runs ``_sample_rows`` and bumps the
        carried counts in place under ``any_pen``."""
        variant, _ = key
        cfg = self.model_config
        flags = bufs.flags(STEP_FLAGS)
        counts = bufs["counts"] if variant == "sampled" else None
        tokens, pos = bufs["tokens0"], bufs["positions"]
        for i in range(self.config.scheduler.decode_window):
            hidden = self._forward(
                "decode", tokens, self._substep_meta(bufs["page_tables"], pos))
            logits = model_lib.compute_logits(self.params, cfg, hidden,
                                              groups=self.groups)
            if variant == "greedy":
                tokens = torch.argmax(logits, dim=-1).to(torch.int32)
                bufs["out_lp"][:, i] = token_logprobs(logits, tokens)
                write_top_logprobs(logits, flags["any_top"],
                                   bufs["out_tid"][:, i],
                                   bufs["out_tlp"][:, i])
            else:
                tokens, lps, tids, tlps = self._sample_rows(
                    bufs, logits, lambda: counts, flags, pos + 1)
                when("count_bump", flags["any_pen"],
                     lambda tokens=tokens: counts.scatter_add_(
                         1, tokens.to(torch.int64)[:, None],
                         torch.ones_like(counts[:, :1])))
                bufs["out_lp"][:, i] = lps
                bufs["out_tid"][:, i] = tids
                bufs["out_tlp"][:, i] = tlps
            bufs["out_tok"][:, i] = tokens
            pos = pos + 1

    def _dispatch_window(self, batch: ScheduledBatch, positions: np.ndarray,
                         prev_out: Optional[torch.Tensor] = None) -> dict:
        """Run one decode window of ``batch`` through its program: fill the
        program's static inputs (one pinned upload per dtype), its first
        tokens (the host's, or ``prev_out``'s last column: the chained
        window's output, copied on the device in stream order) and, for a
        fresh sampled window with penalties, its counts (rebuilt from the
        host-known outputs; a chained window carries them, so penalties
        see the in-flight window's tokens the host has not fetched yet);
        then run or replay it and enqueue the one device->host copy of its
        outputs.

        The variant is chosen on the host, as the JAX engine does: greedy
        for all-greedy, penalty-free, bias-free batches."""
        ph = self.obs.phases.phase
        W = self.config.scheduler.decode_window
        if self._sanitizer is not None:
            self._sanitizer.on_decode_dispatch(batch.seqs, positions, W)
        B = batch.page_tables.shape[0]        # the scheduler's bucket
        any_pen = bool(np.any(batch.presence) or np.any(batch.frequency))
        bias = any(seq.params.logit_bias for seq in batch.seqs)
        greedy = bool(np.all(batch.temperature <= 0)) and not (any_pen
                                                              or bias)
        with_top = bool(np.any(batch.top_n > 0))
        key = ("greedy" if greedy else "sampled", B)
        bufs = self._programs.buffers(key)
        step_key = self._next_step_key()
        with ph("host_prep"):
            ids, vals = self._bias_arrays(batch)
            inputs = {"positions": positions,
                      "page_tables": batch.page_tables,
                      "flags": step_flags(batch, ids)}
            if not greedy:
                inputs.update(top_k=batch.top_k, seed=batch.seed,
                              step_key=[step_key], bias_ids=ids,
                              bias_vals=vals, temperature=batch.temperature,
                              top_p=batch.top_p, presence=batch.presence,
                              frequency=batch.frequency)
            bufs.upload(inputs)
            bufs["tokens0"].copy_(self._up(batch.tokens) if prev_out is None
                                  else prev_out[:, -1])
            if any_pen and prev_out is None:
                bufs["counts"].copy_(build_counts(
                    self._penalty_out_tokens(batch),
                    self.model_config.vocab_size))
        with ph("device_dispatch"):
            self._programs.run(key)
            outs = ("out_tok", "out_lp") + (("out_tid", "out_tlp")
                                            if with_top else ())
            fetch = self._start_fetch(*(bufs[name] for name in outs))
        return {"batch": batch, "dev_out": bufs["out_tok"], "fetch": fetch,
                "positions": positions, "zombies": set(), "greedy": greedy}

    def _advance_window(self, inflight: dict) -> Optional[dict]:
        """Build + enqueue the speculative successor window: same batch
        composition (so the same program), positions advanced by W, pages
        grown to cover the new window. Returns None (chain breaks) if pages
        can't be grown."""
        W = self.config.scheduler.decode_window
        ps = self.config.cache.page_size
        batch = inflight["batch"]
        new_positions = inflight["positions"] + W
        grows = []
        total = 0
        for s, seq in enumerate(batch.seqs):
            last_pos = seq.last_window_pos(
                int(new_positions[s]), W, self.config.effective_max_len)
            need = cdiv(last_pos + 1, ps) - len(seq.pages)
            if need > 0:
                grows.append((s, seq, need))
                total += need
        if not self.scheduler.allocator.can_allocate(total):
            return None
        for s, seq, need in grows:
            seq.pages.extend(self.scheduler.allocator.allocate(need))
            batch.page_tables[s, :len(seq.pages)] = seq.pages
        self.step_count += 1
        return self._dispatch_window(batch, new_positions,
                                     prev_out=inflight["dev_out"])

    def _process_window(self, batch: ScheduledBatch, next_tokens: np.ndarray,
                        logprobs: np.ndarray, zombies: set,
                        defer: bool, top_ids: Optional[np.ndarray] = None,
                        top_lps: Optional[np.ndarray] = None,
                        emit_counts: Optional[np.ndarray] = None,
                        ) -> list[RequestOutput]:
        """next_tokens/logprobs: [B_pad, W]. Append window tokens per
        sequence until a stop condition fires; tokens generated past the
        stop are discarded. ``zombies`` (request ids finished in an earlier
        chained window) are skipped; with ``defer`` the pages of newly
        finished sequences are held until the chain drains (an in-flight
        window may still write to them). ``emit_counts`` [B] caps the
        usable columns per row (spec steps: accepted drafts + 1; columns
        past the first rejection are garbage)."""
        # Chaos site: KGCT_FAULT=nan_step_output poisons the fetched
        # logprobs — the corruption class the KGCT_SANITIZE step-output
        # guard must catch before any client sees it.
        if _inject_fault("nan_step_output"):
            logprobs = np.full_like(np.asarray(logprobs, np.float32), np.nan)
        if self._sanitizer is not None:
            self._sanitizer.check_outputs(
                next_tokens, logprobs, emit_counts,
                self.model_config.vocab_size, len(batch.seqs))
        outputs = []
        for s, seq in enumerate(batch.seqs):
            if seq.request_id in zombies:
                continue
            had_first = seq.first_token_time is not None
            want_lps = seq.params.logprobs
            want_top = (seq.params.top_logprobs if top_ids is not None else 0)
            new_tokens: list[int] = []
            new_lps: list[float] = []
            new_tops: list[list[tuple[int, float]]] = []
            width = (next_tokens.shape[1] if emit_counts is None
                     else int(emit_counts[s]))
            for j, (token, lp) in enumerate(zip(next_tokens[s][:width],
                                                logprobs[s][:width])):
                token = int(token)
                top = None
                if want_top:
                    top = [(int(t), float(v)) for t, v in
                           zip(top_ids[s, j, :want_top],
                               top_lps[s, j, :want_top])]
                    # OpenAI/vLLM: the SAMPLED token is always present (up
                    # to N+1 entries) even when it fell outside the top N.
                    if token not in (t for t, _ in top):
                        top.append((token, float(lp)))
                    new_tops.append(top)
                seq.append_token(token, float(lp) if want_lps else None, top)
                new_tokens.append(token)
                if want_lps:
                    new_lps.append(float(lp))
                reason = seq.check_stop(self.config.effective_max_len)
                if reason is not None:
                    if defer:
                        seq.status = SequenceStatus.FINISHED
                        seq.finish_reason = reason
                        if seq in self.scheduler.running:
                            self.scheduler.running.remove(seq)
                        self._deferred_release.append(seq)
                        self.obs.on_finish(seq, reason)
                    else:
                        self.scheduler.finish(seq, reason)
                    break
            self.stats.tokens_generated += len(new_tokens)
            if not had_first and seq.first_token_time is not None:
                fetch_s = self._ttft_transfer_s
                if fetch_s is None:
                    fetch_s = self.obs.phases.current_durs.get(
                        "device_fetch", 0.0)
                self.obs.on_first_token(seq, fetch_s=fetch_s)
            if seq.is_finished:
                self.stats.requests_finished += 1
            outputs.append(RequestOutput(
                request_id=seq.request_id,
                prompt_token_ids=seq.prompt_token_ids,
                output_token_ids=list(seq.output_token_ids),
                finished=seq.is_finished,
                finish_reason=(seq.finish_reason.value
                               if seq.finish_reason else None),
                new_token_ids=new_tokens,
                new_logprobs=new_lps if want_lps else None,
                output_logprobs=(list(seq.output_logprobs)
                                 if want_lps else None),
                new_top_logprobs=new_tops if want_top else None,
                output_top_logprobs=(list(seq.output_top_logprobs)
                                     if seq.params.top_logprobs else None)))
        return outputs

    def _drain_terminally_finished(self) -> list[RequestOutput]:
        """Sequences the scheduler finished on its own (grown past pool
        capacity) still owe the client a finished RequestOutput."""
        outs = []
        for seq in self.scheduler.terminally_finished:
            self.stats.requests_finished += 1
            outs.append(RequestOutput(
                request_id=seq.request_id,
                prompt_token_ids=seq.prompt_token_ids,
                output_token_ids=list(seq.output_token_ids),
                finished=True,
                finish_reason=(seq.finish_reason.value
                               if seq.finish_reason else None),
                new_token_ids=[],
                output_logprobs=(list(seq.output_logprobs)
                                 if seq.params.logprobs else None),
                output_top_logprobs=(list(seq.output_top_logprobs)
                                     if seq.params.top_logprobs else None)))
        self.scheduler.terminally_finished.clear()
        return outs

    def _drain_deferred(self) -> None:
        for seq in self._deferred_release:
            if (seq.hold_kv and seq.pages
                    and seq.finish_reason != FinishReason.ABORT):
                # A disaggregated prefill finishing inside a chained decode
                # window: the export seam owns the release, as in the
                # scheduler's finish.
                self.scheduler.held[seq.request_id] = seq
                continue
            if seq.pages:
                self.scheduler.allocator.free(seq.pages)
                seq.pages = []
        self._deferred_release.clear()

    # -- convenience --------------------------------------------------------

    def generate(self, prompts: list[list[int]],
                 params=None) -> list[RequestOutput]:
        """Synchronous batch generation (offline / test path). ``params``:
        one SamplingParams for all prompts, or a list of one per prompt."""
        plist = (list(params) if isinstance(params, (list, tuple))
                 else [params] * len(prompts))
        if len(plist) != len(prompts):
            raise ValueError(f"got {len(plist)} SamplingParams for "
                             f"{len(prompts)} prompts")
        for i, (p, sp) in enumerate(zip(prompts, plist)):
            self.add_request(f"req-{i}", p, sp)
        final: dict[str, RequestOutput] = {}
        while self.has_unfinished_requests():
            for out in self.step():
                if out.finished:
                    final[out.request_id] = out
        return [final[f"req-{i}"] for i in range(len(prompts))]


def _stomp_committed_slot(batch, page_size: int, S: int,
                          token_start: int = 0) -> None:
    """Chaos helper (``KGCT_FAULT=kv_commit_stomp``): redirect row 0's
    first draft KV write to the sequence's position-0 slot — a REAL write
    into committed history (``num_tokens - 1 > 0`` guarantees position 0
    is committed). The KGCT_SANITIZE KV shadow must refuse the dispatch;
    with the sanitizer off this genuinely corrupts context, which is the
    point — the harness validates the detector, not a simulation of it.
    ``token_start``: where the verify slices begin on the token axis
    (spec×mixed offsets them past the prefill chunk)."""
    if not batch.seqs:
        return
    seq = batch.seqs[0]
    if seq.num_tokens < 2 or not seq.pages:
        return
    batch.slot_mapping[token_start + (1 if S > 1 else 0)] = \
        seq.pages[0] * page_size
