"""The engine's step programs: one captured CUDA graph per program key, the
counterpart of the JAX engine's per-bucket jit programs (``_maybe_jit`` and
the jit caches behind ``compiled_step_variants``).

A key's first element names its family; the rest are the bucketed shapes
its JAX jit cache is keyed by:

- ``("greedy" | "sampled", B)``: the decode window (the JAX engine's two
  decode programs), B a bucket of ``SchedulerConfig.decode_buckets``;
- ``("prefill", T, B)``: a ragged prefill of T tokens (a prefill bucket)
  sampling B rows (a decode bucket);
- ``("prefill_hist", T, W)``: one sequence's solo chunk of T tokens over
  a page table W pages wide (the power of two of
  ``Scheduler._chunk_page_table``);
- ``("mixed", Tp, R, W)``: a chunk of Tp tokens, R decode rows (the chunk
  samples on one of them) and the chunk's table width W;
- ``("spec", R, S)``: a verify step of R rows of S = k + 1 tokens over
  the whole ``[R, pps]`` page tables (the JAX program's token width
  ``R * S``; each rung of the adaptive ladder is its own S);
- ``("spec_mixed", Tp, R, W, S)``: a chunk of Tp tokens beside R verify
  rows of S tokens, the chunk's table W wide;
- ``("draft_decode", B)`` and ``("draft_prefill", T, W)``: the draft
  model's greedy dispatch (replayed k times a round) and its reset chunk,
  registered by the draft runner (``add_families``) so that one pool and
  one count serve them, as the JAX engine folds the draft runner's jit
  caches into its own;
- ``("kv_gather", n_pad)`` and ``("kv_scatter", n_pad)``: the KV
  transfers (swap, prefix spill and restore, handoff export and import)
  of n_pad pages, the power of two of the page count, registered by
  ``engine/kv_cache.py::KVTransferPrograms`` (``add_families``), as the
  JAX engine counts its gather and donated scatter jit caches.

Each key owns its ``StaticBuffers``: inputs the dispatcher fills before
every run, state it carries between runs or writes only when it changes
(the decode window's first tokens and penalty counts, a chunk's or a
verify step's penalty history) and outputs that every run overwrites.

- On the card, a key's first run is its warm-up: the body runs eagerly on
  the capture stream (cuBLAS handles and workspaces, the kernels' launch
  records and workspaces, the rope table all come to exist there) and that
  run is the step's result. Then the body is captured into a
  ``torch.cuda.CUDAGraph``, and every later run of the key replays it.
  Capture happens lazily, as ``jax.jit`` compiles at the first call.
- A body's gated stages (``ops/gates.py``: the JAX programs' ``lax.cond``
  stages) are captured as conditional nodes on the per-step flags of the
  key's ``flags`` input, both branches of each; the warm-up ran only the
  host flags' branches and lists them all, so a throwaway capture in
  relaxed mode (never instantiated) takes every branch once before the
  real one (the gated stages alone, not the forward). The flags
  are inputs, not part of the key: one program per JAX jit key.
- All graphs share one memory pool. Nothing allocated inside a capture
  outlives it (the body writes into the static buffers), and replays never
  overlap: they run on the engine's one stream. So one program's scratch
  can be another's, and the kernels' shared workspaces too.
- A capture that fails raises ``CaptureError`` (a capture out of memory
  too): the step is never run eagerly in its place.
- Python's cyclic garbage collector is paused while any capture is open:
  a collection run by the capturing thread, which allocates as the body
  runs, could free a dead engine's graphs and pool there, calls that void
  the capture.
- On the CPU nothing is captured (only CUDA captures): the cache keys the
  same programs around the eager body, so the program count
  (``kgct_jit_compiles_total``) and the compile guard read the same in the
  CPU tests as on the card.
- ``enabled=False`` (``EngineConfig.enforce_eager``; ranks under
  torch.distributed, whose gloo collectives stage through the host and
  cannot be captured) runs the same body eagerly over the same buffers and
  builds no program.

A body is called as ``body(key, buffers)``: the key is static Python data,
the buffers are tensors; branching on the first is free, on the second it
is a host read that capture refuses (KGCT001): a body branches on a step's
flags only through ``gates.when``.
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..ops import cuda as cuda_ops
from ..ops import gates

# (shape, dtype) of a static buffer, by name.
Layout = dict[str, tuple[tuple[int, ...], torch.dtype]]

# One token per capture open in this process: engines in several threads
# may capture at once (list.append and list.remove hold the interpreter
# lock). Outside captures the collector runs as Python's default has it.
_open_captures: list = []


@contextlib.contextmanager
def _collector_paused():
    """No cyclic garbage collection while any capture is open."""
    token = object()
    _open_captures.append(token)
    gc.disable()
    try:
        yield
    finally:
        _open_captures.remove(token)
        if not _open_captures:
            gc.enable()
            if _open_captures:      # another thread opened one meanwhile
                gc.disable()


def activation_bytes(cfg, tokens: int, rows: int, out_cap: int,
                     positions: int = 1) -> int:
    """A reckoning from above of what one program of ``tokens`` tokens and
    ``rows`` sampled rows, each sampled at ``positions`` positions (a
    verify step's S), allocates while it runs, which the graphs' shared
    pool keeps once the program is captured: per layer the MLP's fp32 gate
    and up, their fp32 product and its model-dtype cast (14 bytes a token
    and ffn column; one expert more in flight under the dense MoE
    dispatch), the fp32 projections, RoPE and norm rows; every layer's new
    K/V until the one scatter; the [rows * positions, vocab] fp32 logits,
    held while the positions are sampled one after another; and one
    position's sampling stage, [rows, vocab] fp32 temporaries (the filter
    tiers' sort among them, 16 rows' worth) with the penalty history. The
    stage's gated branches are captured from streams of their own, one per
    nesting depth, whose blocks the pool keeps apart from the forward's:
    every branch is resident at once, which the 16 rows' worth covers (a
    gated stage at 32 rows of llama-3-8b's vocabulary took 12 rows' worth
    of the pool on the card, PERF.md)."""
    item = 4 if cfg.dtype == "float32" else 2
    qkv = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    mlp = 14 * cfg.intermediate_size * (2 if cfg.is_moe else 1)
    layer = tokens * (mlp + 16 * cfg.hidden_size + 12 * qkv)
    kv = 2 * cfg.num_layers * tokens * cfg.num_kv_heads * cfg.head_dim * item
    logits = rows * positions * 4 * cfg.vocab_size
    sampling = rows * (16 * 4 * cfg.vocab_size + 4 * out_cap)
    return layer + kv + logits + sampling


def program_bytes(config, draft=None) -> int:
    """The largest program of every family ``config``'s engine may build,
    by ``activation_bytes``: the prefill and mixed steps (a prefill bucket
    of tokens beside a decode bucket of rows), with speculation on the
    spec×mixed step at the ladder's top rung (a chunk beside R verify
    rows of S tokens, every slot's logits kept), and ``draft``'s (the
    draft model's config) decode dispatch and reset chunk. The pool is
    shared and replays never overlap, so the largest, not the sum. The KV
    transfer programs allocate nothing there: they move pages through
    their own staging (``engine/kv_cache.py::transfer_bytes``)."""
    sc = config.scheduler
    T, B = max(sc.prefill_buckets), max(sc.decode_buckets)
    cap = config.effective_max_len
    sizes = [activation_bytes(config.model, T + B, B + 1, cap)]
    if sc.spec_decode_enabled:
        S = sc.effective_spec_k_max + 1
        sizes.append(activation_bytes(config.model, T + B * S, B + 1, cap,
                                      positions=S))
        if draft is not None:
            sizes.append(activation_bytes(draft, max(512, B), B, 0))
    return max(sizes)


class CaptureError(RuntimeError):
    """A program's capture failed; its step does not run eagerly
    instead."""


class StaticBuffers:
    """One program's static tensors. The inputs of one dtype are views of
    one device buffer, so ``upload`` fills them all with one copy from one
    pinned host buffer; ``state`` buffers (zeros at first) are written on
    the device only."""

    def __init__(self, device: torch.device, inputs: Layout, state: Layout):
        self.device = device
        self.host: dict = {}        # the last upload's host arrays
        self.tensors: dict[str, torch.Tensor] = {}
        # dtype -> (device buffer, [(name, offset, shape)])
        self._packs: dict[torch.dtype, tuple] = {}
        by_dtype: dict[torch.dtype, list] = {}
        for name, (shape, dtype) in inputs.items():
            by_dtype.setdefault(dtype, []).append((name, shape))
        for dtype, entries in by_dtype.items():
            n = sum(int(np.prod(s)) for _, s in entries)
            buf = torch.zeros(n, dtype=dtype, device=device)
            segs, off = [], 0
            for name, shape in entries:
                size = int(np.prod(shape))
                self.tensors[name] = buf[off:off + size].view(shape)
                segs.append((name, off, shape))
                off += size
            self._packs[dtype] = (buf, segs)
        for name, (shape, dtype) in state.items():
            self.tensors[name] = torch.zeros(shape, dtype=dtype,
                                             device=device)

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.tensors[name]

    def flags(self, names: tuple) -> dict:
        """The int32 input ``flags`` as ``gates.Flag``s by name (``names``
        in its order): each the last upload's host value beside its device
        copy, which a captured program's conditional nodes read."""
        host, dev = self.host["flags"], self.tensors["flags"]
        return {name: gates.Flag(bool(host[i]), dev[i:i + 1])
                for i, name in enumerate(names)}

    def upload(self, arrays: dict) -> None:
        """Every input from the host arrays of the same names (shapes must
        match). On the card each dtype's inputs are packed into one pinned
        buffer and copied without blocking: PyTorch's pinned allocator
        keeps the buffer from reuse until its copy has run, so a chained
        window's upload never waits for the window before it."""
        pinned = self.device.type == "cuda"
        self.host = arrays
        for buf, segs in self._packs.values():
            host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=pinned)
            flat = host.numpy()
            for name, off, shape in segs:
                a = np.asarray(arrays[name])
                if a.shape != tuple(shape):
                    raise ValueError(f"static input {name}: shape {a.shape}"
                                     f", the program takes {tuple(shape)}")
                flat[off:off + a.size] = a.reshape(-1)
            buf.copy_(host, non_blocking=pinned)


class StepPrograms:
    """The program cache of one engine: ``buffers(key)`` gives a key's
    static buffers (made at its first run), ``run(key)`` runs its step:
    eagerly, or captured once and replayed."""

    def __init__(self, bodies: dict[str, Callable],
                 layout: Optional[Callable], device: torch.device,
                 enabled: bool):
        """``bodies[family](key, buffers)`` is one step of a key of that
        family (``key[0]``); ``layout(key)`` gives the (inputs, state)
        ``Layout``s of a key's buffers (None with no bodies: a cache whose
        families are all registered later)."""
        self._bodies: dict[str, Callable] = {}
        self._layouts: dict[str, Callable] = {}
        self.add_families(bodies, layout)
        self.device = device
        self.enabled = enabled
        self.captures = enabled and device.type == "cuda"
        self._buffers: dict = {}
        self._programs: dict = {}
        self._stream: Optional[torch.cuda.Stream] = None
        self._pool = None
        # The streams the conditional nodes' bodies are captured from, one
        # per nesting depth (ops/gates.py), shared by every capture.
        self._children: list = []
        # Per capture: host seconds of the capture itself (the warm-up
        # run is not in it); the shared pool's growth in reserved bytes;
        # steps run by replay.
        self.capture_seconds: list[float] = []
        self.pool_bytes = 0
        self.replays = 0

    def add_families(self, bodies: dict[str, Callable],
                     layout: Callable) -> "StepPrograms":
        """Register more families, with their own layout, in this cache
        (the draft runner's bodies in its engine's: one pool, one count).
        Returns the cache."""
        for family, body in bodies.items():
            if family in self._bodies:
                raise ValueError(f"step program family {family!r} is "
                                 "registered already")
            self._bodies[family] = body
            self._layouts[family] = layout
        return self

    def __len__(self) -> int:
        """Programs built: graphs captured on the card, keys seen on the
        CPU; 0 when disabled."""
        return len(self._programs)

    def keys(self, family: Optional[str] = None) -> list:
        """The programs built, sorted; only ``family``'s when given."""
        return sorted(k for k in self._programs
                      if family is None or k[0] == family)

    def recorded_launches(self) -> dict:
        """Per captured program, the kernel launches its graph holds."""
        return {key: prog[1] for key, prog in sorted(self._programs.items())
                if prog is not None}

    def buffers(self, key) -> StaticBuffers:
        bufs = self._buffers.get(key)
        if bufs is None:
            bufs = self._buffers[key] = StaticBuffers(
                self.device, *self._layouts[key[0]](key))
        return bufs

    def run(self, key) -> None:
        """One step of ``key`` over its buffers, on the current stream."""
        bufs = self.buffers(key)
        body = self._bodies[key[0]]
        if not self.enabled:
            body(key, bufs)
            return
        prog = self._programs.get(key)
        if not self.captures:
            self._programs[key] = None
            body(key, bufs)
        elif prog is None:
            self._programs[key] = self._capture(key, body, bufs)
        else:
            graph, launches, _ = prog
            graph.replay()
            self.replays += 1
            cuda_ops.add_launches(launches)

    def _capture(self, key, body: Callable, bufs: StaticBuffers) -> tuple:
        """Warm up (this step, eagerly, on the capture stream), then
        capture the body into a graph in the shared pool. Returns (graph,
        kernel launches the graph holds by kernel, the scratch tensors its
        kernels use, kept alive with it).

        The warm-up runs one branch of each gated stage (the host flags')
        and lists every branch of the gates it meets; a throwaway capture
        in relaxed mode, whose graph is never instantiated, then takes each
        of them once, nested gates inline (a first call's lazy set-up,
        allowed there; a branch a capture refuses fails there, before any
        conditional node exists), and the real capture records both
        branches of each gate as conditional nodes."""
        main = torch.cuda.current_stream(self.device)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        side = self._stream
        side.wait_stream(main)
        with torch.cuda.stream(side):
            with gates.collecting() as branches:
                body(key, bufs)
            reserved = torch.cuda.memory_reserved(self.device)
            t0 = time.perf_counter()
            throwaway = torch.cuda.CUDAGraph(keep_graph=True)
            if branches:
                with self._recording(key, throwaway, inline=True):
                    throwaway.capture_begin(pool=self._pool,
                                            capture_error_mode="relaxed")
                    for branch in branches:
                        branch()
            del branches
            graph = torch.cuda.CUDAGraph()
            with self._recording(key, graph) as (recorded, scratch):
                # thread_local: another thread's CUDA calls (a /metrics
                # scrape reading free memory) do not void this thread's
                # capture.
                graph.capture_begin(pool=self._pool,
                                    capture_error_mode="thread_local")
                body(key, bufs)
            # Only now: the pool must not drop to no graph between the
            # two captures (the allocator refuses a pool it freed).
            del throwaway
        self.capture_seconds.append(time.perf_counter() - t0)
        self.pool_bytes += torch.cuda.memory_reserved(self.device) - reserved
        main.wait_stream(side)
        return graph, dict(recorded), scratch

    @contextlib.contextmanager
    def _recording(self, key, graph: "torch.cuda.CUDAGraph",
                   inline: bool = False):
        """Open around one capture of ``graph``, begun and recorded inside;
        ends it on leaving. A capture launches nothing: the wrapper counts
        of this thread's capture (other engines' threads launch meanwhile)
        are taken back and move to the replays, each of which launches what
        the graph recorded. The capture's kernels get workspaces and
        counters of their own: a replay may run while another engine's
        thread warms a capture up on its side stream. Gates inside become
        conditional nodes (with ``inline``, every branch in the graph as
        it is: ``gates.capturing``). Yields (the launches recorded, the
        scratch sets); raises ``CaptureError`` if the capture fails."""
        with _collector_paused(), cuda_ops.tally_launches() as recorded, \
                cuda_ops.capture_scratch() as scratch, \
                gates.capturing(self.device, self._pool, self._children,
                                inline):
            try:
                yield recorded, scratch
                graph.capture_end()
            except Exception as err:    # out of memory too
                self._abandon(graph)
                raise CaptureError(f"capture of step program {key} "
                                   f"failed: {err}") from err
            finally:
                cuda_ops.add_launches({k: -n for k, n in recorded.items()})

    def _abandon(self, graph: "torch.cuda.CUDAGraph") -> None:
        """End a capture that failed. PyTorch ends a capture's routing of
        this stream's allocations to the pool, and gives the pool back,
        only for a capture that ended well: left as they are, the caching
        allocator would defer every later free for the capture it still
        sees and could release no cached memory again."""
        try:
            graph.capture_end()
        except RuntimeError:
            pass                    # the error voided the capture
        else:
            # It ended (the error came after it, or from a conditional
            # node's body only): PyTorch ended the routing, and the graph
            # gives its pool reference back when it is dropped.
            return
        index = gates.device_index(self.device)
        for end in (torch._C._cuda_endAllocateToPool,
                    torch._C._cuda_releasePool):
            try:
                end(index, self._pool)
            except RuntimeError:
                pass                # capture_end got this far already
