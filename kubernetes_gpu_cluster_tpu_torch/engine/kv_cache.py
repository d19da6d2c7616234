"""Paged KV cache: device-side page pool, host-side page allocator, and the
host KV tier.

- Device side: one K and one V tensor of shape
  ``[num_layers, num_pages, page_size, num_kv_heads * head_dim]`` on the
  engine's device. The layout is byte-for-byte the JAX package's: heads are
  stored flattened so one page's K rows are one contiguous run, and the
  cross-replica KV wire format depends on it. The attention kernels address
  the stacked pool through page tables and a layer index; the one
  post-forward scatter (``ops.attention.write_kv_pages_all``) updates it in
  place.
- Host side: ``PageAllocator`` — a free-list allocator with refcounts,
  mirroring vLLM's block manager role. Page 0 is reserved as a scrap page:
  padding tokens write there so the scatter needs no masking.

Two-tier extension (``CacheConfig.swap_space_gb`` > 0): a second page pool
in host memory (``HostKVPool``) and the device<->host transfers
(``KVSwapper``): the scheduler preempts by swap instead of recompute, and
the prefix cache spills evicted pages for a second-chance restore. The
cross-replica seam (``KVPageIO``: disaggregated prefill/decode, live
migration, the fleet prefix cache) rides the same gather/scatter pair
(``KVTransferPrograms``).

Transfer discipline, on one CUDA stream: the gather and the scatter are
step programs of the engine's cache, keyed as the JAX package's jit caches
by the page count's power of two (``KVTransferPrograms``). A gather is
queued behind every kernel already on the stream, so it reads what they
wrote; its copies to pinned host memory follow it, and every call that
moves pages to the host waits on an event recorded after them, so the
caller may free and reuse the device pages at once. A scatter writes the
engine's pool tensors in place; its copies read pinned host pages after
the call returns, and those pages go back to the host free list with the
copy's event and are handed out again only once it completed
(``HostKVPool.allocate`` waits).
"""

from __future__ import annotations

import hashlib
import time
import weakref
from collections import OrderedDict
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..config import ModelConfig, CacheConfig
from ..resilience.faults import inject as _inject_fault
from ..utils import cdiv, get_logger
from ..utils.math import next_power_of_2

logger = get_logger("kv_cache")

# Page 0 never backs real tokens; padding slots scatter into it.
SCRAP_PAGE = 0


class KVCache(NamedTuple):
    """Device-side paged KV pool. k/v: [L, P, page_size, n_kv * head_dim]."""
    k: torch.Tensor
    v: torch.Tensor

    @property
    def num_pages(self) -> int:
        return self.k.shape[1]

    @property
    def page_size(self) -> int:
        return self.k.shape[2]


def kv_dtype(model: ModelConfig, cache: CacheConfig) -> torch.dtype:
    return getattr(torch, cache.dtype) if cache.dtype else model.torch_dtype


def allocate_kv_cache(model: ModelConfig, cache: CacheConfig, num_pages: int,
                      device: torch.device | str) -> KVCache:
    shape = (model.num_layers, num_pages, cache.page_size,
             model.num_kv_heads * model.head_dim)
    dtype = kv_dtype(model, cache)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def kv_cache_bytes_per_page(model: ModelConfig, cache: CacheConfig) -> int:
    itemsize = torch.empty((), dtype=kv_dtype(model, cache)).element_size()
    per_tok = model.num_kv_heads * model.head_dim * itemsize
    return 2 * model.num_layers * cache.page_size * per_tok


def transfer_pages(max_model_len: int, page_size: int) -> int:
    """The largest KV transfer bucket: the power of two of one full-length
    sequence's pages."""
    return next_power_of_2(cdiv(max_model_len, page_size))


def transfer_bytes(model: ModelConfig, cache: CacheConfig,
                   max_model_len: int) -> int:
    """Device bytes of the KV transfers' staging (K and V of the largest
    bucket), which the engine keeps out of the page pool."""
    return (kv_cache_bytes_per_page(model, cache)
            * transfer_pages(max_model_len, cache.page_size))


def derive_num_pages(
    model: ModelConfig,
    cache: CacheConfig,
    max_model_len: int,
    max_num_seqs: int,
    free_bytes: Optional[int] = None,
    groups=None,
) -> int:
    """Size the page pool. If ``cache.num_pages`` is set, use it; else use
    ``hbm_utilization`` of the device's free memory (the reference's
    gpuMemoryUtilization semantics; the engine reads it from
    ``torch.cuda.mem_get_info``); else fall back to enough pages for
    max_num_seqs full-length sequences (CPU/test path).

    ``groups`` (``parallel.ParallelGroups``): the free bytes are first
    all-reduced with MIN over every rank, so all ranks size one pool and
    their schedulers stay in lockstep. ``model`` then carries one rank's
    kv heads (``parallel.sharding.local_kv_config``)."""
    if cache.num_pages is not None:
        return cache.num_pages
    if free_bytes is not None and groups is not None:
        free_bytes = groups.world_min(free_bytes)
    if free_bytes is not None:
        budget = int(free_bytes * cache.hbm_utilization)
        n = budget // kv_cache_bytes_per_page(model, cache)
        if n < 2:
            raise ValueError(
                f"device memory budget {budget} too small for even 2 KV "
                f"pages ({kv_cache_bytes_per_page(model, cache)} B/page)")
        return n
    pages_per_seq = cdiv(max_model_len, cache.page_size)
    return max_num_seqs * pages_per_seq + 1  # +1 scrap page


class PageAllocator:
    """Free-list page allocator with refcounts (enables future copy-on-write
    prefix sharing). All operations O(1) amortized. Host-side only — the device
    never sees this object, just the block tables it produces."""

    def __init__(self, num_pages: int, page_size: int):
        assert num_pages >= 2, "need at least scrap page + 1 usable page"
        self.num_pages = num_pages
        self.page_size = page_size
        # Page 0 is the scrap page and never allocatable.
        self._free: list[int] = list(range(num_pages - 1, 0, -1))
        self._refcount: dict[int, int] = {}

    @property
    def num_free(self) -> int:
        return len(self._free)

    def can_allocate(self, n: int) -> bool:
        return len(self._free) >= n

    def allocate(self, n: int) -> list[int]:
        if not self.can_allocate(n):
            raise RuntimeError(f"KV page pool exhausted: want {n}, free {self.num_free}")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refcount[p] = 1
        return pages

    def fork(self, page: int) -> None:
        """Increment refcount (copy-on-write prefix sharing)."""
        self._refcount[page] += 1

    def free(self, pages: list[int]) -> None:
        for p in pages:
            rc = self._refcount.get(p)
            if rc is None:
                raise RuntimeError(f"double free of page {p}")
            if rc == 1:
                del self._refcount[p]
                self._free.append(p)
            else:
                self._refcount[p] = rc - 1

    def pages_for_tokens(self, num_tokens: int) -> int:
        return cdiv(num_tokens, self.page_size)


def dtype_name(dtype) -> str:
    """The JAX package's spelling of a KV dtype ("float32", "bfloat16"):
    the export states carry it, so either package reads the other's."""
    return str(dtype).removeprefix("torch.")


def host_tensor(a) -> torch.Tensor:
    """A CPU tensor over one transferred K or V buffer ``[L, n, ps, kd]``:
    a CPU torch tensor as it is, or a numpy array (the reference's wire
    codec decodes to numpy). numpy has no bfloat16 of its own; an array of
    that dtype (``ml_dtypes``, what the JAX side decodes to) is read
    through its 16-bit pattern."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise ValueError(f"KV buffer on {a.device}, expected the host")
        return a
    a = np.asarray(a)
    if str(a.dtype) == "bfloat16":
        return host_tensor(a.view(np.uint16)).view(torch.bfloat16)
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a)


class KVTransferRefused(RuntimeError):
    """A KV transfer was refused before any byte moved: the host tier is
    full after reclaim or the ``kv_swap_fail`` chaos site fired (swap-out),
    or an importing engine has no seat or pages for the state. The caller
    degrades (recompute preemption, local prefill); a device fault during a
    transfer is never this type and propagates."""


def _runs(pages: list[int]) -> list[tuple[int, int, int]]:
    """(first page id, its index in ``pages``, length) of each run of
    consecutive page ids: one host copy per run and layer."""
    runs = []
    start = 0
    for i in range(1, len(pages) + 1):
        if i == len(pages) or pages[i] != pages[i - 1] + 1:
            runs.append((pages[start], start, i - start))
            start = i
    return runs


def _page_rows(pool: torch.Tensor) -> torch.Tensor:
    """A ``[L, P, ps, kd]`` pool tensor as ``[L * P, ps * kd]`` page rows
    (a view: writes land in the pool)."""
    return pool.view(pool.shape[0] * pool.shape[1], -1)


def _pin(t: torch.Tensor) -> None:
    rc = int(torch.cuda.cudart().cudaHostRegister(
        t.data_ptr(), t.numel() * t.element_size(), 0))
    if rc != 0:
        raise RuntimeError(f"cudaHostRegister of the host KV pool failed "
                           f"(cudaError {rc})")


def _unpin(*tensors: torch.Tensor) -> None:
    for t in tensors:
        torch.cuda.cudart().cudaHostUnregister(t.data_ptr())


class HostKVPool:
    """Second KV tier: a page pool in host memory, sized by
    ``CacheConfig.swap_space_gb``. Same ``[L, P, page_size, kv_dim]`` layout
    and dtype as the device pool, so a page moves as one contiguous run per
    layer.

    On a CUDA engine both tensors are allocated once at their exact size
    and page-locked with ``cudaHostRegister`` (the caching allocator behind
    ``pin_memory=True`` may round a block up to a power of two), so every
    copy to or from them is a direct DMA. Pinning faults in every page:
    it costs time once, at start-up (``pin_s``, logged). The JAX package
    backs its pool lazily with pageable ``np.zeros`` instead. A CPU engine's
    pool is ordinary memory.

    Pages freed while a host->device copy may still read them wait on that
    copy's event (``free(pages, event)``). They count as free for every
    capacity decision, so the port's swap decisions are the JAX package's,
    and ``allocate`` waits for the pending events before it hands a page
    out again."""

    def __init__(self, num_pages: int, num_layers: int, page_size: int,
                 kv_dim: int, dtype: torch.dtype, pin: bool = False):
        assert num_pages >= 1, "host pool needs at least one page"
        self.num_pages = num_pages
        shape = (num_layers, num_pages, page_size, kv_dim)
        self.k = torch.empty(shape, dtype=dtype)
        self.v = torch.empty(shape, dtype=dtype)
        self.pin_s = 0.0
        if pin:
            t0 = time.perf_counter()
            _pin(self.k)
            try:
                _pin(self.v)
            except RuntimeError:
                _unpin(self.k)
                raise
            # Unregister when the pool dies (process exit frees it anyway).
            weakref.finalize(self, _unpin, self.k, self.v).atexit = False
            self.pin_s = time.perf_counter() - t0
        self._free: list[int] = list(range(num_pages - 1, -1, -1))
        self._pending: list[tuple[torch.cuda.Event, list[int]]] = []

    @property
    def num_free(self) -> int:
        return len(self._free) + sum(len(p) for _, p in self._pending)

    @property
    def num_in_use(self) -> int:
        return self.num_pages - self.num_free

    def can_allocate(self, n: int) -> bool:
        return self.num_free >= n

    def allocate(self, n: int) -> list[int]:
        if not self.can_allocate(n):
            raise RuntimeError(
                f"host KV pool exhausted: want {n}, free {self.num_free}")
        # Every pending copy was queued before the caller's transfer: on one
        # stream that transfer waits for them anyway, so waiting here first
        # costs nothing and keeps the free-list order deterministic.
        for event, pages in self._pending:
            event.synchronize()
            self._release(pages)
        self._pending.clear()
        # Ascending ids: consecutive pages make one copy per layer and run.
        return sorted(self._free.pop() for _ in range(n))

    def _release(self, pages: list[int]) -> None:
        # The lowest id on top of the stack: the next allocation pops a
        # freed run back in ascending order instead of reversing it.
        self._free.extend(sorted(pages, reverse=True))

    def free(self, pages: list[int],
             event: Optional[torch.cuda.Event] = None) -> None:
        """Return ``pages``; with ``event``, only once it has completed."""
        if event is None:
            self._release(pages)
        else:
            self._pending.append((event, list(pages)))

    def put(self, pages: list[int], k: torch.Tensor, v: torch.Tensor) -> None:
        """Write host buffers ``[L, n, ps, kd]`` into ``pages``."""
        idx = torch.tensor(pages, dtype=torch.int64)
        self.k.index_copy_(1, idx, k)
        self.v.index_copy_(1, idx, v)

    def get(self, pages: list[int]) -> tuple[torch.Tensor, torch.Tensor]:
        """A copy of ``pages`` as host buffers ``[L, n, ps, kd]``."""
        idx = torch.tensor(pages, dtype=torch.int64)
        return self.k.index_select(1, idx), self.v.index_select(1, idx)


class KVTransferPrograms:
    """The one gather/scatter pair behind every KV transfer seam —
    :class:`KVSwapper` (device<->host tier) and :class:`KVPageIO`
    (cross-replica handoff) share one instance, so the transfer discipline
    lives in one place.

    Two families of step programs in the engine's program cache
    (``engine/step_programs.py``), keyed as the JAX package's gather and
    donated scatter jit caches: ``("kv_gather", n_pad)`` and
    ``("kv_scatter", n_pad)``, ``n_pad = next_power_of_2(len(pages))``.
    The programs move page rows (one page of one layer, ``ps * kd``
    elements) between the pool and one device staging buffer per tensor,
    through one row index of ``L * n_pad`` entries: the n pages of every
    layer first, layer by layer, so that the staging's first ``L * n``
    rows hold a ``[L, n, ps, kd]`` host buffer's bytes in order, then the
    padded rows, each at its layer's ``SCRAP_PAGE``.

    - gather: ``index_select`` of the pool's rows into the staging;
    - scatter: ``index_copy_`` of the staging's rows INTO the engine's pool
      tensors (the kernel wrappers take the pool pointers per call, so the
      pool is never rebound). The padded staging rows are zero, as the JAX
      ``k_data`` is, so the duplicate ``SCRAP_PAGE`` writes all write the
      same bytes.

    A captured program reads and writes its staging at one address on
    every replay, so with programs the staging is made once, at the first
    transfer, sized for the largest bucket (``transfer_pages``), outside
    the programs' shared pool, and the engine reckons it out of the page
    pool (``transfer_bytes``). With programs disabled (``enforce_eager``,
    a rank) it grows to the largest bucket moved, as an eager transfer's
    buffers stay in the caching allocator, and nothing is reckoned.

    Between the staging and host memory the copies run on the same stream
    outside the graph: one DMA per tensor for an export's or an import's
    buffers (one per layer for a page range sliced out of a larger
    buffer), one per run of consecutive host pages, layer and tensor to
    or from the host pool. A gather completes inside its call (an event
    after its copies), so the caller may free and reuse the device pages
    at once; a scatter returns the event after its program, until which
    its host pages are read. Only a CUDA engine records events (a CPU
    engine's copies have completed when they return)."""

    def __init__(self, device: torch.device, programs, max_pages: int):
        """``programs``: the engine's ``StepPrograms``, where the two
        families are registered. ``max_pages``: the largest bucket, a power
        of two (``transfer_pages``)."""
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.programs = programs.add_families(
            {"kv_gather": self._gather_body,
             "kv_scatter": self._scatter_body}, self._layout)
        self.max_pages = max_pages
        self._kv: Optional[KVCache] = None
        self._staging: tuple = ()

    def _layout(self, key) -> tuple[dict, dict]:
        rows = self._kv.k.shape[0] * key[1]
        return {"rows": ((rows,), torch.int64)}, {}

    def _gather_body(self, key, bufs) -> None:
        rows = bufs["rows"]
        for pool, stage in zip(self._kv, self._staging):
            torch.index_select(_page_rows(pool), 0, rows,
                               out=stage[:rows.shape[0]])

    def _scatter_body(self, key, bufs) -> None:
        rows = bufs["rows"]
        for pool, stage in zip(self._kv, self._staging):
            _page_rows(pool).index_copy_(0, rows, stage[:rows.shape[0]])

    def _stage(self, kv: "KVCache", n: int) -> tuple[int, tuple]:
        """Bind the programs to ``kv`` at the first transfer; returns the
        bucket of ``n`` pages and the staging rows of that bucket, K and
        V."""
        if self._kv is None:
            self._kv = kv
        elif kv.k.data_ptr() != self._kv.k.data_ptr():
            raise ValueError("the KV transfer programs serve one pool")
        n_pad = next_power_of_2(n)
        if n_pad > self.max_pages:
            raise ValueError(f"a transfer of {n} pages exceeds the largest "
                             f"bucket, {self.max_pages} pages")
        L, _, ps, kd = kv.k.shape
        pages = self.max_pages if self.programs.enabled else n_pad
        if not self._staging or len(self._staging[0]) < L * pages:
            self._staging = tuple(
                torch.empty((L * pages, ps * kd), dtype=kv.k.dtype,
                            device=kv.k.device) for _ in range(2))
        return n_pad, tuple(s[:L * n_pad] for s in self._staging)

    def _run(self, family: str, n_pad: int, pages: list[int]) -> None:
        """Run ``family``'s program over ``pages``, padded to ``n_pad``
        with ``SCRAP_PAGE``."""
        L, P = self._kv.k.shape[:2]
        base = np.arange(L, dtype=np.int64) * P
        rows = np.concatenate([
            (base[:, None] + np.asarray(pages, np.int64)).reshape(-1),
            np.repeat(base + SCRAP_PAGE, n_pad - len(pages))])
        key = (family, n_pad)
        self.programs.buffers(key).upload({"rows": rows})
        self.programs.run(key)

    def _event(self) -> Optional[torch.cuda.Event]:
        """The event after the work queued so far on a CUDA engine; None
        on a CPU engine, whose copies have completed on return."""
        if not self.cuda:
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return event

    def _fence(self) -> None:
        """Return only once every queued copy into host memory is done."""
        if self.cuda:
            self._event().synchronize()

    def gather_pages(self, kv: "KVCache", pages: list[int]
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """Gather ``pages`` into a contiguous host buffer per tensor, each
        of shape ``[L, n, ps, kd]`` (pinned on a CUDA engine), one copy
        each. The copy COMPLETES inside this call: after return the device
        pages are free to be released and reallocated."""
        n = len(pages)
        n_pad, staged = self._stage(kv, n)
        self._run("kv_gather", n_pad, pages)
        L, _, ps, kd = kv.k.shape
        out = []
        for src in staged:
            host = torch.empty((L, n, ps, kd), dtype=src.dtype,
                               pin_memory=self.cuda)
            host.view(L * n, -1).copy_(src[:L * n], non_blocking=True)
            out.append(host)
        self._fence()
        return out[0], out[1]

    def gather_to_host(self, kv: "KVCache", pages: list[int],
                       host: HostKVPool, host_pages: list[int]) -> None:
        """Gather device ``pages`` into the host pool's ``host_pages`` (one
        copy per run of consecutive host pages, layer and tensor, straight
        into the pool). Completes inside the call, like
        :meth:`gather_pages`."""
        n = len(pages)
        n_pad, staged = self._stage(kv, n)
        self._run("kv_gather", n_pad, pages)
        for src, dst in zip(staged, (host.k, host.v)):
            for h0, i0, m in _runs(host_pages):
                for layer in range(dst.shape[0]):
                    r = layer * n + i0
                    dst[layer, h0:h0 + m].view(m, -1).copy_(
                        src[r:r + m], non_blocking=True)
        self._fence()

    def scatter_pages(self, kv: "KVCache", device_pages: list[int],
                      k: torch.Tensor, v: torch.Tensor
                      ) -> Optional[torch.cuda.Event]:
        """Write host buffers ``[L, n, ps, kd]`` into ``device_pages`` of
        the pool, in place (one copy per tensor into the staging, one per
        layer for a page range sliced out of a larger buffer, then the
        program). Returns the event after the program on a CUDA engine
        (the host buffers are read until it completes), else None."""
        n = len(device_pages)
        n_pad, staged = self._stage(kv, n)
        for dst, src in zip(staged, (k, v)):
            L = src.shape[0]
            if src.is_contiguous():
                dst[:L * n].copy_(src.view(L * n, -1), non_blocking=True)
            else:
                for layer in range(L):
                    dst[layer * n:(layer + 1) * n].copy_(
                        src[layer].reshape(n, -1), non_blocking=True)
        return self._scatter(n_pad, device_pages, staged)

    def scatter_from_host(self, kv: "KVCache", device_pages: list[int],
                          host: HostKVPool, host_pages: list[int]
                          ) -> Optional[torch.cuda.Event]:
        """Write the host pool's ``host_pages`` into ``device_pages`` (one
        copy per run of consecutive host pages, layer and tensor into the
        staging, then the program). Returns the event after the program on
        a CUDA engine (the host pages are read until it completes), else
        None."""
        n = len(host_pages)
        n_pad, staged = self._stage(kv, n)
        for dst, src in zip(staged, (host.k, host.v)):
            for h0, i0, m in _runs(host_pages):
                for layer in range(src.shape[0]):
                    r = layer * n + i0
                    dst[r:r + m].copy_(src[layer, h0:h0 + m].view(m, -1),
                                       non_blocking=True)
        return self._scatter(n_pad, device_pages, staged)

    def _scatter(self, n_pad: int, device_pages: list[int], staged
                 ) -> Optional[torch.cuda.Event]:
        """Zero the staging's padded rows and run the scatter program."""
        real = self._kv.k.shape[0] * len(device_pages)
        for s in staged:
            s[real:].zero_()
        self._run("kv_scatter", n_pad, device_pages)
        return self._event()


class KVSwapper:
    """Device<->host page movement for the two-tier KV cache, on the shared
    :class:`KVTransferPrograms` pair.

    - ``swap_out`` returns only after the pages' bytes are in the host
      pool: the caller may free the device pages at once.
    - ``swap_in`` queues the copies and the scatter program and returns;
      the host pages go back to the pool with the program's event, so a
      swap-out in the same ``schedule()`` never overwrites a host page
      still being read. Its latency sample (``obs.on_swap``) is therefore
      the time to queue the transfer, not to finish it.

    Only a full host tier (after reclaim) and the ``kv_swap_fail`` chaos
    site raise :class:`KVTransferRefused`; the scheduler degrades those
    to recompute preemption, and every other error propagates."""

    def __init__(self, host_pool: HostKVPool,
                 get_kv: Callable[[], "KVCache"],
                 programs: KVTransferPrograms, obs=None):
        self.host = host_pool
        self._get_kv = get_kv
        self.programs = programs
        self.obs = obs
        # Optional host-tier reclaim hook (the prefix-spill store registers
        # one): asked to drop LRU spilled entries when a swap-out needs room
        # — live-session KV outranks re-computable spilled prefixes.
        self.reclaim = None
        # Optional restore notification (the KGCT_SANITIZE KV-slot shadow
        # registers one): a swapped-in slot is committed history.
        self.on_restored = None

    def _emit(self, direction: str, pages: int, dt: float,
              request_id: str) -> None:
        if self.obs is not None:
            self.obs.on_swap(direction, pages, dt, request_id)

    def swap_out(self, pages: list[int], request_id: str = "") -> list[int]:
        """Gather ``pages`` from the device pool into host pages; returns
        the host page ids. Raises :class:`KVTransferRefused` when the host
        tier has no room even after reclaim, or the chaos site
        ``kv_swap_fail`` (KGCT_FAULT) fires."""
        if _inject_fault("kv_swap_fail"):
            raise KVTransferRefused("KGCT_FAULT kv_swap_fail: injected "
                                    "swap-out failure")
        n = len(pages)
        if not self.host.can_allocate(n) and self.reclaim is not None:
            self.reclaim(n - self.host.num_free)
        if not self.host.can_allocate(n):
            raise KVTransferRefused(
                f"host KV pool full: want {n}, free {self.host.num_free}")
        t0 = time.perf_counter()
        host_pages = self.host.allocate(n)
        try:
            self.programs.gather_to_host(self._get_kv(), pages, self.host,
                                         host_pages)
        except BaseException:
            self.host.free(host_pages)
            raise
        self._emit("out", n, time.perf_counter() - t0, request_id)
        return host_pages

    def swap_in(self, host_pages: list[int], device_pages: list[int],
                request_id: str = "") -> None:
        """Scatter host pages into freshly allocated device pages and
        release the host copies once the copy has read them."""
        n = len(host_pages)
        assert n == len(device_pages)
        t0 = time.perf_counter()
        event = self.programs.scatter_from_host(
            self._get_kv(), device_pages, self.host, host_pages)
        self.host.free(host_pages, event)
        self._emit("in", n, time.perf_counter() - t0, request_id)

    # -- single-page convenience (prefix-spill) -----------------------------

    def spill_page(self, page: int) -> Optional[int]:
        """Best-effort single-page spill (prefix-cache eviction path): None
        when the host tier has no room — spill never evicts host entries,
        so session swap-outs keep priority over re-computable prefixes."""
        if not self.host.can_allocate(1):
            return None
        try:
            [hp] = self.swap_out([page])
        except KVTransferRefused:
            return None   # chaos-injected: drop, don't spill
        return hp

    def restore_page(self, host_page: int, device_page: int) -> None:
        self.swap_in([host_page], [device_page])

    def free_host(self, host_pages: list[int]) -> None:
        if host_pages:
            self.host.free(host_pages)

    def notify_restored(self, seq) -> None:
        if self.on_restored is not None:
            self.on_restored(seq)


class KVPageIO:
    """Cross-REPLICA KV page movement: the export/import seam of
    disaggregated prefill/decode serving, live migration and the fleet
    prefix cache. An exporter gathers committed pages into one contiguous
    host buffer pair (``export_pages``); an importer scatters a transferred
    pair into freshly allocated pages of its own pool (``import_pages``)
    and the sequence resumes decode directly — the swap-in path, never a
    prefill replay. Same machinery as :class:`KVSwapper`: both seams
    delegate to one shared :class:`KVTransferPrograms`.

    The buffers are CPU tensors ``[L, n, ps, kd]`` in the pool's dtype;
    ``import_pages`` also takes numpy arrays (:func:`host_tensor`), which
    is what the reference's wire codec decodes to."""

    def __init__(self, get_kv: Callable[[], "KVCache"],
                 programs: KVTransferPrograms):
        self._get_kv = get_kv
        self.programs = programs

    def export_pages(self, pages: list[int]
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """Gather ``pages`` into one contiguous host buffer pair. The copy
        COMPLETES inside this call: after return the device pages are free
        to be released and reallocated."""
        return self.programs.gather_pages(self._get_kv(), pages)

    def import_pages(self, device_pages: list[int], k, v) -> None:
        """Scatter a transferred buffer pair into ``device_pages``, in
        place. Pinned sources from PyTorch's allocator are kept alive by it
        until the copy has read them; pageable ones are staged before the
        call returns."""
        k, v = host_tensor(k), host_tensor(v)
        n = len(device_pages)
        assert k.shape[1] == n and v.shape[1] == n
        self.programs.scatter_pages(self._get_kv(), device_pages, k, v)


def build_kv_swapper(model: ModelConfig, cache: CacheConfig, kv: "KVCache",
                     get_kv, programs: KVTransferPrograms, obs=None
                     ) -> Optional[KVSwapper]:
    """Size the host tier from ``swap_space_gb`` exactly as the JAX package
    does (whole pages of ``kv_cache_bytes_per_page``) and build the
    swapper; None (with a loud log) when the budget fits less than one
    page."""
    if not cache.kv_swap_enabled:
        return None
    bpp = kv_cache_bytes_per_page(model, cache)
    num_host = int(cache.swap_space_gb * (1 << 30)) // bpp
    if num_host < 1:
        logger.warning(
            "kv swap disabled: swap_space_gb=%.3f fits no page (%d B/page)",
            cache.swap_space_gb, bpp)
        return None
    L, _, ps, kd = kv.k.shape
    pool = HostKVPool(num_host, L, ps, kd, kv.k.dtype,
                      pin=kv.k.device.type == "cuda")
    logger.info("host KV tier: %d pages x %d tokens (%.2f GB swap space%s)",
                num_host, ps, cache.swap_space_gb,
                f"; pinned in {pool.pin_s:.2f} s" if pool.pin_s else "")
    return KVSwapper(pool, get_kv, programs, obs=obs)


class PrefixCache:
    """Automatic prefix caching: full prompt pages are content-addressed by a
    CHAINED digest (page i's key commits to all tokens 0..(i+1)*ps), so a new
    request whose prompt shares a page-aligned prefix with any previously
    served one reuses those KV pages instead of recomputing them — a cache
    hit turns admission into a chunked prefill whose "history" is the shared
    pages, so no new kernel is needed.

    Ownership: the cache holds ONE refcount on every cached page (pages are
    append-only, so content can never change while a reference exists).
    Sequences that reuse a page fork it (+1). Eviction is LRU and drops only
    the cache's own reference; pages still used by live sequences survive
    until their refcount drains. Digests are blake2b-chained — no
    Python-hash collisions serving wrong context.

    Host spill tier (``swapper`` attached by the engine when the two-tier
    cache is on): eviction SPILLS the victim page to host memory before
    dropping it, and ``lookup`` gets a second-chance host hit — the page
    scatters back into a fresh device page and the chain walk continues, so
    a prefix squeezed out by page pressure costs a copy, not a re-prefill.
    Host entries are a flat LRU keyed by digest: an entry whose parent left
    the host tier becomes unreachable, drifts to the LRU head untouched, and
    is reclaimed under the next pressure.

    Fleet tier (``fleet_spill``, armed by ``LLMEngine.enable_fleet_spill``):
    when the HOST rung cannot take an evicted page (swap off, host pool
    full, chaos), the page is offered to a PEER replica's host tier before
    being dropped. The hook gathers the page itself (the copy completes
    inside the call, before the free) and must never raise; a
    peer-received page enters through :meth:`accept_host_entry`, keyed by
    the same chained digest, so the peer's own ``lookup`` second-chances it
    like any local spill.
    """

    def __init__(self, allocator: "PageAllocator"):
        self.allocator = allocator
        self._entries: "OrderedDict[bytes, int]" = OrderedDict()  # digest->page
        # digest -> child digests: a chained child is only reachable through
        # its parent, so eviction must take descendants along or they would
        # sit unreachable while pinning page references.
        self._children: dict[bytes, set] = {}
        self.hits = 0
        self.misses = 0
        # Host spill tier: digest -> host page id, ordered for LRU reclaim
        # when the swapper asks for room back.
        self.swapper: Optional[KVSwapper] = None
        self._host_entries: "OrderedDict[bytes, int]" = OrderedDict()
        self.host_hits = 0
        # Fleet remote-spill rung: callable(digest, page) -> bool. Called
        # ONLY when the local host rung could not take the page.
        self.fleet_spill = None

    def attach_swapper(self, swapper: KVSwapper) -> None:
        self.swapper = swapper
        swapper.reclaim = self._reclaim_host

    def _reclaim_host(self, n_pages: int) -> int:
        """Drop LRU spilled entries so a session swap-out can land: spilled
        prefixes are re-computable, a preempted session's KV is not."""
        dropped = 0
        while dropped < n_pages and self._host_entries:
            _, hp = self._host_entries.popitem(last=False)
            self.swapper.free_host([hp])
            dropped += 1
        return dropped

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def _page_digests(token_ids: list[int], n_pages: int, ps: int):
        """Chained blake2b digest per full page, yielded lazily (a lookup
        that misses on page 0 must not hash a hundred-page prompt)."""
        raw = np.asarray(token_ids[:n_pages * ps], np.int32).tobytes()
        digest = b""
        for i in range(n_pages):
            h = hashlib.blake2b(digest, digest_size=16)
            h.update(raw[i * ps * 4:(i + 1) * ps * 4])
            digest = h.digest()
            yield digest

    def lookup(self, token_ids: list[int],
               max_tokens: Optional[int] = None,
               record_stats: bool = True) -> tuple[list[int], int]:
        """Longest page-aligned cached prefix of ``token_ids`` (capped at
        ``max_tokens``), either tier. Returns (forked page ids, matched
        token count) — caller owns one reference per returned page.
        ``record_stats=False`` leaves the hit/miss counters alone."""
        ps = self.allocator.page_size
        n = len(token_ids) // ps
        if max_tokens is not None:
            n = min(n, max_tokens // ps)
        pages: list[int] = []
        matched = 0
        parent = b""
        for digest in self._page_digests(token_ids, n, ps):
            page = self._entries.get(digest)
            if page is None:
                page = self._second_chance(digest, parent)
            if page is None:
                break
            self._entries.move_to_end(digest)       # LRU touch
            # Fork as we go (the caller's reference): a later host restore's
            # allocate() may evict OTHER device entries under pressure, and
            # already-matched pages must survive that on our refcount.
            self.allocator.fork(page)
            pages.append(page)
            matched += ps
            parent = digest
        if record_stats:
            if matched:
                self.hits += 1
            else:
                self.misses += 1
        return pages, matched

    def export_walk(self, token_ids: list[int], max_tokens: int
                    ) -> tuple[list, int]:
        """Chain walk for a PEER's fetch: returns (entries, matched) where
        each entry is ``("dev", page)`` — forked, the caller owns one
        reference and must free it after its gather — or ``("host", hp)``,
        to be READ IN PLACE from the host pool. Never restores a spill,
        touches LRU order or bumps a counter: serving a peer must not
        perturb the owner's cache or its locality telemetry."""
        ps = self.allocator.page_size
        n = min(len(token_ids) // ps, max_tokens // ps)
        entries: list = []
        matched = 0
        for digest in self._page_digests(token_ids, n, ps):
            page = self._entries.get(digest)
            if page is not None:
                self.allocator.fork(page)
                entries.append(("dev", page))
            else:
                hp = self._host_entries.get(digest)
                if hp is None:
                    break
                entries.append(("host", hp))
            matched += ps
        return entries, matched

    def peek(self, token_ids: list[int],
             max_tokens: Optional[int] = None) -> int:
        """Token count of the longest cached prefix of ``token_ids`` —
        live entries AND host spills — WITHOUT forking pages, restoring
        spills, touching LRU order, or recording stats."""
        ps = self.allocator.page_size
        n = len(token_ids) // ps
        if max_tokens is not None:
            n = min(n, max_tokens // ps)
        matched = 0
        for digest in self._page_digests(token_ids, n, ps):
            if digest not in self._entries and \
                    digest not in self._host_entries:
                break
            matched += ps
        return matched

    def _second_chance(self, digest: bytes, parent: bytes) -> Optional[int]:
        """Host-tier hit: restore the spilled page into a fresh device page
        and re-enter it as a live cache entry (the allocate() below IS the
        cache's reference, like register's fork). None on host miss or when
        no device page can be found even after eviction."""
        if self.swapper is None:
            return None
        hp = self._host_entries.pop(digest, None)
        if hp is None:
            return None
        if not self.allocator.can_allocate(1):
            self.swapper.free_host([hp])
            return None
        [page] = self.allocator.allocate(1)
        self.swapper.restore_page(hp, page)
        self._entries[digest] = page
        if parent:
            self._children.setdefault(parent, set()).add(digest)
        self.host_hits += 1
        return page

    def register(self, token_ids: list[int], pages: list[int],
                 start_page: int = 0) -> None:
        """Register the full pages backing ``token_ids`` (a completed prompt
        prefill). First registration of a digest wins; already-cached pages
        are left alone (dedupe). ``start_page``: the pages cover the chain
        FROM that page index (a fleet delta import ships only the tail);
        the digest chain still walks from token 0."""
        ps = self.allocator.page_size
        n = min(start_page + len(pages), len(token_ids) // ps)
        parent = b""
        for i, digest in enumerate(self._page_digests(token_ids, n, ps)):
            if i >= start_page and digest not in self._entries:
                page = pages[i - start_page]
                self.allocator.fork(page)           # the cache's reference
                self._entries[digest] = page
                if parent:
                    self._children.setdefault(parent, set()).add(digest)
            parent = digest

    def evict(self, n_pages: int) -> int:
        """Drop LRU entries (each with its now-unreachable descendants)
        until ``n_pages`` entries were dropped or the cache is empty.
        Freeing only releases the cache's reference — shared pages stay
        alive for their sequences."""
        dropped = 0
        while dropped < n_pages and self._entries:
            digest, _ = next(iter(self._entries.items()))  # LRU head
            dropped += self._drop_subtree(digest)
        return dropped

    def _drop_subtree(self, digest: bytes) -> int:
        dropped = 0
        stack = [digest]
        while stack:
            d = stack.pop()
            page = self._entries.pop(d, None)
            if page is None:
                continue
            spilled = d in self._host_entries
            if self.swapper is not None and not spilled:
                # Spill BEFORE the free: the gather reads the page while
                # the cache's reference still pins it. Best-effort — a full
                # host pool just drops the page.
                hp = self.swapper.spill_page(page)
                if hp is not None:
                    self._host_entries[d] = hp
                    spilled = True
            if not spilled and self.fleet_spill is not None:
                # Remote-spill rung: the hook gathers the content itself
                # (the copy completes inside the call, before the free
                # below) and never raises.
                self.fleet_spill(d, page)
            self.allocator.free([page])
            dropped += 1
            stack.extend(self._children.pop(d, ()))
        return dropped

    def accept_host_entry(self, digest: bytes, k, v) -> bool:
        """Receive a PEER's remote-spilled page ``[L, 1, ps, kd]`` into the
        local host tier, keyed by its chained digest: a later ``lookup``
        whose chain reaches the digest second-chances it like a local
        spill. False (and no state change) when the host tier is off, full,
        or already holds the digest — remote spill never evicts local
        entries."""
        if self.swapper is None:
            return False
        if digest in self._host_entries or digest in self._entries:
            return False
        host = self.swapper.host
        if not host.can_allocate(1):
            return False
        [hp] = host.allocate(1)
        host.put([hp], host_tensor(k), host_tensor(v))
        self._host_entries[digest] = hp
        return True


class CachingPageAllocator(PageAllocator):
    """PageAllocator that transparently evicts prefix-cache entries under
    pressure, so every existing can_allocate/allocate call site (scheduler
    admission, decode window growth, chunk growth) gets eviction for free."""

    def __init__(self, num_pages: int, page_size: int):
        super().__init__(num_pages, page_size)
        self.prefix_cache = PrefixCache(self)

    def can_allocate(self, n: int) -> bool:
        # Evicting an entry only frees its page when no live sequence shares
        # it, so keep evicting until satisfied or the cache runs dry.
        while len(self._free) < n and len(self.prefix_cache):
            if self.prefix_cache.evict(n - len(self._free)) == 0:
                break
        return len(self._free) >= n
