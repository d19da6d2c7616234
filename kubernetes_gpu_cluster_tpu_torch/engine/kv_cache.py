"""Paged KV cache: device-side page pool + host-side page allocator.

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

Not yet ported: the host-DRAM second tier (``HostKVPool``/``KVSwapper``)
and the cross-replica page IO (``KVPageIO``).
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import ModelConfig, CacheConfig
from ..utils import cdiv, get_logger

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


def derive_num_pages(
    model: ModelConfig,
    cache: CacheConfig,
    max_model_len: int,
    max_num_seqs: int,
    free_bytes: Optional[int] = None,
) -> int:
    """Size the page pool. If ``cache.num_pages`` is set, use it; else use
    ``hbm_utilization`` of the device's free memory (the reference's
    gpuMemoryUtilization semantics; the engine reads it from
    ``torch.cuda.mem_get_info``); else fall back to enough pages for
    max_num_seqs full-length sequences (CPU/test path)."""
    if cache.num_pages is not None:
        return cache.num_pages
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

    Not ported yet: the JAX package's host spill tier and fleet remote-spill
    rung (they come with swap, ROADMAP R4, and the fleet plane, R8).
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
        ``max_tokens``). Returns (forked page ids, matched token count) —
        caller owns one reference per returned page."""
        ps = self.allocator.page_size
        n = len(token_ids) // ps
        if max_tokens is not None:
            n = min(n, max_tokens // ps)
        pages: list[int] = []
        matched = 0
        for digest in self._page_digests(token_ids, n, ps):
            page = self._entries.get(digest)
            if page is None:
                break
            self._entries.move_to_end(digest)       # LRU touch
            self.allocator.fork(page)               # the caller's reference
            pages.append(page)
            matched += ps
        if record_stats:
            if matched:
                self.hits += 1
            else:
                self.misses += 1
        return pages, matched

    def peek(self, token_ids: list[int],
             max_tokens: Optional[int] = None) -> int:
        """Token count of the longest cached prefix of ``token_ids`` WITHOUT
        forking pages, touching LRU order, or recording stats."""
        ps = self.allocator.page_size
        n = len(token_ids) // ps
        if max_tokens is not None:
            n = min(n, max_tokens // ps)
        matched = 0
        for digest in self._page_digests(token_ids, n, ps):
            if digest not in self._entries:
                break
            matched += ps
        return matched

    def register(self, token_ids: list[int], pages: list[int],
                 start_page: int = 0) -> None:
        """Register the full pages backing ``token_ids`` (a completed prompt
        prefill). First registration of a digest wins; already-cached pages
        are left alone (dedupe). ``start_page``: the pages cover the chain
        FROM that page index; the digest chain still walks from token 0."""
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
            self.allocator.free([page])
            dropped += 1
            stack.extend(self._children.pop(d, ()))
        return dropped


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
