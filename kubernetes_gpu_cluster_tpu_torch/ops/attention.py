"""Attention over the paged KV cache: plain PyTorch versions + dispatch.

Two attention shapes exist in the serving hot loop:

- **ragged prefill**: all prompt tokens of the scheduled prefill batch are
  flattened to one ``[T, ...]`` token axis with segment ids; attention is
  causal within each segment.
- **paged decode**: one query token per sequence; K/V live in the paged pool
  and are addressed through per-sequence page tables.

plus chunked prefill, where one sequence's chunk attends to its committed
pool history and causally to itself, and speculative verification, where
each running sequence's ``[last token, k drafts]`` slice attends to its
pool history and causally to itself.

The ``*_plain`` functions compute each in plain PyTorch (dense masked fp32,
the JAX package's XLA oracles term for term): the CPU path and the yardstick
the CUDA kernels are held against. The dispatchers choose by device: a CPU
tensor takes the plain version, a CUDA tensor takes the hand-written kernel
in ``ops/cuda/`` or raises — there is no fallback between the two. Verify
attention has no Pallas kernel in the JAX package (its dispatcher sends
every backend to the XLA version); the port runs its own kernel for it
on the card (``ops/cuda/spec_verify.py``), since a captured verify step
takes the whole page table.
"""

from __future__ import annotations

from typing import Optional

import torch

from .cuda.flash_prefill import flash_prefill
from .cuda.flash_prefill import kb_min as flash_prefill_kb_min
from .cuda.flash_prefill_hist import flash_prefill_hist, valid_tokens
from .cuda.paged_decode import paged_decode
from .cuda.spec_verify import spec_verify


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def _pool_layer(pool: torch.Tensor, layer: Optional[int]) -> torch.Tensor:
    if pool.dim() == 4:
        if layer is None:
            raise ValueError("layer index required for a stacked pool")
        return pool[layer]
    return pool


def _masked_softmax(scores: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis; fully-masked (all -inf) rows give 0."""
    p = torch.softmax(scores, dim=-1)
    return torch.where(torch.isnan(p), torch.zeros_like(p), p)


# ---------------------------------------------------------------------------
# KV page writes
# ---------------------------------------------------------------------------

def write_kv_pages_all(kv_k: torch.Tensor, kv_v: torch.Tensor,
                       k_all: torch.Tensor, v_all: torch.Tensor,
                       slot_mapping: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter every layer's new K/V vectors into the page pool at once,
    IN PLACE (one ``index_copy_`` per pool on its flattened slot axis).

    kv_k/kv_v:    [L, P, page_size, n_kv*hd] (the whole pool, heads flattened)
    k_all/v_all:  [L, T, n_kv, hd] or [L, T, n_kv*hd] (every layer's new
                  entries)
    slot_mapping: [T] flat slot = page_id * page_size + offset. Padding
                  tokens carry slots inside the scrap page 0.

    Runs after the layer loop: attention reads the pool before this write
    and takes the current step's K/V directly. Returns the pool tensors."""
    L, P, ps, kd = kv_k.shape
    T = k_all.shape[1]
    idx = slot_mapping.to(device=kv_k.device, dtype=torch.int64)
    kv_k.view(L, P * ps, kd).index_copy_(
        1, idx, k_all.reshape(L, T, kd).to(kv_k.dtype))
    kv_v.view(L, P * ps, kd).index_copy_(
        1, idx, v_all.reshape(L, T, kd).to(kv_v.dtype))
    return kv_k, kv_v


# ---------------------------------------------------------------------------
# Plain versions (the JAX package's XLA oracles, in PyTorch)
# ---------------------------------------------------------------------------

def ragged_prefill_attention_plain(
    q: torch.Tensor,          # [T, n_heads, hd] (post-RoPE)
    k: torch.Tensor,          # [T, n_kv, hd]
    v: torch.Tensor,          # [T, n_kv, hd]
    seg_ids: torch.Tensor,    # [T] segment id per token; padding = -1
    positions: torch.Tensor,  # [T] position within segment
    scale: float,
    window: Optional[torch.Tensor] = None,  # the kernel's; unused here
) -> torch.Tensor:
    """Dense masked attention, causal within each segment; O(T^2) memory
    in the score matrix. Padding rows emit zeros."""
    del window
    T, n_heads, hd = q.shape
    n_kv = k.shape[1]
    g = n_heads // n_kv
    qg = (q.float() * scale).reshape(T, n_kv, g, hd)
    scores = torch.einsum("tkgh,skh->kgts", qg, k.float())    # [n_kv,g,T,T]
    same = (seg_ids[:, None] == seg_ids[None, :]) & (seg_ids[:, None] >= 0)
    causal = positions[:, None] >= positions[None, :]
    scores = scores.masked_fill(~(same & causal), float("-inf"))
    probs = _masked_softmax(scores)
    out = torch.einsum("kgts,skh->tkgh", probs, v.float())     # [T,n_kv,g,hd]
    return out.reshape(T, n_heads, hd).to(q.dtype)


def prefill_history_attention_plain(
    q: torch.Tensor,          # [T, n_heads, hd] — ONE sequence's chunk
    k: torch.Tensor,          # [T, n_kv, hd] (this chunk's keys)
    v: torch.Tensor,          # [T, n_kv, hd]
    seg_ids: torch.Tensor,    # [T]: 0 for chunk tokens, -1 padding
    positions: torch.Tensor,  # [T] GLOBAL positions (offset by history)
    k_pool: torch.Tensor,     # [P, ps, n_kv*hd] or [L, P, ps, n_kv*hd]
    v_pool: torch.Tensor,
    page_table: torch.Tensor, # [pages_per_seq] (this sequence's pages)
    hist_len,                 # int, or an int32 [1] / 0-d tensor: tokens
                              # already committed
    scale: float,
    layer: Optional[int] = None,
) -> torch.Tensor:
    """Chunked-prefill attention: causal within the chunk PLUS full
    attention to the sequence's committed history in the paged pool."""
    k_pool = _pool_layer(k_pool, layer)
    v_pool = _pool_layer(v_pool, layer)
    T, n_heads, hd = q.shape
    n_kv = k.shape[1]
    ps = k_pool.shape[1]
    H = page_table.shape[0] * ps
    g = n_heads // n_kv
    idx = page_table.to(torch.int64)
    k_hist = k_pool[idx].reshape(H, n_kv, hd).float()
    v_hist = v_pool[idx].reshape(H, n_kv, hd).float()

    qg = (q.float() * scale).reshape(T, n_kv, g, hd)
    s_h = torch.einsum("tkgh,skh->kgts", qg, k_hist)         # [n_kv,g,T,H]
    valid_h = ((torch.arange(H, device=q.device)[None, :] < hist_len)
               & (seg_ids[:, None] >= 0))
    s_h = s_h.masked_fill(~valid_h, float("-inf"))
    s_b = torch.einsum("tkgh,skh->kgts", qg, k.float())      # [n_kv,g,T,T]
    same = (seg_ids[:, None] == seg_ids[None, :]) & (seg_ids[:, None] >= 0)
    causal = positions[:, None] >= positions[None, :]
    s_b = s_b.masked_fill(~(same & causal), float("-inf"))
    p = _masked_softmax(torch.cat([s_h, s_b], dim=-1))       # [n_kv,g,T,H+T]
    out = (torch.einsum("kgts,skh->tkgh", p[..., :H], v_hist)
           + torch.einsum("kgts,skh->tkgh", p[..., H:], v.float()))
    return out.reshape(T, n_heads, hd).to(q.dtype)


def paged_decode_attention_plain(
    q: torch.Tensor,             # [B, n_heads, hd] (post-RoPE)
    k_cache_l: torch.Tensor,     # [P, ps, n_kv*hd] or [L, P, ps, n_kv*hd]
    v_cache_l: torch.Tensor,
    page_tables: torch.Tensor,   # [B, pages_per_seq] page ids (pad = scrap)
    context_lens: torch.Tensor,  # [B] valid tokens (incl. current)
    k_cur: torch.Tensor,         # [B, n_kv, hd] current token's K (not in pool)
    v_cur: torch.Tensor,         # [B, n_kv, hd]
    scale: float,
    layer: Optional[int] = None,
) -> torch.Tensor:
    """Gather-then-attend. The pool holds positions 0..context_len-2; the
    current token's K/V arrive separately because pool writes are deferred
    to one post-forward scatter (write_kv_pages_all)."""
    k_cache_l = _pool_layer(k_cache_l, layer)
    v_cache_l = _pool_layer(v_cache_l, layer)
    B, n_heads, hd = q.shape
    ps = k_cache_l.shape[1]
    n_kv = k_cur.shape[1]
    L = page_tables.shape[1] * ps
    g = n_heads // n_kv
    idx = page_tables.to(torch.int64)
    k_seq = k_cache_l[idx].reshape(B, L, n_kv, hd).float()
    v_seq = v_cache_l[idx].reshape(B, L, n_kv, hd).float()

    qg = (q.float() * scale).reshape(B, n_kv, g, hd)
    scores = torch.einsum("bkgh,blkh->bkgl", qg, k_seq)       # [B,n_kv,g,L]
    valid = (torch.arange(L, device=q.device)[None, :]
             < (context_lens - 1)[:, None])
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    cur = torch.einsum("bkgh,bkh->bkg", qg, k_cur.float())
    probs = torch.softmax(torch.cat([scores, cur[..., None]], dim=-1), dim=-1)
    out = (torch.einsum("bkgl,blkh->bkgh", probs[..., :L], v_seq)
           + probs[..., L:] * v_cur.float()[:, :, None, :])
    return out.reshape(B, n_heads, hd).to(q.dtype)


def spec_verify_attention_plain(
    q: torch.Tensor,             # [B*S, n_heads, hd] (post-RoPE), row-major
    k: torch.Tensor,             # [B*S, n_kv, hd] this step's keys (drafts too)
    v: torch.Tensor,             # [B*S, n_kv, hd]
    k_pool: torch.Tensor,        # [P, ps, n_kv*hd] or [L, P, ps, n_kv*hd]
    v_pool: torch.Tensor,
    page_tables: torch.Tensor,   # [B, pages] page ids (pad = scrap)
    context_lens: torch.Tensor,  # [B] committed tokens incl. the slice's first
    scale: float,
    layer: Optional[int] = None,
) -> torch.Tensor:
    """Batched draft verification: B rows of S = k+1 tokens (``[last
    committed token, k drafts]``), each token attending to its row's pool
    history (positions ``0..context_len-2``, the same mask for all S
    queries) and causally to the earlier tokens of its own slice. The
    slice's own K/V arrive in-batch; the caller commits them in the one
    post-forward scatter. fp32 throughout. A padding row (context 0) sees
    only its own slice, as in the JAX package; the host never reads it."""
    k_pool = _pool_layer(k_pool, layer)
    v_pool = _pool_layer(v_pool, layer)
    B = page_tables.shape[0]
    T, n_heads, hd = q.shape
    S = T // B
    n_kv = k.shape[1]
    ps = k_pool.shape[1]
    L = page_tables.shape[1] * ps
    g = n_heads // n_kv
    idx = page_tables.to(torch.int64)
    k_seq = k_pool[idx].reshape(B, L, n_kv, hd).float()
    v_seq = v_pool[idx].reshape(B, L, n_kv, hd).float()

    qg = (q.float() * scale).reshape(B, S, n_kv, g, hd)
    kf = k.float().reshape(B, S, n_kv, hd)
    vf = v.float().reshape(B, S, n_kv, hd)
    s_h = torch.einsum("bskgh,blkh->bkgsl", qg, k_seq)      # [B,n_kv,g,S,L]
    valid_h = (torch.arange(L, device=q.device)[None, :]
               < (context_lens - 1)[:, None])                # [B, L]
    s_h = s_h.masked_fill(~valid_h[:, None, None, None, :], float("-inf"))
    s_b = torch.einsum("bskgh,btkh->bkgst", qg, kf)         # [B,n_kv,g,S,S]
    causal = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                   device=q.device))
    s_b = s_b.masked_fill(~causal, float("-inf"))
    p = _masked_softmax(torch.cat([s_h, s_b], dim=-1))      # [B,n_kv,g,S,L+S]
    out = (torch.einsum("bkgsl,blkh->bskgh", p[..., :L], v_seq)
           + torch.einsum("bkgst,btkh->bskgh", p[..., L:], vf))
    return out.reshape(T, n_heads, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Dispatchers: the plain version on the CPU, the CUDA kernel on the card
# ---------------------------------------------------------------------------

def ragged_prefill_attention(q, k, v, seg_ids, positions, scale,
                             window=None):
    """``window``: the kernel's K-window starts (``prefill_window``), when
    the caller computed them once for all layers; the plain path needs
    none."""
    if _on_cpu(q):
        return ragged_prefill_attention_plain(q, k, v, seg_ids, positions,
                                              scale)
    return flash_prefill(q, k, v, seg_ids, positions, scale, window)


def prefill_window(seg_ids: torch.Tensor) -> torch.Tensor:
    """The flash prefill kernel's first K tile per q tile for ``seg_ids``
    (``ops.cuda.flash_prefill.kb_min``): plain torch, computed once per
    forward and shared by every layer."""
    return flash_prefill_kb_min(seg_ids)


def prefill_history_valid(seg_ids: torch.Tensor) -> torch.Tensor:
    """The history kernel's chunk length ``sum(seg_ids >= 0)`` as an int32
    [1] tensor on seg_ids' device (``ops.cuda.flash_prefill_hist.
    valid_tokens``): plain torch, computed once per forward and shared by
    every layer."""
    return valid_tokens(seg_ids)


def prefill_history_attention(q, k, v, seg_ids, positions, k_pool, v_pool,
                              page_table, hist_len, scale, *, layer=None,
                              n_valid=None):
    """``hist_len``: an int32 [1] tensor on q's device (the kernel reads it
    there; the plain path also takes an int). ``n_valid``: the kernel's
    chunk length (``prefill_history_valid``), when the caller computed it
    once for all layers; the plain path needs none."""
    if _on_cpu(q):
        return prefill_history_attention_plain(
            q, k, v, seg_ids, positions, k_pool, v_pool, page_table,
            hist_len, scale, layer=layer)
    return flash_prefill_hist(q, k, v, seg_ids, positions, k_pool, v_pool,
                              page_table, hist_len, scale, layer=layer,
                              n_valid=n_valid)


def paged_decode_attention(q, k_cache_l, v_cache_l, page_tables, context_lens,
                           k_cur, v_cur, scale, *, layer=None):
    if _on_cpu(q):
        return paged_decode_attention_plain(
            q, k_cache_l, v_cache_l, page_tables, context_lens, k_cur, v_cur,
            scale, layer=layer)
    return paged_decode(q, k_cache_l, v_cache_l, page_tables, context_lens,
                        k_cur, v_cur, scale, layer=layer)


# Most fp32 history bytes (K and V) one spec_verify_attention_plain call
# gathers on the CPU; a larger batch is split over rows.
VERIFY_GATHER_BYTES = 1 << 30


def spec_verify_attention(q, k, v, k_pool, v_pool, page_tables, context_lens,
                          scale, *, layer=None):
    """Spec-verify dispatcher. The JAX package has no Pallas kernel for
    this function (its dispatcher sends every backend to the XLA version);
    on the card it runs the port's own kernel (``ops/cuda/spec_verify.py``)
    over the whole table, reading ``context_lens`` on the device. On the
    CPU the plain version runs in groups of rows whose gathered fp32
    history stays within ``VERIFY_GATHER_BYTES``."""
    if not _on_cpu(q):
        return spec_verify(q, k, v, k_pool, v_pool, page_tables,
                           context_lens, scale, layer=layer)
    B, pps = page_tables.shape
    S = q.shape[0] // B
    per_row = 2 * pps * k_pool.shape[-2] * k_pool.shape[-1] * 4
    rows = max(1, VERIFY_GATHER_BYTES // per_row)
    if rows >= B:
        return spec_verify_attention_plain(q, k, v, k_pool, v_pool,
                                           page_tables, context_lens, scale,
                                           layer=layer)
    return torch.cat([spec_verify_attention_plain(
        q[b * S:(b + rows) * S], k[b * S:(b + rows) * S],
        v[b * S:(b + rows) * S], k_pool, v_pool, page_tables[b:b + rows],
        context_lens[b:b + rows], scale, layer=layer)
        for b in range(0, B, rows)], dim=0)


# ---------------------------------------------------------------------------
# Mixed prefill/decode attention (stall-free batching)
# ---------------------------------------------------------------------------

def mixed_attention(q, k, v, seg_ids, positions, k_pool, v_pool,
                    chunk_page_table, hist_len, page_tables, context_lens,
                    scale, *, n_prefill: int, layer=None, n_valid=None):
    """Attention for one MIXED step: the token axis is
    ``[prefill chunk | decode rows]`` split at ``n_prefill``.

    - tokens [0:n_prefill): one sequence's prompt chunk — causal within the
      chunk plus full attention to its committed pool history
      (``prefill_history_attention``).
    - tokens [n_prefill:): one decode token per running sequence against the
      paged pool (``paged_decode_attention``).

    Both halves read the pool PRE-write and the caller commits all new K/V
    in the one post-forward scatter. Chunk and decode sequences are
    disjoint and each half addresses only its own page tables. ``n_valid``
    is ``prefill_history_valid(seg_ids[:n_prefill])`` when the caller
    computed it once for all layers."""
    out_p = prefill_history_attention(
        q[:n_prefill], k[:n_prefill], v[:n_prefill], seg_ids[:n_prefill],
        positions[:n_prefill], k_pool, v_pool, chunk_page_table[0], hist_len,
        scale, layer=layer, n_valid=n_valid)
    out_d = paged_decode_attention(
        q[n_prefill:], k_pool, v_pool, page_tables, context_lens,
        k[n_prefill:], v[n_prefill:], scale, layer=layer)
    return torch.cat([out_p, out_d], dim=0)


def spec_mixed_attention(q, k, v, seg_ids, positions, k_pool, v_pool,
                         chunk_page_table, hist_len, page_tables,
                         context_lens, scale, *, n_prefill: int, layer=None,
                         n_valid=None):
    """Attention for one SPEC×MIXED step: the token axis is
    ``[prefill chunk | verify slices]`` split at ``n_prefill``.

    - tokens [0:n_prefill): one sequence's prompt chunk, exactly the mixed
      step's chunk half (``prefill_history_attention``: the history kernel
      on the card); chunk tokens carry seg 0, padding -1.
    - tokens [n_prefill:): every running sequence's ``[last, d_1..d_k]``
      verify slice against the paged pool (``spec_verify_attention``, as in
      the pure spec step).

    Both halves read the pool PRE-write and the caller commits all new K/V
    in the one post-forward scatter. ``n_valid`` is
    ``prefill_history_valid`` of the chunk half when the caller computed it
    once for all layers."""
    # The chunk half's segment view: the flat batch carries row ids on the
    # verify slices, which the chunk's attention must not see.
    segp = torch.where(seg_ids[:n_prefill] >= 0, 0, -1).to(seg_ids.dtype)
    out_p = prefill_history_attention(
        q[:n_prefill], k[:n_prefill], v[:n_prefill], segp,
        positions[:n_prefill], k_pool, v_pool, chunk_page_table[0], hist_len,
        scale, layer=layer, n_valid=n_valid)
    out_s = spec_verify_attention(
        q[n_prefill:], k[n_prefill:], v[n_prefill:], k_pool, v_pool,
        page_tables, context_lens, scale, layer=layer)
    return torch.cat([out_p, out_s], dim=0)
