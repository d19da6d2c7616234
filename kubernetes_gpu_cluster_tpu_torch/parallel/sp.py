"""Sequence parallelism: ring attention for ragged prefill over the sp
ranks.

The JAX package's ``parallel/sp.py`` shards the token axis of a prefill
over the ``sp`` mesh axis under ``shard_map`` and rotates K/V blocks with
``ppermute``. Here every sp rank runs the step's matmuls on the whole
batch (its weights and pool are its sp peers', as the JAX package
replicates them over sp) and splits only the attention: rank ``r`` takes
query rows ``[r * T / sp, (r + 1) * T / sp)`` and its own K/V block; the
blocks rotate around the sp group with ``batch_isend_irecv``, each with its
GLOBAL segment ids and positions, and the softmax runs online in fp32 with
the JAX package's ``m / l / acc`` carries, so no rank holds a ``[T, T]``
score matrix. The output rows are all-gathered over sp. Decode and
chunked prefill are not split: every sp rank runs them through the
kernels on its whole pool.

The JAX package's block attend is an ``einsum``, not a Pallas kernel, so
this one is plain PyTorch on both devices.
"""

from __future__ import annotations

import torch

NEG = -1e30


def _block_attend(qg, k_blk, v_blk, q_seg, k_seg, q_pos, k_pos, m, l, acc,
                  scale: float):
    """One ring step: the local queries against one K/V block, folded into
    the online softmax. qg [Tl, n_kv, g, hd]; k_blk/v_blk [Tb, n_kv, hd];
    m/l [Tl, n_kv, g, 1]; acc [Tl, n_kv, g, hd]; all fp32."""
    scores = torch.einsum("tkgh,skh->tkgs", qg * scale, k_blk)
    mask = ((q_seg[:, None] == k_seg[None, :]) & (q_seg[:, None] >= 0)
            & (q_pos[:, None] >= k_pos[None, :]))[:, None, None, :]
    scores = torch.where(mask, scores, NEG)
    m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
    p = torch.where(mask, torch.exp(scores - m_new), 0.0)
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(dim=-1, keepdim=True)
    acc = acc * alpha + torch.einsum("tkgs,skh->tkgh", p, v_blk)
    return m_new, l, acc


def ring_attention_shard(q, k, v, seg_ids, positions, scale: float,
                         groups) -> torch.Tensor:
    """Ring attention on this sp rank's rows only (the JAX package's
    ``shard_map`` body): q [Tl, nh, hd], k/v [Tl, n_kv, hd] and their
    GLOBAL seg_ids / positions [Tl] are this rank's block of the token
    axis; returns its [Tl, nh, hd] output rows."""
    Tl, nh, hd = q.shape
    n_kv = k.shape[1]
    g = nh // n_kv
    qg = q.float().reshape(Tl, n_kv, g, hd)
    blk = [k.contiguous(), v.contiguous(), seg_ids.contiguous(),
           positions.contiguous()]
    m = torch.full((Tl, n_kv, g, 1), NEG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((Tl, n_kv, g, hd), dtype=torch.float32,
                      device=q.device)
    for i in range(groups.sp):
        k_blk, v_blk, k_seg, k_pos = blk
        m, l, acc = _block_attend(qg, k_blk.float(), v_blk.float(), seg_ids,
                                  k_seg, positions, k_pos, m, l, acc, scale)
        if i < groups.sp - 1:
            blk = groups.ring_shift(blk)
    # Fully masked rows (padding) have l = 0 and give 0.
    return (acc / torch.clamp(l, min=1e-20)).reshape(Tl, nh, hd).to(q.dtype)


def ring_prefill_attention(q, k, v, seg_ids, positions, scale, window=None,
                           *, groups):
    """``ops.attention.ragged_prefill_attention`` over the sp ring of
    ``groups``: q [T, nh, hd], k/v [T, n_kv, hd] (this rank's heads),
    seg_ids/positions [T], the same on every sp rank; returns [T, nh, hd].
    T must divide by sp (the engine's prefill buckets do); ``window``, the
    flash kernel's, is unused."""
    del window
    T, sp = q.shape[0], groups.sp
    if T % sp:
        raise ValueError(f"ring attention: T={T} not divisible by sp={sp}")
    rows = slice(groups.sp_rank * (T // sp), (groups.sp_rank + 1) * (T // sp))
    out = ring_attention_shard(q[rows], k[rows], v[rows], seg_ids[rows],
                               positions[rows], scale, groups)
    return groups.all_gather(out, dim=0, over="sp")
