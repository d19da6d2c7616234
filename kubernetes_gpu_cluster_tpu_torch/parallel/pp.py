"""Pipeline parallelism: each stage a process holding ``L / S`` layers.

The reference served ``pipelineParallelSize: 2`` over Ray
(``values-01-minimal-example4.yaml:16-23``). The JAX package runs one SPMD
program: a circular ``scan`` over ``M + S - 1`` ticks whose hidden states
rotate with ``ppermute``, inactive ticks writing into the scrap page. Here
each stage is its own process, so the schedule is GPipe's: for each
microbatch stage 0 embeds, every later stage receives the hidden state
from the one before, runs its own layers (each stage's kernels on its own
layer slab of the pool, ``parallel/sharding.py`` slices the weights and
``local_kv_config`` the pool), and sends it on. No tick is inactive, so no
scrap-page write is needed. The last stage broadcasts its ``[M * N, d]``
hidden over the pp group (the JAX ``psum`` over ``pp``), and every rank
then takes the final norm, the logits and the sample with the same
generators, so stages step in lockstep as tp ranks do. tp and ep apply
inside a stage: its collectives run over the stage's own tp / ep groups.

Microbatches, as the JAX engine: prefill rides as ONE microbatch (a
sequence must not straddle microbatches); decode splits the batch into
``S`` microbatches when ``S`` divides it, else one; chunked prefill splits
the chunk into ``S`` sub-chunks (when ``S`` divides it), sub-chunk ``j``
attending to the pool with ``hist_len + j * sub`` tokens of history: a
stage commits sub-chunk ``j - 1``'s K/V to its slab before it runs
sub-chunk ``j``, so that history is in place.
"""

from __future__ import annotations

import torch

from ..config import ModelConfig
from ..models import llama as model_lib


def validate_pp_mesh(cfg: ModelConfig, pp: int, tp: int = 1,
                     ep: int = 1) -> None:
    """The JAX package's ``validate_pp_mesh``: raise ValueError for a
    model the pipeline cannot split."""
    if cfg.num_layers % pp != 0:
        raise ValueError(f"num_layers={cfg.num_layers} not divisible by "
                         f"pp={pp}")
    if cfg.num_heads % tp != 0:
        raise ValueError(f"num_heads={cfg.num_heads} not divisible by "
                         f"tp={tp}")
    if cfg.num_kv_heads % tp != 0:
        raise ValueError(
            f"manual TP inside the pipeline requires num_kv_heads "
            f"({cfg.num_kv_heads}) divisible by tp={tp}")
    if cfg.is_moe and cfg.num_experts % ep != 0:
        raise ValueError(f"num_experts={cfg.num_experts} not divisible by "
                         f"ep={ep}")


def stage_layers(cfg: ModelConfig, groups) -> range:
    """The layers of this rank's stage: ``[s * L / S, (s + 1) * L / S)``."""
    n = cfg.num_layers // groups.pp
    return range(groups.pp_rank * n, (groups.pp_rank + 1) * n)


def num_microbatches(kind: str, n: int, stages: int) -> int:
    """M of the JAX engine: 1 for a prefill; ``stages`` for a decode batch
    or a history chunk of ``n`` rows when ``stages`` divides it, else 1."""
    if kind == "prefill" or n % stages:
        return 1
    return stages


def _microbatch(kind: str, tokens, meta, j: int, n: int, page_table,
                hist_len):
    """(tokens, meta, forward's extra args) of microbatch ``j`` of
    ``n`` rows."""
    rows = slice(j * n, (j + 1) * n)
    if kind == "prefill":
        return tokens, meta, ()
    if kind == "decode":
        return tokens[rows], model_lib.DecodeMeta(
            positions=meta.positions[rows],
            slot_mapping=meta.slot_mapping[rows],
            page_tables=meta.page_tables[rows],
            context_lens=meta.context_lens[rows]), ()
    sub = model_lib.PrefillMeta(
        seg_ids=meta.seg_ids[rows], positions=meta.positions[rows],
        slot_mapping=meta.slot_mapping[rows],
        logits_indices=torch.zeros_like(meta.logits_indices[:1]))
    return tokens[rows], sub, (page_table, hist_len + j * n)


_FORWARDS = {"prefill": model_lib.forward_prefill,
             "decode": model_lib.forward_decode,
             "prefill_hist": model_lib.forward_prefill_hist}


def run_pipeline(kind: str, params, cfg: ModelConfig, microbatches: list,
                 kv, groups) -> torch.Tensor:
    """The GPipe schedule over ``microbatches``, a list of (tokens, meta,
    forward's extra args) of ``n`` rows each: this stage runs its layers
    on each in turn, taking its input from the previous stage (stage 0
    embeds) and passing its output on. Returns the last stage's raw hidden
    ``[M, n, d]``, broadcast to every stage (the counterpart of the JAX
    package's ``build_pp_forward``)."""
    fwd = _FORWARDS[kind]
    n = microbatches[0][0].shape[0]
    device = microbatches[0][0].device
    d = params["final_norm"].shape[-1]
    dtype = params["embed"].dtype
    outs = []
    for tok, mb, extra in microbatches:
        h_in = (None if groups.is_first_stage else
                groups.recv_prev_stage((n, d), dtype, device))
        _, _, h = fwd(params, cfg, tok, mb, kv, *extra, groups=groups,
                      hidden_in=h_in)
        if groups.is_last_stage:
            outs.append(h)
        else:
            groups.send_next_stage(h)
    hidden = (torch.stack(outs) if groups.is_last_stage else
              torch.empty((len(microbatches), n, d), dtype=dtype,
                          device=device))
    return groups.broadcast_from_last_stage(hidden)


def pp_logits(params, cfg: ModelConfig, hidden: torch.Tensor,
              logits_indices=None, groups=None) -> torch.Tensor:
    """The JAX package's ``pp_logits``: final norm and logits of one
    microbatch's raw hidden ``[N, d]`` (the rows ``logits_indices`` picks
    when given)."""
    if logits_indices is not None:
        hidden = hidden[logits_indices.to(torch.int64)]
    return model_lib.compute_logits(
        params, cfg, model_lib._norm(cfg, hidden, params, "final_norm"),
        groups=groups)


def pipeline_forward(kind: str, params, cfg: ModelConfig, tokens, meta, kv,
                     groups, page_table=None, hist_len=None):
    """One ``kind`` step ("prefill", "decode" or "prefill_hist") through
    the pipeline: the contract of ``models.llama.forward_<kind>`` on
    every rank of every stage. ``params`` and ``kv`` are this stage's
    (``L / S`` layers); ``tokens`` and ``meta`` the whole step's;
    ``page_table`` and ``hist_len`` (an int32 [1] tensor) those of a
    history chunk. Returns
    (normed rows that feed sampling, kv, the last stage's raw hidden
    ``[N, d]``), the same on every rank."""
    N = tokens.shape[0]
    M = num_microbatches(kind, N, groups.pp)
    mbs = [_microbatch(kind, tokens, meta, j, N // M, page_table, hist_len)
           for j in range(M)]
    hidden = run_pipeline(kind, params, cfg, mbs, kv, groups).reshape(N, -1)
    selected = hidden if kind == "decode" else \
        hidden[meta.logits_indices.to(torch.int64)]
    return model_lib._norm(cfg, selected, params, "final_norm"), kv, hidden
