#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``kubernetes_gpu_cluster_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. Card: name and power limit, kernel build from ``csrc/`` with nvcc.
2. Kernels against their plain PyTorch versions at llama-3-8b shapes
   (attention: nh 32, n_kv 8, hd 128, bf16, the engine's page size; int4
   matmul: the w_gate projection at a decode batch of 32): max-abs error
   within a stated tolerance, the kernel's device time (calls captured in a
   CUDA graph, which also proves the wrappers capture), its time with the
   launch (CUDA events around each call) and the host's microseconds per
   call, the plain version's time, the bound (the least time the card
   could take for the same work) and, where one PyTorch call computes the
   same function, that call's time, timed the same way. Logged beside
   them: decode at one 8191-token sequence and at B 32 over contexts
   64-256; flash prefill at one 2048-token segment and at 16 segments of
   128; the history kernel at a 2048-token chunk over 952 and a 64-token
   chunk over 6000; int4 at a 2048-row prefill, w_down and lm_head.
3. Model: the llama-3-8b forward through the kernels against the same
   forward through the plain attention versions, on one small ragged batch.
4. Engine: ``LLMEngine`` serving llama-3-8b at full width and depth (random
   bf16 weights from a seed) through prefill, mixed, chunked-prefill and
   decode-window steps; every attention kernel's launch count over that run
   must be > 0, and a second run of the same requests must give the same
   tokens.
5. Async front door: concurrent ``AsyncLLMEngine.generate`` streams.

Then the bf16 weights are freed and the int4 / int8 paths run:

3b. Model, int4: the llama-3-8b int4 forward through the int4 kernel
    against the same forward through ``int4_matmul_plain``.
4b. Engine, int4: ``LLMEngine`` serving llama-3-8b int4 (random packed
    weights from the seed) through every step kind; all four kernels
    launched in that run; a second run gives the same tokens.
4c. Engine, int8: four requests served twice with the same tokens.

Then the other model families, each from random weights at its preset's
full width and depth, freed before the next (``FAMILIES``): qwen2.5-7b
bf16 (q/k/v bias, a GQA group of 7), qwen3-4b bf16 (qk-norm, tied
embeddings, q width 4096 != d 2560), opt-125m bf16 (LayerNorm, learned
positions, a biased ReLU MLP, tied embeddings, MHA at hd 64) and
mixtral-8x7b int4 (dense-dispatch MoE: every expert's three matmuls through
the int4 kernel). For each:

6.  The three attention kernels at the family's heads and phase 2's
    shapes, against their plain versions (logged, not recorded).
6a. Model: the forward through the kernels against the same forward with
    the plain attention versions (bf16) or ``int4_matmul_plain`` (int4,
    attention on the kernels in both runs, so the routing stays the same;
    the (token, layer) pairs whose top-k experts differ are counted).
6b. Engine: ``LLMEngine`` through every step kind, twice, the same tokens;
    the attention kernels (and the int4 kernel) launched in the first run.

Then speculative decoding:

7a. llama-3-8b bf16 (the phase-4 weights, before they are freed): the
    phase-4 engine with n-gram speculation (k 4, mixed batching on) on
    phase 4's workload shape, where half the prompts repeat a random 8-32
    token pattern and one more request samples with a seed; served twice
    (the same tokens; spec and spec×mixed steps ran, drafts were made, the
    three attention kernels launched), and once by the spec-off engine.
    Logged: tokens/s on and off, the acceptance ratio, the share of greedy
    requests whose tokens equal spec off (bf16: verify attention is fp32
    PyTorch, decode the bf16 kernel, so near-ties may flip), and the
    verify attention's ms per call at the engine's shape beside
    ``paged_decode``'s.
7b. tinyllama-1.1b fp32 at full width and depth, drafting for itself (the
    draft model's own pool, the target's weights: an oracle), k 4,
    adaptive k and mixed batching on: acceptance >= 0.9, ``paged_decode``
    launched by the draft runner, and greedy tokens equal to the spec-off
    engine on every request, except where the printed top-2 logit gap at
    the first differing position is below 1e-3 of that position's logit
    standard deviation (counted).

Then the KV transfer layer, on the phase-4 weights (after 7a, before they
are freed; each engine freed before the next is built):

8a. Swap: a 160-page pool (2 MiB pages) and a 2 GB pinned host tier under
    twelve greedy requests whose decode growth overflows the pool: swap
    preemptions > 0 and recompute 0; a wrapper in this script keeps a
    device copy of every page set that goes out and checks every restored
    page ``torch.equal`` to it (the count is logged); the same requests
    twice give the same tokens; each direction's pages, GB, ms and GB/s
    beside a pinned 1 GiB ``copy_`` each way (the link's bound) and the
    time to pin the host tier. A never-preempted engine serves the same
    requests; greedy differences are counted and logged with their top-2
    gap (batch composition changes the GEMM and decode split shapes, so
    bf16 near-ties flip).
8b. Handoff: a prefill replica and a decode replica (two engines, each
    with its own pool). Four prompts, one at a time: prefill with
    ``hold_kv`` and ``max_tokens`` 1, ``export_held``, ``import_request``,
    decode to completion; the tokens must equal the decode replica serving
    the prompt alone. One request migrates mid-decode
    (``export_running`` -> ``import_request``) with tokens equal to the
    uninterrupted run. Then a 1024-token prefix goes ``export_prefix`` ->
    ``begin/import_prefix_chunk/commit``, and a prompt extending it hits
    the imported pages (a prefix-cache hit) with tokens equal to the
    prefill replica serving it from its own cache. Export and import ms
    and GB/s are logged.
8c. Prefix spill: a 192-page engine with prefix caching and a 1 GB host
    tier, beside a 1024-page engine that never evicts. Churn spills every
    page of a 512-token prefix to the host; ``export_prefix`` reads them
    there, byte-equal to the other engine's device pages; a prompt behind
    the prefix restores each page (second chance, > 0 host hits) and runs
    its suffix through the history kernel (launched), with tokens equal to
    the other engine's. A 256-token prefix crosses page by page into the
    host tier (``accept_remote_spill``) and is restored the same way.

After 7b, on its tinyllama-1.1b fp32 weights:

8d. Swap as in 8a (160 pages, 1 GB host tier): swap preemptions only,
    every restored page bit-equal, two identical runs; greedy tokens equal
    the never-preempted engine's except near-ties as in 7b (counted). In
    fp32 the two batchings agree to ~1e-6, so this tells a swap fault
    from bf16 batching noise, which 8a cannot.

Then the OpenAI server (``serving/api_server.py`` on ``serving/http.py``;
the client here speaks HTTP/1.1 over asyncio streams on 127.0.0.1):

9a. In this process on the phase-4 llama-3-8b bf16 weights (run after
    phase 5, before 7a): a 1024-page pool, 16 seats, the byte tokenizer.
    Sequential: four token-id prompts (64, 300, 900 and a chunked 2500
    tokens), greedy, 32 tokens, each plain and streamed; a wrapper in this
    script around the server's ``AsyncLLMEngine.generate`` records the
    token ids, which must be the same both ways and equal to
    ``LLMEngine.generate`` of the prompt alone on the same engine, except
    near-ties as in 7b (counted); the text must be the byte tokenizer's
    decode of the ids and ``usage`` must count them. Concurrent: 16
    requests (completions and chat, streamed and not, one with logprobs 2,
    one n 2 with a seed, one over the prefill budget) in two waves; every
    response 200, every stream ends in ``[DONE]``, the engine idle after,
    the three attention kernels launched, ``kgct_requests_total`` up by
    16, ``kgct_hbm_bytes_in_use`` above 0; client-side TTFT and end-to-end
    seconds logged. Under that load a request with a 0.001 ms TTFT budget
    gets 429 with ``Retry-After``. A 400-token stream closed after its
    first frame (logprobs on, so frames flow per engine chunk) is aborted
    before its 400th token and leaves the engine idle within 10 s, and the
    server still answers. ``begin_drain()``: ``/health`` 503, a new request 503, the
    in-flight stream ends in ``[DONE]``.
9b. The CLI in a subprocess on the card (tinyllama-1.1b int4, group 128,
    8 seats, 0.3 of the free memory): ``/health`` polled until it answers,
    plain, streamed and chat requests, then a long stream during which
    ``POST /debug/profile?seconds=2`` captures a torch.profiler trace
    while one 1500-token prompt alone (a mixed step) and then a wave of
    short prompts (a packed prefill step) arrive; the trace must hold CUDA kernel events of all four kernels
    (found by their ``__global__`` names in ``csrc/``). SIGTERM: exit 0
    within the drain grace. On any failure the server's output is printed.

Then the fleet plane (``serving/handoff.py``'s KV wire, ``fleet_cache.py``,
the server's ``/internal/*`` routes), on the phase-4 weights after phase 8:
servers in this process on free ports, driven through the port's own HTTP
client, at most four llama-3-8b engines alive (1024-page pools, 8 seats);
every greedy request's tokens must equal ``LLMEngine.generate`` of its
prompt alone (on the colocated server's engine, before it serves) but for
near-ties as in 7b (counted):

10a. A ``prefill`` server P (prefix caching on) and a ``decode`` server D
     pulling from it (``x-kgct-prefill-url``), integrity on: six requests
     (prompts 64-2500, 32 new tokens; two streamed with logprobs 1, one
     logprobs 2, one seeded sampled, compared by length). D counts 6
     imports ``ok`` and 0 fallbacks, P 6 exports; each handoff's bytes and
     seconds from ``/metrics``; the streamed ones also colocated on C for
     the TTFT beside D's.
10b. The same pair with ``kv_wire_corrupt`` armed: the corruption is
     caught, the request falls back to local prefill with its tokens, P is
     quarantined on D.
10d. A ``both`` server C streams a 1024-token prompt (400 new tokens) with
     ``x-kgct-migrate-url`` D; after 16 tokens ``begin_drain()`` pushes it:
     the stream ends with no ``[DONE]``, D parks it, ``/internal/resume``
     on D answers in ``import`` mode with only the unseen tokens, and
     relayed plus resumed tokens equal the uninterrupted run.
10c. Two fleet-cache servers F1 and F2: a 1024-token prefix cached on F1 is
     pulled by F2 on ``x-kgct-prefix-source`` (one pull ``ok``, one cache
     hit, the history kernel launched, F1's tokens). Then F1 rebuilt with a
     192-page pool and no host tier of its own: churn evicts a 512-token
     prefix, whose 32 pages land in F2's 1 GB host tier through
     ``/internal/fleet_spill`` (counted ``ok``), and F2 serves the prompt
     from them (host hits) with F1's tokens.
10e. The codec on 10a's 1500-token frame (encode, decode, the import-seam
     verify; integrity on and off; ms and GB/s, best of 3) and the prefill
     FLOP/s of one packed 2048-token prefill step (best of 3), the figure
     ``fleet_cache.DEFAULT_FLOPS["cuda"]`` holds; the pull policy logged.
     ``paged_decode``, ``flash_prefill`` and ``flash_prefill_hist`` must
     have launched across phase 10.

Then the router (``serving/router.py``) on the same weights, right after
phase 10: two ``both`` replicas A and B (1024 pages, 8 seats, prefix
caching on), a ``prefill`` replica P and a ``decode`` replica D, servers
in this process on free ports, with the port's router in front of them in
the same process; the greedy references come from an ``LLMEngine`` of the
replicas' configuration that serves nothing else, fed the same prompts in
the same order:

11.  The router's hop: the same cold 512-token prompt straight to B and
     through a router over A alone (client TTFT and end to end, both
     streamed) for each of 10 cold prompts, and a one-token request both
     ways, many times; the router's added ms (the cold pairs' median,
     quartiles and range, unresolved where the quartiles span 0).
11a. Prefix affinity: four sessions (``session_id``) of three streamed
     turns each, the turns of a session sharing a 512-1024-token prefix.
     Every session sticks to one replica (12 affinity hits), every warm
     turn hits the owner's prefix cache and launches
     ``flash_prefill_hist``, every turn's tokens equal the reference's but
     for counted near-ties.
11b. Least-inflight: 16 concurrent requests (prompts 64-2500, 64 new
     tokens, half streamed) spread over both replicas (each serves some),
     no failure, no retry, one upstream connection per request.
11c. ``replica_kill_midstream`` after 8 relayed chunks of a 1024-token
     stream with 256 new tokens: the client sees one stream ending in
     ``[DONE]``; ``kgct_failovers_total`` rises by one. The relayed tokens
     equal the uninterrupted run's; the resumed ones equal the reference's
     greedy continuation of prompt + relayed tokens (what the recompute
     rung computes); where the whole differs from the uninterrupted run,
     the first difference and its top-2 gap are logged, and the gap must
     be under ``RESUME_DRIFT`` of the logits' deviation.
11e. The router's ``/metrics`` carries both replicas' series, relabelled;
     ``/debug/trace`` is one Perfetto document with a track for the router
     and one per replica; ``replica_down`` on a session's owner sends the
     session to the other replica, and the recovered owner gets it back.
11d. Disaggregated: D behind the router with P as its prefill pool
     (``prefill_urls``); 1500- and 300-token prompts, the handoff counted
     ``ok`` on both sides, tokens equal to the reference's.
11f. The router's CLI in a subprocess in front of A: one streamed request,
     then SIGTERM, exit 0.

The three attention kernels must have launched on the replicas across
phase 11. Each phase logs its seconds.

Then, still on the phase-4 weights, tensor and expert parallelism, each
rank a child process (``chip_smoke.py --tp-child``) that builds its engine
from the seed, drawing each full tensor and keeping its slice; the script
first records the tp=1 engine's greedy tokens for the same requests:

12.  tp 2: two ranks on card 0 joined by gloo (NCCL refuses two ranks on
     one device; gloo stages each all-reduce through host memory, so this
     measures no NVLink), 1024 pages each. Rank 0 serves 8 requests (a
     2500-token prompt, chunked, and prompts arriving one at a time while
     others decode: prefill, chunked, mixed and decode-window steps)
     through ``AsyncLLMEngine(leader=DirectiveLeader)``; rank 1 runs a
     ``DirectiveFollower``. Arrivals follow tp=1's step for step (the
     worker waits after each step for the requests due), and the two runs
     must step the same batches (each step's kind and size). Each
     request's tokens equal tp=1's up to a first difference; from there
     every token is, teacher forced on the tp=1 weights, the top token or
     under ``RESUME_DRIFT`` of the logits' deviation below it: the
     all-reduce sums in another order. ``paged_decode``, ``flash_prefill`` and
     ``flash_prefill_hist`` launch on both ranks (each reports its counts,
     set to 0 just before it serves). Logged: tokens/s at tp 1 and tp 2
     and the ms of one all-reduce of a decode step's [8, 4096] fp32.
12c. Group abort on the same ranks: ``broadcast_fail`` on the leader
     mid-generation; every request fails, the leader's worker stops, the
     follower group-aborts and its ``/health`` turns 503, both within
     ``ABORT_BOUND_S``; no rank process is left.
12e. The server's CLI at tp 2: two ``--distributed`` ranks on card 0
     (``chip_smoke.py --cli-rank``: ``api_server.main`` after a gloo
     rendezvous, since the CLI picks NCCL on a card), four greedy
     requests over HTTP (a 2300-token prompt, chunked, then three more);
     every served token teacher forced as in 12 (there is no one-device
     run to compare with first), the three attention kernels launched on
     both ranks, the follower's ``/health`` 200, and after SIGTERM rank 0
     drains and its stop directive lets rank 1 exit, both with 0.
13.  pp 2: llama-3-8b bf16 at full width and depth as two pipeline
     stages on card 0 over gloo (16 layers and their slab of a 1024-page
     pool each; the embedding and head whole on both), phase 12's
     requests through ``AsyncLLMEngine(leader=)``. pp turns mixed
     batching off, so the one-device reference runs with mixed (and spec)
     off too; arrivals follow it step for step and the two runs must step
     the same batches. Tokens held as in 12. ``paged_decode``,
     ``flash_prefill`` and ``flash_prefill_hist`` launch on both ranks.
     Logged: each rank's weight GB, one send/recv of a decode step's
     [8, 4096] bf16 hidden between the stages (gloo point-to-point ops
     take host memory, so it travels through a pinned buffer) and one
     broadcast of it from the last stage, in ms, and tokens/s at pp 2
     beside pp 1.
13b. sp 2: the same model as two sp ranks on card 0, each holding the
     whole model and a fixed 1024-page pool (both read one
     ``mem_get_info``); the requests' long prompt is 2048 tokens, so one
     prefill runs ring attention at T 2048 (1024 rows a rank). Held as in
     13 against the one-device engine with mixed off; ``paged_decode``
     launches on both ranks and ``flash_prefill`` on neither (the ring
     takes its place, as in the JAX package). Logged: the ring's ms at
     T 2048 beside ``flash_prefill``'s on the same inputs, and its
     largest difference from it.
13c. The server's CLI with ``--pipeline-parallel-size 2``: 12e's requests
     and checks with pp in place of tp.
12d. With two cards, phase 12 over NCCL on cards 0 and 1; with one, the
     line ``nccl tp: not run (1 card)``.
12b. ep 2: mixtral-8x7b int4 at tp 1, ep 2, full width (depth
     ``EP_LAYERS``, None for all 32), two ranks on card 0, four requests,
     the same token check against the one-device engine; ``int4_matmul``
     launches on both ranks.

The line before the last is the ``kernels`` JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
with code 2 and prints no result.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import gc
import itertools
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and dense
# bf16 tensor-core rate. Bounds are stated against these.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
# fp32 outside the tensor cores: the verify attention computes in fp32.
PEAK_FP32_FLOPS = 67e12
# Max-abs tolerance of a bf16 kernel output against the plain version: both
# accumulate in fp32 and round once to bf16 (2^-8 relative, outputs of
# magnitude < ~2.5), plus the different summation order; the tensor-core
# attention kernels also round the softmax probabilities to bf16 before
# P.V (about 2^-9 relative per term).
BF16_ATOL = 2e-2
# Relative L2 tolerance of the model's fp32 logits, kernels vs plain
# versions, after 32 bf16 layers.
LOGITS_RTOL = 5e-2
# Max-abs tolerance of the int4 matmul against int4_matmul_plain, as a
# fraction of the largest output: both return fp32 sums of exact products
# (bf16 x times a nibble), added in different orders.
INT4_RTOL = 1e-5
# H100 L2 size: a weight read again while it still sits there would be timed
# faster than the engine, where every call reads another layer's weight.
L2_BYTES = 50 * 2 ** 20
SEED = 0
MODEL = "llama-3-8b"
GROUP = 128        # int4 group size of the served model (the default)
# The other families, each at its preset's full width and depth: (preset,
# quantization, workload() arguments, SchedulerConfig overrides, KV pages).
# opt-125m holds 2048 positions: its prompts stay below that, and a lower
# prefill budget still chunks the long one. mixtral-8x7b runs int4 (24 GB
# with its scales; bf16 would be 93 GB) on a small workload: a dense-
# dispatch forward makes 897 int4 calls.
FAMILIES = (
    ("qwen2.5-7b", None, {}, {}, 6144),
    ("qwen3-4b", None, {}, {}, 6144),
    ("opt-125m", None, dict(long_len=1500, max_prompt=500),
     dict(max_prefill_tokens=512), 4096),
    ("mixtral-8x7b", "int4", dict(n_req=10, long_len=1400, max_prompt=768,
                                  wave=1),
     dict(max_prefill_tokens=1024), 2048),
)


def log(*a) -> None:
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median time of one call of ``fn`` in CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def graph_ms(fn, reps: int) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in one
    CUDA graph and replayed, so the host's launch overhead between calls
    (which exceeds a decode-sized kernel's run time) is not counted."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    e1.record()
    e1.synchronize()
    ms = e0.elapsed_time(e1) / reps
    del graph
    return ms


def host_us(fn, n: int) -> float:
    """Host microseconds per call of ``fn`` (validation, allocation and the
    launches), ``n`` calls queued back to back without waiting on the
    card."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _randn(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device).to(dtype)


def _compare(name, got, ref) -> float:
    if not torch.isfinite(got.float()).all():
        raise RuntimeError(f"{name}: non-finite kernel output")
    err = float((got.float() - ref.float()).abs().max())
    if err > BF16_ATOL:
        raise RuntimeError(f"{name}: max abs error {err} > {BF16_ATOL}")
    return err


def _prefill_case(gen, T, n_seg, nh, n_kv, hd, dt, device) -> dict:
    """flash_prefill on T tokens as ``n_seg`` equal segments, against the
    plain version; the kernel (called as the engine calls it, with the
    window computed once beforehand) and its SDPA yardstick timed alike,
    in CUDA graphs, so neither reading holds host time."""
    from kubernetes_gpu_cluster_tpu_torch.ops import attention as A
    from kubernetes_gpu_cluster_tpu_torch.ops.cuda import flash_prefill as fp
    n = T // n_seg
    seg = np.repeat(np.arange(n_seg, dtype=np.int32), n)
    pos = np.tile(np.arange(n, dtype=np.int32), n_seg)
    q = _randn(gen, (T, nh, hd), dt, device)
    k = _randn(gen, (T, n_kv, hd), dt, device)
    v = _randn(gen, (T, n_kv, hd), dt, device)
    t_seg = torch.from_numpy(seg).to(device)
    t_pos = torch.from_numpy(pos).to(device)
    scale = hd ** -0.5
    args = (q, k, v, t_seg, t_pos, scale)
    window = fp.kb_min(t_seg)
    got = fp.flash_prefill(*args, window=window)
    ref = A.ragged_prefill_attention_plain(*args)
    err = _compare(f"flash_prefill {n_seg}x{n}", got, ref)
    # Library yardstick: one SDPA call with the same segment-causal mask
    # (k/v heads expanded to nh beforehand, outside the timing).
    mask = ((t_seg[:, None] == t_seg[None, :])
            & (t_pos[:, None] >= t_pos[None, :]))
    qh = q.transpose(0, 1)[None]
    kh = k.repeat_interleave(nh // n_kv, dim=1).transpose(0, 1)[None]
    vh = v.repeat_interleave(nh // n_kv, dim=1).transpose(0, 1)[None]

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, scale=scale)

    _compare("sdpa (library yardstick)", sdpa()[0].transpose(0, 1), ref)
    nbytes = 2 * T * (2 * nh * hd + 2 * n_kv * hd) + 4 * T
    flops = 4 * nh * hd * n_seg * n * (n + 1) // 2
    bms, by = bound_ms(nbytes, flops)
    kernel = lambda: fp.flash_prefill(*args, window=window)  # noqa: E731
    return dict(max_abs_err=err, ms=graph_ms(kernel, 20),
                library_ms=graph_ms(sdpa, 20), bound_ms=bms, bound_by=by,
                kernel=kernel, shape=f"T={T} as {n_seg} segments",
                plain=lambda: A.ragged_prefill_attention_plain(*args))


def _decode_case(gen, rng, B, ctx_lo, ctx_hi, nh, n_kv, hd, ps, pps, dt,
                 device) -> dict:
    """paged_decode on B rows of contexts drawn from [ctx_lo, ctx_hi] over
    ``pps``-page tables (layer 1 of a 2-layer pool), against the plain
    version; the kernel called as the engine calls it, timed in a CUDA
    graph."""
    from kubernetes_gpu_cluster_tpu_torch.ops import attention as A
    from kubernetes_gpu_cluster_tpu_torch.ops.cuda import paged_decode as pd
    from kubernetes_gpu_cluster_tpu_torch.utils import cdiv
    kd = n_kv * hd
    ctx = rng.integers(ctx_lo, ctx_hi + 1, B).astype(np.int32)
    n_pages = [cdiv(int(c), ps) for c in ctx]
    P = sum(n_pages) + 1
    perm = rng.permutation(np.arange(1, P)).astype(np.int32)
    tables = np.zeros((B, pps), np.int32)
    o = 0
    for b, n in enumerate(n_pages):
        tables[b, :n] = perm[o:o + n]
        o += n
    kpool = _randn(gen, (2, P, ps, kd), dt, device)
    vpool = _randn(gen, (2, P, ps, kd), dt, device)
    args = (_randn(gen, (B, nh, hd), dt, device), kpool, vpool,
            torch.from_numpy(tables).to(device),
            torch.from_numpy(ctx).to(device),
            _randn(gen, (B, n_kv, hd), dt, device),
            _randn(gen, (B, n_kv, hd), dt, device), hd ** -0.5)
    got = pd.paged_decode(*args, layer=1)
    ref = A.paged_decode_attention_plain(*args, layer=1)
    err = _compare(f"paged_decode B={B} ctx {ctx_lo}-{ctx_hi}", got, ref)
    if not torch.equal(pd.paged_decode(*args, layer=1), got):
        raise RuntimeError("paged_decode: a second call gave other bits")
    nbytes = 2 * (2 * B * nh * hd + 2 * B * kd + 2 * kd * int(np.sum(ctx - 1))) \
        + 4 * (B * pps + B)
    bms, by = bound_ms(nbytes, 4 * nh * hd * int(np.sum(ctx)))
    kernel = lambda: pd.paged_decode(*args, layer=1)  # noqa: E731
    return dict(max_abs_err=err, ms=graph_ms(kernel, 20), bound_ms=bms,
                bound_by=by, kernel=kernel, args=args,
                plain=lambda: A.paged_decode_attention_plain(*args, layer=1),
                shape=f"B={B} ctx={int(ctx.min())}-{int(ctx.max())} ps={ps} "
                      f"pps={pps}")


def _hist_case(gen, rng, T, hist, nh, n_kv, hd, ps, dt, device) -> dict:
    """flash_prefill_hist on a T-token chunk over ``hist`` pooled tokens
    (layer 1 of a 2-layer pool, the table as wide as the engine's: the next
    power of two in pages), against the plain version; the kernel called
    as the engine calls it (n_valid computed once beforehand), timed in a
    CUDA graph."""
    from kubernetes_gpu_cluster_tpu_torch.ops import attention as A
    from kubernetes_gpu_cluster_tpu_torch.ops.cuda import \
        flash_prefill_hist as fh
    from kubernetes_gpu_cluster_tpu_torch.utils import cdiv
    kd = n_kv * hd
    n_pages = cdiv(hist + T, ps)
    width = 1 << (n_pages - 1).bit_length()
    P = n_pages + 1
    table = np.zeros(width, np.int32)
    table[:n_pages] = rng.permutation(np.arange(1, P)).astype(np.int32)
    t_seg = torch.zeros(T, dtype=torch.int32, device=device)
    args = (_randn(gen, (T, nh, hd), dt, device),
            _randn(gen, (T, n_kv, hd), dt, device),
            _randn(gen, (T, n_kv, hd), dt, device), t_seg,
            torch.arange(hist, hist + T, dtype=torch.int32, device=device),
            _randn(gen, (2, P, ps, kd), dt, device),
            _randn(gen, (2, P, ps, kd), dt, device),
            torch.from_numpy(table).to(device), hist, hd ** -0.5)
    n_valid = fh.valid_tokens(t_seg)
    got = fh.flash_prefill_hist(*args, layer=1, n_valid=n_valid)
    ref = A.prefill_history_attention_plain(*args, layer=1)
    err = _compare(f"flash_prefill_hist chunk {T} hist {hist}", got, ref)
    if not torch.equal(fh.flash_prefill_hist(*args, layer=1), got):
        raise RuntimeError("flash_prefill_hist: a second call gave other bits")
    nbytes = 2 * (T * (2 * nh * hd + 2 * kd) + 2 * hist * kd) + 4 * (width + T)
    flops = 4 * nh * hd * (T * hist + T * (T + 1) // 2)
    bms, by = bound_ms(nbytes, flops)
    kernel = lambda: fh.flash_prefill_hist(  # noqa: E731
        *args, layer=1, n_valid=n_valid)
    return dict(max_abs_err=err, ms=graph_ms(kernel, 20), bound_ms=bms,
                bound_by=by, kernel=kernel,
                plain=lambda: A.prefill_history_attention_plain(*args,
                                                                layer=1),
                shape=f"chunk={T} hist={hist} ps={ps}")


def _logged(what, case) -> None:
    log(f"{what}:", json.dumps({k: case[k] for k in (
        "ms", "bound_ms", "bound_by", "max_abs_err", "shape")}))


def check_kernels(cfg, page_size: int, max_len: int, device) -> list[dict]:
    from kubernetes_gpu_cluster_tpu_torch.utils import cdiv

    nh, n_kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt, ps = torch.bfloat16, page_size
    gen = torch.Generator(device=device).manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    pps = cdiv(max_len, ps)                  # the engine's decode table width
    rows = []

    def row(name, case, replaces):
        return dict(
            name=name, route="cuda",
            source=f"kubernetes_gpu_cluster_tpu_torch/csrc/{name}.cu",
            replaces=replaces, max_abs_err=case["max_abs_err"],
            ms=case["ms"], plain_ms=cuda_ms(case["plain"], 5),
            bound_ms=case["bound_ms"], bound_by=case["bound_by"],
            library_ms=case.get("library_ms"), shape=case["shape"],
            ms_with_launch=cuda_ms(case["kernel"], 20),
            host_us=host_us(case["kernel"], 200))

    # -- paged decode: B=32, context 512-2048 mixed (the row), then logged
    #    only: one 8191-token sequence and B=32 at 64-256.
    case = _decode_case(gen, rng, 32, 512, 2048, nh, n_kv, hd, ps, pps, dt,
                        device)
    rows.append(row("paged_decode", case,
                    "kubernetes_gpu_cluster_tpu/ops/pallas/paged_decode.py:206"))
    del case
    for B, lo, hi in ((1, 8191, 8191), (32, 64, 256)):
        _logged(f"paged_decode B={B} ctx {lo}-{hi}", _decode_case(
            gen, rng, B, lo, hi, nh, n_kv, hd, ps, pps, dt, device))

    # -- ragged prefill: T=2048 as four segments of 512 (the row), then
    #    logged only: one 2048-token segment and 16 segments of 128.
    for T, n_seg in ((2048, 4), (2048, 1), (2048, 16)):
        case = _prefill_case(gen, T, n_seg, nh, n_kv, hd, dt, device)
        if n_seg == 4:
            rows.append(row(
                "flash_prefill", case,
                "kubernetes_gpu_cluster_tpu/ops/pallas/flash_prefill.py:119"))
        else:
            log(f"flash_prefill T={T} as {n_seg} segments:", json.dumps(
                {k: case[k] for k in ("ms", "library_ms", "bound_ms",
                                      "bound_by", "max_abs_err")}))
        del case

    # -- history: a 512-token chunk over 2048 history tokens (the row), then
    #    logged only: the second chunk of a 3000-token prompt and a short
    #    chunk over a long history.
    case = _hist_case(gen, rng, 512, 2048, nh, n_kv, hd, ps, dt, device)
    rows.append(row(
        "flash_prefill_hist", case,
        "kubernetes_gpu_cluster_tpu/ops/pallas/flash_prefill_hist.py:167"))
    del case
    for T, hist in ((2048, 952), (64, 6000)):
        _logged(f"flash_prefill_hist chunk {T} hist {hist}", _hist_case(
            gen, rng, T, hist, nh, n_kv, hd, ps, dt, device))
    torch.cuda.synchronize()
    return rows


def _int4_operands(gen, T, K, N, device):
    x = _randn(gen, (T, K), torch.bfloat16, device)
    wp = torch.randint(-128, 128, (K // 2, N), generator=gen, device=device,
                       dtype=torch.int8)
    scale = torch.rand(K // GROUP, N, generator=gen,
                       device=device) * (K ** -0.5 / 7)
    return x, wp, scale


def _dequant_bf16(wp, scale):
    from kubernetes_gpu_cluster_tpu_torch.ops import quant as Q
    K, N = wp.shape[0] * 2, wp.shape[1]
    return (Q.unpack_int4(wp).float().reshape(-1, GROUP, N)
            * scale[:, None]).reshape(K, N).to(torch.bfloat16)


def _cold_weights(gen, x, wp, scale):
    """Calls that take (x, w) in turn over enough distinct weights (the
    first is ``wp``) that each call reads its weight from device memory, as
    every call in the engine does: ``(kernel call, cuBLAS call on the bf16
    dequantized weight)``."""
    K, N = wp.shape[0] * 2, wp.shape[1]
    n4 = 1 + -(-2 * L2_BYTES // (wp.numel() + 4 * scale.numel()))
    n16 = 1 + -(-2 * L2_BYTES // (2 * K * N))
    sets = [(wp, scale)] + [_int4_operands(gen, 1, K, N, x.device)[1:]
                            for _ in range(n4 - 1)]
    dense = [_dequant_bf16(*sets[i % n4]) for i in range(n16)]
    from kubernetes_gpu_cluster_tpu_torch.ops.cuda import int4_matmul as K4
    it4, it16 = itertools.cycle(sets), itertools.cycle(dense)
    return (lambda: K4.int4_matmul(x, *next(it4)),
            lambda: torch.matmul(x, next(it16)))


def _int4_bytes(T, K, N):
    return K * N // 2 + 4 * (K // GROUP) * N + 2 * T * K + 4 * T * N


def check_int4(cfg, device) -> dict:
    """The int4 matmul at the w_gate projection of a 32-row decode step.
    ``library_ms`` is cuBLAS (``torch.matmul``) on the same bf16 x with the
    weight dequantized to bf16 beforehand: the same product from four times
    the weight bytes. Both are timed over rotating weight copies, so no
    call finds its weight in L2. Also logs (not recorded) the kernel and
    that call at a 2048-row prefill, at w_down and at lm_head."""
    from kubernetes_gpu_cluster_tpu_torch.ops import quant as Q
    from kubernetes_gpu_cluster_tpu_torch.ops.cuda import int4_matmul as K4

    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    d, ff, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    T, K, N = 32, d, ff
    x, wp, scale = _int4_operands(gen, T, K, N, device)
    got = K4.int4_matmul(x, wp, scale)
    ref = Q.int4_matmul_plain(x, wp, scale)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise RuntimeError("int4_matmul: non-finite kernel output")
    err = float((got - ref).abs().max())
    tol = INT4_RTOL * float(ref.abs().max())
    if err > tol:
        raise RuntimeError(f"int4_matmul: max abs error {err} > {tol}")
    kernel, library = _cold_weights(gen, x, wp, scale)
    bms, by = bound_ms(_int4_bytes(T, K, N), 2 * T * K * N)
    row = dict(
        name="int4_matmul", route="cuda",
        source="kubernetes_gpu_cluster_tpu_torch/csrc/int4_matmul.cu",
        replaces="kubernetes_gpu_cluster_tpu/ops/pallas/int4_matmul.py:57",
        max_abs_err=err, ms=graph_ms(kernel, 50),
        plain_ms=cuda_ms(lambda: Q.int4_matmul_plain(x, wp, scale), 5),
        bound_ms=bms, bound_by=by, library_ms=graph_ms(library, 50),
        shape=f"T={T} K={K} N={N} gs={GROUP} bf16 x",
        ms_with_launch=cuda_ms(kernel, 20), host_us=host_us(kernel, 200))
    del x, wp, scale, got, ref, kernel, library
    for T, K, N, what in ((2048, d, ff, "prefill w_gate"),
                          (32, ff, d, "decode w_down"),
                          (32, d, V, "decode lm_head")):
        kernel, library = _cold_weights(
            gen, *_int4_operands(gen, T, K, N, device))
        log(f"int4 {what} T={T} K={K} N={N}:", json.dumps({
            "ms": graph_ms(kernel, 10), "library_ms": graph_ms(library, 10),
            "bound_ms": bound_ms(_int4_bytes(T, K, N), 2 * T * K * N)}))
        del kernel, library
    torch.cuda.synchronize()
    return row


# ---------------------------------------------------------------------------
# Phase 3: the model forward, kernels against plain versions
# ---------------------------------------------------------------------------

def _routes(store: list):
    """A stand-in for ``models.llama._moe_mlp`` that appends each call's
    fp32 router logits [T, E] to ``store``, then runs the block."""
    from kubernetes_gpu_cluster_tpu_torch.models import llama as M
    block = M._moe_mlp

    def recorded(lp, cfg, x, groups=None):
        store.append(M._mm_f32(x.to(torch.float32), lp["router"]))
        return block(lp, cfg, x, groups)
    return recorded


def _routing(got: torch.Tensor, ref: torch.Tensor, k: int) -> dict:
    """Router logits of every (token, layer) pair of two runs -> how many
    pairs chose other top-k experts, and for those the gap between their
    k-th and (k+1)-th logit against how far the logits moved between the
    runs (a gap no wider than the move is a near-tie that the runs may
    break either way)."""
    def chosen(logits):
        return torch.topk(logits, k, dim=-1).indices.sort(dim=-1).values

    differs = (chosen(got) != chosen(ref)).any(dim=-1)
    top = torch.topk(got, k + 1, dim=-1).values
    gap = top[:, k - 1] - top[:, k]
    shift = (got - ref).abs().max(dim=-1).values
    return {"routing_pairs": int(differs.numel()),
            "routing_differs": int(differs.sum()),
            "routing_shift_median": float(shift.median()),
            "routing_gap_shift_at_differs": [
                [float(g), float(m)] for g, m in zip(gap[differs],
                                                     shift[differs])],
            "routing_near_ties": int((gap <= shift).sum())}


def check_model(params, cfg, page_size: int, device, plain) -> dict:
    """Logits of a ragged prefill and one decode substep through the
    kernels, against the same forward with ``plain`` — (module, name,
    plain version) triples — patched in."""
    from kubernetes_gpu_cluster_tpu_torch.config import CacheConfig
    from kubernetes_gpu_cluster_tpu_torch.engine.kv_cache import \
        allocate_kv_cache
    from kubernetes_gpu_cluster_tpu_torch.models import llama as M

    ps = page_size
    lens = [100, 37, 250, 13]
    T = 512
    rng = np.random.default_rng(SEED + 1)
    tokens = np.zeros(T, np.int32)
    seg = np.full(T, -1, np.int32)
    pos = np.zeros(T, np.int32)
    slots = np.zeros(T, np.int32)
    last = []
    page_rows = []
    o, next_page = 0, 1
    for s, n in enumerate(lens):
        tokens[o:o + n] = rng.integers(1, cfg.vocab_size, n)
        seg[o:o + n] = s
        pos[o:o + n] = np.arange(n)
        pages = list(range(next_page, next_page + n // ps + 1))
        next_page += len(pages)
        page_rows.append(pages)
        slots[o:o + n] = [pages[p // ps] * ps + p % ps for p in range(n)]
        last.append(o + n - 1)
        o += n
    up = lambda a: torch.from_numpy(np.asarray(a)).to(device)  # noqa: E731
    meta = M.PrefillMeta(up(seg), up(pos), up(slots), up(np.array(last,
                                                                   np.int32)))
    # One decode substep after the prefill: each sequence's next token.
    pps = max(len(p) for p in page_rows)
    tables = np.zeros((len(lens), pps), np.int32)
    for b, pages in enumerate(page_rows):
        tables[b, :len(pages)] = pages
    dpos = np.array(lens, np.int32)
    dslots = np.array([page_rows[b][n // ps] * ps + n % ps
                       for b, n in enumerate(lens)], np.int32)
    dmeta = M.DecodeMeta(up(dpos), up(dslots), up(tables), up(dpos + 1))
    dtok = up(rng.integers(1, cfg.vocab_size, len(lens)).astype(np.int32))
    cache = CacheConfig(page_size=ps)

    routes: dict = {"kernels": [], "plain": []}

    def run(which):
        with contextlib.ExitStack() as stack:
            if cfg.is_moe:
                stack.enter_context(mock.patch.object(
                    M, "_moe_mlp", _routes(routes[which])))
            if which == "plain":
                for mod, name, fn in plain:
                    stack.enter_context(mock.patch.object(mod, name, fn))
            kv = allocate_kv_cache(cfg, cache, next_page + 1, device)
            h, _, _ = M.forward_prefill(params, cfg, up(tokens), meta, kv)
            lp = M.compute_logits(params, cfg, h)
            h, _, _ = M.forward_decode(params, cfg, dtok, dmeta, kv)
            return lp, M.compute_logits(params, cfg, h)

    got_p, got_d = run("kernels")
    ref_p, ref_d = run("plain")
    out = {}
    if cfg.is_moe:      # (token, layer) pairs routed to other experts
        out.update(_routing(torch.cat(routes["kernels"]),
                            torch.cat(routes["plain"]),
                            cfg.num_experts_per_tok))
    for name, g, r in (("prefill", got_p, ref_p), ("decode", got_d, ref_d)):
        if not torch.isfinite(g).all():
            raise RuntimeError(f"model {name}: non-finite logits")
        rel = float(torch.linalg.vector_norm(g - r)
                    / torch.linalg.vector_norm(r))
        if rel > LOGITS_RTOL:
            raise RuntimeError(f"model {name}: logits rel-L2 {rel} > "
                               f"{LOGITS_RTOL}")
        out[f"{name}_logits_rel_l2"] = rel
        out[f"{name}_argmax_agree"] = float(
            (g.argmax(-1) == r.argmax(-1)).float().mean())
    return out


# ---------------------------------------------------------------------------
# Phase 4: the engine
# ---------------------------------------------------------------------------

def workload(vocab: int, n_req: int = 24, long_len: int = 3000,
             max_prompt: int = 1500, wave: int = 3):
    """(arrival step, request id suffix, prompt, SamplingParams) in waves:
    a first wave, then ``wave`` requests every three steps while earlier
    ones decode, one prompt above max_prefill_tokens (chunked), and one
    seeded sampled request. A prompt that arrives with no other packable
    prompt waiting rides a mixed step (engine/mixed_batch.py); waves of
    short prompts are packed into plain prefill steps instead."""
    from kubernetes_gpu_cluster_tpu_torch.engine import SamplingParams
    rng = np.random.default_rng(SEED + 2)
    reqs = []
    for i in range(n_req):
        n = int(rng.integers(32, max_prompt + 1))
        prompt = [int(t) for t in rng.integers(1, vocab, n)]
        max_tokens = int(rng.integers(32, 65))
        if i == 5:
            sp = SamplingParams(max_tokens=max_tokens, temperature=0.8,
                                top_p=0.95, top_k=50, seed=1234)
        else:
            sp = SamplingParams(max_tokens=max_tokens, temperature=0.0)
        arrival = 0 if i < 6 else 2 + 3 * ((i - 6) // wave)
        reqs.append((arrival, f"r{i}", prompt, sp))
    # The long prompt heads the first wave: with nothing running yet its
    # first chunks run solo (chunked prefill over the pool history).
    prompt = [int(t) for t in rng.integers(1, vocab, long_len)]
    reqs.insert(0, (0, "long", prompt, SamplingParams(max_tokens=48,
                                                      temperature=0.0)))
    return reqs


def drive(engine, reqs, tag: str, hist_counter) -> dict:
    """Serve ``reqs`` (arrivals by step index, so two runs see the same
    batches), recording each step's kind and batch size."""
    pending = sorted(reqs, key=lambda r: r[0])
    kinds = dict.fromkeys(("prefill", "chunked", "mixed", "decode", "spec",
                           "spec_mixed"), 0)
    final = {}
    schedule = []
    step = 0
    t0 = time.perf_counter()
    while pending or engine.has_unfinished_requests():
        while pending and pending[0][0] <= step:
            _, rid, prompt, sp = pending.pop(0)
            engine.add_request(f"{tag}-{rid}", prompt, sp)
        hist_before = hist_counter.launches
        for out in engine.step():
            if out.finished:
                final[out.request_id[len(tag) + 1:]] = out.output_token_ids
        schedule.append(_step_record(engine, hist_counter, hist_before))
        if schedule[-1] is not None:
            kinds[schedule[-1][0]] += 1
        step += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_tok = sum(len(t) for t in final.values())
    return {"tokens": final, "kinds": kinds, "wall_s": wall,
            "generated_tokens": n_tok, "tokens_per_s": n_tok / wall,
            "steps": step, "schedule": schedule}


def _step_record(engine, hist_counter, hist_before):
    """[kind, sequences] of the step just run, None for a step that ran no
    batch; a prefill step that launched the history kernel is a solo chunk
    of a long prompt ("chunked")."""
    info = engine._last_step_info
    if info is None:
        return None
    kind = info[0]
    if kind == "prefill" and hist_counter.launches > hist_before:
        kind = "chunked"
    return [kind, info[1]]


def check_engine(cfg_engine, params, device, counters, reqs) -> dict:
    """Serve ``reqs`` twice; every kernel in ``counters`` must launch in
    run 1 (counts set to 0 just before it) and both runs must agree."""
    from kubernetes_gpu_cluster_tpu_torch.engine import LLMEngine
    engine = LLMEngine(cfg_engine, params=params, device=device)
    # Warm-up: cuBLAS handles and the allocator, outside the counted run.
    hist = counters["flash_prefill_hist"]
    drive(engine, reqs[1:3], "warm", hist)
    for mod in counters.values():
        mod.launches = 0
    run1 = drive(engine, reqs, "a", hist)
    launches = {name: mod.launches for name, mod in counters.items()}
    log("engine run 1:", _loggable(run1),
        "launches:", json.dumps(launches))
    for name, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"kernel {name} never launched on the main path")
    for kind in ("prefill", "chunked", "mixed", "decode"):
        if run1["kinds"].get(kind, 0) <= 0:
            raise RuntimeError(f"no {kind} step ran: {run1['kinds']}")
    if set(run1["tokens"]) != {r[1] for r in reqs}:
        raise RuntimeError("not every request finished")
    for _, rid, prompt, sp in reqs:
        toks = run1["tokens"][rid]
        if len(toks) != sp.max_tokens or not all(
                0 <= t < cfg_engine.model.vocab_size for t in toks):
            raise RuntimeError(f"{rid}: bad output {len(toks)} tokens")
    run2 = drive(engine, reqs, "b", hist)
    same = [rid for rid in run1["tokens"]
            if run1["tokens"][rid] == run2["tokens"][rid]]
    if len(same) != len(run1["tokens"]):
        diff = sorted(set(run1["tokens"]) - set(same))
        raise RuntimeError(f"second run differs for {diff}")
    log("engine run 2: identical tokens for", len(same), "requests;",
        _loggable(run2))
    del engine
    return {"run1": _summary(run1),
            "launches": launches}


def check_int8_engine(cfg_engine, device) -> dict:
    """int8 llama-3-8b (random codes from the seed; the pool sized from the
    free memory left by the weights): four requests, twice, same tokens."""
    from kubernetes_gpu_cluster_tpu_torch.engine import (LLMEngine,
                                                         SamplingParams)
    engine = LLMEngine(cfg_engine, device=device)
    rng = np.random.default_rng(SEED + 5)
    prompts = [[int(t) for t in rng.integers(1, cfg_engine.model.vocab_size,
                                             int(n))]
               for n in (64, 300, 900, 17)]
    sp = SamplingParams(max_tokens=16, temperature=0.0)
    t0 = time.perf_counter()
    first = [o.output_token_ids for o in engine.generate(prompts, sp)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    second = [o.output_token_ids for o in engine.generate(prompts, sp)]
    if first != second:
        raise RuntimeError("int8 engine: the second run differs")
    if any(len(t) != sp.max_tokens for t in first):
        raise RuntimeError("int8 engine: a request ended early")
    out = {"requests": len(prompts), "kv_pages": engine.kv_cache.num_pages,
           "weight_gb": sum(t.numel() * t.element_size() for t in
                            [*engine.params["layers"].values(),
                             *(v for k, v in engine.params.items()
                               if k != "layers")]) / 1e9,
           "run1_wall_s": wall}
    del engine
    return out


def check_family(cfg, wl, sched, pages, device, attn, attn_plain) -> dict:
    """Phases 6a and 6b for one family (random weights from the seed, freed
    at the end)."""
    from kubernetes_gpu_cluster_tpu_torch.config import (CacheConfig,
                                                         EngineConfig,
                                                         SchedulerConfig)
    from kubernetes_gpu_cluster_tpu_torch.engine.engine import \
        DEFAULT_PAGE_SIZE
    from kubernetes_gpu_cluster_tpu_torch.models import llama as M
    from kubernetes_gpu_cluster_tpu_torch.ops import quant as Q
    from kubernetes_gpu_cluster_tpu_torch.ops.cuda import int4_matmul

    ps = DEFAULT_PAGE_SIZE
    # The attention kernels at this family's heads, the phase-2 shapes.
    nh, n_kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    gen = torch.Generator(device=device).manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    dt = torch.bfloat16
    for what, case in (
            ("paged_decode", lambda: _decode_case(
                gen, rng, 32, 512, 2048, nh, n_kv, hd, ps,
                -(-cfg.max_model_len // ps), dt, device)),
            ("flash_prefill", lambda: _prefill_case(
                gen, 2048, 4, nh, n_kv, hd, dt, device)),
            ("flash_prefill_hist", lambda: _hist_case(
                gen, rng, 512, 2048, nh, n_kv, hd, ps, dt, device))):
        _logged(f"{cfg.name} {what} nh={nh} n_kv={n_kv} hd={hd}", case())
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(
        SEED), device)
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0,
           "weight_gb": sum(t.numel() * t.element_size() for t in
                            [*params["layers"].values(),
                             *(v for k, v in params.items()
                               if k != "layers")]) / 1e9}
    counters = dict(attn)
    plain = attn_plain
    if cfg.quantization == "int4":
        counters["int4_matmul"] = int4_matmul
        plain = [(Q, "int4_matmul", Q.int4_matmul_plain)]
    t0 = time.perf_counter()
    out["model"] = check_model(params, cfg, ps, device, plain)
    if out["model"].get("routing_differs"):
        log(f"{cfg.name}: the top-k experts of "
            f"{out['model']['routing_differs']} (token, layer) pairs differ "
            "between the kernel and plain runs")
    out["model_s"] = time.perf_counter() - t0
    log(f"{cfg.name} model:", json.dumps(out))
    t0 = time.perf_counter()
    cfg_engine = EngineConfig(
        model=cfg, seed=SEED, cache=CacheConfig(page_size=ps,
                                                num_pages=pages),
        scheduler=SchedulerConfig(max_num_seqs=32, **sched))
    out["engine"] = check_engine(cfg_engine, params, device, counters,
                                 workload(cfg.vocab_size, **wl))
    out["engine_s"] = time.perf_counter() - t0
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 7: speculative decoding
# ---------------------------------------------------------------------------

# Top-2 logit gap, as a fraction of the logits' standard deviation, below
# which a greedy divergence between spec on and off counts as a near-tie:
# two fp32 attention paths (PyTorch verify, the decode kernel) differ by
# ~1e-6 relative, so only such ties can flip.
NEAR_TIE = 1e-3


def spec_workload(vocab: int):
    """Phase 4's workload shape with half the prompts (the last twelve to
    arrive, so the first windows run without drafts) repeating a random
    8-32 token pattern to their length, so n-gram drafts exist, plus one
    more seeded sampled request."""
    from kubernetes_gpu_cluster_tpu_torch.engine import SamplingParams
    rng = np.random.default_rng(SEED + 7)
    reqs = []
    for arrival, rid, prompt, sp in workload(vocab):
        if rid != "long" and int(rid[1:]) >= 12:
            pattern = [int(t) for t in rng.integers(
                1, vocab, int(rng.integers(8, 33)))]
            prompt = (pattern * (len(prompt) // len(pattern) + 1))[
                :len(prompt)]
        reqs.append((arrival, rid, prompt, sp))
    pattern = [int(t) for t in rng.integers(1, vocab, 16)]
    reqs.append((2, "sampled", pattern * 20, SamplingParams(
        max_tokens=48, temperature=0.8, top_p=0.95, seed=77)))
    return reqs


def _spec_run(engine, reqs, tag, counters) -> dict:
    """One counted run (every count set to 0 just before it): drive()'s
    record plus the launches, drafted/accepted tokens of this run."""
    obs = engine.obs
    d0, a0 = obs.spec_drafted_tokens, obs.spec_accepted_tokens
    for mod in counters.values():
        mod.launches = 0
    run = drive(engine, reqs, tag, counters["flash_prefill_hist"])
    run["launches"] = {n: mod.launches for n, mod in counters.items()}
    run["drafted"] = obs.spec_drafted_tokens - d0
    run["accepted"] = obs.spec_accepted_tokens - a0
    run["acceptance"] = run["accepted"] / max(run["drafted"], 1)
    return run


def _summary(run) -> dict:
    """``drive``'s result without its per-request and per-step lists."""
    return {k: v for k, v in run.items() if k not in ("tokens", "schedule")}


def _loggable(run) -> str:
    return json.dumps(_summary(run))


def time_verify(cfg, page_size, max_len, device, S: int) -> dict:
    """The verify attention (PyTorch, fp32) per call at the engine's shape,
    B 32 rows of S tokens over contexts 512-2048 with the table cut to the
    longest, beside ``paged_decode`` on the same pool and contexts (one
    token per row), each timed in CUDA events. Its bound: the bf16 inputs
    and output moved once, against the fp32 operations over each row's
    history and causal slice at the fp32 peak."""
    from kubernetes_gpu_cluster_tpu_torch.ops import attention as A
    from kubernetes_gpu_cluster_tpu_torch.utils import cdiv
    nh, n_kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    rng = np.random.default_rng(SEED + 8)
    B, dt = 32, torch.bfloat16
    case = _decode_case(gen, rng, B, 512, 2048, nh, n_kv, hd, page_size,
                        cdiv(max_len, page_size), dt, device)
    _, kpool, vpool, tables, ctx, _, _, scale = case["args"]
    width = A.verify_table_width(ctx.cpu().numpy(), page_size)
    tables = tables[:, :width].contiguous()
    q = _randn(gen, (B * S, nh, hd), dt, device)
    k = _randn(gen, (B * S, n_kv, hd), dt, device)
    v = _randn(gen, (B * S, n_kv, hd), dt, device)

    def verify():
        return A.spec_verify_attention(q, k, v, kpool, vpool, tables, ctx,
                                       scale, layer=1)

    out = verify()
    if not torch.isfinite(out.float()).all():
        raise RuntimeError("verify attention: non-finite output")
    hist = int((ctx - 1).clamp(min=0).sum())
    nbytes = 2 * (2 * B * S * (nh * hd + n_kv * hd) + 2 * n_kv * hd * hist) \
        + 4 * (B * width + B)
    flops = 4 * nh * hd * (S * hist + B * S * (S + 1) // 2)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return {"verify_ms": cuda_ms(verify, 10),
            "verify_bound_ms": max(t_bytes, t_ops),
            "verify_bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "paged_decode_ms": cuda_ms(case["kernel"], 20),
            "paged_decode_graph_ms": case["ms"], "rows": B, "S": S,
            "table_width": width, "shape": case["shape"]}


def check_spec_ngram(cfg_engine, params, device, counters) -> dict:
    """Phase 7a: n-gram speculation on the phase-4 engine, twice, then the
    spec-off engine once on the same requests."""
    from kubernetes_gpu_cluster_tpu_torch.engine import LLMEngine
    sc = dataclasses.replace(cfg_engine.scheduler, spec_decode_enabled=True,
                             num_speculative_tokens=4,
                             mixed_batch_enabled=True)
    cfg_spec = dataclasses.replace(cfg_engine, scheduler=sc)
    reqs = spec_workload(cfg_engine.model.vocab_size)
    engine = LLMEngine(cfg_spec, params=params, device=device)
    drive(engine, reqs[1:3], "warm", counters["flash_prefill_hist"])
    run1 = _spec_run(engine, reqs, "a", counters)
    log("spec engine run 1:", _loggable(run1))
    kinds, launches = run1["kinds"], run1["launches"]
    if kinds["spec"] < 1 or kinds["spec_mixed"] < 1:
        raise RuntimeError(f"spec / spec_mixed steps did not run: {kinds}")
    if run1["drafted"] <= 0:
        raise RuntimeError("the n-gram proposer drafted nothing")
    for name in ("paged_decode", "flash_prefill", "flash_prefill_hist"):
        if launches[name] <= 0:
            raise RuntimeError(f"kernel {name} never launched in the spec run")
    if set(run1["tokens"]) != {r[1] for r in reqs}:
        raise RuntimeError("spec engine: not every request finished")
    run2 = _spec_run(engine, reqs, "b", counters)
    log("spec engine run 2:", _loggable(run2))
    diff = sorted(r for r in run1["tokens"]
                  if run1["tokens"][r] != run2["tokens"][r])
    if diff:
        raise RuntimeError(f"spec engine: the second run differs for {diff}")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    off = LLMEngine(cfg_engine, params=params, device=device)
    drive(off, reqs[1:3], "warm", counters["flash_prefill_hist"])
    run_off = drive(off, reqs, "off", counters["flash_prefill_hist"])
    del off
    greedy = [r[1] for r in reqs if r[3].temperature == 0.0]
    same = sum(run1["tokens"][r] == run_off["tokens"][r] for r in greedy)
    out = {"tokens_per_s_spec": run1["tokens_per_s"],
           "tokens_per_s_spec_run2": run2["tokens_per_s"],
           "tokens_per_s_off": run_off["tokens_per_s"],
           "acceptance": run1["acceptance"], "drafted": run1["drafted"],
           "accepted": run1["accepted"], "kinds": kinds,
           "kinds_off": run_off["kinds"], "launches": launches,
           "greedy_identical_to_off": same / len(greedy),
           "greedy_requests": len(greedy)}
    out.update(time_verify(cfg_engine.model, cfg_engine.cache.page_size,
                           cfg_engine.effective_max_len, device, 5))
    return out


def _prefill_logits(params, cfg, ids, at, device) -> torch.Tensor:
    """fp32 logits [len(at), V] after ``ids[:i + 1]`` for each i in
    ``at``, by one prefill of the whole sequence."""
    from kubernetes_gpu_cluster_tpu_torch.config import CacheConfig
    from kubernetes_gpu_cluster_tpu_torch.engine.kv_cache import \
        allocate_kv_cache
    from kubernetes_gpu_cluster_tpu_torch.models import llama as M
    n, ps = len(ids), 16
    up = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(device)  # noqa: E731
    kv = allocate_kv_cache(cfg, CacheConfig(page_size=ps), -(-n // ps) + 1,
                           device)
    meta = M.PrefillMeta(up(np.zeros(n)), up(np.arange(n)),
                         up(np.arange(n) + ps), up(at))
    h, _, _ = M.forward_prefill(params, cfg, up(ids), meta, kv)
    return M.compute_logits(params, cfg, h)


def _top2_gap(params, cfg, ids, device) -> tuple[float, float]:
    """(top-2 gap, standard deviation) of the logits after ``ids``, by one
    prefill of the whole sequence."""
    logits = _prefill_logits(params, cfg, ids, [len(ids) - 1], device)[0]
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1]), float(logits.std())


def check_spec_draft(cfg, params, device, counters) -> dict:
    """Phase 7b: tinyllama-1.1b fp32 drafting for itself (an oracle), the
    draft model's own pool; spec off on the same requests."""
    from kubernetes_gpu_cluster_tpu_torch.config import (
        CacheConfig, EngineConfig, SchedulerConfig)
    from kubernetes_gpu_cluster_tpu_torch.engine import (LLMEngine,
                                                         SamplingParams)
    base = EngineConfig(model=cfg, seed=SEED,
                        cache=CacheConfig(page_size=16, num_pages=2048),
                        scheduler=SchedulerConfig(max_num_seqs=32,
                                                  max_prefill_tokens=512))
    spec = dataclasses.replace(base, scheduler=dataclasses.replace(
        base.scheduler, spec_decode_enabled=True, num_speculative_tokens=4,
        spec_adaptive_k=True, spec_draft_model="tinyllama-1.1b"))
    rng = np.random.default_rng(SEED + 9)
    greedy = SamplingParams(max_tokens=40, temperature=0.0)
    reqs = [(0 if i < 6 else 2 + 2 * (i - 6), f"r{i}",
             [int(t) for t in rng.integers(1, cfg.vocab_size,
                                           int(rng.integers(24, 400)))],
             greedy) for i in range(14)]
    reqs.insert(0, (0, "long", [int(t) for t in rng.integers(
        1, cfg.vocab_size, 1300)], greedy))
    engine = LLMEngine(spec, params=params, device=device,
                       draft_params=params)
    runner = engine.scheduler.spec_proposer
    propose = runner.propose_batch
    by_draft = {"paged_decode": 0, "flash_prefill_hist": 0}

    def counted(seqs, k):
        before = {n: counters[n].launches for n in by_draft}
        out = propose(seqs, k)
        for n in by_draft:
            by_draft[n] += counters[n].launches - before[n]
        return out

    runner.propose_batch = counted
    drive(engine, reqs[1:3], "warm", counters["flash_prefill_hist"])
    for n in by_draft:
        by_draft[n] = 0
    run = _spec_run(engine, reqs, "a", counters)
    run["launches_by_draft_runner"] = dict(by_draft)
    run["draft_dispatches"] = runner.num_dispatches
    run["draft_reset_prefills"] = runner.num_reset_prefills
    log("draft spec engine:", _loggable(run))
    del engine, runner
    gc.collect()
    torch.cuda.empty_cache()
    if run["acceptance"] < 0.9:
        raise RuntimeError(f"oracle draft acceptance {run['acceptance']}")
    if by_draft["paged_decode"] <= 0:
        raise RuntimeError("the draft runner never launched paged_decode")
    if run["kinds"]["spec"] + run["kinds"]["spec_mixed"] < 1:
        raise RuntimeError(f"no spec step ran: {run['kinds']}")
    off = LLMEngine(base, params=params, device=device)
    run_off = drive(off, reqs, "off", counters["flash_prefill_hist"])
    del off
    ties, faults = [], []
    for _, rid, prompt, _ in reqs:
        a, b = run["tokens"][rid], run_off["tokens"][rid]
        if a == b:
            continue
        i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        gap, std = _top2_gap(params, cfg, prompt + b[:i], device)
        log(f"spec/off divergence {rid} at output {i}: top-2 gap {gap} "
            f"logit std {std} ({gap / std:.3g} of it)")
        (ties if gap < NEAR_TIE * std else faults).append(rid)
    gc.collect()
    torch.cuda.empty_cache()
    if faults:
        raise RuntimeError(f"greedy spec output differs from spec off "
                           f"beyond a near-tie for {faults}")
    return {"tokens_per_s_spec": run["tokens_per_s"],
            "tokens_per_s_off": run_off["tokens_per_s"],
            "acceptance": run["acceptance"], "kinds": run["kinds"],
            "launches": run["launches"],
            "launches_by_draft_runner": run["launches_by_draft_runner"],
            "near_tie_divergences": len(ties), "requests": len(reqs)}


# ---------------------------------------------------------------------------
# Phase 8: the KV transfer layer (host tier, export/import seams)
# ---------------------------------------------------------------------------

SWAP_PAGES = 160     # 8a's and 8d's device pool (8a: 320 MB of bf16 KV)
SWAP_GB = 2.0        # 8a's host tier: 1024 pages, more than the overflow
SWAP_GB_FP32 = 1.0   # 8d's host tier: 1489 pages of tinyllama-1.1b fp32
HANDOFF_PAGES = 1024
PREFIX_TOKENS = 1024
SPILL_PAGES = 192    # 8c's device pool: two 1500-token prompts evict it
SPILL_GB = 1.0       # 8c's host tier: 512 pages
SHARED_TOKENS = 512  # 8c's prefix spilled to the host and restored
REMOTE_TOKENS = 256  # 8c's prefix accepted as a peer's spill


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def link_bound(device) -> dict:
    """GB/s of one 1 GiB ``copy_`` each way between pinned host memory and
    the card (CUDA events): the link's bound beside the transfer rates."""
    n = 1 << 30
    host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(n, dtype=torch.uint8, device=device)
    d2h = cuda_ms(lambda: host.copy_(dev, non_blocking=True), 3, warmup=1)
    h2d = cuda_ms(lambda: dev.copy_(host, non_blocking=True), 3, warmup=1)
    return {"d2h_gb_s": n / d2h / 1e6, "h2d_gb_s": n / h2d / 1e6,
            "bytes": n}


class SwapAudit:
    """Wraps an engine's swapper (in this script only): keeps a device copy
    of every page set that goes out, checks every restored page against it
    with ``torch.equal``, and times each transfer between two
    synchronizes (the swapper's own swap-in returns before its copy
    finishes)."""

    def __init__(self, engine):
        self.engine = engine
        sw = engine.swapper
        self._out, self._in = sw.swap_out, sw.swap_in
        sw.swap_out, sw.swap_in = self.swap_out, self.swap_in
        self.saved: dict = {}
        self.compared = 0
        self.pages = {"out": 0, "in": 0}
        self.seconds = {"out": 0.0, "in": 0.0}

    def _read(self, pages):
        kv = self.engine.kv_cache
        idx = torch.tensor(pages, device=kv.k.device)
        return kv.k.index_select(1, idx), kv.v.index_select(1, idx)

    def _timed(self, direction, n, fn):
        device = self.engine.device
        _sync(device)
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        self.seconds[direction] += time.perf_counter() - t0
        self.pages[direction] += n
        return out

    def swap_out(self, pages, request_id=""):
        k, v = self._read(pages)
        host_pages = self._timed("out", len(pages),
                                 lambda: self._out(pages, request_id))
        for i, hp in enumerate(host_pages):
            self.saved[hp] = (k[:, i], v[:, i])
        return host_pages

    def swap_in(self, host_pages, device_pages, request_id=""):
        self._timed("in", len(host_pages), lambda: self._in(
            host_pages, device_pages, request_id))
        k, v = self._read(device_pages)
        for i, hp in enumerate(host_pages):
            want_k, want_v = self.saved.pop(hp)
            if not (torch.equal(k[:, i], want_k)
                    and torch.equal(v[:, i], want_v)):
                raise RuntimeError(f"restored page {device_pages[i]} (host "
                                   f"{hp}) differs from what went out")
            self.compared += 1

    def rates(self, page_bytes: int) -> dict:
        out = {}
        for d in ("out", "in"):
            b = self.pages[d] * page_bytes
            out[d] = {"pages": self.pages[d], "gb": b / 1e9,
                      "ms": self.seconds[d] * 1e3,
                      "gb_s": b / self.seconds[d] / 1e9
                      if self.seconds[d] else None}
        return out


def swap_workload(vocab: int):
    """Twelve greedy requests of 200-600-token prompts and 64-128 new
    tokens, all at step 0: their decode growth overflows 8a's pool."""
    from kubernetes_gpu_cluster_tpu_torch.engine import SamplingParams
    rng = np.random.default_rng(SEED + 11)
    return [(0, f"s{i}", [int(t) for t in rng.integers(
        1, vocab, int(rng.integers(200, 601)))],
        SamplingParams(max_tokens=int(rng.integers(64, 129)),
                       temperature=0.0)) for i in range(12)]


def check_swap(cfg_engine, params, device, counters, swap_gb: float,
               near_ties_only: bool) -> dict:
    """Swap preemption on ``params`` through a ``SWAP_PAGES`` pool: the
    same requests twice (identical tokens), every restored page bit-equal
    to what went out, then a never-preempted engine on the same requests.
    Greedy differences from it are logged with their top-2 gap: batch
    composition changes the GEMM shapes and ``paged_decode``'s split plan.
    Phase 8a (llama-3-8b bf16) counts them; with ``near_ties_only`` (8d,
    fp32, where the two batchings agree to ~1e-6) each one must be a
    near-tie, below ``NEAR_TIE`` of the logit standard deviation."""
    from kubernetes_gpu_cluster_tpu_torch.config import (CacheConfig,
                                                         SchedulerConfig)
    from kubernetes_gpu_cluster_tpu_torch.engine import LLMEngine
    from kubernetes_gpu_cluster_tpu_torch.engine.kv_cache import \
        kv_cache_bytes_per_page
    cfg = cfg_engine.model
    ps = cfg_engine.cache.page_size
    sched = SchedulerConfig(max_num_seqs=12)
    cfg_swap = dataclasses.replace(
        cfg_engine, scheduler=sched,
        cache=CacheConfig(page_size=ps, num_pages=SWAP_PAGES,
                          swap_space_gb=swap_gb))
    page_bytes = kv_cache_bytes_per_page(cfg, cfg_swap.cache)
    reqs = swap_workload(cfg.vocab_size)
    hist = counters.get("flash_prefill_hist")
    engine = LLMEngine(cfg_swap, params=params, device=device)
    host = engine.swapper.host
    audit = SwapAudit(engine)
    drive(engine, reqs[:2], "warm", hist)
    for mod in counters.values():
        mod.launches = 0
    kinds0 = dict(engine.scheduler.num_preemptions_by_kind)
    run1 = drive(engine, reqs, "a", hist)
    launches = {name: mod.launches for name, mod in counters.items()}
    kinds = {k: v - kinds0[k]
             for k, v in engine.scheduler.num_preemptions_by_kind.items()}
    rates = audit.rates(page_bytes)
    compared = audit.compared
    log("swap run 1:", _loggable(run1),
        "preemptions:", json.dumps(kinds), "launches:", json.dumps(launches))
    if kinds["swap"] <= 0 or kinds["recompute"] != 0:
        raise RuntimeError(f"swap: expected swap preemptions only: {kinds}")
    if compared <= 0 or audit.pages["in"] != audit.pages["out"]:
        raise RuntimeError(f"swap: {compared} restored pages compared, "
                           f"{audit.pages}")
    # The prompts fit the prefill budget: no chunk runs the history kernel.
    for name in ("paged_decode", "flash_prefill"):
        if launches.get(name, 1) <= 0:
            raise RuntimeError(f"swap: kernel {name} never launched")
    if set(run1["tokens"]) != {r[1] for r in reqs}:
        raise RuntimeError("swap: not every request finished")
    run2 = drive(engine, reqs, "b", hist)
    diff = sorted(r for r in run1["tokens"]
                  if run1["tokens"][r] != run2["tokens"][r])
    if diff:
        raise RuntimeError(f"swap: the second run differs for {diff}")
    if (host.num_in_use or engine.scheduler.allocator.num_free
            != engine.scheduler.allocator.num_pages - 1):
        raise RuntimeError("swap: pages left in use after the runs")
    out = {"preemptions": kinds, "restored_pages_compared": compared,
           "restored_pages_compared_run2": audit.compared - compared,
           "transfers": rates, "page_bytes": page_bytes,
           "host_pages": host.num_pages, "host_pin_s": host.pin_s,
           "tokens_per_s": run1["tokens_per_s"],
           "tokens_per_s_run2": run2["tokens_per_s"],
           "kinds": run1["kinds"], "launches": launches}
    del engine, audit, host
    gc.collect()
    torch.cuda.empty_cache()
    off = LLMEngine(dataclasses.replace(
        cfg_engine, scheduler=sched,
        cache=CacheConfig(page_size=ps, num_pages=HANDOFF_PAGES)),
        params=params, device=device)
    run_off = drive(off, reqs, "off", hist)
    del off
    gc.collect()
    torch.cuda.empty_cache()
    diverged, faults = [], []
    for _, rid, prompt, _ in reqs:
        a, b = run1["tokens"][rid], run_off["tokens"][rid]
        if a == b:
            continue
        i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        gap, std = _top2_gap(params, cfg, prompt + b[:i], device)
        log(f"swap/never-preempted divergence {rid} at output {i}: top-2 "
            f"gap {gap} logit std {std} ({gap / std:.3g} of it)")
        diverged.append({"rid": rid, "at": i, "gap_over_std": gap / std})
        if gap >= NEAR_TIE * std:
            faults.append(rid)
    if near_ties_only and faults:
        raise RuntimeError(f"swap output differs from never-preempted "
                           f"beyond a near-tie for {faults}")
    out.update(tokens_per_s_never_preempted=run_off["tokens_per_s"],
               kinds_never_preempted=run_off["kinds"],
               greedy_differing_from_never_preempted=len(diverged),
               beyond_near_tie=len(faults), divergences=diverged,
               requests=len(reqs))
    return out


def _serve_one(engine, rid, prompt, sp) -> list[int]:
    engine.add_request(rid, prompt, sp)
    final = None
    while engine.has_unfinished_requests():
        for o in engine.step():
            if o.request_id == rid and o.finished:
                final = list(o.output_token_ids)
    return final


def check_handoff(cfg_engine, params, device, counters) -> dict:
    """Phase 8b: a prefill replica and a decode replica (two engines on
    the phase-4 weights, each with its own pool). Each request, one at a
    time: prefill with hold_kv and max_tokens 1, export_held,
    import_request on the decode replica, decode to completion; the tokens
    must equal the decode replica serving the same request alone. One
    request moves mid-decode (export_running -> import_request). Then one
    1024-token prefix goes export_prefix -> begin/import_prefix_chunk/
    commit, and a prompt extending it hits the imported pages, with tokens
    equal to the prefill replica (which hits its own cached pages)."""
    from kubernetes_gpu_cluster_tpu_torch.config import (CacheConfig,
                                                         SchedulerConfig)
    from kubernetes_gpu_cluster_tpu_torch.engine import (LLMEngine,
                                                         SamplingParams)
    cfg = cfg_engine.model
    ps = cfg_engine.cache.page_size
    cfg_pair = dataclasses.replace(
        cfg_engine, cache=CacheConfig(page_size=ps, num_pages=HANDOFF_PAGES),
        scheduler=SchedulerConfig(max_num_seqs=8,
                                  enable_prefix_caching=True))
    pre = LLMEngine(cfg_pair, params=params, device=device)
    dec = LLMEngine(cfg_pair, params=params, device=device)
    rng = np.random.default_rng(SEED + 12)
    sp = SamplingParams(max_tokens=32, temperature=0.0)
    warm = [int(t) for t in rng.integers(1, cfg.vocab_size, 64)]
    for eng in (pre, dec):
        _serve_one(eng, "warm", warm, sp)
    for mod in counters.values():
        mod.launches = 0
    handoffs = []
    for i, n in enumerate((300, 700, 1100, 1500)):
        prompt = [int(t) for t in rng.integers(1, cfg.vocab_size, n)]
        ref = _serve_one(dec, f"colo-{i}", prompt, sp)
        pre.add_request(f"pf-{i}", prompt,
                        dataclasses.replace(sp, max_tokens=1), hold_kv=True)
        while pre.has_unfinished_requests():
            pre.step()
        _sync(device)
        t0 = time.perf_counter()
        state = pre.export_held(f"pf-{i}")
        t_exp = time.perf_counter() - t0
        nbytes = state["k"].nbytes + state["v"].nbytes
        t0 = time.perf_counter()
        outs = dec.import_request(f"dc-{i}", prompt, sp, state)
        _sync(device)
        t_imp = time.perf_counter() - t0
        got = list(outs[0].output_token_ids)
        while dec.has_unfinished_requests():
            for o in dec.step():
                if o.request_id == f"dc-{i}" and o.finished:
                    got = list(o.output_token_ids)
        if got != ref:
            raise RuntimeError(f"8b: handoff of {n}-token prompt differs "
                               f"from colocated: {got[:8]} vs {ref[:8]}")
        handoffs.append({"prompt": n, "pages": state["k"].shape[1],
                         "bytes": nbytes, "export_ms": t_exp * 1e3,
                         "export_gb_s": nbytes / t_exp / 1e9,
                         "import_ms": t_imp * 1e3,
                         "import_gb_s": nbytes / t_imp / 1e9})
    migration = _migrate_one(pre, dec, rng, sp, device)
    prefix = [int(t) for t in rng.integers(1, cfg.vocab_size, PREFIX_TOKENS)]
    ext = [int(t) for t in rng.integers(1, cfg.vocab_size, 200)]
    _serve_one(pre, "pfx", prefix + ext[:1],
               dataclasses.replace(sp, max_tokens=1))
    _sync(device)
    t0 = time.perf_counter()
    state = pre.export_prefix(prefix + ext)
    t_exp = time.perf_counter() - t0
    if state["matched_tokens"] != PREFIX_TOKENS:
        raise RuntimeError(f"8b: exported {state['matched_tokens']} prefix "
                           f"tokens, expected {PREFIX_TOKENS}")
    nbytes = state["k"].nbytes + state["v"].nbytes
    t0 = time.perf_counter()
    handle = dec.begin_prefix_import(
        {k: v for k, v in state.items() if k not in ("k", "v")})
    for j in range(0, state["k"].shape[1], 16):
        dec.import_prefix_chunk(handle, state["k"][:, j:j + 16],
                                state["v"][:, j:j + 16])
    dec.commit_prefix_import(handle)
    _sync(device)
    t_imp = time.perf_counter() - t0
    if dec.prefix_peek(prefix + ext) != PREFIX_TOKENS:
        raise RuntimeError("8b: the imported prefix is not in the cache")
    hits0 = dec.scheduler.prefix_cache.hits
    got = _serve_one(dec, "ext-dc", prefix + ext, sp)
    hit = dec.scheduler.prefix_cache.hits - hits0
    ref = _serve_one(pre, "ext-colo", prefix + ext, sp)
    if hit != 1 or got != ref:
        raise RuntimeError(f"8b: prefix import hit {hit}; tokens "
                           f"{'equal' if got == ref else 'differ'}")
    launches = {name: mod.launches for name, mod in counters.items()}
    for name, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"8b: kernel {name} never launched")
    del pre, dec
    gc.collect()
    torch.cuda.empty_cache()
    return {"handoffs": handoffs, "handoff_tokens_identical": len(handoffs),
            "migration": migration,
            "prefix": {"tokens": PREFIX_TOKENS, "bytes": nbytes,
                       "export_ms": t_exp * 1e3,
                       "export_gb_s": nbytes / t_exp / 1e9,
                       "import_ms": t_imp * 1e3,
                       "import_gb_s": nbytes / t_imp / 1e9,
                       "cache_hit": hit, "tokens_identical": got == ref},
            "launches": launches}


def _migrate_one(src, dst, rng, sp, device) -> dict:
    """Live migration of one request between two engines: decode on
    ``src`` until at least nine tokens are out, ``export_running``, drain
    ``src``, ``import_request`` on ``dst`` and decode to the end; the tokens
    must equal ``dst`` serving the request uninterrupted."""
    prompt = [int(t) for t in rng.integers(1, src.model_config.vocab_size,
                                           900)]
    ref = _serve_one(dst, "mig-colo", prompt, sp)
    src.add_request("mig", prompt, sp)
    done = []
    while len(done) < 9:
        if not src.has_unfinished_requests():
            raise RuntimeError("8b: the request to migrate left the engine")
        for o in src.step():
            if o.request_id == "mig":
                if o.finished:
                    raise RuntimeError("8b: the request to migrate finished")
                done = list(o.output_token_ids)
    _sync(device)
    t0 = time.perf_counter()
    state = src.export_running("mig")
    t_exp = time.perf_counter() - t0
    while src.has_unfinished_requests():
        src.step()
    moved = len(state["output_token_ids"])
    nbytes = state["k"].nbytes + state["v"].nbytes
    outs = dst.import_request("mig-dc", prompt, sp, state)
    got = list(outs[0].output_token_ids)
    while dst.has_unfinished_requests():
        for o in dst.step():
            if o.request_id == "mig-dc" and o.finished:
                got = list(o.output_token_ids)
    if got != ref:
        raise RuntimeError(f"8b: migrated request differs from "
                           f"uninterrupted: {got} vs {ref}")
    return {"prompt": len(prompt), "tokens_moved": moved,
            "pages": state["k"].shape[1], "bytes": nbytes,
            "export_ms": t_exp * 1e3, "export_gb_s": nbytes / t_exp / 1e9,
            "tokens_identical": True}


def check_prefix_spill(cfg_engine, params, device, counters) -> dict:
    """Phase 8c: the prefix cache's host spill tier on the phase-4 weights.
    A ``SPILL_PAGES`` engine with prefix caching and a pinned host tier
    (``spill``) and a 1024-page engine that never evicts (``keep``) each
    serve a prompt behind a 512-token prefix; three 1500-token prompts
    churn ``spill``'s cache, so every page of that prefix spills to the
    host. ``export_prefix`` of it reads the host tier in place and must
    equal ``keep``'s export of its device pages byte for byte. Counted
    run: a second prompt behind the prefix second-chances every spilled
    page (one host-to-device copy each) and prefills its suffix through
    the history kernel; its tokens must equal ``keep``'s, served from
    device pages. Last, ``keep`` exports a 256-token prefix page by page
    into ``spill``'s host tier (``accept_remote_spill``), and a prompt
    behind it restores those pages, with tokens equal to ``keep``'s."""
    from kubernetes_gpu_cluster_tpu_torch.config import (CacheConfig,
                                                         SchedulerConfig)
    from kubernetes_gpu_cluster_tpu_torch.engine import (LLMEngine,
                                                         SamplingParams)
    from kubernetes_gpu_cluster_tpu_torch.engine.kv_cache import PrefixCache
    cfg = cfg_engine.model
    ps = cfg_engine.cache.page_size
    sched = SchedulerConfig(max_num_seqs=8, enable_prefix_caching=True)
    spill = LLMEngine(dataclasses.replace(
        cfg_engine, scheduler=sched,
        cache=CacheConfig(page_size=ps, num_pages=SPILL_PAGES,
                          swap_space_gb=SPILL_GB)),
        params=params, device=device)
    keep = LLMEngine(dataclasses.replace(
        cfg_engine, scheduler=sched,
        cache=CacheConfig(page_size=ps, num_pages=HANDOFF_PAGES)),
        params=params, device=device)
    pc = spill.scheduler.prefix_cache
    rng = np.random.default_rng(SEED + 13)

    def toks(n):
        return [int(t) for t in rng.integers(1, cfg.vocab_size, n)]

    sp = SamplingParams(max_tokens=32, temperature=0.0)
    one = dataclasses.replace(sp, max_tokens=1)
    shared, remote = toks(SHARED_TOKENS), toks(REMOTE_TOKENS)
    first, second = shared + toks(64), shared + toks(200)
    for eng in (spill, keep):
        _serve_one(eng, "first", first, sp)
    for i in range(3):
        _serve_one(spill, f"churn-{i}", toks(1500), one)
    n_shared = SHARED_TOKENS // ps
    digests = list(PrefixCache._page_digests(shared, n_shared, ps))
    on_host = sum(d in pc._host_entries for d in digests)
    if on_host != n_shared:
        raise RuntimeError(f"8c: {on_host} of the prefix's {n_shared} pages "
                           f"spilled to the host")
    _sync(device)
    t0 = time.perf_counter()
    got_state = spill.export_prefix(second)
    t_exp = time.perf_counter() - t0
    want_state = keep.export_prefix(second)
    if not (got_state["matched_tokens"] == SHARED_TOKENS
            and torch.equal(got_state["k"], want_state["k"])
            and torch.equal(got_state["v"], want_state["v"])):
        raise RuntimeError("8c: the export read from the host tier differs "
                           "from the device pages it spilled")
    nbytes = got_state["k"].nbytes + got_state["v"].nbytes
    for mod in counters.values():
        mod.launches = 0
    hits0 = pc.host_hits
    got = _serve_one(spill, "second", second, sp)
    launches = {name: mod.launches for name, mod in counters.items()}
    host_hits = pc.host_hits - hits0
    want = _serve_one(keep, "second", second, sp)
    log("prefix spill counted run: host hits", host_hits, "launches:",
        json.dumps(launches))
    if host_hits != n_shared:
        raise RuntimeError(f"8c: {host_hits} host hits, expected {n_shared}")
    # The suffix prefills over the restored history: no ragged prefill.
    for name in ("paged_decode", "flash_prefill_hist"):
        if launches.get(name, 1) <= 0:
            raise RuntimeError(f"8c: kernel {name} never launched")
    if got != want:
        raise RuntimeError("8c: tokens after the host restore differ from "
                           "the engine that kept the prefix on the card")
    _serve_one(keep, "remote", remote + toks(64), one)
    tail = remote + toks(150)
    st = keep.export_prefix(tail)
    n_remote = REMOTE_TOKENS // ps
    accepted = sum(spill.accept_remote_spill(
        d.hex(), st["k"][:, j:j + 1], st["v"][:, j:j + 1])
        for j, d in enumerate(PrefixCache._page_digests(tail, n_remote, ps)))
    hits0 = pc.host_hits
    got = _serve_one(spill, "remote", tail, sp)
    remote_hits = pc.host_hits - hits0
    want = _serve_one(keep, "remote-2", tail, sp)
    if accepted != n_remote or remote_hits != n_remote or got != want:
        raise RuntimeError(f"8c: {accepted} remote spills accepted, "
                           f"{remote_hits} restored, tokens "
                           f"{'equal' if got == want else 'differ'}")
    host = spill.swapper.host
    if host.num_in_use != len(pc._host_entries):
        raise RuntimeError(f"8c: {host.num_in_use} host pages in use for "
                           f"{len(pc._host_entries)} spilled entries")
    out = {"host_entries": len(pc._host_entries), "host_hits": host_hits, "remote_spills_accepted": accepted,
           "remote_host_hits": remote_hits,
           "export_from_host": {"pages": n_shared, "bytes": nbytes,
                                "ms": t_exp * 1e3,
                                "gb_s": nbytes / t_exp / 1e9},
           "tokens_identical": 2, "launches": launches}
    del spill, keep, pc, host
    gc.collect()
    torch.cuda.empty_cache()
    return out


async def _streams(aeng, prompts, sp) -> list:
    async def one(i, prompt):
        toks, chunks = [], 0
        async for chunk in aeng.generate(f"async-{i}", prompt, sp):
            toks += chunk.new_token_ids
            chunks += 1
        return toks, chunks
    aeng.start()
    try:
        return await asyncio.gather(*(one(i, p) for i, p in enumerate(prompts)))
    finally:
        aeng.shutdown()


def check_async(cfg_engine, params, device) -> dict:
    from kubernetes_gpu_cluster_tpu_torch.engine import SamplingParams
    from kubernetes_gpu_cluster_tpu_torch.serving.async_engine import \
        AsyncLLMEngine
    aeng = AsyncLLMEngine(cfg_engine, params=params, device=device)
    rng = np.random.default_rng(SEED + 3)
    prompts = [[int(t) for t in rng.integers(1, cfg_engine.model.vocab_size,
                                             int(n))]
               for n in (64, 300, 900, 17)]
    sp = SamplingParams(max_tokens=24, temperature=0.0)
    results = asyncio.run(_streams(aeng, prompts, sp))
    for toks, chunks in results:
        if len(toks) != sp.max_tokens:
            raise RuntimeError(f"async stream ended with {len(toks)} tokens")
    return {"streams": len(results),
            "chunks": [c for _, c in results]}


# ---------------------------------------------------------------------------
# Phase 9: the OpenAI server (in process on the phase-4 weights; the CLI)
# ---------------------------------------------------------------------------

REPO = Path(__file__).resolve().parent
SERVER_PAGES = 1024
SERVER_SEQS = 16
SEQ_PROMPTS = (64, 300, 900, 2500)   # 2500 > the 2048-token prefill budget
SEQ_TOKENS = 32
CLI_MODEL = ["--model", "tinyllama-1.1b", "--quantization", "int4",
             "--quant-group-size", "128"]
CLI_LONG_PROMPT = 1500               # alone while another decodes: mixed
# Filled by _record_ids: the token ids each engine request produced.
_PRODUCED: dict = {}


async def http_call(port: int, method: str, path: str, body=None,
                    headers=None, close_after_first: bool = False,
                    on_data=None) -> dict:
    """One HTTP/1.1 request to 127.0.0.1 on its own connection, through the
    port's client (``serving/http.py``; the card's machine has no HTTP
    client library): status, headers, body, for a chunked (SSE) body the
    seconds to its first ``data:`` frame, and whether the connection was
    cut inside the body. ``close_after_first`` closes the connection right
    after that frame; ``on_data(raw)`` sees the body as it grows."""
    from kubernetes_gpu_cluster_tpu_torch.serving.http import (ClientError,
                                                               ClientSession)
    t0 = time.perf_counter()
    url = f"http://127.0.0.1:{port}{path}"
    sess = ClientSession()
    call = (sess.get(url, headers=headers, timeout_s=600) if method == "GET"
            else sess.post(url, json=body, headers=headers, timeout_s=600))
    raw, first, severed = bytearray(), None, False
    async with call as r:
        sse = "chunked" in r.headers.get("Transfer-Encoding", "")
        try:
            async for piece in r.iter_chunked(1 << 16):
                raw += piece
                if sse and first is None and b"data: " in raw:
                    first = time.perf_counter() - t0
                    if close_after_first:
                        break
                if on_data is not None:
                    on_data(raw)
        except ClientError:
            severed = True
        return {"status": r.status, "headers": r.headers, "raw": raw,
                "body": raw.decode("utf-8", errors="replace"),
                "ttft_s": first, "e2e_s": time.perf_counter() - t0,
                "severed": severed}


def sse_frames(body: str) -> list:
    frames = [ln[len("data: "):] for ln in body.splitlines()
              if ln.startswith("data: ")]
    if not frames or frames[-1] != "[DONE]":
        raise RuntimeError(f"stream did not end in [DONE]: {body[-200:]!r}")
    return [json.loads(f) for f in frames[:-1]]


def _record_ids(aeng) -> None:
    """Wrap the server's ``AsyncLLMEngine.generate``: every engine request's
    output token ids land in ``_PRODUCED`` (random weights over a
    128256-token vocabulary make the byte tokenizer's text mostly empty)."""
    inner = aeng.generate

    async def generate(rid, ids, params, **kw):
        async for chunk in inner(rid, ids, params, **kw):
            _PRODUCED[rid] = list(chunk.output_token_ids)
            yield chunk
    aeng.generate = generate


def _metric(text: str, name: str, missing=None) -> float:
    """The value of the series ``name``; ``missing`` when it is not
    rendered (a labelled histogram renders once observed), else an
    error."""
    lines = [ln for ln in text.splitlines() if ln.startswith(name + " ")]
    if not lines and missing is not None:
        return missing
    [line] = lines
    return float(line.split()[-1])


async def _serve_9a(api, prompts, ref, vocab, counters) -> dict:
    from kubernetes_gpu_cluster_tpu_torch.serving.http import Server
    from kubernetes_gpu_cluster_tpu_torch.serving.tokenizer import \
        ByteTokenizer
    tok = ByteTokenizer()
    eng = api.engine.engine
    srv = Server(api.build_app())
    await srv.start("127.0.0.1", 0)
    port = srv.port
    out = {}
    try:
        # 9a.1 sequential: each prompt plain, then streamed.
        seq = []
        for i, prompt in enumerate(prompts):
            body = {"prompt": prompt, "max_tokens": SEQ_TOKENS,
                    "temperature": 0.0}
            plain = await http_call(port, "POST", "/v1/completions", body,
                                    {"x-kgct-request-id": f"seq{i}-plain"})
            sse = await http_call(port, "POST", "/v1/completions",
                                  dict(body, stream=True),
                                  {"x-kgct-request-id": f"seq{i}-sse"})
            if plain["status"] != 200 or sse["status"] != 200:
                raise RuntimeError(f"seq{i}: {plain['status']} "
                                   f"{sse['status']} {plain['body'][:300]}")
            a, b = _PRODUCED[f"seq{i}-plain"], _PRODUCED[f"seq{i}-sse"]
            doc = json.loads(plain["body"])
            text_sse = "".join(f["choices"][0]["text"]
                               for f in sse_frames(sse["body"]))
            if a != b:
                raise RuntimeError(f"seq{i}: plain and streamed ids differ")
            if doc["choices"][0]["text"] != tok.decode(a) or \
                    text_sse != tok.decode(b):
                raise RuntimeError(f"seq{i}: text is not decode(ids)")
            if doc["usage"] != {"prompt_tokens": len(prompt),
                                "completion_tokens": len(a),
                                "total_tokens": len(prompt) + len(a)}:
                raise RuntimeError(f"seq{i}: usage {doc['usage']}")
            seq.append({"prompt": len(prompt), "tokens": len(a),
                        "equal_to_engine": a == ref[i],
                        "plain_e2e_s": plain["e2e_s"],
                        "sse_ttft_s": sse["ttft_s"],
                        "sse_e2e_s": sse["e2e_s"]})
        out["sequential"] = seq

        # 9a.2-3 concurrent, with the admission check under load.
        rng = np.random.default_rng(SEED + 10)
        metrics0 = (await http_call(port, "GET", "/metrics"))["body"]
        reqs = []
        for i in range(16):
            kind = "chat" if i % 4 == 3 else "completion"
            body = {"max_tokens": 128, "temperature": 0.0,
                    "stream": i % 2 == 1}
            if kind == "chat":
                body["messages"] = [{"role": "user",
                                     "content": f"request {i}: say more"}]
            else:
                n = SEQ_PROMPTS[-1] if i == 0 else int(rng.integers(32,
                                                                    600))
                body["prompt"] = [int(t) for t in rng.integers(1, vocab, n)]
            if i == 2:
                body["logprobs"] = 2
            elif kind == "completion" and body["stream"]:
                # A frame per engine chunk (random ids mostly decode to no
                # text), so the first frame times the first token.
                body["logprobs"] = 1
            if i == 4:
                body.update(n=2, seed=77, temperature=0.8)
            path = ("/v1/chat/completions" if kind == "chat"
                    else "/v1/completions")
            reqs.append((path, body))
        for mod in counters.values():
            mod.launches = 0
        tasks = [asyncio.ensure_future(http_call(port, "POST", p, b))
                 for p, b in reqs[:8]]
        deadline = time.monotonic() + 120
        while not eng.scheduler.running:
            if time.monotonic() > deadline:
                raise RuntimeError("first wave never started")
            await asyncio.sleep(0.01)
        tasks += [asyncio.ensure_future(http_call(port, "POST", p, b))
                  for p, b in reqs[8:]]
        while len(eng.scheduler.waiting) + len(eng.scheduler.running) < 16:
            if time.monotonic() > deadline or all(t.done() for t in tasks):
                raise RuntimeError("the 16 requests never queued together")
            await asyncio.sleep(0.005)
        shed = await http_call(port, "POST", "/v1/completions",
                               {"prompt": [5, 6, 7], "max_tokens": 4},
                               {"x-kgct-ttft-budget-ms": "0.001"})
        health = json.loads((await http_call(port, "GET", "/health"))["body"])
        if shed["status"] != 429 or "retry-after" not in shed["headers"]:
            raise RuntimeError(f"budget request not shed: {shed['status']} "
                               f"{shed['headers']}")
        if health["waiting"] + health["running"] <= 0:
            raise RuntimeError(f"/health under load: {health}")
        results = await asyncio.gather(*tasks)
        for (path, body), r in zip(reqs, results):
            if r["status"] != 200:
                raise RuntimeError(f"{path}: {r['status']} {r['body'][:300]}")
            if body["stream"]:
                sse_frames(r["body"])
        deadline = time.monotonic() + 10
        while eng.has_unfinished_requests():
            if time.monotonic() > deadline:
                raise RuntimeError("engine not idle after the concurrent "
                                   "requests")
            await asyncio.sleep(0.01)
        launches = {n: m.launches for n, m in counters.items()}
        if min(launches.values()) <= 0:
            raise RuntimeError(f"kernels not launched by the server: "
                               f"{launches}")
        metrics1 = (await http_call(port, "GET", "/metrics"))["body"]
        n_req = (_metric(metrics1, "kgct_requests_total")
                 - _metric(metrics0, "kgct_requests_total"))
        hbm = _metric(metrics1, "kgct_hbm_bytes_in_use")
        if n_req != 16 or hbm <= 0:
            raise RuntimeError(f"/metrics: {n_req} requests, {hbm} bytes")
        out["concurrent"] = {
            "launches": launches, "requests_total_delta": n_req,
            "hbm_bytes_in_use": hbm,
            "shed": {"status": shed["status"],
                     "retry_after": shed["headers"]["retry-after"],
                     "health": {k: health[k] for k in ("waiting",
                                                       "running")}},
            "ttft_s": [r["ttft_s"] for r in results if r["ttft_s"]],
            "e2e_s": [r["e2e_s"] for r in results]}

        # 9a.4 disconnect after the first frame of a 400-token stream
        # (logprobs: a frame per engine chunk, so the first comes early).
        cut = await http_call(port, "POST", "/v1/completions",
                              {"prompt": [9] * 50, "max_tokens": 400,
                               "temperature": 0.0, "stream": True,
                               "logprobs": 1},
                              close_after_first=True)
        t0 = time.monotonic()
        while eng.has_unfinished_requests():
            if time.monotonic() - t0 > 10:
                raise RuntimeError("a closed stream kept the engine busy")
            await asyncio.sleep(0.01)
        idle_s = time.monotonic() - t0
        alive = await http_call(port, "POST", "/v1/completions",
                                {"prompt": [9] * 8, "max_tokens": 4,
                                 "temperature": 0.0})
        n_cut = len(_PRODUCED[cut["headers"]["x-kgct-request-id"]])
        if cut["ttft_s"] is None or n_cut >= 400 or alive["status"] != 200:
            raise RuntimeError(f"disconnect: first frame {cut['ttft_s']}, "
                               f"{n_cut} tokens, then {alive['status']}")
        out["disconnect"] = {"idle_after_s": idle_s,
                             "tokens_seen_before_abort": n_cut}

        # 9a.5 drain with a stream in flight.
        reader_task = asyncio.ensure_future(http_call(
            port, "POST", "/v1/completions",
            {"prompt": [11] * 40, "max_tokens": 64, "temperature": 0.0,
             "stream": True}))
        while not eng.scheduler.running:
            await asyncio.sleep(0.005)
        drained = []
        task = api.begin_drain(on_drained=lambda: drained.append(1))
        h = await http_call(port, "GET", "/health")
        new = await http_call(port, "POST", "/v1/completions",
                              {"prompt": [1, 2], "max_tokens": 2})
        inflight = await reader_task
        await asyncio.wait_for(task, 60)
        frames = sse_frames(inflight["body"])
        if (h["status"], new["status"], inflight["status"]) != \
                (503, 503, 200) or drained != [1]:
            raise RuntimeError(f"drain: health {h['status']}, new "
                               f"{new['status']}, stream "
                               f"{inflight['status']}, drained {drained}")
        out["drain"] = {"health": h["status"], "new_request": new["status"],
                        "inflight_frames": len(frames)}
    finally:
        await srv.close()
    return out


def check_server(cfg_engine, params, device, counters) -> dict:
    """Phase 9a: the OpenAI server in this process on the phase-4 weights
    (a 1024-page pool, 16 seats, the byte tokenizer)."""
    from kubernetes_gpu_cluster_tpu_torch.config import (CacheConfig,
                                                         SchedulerConfig)
    from kubernetes_gpu_cluster_tpu_torch.engine import SamplingParams
    from kubernetes_gpu_cluster_tpu_torch.serving import build_server
    os.environ["KGCT_FLIGHT_DIR"] = str(REPO / "build" / "flight")
    cfg = cfg_engine.model
    cfg_server = dataclasses.replace(
        cfg_engine,
        cache=CacheConfig(page_size=cfg_engine.cache.page_size,
                          num_pages=SERVER_PAGES),
        scheduler=SchedulerConfig(max_num_seqs=SERVER_SEQS))
    api = build_server(cfg_server, params=params, device=device,
                       model_name=MODEL)
    eng = api.engine.engine
    rng = np.random.default_rng(SEED + 9)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)]
               for n in SEQ_PROMPTS]
    sp = SamplingParams(max_tokens=SEQ_TOKENS, temperature=0.0)
    # Each prompt alone through LLMEngine.generate on the server's own
    # engine, before its worker starts: batch-1 shapes, as over HTTP.
    ref = [list(eng.generate([p], sp)[0].output_token_ids) for p in prompts]
    _record_ids(api.engine)
    out = asyncio.run(_serve_9a(api, prompts, ref, cfg.vocab_size,
                                counters))
    diverged, faults = [], []
    for i, (row, prompt) in enumerate(zip(out["sequential"], prompts)):
        if row["equal_to_engine"]:
            continue
        a, b = _PRODUCED[f"seq{i}-plain"], ref[i]
        j = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        gap, std = _top2_gap(params, cfg, prompt + b[:j], device)
        log(f"server/engine divergence seq{i} at output {j}: top-2 gap "
            f"{gap} logit std {std} ({gap / std:.3g} of it)")
        diverged.append({"seq": i, "at": j, "gap_over_std": gap / std})
        if gap >= NEAR_TIE * std:
            faults.append(i)
    if faults:
        raise RuntimeError(f"HTTP tokens differ from LLMEngine.generate "
                           f"beyond a near-tie for prompts {faults}")
    out["divergences"] = diverged
    del api, eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _kernel_names() -> dict:
    """Each CUDA source's ``__global__`` function names."""
    from kubernetes_gpu_cluster_tpu_torch.ops.cuda import build
    import re
    names = {}
    for name in build.KERNELS:
        src = (build.CSRC / f"{name}.cu").read_text()
        names[name] = re.findall(r"__global__[^\n]*\n\s*(\w+)\s*\(", src)
    return names


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def _drive_cli(port: int, proc, vocab: int) -> dict:
    deadline = time.monotonic() + 600
    while True:
        if proc.poll() is not None:
            raise RuntimeError(f"the CLI server exited with {proc.returncode}")
        try:
            if (await http_call(port, "GET", "/health"))["status"] == 200:
                break
        except OSError:
            pass
        if time.monotonic() > deadline:
            raise RuntimeError("the CLI server never answered /health")
        await asyncio.sleep(0.5)
    up_s = 600 - (deadline - time.monotonic())
    rng = np.random.default_rng(SEED + 11)

    def ids(n):
        return [int(t) for t in rng.integers(1, vocab, n)]
    first = [
        await http_call(port, "POST", "/v1/completions",
                        {"prompt": ids(100), "max_tokens": 16,
                         "temperature": 0.0}),
        await http_call(port, "POST", "/v1/completions",
                        {"prompt": ids(100), "max_tokens": 16,
                         "temperature": 0.0, "stream": True}),
        await http_call(port, "POST", "/v1/chat/completions",
                        {"messages": [{"role": "user", "content": "hello"}],
                         "max_tokens": 16, "temperature": 0.0}),
    ]
    sse_frames(first[1]["body"])
    # The long request decodes while the profiler runs. Inside the window
    # one prompt arrives alone (a mixed step: its chunk through the history
    # kernel), then, once it is served, a wave of short prompts (a packed
    # prefill step: flash_prefill). The profiler's start may hold the
    # server's loop, so the first arrival waits a second.
    long = asyncio.ensure_future(http_call(
        port, "POST", "/v1/completions",
        {"prompt": ids(64), "max_tokens": 300, "temperature": 0.0,
         "stream": True}))
    await asyncio.sleep(1.0)
    prof = asyncio.ensure_future(http_call(port, "POST",
                                           "/debug/profile?seconds=2"))
    await asyncio.sleep(1.0)
    wave = [await http_call(port, "POST", "/v1/completions",
                            {"prompt": ids(CLI_LONG_PROMPT), "max_tokens": 4,
                             "temperature": 0.0})]
    wave += await asyncio.gather(*(http_call(
        port, "POST", "/v1/completions",
        {"prompt": ids(n), "max_tokens": 4, "temperature": 0.0})
        for n in (120, 130, 140)))
    rest = wave + [await long]
    prof = await prof
    for r in first + rest:
        if r["status"] != 200:
            raise RuntimeError(f"CLI request: {r['status']} "
                               f"{r['body'][:300]}")
    if prof["status"] != 200:
        raise RuntimeError(f"/debug/profile: {prof['status']} {prof['body']}")
    trace_dir = Path(json.loads(prof["body"])["trace_dir"])
    [trace] = sorted(trace_dir.glob("trace-*.json"))
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    found = {mod: sum(any(n in k for n in names) for k in kernels)
             for mod, names in _kernel_names().items()}
    if min(found.values()) <= 0:
        raise RuntimeError(f"profiler trace lacks kernels: {found} "
                           f"({len(kernels)} kernel events)")
    return {"health_after_s": up_s, "requests": len(first) + len(rest),
            "trace_mb": trace.stat().st_size / 2 ** 20,
            "kernel_events": len(kernels), "by_source": found}


def check_cli(vocab: int) -> dict:
    """Phase 9b: the CLI on the card in a subprocess (tinyllama-1.1b int4):
    requests, a profiler capture holding all four kernels, SIGTERM exit 0
    within the drain grace."""
    import signal
    port = _free_port()
    work = REPO / "build" / "cli-9b"
    work.mkdir(parents=True, exist_ok=True)
    for old in work.glob("kgct-profile/trace-*.json"):
        old.unlink()
    env = dict(os.environ, TMPDIR=str(work),
               KGCT_FLIGHT_DIR=str(work / "flight"),
               PYTHONPATH=os.pathsep.join(
                   [str(REPO)] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    cmd = [sys.executable, "-m",
           "kubernetes_gpu_cluster_tpu_torch.serving.api_server",
           *CLI_MODEL, "--max-num-seqs", "8",
           "--hbm-utilization", "0.3", "--host", "127.0.0.1",
           "--port", str(port)]
    log_path = work / "server.log"
    with open(log_path, "w") as logf:
        proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=logf,
                                stderr=subprocess.STDOUT)
        try:
            out = asyncio.run(_drive_cli(port, proc, vocab))
            t0 = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=DRAIN_GRACE_S)
            out["sigterm_exit_s"] = time.perf_counter() - t0
            if rc != 0:
                raise RuntimeError(f"the CLI server exited {rc} on SIGTERM")
        except BaseException:
            logf.flush()
            log("CLI server output (tail):\n"
                + log_path.read_text()[-6000:])
            raise
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


# ---------------------------------------------------------------------------
# Phase 10: the fleet plane (in process on the phase-4 weights)
# ---------------------------------------------------------------------------

FLEET_PAGES = 1024
FLEET_SEQS = 8
DISAGG_PROMPTS = (64, 300, 700, 1100, 1500, 2500)
DISAGG_TOKENS = 32
# 10a's request shapes by prompt index: streamed (logprobs 1, so a frame
# per engine chunk times the first token), logprobs 2, seeded sampled.
DISAGG_STREAMED = (1, 4)
DISAGG_LOGPROBS = 2
DISAGG_SEEDED = 3
CODEC_PROMPT = 1500                  # 10e times the codec on its state
FLEET_PREFIX = 1024
FLEET_SUFFIX = 200
SPILL_PREFIX = 512                   # 32 pages: the spill queue's cap
SPILL_SUFFIX = 15                    # under a page: no page of its own
SPILL_HOST_GB = 1.0
MIGRATE_PROMPT = 1024
MIGRATE_TOKENS = 400
MIGRATE_AFTER = 16                   # relayed tokens before the drain
FLOPS_PROMPTS = (512, 512, 512, 512)  # one packed 2048-token prefill step


def _first_diff(a: list, b: list) -> int:
    return next((k for k, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def _held_to(what, got, ref, prompt, params, cfg, device, ties) -> None:
    """``got`` equals ``ref`` but where the top-2 logit gap at the first
    differing position is below NEAR_TIE of the logits' deviation (counted
    in ``ties``); anything else fails the run."""
    if got == ref:
        return
    j = _first_diff(got, ref)
    gap, std = _top2_gap(params, cfg, prompt + ref[:j], device)
    log(f"{what}: tokens differ at output {j}: top-2 gap {gap} logit "
        f"std {std} ({gap / std:.3g} of it)")
    if gap >= NEAR_TIE * std:
        raise RuntimeError(f"{what}: tokens differ from the reference "
                           f"beyond a near-tie at output {j}")
    ties.append({"what": what, "at": j, "gap_over_std": gap / std})


def _ledger(raw: bytes) -> tuple[list, bool]:
    """(token ledger of the SSE frames, whether ``[DONE]`` ended them)."""
    ids, done = [], False
    for ln in raw.decode("utf-8", errors="replace").splitlines():
        if ln == "data: [DONE]":
            done = True
        elif ln.startswith("data: {"):
            ids += json.loads(ln[6:]).get("kgct_token_ids", [])
    return ids, done


async def _metrics(port: int) -> str:
    return (await http_call(port, "GET", "/metrics"))["body"]


async def _fleet_10abd(srv, refs, prompts, ctx) -> dict:
    """10a disaggregated serving, 10b wire chaos, 10d drain-time live
    migration, on servers P (prefill), D (decode) and C (colocated)."""
    from kubernetes_gpu_cluster_tpu_torch.resilience.faults import \
        configure_faults
    from kubernetes_gpu_cluster_tpu_torch.serving.errors import (
        MIGRATE_URL_HEADER, PREFILL_URL_HEADER, REQUEST_ID_HEADER,
        RESUME_MODE_HEADER)
    from kubernetes_gpu_cluster_tpu_torch.serving.http import Server
    running = []
    for name in ("P", "D", "C"):
        server = Server(srv[name]["api"].build_app())
        await server.start("127.0.0.1", srv[name]["port"])
        running.append(server)
    port = {n: srv[n]["port"] for n in srv}
    url = {n: srv[n]["url"] for n in srv}
    out = {}
    try:
        # 10a: six requests to D, each pulled from P; each also to C.
        rows = []
        for i, prompt in enumerate(prompts["a"]):
            body = {"prompt": prompt, "max_tokens": DISAGG_TOKENS,
                    "temperature": 0.0}
            if i in DISAGG_STREAMED:
                body.update(stream=True, logprobs=1)
            elif i == DISAGG_LOGPROBS:
                body["logprobs"] = 2
            elif i == DISAGG_SEEDED:
                body.update(temperature=0.8, seed=7)
            m0 = await _metrics(port["D"])
            p0 = await _metrics(port["P"])
            dec = await http_call(
                port["D"], "POST", "/v1/completions", body,
                {PREFILL_URL_HEADER: url["P"],
                 REQUEST_ID_HEADER: f"10a-{i}-dec"})
            m1 = await _metrics(port["D"])
            p1 = await _metrics(port["P"])
            if dec["status"] != 200:
                raise RuntimeError(f"10a-{i}: {dec['status']} "
                                   f"{dec['body'][:300]}")
            got = _PRODUCED[f"10a-{i}-dec"]
            colo = None
            if body.get("stream"):
                if not dec["body"].rstrip().endswith("data: [DONE]"):
                    raise RuntimeError(f"10a-{i}: stream did not end in "
                                       "[DONE]")
                # The same stream colocated on C: the TTFT beside D's.
                colo = await http_call(
                    port["C"], "POST", "/v1/completions", body,
                    {REQUEST_ID_HEADER: f"10a-{i}-colo"})
                ctx["held"](f"10a-{i} colocated",
                            _PRODUCED[f"10a-{i}-colo"], refs["a"][i],
                            prompt)
            if i == DISAGG_SEEDED:
                if not 0 < len(got) <= DISAGG_TOKENS:
                    raise RuntimeError(f"10a-{i}: sampled {len(got)} "
                                       "tokens")
            else:
                ctx["held"](f"10a-{i} decode", got, refs["a"][i], prompt)
            if i == DISAGG_LOGPROBS:
                lp = json.loads(dec["body"])["choices"][0]["logprobs"]
                if len(lp["top_logprobs"]) != len(got):
                    raise RuntimeError(f"10a-{i}: logprobs {lp}")
            key_b = 'kgct_disagg_kv_bytes_total{side="%s"}'
            key_s = 'kgct_disagg_handoff_seconds_sum{side="%s"}'
            nbytes = _metric(m1, key_b % "import") - _metric(m0,
                                                             key_b % "import")
            secs = (_metric(m1, key_s % "import", 0.0)
                    - _metric(m0, key_s % "import", 0.0))
            exp_s = (_metric(p1, key_s % "export", 0.0)
                     - _metric(p0, key_s % "export", 0.0))
            rows.append({"prompt": len(prompt), "tokens": len(got),
                         "stream": bool(body.get("stream")),
                         "bytes": nbytes, "import_s": secs,
                         "import_gb_s": nbytes / secs / 1e9,
                         "export_s": exp_s,
                         "decode_ttft_s": dec["ttft_s"],
                         "decode_e2e_s": dec["e2e_s"],
                         **({"colocated_ttft_s": colo["ttft_s"],
                             "colocated_e2e_s": colo["e2e_s"]}
                            if colo else {})})
        mD, mP = await _metrics(port["D"]), await _metrics(port["P"])
        h = 'kgct_disagg_handoffs_total{side="%s",outcome="%s"}'
        counts = {"import_ok": _metric(mD, h % ("import", "ok")),
                  "import_fallback": _metric(mD, h % ("import", "fallback")),
                  "export_ok": _metric(mP, h % ("export", "ok"))}
        if counts != {"import_ok": 6, "import_fallback": 0, "export_ok": 6}:
            raise RuntimeError(f"10a: handoff counters {counts}")
        out["10a"] = {"handoffs": rows, "counters": counts}
        # The frame 10e times: P's export of the 1500-token prompt.
        r = await http_call(port["P"], "POST", "/internal/kv_handoff", {
            "prompt_token_ids": prompts["a"][DISAGG_PROMPTS.index(
                CODEC_PROMPT)], "temperature": 0.0})
        if r["status"] != 200:
            raise RuntimeError(f"10e: export {r['status']}")
        ctx["frame"] = bytes(r["raw"])

        # 10b: the same pair with the transit corruption armed.
        configure_faults("kv_wire_corrupt")
        try:
            bad = await http_call(
                port["D"], "POST", "/v1/completions",
                {"prompt": prompts["b"], "max_tokens": DISAGG_TOKENS,
                 "temperature": 0.0},
                {PREFILL_URL_HEADER: url["P"], REQUEST_ID_HEADER: "10b"})
        finally:
            configure_faults(None)
        if bad["status"] != 200:
            raise RuntimeError(f"10b: {bad['status']} {bad['body'][:300]}")
        ctx["held"]("10b", _PRODUCED["10b"], refs["b"], prompts["b"])
        mD = await _metrics(port["D"])
        corrupt = _metric(mD, 'kgct_kv_wire_corruptions_total{path='
                              '"handoff",outcome="corrupt"}')
        fallback = _metric(mD, h % ("import", "fallback"))
        quarantines = _metric(mD, 'kgct_peer_quarantines_total{peer="%s"}'
                              % url["P"])
        quarantined = srv["D"]["api"].peer_scores.quarantined(url["P"])
        if (corrupt, fallback, quarantines, quarantined) != (1, 1, 1, True):
            raise RuntimeError(f"10b: corrupt {corrupt}, fallback "
                               f"{fallback}, quarantines {quarantines}, "
                               f"quarantined {quarantined}")
        out["10b"] = {"corruptions": corrupt, "fallbacks": fallback,
                      "quarantined": quarantined, "tokens_held": True}

        # 10d: a stream on C drained toward D, then resumed there.
        body = {"prompt": prompts["d"], "max_tokens": MIGRATE_TOKENS,
                "temperature": 0.0, "stream": True}
        drains = []

        def on_data(raw):
            if not drains and len(_ledger(raw)[0]) >= MIGRATE_AFTER:
                drains.append(srv["C"]["api"].begin_drain())
        cut = await http_call(
            port["C"], "POST", "/v1/completions", body,
            {MIGRATE_URL_HEADER: url["D"], REQUEST_ID_HEADER: "10d"},
            on_data=on_data)
        if not drains:
            raise RuntimeError("10d: the stream ended before the drain")
        await asyncio.wait_for(drains[0], 120)
        relayed, done = _ledger(cut["raw"])
        mD, mC = await _metrics(port["D"]), await _metrics(port["C"])
        g = 'kgct_migrations_total{side="%s",outcome="%s"}'
        parked = _metric(mD, g % ("recv", "ok"))
        pushed = _metric(mC, g % ("push", "ok"))
        if done or not cut["severed"] or parked != 1 or pushed != 1:
            raise RuntimeError(f"10d: done {done}, severed "
                               f"{cut['severed']}, parked {parked}, "
                               f"pushed {pushed}")
        resumed = await http_call(
            port["D"], "POST", "/internal/resume",
            {"body": body, "kind": "completion",
             "relayed_token_ids": relayed}, {REQUEST_ID_HEADER: "10d"})
        new, rdone = _ledger(resumed["raw"])
        mode = resumed["headers"].get(RESUME_MODE_HEADER)
        if resumed["status"] != 200 or mode != "import" or not rdone:
            raise RuntimeError(f"10d: resume {resumed['status']} mode "
                               f"{mode} done {rdone}")
        ctx["held"]("10d", relayed + new, refs["d"], prompts["d"])
        push_b = _metric(mC, 'kgct_migration_bytes_total{side="push"}')
        push_s = _metric(mC, 'kgct_migration_seconds_sum{side="push"}')
        out["10d"] = {"relayed": len(relayed), "resumed": len(new),
                      "mode": mode, "push_bytes": push_b,
                      "push_ms": push_s * 1e3,
                      "push_gb_s": push_b / push_s / 1e9,
                      "resume_ttft_s": resumed["ttft_s"]}
    finally:
        for server in running:
            await server.close()
    return out


async def _fleet_10c(srv, build_f1_spill, prompts, ctx) -> dict:
    """10c: a fleet-cache pull F1 -> F2, then F1 rebuilt small, its evicted
    prefix remote-spilled into F2's host tier."""
    from kubernetes_gpu_cluster_tpu_torch.serving.errors import (
        PREFIX_SOURCE_HEADER, REQUEST_ID_HEADER)
    from kubernetes_gpu_cluster_tpu_torch.serving.http import Server
    servers = {}
    for name in ("F1", "F2"):
        servers[name] = Server(srv[name]["api"].build_app())
        await servers[name].start("127.0.0.1", srv[name]["port"])
    port = {n: srv[n]["port"] for n in ("F1", "F2")}
    url = {n: srv[n]["url"] for n in ("F1", "F2")}
    f2 = srv["F2"]["api"].engine
    out = {}

    async def comp(name, prompt, rid, max_tokens=DISAGG_TOKENS,
                   headers=None):
        r = await http_call(port[name], "POST", "/v1/completions",
                            {"prompt": prompt, "max_tokens": max_tokens,
                             "temperature": 0.0},
                            {REQUEST_ID_HEADER: rid, **(headers or {})})
        if r["status"] != 200:
            raise RuntimeError(f"10c {rid}: {r['status']} {r['body'][:300]}")
        return r
    try:
        prefix, ext = prompts["c_prefix"], prompts["c_suffix"]
        await comp("F1", prefix + ext[:1], "10c-warm", max_tokens=1)
        hist0 = ctx["hist"].launches
        hits0 = f2.engine.scheduler.prefix_cache.hits
        pulled = await comp("F2", prefix + ext, "10c-pull",
                            headers={PREFIX_SOURCE_HEADER: url["F1"]})
        hits = f2.engine.scheduler.prefix_cache.hits - hits0
        own = await comp("F1", prefix + ext, "10c-own")
        pulls = dict(f2.engine.obs.fleet_pulls)
        if pulls["ok"] != 1 or hits != 1 or ctx["hist"].launches <= hist0:
            raise RuntimeError(f"10c: pulls {pulls}, hits {hits}, history "
                               f"launches {ctx['hist'].launches - hist0}")
        ctx["held"]("10c pull", _PRODUCED["10c-pull"], _PRODUCED["10c-own"],
                    prefix + ext)
        m2 = await _metrics(port["F2"])
        nbytes = _metric(m2, 'kgct_fleet_prefix_bytes_total{dir="pull"}')
        secs = _metric(m2, "kgct_fleet_prefix_pull_seconds_sum")
        out["pull"] = {"tokens": FLEET_PREFIX, "bytes": nbytes,
                       "pull_ms": secs * 1e3,
                       "pull_gb_s": nbytes / secs / 1e9,
                       "cache_hits": hits,
                       "pulled_ttft_e2e_s": pulled["e2e_s"],
                       "owner_e2e_s": own["e2e_s"]}

        # Remote spill: F1 rebuilt with a small pool.
        await servers["F1"].close()
        srv["F1"] = build_f1_spill()
        servers["F1"] = Server(srv["F1"]["api"].build_app())
        await servers["F1"].start("127.0.0.1", srv["F1"]["port"])
        f1 = srv["F1"]["api"].engine
        sp_prefix, sp_suffix = prompts["s_prefix"], prompts["s_suffix"]
        await comp("F1", sp_prefix + sp_suffix[:1], "10c-spill-warm",
                   max_tokens=1)
        await comp("F1", sp_prefix + sp_suffix, "10c-spill-own")
        for i, churn in enumerate(prompts["s_churn"]):
            if not await f1.run_in_worker(lambda e: e.prefix_peek(
                    sp_prefix + sp_suffix)):
                break
            await comp("F1", churn, f"10c-churn-{i}", max_tokens=1)
        if await f1.run_in_worker(lambda e: e.prefix_peek(
                sp_prefix + sp_suffix)):
            raise RuntimeError("10c: churn did not evict the prefix")
        deadline = time.monotonic() + 60
        spills = f1.engine.obs.fleet_spills
        while spills["ok"] < SPILL_PREFIX // ctx["ps"]:
            if time.monotonic() > deadline:
                raise RuntimeError(f"10c: spills {dict(spills)}")
            await asyncio.sleep(0.05)
        have = await f2.run_in_worker(lambda e: e.prefix_peek(
            sp_prefix + sp_suffix))
        if have != SPILL_PREFIX:
            raise RuntimeError(f"10c: F2 holds {have} spilled tokens")
        host0 = f2.engine.scheduler.prefix_cache.host_hits
        await comp("F2", sp_prefix + sp_suffix, "10c-spill-restored")
        host_hits = f2.engine.scheduler.prefix_cache.host_hits - host0
        if host_hits < 1:
            raise RuntimeError("10c: the spilled pages were not restored")
        ctx["held"]("10c spill", _PRODUCED["10c-spill-restored"],
                    _PRODUCED["10c-spill-own"], sp_prefix + sp_suffix)
        m1 = await _metrics(port["F1"])
        out["spill"] = {
            "spills_ok": _metric(m1, 'kgct_fleet_prefix_spills_total'
                                     '{outcome="ok"}'),
            "spills_dropped": _metric(m1, 'kgct_fleet_prefix_spills_total'
                                          '{outcome="dropped"}'),
            "bytes": _metric(m1, 'kgct_fleet_prefix_bytes_total'
                                 '{dir="spill"}'),
            "peer_tokens": have, "host_hits": host_hits}
    finally:
        for server in servers.values():
            await server.close()
    return out


def _best_ms(fn, reps: int = 3) -> float:
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def time_codec(frame: bytes) -> dict:
    """10e: the codec on the 1500-token handoff frame, integrity on and
    off: ms and GB/s of the K/V payload, best of 3, on the host."""
    from kubernetes_gpu_cluster_tpu_torch.serving.handoff import (
        decode_handoff, encode_handoff, verify_import_state)
    state = decode_handoff(frame, require_integrity=True)
    stash = state["_integrity"]
    payload = state["k"].nbytes + state["v"].nbytes
    plain = bytes(encode_handoff(state, integrity=False))

    def verify():
        state["_integrity"] = stash
        verify_import_state(state)
    rows = {
        "encode_crc": _best_ms(lambda: encode_handoff(state,
                                                      integrity=True)),
        "encode_plain": _best_ms(lambda: encode_handoff(state)),
        "decode_crc": _best_ms(lambda: decode_handoff(
            frame, require_integrity=True)),
        "decode_plain": _best_ms(lambda: decode_handoff(plain)),
        "verify_import_state": _best_ms(verify)}
    out = {"payload_bytes": payload, "frame_bytes": len(frame),
           "pages": state["k"].shape[1]}
    for k, ms in rows.items():
        out[k] = {"ms": ms, "gb_s": payload / ms / 1e6}
    return out


def measure_prefill_flops(cfg_engine, params, device) -> dict:
    """10e: prefill FLOP/s of one packed 2048-token prefill step (four
    512-token prompts admitted together), synchronized, best of 3:
    ``prefill_flops_per_token`` x tokens / wall. The pull gate's ``cuda``
    figure."""
    from kubernetes_gpu_cluster_tpu_torch.config import CacheConfig
    from kubernetes_gpu_cluster_tpu_torch.engine import (LLMEngine,
                                                         SamplingParams)
    from kubernetes_gpu_cluster_tpu_torch.serving.fleet_cache import \
        prefill_flops_per_token
    cfg = cfg_engine.model
    eng = LLMEngine(dataclasses.replace(
        cfg_engine, cache=CacheConfig(page_size=cfg_engine.cache.page_size,
                                      num_pages=FLEET_PAGES)),
        params=params, device=device)
    rng = np.random.default_rng(SEED + 21)
    one = SamplingParams(max_tokens=1, temperature=0.0)
    walls = []
    for rep in range(4):              # the first is a warm-up
        for j, n in enumerate(FLOPS_PROMPTS):
            eng.add_request(f"fl-{rep}-{j}", [int(t) for t in rng.integers(
                1, cfg.vocab_size, n)], one)
        _sync(device)
        t0 = time.perf_counter()
        outs = eng.step()
        _sync(device)
        wall = time.perf_counter() - t0
        # One step prefilled every prompt: each finished at its one token.
        if sum(o.finished for o in outs) != len(FLOPS_PROMPTS) or \
                eng.has_unfinished_requests():
            raise RuntimeError(f"10e: not one packed prefill step: "
                               f"{eng._last_step_info}")
        if rep:
            walls.append(wall)
    tokens = sum(FLOPS_PROMPTS)
    fpt = prefill_flops_per_token(cfg)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return {"tokens": tokens, "flops_per_token": fpt,
            "walls_s": walls, "best_s": min(walls),
            "flops_per_s": fpt * tokens / min(walls)}


def check_fleet(cfg_engine, params, device, counters) -> dict:
    """Phase 10: the fleet plane on the phase-4 weights, servers in this
    process on free ports of 127.0.0.1, at most four engines alive."""
    from kubernetes_gpu_cluster_tpu_torch.config import (CacheConfig,
                                                         SchedulerConfig)
    from kubernetes_gpu_cluster_tpu_torch.engine import SamplingParams
    from kubernetes_gpu_cluster_tpu_torch.serving import build_server
    from kubernetes_gpu_cluster_tpu_torch.serving.fleet_cache import (
        DEFAULT_FLOPS, build_pull_policy, kv_bytes_per_token)
    cfg = cfg_engine.model
    ps = cfg_engine.cache.page_size
    rng = np.random.default_rng(SEED + 20)

    def toks(n):
        return [int(t) for t in rng.integers(1, cfg.vocab_size, n)]

    prompts = {"a": [toks(n) for n in DISAGG_PROMPTS], "b": toks(300),
               "d": toks(MIGRATE_PROMPT), "c_prefix": toks(FLEET_PREFIX),
               "c_suffix": toks(FLEET_SUFFIX),
               "s_prefix": toks(SPILL_PREFIX), "s_suffix": toks(SPILL_SUFFIX),
               "s_churn": [toks(1500) for _ in range(4)]}
    ports = {name: _free_port() for name in ("P", "D", "C", "F1", "F2")}

    def server(name, pages=FLEET_PAGES, prefix=False, swap_gb=0.0,
               record=True, **kw):
        cfg_s = dataclasses.replace(
            cfg_engine,
            cache=CacheConfig(page_size=ps, num_pages=pages,
                              swap_space_gb=swap_gb),
            scheduler=SchedulerConfig(max_num_seqs=FLEET_SEQS,
                                      enable_prefix_caching=prefix))
        api = build_server(cfg_s, params=params, device=device,
                           model_name=MODEL, **kw)
        if record:
            _record_ids(api.engine)
        return {"api": api, "port": ports[name],
                "url": f"http://127.0.0.1:{ports[name]}"}

    def url(name):
        return f"http://127.0.0.1:{ports[name]}"

    ties = []
    ctx = {"ps": ps, "hist": counters["flash_prefill_hist"],
           "held": lambda what, got, ref, prompt: _held_to(
               what, got, ref, prompt, params, cfg, device, ties)}
    for mod in counters.values():
        mod.launches = 0
    t0 = time.perf_counter()
    srv = {"C": server("C", peer_pool=[url("D")])}
    # References: each prompt alone through LLMEngine.generate on C's
    # engine, before its worker starts.
    ceng = srv["C"]["api"].engine.engine
    sp = SamplingParams(max_tokens=DISAGG_TOKENS, temperature=0.0)
    refs = {"a": [list(ceng.generate([p], sp)[0].output_token_ids)
                  for p in prompts["a"]],
            "b": list(ceng.generate([prompts["b"]], sp)[0].output_token_ids),
            "d": list(ceng.generate([prompts["d"]], dataclasses.replace(
                sp, max_tokens=MIGRATE_TOKENS))[0].output_token_ids)}
    # P's requests carry D's request ids: only D's are recorded.
    srv["P"] = server("P", role="prefill", prefix=True, record=False)
    srv["D"] = server("D", role="decode", prefill_pool=[url("P")])
    t_ref = time.perf_counter() - t0
    out = asyncio.run(_fleet_10abd(srv, refs, prompts, ctx))
    del srv, ceng
    gc.collect()
    torch.cuda.empty_cache()
    t_abd = time.perf_counter() - t0

    srv = {"F1": server("F1", prefix=True, fleet_prefix_cache=True,
                        peer_pool=[url("F2")]),
           "F2": server("F2", prefix=True, swap_gb=SPILL_HOST_GB,
                        fleet_prefix_cache=True, peer_pool=[url("F1")])}

    def f1_spill():
        srv["F1"] = None
        gc.collect()
        torch.cuda.empty_cache()
        # No host tier of its own: every evicted page takes the remote
        # rung into F2's host tier.
        return server("F1", pages=SPILL_PAGES, prefix=True,
                      fleet_prefix_cache=True, peer_pool=[url("F2")])
    out["10c"] = asyncio.run(_fleet_10c(srv, f1_spill, prompts, ctx))
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    launches = {name: mod.launches for name, mod in counters.items()}
    for name, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"10: kernel {name} never launched")
    out["launches"] = launches
    out["near_ties"] = ties
    t_c = time.perf_counter() - t0

    out["10e"] = {"codec": time_codec(ctx.pop("frame")),
                  "prefill": measure_prefill_flops(cfg_engine, params,
                                                   device)}
    measured = out["10e"]["prefill"]["flops_per_s"]
    pol = build_pull_policy(cfg, ps, 2, "cuda")
    out["10e"]["policy"] = pol.describe()
    out["10e"]["policy_at_measured"] = dataclasses.replace(
        pol, flops_per_s=measured).describe()
    out["10e"]["default_flops_cuda"] = DEFAULT_FLOPS["cuda"]
    out["10e"]["kv_bytes_per_token"] = kv_bytes_per_token(cfg, 2)
    out["seconds"] = {"references": t_ref, "10abd": t_abd - t_ref,
                      "10c": t_c - t_abd,
                      "10e": time.perf_counter() - t0 - t_c}
    return out


# ---------------------------------------------------------------------------
# Phase 11: the router in front of replicas (in process on the phase-4
# weights)
# ---------------------------------------------------------------------------

ROUTER_PAGES = 1024
ROUTER_SEQS = 8
HOP_PROMPT = 512                     # 11: the router's added ms
HOP_REPS = 10
HOP_SMALL_REPS = 20
AFFINITY_PREFIXES = (512, 640, 896, 1024)   # 11a: one session each
AFFINITY_SUFFIX = 48
AFFINITY_TOKENS = 16
SPREAD = 16                          # 11b: concurrent requests
SPREAD_PROMPTS = (64, 2500)          # 11b: prompt lengths, evenly spaced
SPREAD_TOKENS = 64
KILL_PROMPT = 1024                   # 11c
KILL_TOKENS = 256
KILL_AFTER = 8                       # relayed chunks before the kill
# 11c: a recompute resume prefills prompt + relayed cold, so its bf16 KV
# is not the uninterrupted run's, written a step at a time: the two runs
# may part where the top-2 gap is below that rounding. The limit on the
# gap (over the logits' deviation) where they part is four times the
# largest reading of the runs whose resumes were sound (0.018-0.025).
RESUME_DRIFT = 0.1
ROUTED_DISAGG = (1500, 300)          # 11d
ROUTED_DISAGG_TOKENS = 16


def _picks(router, rid: str) -> list:
    """The replicas the router picked for request ``rid``, in order."""
    return [e.args["replica"] for e in router.tracer.events()
            if e.kind == "pick" and e.request_id == rid
            and e.args.get("pool") != "prefill"]


async def _router_11(srv, prompts, refs, ctx) -> dict:
    """11, 11a-11f on replicas A, B, P, D (``srv``: name -> APIServer)."""
    from collections import Counter

    from kubernetes_gpu_cluster_tpu_torch.resilience.faults import \
        configure_faults
    from kubernetes_gpu_cluster_tpu_torch.serving import router as R
    from kubernetes_gpu_cluster_tpu_torch.serving.errors import \
        REQUEST_ID_HEADER
    from kubernetes_gpu_cluster_tpu_torch.serving.http import Server
    running, port, url = [], {}, {}

    async def serve(app, name):
        server = Server(app)
        await server.start("127.0.0.1", 0)
        running.append(server)
        port[name] = server.port
        url[name] = f"http://127.0.0.1:{server.port}"
        return server.port

    def rid_hdr(rid):
        return {REQUEST_ID_HEADER: rid}

    def ok(what, r, stream=False):
        if r["status"] != 200:
            raise RuntimeError(f"{what}: {r['status']} {r['body'][:300]}")
        if stream:
            sse_frames(r["body"])
        return r

    for name in ("A", "B", "P", "D"):
        await serve(srv[name].build_app(), name)
    out = {}
    try:
        # 11: the hop, on cold prompts of one length, then a one-token
        # request many times.
        r1 = R.Router([url["A"]], health_interval_s=3600)
        await serve(r1.build_app(), "R1")
        hop = {"direct": [], "routed": []}
        for i, prompt in enumerate(prompts["hop"]):
            # logprobs 1: a frame per engine chunk (random weights make the
            # byte tokenizer's text mostly empty), so the first one times
            # the first token.
            body = {"prompt": prompt, "max_tokens": AFFINITY_TOKENS,
                    "temperature": 0.0, "stream": True, "logprobs": 1}
            order = (("direct", "B"), ("routed", "R1"))
            for how, name in (order if i % 2 == 0 else order[::-1]):
                r = ok(f"11 hop {how}", await http_call(
                    port[name], "POST", "/v1/completions", body,
                    rid_hdr(f"11-{how}-{i}")), stream=True)
                hop[how].append({"ttft_s": r["ttft_s"], "e2e_s": r["e2e_s"]})
        small = {"direct": [], "routed": []}
        one = {"prompt": prompts["hop"][0][:8], "max_tokens": 1,
               "temperature": 0.0}
        for i in range(HOP_SMALL_REPS):
            for how, name in (("direct", "A"), ("routed", "R1")):
                r = ok("11 one-token", await http_call(
                    port[name], "POST", "/v1/completions", one))
                small[how].append(r["e2e_s"])
        med = lambda xs: float(np.median(xs))  # noqa: E731

        def added(key):
            """The router's added ms over the HOP_REPS pairs (routed minus
            direct, one pair per cold prompt): the median, the quartiles
            and the range; unresolved where the quartiles span 0."""
            d = 1e3 * np.array([r[key] - h[key] for r, h in
                                zip(hop["routed"], hop["direct"])])
            q1, q3 = (float(x) for x in np.percentile(d, (25, 75)))
            return {"median": float(np.median(d)), "q1": q1, "q3": q3,
                    "min": float(d.min()), "max": float(d.max()),
                    "resolved": q1 > 0 or q3 < 0}
        out["11"] = {
            "cold": hop,
            "cold_ttft_added_ms": added("ttft_s"),
            "cold_e2e_added_ms": added("e2e_s"),
            "one_token_e2e_ms": {k: 1e3 * med(v) for k, v in small.items()},
            "one_token_added_ms": 1e3 * (med(small["routed"])
                                         - med(small["direct"]))}

        # 11a: prefix affinity.
        ra = R.Router([url["A"], url["B"]], health_interval_s=3600,
                      routing_policy="prefix-affinity")
        await serve(ra.build_app(), "Ra")
        engines = {n: srv[n].engine.engine for n in ("A", "B")}
        by_url = {url[n]: n for n in engines}
        sessions, warm_hist = [], []
        for s, turns in enumerate(prompts["a"]):
            owners = []
            for t, prompt in enumerate(turns):
                rid = f"11a-{s}-{t}"
                hits0 = {n: e.scheduler.prefix_cache.hits
                         for n, e in engines.items()}
                hist0 = ctx["hist"].launches
                r = ok(rid, await http_call(
                    port["Ra"], "POST", "/v1/completions",
                    {"prompt": prompt, "max_tokens": AFFINITY_TOKENS,
                     "temperature": 0.0, "stream": True,
                     "session_id": f"11a-session-{s}"}, rid_hdr(rid)),
                    stream=True)
                [picked] = _picks(ra, rid)
                owner = by_url[picked]
                owners.append(owner)
                hits = engines[owner].scheduler.prefix_cache.hits \
                    - hits0[owner]
                if t > 0:
                    warm_hist.append(ctx["hist"].launches - hist0)
                    if hits < 1 or warm_hist[-1] < 1:
                        raise RuntimeError(
                            f"{rid}: warm turn on {owner}: {hits} prefix "
                            f"hits, {warm_hist[-1]} history launches")
                ctx["held"](rid, _PRODUCED[rid], refs["a"][s][t], prompt)
                if t == 0:
                    first = r
            if len(set(owners)) != 1:
                raise RuntimeError(f"11a session {s} moved: {owners}")
            sessions.append({"prefix": len(turns[0]) - AFFINITY_SUFFIX,
                             "owner": owners[0],
                             "cold_ttft_s": first["ttft_s"],
                             "warm_ttft_s": r["ttft_s"]})
        ma = await _metrics(port["Ra"])
        hits = _metric(ma, "kgct_router_affinity_hits_total")
        if hits != 3 * len(prompts["a"]):
            raise RuntimeError(f"11a: {hits} affinity hits")
        out["11a"] = {"sessions": sessions, "affinity_hits": hits,
                      "warm_hist_launches": warm_hist}

        # 11b: least-inflight under 16 concurrent requests.
        rb = R.Router([url["A"], url["B"]], health_interval_s=3600)
        await serve(rb.build_app(), "Rb")
        opened = []
        inner = rb._session._connect

        async def connect(*a, **kw):
            opened.append(a[:2])
            return await inner(*a, **kw)
        rb._session._connect = connect
        t_b = time.perf_counter()
        rows = await asyncio.gather(*(http_call(
            port["Rb"], "POST", "/v1/completions",
            {"prompt": prompt, "max_tokens": SPREAD_TOKENS,
             "temperature": 0.0, **({"stream": True} if i % 2 else {})},
            rid_hdr(f"11b-{i}")) for i, prompt in enumerate(prompts["b"])))
        wall_b = time.perf_counter() - t_b
        served = {n: 0 for n in engines}
        for i, r in enumerate(rows):
            ok(f"11b-{i}", r, stream=bool(i % 2))
            if len(_PRODUCED[f"11b-{i}"]) != SPREAD_TOKENS:
                raise RuntimeError(f"11b-{i}: "
                                   f"{len(_PRODUCED[f'11b-{i}'])} tokens")
            [picked] = _picks(rb, f"11b-{i}")
            served[by_url[picked]] += 1
        if min(served.values()) < 1 or rb.retries_total \
                or any(r.consecutive_failures for r in rb.replicas):
            raise RuntimeError(f"11b: served {served}, retries "
                               f"{rb.retries_total}")
        if len(opened) != SPREAD:
            raise RuntimeError(f"11b: {len(opened)} upstream connections "
                               f"for {SPREAD} requests")
        out["11b"] = {
            "served": served, "wall_s": wall_b,
            "tokens_per_s": SPREAD * SPREAD_TOKENS / wall_b,
            "upstream_connections_per_request": len(opened) / SPREAD,
            "ttft_s": sorted(r["ttft_s"] for r in rows if r["ttft_s"]),
            "e2e_s": sorted(r["e2e_s"] for r in rows)}

        # 11c: a stream severed after KILL_AFTER relayed chunks.
        rc = R.Router([url["A"], url["B"]], health_interval_s=3600)
        await serve(rc.build_app(), "Rc")
        relays = []

        class Kept(R._SSERelay):
            def __init__(self):
                super().__init__()
                relays.append(self)
        configure_faults(f"replica_kill_midstream:after={KILL_AFTER},"
                         "times=1")
        try:
            with mock.patch.object(R, "_SSERelay", Kept):
                r = ok("11c", await http_call(
                    port["Rc"], "POST", "/v1/completions",
                    {"prompt": prompts["c"], "max_tokens": KILL_TOKENS,
                     "temperature": 0.0, "stream": True}, rid_hdr("11c")),
                    stream=True)
        finally:
            configure_faults(None)
        [relay] = relays
        [cut] = [e.args for e in rc.tracer.events()
                 if e.kind == "failover" and "relayed_tokens" in e.args]
        mc = await _metrics(port["Rc"])
        g = 'kgct_failovers_total{outcome="%s"}'
        fo = {oc: _metric(mc, g % oc) for oc in ("import", "recompute",
                                                 "failed")}
        if sum(fo.values()) != 1 or fo["failed"] or not relay.done \
                or len(relay.tokens) != KILL_TOKENS:
            raise RuntimeError(f"11c: failovers {fo}, done {relay.done}, "
                               f"{len(relay.tokens)} tokens")
        out["11c"] = {"failovers": fo, "picks": _picks(rc, "11c"),
                      "relayed": cut["relayed_tokens"],
                      "tokens": list(relay.tokens),
                      "failover_s": _metric(
                          mc, "kgct_router_failover_seconds_sum"),
                      "ttft_s": r["ttft_s"], "e2e_s": r["e2e_s"]}

        # 11e: the aggregated /metrics and trace, and replica_down.
        families = {}
        for ln in ma.splitlines():
            for n in engines:
                if f'replica="{url[n]}"' in ln \
                        and not ln.startswith("kgct_router_"):
                    families.setdefault(n, set()).add(
                        ln.split("{")[0])
        if set(families) != set(engines) \
                or families["A"] != families["B"] or len(families["A"]) < 10:
            raise RuntimeError(f"11e: relabelled series {families}")
        tr = ok("11e trace", await http_call(port["Ra"], "GET",
                                             "/debug/trace"))
        doc = json.loads(tr["body"])
        names = {e["pid"]: e["args"]["name"] for e in doc["traceEvents"]
                 if e.get("name") == "process_name"}
        want = {"kgct-router"} | {f"kgct-engine {url[n]}" for n in engines}
        if set(names.values()) != want:
            raise RuntimeError(f"11e: trace processes {names}")
        per_pid = {names[p]: n for p, n in Counter(
            e["pid"] for e in doc["traceEvents"]).items()}
        key = ra._affinity_key_from_obj({"session_id": "11a-session-0"})
        owner = ra.ring.owner(key)
        idx = [r.url for r in ra.replicas].index(owner)
        down = {}
        configure_faults(f"replica_down:value={idx}")
        try:
            for rep in ra.replicas:
                await ra._check(rep, startup=True)
            body = {"prompt": prompts["a"][0][-1], "max_tokens": 4,
                    "temperature": 0.0, "session_id": "11a-session-0"}
            ok("11e down", await http_call(port["Ra"], "POST",
                                           "/v1/completions", body,
                                           rid_hdr("11e-down")))
            down["during"] = _picks(ra, "11e-down")
        finally:
            configure_faults(None)
        ra.replicas[idx].benched_until = 0.0
        for rep in ra.replicas:
            await ra._check(rep)
        ok("11e back", await http_call(port["Ra"], "POST",
                                       "/v1/completions", body,
                                       rid_hdr("11e-back")))
        down["after"] = _picks(ra, "11e-back")
        if down["during"] == [owner] or down["after"] != [owner] \
                or ra.ring_remaps_total != 1:
            raise RuntimeError(f"11e: owner {owner}, {down}, remaps "
                               f"{ra.ring_remaps_total}")
        out["11e"] = {"relabelled_families": len(families["A"]),
                      "trace_events": per_pid, "down": down}

        # 11d: disaggregated behind the router.
        rd = R.Router([url["D"]], prefill_urls=[url["P"]],
                      health_interval_s=3600)
        await serve(rd.build_app(), "Rd")
        rows = []
        for i, prompt in enumerate(prompts["d"]):
            rid = f"11d-{i}"
            r = ok(rid, await http_call(
                port["Rd"], "POST", "/v1/completions",
                {"prompt": prompt, "max_tokens": ROUTED_DISAGG_TOKENS,
                 "temperature": 0.0, **({"stream": True, "logprobs": 1}
                                        if i == 0 else {})}, rid_hdr(rid)),
                stream=i == 0)
            ctx["held"](rid, _PRODUCED[rid], refs["d"][i], prompt)
            rows.append({"prompt": len(prompt), "ttft_s": r["ttft_s"],
                         "e2e_s": r["e2e_s"]})
        mD, mP = await _metrics(port["D"]), await _metrics(port["P"])
        h = 'kgct_disagg_handoffs_total{side="%s",outcome="%s"}'
        counts = (_metric(mD, h % ("import", "ok")),
                  _metric(mD, h % ("import", "fallback")),
                  _metric(mP, h % ("export", "ok")))
        if counts != (2, 0, 2):
            raise RuntimeError(f"11d: handoffs (import ok, fallback, "
                               f"export ok) {counts}")
        out["11d"] = {"requests": rows, "handoffs": counts}

        # 11f: the CLI in a subprocess in front of A.
        out["11f"] = await _router_cli(url["A"])
    finally:
        for server in reversed(running):
            await server.close()
    return out


async def _router_cli(replica_url: str) -> dict:
    """11f: ``python -m ...serving.router`` in front of ``replica_url``,
    one streamed request, SIGTERM, exit 0."""
    import signal
    work = REPO / "build" / "router-11f"
    work.mkdir(parents=True, exist_ok=True)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    log_path = work / "router.log"
    t0 = time.perf_counter()
    with open(log_path, "w") as logf:
        proc = subprocess.Popen(
            [sys.executable, "-m",
             "kubernetes_gpu_cluster_tpu_torch.serving.router",
             "--replicas", replica_url, "--host", "127.0.0.1",
             "--port", str(port)], cwd=REPO, env=env, stdout=logf,
            stderr=subprocess.STDOUT)
        try:
            while True:
                if proc.poll() is not None:
                    raise RuntimeError(f"11f: the router exited with "
                                       f"{proc.returncode}")
                try:
                    if (await http_call(port, "GET", "/health"))[
                            "status"] == 200:
                        break
                except OSError:
                    pass
                if time.perf_counter() - t0 > 60:
                    raise RuntimeError("11f: the router never answered")
                await asyncio.sleep(0.1)
            up_s = time.perf_counter() - t0
            r = await http_call(port, "POST", "/v1/completions",
                                {"prompt": [1, 2, 3, 4], "max_tokens": 8,
                                 "temperature": 0.0, "stream": True},
                                {"x-kgct-request-id": "11f"})
            if r["status"] != 200 or len(_PRODUCED["11f"]) != 8:
                raise RuntimeError(f"11f: {r['status']} {r['body'][:300]}")
            sse_frames(r["body"])
            t1 = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            rc = await asyncio.to_thread(proc.wait, 30)
            if rc != 0:
                raise RuntimeError(f"11f: the router exited {rc} on SIGTERM")
            return {"health_after_s": up_s, "ttft_s": r["ttft_s"],
                    "sigterm_exit_s": time.perf_counter() - t1}
        except BaseException:
            logf.flush()
            log("router CLI output (tail):\n" + log_path.read_text()[-4000:])
            raise
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def check_router(cfg_engine, params, device, counters) -> dict:
    """Phase 11: the port's router in front of in-process replicas on the
    phase-4 weights (five engines: A, B, P, D and the reference)."""
    from kubernetes_gpu_cluster_tpu_torch.config import (CacheConfig,
                                                         SchedulerConfig)
    from kubernetes_gpu_cluster_tpu_torch.engine import (LLMEngine,
                                                         SamplingParams)
    from kubernetes_gpu_cluster_tpu_torch.serving import build_server
    cfg = cfg_engine.model
    ps = cfg_engine.cache.page_size
    rng = np.random.default_rng(SEED + 30)

    def toks(n):
        return [int(t) for t in rng.integers(1, cfg.vocab_size, n)]

    prompts = {
        "hop": [toks(HOP_PROMPT) for _ in range(HOP_REPS)],
        "a": [[prefix + toks(AFFINITY_SUFFIX) for _ in range(3)]
              for prefix in (toks(n) for n in AFFINITY_PREFIXES)],
        "b": [toks(int(n)) for n in rng.permutation(
            np.linspace(*SPREAD_PROMPTS, SPREAD).astype(int))],
        "c": toks(KILL_PROMPT),
        "d": [toks(n) for n in ROUTED_DISAGG]}

    def config(prefix=True):
        return dataclasses.replace(
            cfg_engine,
            cache=CacheConfig(page_size=ps, num_pages=ROUTER_PAGES),
            scheduler=SchedulerConfig(max_num_seqs=ROUTER_SEQS,
                                      enable_prefix_caching=prefix))

    t0 = time.perf_counter()
    # The reference: the replicas' configuration, the same prompts in the
    # same order (11a's warm turns hit its prefix cache as the owner's do).
    ref_eng = LLMEngine(config(), params=params, device=device)

    def gen(prompt, n):
        return list(ref_eng.generate([prompt], SamplingParams(
            max_tokens=n, temperature=0.0))[0].output_token_ids)
    refs = {"a": [[gen(p, AFFINITY_TOKENS) for p in turns]
                  for turns in prompts["a"]],
            "c": gen(prompts["c"], KILL_TOKENS),
            "d": [gen(p, ROUTED_DISAGG_TOKENS) for p in prompts["d"]]}
    srv = {}
    for name, role in (("A", "both"), ("B", "both"), ("P", "prefill"),
                       ("D", "decode")):
        srv[name] = build_server(config(prefix=role == "both"),
                                 params=params, device=device,
                                 model_name=MODEL, role=role)
        # P's requests carry D's request ids: only D's are recorded.
        if role != "prefill":
            _record_ids(srv[name].engine)
    t_ref = time.perf_counter() - t0

    ties = []
    ctx = {"hist": counters["flash_prefill_hist"],
           "held": lambda what, got, ref, prompt: _held_to(
               what, got, ref, prompt, params, cfg, device, ties)}
    for mod in counters.values():
        mod.launches = 0
    out = asyncio.run(_router_11(srv, prompts, refs, ctx))
    launches = {name: mod.launches for name, mod in counters.items()}
    if min(launches.values()) <= 0:
        raise RuntimeError(f"11: replica kernel launches {launches}")
    t_serve = time.perf_counter() - t0 - t_ref

    # 11c: the relayed tokens are the uninterrupted run's; the resumed ones
    # the reference's greedy continuation of prompt + relayed, prefilled
    # cold as the successor does (the reference's cache holds the
    # uninterrupted run's decode-time pages: dropped first).
    c = out["11c"]
    got, n_cut = c.pop("tokens"), c["relayed"]
    relayed, resumed = got[:n_cut], got[n_cut:]
    ctx["held"]("11c relayed", relayed, refs["c"][:n_cut], prompts["c"])
    cache = ref_eng.scheduler.prefix_cache
    cache.evict(len(cache))
    cont = gen(prompts["c"] + relayed, KILL_TOKENS - n_cut)
    ctx["held"]("11c resumed", resumed, cont, prompts["c"] + relayed)
    j = _first_diff(got, refs["c"])
    c["equal_to_uninterrupted"] = got == refs["c"]
    if j < len(got):
        gap, std = _top2_gap(params, cfg, prompts["c"] + refs["c"][:j],
                             device)
        log(f"11c: the resumed stream leaves the uninterrupted run at "
            f"output {j} (relayed {n_cut}): top-2 gap {gap} logit std "
            f"{std} ({gap / std:.3g} of it; limit {RESUME_DRIFT})")
        c["uninterrupted_diff"] = {"at": j, "gap_over_std": gap / std,
                                   "limit": RESUME_DRIFT}
        if gap >= RESUME_DRIFT * std:
            raise RuntimeError(
                f"11c: the resumed stream leaves the uninterrupted run at "
                f"output {j} with a top-2 gap of {gap / std:.3g} of the "
                f"logit std, over the limit {RESUME_DRIFT}")
    del ref_eng, srv
    gc.collect()
    torch.cuda.empty_cache()
    out["launches"] = launches
    out["near_ties"] = ties
    out["seconds"] = {"engines_and_references": t_ref, "serving": t_serve,
                      "total": time.perf_counter() - t0}
    return out


# ---------------------------------------------------------------------------
# Phase 12: tensor and expert parallelism, ranks in child processes
# ---------------------------------------------------------------------------

TP_PAGES = 1024      # each rank's pool, fixed: ranks sharing one card see
TP_SEQS = 8          # one mem_get_info, so none is derived from it
TP_LONG = 2500       # > the 2048-token prefill budget: chunked
EP_REQS = 4
FAULT_AFTER = 3      # 12c: broadcasts before the injected failure
ABORT_BOUND_S = 60.0  # 12c: both ranks gone within this after the fault
ALLREDUCE_REPS = 50
EP_LAYERS = None     # 12b's depth: None is mixtral-8x7b's full 32 layers
SP_LONG = 2048       # 13b: one prefill of T 2048 through the ring
P2P_REPS = 50
RING_REPS = 5
RING_ERR = 5e-2      # 13b: ring vs flash_prefill on bf16 inputs
TP_DIR = REPO / "build" / "tp"


def tp_requests(vocab: int, n_req: int, long_len: int) -> list:
    """``workload``'s prompts, every request greedy: the long one (chunked)
    and three more arrive at once, the rest one at a time every three
    steps while those decode (mixed steps)."""
    from kubernetes_gpu_cluster_tpu_torch.engine import SamplingParams
    reqs = workload(vocab, n_req=n_req, long_len=long_len, max_prompt=768,
                    wave=1)
    return [(0 if i < 4 else 3 * (i - 3), rid, prompt,
             SamplingParams(max_tokens=sp.max_tokens, temperature=0.0))
            for i, (_, rid, prompt, sp) in enumerate(reqs)]


def _req_spec(reqs) -> list:
    return [[a, rid, prompt, sp.max_tokens] for a, rid, prompt, sp in reqs]


def spawn_ranks(tag: str, spec: dict, devices: list, backend: str,
                timeout_s: float) -> list[dict]:
    """Run ``chip_smoke.py --tp-child`` as one process per rank (rank k
    on ``cuda:devices[k]``), joined over localhost by ``backend``; returns
    each rank's result record. Any rank that fails or outlives
    ``timeout_s`` fails the phase; no process is left behind."""
    world = len(devices)
    TP_DIR.mkdir(parents=True, exist_ok=True)
    spec = dict(spec, tag=tag, world=world, backend=backend,
                coordinator=f"127.0.0.1:{_free_port()}",
                ctrl=[_free_port() for _ in range(2 * world)])
    procs, logs = [], []
    for rank, dev in enumerate(devices):
        out = TP_DIR / f"{tag}-rank{rank}.json"
        out.unlink(missing_ok=True)
        logf = open(TP_DIR / f"{tag}-rank{rank}.log", "w")
        logs.append(logf)
        env = dict(os.environ, GLOO_SOCKET_IFNAME="lo",
                   KGCT_COORDINATOR=spec["coordinator"],
                   KGCT_NUM_PROCESSES=str(world),
                   KGCT_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--tp-child",
             json.dumps(dict(spec, rank=rank, device=dev, out=str(out)))],
            env=env, stdout=logf, stderr=subprocess.STDOUT))
    t0 = time.monotonic()
    try:
        for p in procs:
            p.wait(timeout=max(timeout_s - (time.monotonic() - t0), 1.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    results = []
    for rank, p in enumerate(procs):
        out = TP_DIR / f"{tag}-rank{rank}.json"
        tail = (TP_DIR / f"{tag}-rank{rank}.log").read_text()[-3000:]
        if p.returncode != 0 or not out.exists():
            log(f"{tag} rank {rank} log tail:\n{tail}")
            raise RuntimeError(f"{tag}: rank {rank} exited {p.returncode}")
        results.append(json.loads(out.read_text()))
    return results


def _time_stage_hops(groups, device) -> dict:
    """13: ms of one send/recv of a decode step's [TP_SEQS, 4096] bf16
    hidden between the two stages (ping-pong, per hop) and of one
    broadcast of it from the last stage."""
    x = torch.randn((TP_SEQS, 4096), dtype=torch.bfloat16, device=device)
    other = groups.peer("pp", 1)

    def ping():
        if groups.is_first_stage:
            groups.send(x, other)
            groups.recv(x.shape, x.dtype, device, other)
        else:
            groups.send(groups.recv(x.shape, x.dtype, device, other), other)
    out = {}
    for name, fn, per in (("p2p_ms", ping, 2),
                          ("bcast_ms", lambda: groups.broadcast_from_last_stage(
                              x), 1)):
        for _ in range(5):
            fn()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(P2P_REPS):
            fn()
        torch.cuda.synchronize(device)
        out[name] = (time.perf_counter() - t0) / (P2P_REPS * per) * 1e3
    return out


def _time_ring(groups, cfg, device) -> dict:
    """13b: the ring's ms (wall, synchronized: its hops go through host
    memory) at T ``SP_LONG`` on one sequence of random bf16 q/k/v at the
    model's heads, beside ``flash_prefill``'s on the same inputs, and the
    largest difference between the two."""
    from kubernetes_gpu_cluster_tpu_torch.ops.attention import (
        prefill_window, ragged_prefill_attention)
    from kubernetes_gpu_cluster_tpu_torch.parallel.sp import \
        ring_prefill_attention
    gen = torch.Generator(device=device).manual_seed(SEED + 13)
    T, hd = SP_LONG, cfg.head_dim
    q = _randn(gen, (T, cfg.num_heads, hd), torch.bfloat16, device)
    k = _randn(gen, (T, cfg.num_kv_heads, hd), torch.bfloat16, device)
    v = _randn(gen, (T, cfg.num_kv_heads, hd), torch.bfloat16, device)
    seg = torch.zeros(T, dtype=torch.int32, device=device)
    pos = torch.arange(T, dtype=torch.int32, device=device)
    scale = hd ** -0.5
    win = prefill_window(seg)

    def ring():
        return ring_prefill_attention(q, k, v, seg, pos, scale,
                                      groups=groups)

    def flash():
        return ragged_prefill_attention(q, k, v, seg, pos, scale, win)
    err = (ring().float() - flash().float()).abs().max().item()
    out = {"T": T, "max_abs_diff": err}
    for name, fn, reps in (("ring_ms", ring, RING_REPS),
                           ("flash_prefill_ms", flash, 5 * RING_REPS)):
        fn()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize(device)
        out[name] = (time.perf_counter() - t0) / reps * 1e3
    return out


def _time_allreduce(groups, device) -> float:
    """ms of one all-reduce of a decode step's [TP_SEQS, d] fp32 over the
    tp group (every rank calls this the same number of times)."""
    x = torch.randn((TP_SEQS, 4096), dtype=torch.float32, device=device)
    for _ in range(5):
        groups.all_reduce(x)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(ALLREDUCE_REPS):
        groups.all_reduce(x)
    torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) / ALLREDUCE_REPS * 1e3


async def _serve_waves(aeng, reqs, steps: list) -> dict:
    """Submit ``reqs`` by arrival step as ``drive`` does and collect each
    request's tokens: the first wave is in the inbox before the worker
    starts, and each later request goes in once the step count reaches its
    arrival, while the worker waits for it (``_hold_for_arrivals``)."""
    from kubernetes_gpu_cluster_tpu_torch.engine import SamplingParams
    out: dict = {}

    async def one(rid, prompt, max_tokens):
        toks = []
        async for chunk in aeng.generate(
                rid, prompt, SamplingParams(max_tokens=max_tokens,
                                            temperature=0.0)):
            toks = chunk.output_token_ids
        out[rid] = toks

    first = [r for r in reqs if r[0] == 0]
    tasks = [asyncio.create_task(one(rid, prompt, max_tokens))
             for _, rid, prompt, max_tokens in first]
    while len(aeng._inbox) < len(first):
        await asyncio.sleep(0)
    aeng.start(asyncio.get_running_loop())
    for arrival, rid, prompt, max_tokens in sorted(
            (r for r in reqs if r[0] > 0), key=lambda r: r[0]):
        while steps[0] < arrival:
            await asyncio.sleep(0.001)
        tasks.append(asyncio.create_task(one(rid, prompt, max_tokens)))
    await asyncio.gather(*tasks)
    return out


def _hold_for_arrivals(aeng, reqs, step: int, seen: set,
                       timeout_s: float = 60.0) -> None:
    """On the worker thread once ``step`` steps have run: wait until every
    request due by then has reached the inbox (``seen`` gathers the ids
    met there), so it joins the batch ``drive`` gives it."""
    due = {rid for arrival, rid, _, _ in reqs if arrival <= step}
    deadline = time.monotonic() + timeout_s
    while not due <= seen:
        with aeng._cv:
            seen.update(item[0] for item in aeng._inbox)
        if time.monotonic() > deadline:
            raise RuntimeError(f"requests {sorted(due - seen)} due at step "
                               f"{step} never reached the inbox")
        time.sleep(0.0005)


async def _fail_midstream(aeng, reqs) -> list:
    """12c: requests that must each end in an error."""
    from kubernetes_gpu_cluster_tpu_torch.engine import SamplingParams
    errors = []

    async def one(rid, prompt):
        try:
            async for _ in aeng.generate(rid, prompt, SamplingParams(
                    max_tokens=64, temperature=0.0)):
                pass
            errors.append(None)
        except Exception as e:
            errors.append(str(e))
    await asyncio.gather(*(one(f"abort-{rid}", prompt)
                           for _, rid, prompt, _ in reqs))
    return errors


def tp_child(spec: dict) -> None:
    """One rank of phase 12/12b/12c/12d. Rank 0 serves ``spec["reqs"]``
    through ``AsyncLLMEngine(leader=DirectiveLeader)``; rank 1 follows.
    Each writes its kernel launches, counted from 0 just before serving,
    and rank 0 the tokens and each step's kind and batch size, to
    ``spec["out"]``."""
    from kubernetes_gpu_cluster_tpu_torch.config import (
        CacheConfig, EngineConfig, ParallelConfig, SchedulerConfig,
        get_model_config)
    from kubernetes_gpu_cluster_tpu_torch.engine import LLMEngine
    from kubernetes_gpu_cluster_tpu_torch.ops.cuda import (
        flash_prefill, flash_prefill_hist, int4_matmul, paged_decode)
    from kubernetes_gpu_cluster_tpu_torch.parallel import (
        initialize_distributed, mesh_from_config)
    from kubernetes_gpu_cluster_tpu_torch.resilience import (
        LoopLiveness, configure_faults)
    from kubernetes_gpu_cluster_tpu_torch.serving.async_engine import \
        AsyncLLMEngine
    from kubernetes_gpu_cluster_tpu_torch.serving.multihost import (
        DirectiveFollower, DirectiveLeader, serve_follower_health)

    rank, world = spec["rank"], spec["world"]
    device = torch.device("cuda", spec["device"])
    torch.cuda.set_device(device)
    ctrl = spec["ctrl"]
    followers = []
    if rank > 0:      # bound before the rendezvous blocks
        followers = [DirectiveFollower(port=ctrl[2 * rank + i],
                                       host="127.0.0.1") for i in range(2)]
    t0 = time.perf_counter()
    initialize_distributed(backend=spec["backend"], device=device,
                           timeout_s=300)
    par = ParallelConfig(tp=spec["tp"], ep=spec["ep"],
                         pp=spec.get("pp", 1), sp=spec.get("sp", 1))
    groups = mesh_from_config(par)
    model = get_model_config(spec["model"]).replace(
        quantization=spec["quant"], quant_group_size=GROUP,
        **({"num_layers": spec["layers"]} if spec.get("layers") else {}))
    cfg = EngineConfig(model=model, seed=SEED, parallel=par,
                       cache=CacheConfig(page_size=spec["page_size"],
                                         num_pages=spec["pages"]),
                       scheduler=SchedulerConfig(max_num_seqs=TP_SEQS))
    counters = {"paged_decode": paged_decode, "flash_prefill": flash_prefill,
                "flash_prefill_hist": flash_prefill_hist,
                "int4_matmul": int4_matmul}
    res: dict = {"rank": rank, "coords": groups.coords}
    if rank == 0:
        addrs = [f"127.0.0.1:{ctrl[2 * k]}" for k in range(1, world)]
        aeng = AsyncLLMEngine(cfg, device=device, groups=groups,
                              leader=DirectiveLeader(addrs))
        engine = aeng.engine
    else:
        engine = LLMEngine(cfg, device=device, groups=groups)
    torch.cuda.synchronize(device)
    res["init_s"] = time.perf_counter() - t0
    res["weight_gb"] = sum(
        t.numel() * t.element_size()
        for t in [*engine.params["layers"].values(),
                  *(v for k, v in engine.params.items() if k != "layers")]
    ) / 1e9
    res["kv_shape"] = list(engine.kv_cache.k.shape)
    for mod in counters.values():
        mod.launches = 0
    if rank == 0:
        steps = [0]
        kinds = dict.fromkeys(("prefill", "chunked", "mixed", "decode"), 0)
        schedule: list = []
        seen = {rid for arrival, rid, _, _ in spec["reqs"] if arrival == 0}
        step = engine.step

        def counted_step():
            hist = flash_prefill_hist.launches
            outs = step()
            schedule.append(_step_record(engine, flash_prefill_hist, hist))
            if schedule[-1] is not None:
                kind = schedule[-1][0]
                kinds[kind] = kinds.get(kind, 0) + 1
            steps[0] += 1
            _hold_for_arrivals(aeng, spec["reqs"], steps[0], seen)
            return outs
        engine.step = counted_step

        async def serve():
            t1 = time.perf_counter()
            toks = await _serve_waves(aeng, spec["reqs"], steps)
            # The steps that drain the in-flight window run after the last
            # token is out: the worker is idle (every step recorded) once
            # an op queued after them has run.
            while engine.has_unfinished_requests():
                await asyncio.sleep(0.001)
            await aeng.run_in_worker(lambda e: None)
            torch.cuda.synchronize(device)
            return toks, time.perf_counter() - t1
        loop = asyncio.new_event_loop()
        toks, wall = loop.run_until_complete(serve())
        engine.step = step
        res.update(tokens=toks, wall_s=wall, kinds=kinds, schedule=schedule,
                   tokens_per_s=sum(map(len, toks.values())) / wall,
                   launches={n: m.launches for n, m in counters.items()})
        aeng.leader.close()             # stop: the follower leaves run()
    else:
        followers[0].run(engine)
        res["launches"] = {n: m.launches for n, m in counters.items()}
    if spec.get("allreduce"):
        res["allreduce_ms"] = _time_allreduce(groups, device)
    if par.pp > 1:
        res.update(_time_stage_hops(groups, device))
    if par.sp > 1:
        res["ring"] = _time_ring(groups, model, device)
    if spec.get("abort"):
        # 12c on the same engines: a fresh channel, then the fault.
        if rank == 0:
            aeng.leader = DirectiveLeader(
                [f"127.0.0.1:{ctrl[2 * k + 1]}" for k in range(1, world)])
            configure_faults(f"broadcast_fail:after={FAULT_AFTER},times=1")
            t1 = time.perf_counter()
            errors = loop.run_until_complete(
                _fail_midstream(aeng, spec["reqs"][:3]))
            aeng._thread.join(timeout=ABORT_BOUND_S)
            res["abort"] = {
                "errors": errors, "s": time.perf_counter() - t1,
                "worker_stopped": not aeng._thread.is_alive(),
                "leader_detached": aeng.leader is None,
                "unfinished": engine.has_unfinished_requests()}
        else:
            liveness = LoopLiveness(timeout_s=600)
            health = serve_follower_health(0, host="127.0.0.1",
                                           liveness=liveness)
            t1 = time.perf_counter()
            followers[1].run(engine, liveness=liveness,
                             liveness_timeout_s=ABORT_BOUND_S)
            import urllib.error
            import urllib.request
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{health.server_address[1]}"
                        "/health", timeout=5) as r:
                    status = r.status
            except urllib.error.HTTPError as e:
                status = e.code
            health.shutdown()
            res["abort"] = {"health": status, "reason": liveness.reason,
                            "s": time.perf_counter() - t1,
                            "unfinished": engine.has_unfinished_requests()}
    Path(spec["out"]).write_text(json.dumps(res))
    import torch.distributed as dist
    dist.destroy_process_group()


def _forced_gaps(params, cfg, prompt, toks, device) -> list[float]:
    """Teacher forcing on ``params``: one prefill of prompt + toks; for
    each output i, how far toks[i]'s logit lies below the top logit after
    prompt + toks[:i], over those logits' deviation (0 where it is the
    top token)."""
    ids = prompt + toks[:-1]
    logits = _prefill_logits(params, cfg, ids,
                             np.arange(len(prompt) - 1, len(ids)), device)
    chosen = logits.gather(1, torch.tensor(toks, device=device)[:, None])
    gaps = (logits.max(-1).values - chosen[:, 0]) / logits.std(-1)
    return gaps.tolist()


def _held_forced(what, got, ref, prompt, params, cfg, device,
                 ties: list) -> bool:
    """``got`` (a run on more than one rank) equals ``ref`` (the
    one-device engine's tokens; None: none to compare) up to its first
    difference j. From j on, each token is, teacher forced on the
    one-device weights ``params`` (one prefill of prompt + got), the top
    token or under ``RESUME_DRIFT`` of the logits' deviation below it: the
    one-device greedy continuation of what came before, but for near-ties
    that the all-reduce's other summation order may flip. Each token off
    the top goes into ``ties``. Returns whether ``got`` equals ``ref``."""
    if not got:
        raise RuntimeError(f"{what}: no tokens")
    j = 0
    if ref is not None:
        j = _first_diff(got, ref)
        if j == min(len(got), len(ref)):
            if len(got) != len(ref):
                raise RuntimeError(f"{what}: {len(got)} tokens, the "
                                   f"one-device run {len(ref)}")
            return True
        log(f"{what}: tokens differ from the one-device run at output {j}")
    gaps = _forced_gaps(params, cfg, prompt, got, device)
    off = [(i, gaps[i]) for i in range(j, len(got)) if gaps[i] > 0]
    ties += [{"what": what, "at": i, "gap_over_std": g} for i, g in off]
    if off:
        i, g = max(off, key=lambda x: x[1])
        log(f"{what}: {len(off)} of outputs {j}-{len(got) - 1} are not the "
            f"top token teacher forced on the one-device weights; the "
            f"widest gap, at output {i}, is {g:.3g} of the logit std (limit "
            f"{RESUME_DRIFT})")
        if g >= RESUME_DRIFT:
            raise RuntimeError(f"{what}: output {i} lies {g:.3g} of the "
                               f"logit std below the top token, over the "
                               f"limit {RESUME_DRIFT}")
    return False


def _same_schedule(what, got: list, ref: list) -> None:
    """The run on ranks stepped the batches the one-device run did, step
    for step: its tokens then differ from that run's only by the ranks'
    arithmetic."""
    if got != ref:
        j = _first_diff(got, ref)
        raise RuntimeError(
            f"{what}: step {j} ran {got[j] if j < len(got) else None}, the "
            f"one-device run {ref[j] if j < len(ref) else None} "
            f"({len(got)} and {len(ref)} steps)")


def _launched(what, results: list, names: tuple) -> None:
    for r in results:
        for name in names:
            if r["launches"][name] <= 0:
                raise RuntimeError(f"{what}: {name} never launched on rank "
                                   f"{r['rank']}: {r['launches']}")


def check_tp(cfg, params, device, card: str, devices: list,
             backend: str, abort: bool) -> dict:
    """Phase 12 (12d with NCCL on two cards): llama-3-8b bf16 at tp 2
    against the tp=1 engine on the same seed; 12c on the same ranks."""
    from kubernetes_gpu_cluster_tpu_torch.config import (
        CacheConfig, EngineConfig, SchedulerConfig)
    from kubernetes_gpu_cluster_tpu_torch.engine import LLMEngine
    from kubernetes_gpu_cluster_tpu_torch.ops.cuda import flash_prefill_hist
    ps = 16
    reqs = tp_requests(cfg.vocab_size, n_req=7, long_len=TP_LONG)
    engine = LLMEngine(EngineConfig(
        model=cfg, seed=SEED, cache=CacheConfig(page_size=ps,
                                                num_pages=TP_PAGES),
        scheduler=SchedulerConfig(max_num_seqs=TP_SEQS)), params=params,
        device=device)
    ref = drive(engine, reqs, "tp1", flash_prefill_hist)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    tag = "12" if backend == "gloo" else "12d"
    t0 = time.perf_counter()
    ranks = spawn_ranks(tag, dict(model=cfg.name, quant=None, tp=2, ep=1,
                                  page_size=ps, pages=TP_PAGES,
                                  reqs=_req_spec(reqs), allreduce=True,
                                  abort=abort),
                        devices, backend, timeout_s=600)
    lead = ranks[0]
    _same_schedule(tag, lead["schedule"], ref["schedule"])
    ties: list = []
    equal = [rid for _, rid, prompt, _ in reqs if _held_forced(
        f"tp 2 ({backend}) {rid}", lead["tokens"][rid], ref["tokens"][rid],
        prompt, params, cfg, device, ties)]
    _launched(tag, ranks, ("paged_decode", "flash_prefill",
                           "flash_prefill_hist"))
    for kind in ("prefill", "chunked", "mixed", "decode"):
        if lead["kinds"].get(kind, 0) <= 0:
            raise RuntimeError(f"{tag}: no {kind} step ran: {lead['kinds']}")
    out = {"backend": backend, "devices": devices,
           "tp1_tokens_per_s": ref["tokens_per_s"],
           "tp2_tokens_per_s": lead["tokens_per_s"],
           "tp2_wall_s": lead["wall_s"], "kinds": lead["kinds"],
           "steps": len(ref["schedule"]), "same_schedule": True,
           "equal_to_tp1": f"{len(equal)} of {len(reqs)}",
           "near_ties": ties,
           "allreduce_ms": [r["allreduce_ms"] for r in ranks],
           "launches": [r["launches"] for r in ranks],
           "init_s": [r["init_s"] for r in ranks],
           "weight_gb": [r["weight_gb"] for r in ranks],
           "kv_shape": ranks[0]["kv_shape"],
           "spawn_s": time.perf_counter() - t0}
    log(f"tp 2 ({backend}, cuda {devices}): {ref['tokens_per_s']:.1f} "
        f"tokens/s at tp 1, {lead['tokens_per_s']:.1f} at tp 2; one "
        f"all-reduce of [{TP_SEQS}, 4096] fp32: "
        f"{[round(r['allreduce_ms'], 4) for r in ranks]} ms | {card}")
    if backend == "gloo":
        log("tp 2 on one card: gloo stages every all-reduce through host "
            "memory; this run measures no NVLink")
    if abort:
        a0, a1 = ranks[0]["abort"], ranks[1]["abort"]
        if not all(a0["errors"]) or not a0["worker_stopped"] \
                or a0["unfinished"]:
            raise RuntimeError(f"12c: leader did not fail cleanly: {a0}")
        if a1["health"] != 503 or a1["unfinished"]:
            raise RuntimeError(f"12c: follower did not group-abort: {a1}")
        if max(a0["s"], a1["s"]) > ABORT_BOUND_S:
            raise RuntimeError(f"12c: ranks took over {ABORT_BOUND_S} s")
        out["abort"] = {"leader": a0, "follower": a1}
        log("group abort (12c):", json.dumps(out["abort"]))
    return out


def check_pp_sp(cfg, params, device, card: str, axis: str) -> dict:
    """Phase 13 (``axis`` "pp") or 13b ("sp"): llama-3-8b bf16 at pp 2 or
    sp 2 as two ranks on card 0 over gloo, against the one-device engine
    on the same seed with mixed batching off (pp and sp turn it off)."""
    from kubernetes_gpu_cluster_tpu_torch.config import (
        CacheConfig, EngineConfig, SchedulerConfig)
    from kubernetes_gpu_cluster_tpu_torch.engine import LLMEngine
    from kubernetes_gpu_cluster_tpu_torch.ops.cuda import flash_prefill_hist
    ps = 16
    tag = "13" if axis == "pp" else "13b"
    reqs = tp_requests(cfg.vocab_size, n_req=7,
                       long_len=TP_LONG if axis == "pp" else SP_LONG)
    engine = LLMEngine(EngineConfig(
        model=cfg, seed=SEED, cache=CacheConfig(page_size=ps,
                                                num_pages=TP_PAGES),
        scheduler=SchedulerConfig(max_num_seqs=TP_SEQS,
                                  mixed_batch_enabled=False)),
        params=params, device=device)
    ref = drive(engine, reqs, f"{axis}1", flash_prefill_hist)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn_ranks(tag, {"model": cfg.name, "quant": None, "tp": 1,
                              "ep": 1, axis: 2, "page_size": ps,
                              "pages": TP_PAGES, "reqs": _req_spec(reqs)},
                        [0, 0], "gloo", timeout_s=600)
    lead = ranks[0]
    _same_schedule(tag, lead["schedule"], ref["schedule"])
    ties: list = []
    equal = [rid for _, rid, prompt, _ in reqs if _held_forced(
        f"{axis} 2 {rid}", lead["tokens"][rid], ref["tokens"][rid], prompt,
        params, cfg, device, ties)]
    kinds = ("prefill", "decode") + (("chunked",) if axis == "pp" else ())
    for kind in kinds:
        if lead["kinds"].get(kind, 0) <= 0:
            raise RuntimeError(f"{tag}: no {kind} step ran: {lead['kinds']}")
    if lead["kinds"].get("mixed", 0):
        raise RuntimeError(f"{tag}: a mixed step ran under {axis}")
    if axis == "pp":
        _launched(tag, ranks, ("paged_decode", "flash_prefill",
                               "flash_prefill_hist"))
    else:
        _launched(tag, ranks, ("paged_decode",))
        for r in ranks:
            if r["launches"]["flash_prefill"]:
                raise RuntimeError(f"{tag}: flash_prefill launched on rank "
                                   f"{r['rank']} under sp: {r['launches']}")
            if r["ring"]["max_abs_diff"] > RING_ERR:
                raise RuntimeError(f"{tag}: ring attention differs from "
                                   f"flash_prefill by {r['ring']}")
    out = {"axis": axis, "one_device_tokens_per_s": ref["tokens_per_s"],
           "tokens_per_s": lead["tokens_per_s"], "wall_s": lead["wall_s"],
           "kinds": lead["kinds"], "steps": len(ref["schedule"]),
           "same_schedule": True,
           "equal_to_one_device": f"{len(equal)} of {len(reqs)}",
           "near_ties": ties, "launches": [r["launches"] for r in ranks],
           "init_s": [r["init_s"] for r in ranks],
           "weight_gb": [r["weight_gb"] for r in ranks],
           "kv_shape": [r["kv_shape"] for r in ranks],
           "spawn_s": time.perf_counter() - t0}
    if axis == "pp":
        out.update(p2p_ms=[r["p2p_ms"] for r in ranks],
                   bcast_ms=[r["bcast_ms"] for r in ranks])
        log(f"pp 2 (gloo, one card): {ref['tokens_per_s']:.1f} tokens/s "
            f"at pp 1, {lead['tokens_per_s']:.1f} at pp 2; weights "
            f"{[round(r['weight_gb'], 2) for r in ranks]} GB a rank; one "
            f"send/recv of [{TP_SEQS}, 4096] bf16 "
            f"{[round(r['p2p_ms'], 4) for r in ranks]} ms, one broadcast "
            f"{[round(r['bcast_ms'], 4) for r in ranks]} ms | {card}")
    else:
        out["ring"] = [r["ring"] for r in ranks]
        log(f"sp 2 (gloo, one card): {ref['tokens_per_s']:.1f} tokens/s "
            f"at sp 1, {lead['tokens_per_s']:.1f} at sp 2; ring attention "
            f"at T {SP_LONG}: {[round(r['ring']['ring_ms'], 3) for r in ranks]}"
            f" ms against flash_prefill "
            f"{[round(r['ring']['flash_prefill_ms'], 4) for r in ranks]} ms"
            f" | {card}")
    log(f"{axis} 2 on one card: gloo stages every hop through host memory;"
        " this run measures no NVLink")
    return out


def check_ep(cfg, device, card: str, layers) -> dict:
    """Phase 12b: mixtral-8x7b int4 at tp 1, ep 2 on two ranks of one card
    against the one-device engine on the same seed."""
    from kubernetes_gpu_cluster_tpu_torch.config import (
        CacheConfig, EngineConfig, SchedulerConfig)
    from kubernetes_gpu_cluster_tpu_torch.engine import LLMEngine
    from kubernetes_gpu_cluster_tpu_torch.ops.cuda import flash_prefill_hist
    from kubernetes_gpu_cluster_tpu_torch.models import llama as M
    ps = 16
    if layers:
        cfg = cfg.replace(num_layers=layers)
    reqs = tp_requests(cfg.vocab_size, n_req=EP_REQS - 1, long_len=1400)
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(
        SEED), device)
    engine = LLMEngine(EngineConfig(
        model=cfg, seed=SEED, cache=CacheConfig(page_size=ps,
                                                num_pages=TP_PAGES // 2),
        scheduler=SchedulerConfig(max_num_seqs=TP_SEQS)), params=params,
        device=device)
    ref = drive(engine, reqs, "ep1", flash_prefill_hist)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn_ranks("12b", dict(model=cfg.name, quant="int4", tp=1, ep=2,
                                    layers=layers, page_size=ps,
                                    pages=TP_PAGES // 2,
                                    reqs=_req_spec(reqs)),
                        [0, 0], "gloo", timeout_s=600)
    _same_schedule("12b", ranks[0]["schedule"], ref["schedule"])
    ties: list = []
    equal = [rid for _, rid, prompt, _ in reqs if _held_forced(
        f"ep 2 {rid}", ranks[0]["tokens"][rid], ref["tokens"][rid], prompt,
        params, cfg, device, ties)]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    _launched("12b", ranks, ("int4_matmul", "paged_decode", "flash_prefill"))
    out = {"layers": cfg.num_layers, "ep1_tokens_per_s": ref["tokens_per_s"],
           "ep2_tokens_per_s": ranks[0]["tokens_per_s"],
           "kinds": ranks[0]["kinds"], "steps": len(ref["schedule"]),
           "same_schedule": True,
           "equal_to_ep1": f"{len(equal)} of {len(reqs)}", "near_ties": ties,
           "launches": [r["launches"] for r in ranks],
           "init_s": [r["init_s"] for r in ranks],
           "weight_gb": [r["weight_gb"] for r in ranks],
           "spawn_s": time.perf_counter() - t0}
    log(f"ep 2 (mixtral-8x7b int4, {cfg.num_layers} layers): "
        f"{ref['tokens_per_s']:.1f} tokens/s at ep 1, "
        f"{ranks[0]['tokens_per_s']:.1f} at ep 2 | {card}")
    return out


DRAIN_GRACE_S = 120.0   # the CLI's default --drain-grace-s
CLI_TP_PROMPTS = (2300, 300, 100, 700)   # 12e: the first one chunked
CLI_TP_TOKENS = 16


def cli_rank_child(spec: dict) -> None:
    """One rank of phase 12e: the server's CLI (``api_server.main`` with
    ``--distributed``) in this process, which first joins the group over
    gloo: two ranks share one card, where NCCL, the CLI's own choice on a
    card, refuses. Writes the kernel launches, counted from this rank's
    first admitted request, and the engine's tokens by prompt to
    ``spec["out"]``."""
    import torch.distributed as dist

    from kubernetes_gpu_cluster_tpu_torch.engine.engine import LLMEngine
    from kubernetes_gpu_cluster_tpu_torch.ops.cuda import (
        flash_prefill, flash_prefill_hist, paged_decode)
    from kubernetes_gpu_cluster_tpu_torch.parallel import \
        initialize_distributed
    from kubernetes_gpu_cluster_tpu_torch.serving import api_server
    initialize_distributed(backend="gloo", device=spec["device"],
                           timeout_s=300)
    counters = {"paged_decode": paged_decode, "flash_prefill": flash_prefill,
                "flash_prefill_hist": flash_prefill_hist}
    prompts, tokens = {}, {}
    add, step = LLMEngine.add_request, LLMEngine.step

    def counted_add(self, request_id, prompt_token_ids, *a, **k):
        if not prompts:
            for mod in counters.values():
                mod.launches = 0
        prompts[request_id] = list(prompt_token_ids)
        return add(self, request_id, prompt_token_ids, *a, **k)

    def recorded_step(self):
        outs = step(self)
        for out in outs:
            if out.finished:
                tokens[out.request_id] = list(out.output_token_ids)
        return outs
    LLMEngine.add_request, LLMEngine.step = counted_add, recorded_step
    try:
        api_server.main(spec["argv"])
    finally:
        Path(spec["out"]).write_text(json.dumps({
            "rank": spec["rank"],
            "launches": {n: m.launches if prompts else 0
                         for n, m in counters.items()},
            "requests": [[prompts[r], t] for r, t in tokens.items()]}))
        dist.destroy_process_group()


async def _drive_cli_tp(port: int, health: int, procs: list,
                        vocab: int, tag: str = "12e") -> dict:
    """12e's (13c's) requests: the long prompt first (chunked), the others
    half a second later, all greedy; the follower's /health while they
    run."""
    deadline = time.monotonic() + 600
    while True:
        for rank, p in enumerate(procs):
            if p.poll() is not None:
                raise RuntimeError(f"{tag}: rank {rank} exited {p.returncode} "
                                   "before serving")
        try:
            if (await http_call(port, "GET", "/health"))["status"] == 200:
                break
        except OSError:
            pass
        if time.monotonic() > deadline:
            raise RuntimeError(f"{tag}: rank 0 never answered /health")
        await asyncio.sleep(0.5)
    up_s = 600 - (deadline - time.monotonic())
    rng = np.random.default_rng(SEED + 12)
    prompts = [[int(t) for t in rng.integers(1, vocab, n)]
               for n in CLI_TP_PROMPTS]

    def complete(prompt):
        return http_call(port, "POST", "/v1/completions",
                         {"prompt": prompt, "max_tokens": CLI_TP_TOKENS,
                          "temperature": 0.0})
    t0 = time.perf_counter()
    first = asyncio.ensure_future(complete(prompts[0]))
    await asyncio.sleep(0.5)
    follower = await http_call(health, "GET", "/health")
    replies = [await first, *await asyncio.gather(
        *(complete(p) for p in prompts[1:]))]
    wall = time.perf_counter() - t0
    for r in replies:
        if r["status"] != 200:
            raise RuntimeError(f"{tag} request: {r['status']} "
                               f"{r['body'][:300]}")
    return {"up_s": up_s, "wall_s": wall, "follower_health": follower["status"],
            "prompts": prompts,
            "bodies": [json.loads(r["body"]) for r in replies]}


def check_cli_tp(cfg, params, device, card: str,
                 flag: str = "--tensor-parallel-size",
                 tag: str = "12e") -> dict:
    """Phase 12e (13c with ``flag`` --pipeline-parallel-size): the
    server's CLI at size 2 of ``flag``, two ``--distributed`` ranks on
    card 0 (each ``chip_smoke.py --cli-rank``). Requests over HTTP; the
    engine's tokens held to the one-device weights by teacher forcing; the
    attention kernels launched on both ranks; the follower's /health 200;
    SIGTERM drains rank 0, whose stop directive lets rank 1 exit, both
    with 0."""
    import signal
    work = REPO / "build" / f"cli-{tag}"
    work.mkdir(parents=True, exist_ok=True)
    port, health, ctrl = _free_port(), _free_port(), _free_port()
    coord = f"127.0.0.1:{_free_port()}"
    procs, logs = [], []
    for rank in range(2):
        out = work / f"rank{rank}.json"
        out.unlink(missing_ok=True)
        env = dict(os.environ, TMPDIR=str(work),
                   KGCT_FLIGHT_DIR=str(work / "flight"),
                   GLOO_SOCKET_IFNAME="lo", KGCT_COORDINATOR=coord,
                   KGCT_NUM_PROCESSES="2", KGCT_PROCESS_ID=str(rank),
                   KGCT_CONTROL_PORT=str(ctrl),
                   KGCT_FOLLOWER_ADDRS=f"127.0.0.1:{ctrl}")
        argv = ["--model", MODEL, flag, "2",
                "--distributed", "--device", "cuda:0",
                "--hbm-utilization", "0.1", "--max-num-seqs", "8",
                "--host", "127.0.0.1",
                "--port", str(port if rank == 0 else health)]
        logs.append(open(work / f"rank{rank}.log", "w"))
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--cli-rank",
             json.dumps({"rank": rank, "device": "cuda:0", "argv": argv,
                         "out": str(out)})],
            cwd=REPO, env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
    try:
        res = asyncio.run(_drive_cli_tp(port, health, procs, cfg.vocab_size,
                                        tag))
        t0 = time.perf_counter()
        procs[0].send_signal(signal.SIGTERM)
        rcs = [procs[0].wait(timeout=DRAIN_GRACE_S),
               procs[1].wait(timeout=ABORT_BOUND_S)]
        res["sigterm_exit_s"] = time.perf_counter() - t0
        if rcs != [0, 0]:
            raise RuntimeError(f"{tag}: the ranks exited {rcs} after SIGTERM")
    except BaseException:
        for rank, f in enumerate(logs):
            f.flush()
            log(f"{tag} rank {rank} log tail:\n"
                + (work / f"rank{rank}.log").read_text()[-4000:])
        raise
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    ranks = [json.loads((work / f"rank{r}.json").read_text())
             for r in range(2)]
    _launched(tag, ranks, ("paged_decode", "flash_prefill",
                             "flash_prefill_hist"))
    if res["follower_health"] != 200:
        raise RuntimeError(f"{tag}: follower /health {res['follower_health']}")
    served = {tuple(p): t for p, t in ranks[0]["requests"]}
    ties: list = []
    for i, (prompt, body) in enumerate(zip(res.pop("prompts"),
                                           res.pop("bodies"))):
        toks = served.get(tuple(prompt))
        if toks is None or body["usage"]["completion_tokens"] != len(toks):
            raise RuntimeError(f"{tag} request {i}: the engine served "
                               f"{None if toks is None else len(toks)} "
                               f"tokens, the reply says {body['usage']}")
        _held_forced(f"{tag} request {i}", toks, None, prompt, params, cfg,
                     device, ties)
    res.update(launches=[r["launches"] for r in ranks], near_ties=ties)
    log(f"CLI {flag} 2 ({tag}): up in {res['up_s']:.1f} s, "
        f"{len(CLI_TP_PROMPTS)} requests in {res['wall_s']:.2f} s | {card}")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from kubernetes_gpu_cluster_tpu_torch.config import (
        CacheConfig, EngineConfig, SchedulerConfig, get_model_config)
    from kubernetes_gpu_cluster_tpu_torch.engine.engine import \
        DEFAULT_PAGE_SIZE
    from kubernetes_gpu_cluster_tpu_torch.models import llama as M
    from kubernetes_gpu_cluster_tpu_torch.ops import attention as A
    from kubernetes_gpu_cluster_tpu_torch.ops import quant as Q
    from kubernetes_gpu_cluster_tpu_torch.ops.cuda import (
        build, flash_prefill, flash_prefill_hist, int4_matmul, paged_decode)

    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log("card:", card, "|", kind, "| torch", torch.__version__,
        "cuda", torch.version.cuda)

    t_phase = [time.perf_counter()]

    def phase(name: str) -> None:
        now = time.perf_counter()
        log(f"phase {name}: {now - t_phase[0]:.1f} s")
        t_phase[0] = now

    # Phase 1: build.
    secs = build.build()
    log(f"kernels built in {secs:.1f} s")
    for name, text in build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "error" in line.lower():
                log(f"  [{name}] {line.strip()}")
    phase("build (1)")

    cfg = get_model_config(MODEL)
    ps = DEFAULT_PAGE_SIZE

    # Phase 2: kernels.
    rows = check_kernels(cfg, ps, cfg.max_model_len, device)
    rows.append(check_int4(cfg, device))
    for r in rows:
        log("kernel:", json.dumps(r))
    gc.collect()
    torch.cuda.empty_cache()
    phase("kernels (2)")

    # Phase 3: model parity.
    gen = torch.Generator(device=device).manual_seed(SEED)
    t0 = time.perf_counter()
    params = M.init_params(cfg, gen, device)
    torch.cuda.synchronize()
    log(f"random {MODEL} weights in {time.perf_counter() - t0:.1f} s")
    attn_plain = [(M, "ragged_prefill_attention",
                   A.ragged_prefill_attention_plain),
                  (M, "paged_decode_attention", A.paged_decode_attention_plain)]
    log("model:", json.dumps(check_model(params, cfg, ps, device,
                                         attn_plain)))

    # Phase 4: engine.
    cfg_engine = EngineConfig(
        model=cfg, seed=SEED,
        cache=CacheConfig(page_size=ps, num_pages=6144),
        scheduler=SchedulerConfig(max_num_seqs=32))
    attn = {"paged_decode": paged_decode, "flash_prefill": flash_prefill,
            "flash_prefill_hist": flash_prefill_hist}
    eng = check_engine(cfg_engine, params, device, attn,
                       workload(cfg.vocab_size))
    gc.collect()
    torch.cuda.empty_cache()

    # Phase 5: async front door.
    cfg_async = dataclasses.replace(
        cfg_engine, cache=CacheConfig(page_size=ps, num_pages=1024))
    log("async:", json.dumps(check_async(cfg_async, params, device)))
    phase(f"{MODEL} bf16 (3, 4, 5)")

    # Phase 9a: the OpenAI server in this process on the same weights.
    log("server:", json.dumps(check_server(cfg_engine, params, device,
                                           attn)), "|", card)
    phase(f"{MODEL} bf16 server (9a)")

    # Phase 7a: n-gram speculative decoding on the same weights.
    log("spec ngram:", json.dumps(check_spec_ngram(cfg_engine, params, device,
                                                   attn)))
    phase(f"{MODEL} bf16 spec (7a)")

    # Phase 8: the KV transfer layer on the same weights.
    swap = check_swap(cfg_engine, params, device, attn, SWAP_GB,
                      near_ties_only=False)
    swap["link"] = link_bound(device)
    log("swap:", json.dumps(swap), "|", card)
    log("handoff:", json.dumps(check_handoff(cfg_engine, params, device,
                                             attn)), "|", card)
    log("prefix spill:", json.dumps(check_prefix_spill(
        cfg_engine, params, device, attn)), "|", card)
    phase(f"{MODEL} bf16 KV transfer (8)")

    # Phase 10: the fleet plane on the same weights.
    log("fleet:", json.dumps(check_fleet(cfg_engine, params, device, attn)),
        "|", card)
    phase(f"{MODEL} bf16 fleet plane (10)")

    # Phase 11: the router in front of replicas on the same weights.
    log("router:", json.dumps(check_router(cfg_engine, params, device,
                                           attn)), "|", card)
    gc.collect()
    torch.cuda.empty_cache()
    phase(f"{MODEL} bf16 router (11)")

    # Phases 12 and 12c: tp 2 as two ranks on this card (gloo), held to
    # the tp=1 tokens of these weights; then the group abort.
    log("tp:", json.dumps(check_tp(cfg, params, device, card, [0, 0],
                                   "gloo", abort=True)), "|", card)
    phase(f"{MODEL} bf16 tp 2 (12, 12c)")
    # Phase 12e: the server's CLI at tp 2, two --distributed ranks.
    log("cli tp:", json.dumps(check_cli_tp(cfg, params, device, card)), "|",
        card)
    phase(f"{MODEL} bf16 CLI tp 2 (12e)")
    # Phases 13 and 13b: pp 2 and sp 2 as two ranks on this card (gloo),
    # held to the one-device engine with mixed off; 13c the CLI at pp 2.
    log("pp:", json.dumps(check_pp_sp(cfg, params, device, card, "pp")),
        "|", card)
    phase(f"{MODEL} bf16 pp 2 (13)")
    log("sp:", json.dumps(check_pp_sp(cfg, params, device, card, "sp")),
        "|", card)
    phase(f"{MODEL} bf16 sp 2 (13b)")
    log("cli pp:", json.dumps(check_cli_tp(
        cfg, params, device, card, "--pipeline-parallel-size", "13c")), "|",
        card)
    phase(f"{MODEL} bf16 CLI pp 2 (13c)")
    # Phase 12d: the same over NCCL, where two cards exist.
    if torch.cuda.device_count() >= 2:
        log("nccl tp:", json.dumps(check_tp(cfg, params, device, card,
                                            [0, 1], "nccl", abort=False)))
        phase(f"{MODEL} bf16 nccl tp 2 (12d)")
    else:
        log("nccl tp: not run (1 card)")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # Phase 12b: expert parallelism, mixtral-8x7b int4 at ep 2.
    log("ep:", json.dumps(check_ep(get_model_config("mixtral-8x7b").replace(
        quantization="int4", quant_group_size=GROUP), device, card,
        EP_LAYERS)), "|", card)
    phase("mixtral-8x7b int4 ep 2 (12b)")

    # Phase 3b: the int4 model, kernel against int4_matmul_plain.
    cfg4 = cfg.replace(quantization="int4", quant_group_size=GROUP)
    params = M.init_params(cfg4, gen, device)
    log("model int4:", json.dumps(check_model(
        params, cfg4, ps, device, [(Q, "int4_matmul", Q.int4_matmul_plain)])))
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # Phase 4b: the int4 engine (random packed weights from the seed).
    cfg_engine4 = dataclasses.replace(
        cfg_engine, model=cfg4, cache=CacheConfig(page_size=ps,
                                                  num_pages=2048))
    eng4 = check_engine(cfg_engine4, None, device,
                        {**attn, "int4_matmul": int4_matmul},
                        workload(cfg.vocab_size, n_req=12, long_len=2500,
                                 max_prompt=768, wave=1))
    gc.collect()
    torch.cuda.empty_cache()

    # Phase 4c: the int8 engine.
    cfg_engine8 = dataclasses.replace(
        cfg_engine, model=cfg.replace(quantization="int8"),
        cache=CacheConfig(page_size=ps),
        scheduler=SchedulerConfig(max_num_seqs=8))
    log("engine int8:", json.dumps(check_int8_engine(cfg_engine8, device)))

    gc.collect()
    torch.cuda.empty_cache()
    phase("int4 and int8 (3b, 4b, 4c)")

    # Phases 6a/6b: the other model families.
    for preset, quant, wl, sched, pages in FAMILIES:
        fam = check_family(get_model_config(preset).replace(
            quantization=quant, quant_group_size=GROUP), wl, sched, pages,
            device, attn, attn_plain)
        log(f"family {preset}:", json.dumps(
            {"tokens_per_s": fam["engine"]["run1"]["tokens_per_s"],
             "launches": fam["engine"]["launches"],
             "kinds": fam["engine"]["run1"]["kinds"],
             "model": fam["model"], "weight_gb": fam["weight_gb"],
             "init_s": fam["init_s"], "model_s": fam["model_s"],
             "engine_s": fam["engine_s"]}))
        phase(f"family {preset}")

    # Phase 7b: draft-model speculative decoding.
    cfg_tiny = get_model_config("tinyllama-1.1b").replace(dtype="float32")
    params = M.init_params(cfg_tiny, torch.Generator(
        device=device).manual_seed(SEED), device)
    log("spec draft:", json.dumps(check_spec_draft(cfg_tiny, params, device,
                                                   attn)))
    phase("tinyllama-1.1b fp32 draft spec (7b)")

    # Phase 8d: swap on the same fp32 weights, held to the never-preempted
    # engine but for near-ties.
    cfg_tiny_engine = EngineConfig(model=cfg_tiny, seed=SEED,
                                   cache=CacheConfig(page_size=ps))
    log("swap fp32:", json.dumps(check_swap(
        cfg_tiny_engine, params, device, attn, SWAP_GB_FP32,
        near_ties_only=True)), "|", card)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    phase("tinyllama-1.1b fp32 swap (8d)")

    # Phase 9b: the CLI server in a subprocess.
    log("cli:", json.dumps(check_cli(cfg_tiny.vocab_size)), "|", card)
    phase("tinyllama-1.1b int4 CLI (9b)")

    eng["launches"]["int4_matmul"] = eng4["launches"]["int4_matmul"]
    for r in rows:
        r["launches"] = eng["launches"][r["name"]]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tp-child"]:
        tp_child(json.loads(sys.argv[2]))
        sys.exit(0)
    if sys.argv[1:2] == ["--cli-rank"]:
        cli_rank_child(json.loads(sys.argv[2]))
        sys.exit(0)
    sys.exit(main())
