#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``kubernetes_gpu_cluster_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. Card: name and power limit; the kernels built from ``csrc/`` with nvcc
   through the serving image's own command (``python -m BUILD_MODULE`` in
   a child, as ``docker/Dockerfile.cuda-serving``'s kernel stage runs it)
   into the kernel directory (``KGCT_KERNEL_DIR``, set for every child);
   the in-process loader must then find every stamp current
   (``build.build()`` returns 0.0).
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
   chunk over 6000; int4 at a 2048-row prefill, w_down and lm_head. Then
   the verify attention kernel (no TPU kernel: the JAX package computes
   it in XLA), R 32 rows of S 5 over contexts 512-2048 on the engine's
   whole 512-page table, beside ``paged_decode`` at the same rows; logged
   only: two padding rows, S 9, opt-125m's heads (bf16, hd 64) and
   tinyllama-1.1b's (fp32, hd 64).
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
    four attention kernels launched, the verify kernel's count in run 1
    is its ``launches``), and once by the spec-off engine. Logged:
    tokens/s on and off, the acceptance ratio, the share of greedy
    requests whose tokens equal spec off (bf16: the verify and decode
    kernels round differently, so near-ties may flip).
7b. tinyllama-1.1b fp32 at full width and depth, drafting for itself (the
    draft model's own pool, the target's weights: an oracle), k 4,
    adaptive k and mixed batching on: acceptance >= 0.9, ``paged_decode``
    launched by the draft runner, and greedy tokens equal to the spec-off
    engine on every request, except where the printed top-2 logit gap at
    the first differing position is below 1e-3 of that position's logit
    standard deviation (counted).
16g. The spec family's step programs (``("spec", R, S)``,
    ``("spec_mixed", Tp, R, W, S)``, the draft runner's ``("draft_decode",
    B)`` and ``("draft_prefill", T, W)``), run inside 7a and 7b: each spec
    engine there is captured, and an ``enforce_eager`` twin serves the
    same requests (logprobs on): greedy and seeded tokens and logprobs
    identical, drafted and accepted totals equal, the twin builds
    nothing. Logged: programs by family, 7a's repeat run building 0 new
    programs, ``kgct_jit_compiles_total`` equal to the programs built,
    tokens/s captured against eager and against spec off captured, and
    the verify programs' sampling stage (``_verify_rows``) at R 32, S 5
    beside one position's, each with its gates closed, at the sampled mix
    and all open (``gated_graph_ms``: one graph, its conditional nodes
    replayed at each mix of flags). Phase 16's census must find no
    synchronizing call left in the spec steps or the draft round.

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
8a-8c run their KV transfers as step programs (``("kv_gather", n_pad)``,
    ``("kv_scatter", n_pad)``): each phase logs its transfer programs by
    family, each a power of two no larger than the largest bucket; 8a's
    repeat builds none, its ``kgct_jit_compiles_total`` counts them, and
    each transfer key's capture seconds and pool growth are logged. Every
    exported buffer equals the pages it came from and every imported page
    the buffer, bit for bit. Beside each captured engine an
    ``enforce_eager`` twin serves the same requests (8a: run 1; 8b, 8c:
    the whole flow), with the same preemptions, tokens and moved bytes.

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
    8 seats, 0.3 of the free memory, prefix caching on): ``/health``
    polled until it answers, plain, streamed and chat requests and a
    1500-token prompt, then a long stream during which
    ``POST /debug/profile?seconds=5`` captures a torch.profiler trace
    while that prompt extended by 64 tokens (a prefix hit: the new tokens
    prefill over the cached pages) and then a wave of short prompts (a
    packed prefill step) arrive (their steps may capture new program
    keys inside the window; 2 s did not always hold them); the trace must hold CUDA kernel events of all four kernels
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
     the TTFT beside D's. Each server's ``kgct_jit_compiles_total`` over
     HTTP equals its engine's programs, its KV gather (P) or scatter (D)
     programs among them.
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

Then the analysis package, in this process on the phase-4 weights
(``kubernetes_gpu_cluster_tpu_torch/analysis``; a wrapper in this script
counts each sanitizer hook's calls and host seconds and refuses any
device tensor handed to one):

15a. An engine built with ``KGCT_SANITIZE=1`` and a plain one (80-page
     pool, 1 GB host tier, n-gram spec k 4, mixed batching on) serve ten
     greedy and one seeded requests (six at step 0, then one every three
     steps; half repeat a pattern): identical tokens; decode-window, spec,
     spec×mixed, swap-restore and output hooks each checked > 0; swap
     preemptions; the three attention kernels launched (counts set to 0
     just before the sanitized run). Logged: tokens/s both ways, the
     hooks' host ms per step.
15b. ``nan_step_output`` raises ``SanitizerError`` in the ``step()`` call
     whose fetched window it poisoned. ``kv_commit_stomp`` aims row 0's
     first draft write at its committed position 0: with the sanitizer
     off, that slot's pool bytes change; with it on, the step is refused
     before any upload and the bytes are unchanged.
15c. Both 15a engines again under ``torch.cuda.set_sync_debug_mode``:
     the same count of synchronizing calls at each source line (0 since
     the KV transfers upload their page indices through pinned buffers),
     and a known synchronizing call counted (the count is live).
15d. ``AsyncLLMEngine`` with ``KGCT_SANITIZE_INTERLEAVE=1`` under seeds
     1-3 and unperturbed, four concurrent streams: a seed that stepped the
     unperturbed schedule gives its tokens exactly; one whose yields moved
     an admission is held by ``_held_forced``.
15e. The draft-model proposer (the phase-4 model drafting for itself)
     with ``KGCT_SANITIZE=1``: ``check_feed`` on every planned feed, the
     tokens of a plain run.
15f. ``kgct-torch-lint`` over the port: ``0 finding(s) (21 rule(s))``.

Then the decode window's step programs (``engine/step_programs.py``: every
card engine captures each (greedy|sampled, decode bucket) window once into
a CUDA graph and replays it; ``enforce_eager`` engines run it eagerly), on
the phase-4 weights right after phase 15:

16a. A server's engine (512 pages, 32 seats) and an ``enforce_eager``
     engine on the same weights serve the same waves: per bucket 1-32 a
     greedy wave, a wave of every sampled kind (seeded, unseeded, top-k
     50 with top-p 0.95, top-k 1000, flat logits at temperature 5 with
     top_p 0.9999, greedy rows with presence and frequency penalties, a
     logit bias and top logprobs, seeded with a penalty) and one without
     the full-sort row; 16-64-token prompts and 25 new tokens, so every
     wave decodes at its bucket through chained windows. Greedy and seeded
     rows give the same tokens both ways (logprobs' largest difference
     logged); the captured engine holds the 12 programs (greedy|sampled x
     buckets 1-32), the eager one none. Logged: captures, seconds per
     capture, the shared pool's bytes.
16b. One unseeded request's consecutive windows carry different step
     keys, and the ("sampled", 32) program replayed on the same inputs
     (turned unseeded) with keys k1, k2, k1 gives k1's first-substep
     tokens twice and others under k2: the key is an input of the graph,
     not a constant.
16c. The 16a waves again on the captured engine: 0 new captures; its
     ``/metrics`` (the server's own app on a free port) reads
     ``kgct_jit_compiles_total`` equal to the engine's count.
     Then phase 4's workload on a captured and an ``enforce_eager``
     engine in turns (eager, captured, captured, eager): tokens/s, the
     same tokens; and 15a's workload on both under
     ``torch.cuda.set_sync_debug_mode``: synchronizing calls per step by
     source line (15c's census), the same tokens, none in the spec steps
     (their fetch is one pinned copy and an event).
16d. A window body with a host read (``int()`` of an output) injected:
     the engine raises ``CaptureError`` at the window's capture, the
     window is not run on eagerly, the card still works after it, and the
     caching allocator releases the engine's memory (reserved bytes back
     within 256 MiB of before it).
16e. (After 4b, on its int4 weights) phase 4b's workload on a captured
     and an ``enforce_eager`` int4 engine: the same tokens; the int4
     kernel recorded in the captured programs and its launches equal
     both ways (a replay counts what its graph recorded). Then n-gram
     speculation on the same weights, four repetitive requests both ways:
     the same tokens and logprobs, the int4 and verify kernels recorded
     in every spec program.

Then tensor and expert parallelism, each rank a child process
(``chip_smoke.py --tp-child``) that builds its engine from the seed,
drawing each full tensor and keeping its slice; the script first records
the one-device engine's greedy tokens for the same requests. 12, 12c and
13b run llama-3-8b at full width cut to ``RANK_LAYERS`` layers, drawn from
the seed at that depth (two ranks on one card over gloo stage every
layer's all-reduce through host memory, which sets their pace); 13, whose
stage split depends on the depth, and 12e, 13c and 14-14b keep the
phase-4 weights at full depth:

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
     pool each; the embedding and head whole on both),
     phase 12's requests through ``AsyncLLMEngine(leader=)``. pp turns mixed
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
14.  The phase-4 weights written as an HF safetensors checkpoint in
     ``CKPT_FILES`` files (plain Python: header length, JSON header, raw
     bytes; the card's machine has no ``safetensors``) under
     ``build/llama-3-8b``, a name that maps ``--model <dir>`` to the
     preset, at full depth (``CKPT_LAYERS``). Logged: GB and seconds.
14a. The streamed load: two ranks on card 0 over gloo (``--tp-child``
     with ``weights``) at tp 2 and at pp 2 each read only their byte
     ranges of the checkpoint; every local tensor is ``torch.equal`` to
     ``shard_tensor`` of phase 4's draw of the full tensor; each logs its
     load seconds and host peak (the resident set's growth over the load,
     ``engine.weights.HostPeak``). A separate process logs the same for
     the whole-then-slice path (the whole load on the host, then
     ``shard_params``), run beside the ranks. The tp 2 ranks then serve
     the long request and ``STREAMED_REQS`` more of phase 12's, held to
     their tp=1 run at full depth as 12 holds its ranks.
14b. Manifests rendered from values whose ``modelURL`` is the checkpoint:
     the ``requestGPU: 1`` Deployment's container (its module and args,
     ``--tokenizer byte`` appended through ``extraArgs``: the rendered
     ``--tokenizer <modelURL>`` needs ``transformers``) on card 0; its
     readiness probe answered, four completions held to the in-process
     engine, exit 0 within the rendered grace after SIGTERM. The pod runs
     as in the runtime image: no directory that holds ``nvcc`` on ``PATH``,
     no ``CUDA_HOME``, no ``CUDA_PATH``, ``KGCT_KERNEL_DIR`` phase 1's
     directory, whose libraries, stamps and ptxas reports must keep their
     sizes and mtimes (nothing rebuilt). Then the
     ``pipelineParallelSize: 2`` StatefulSet's two pods as two ranks on
     card 0 through 13c's harness, each streaming its stage, held as 13c.
     The checkpoint directory is deleted at the end, on failure too.
14c. The image's refusals, each a child with no ``nvcc`` reachable: (a)
     ``build.library("paged_decode")`` over an empty kernel directory exits
     non-zero naming the kernel and the directory; (b) the server's CLI at
     ``--tensor-parallel-size`` one above the cards seen exits non-zero
     within ``REFUSAL_BOUND_S`` with the start-time refusal, before any
     weight, and leaves no rank behind. Its children run in a thread of
     their own beside 12d and 12b (they load no weights), as do 18's.
18.  The node layer (``tools/node_layer.py``): the H100 device plugin and
     its kubelet stand-in (``cluster/device-plugin-cuda``) built by its
     Makefile; the plugin's ``--write-cdi-spec``
     lists, UUID for UUID, what ``nvidia-smi`` lists, as many as
     ``device_count()``; run with ``--plugin-dir`` in a temporary directory,
     it registers ``nvidia.com/gpu`` at ``kgct-cuda.sock`` with the stand-in,
     whose ``Allocate`` of each UUID returns character devices and
     read-only mounts of regular files at the driver's version, and of an
     unknown ID ``NOT_FOUND``; a child with an empty environment but
     ``LD_LIBRARY_PATH`` (links named as the mounts) and
     ``CUDA_VISIBLE_DEVICES`` initializes CUDA, sees one device, the
     allocated node, JIT-loads a PTX module and maps no driver library
     from outside the mounts; the mounted ``nvidia-smi -L`` lists the UUID;
     SIGTERM ends the plugin within 2 s, its socket removed. Logged: build
     seconds, start-to-register ms, ``Allocate`` microseconds. Beside 12d
     and 12b.
12d. With two cards, phase 12 over NCCL on cards 0 and 1; with one, the
     line ``nccl tp: not run (1 card)``.
12b. ep 2: mixtral-8x7b int4 at tp 1, ep 2, full width (depth
     ``EP_LAYERS``, None for all 32), two ranks on card 0, four requests,
     the same token check against the one-device engine; ``int4_matmul``
     launches on both ranks.

Last, the entry twin:

17. ``graft_entry.entry()`` on the card (tinyllama-1.1b bf16 at full
    width and depth, random weights from seed 0; its strict probes of
    ``paged_decode`` and ``flash_prefill`` first): the decode step of
    batch 8 run eagerly (``paged_decode`` launched), through the plain
    attention version, and captured with ``torch.cuda.graph`` and
    replayed: the same tokens all three ways; the replay's device ms
    beside one ``paged_decode`` call at the step's shapes.

The line before the last is the ``kernels`` JSON record (the four TPU
kernels' ports and the verify kernel); the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
with code 2 and prints no result.
"""

from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import contextlib
import dataclasses
import gc
import itertools
import json
import os
import shutil
import subprocess
import sys
import time
import warnings
from pathlib import Path
from typing import Optional
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


# Every process this script starts is started by ``start_child`` and asks
# the kernel to be killed when this process dies (``die_with_parent``, the
# first thing each child does), so none outlives the script, however it
# ends: a failed phase kills its children in its ``finally``, the time
# limit and SIGTERM raise ``Stopped`` (``main``'s ``finally`` kills what is
# left), and a SIGKILL of this process reaches each child through the
# kernel.
# The serving image's kernel stage runs ``python -m BUILD_MODULE``
# (docker/Dockerfile.cuda-serving); phase 1 runs the same.
BUILD_MODULE = "kubernetes_gpu_cluster_tpu_torch.ops.cuda.build"
PARENT_ENV = "KGCT_SMOKE_PARENT"
PR_SET_PDEATHSIG = 1
RUN_LIMIT_S = 1140          # the whole run, the build included
# Phase 4's and 7a's tokens/s on the tree before the step programs' stages
# were gated (commit 483ea15), printed beside this run's:
# ``tools/spec_vs_parent.py --parent`` (that tree) in one call on an NVIDIA
# H100 80GB HBM3 at 700.00 W, order parent, tree, tree, parent; the
# parent's two children, in order (7a: each child's first engine). Run 1
# holds the captures. Compare two trees only within one call.
UNGATED_TOKENS_PER_S = {
    "4": {"run_1": [182.6672819358523, 181.84976935344633],
          "run_2": [548.6547133204442, 566.0284226921681]},
    "7a": {"run_1": [233.80219596177596, 239.13055687086597],
           "run_2": [487.0392217949685, 482.5553504667722]}}
_CHILDREN: list = []
# A child that runs a module (the server's and the router's CLIs) asks
# for the same before it imports anything.
_MODULE_CHILD = (
    "import ctypes, os, runpy, signal, sys\n"
    f"ctypes.CDLL(None).prctl({PR_SET_PDEATHSIG}, signal.SIGKILL, 0, 0, 0)\n"
    f"if os.getppid() != int(os.environ[{PARENT_ENV!r}]):\n"
    "    os._exit(1)\n"
    "sys.argv = sys.argv[1:]\n"
    "runpy.run_module(sys.argv[0], run_name='__main__', alter_sys=True)\n")


class Stopped(BaseException):
    """The run's time limit or a SIGTERM: the phase in progress unwinds
    (killing its children) and the run fails."""


def start_child(args: list, module: Optional[str] = None,
                **popen) -> subprocess.Popen:
    """``chip_smoke.py`` with ``args`` (one of its child modes), or the
    module ``module`` run as ``__main__`` with ``args``, in a process that
    dies with this one."""
    env = dict(popen.pop("env", None) or os.environ)
    env[PARENT_ENV] = str(os.getpid())
    head = ([sys.executable, "-c", _MODULE_CHILD, module] if module else
            [sys.executable, str(Path(__file__).resolve())])
    proc = subprocess.Popen([*head, *args], env=env, **popen)
    _CHILDREN.append(proc)
    return proc


def die_with_parent() -> None:
    """In a child of ``start_child``: SIGKILL when the parent dies; exit
    at once if it died already."""
    import ctypes
    import signal
    ctypes.CDLL(None).prctl(PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0)
    if os.getppid() != int(os.environ[PARENT_ENV]):
        os._exit(1)


def kill_children() -> None:
    """Kill and reap every child still running."""
    for p in _CHILDREN:
        if p.poll() is None:
            p.kill()
    for p in _CHILDREN:
        with contextlib.suppress(subprocess.TimeoutExpired):
            p.wait(timeout=30)


def host_memory() -> dict:
    """GB of this process's resident set (now and its peak), of the host's
    available memory and, under a cgroup v2 limit, of the cgroup's use."""
    gb = {}
    for path, keys in (("/proc/self/status", ("VmRSS", "VmHWM")),
                       ("/proc/meminfo", ("MemAvailable",))):
        with contextlib.suppress(OSError):
            for line in Path(path).read_text().splitlines():
                k, _, v = line.partition(":")
                if k in keys:
                    gb[k] = round(int(v.split()[0]) / 2**20, 3)
    for k in ("memory.current", "memory.peak", "memory.max"):
        with contextlib.suppress(OSError, ValueError):
            gb[k] = round(int(Path("/sys/fs/cgroup", k).read_text())
                          / 2**30, 3)
    return gb


def mount_of(path: Path) -> dict:
    """The mount that holds ``path``: its point and filesystem type."""
    best = ("", "?")
    with contextlib.suppress(OSError):
        for line in Path("/proc/mounts").read_text().splitlines():
            _, point, fs = line.split()[:3]
            if str(path).startswith(point) and len(point) > len(best[0]):
                best = (point, fs)
    return {"mount": best[0], "fs": best[1]}


def release_host_cache() -> None:
    """Return PyTorch's cached pinned host blocks to the system (the
    engines stage their uploads in pinned memory)."""
    gc.collect()
    torch.cuda.empty_cache()
    if hasattr(torch._C, "_host_emptyCache"):
        torch._C._host_emptyCache()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def build_kernels(build, card: str) -> dict:
    """Phase 1: ``python -m BUILD_MODULE`` in a child builds every kernel
    into the kernel directory; this process's loader must then read every
    stamp current (``build.build()`` returns 0.0)."""
    t0 = time.perf_counter()
    proc = start_child([], module=BUILD_MODULE, cwd=REPO,
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True)
    out, _ = proc.communicate(timeout=900)
    secs = time.perf_counter() - t0
    for line in out.splitlines():
        log(f"  {line.rstrip()}")
    if proc.returncode != 0:
        raise RuntimeError(f"phase 1: {BUILD_MODULE} exited "
                           f"{proc.returncode}")
    in_process = build.build()
    if in_process != 0.0:
        raise RuntimeError(f"phase 1: the loader rebuilt for {in_process} s "
                           "after the build command: stamps not current")
    per_kernel = {}
    for line in out.splitlines():
        name, _, rest = line.partition(": built in ")
        if rest:
            per_kernel[name.strip()] = float(rest.split()[0])
    # The verify kernel's bf16 instances (TMA ring, wgmma): registers,
    # shared memory and spills as ptxas reported them when the library was
    # built (kept beside it, so a current library has them too); a spill
    # fails.
    verify = [f for f in build.ptxas_of("spec_verify") or []
              if "spec_verify_kernel" in f["function"]]
    log("spec_verify ptxas (bf16 kernel):", json.dumps(verify))
    if not verify or any(f.get("spill_stores", 0) or f.get("spill_loads", 0)
                         for f in verify):
        raise RuntimeError(f"phase 1: spec_verify's bf16 kernel spills or "
                           f"was not reported: {verify}")
    res = {"dir": str(build.kernel_dir()), "command_s": secs,
           "kernels_s": per_kernel, "in_process_s": in_process,
           "spec_verify_ptxas": verify}
    log(f"kernels built by {BUILD_MODULE} in {secs:.1f} s "
        f"{json.dumps(per_kernel)}; in-process check {in_process} s | {card}")
    return res


def without_nvcc(env: dict, kernel_dir: Path) -> dict:
    """``env`` as the runtime image gives it: no directory that holds
    ``nvcc`` on ``PATH``, no ``CUDA_HOME``, no ``CUDA_PATH``; the kernels
    from ``kernel_dir``. The interpreter is started by its full path and
    ``libcuda`` comes from the dynamic loader's cache, so both stay
    reachable."""
    env = {k: v for k, v in env.items() if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = os.pathsep.join(
        d for d in env.get("PATH", "").split(os.pathsep)
        if d and not (Path(d) / "nvcc").exists())
    env["KGCT_KERNEL_DIR"] = str(kernel_dir)
    if shutil.which("nvcc", path=env["PATH"]):
        raise RuntimeError(f"nvcc still on PATH {env['PATH']}")
    return env


def kernel_files(kernel_dir: Path) -> dict:
    """Size and mtime of every file in ``kernel_dir``: each kernel's
    library, stamp and ptxas report."""
    return {p.name: (p.stat().st_size, p.stat().st_mtime_ns)
            for p in sorted(kernel_dir.iterdir()) if p.is_file()}


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
    (which exceeds a decode-sized kernel's run time) is not counted. The
    capture takes one scratch set for its calls, as an engine's does."""
    from kubernetes_gpu_cluster_tpu_torch.ops import cuda as cuda_ops
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with cuda_ops.capture_scratch() as scratch, torch.cuda.graph(graph):
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
    del graph, scratch
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
    as the engine calls it (n_valid computed once beforehand, hist_len an
    int32 [1] on the card), timed in a CUDA graph."""
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
            torch.from_numpy(table).to(device),
            torch.tensor([hist], dtype=torch.int32, device=device),
            hd ** -0.5)
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


def _verify_case(gen, rng, R, S, ctx_lo, ctx_hi, nh, n_kv, hd, ps, pps, dt,
                 device, padding: int = 0) -> dict:
    """spec_verify on R rows of S queries, contexts drawn from [ctx_lo,
    ctx_hi] (the last ``padding`` rows padding rows, context 0, on the
    scrap page), over the engine's whole ``pps``-page table (layer 1 of a
    2-layer pool), against the plain version; the kernel called as the
    engine calls it, timed in a CUDA graph, beside ``paged_decode`` on the
    same pool, tables and contexts (one query a row). Bound: the inputs
    and the output moved once, each row's history read once, against the
    operations over each row's history and causal slice at the peak of
    the kernel's type (the bf16 tensor cores, or fp32 outside them)."""
    from kubernetes_gpu_cluster_tpu_torch.ops import attention as A
    from kubernetes_gpu_cluster_tpu_torch.ops.cuda import spec_verify as sv
    dec = _decode_case(gen, rng, R, ctx_lo, ctx_hi, nh, n_kv, hd, ps, pps,
                       dt, device)
    _, kpool, vpool, tables, ctx, _, _, scale = dec["args"]
    if padding:
        ctx[R - padding:] = 0
        tables[R - padding:] = 0
    args = (_randn(gen, (R * S, nh, hd), dt, device),
            _randn(gen, (R * S, n_kv, hd), dt, device),
            _randn(gen, (R * S, n_kv, hd), dt, device), kpool, vpool,
            tables, ctx, scale)
    got = sv.spec_verify(*args, layer=1)
    ref = A.spec_verify_attention_plain(*args, layer=1)
    what = (f"spec_verify R={R} S={S} nh={nh} n_kv={n_kv} hd={hd} "
            f"{str(dt)[6:]}")
    err = _compare(what, got, ref)
    if not torch.equal(sv.spec_verify(*args, layer=1), got):
        raise RuntimeError(f"{what}: a second call gave other bits")
    item = 2 if dt == torch.bfloat16 else 4
    hist = int((ctx - 1).clamp(min=0).sum())
    nbytes = item * (R * S * (2 * nh * hd + 2 * n_kv * hd)
                     + 2 * n_kv * hd * hist) + 4 * (R * pps + R)
    flops = 4 * nh * hd * (S * hist + R * S * (S + 1) // 2)
    if dt == torch.bfloat16:
        bms, by = bound_ms(nbytes, flops)
    else:
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FP32_FLOPS * 1e3
        bms, by = ((t_bytes, "bytes") if t_bytes >= t_ops
                   else (t_ops, "operations"))
    kernel = lambda: sv.spec_verify(*args, layer=1)  # noqa: E731
    c = [int(x) for x in ctx.tolist() if x > 0]
    return dict(max_abs_err=err, ms=graph_ms(kernel, 20), bound_ms=bms,
                bound_by=by, kernel=kernel,
                plain=lambda: A.spec_verify_attention_plain(*args, layer=1),
                paged_decode_ms=dec["ms"],
                shape=f"R={R} S={S} ctx={min(c)}-{max(c)} padding={padding} "
                      f"ps={ps} pps={pps} nh={nh} n_kv={n_kv} hd={hd} "
                      f"{str(dt)[6:]}")


HIST_REPLAYS = (0, 952, 2048, 3000)   # history lengths of one captured launch


def _hist_replays(gen, rng, T, nh, n_kv, hd, ps, dt, device) -> dict:
    """One flash_prefill_hist launch (a T-token chunk, layer 1 of a 2-layer
    pool, a table covering the longest history) captured once in a CUDA
    graph, then replayed at each ``HIST_REPLAYS`` length written into its
    int32 [1] ``hist_len`` buffer, positions moved along: every replay
    against the plain version at that length. A length baked into the
    graph would give the first one's attention at every replay."""
    from kubernetes_gpu_cluster_tpu_torch.ops import attention as A
    from kubernetes_gpu_cluster_tpu_torch.ops.cuda import \
        flash_prefill_hist as fh
    from kubernetes_gpu_cluster_tpu_torch.utils import cdiv
    kd = n_kv * hd
    n_pages = cdiv(max(HIST_REPLAYS) + T, ps)
    P = n_pages + 1
    table = torch.from_numpy(rng.permutation(np.arange(1, P)).astype(
        np.int32)).to(device)
    seg = torch.zeros(T, dtype=torch.int32, device=device)
    hist = torch.zeros(1, dtype=torch.int32, device=device)
    pos = torch.arange(T, dtype=torch.int32, device=device)
    args = (_randn(gen, (T, nh, hd), dt, device),
            _randn(gen, (T, n_kv, hd), dt, device),
            _randn(gen, (T, n_kv, hd), dt, device), seg, pos,
            _randn(gen, (2, P, ps, kd), dt, device),
            _randn(gen, (2, P, ps, kd), dt, device), table, hist,
            hd ** -0.5)
    n_valid = fh.valid_tokens(seg)
    fh.flash_prefill_hist(*args, layer=1, n_valid=n_valid)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = fh.launches
    with torch.cuda.graph(graph):
        out = fh.flash_prefill_hist(*args, layer=1, n_valid=n_valid)
    fh.launches = before            # the capture launched nothing
    errs = {}
    for h in HIST_REPLAYS:
        hist.fill_(h)
        pos.copy_(torch.arange(h, h + T, dtype=torch.int32, device=device))
        graph.replay()
        errs[h] = _compare(f"flash_prefill_hist replay at hist {h}", out,
                           A.prefill_history_attention_plain(*args,
                                                             layer=1))
    del graph
    return {"chunk": T, "hist_len": list(HIST_REPLAYS),
            "max_abs_err": errs, "captures": 1,
            "replays": len(HIST_REPLAYS)}


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
    replays = _hist_replays(gen, rng, 512, nh, n_kv, hd, ps, dt, device)
    log("flash_prefill_hist captured once, replayed:", json.dumps(replays))
    rows[-1]["replays"] = replays

    # -- verify attention (no TPU kernel: the JAX package computes it in
    #    XLA): R 32 x S 5 over contexts 512-2048 on the engine's whole
    #    table (the row), beside paged_decode at the same rows; then logged
    #    only: a padding row, S 9, qwen2.5-7b's heads (g 7: 35 queries a
    #    kv head), and the hd-64 heads of opt-125m (bf16)
    #    and tinyllama-1.1b (fp32, phase 7b's dtype) over 128-page tables.
    case = _verify_case(gen, rng, 32, 5, 512, 2048, nh, n_kv, hd, ps, pps,
                        dt, device)
    rows.append(row("spec_verify", case,
                    "kubernetes_gpu_cluster_tpu/ops/attention.py:258"))
    rows[-1]["paged_decode_ms"] = case["paged_decode_ms"]
    rows[-1]["tpu_kernel"] = ("none: the JAX package computes it in XLA "
                              "(spec_verify_attention_xla)")
    del case
    for what, args in (
            ("padding row", (8, 5, 512, 2048, nh, n_kv, hd, ps, pps, dt)),
            ("S 9", (32, 9, 512, 2048, nh, n_kv, hd, ps, pps, dt)),
            ("qwen2.5-7b heads", (32, 5, 512, 2048, 28, 4, 128, ps, pps, dt)),
            ("opt-125m heads", (32, 5, 256, 1500, 12, 12, 64, ps, 128, dt)),
            ("tinyllama-1.1b heads fp32",
             (32, 5, 256, 1500, 32, 4, 64, ps, 128, torch.float32))):
        case = _verify_case(gen, rng, *args, device,
                            padding=2 if what == "padding row" else 0)
        log(f"spec_verify {what}:", json.dumps(
            {k: case[k] for k in ("ms", "bound_ms", "bound_by",
                                  "max_abs_err", "paged_decode_ms",
                                  "shape")}
            | {"ms_with_launch": cuda_ms(case["kernel"], 20),
               "plain_ms": cuda_ms(case["plain"], 3)}))
        del case
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
    logprobs = {}
    while pending or engine.has_unfinished_requests():
        while pending and pending[0][0] <= step:
            _, rid, prompt, sp = pending.pop(0)
            engine.add_request(f"{tag}-{rid}", prompt, sp)
        hist_before = hist_counter.launches
        for out in engine.step():
            if out.finished:
                final[out.request_id[len(tag) + 1:]] = out.output_token_ids
                logprobs[out.request_id[len(tag) + 1:]] = out.output_logprobs
        schedule.append(_step_record(engine, hist_counter, hist_before))
        if schedule[-1] is not None:
            kinds[schedule[-1][0]] += 1
        step += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_tok = sum(len(t) for t in final.values())
    return {"tokens": final, "kinds": kinds, "wall_s": wall,
            "generated_tokens": n_tok, "tokens_per_s": n_tok / wall,
            "steps": step, "schedule": schedule, "logprobs": logprobs}


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
    return {"run1": _summary(run1), "run2_tokens_per_s": run2["tokens_per_s"],
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
    return {k: v for k, v in run.items()
            if k not in ("tokens", "schedule", "logprobs")}


def _loggable(run) -> str:
    return json.dumps(_summary(run))


def _with_logprobs(reqs) -> list:
    """``reqs`` with every request asking for its logprobs."""
    return [(a, rid, p, dataclasses.replace(sp, logprobs=True))
            for a, rid, p, sp in reqs]


def _held_spec(what, got, ref, reqs) -> dict:
    """Greedy and seeded requests' tokens and logprobs of two runs must be
    identical (an unseeded row draws from its engine's generator)."""
    rows = [rid for _, rid, _, sp in reqs
            if sp.temperature == 0.0 or sp.seed is not None]
    diff = [rid for rid in rows
            if got["tokens"][rid] != ref["tokens"][rid]
            or got["logprobs"][rid] != ref["logprobs"][rid]]
    if diff:
        raise RuntimeError(f"{what}: captured and eager tokens or logprobs "
                           f"differ for {diff}")
    return {"rows_identical": len(rows), "requests": len(reqs)}


def _programs_by_family(eng) -> dict:
    keys = eng._programs.keys()
    return {f: len([k for k in keys if k[0] == f])
            for f in sorted({k[0] for k in keys})}


# Gate mixes a stage is timed at (the step's flags, engine.STEP_FLAGS):
# every gate closed (greedy, no penalties, no bias, no alternatives), the
# sampled mix the stage was timed at before it was gated (temperature 0.8,
# top_k 50, top_p 0.95: the sampled path and the filters), and every stage
# open, as the programs ran before they were gated.
GATE_MIXES = {"closed": (), "sampled": ("any_sampled", "needs_filter",
                                         "chunk_sampled", "chunk_filter"),
              "open": None}


def gated_graph_ms(fn, reps: int, flags: torch.Tensor) -> dict:
    """Device time of one call of ``fn`` at each of ``GATE_MIXES``:
    ``reps`` calls captured in one CUDA graph with their gated stages as
    conditional nodes (``ops/gates.py``, as a step program captures them)
    on the int32 ``flags`` (``STEP_FLAGS`` order), the graph replayed once
    per mix after ``flags`` is filled with it. ``fn`` runs twice eagerly
    first, with the host flags it was built with."""
    from kubernetes_gpu_cluster_tpu_torch.engine.engine import STEP_FLAGS
    from kubernetes_gpu_cluster_tpu_torch.ops import cuda as cuda_ops
    from kubernetes_gpu_cluster_tpu_torch.ops import gates
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    pool = torch.cuda.graph_pool_handle()
    graph = torch.cuda.CUDAGraph()
    with cuda_ops.capture_scratch() as scratch, \
            torch.cuda.graph(graph, pool=pool), \
            gates.capturing(flags.device, pool, []):
        for _ in range(reps):
            fn()
    out = {}
    for mix, names in GATE_MIXES.items():
        flags.copy_(torch.tensor([names is None or n in names
                                  for n in STEP_FLAGS], dtype=torch.int32))
        graph.replay()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        out[mix] = e0.elapsed_time(e1) / reps
    del graph, scratch
    return out


def _open_flags(device) -> tuple:
    """An int32 flags tensor and its ``gates.Flag``s, every host value set
    (the eager warm-up runs every stage)."""
    from kubernetes_gpu_cluster_tpu_torch.engine.engine import STEP_FLAGS
    from kubernetes_gpu_cluster_tpu_torch.ops import gates
    flags = torch.ones(len(STEP_FLAGS), dtype=torch.int32, device=device)
    return flags, {n: gates.Flag(True, flags[i:i + 1])
                   for i, n in enumerate(STEP_FLAGS)}


def _verify_stage_ms(engine, device, R: int = 32, S: int = 5) -> dict:
    """The verify programs' sampling stage (``_verify_rows``: the counts,
    at each position penalties, the filter thresholds, the acceptance draw
    or the argmax, the count bump and top logprobs, then the bonus) on R
    rows at the engine's vocabulary, device time at each gate mix
    (``gated_graph_ms``: the same graph, its conditional nodes on the
    flags), beside one position's stage (``_sample_rows``, its bias
    included) on the same rows."""
    V = engine.model_config.vocab_size
    bufs = engine._programs.buffers(("spec", R, S))
    bufs["temperature"].fill_(0.8)
    bufs["top_k"].fill_(50)
    bufs["top_p"].fill_(0.95)
    bufs["seed"].fill_(-1)
    bufs["bias_ids"].fill_(-1)
    bufs["out_tokens"].fill_(-1)
    gen = torch.Generator(device=device).manual_seed(SEED)
    logits = torch.randn((R * S, V), generator=gen, device=device)
    drafts = torch.randint(0, V, (R * S,), generator=gen, device=device,
                           dtype=torch.int32)
    counts = torch.zeros((R, V), dtype=torch.int32, device=device)
    pos = torch.arange(R, dtype=torch.int32, device=device)
    flags, gated = _open_flags(device)
    out = {"R": R, "S": S, "V": V,
           "verify_rows_ms": gated_graph_ms(lambda: engine._verify_rows(
               bufs, logits, drafts, R, S, gated), 10, flags),
           "sample_rows_ms": gated_graph_ms(lambda: engine._sample_rows(
               bufs, logits[:R], lambda: counts, gated, pos), 10, flags)}
    out["per_position_ms"] = {m: t / S
                              for m, t in out["verify_rows_ms"].items()}
    return out


def check_spec_ngram(cfg_engine, params, device, counters, card) -> dict:
    """Phase 7a: n-gram speculation on the phase-4 engine (captured step
    programs), twice, then the spec-off engine once on the same requests;
    then 16g's first half: an enforce_eager twin of the spec engine on the
    same requests, held to the captured runs (see the module
    docstring)."""
    from kubernetes_gpu_cluster_tpu_torch.engine import LLMEngine
    from kubernetes_gpu_cluster_tpu_torch.serving.metrics import Metrics
    sc = dataclasses.replace(cfg_engine.scheduler, spec_decode_enabled=True,
                             num_speculative_tokens=4,
                             mixed_batch_enabled=True)
    cfg_spec = dataclasses.replace(cfg_engine, scheduler=sc)
    reqs = _with_logprobs(spec_workload(cfg_engine.model.vocab_size))
    engine = LLMEngine(cfg_spec, params=params, device=device)
    drive(engine, reqs[1:3], "warm", counters["flash_prefill_hist"])
    run1 = _spec_run(engine, reqs, "a", counters)
    log("spec engine run 1:", _loggable(run1))
    kinds, launches = run1["kinds"], run1["launches"]
    if kinds["spec"] < 1 or kinds["spec_mixed"] < 1:
        raise RuntimeError(f"spec / spec_mixed steps did not run: {kinds}")
    if run1["drafted"] <= 0:
        raise RuntimeError("the n-gram proposer drafted nothing")
    for name in ("paged_decode", "flash_prefill", "flash_prefill_hist",
                 "spec_verify"):
        if launches[name] <= 0:
            raise RuntimeError(f"kernel {name} never launched in the spec run")
    if set(run1["tokens"]) != {r[1] for r in reqs}:
        raise RuntimeError("spec engine: not every request finished")
    progs = engine._programs
    built = (engine.compiled_step_variants(), len(progs.capture_seconds))
    run2 = _spec_run(engine, reqs, "b", counters)
    log("spec engine run 2:", _loggable(run2))
    diff = sorted(r for r in run1["tokens"]
                  if run1["tokens"][r] != run2["tokens"][r])
    if diff:
        raise RuntimeError(f"spec engine: the second run differs for {diff}")
    again = (engine.compiled_step_variants(), len(progs.capture_seconds))
    gauge = _metric(Metrics(engine).render(), "kgct_jit_compiles_total")
    if again != built or gauge != again[0] or not progs.keys("spec") \
            or not progs.keys("spec_mixed"):
        raise RuntimeError(f"16g: programs {built} -> {again}, gauge "
                           f"{gauge}, keys {progs.keys()}")
    g16 = {"programs": _programs_by_family(engine),
           "new_captures_on_repeat": again[1] - built[1],
           "kgct_jit_compiles_total": gauge,
           "capture": _capture_record(engine),
           "verify_stage": _verify_stage_ms(engine, device)}
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    eager = LLMEngine(dataclasses.replace(cfg_spec, enforce_eager=True),
                      params=params, device=device)
    drive(eager, reqs[1:3], "warm", counters["flash_prefill_hist"])
    run_eager = _spec_run(eager, reqs, "e", counters)
    log("spec engine eager:", _loggable(run_eager))
    if eager.compiled_step_variants():
        raise RuntimeError("16g: the enforce_eager spec engine built "
                           "programs")
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    g16["held"] = _held_spec("16g n-gram", run1, run_eager, reqs)
    off = LLMEngine(cfg_engine, params=params, device=device)
    drive(off, reqs[1:3], "warm", counters["flash_prefill_hist"])
    run_off = drive(off, reqs, "off", counters["flash_prefill_hist"])
    del off
    g16["tokens_per_s"] = {"spec_captured": [run1["tokens_per_s"],
                                             run2["tokens_per_s"]],
                           "spec_eager": run_eager["tokens_per_s"],
                           "off_captured": run_off["tokens_per_s"]}
    g16["drafted_accepted"] = {"captured": [run1["drafted"],
                                            run1["accepted"]],
                               "eager": [run_eager["drafted"],
                                         run_eager["accepted"]]}
    if g16["drafted_accepted"]["captured"] != \
            g16["drafted_accepted"]["eager"]:
        raise RuntimeError(f"16g: drafted / accepted differ: "
                           f"{g16['drafted_accepted']}")
    log("spec programs 16g n-gram:", json.dumps(g16), "|", card)
    greedy = [r[1] for r in reqs if r[3].temperature == 0.0]
    same = sum(run1["tokens"][r] == run_off["tokens"][r] for r in greedy)
    return {"tokens_per_s_spec": run1["tokens_per_s"],
            "tokens_per_s_spec_run2": run2["tokens_per_s"],
            "tokens_per_s_off": run_off["tokens_per_s"],
            "acceptance": run1["acceptance"], "drafted": run1["drafted"],
            "accepted": run1["accepted"], "kinds": kinds,
            "kinds_off": run_off["kinds"], "launches": launches,
            "greedy_identical_to_off": same / len(greedy),
            "greedy_requests": len(greedy), "16g": g16}


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


def check_spec_draft(cfg, params, device, counters, card) -> dict:
    """Phase 7b: tinyllama-1.1b fp32 drafting for itself (an oracle), the
    draft model's own pool, the draft runner's programs in the engine's
    cache; the same requests again (no new program), then 16g's second
    half (an enforce_eager twin, held to the captured run) and spec off."""
    from kubernetes_gpu_cluster_tpu_torch.config import (
        CacheConfig, EngineConfig, SchedulerConfig)
    from kubernetes_gpu_cluster_tpu_torch.engine import (LLMEngine,
                                                         SamplingParams)
    from kubernetes_gpu_cluster_tpu_torch.serving.metrics import Metrics
    base = EngineConfig(model=cfg, seed=SEED,
                        cache=CacheConfig(page_size=16, num_pages=2048),
                        scheduler=SchedulerConfig(max_num_seqs=32,
                                                  max_prefill_tokens=512))
    spec = dataclasses.replace(base, scheduler=dataclasses.replace(
        base.scheduler, spec_decode_enabled=True, num_speculative_tokens=4,
        spec_adaptive_k=True, spec_draft_model="tinyllama-1.1b"))
    rng = np.random.default_rng(SEED + 9)
    greedy = SamplingParams(max_tokens=40, temperature=0.0, logprobs=True)
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
    progs = engine._programs
    if not (progs.keys("draft_decode") and progs.keys("draft_prefill")):
        raise RuntimeError(f"16g: no draft program built: {progs.keys()}")
    g16 = {"programs": _programs_by_family(engine),
           "kgct_jit_compiles_total": _metric(Metrics(engine).render(),
                                              "kgct_jit_compiles_total"),
           "capture": _capture_record(engine)}
    if g16["kgct_jit_compiles_total"] != engine.compiled_step_variants():
        raise RuntimeError(f"16g: gauge {g16['kgct_jit_compiles_total']}")
    run2 = _spec_run(engine, reqs, "b", counters)
    g16["programs_after_repeat"] = _programs_by_family(engine)
    del engine, runner
    gc.collect()
    torch.cuda.empty_cache()
    if run["acceptance"] < 0.9:
        raise RuntimeError(f"oracle draft acceptance {run['acceptance']}")
    if by_draft["paged_decode"] <= 0:
        raise RuntimeError("the draft runner never launched paged_decode")
    if run["kinds"]["spec"] + run["kinds"]["spec_mixed"] < 1:
        raise RuntimeError(f"no spec step ran: {run['kinds']}")
    if run["launches"]["spec_verify"] <= 0:
        raise RuntimeError("the verify kernel never launched in 7b")
    eager = LLMEngine(dataclasses.replace(spec, enforce_eager=True),
                      params=params, device=device, draft_params=params)
    drive(eager, reqs[1:3], "warm", counters["flash_prefill_hist"])
    run_eager = _spec_run(eager, reqs, "e", counters)
    if eager.compiled_step_variants():
        raise RuntimeError("16g: the enforce_eager draft engine built "
                           "programs")
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    g16["held"] = _held_spec("16g draft", run, run_eager, reqs)
    g16["drafted_accepted"] = {"captured": [run["drafted"], run["accepted"]],
                               "eager": [run_eager["drafted"],
                                         run_eager["accepted"]]}
    if (g16["drafted_accepted"]["captured"]
            != g16["drafted_accepted"]["eager"]):
        raise RuntimeError(f"16g: drafted / accepted differ: "
                           f"{g16['drafted_accepted']}")
    off = LLMEngine(base, params=params, device=device)
    run_off = drive(off, reqs, "off", counters["flash_prefill_hist"])
    del off
    g16["tokens_per_s"] = {"spec_captured": [run["tokens_per_s"],
                                             run2["tokens_per_s"]],
                           "spec_eager": run_eager["tokens_per_s"],
                           "off_captured": run_off["tokens_per_s"]}
    log("spec programs 16g draft:", json.dumps(g16), "|", card)
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
            "near_tie_divergences": len(ties), "requests": len(reqs),
            "16g": g16}


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


def transfer_keys(what: str, engine) -> dict:
    """The engine's KV transfer programs by family, as page buckets; each
    must be a power of two no larger than the largest bucket."""
    from kubernetes_gpu_cluster_tpu_torch.engine.kv_cache import \
        transfer_pages
    top = transfer_pages(engine.config.effective_max_len,
                         engine.config.cache.page_size)
    keys = {f: [k[1] for k in engine._programs.keys(f)]
            for f in ("kv_gather", "kv_scatter")}
    for family, buckets in keys.items():
        for n in buckets:
            if n & (n - 1) or n > top:
                raise RuntimeError(f"{what}: transfer program ({family}, "
                                   f"{n}) is not a power of two up to the "
                                   f"largest bucket, {top}")
    return keys


def counters_clear(where: str) -> None:
    """Every split kernel's counters outside captures are 0, as each
    kernel leaves them: checked after the phases whose engines step in
    threads of their own."""
    from kubernetes_gpu_cluster_tpu_torch.ops.cuda import (int4_matmul,
                                                           paged_decode,
                                                           spec_verify)
    torch.cuda.synchronize()
    left = {m.__name__.rpartition(".")[2]: m.SCRATCH.counters_in_use()
            for m in (paged_decode, spec_verify, int4_matmul)}
    log(f"{where}: split counters not 0:", json.dumps(left))
    if any(left.values()):
        raise RuntimeError(f"{where}: split counters left non-zero {left}")


def capture_log(programs) -> dict:
    """Wraps a program cache's capture (in this script only): the returned
    dict fills with each key's capture seconds and the shared pool's
    growth in bytes, as it is captured."""
    log_: dict = {}
    capture = programs._capture

    def logged(key, body, bufs):
        n, pool = len(programs.capture_seconds), programs.pool_bytes
        prog = capture(key, body, bufs)
        log_[key] = {"s": programs.capture_seconds[n],
                     "pool_bytes": programs.pool_bytes - pool}
        return prog
    programs._capture = logged
    return log_


def held_pages(what: str, engine, pages: list, k, v) -> None:
    """``engine``'s pool pages ``pages`` equal the host buffers ``k``,
    ``v`` bit for bit."""
    idx = torch.tensor(pages, device=engine.device)
    for pool, want in zip(engine.kv_cache, (k, v)):
        if not torch.equal(pool.index_select(1, idx).cpu(), want):
            raise RuntimeError(f"{what}: pool pages differ from the moved "
                               f"buffers")


def twins_equal(what: str, got: dict, ref: dict) -> int:
    """The captured flow's ``record`` against its ``enforce_eager`` twin's:
    the same tokens for every request and the same bytes in every moved
    buffer. Returns the buffers compared."""
    if got["tokens"] != ref["tokens"]:
        diff = sorted(r for r in got["tokens"]
                      if got["tokens"][r] != ref["tokens"].get(r))
        raise RuntimeError(f"{what}: captured and eager tokens differ for "
                           f"{diff}")
    if got["moved"].keys() != ref["moved"].keys():
        raise RuntimeError(f"{what}: captured and eager moved other states")
    for name, bufs in got["moved"].items():
        if not all(torch.equal(a, b)
                   for a, b in zip(bufs, ref["moved"][name])):
            raise RuntimeError(f"{what}: captured and eager {name} buffers "
                               f"differ")
    return 2 * len(got["moved"])


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

    def reset(self) -> None:
        self.pages = {"out": 0, "in": 0}
        self.seconds = {"out": 0.0, "in": 0.0}

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
               near_ties_only: bool, eager_twin: bool = False) -> dict:
    """Swap preemption on ``params`` through a ``SWAP_PAGES`` pool: the
    same requests twice (identical tokens, the second run building no
    transfer program), every restored page bit-equal to what went out,
    then a never-preempted engine on the same requests. Greedy differences
    from it are logged with their top-2 gap: batch composition changes the
    GEMM shapes and ``paged_decode``'s split plan. Phase 8a (llama-3-8b
    bf16) counts them; with ``near_ties_only`` (8d, fp32, where the two
    batchings agree to ~1e-6) each one must be a near-tie, below
    ``NEAR_TIE`` of the logit standard deviation. With ``eager_twin`` an
    ``enforce_eager`` engine serves the first run's requests too: the same
    preemptions and tokens, its restored pages compared as well, no
    program built."""
    from kubernetes_gpu_cluster_tpu_torch.serving.metrics import Metrics
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
    captures = capture_log(engine._programs)
    drive(engine, reqs[:2], "warm", hist)
    for mod in counters.values():
        mod.launches = 0
    kinds0 = dict(engine.scheduler.num_preemptions_by_kind)
    run1 = drive(engine, reqs, "a", hist)
    launches = {name: mod.launches for name, mod in counters.items()}
    kinds = {k: v - kinds0[k]
             for k, v in engine.scheduler.num_preemptions_by_kind.items()}
    rates = audit.rates(page_bytes)
    audit.reset()
    compared = audit.compared
    keys = transfer_keys("8a", engine)
    gauge = _metric(Metrics(engine).render(), "kgct_jit_compiles_total")
    log("swap run 1:", _loggable(run1),
        "preemptions:", json.dumps(kinds), "launches:", json.dumps(launches),
        "transfer programs:", json.dumps(keys), "kgct_jit_compiles_total:",
        gauge)
    if not (keys["kv_gather"] and keys["kv_scatter"]):
        raise RuntimeError(f"swap: no transfer program built: {keys}")
    if gauge != len(engine._programs.keys()):
        raise RuntimeError(f"swap: kgct_jit_compiles_total {gauge} != "
                           f"{len(engine._programs.keys())} programs")
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
    if transfer_keys("8a", engine) != keys:
        raise RuntimeError(f"swap: the second run built transfer programs: "
                           f"{transfer_keys('8a', engine)} after {keys}")
    if (host.num_in_use or engine.scheduler.allocator.num_free
            != engine.scheduler.allocator.num_pages - 1):
        raise RuntimeError("swap: pages left in use after the runs")
    out = {"preemptions": kinds, "restored_pages_compared": compared,
           "restored_pages_compared_run2": audit.compared - compared,
           "transfers": rates, "transfers_run2": audit.rates(page_bytes),
           "transfer_programs": keys, "kgct_jit_compiles_total": gauge,
           "transfer_captures": {f"{k[0]} {k[1]}": c
                                 for k, c in captures.items()
                                 if k[0].startswith("kv_")},
           "staging_bytes": sum(t.nbytes
                                for t in engine._kv_programs._staging),
           "page_bytes": page_bytes,
           "host_pages": host.num_pages, "host_pin_s": host.pin_s,
           "tokens_per_s": run1["tokens_per_s"],
           "tokens_per_s_run2": run2["tokens_per_s"],
           "kinds": run1["kinds"], "launches": launches}
    del engine, audit, host
    gc.collect()
    torch.cuda.empty_cache()
    if eager_twin:
        twin = LLMEngine(dataclasses.replace(cfg_swap, enforce_eager=True),
                         params=params, device=device)
        audit = SwapAudit(twin)
        drive(twin, reqs[:2], "warm", hist)
        kinds0 = dict(twin.scheduler.num_preemptions_by_kind)
        run_e = drive(twin, reqs, "a", hist)
        kinds_e = {k: v - kinds0[k] for k, v in
                   twin.scheduler.num_preemptions_by_kind.items()}
        twins_equal("8a", {"tokens": run1["tokens"], "moved": {}},
                    {"tokens": run_e["tokens"], "moved": {}})
        if kinds_e != kinds or twin.compiled_step_variants() != 0:
            raise RuntimeError(f"swap: the eager twin preempted {kinds_e} "
                               f"against {kinds}, built "
                               f"{twin.compiled_step_variants()} programs")
        if audit.compared <= 0:
            raise RuntimeError("swap: the eager twin restored no page")
        out["eager_twin"] = {"tokens_identical": len(run_e["tokens"]),
                             "restored_pages_compared": audit.compared,
                             "transfers": audit.rates(page_bytes),
                             "tokens_per_s": run_e["tokens_per_s"]}
        del twin, audit
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


def _kept(state: dict) -> tuple:
    """Pageable copies of a state's K and V for the twin's comparison: the
    pinned originals go back to PyTorch's pinned-memory cache, as a
    server's would, instead of making every later export pin anew."""
    return state["k"].clone(), state["v"].clone()


def pool_pages(engine, pages: list) -> list:
    """Host copies of ``engine``'s pool pages ``pages``, K and V."""
    idx = torch.tensor(pages, device=engine.device)
    return [pool.index_select(1, idx).cpu() for pool in engine.kv_cache]


def check_handoff(cfg_engine, params, device, counters, eager: bool = False,
                  record: Optional[dict] = None) -> dict:
    """Phase 8b: a prefill replica and a decode replica (two engines on
    the phase-4 weights, each with its own pool). Each request, one at a
    time: prefill with hold_kv and max_tokens 1, export_held,
    import_request on the decode replica, decode to completion; the tokens
    must equal the decode replica serving the same request alone. One
    request moves mid-decode (export_running -> import_request). Then one
    1024-token prefix goes export_prefix -> begin/import_prefix_chunk/
    commit, and a prompt extending it hits the imported pages, with tokens
    equal to the prefill replica (which hits its own cached pages). Every
    exported buffer equals the pages it was gathered from, and every
    imported page the buffer it came from (the prefix exported back),
    bit for bit. ``eager``: both engines ``enforce_eager``. ``record``
    takes every request's tokens and every moved buffer pair, for the
    twin's comparison."""
    from kubernetes_gpu_cluster_tpu_torch.config import (CacheConfig,
                                                         SchedulerConfig)
    from kubernetes_gpu_cluster_tpu_torch.engine import (LLMEngine,
                                                         SamplingParams)
    from kubernetes_gpu_cluster_tpu_torch.utils import cdiv
    cfg = cfg_engine.model
    ps = cfg_engine.cache.page_size
    record = {"tokens": {}, "moved": {}} if record is None else record
    cfg_pair = dataclasses.replace(
        cfg_engine, cache=CacheConfig(page_size=ps, num_pages=HANDOFF_PAGES),
        scheduler=SchedulerConfig(max_num_seqs=8,
                                  enable_prefix_caching=True),
        enforce_eager=eager)
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
        held = pre.scheduler.held[f"pf-{i}"]
        n_pages = cdiv(held.num_tokens - 1, ps)
        want = pool_pages(pre, held.pages[:n_pages])
        _sync(device)
        t0 = time.perf_counter()
        state = pre.export_held(f"pf-{i}")
        t_exp = time.perf_counter() - t0
        if not all(torch.equal(state[t], w) for t, w in zip("kv", want)):
            raise RuntimeError(f"8b: export {i} differs from its pages")
        nbytes = state["k"].nbytes + state["v"].nbytes
        t0 = time.perf_counter()
        outs = dec.import_request(f"dc-{i}", prompt, sp, state)
        _sync(device)
        t_imp = time.perf_counter() - t0
        held_pages(f"8b import {i}", dec,
                   dec.scheduler.find_running(f"dc-{i}").pages[:n_pages],
                   state["k"], state["v"])
        got = list(outs[0].output_token_ids)
        while dec.has_unfinished_requests():
            for o in dec.step():
                if o.request_id == f"dc-{i}" and o.finished:
                    got = list(o.output_token_ids)
        if got != ref:
            raise RuntimeError(f"8b: handoff of {n}-token prompt differs "
                               f"from colocated: {got[:8]} vs {ref[:8]}")
        record["tokens"][f"handoff-{i}"] = got
        record["moved"][f"handoff-{i}"] = _kept(state)
        handoffs.append({"prompt": n, "pages": state["k"].shape[1],
                         "bytes": nbytes, "export_ms": t_exp * 1e3,
                         "export_gb_s": nbytes / t_exp / 1e9,
                         "import_ms": t_imp * 1e3,
                         "import_gb_s": nbytes / t_imp / 1e9})
    migration = _migrate_one(pre, dec, rng, sp, device, record)
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
    back = dec.export_prefix(prefix + ext)
    if not all(torch.equal(back[t], state[t]) for t in "kv"):
        raise RuntimeError("8b: the imported prefix's pages differ from "
                           "the buffers they came from")
    record["moved"]["prefix"] = _kept(state)
    hits0 = dec.scheduler.prefix_cache.hits
    got = _serve_one(dec, "ext-dc", prefix + ext, sp)
    hit = dec.scheduler.prefix_cache.hits - hits0
    ref = _serve_one(pre, "ext-colo", prefix + ext, sp)
    if hit != 1 or got != ref:
        raise RuntimeError(f"8b: prefix import hit {hit}; tokens "
                           f"{'equal' if got == ref else 'differ'}")
    record["tokens"]["prefix"] = got
    launches = {name: mod.launches for name, mod in counters.items()}
    for name, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"8b: kernel {name} never launched")
    keys = {"prefill": transfer_keys("8b", pre),
            "decode": transfer_keys("8b", dec)}
    if eager != (keys["prefill"]["kv_gather"] == []
                 and keys["decode"]["kv_scatter"] == []):
        raise RuntimeError(f"8b: transfer programs {keys} "
                           f"({'eager' if eager else 'captured'})")
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
            "transfer_programs": keys, "launches": launches}


def _migrate_one(src, dst, rng, sp, device, record: dict) -> dict:
    """Live migration of one request between two engines: decode on
    ``src`` until at least nine tokens are out, ``export_running``, drain
    ``src``, ``import_request`` on ``dst`` (the imported pages bit-equal
    to the state's) and decode to the end; the tokens must equal ``dst``
    serving the request uninterrupted."""
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
    held_pages("8b migration import", dst,
               dst.scheduler.find_running("mig-dc").pages[
                   :state["k"].shape[1]], state["k"], state["v"])
    got = list(outs[0].output_token_ids)
    while dst.has_unfinished_requests():
        for o in dst.step():
            if o.request_id == "mig-dc" and o.finished:
                got = list(o.output_token_ids)
    if got != ref:
        raise RuntimeError(f"8b: migrated request differs from "
                           f"uninterrupted: {got} vs {ref}")
    record["tokens"]["migration"] = got
    record["moved"]["migration"] = _kept(state)
    return {"prompt": len(prompt), "tokens_moved": moved,
            "pages": state["k"].shape[1], "bytes": nbytes,
            "export_ms": t_exp * 1e3, "export_gb_s": nbytes / t_exp / 1e9,
            "tokens_identical": True}


def check_prefix_spill(cfg_engine, params, device, counters,
                       eager: bool = False,
                       record: Optional[dict] = None) -> dict:
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
    behind it restores those pages, with tokens equal to ``keep``'s.
    ``eager``: both engines ``enforce_eager``. ``record`` takes the
    tokens and the exported buffers, for the twin's comparison."""
    from kubernetes_gpu_cluster_tpu_torch.config import (CacheConfig,
                                                         SchedulerConfig)
    from kubernetes_gpu_cluster_tpu_torch.engine import (LLMEngine,
                                                         SamplingParams)
    from kubernetes_gpu_cluster_tpu_torch.engine.kv_cache import PrefixCache
    cfg = cfg_engine.model
    ps = cfg_engine.cache.page_size
    sched = SchedulerConfig(max_num_seqs=8, enable_prefix_caching=True)
    record = {"tokens": {}, "moved": {}} if record is None else record
    spill = LLMEngine(dataclasses.replace(
        cfg_engine, scheduler=sched,
        cache=CacheConfig(page_size=ps, num_pages=SPILL_PAGES,
                          swap_space_gb=SPILL_GB), enforce_eager=eager),
        params=params, device=device)
    keep = LLMEngine(dataclasses.replace(
        cfg_engine, scheduler=sched,
        cache=CacheConfig(page_size=ps, num_pages=HANDOFF_PAGES),
        enforce_eager=eager), params=params, device=device)
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
    record["moved"]["export_from_host"] = _kept(got_state)
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
    record["tokens"]["second"] = got
    _serve_one(keep, "remote", remote + toks(64), one)
    tail = remote + toks(150)
    st = keep.export_prefix(tail)
    record["moved"]["remote"] = _kept(st)
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
    record["tokens"]["remote"] = got
    host = spill.swapper.host
    if host.num_in_use != len(pc._host_entries):
        raise RuntimeError(f"8c: {host.num_in_use} host pages in use for "
                           f"{len(pc._host_entries)} spilled entries")
    keys = transfer_keys("8c", spill)
    if eager != (keys["kv_gather"] == [] and keys["kv_scatter"] == []):
        raise RuntimeError(f"8c: transfer programs {keys} "
                           f"({'eager' if eager else 'captured'})")
    out = {"host_entries": len(pc._host_entries), "host_hits": host_hits,
           "remote_spills_accepted": accepted,
           "remote_host_hits": remote_hits,
           "export_from_host": {"pages": n_shared, "bytes": nbytes,
                                "ms": t_exp * 1e3,
                                "gb_s": nbytes / t_exp / 1e9},
           "tokens_identical": 2, "transfer_programs": keys,
           "launches": launches}
    del spill, keep, pc, host
    gc.collect()
    torch.cuda.empty_cache()
    return out


def with_eager_twin(what: str, check, *args) -> dict:
    """``check`` (8b's or 8c's) on captured engines, then on their
    ``enforce_eager`` twins: the same tokens and moved bytes both ways."""
    records = [{"tokens": {}, "moved": {}} for _ in range(2)]
    out = check(*args, eager=False, record=records[0])
    twin = check(*args, eager=True, record=records[1])
    out["eager_twin"] = {"buffers_equal": twins_equal(what, *records),
                         "tokens_identical": len(records[0]["tokens"]),
                         "launches": twin["launches"]}
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
CLI_LONG_PROMPT = 1500               # cached, then extended: a history prefill
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
    # A long prompt served before the window leaves its pages in the
    # prefix cache. Inside the window the same prompt arrives extended, so
    # only its new tokens prefill, over the cached pages (the history
    # kernel), then a wave of short prompts (a packed prefill step:
    # flash_prefill), while the long request decodes. (A prompt that only
    # arrives alone while another decodes rides a mixed step through the
    # history kernel too, but captured decode windows can finish the other
    # request first.) The profiler's start may hold the server's loop, so
    # the first arrival waits a second.
    cached = ids(CLI_LONG_PROMPT)
    first.append(await http_call(port, "POST", "/v1/completions",
                                 {"prompt": cached, "max_tokens": 4,
                                  "temperature": 0.0}))
    long = asyncio.ensure_future(http_call(
        port, "POST", "/v1/completions",
        {"prompt": ids(64), "max_tokens": 300, "temperature": 0.0,
         "stream": True}))
    await asyncio.sleep(1.0)
    prof = asyncio.ensure_future(http_call(port, "POST",
                                           "/debug/profile?seconds=5"))
    await asyncio.sleep(1.0)
    wave = [await http_call(port, "POST", "/v1/completions",
                            {"prompt": cached + ids(64), "max_tokens": 4,
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
    # The CLI serves spec off; the graph gate's flag kernel is not one of
    # the ported kernels this trace is checked for.
    found = {mod: sum(any(n in k for n in names) for k in kernels)
             for mod, names in _kernel_names().items()
             if mod not in ("spec_verify", "graph_gate")}
    if min(found.values()) <= 0:
        raise RuntimeError(f"profiler trace lacks kernels: {found} "
                           f"({len(kernels)} kernel events)")
    return {"health_after_s": up_s, "requests": len(first) + len(rest),
            "trace_mb": trace.stat().st_size / 2 ** 20,
            "kernel_events": len(kernels), "by_source": found}


def check_cli(vocab: int) -> dict:
    """Phase 9b: the CLI on the card in a subprocess (tinyllama-1.1b int4):
    requests, a profiler capture holding the four TPU kernels' ports,
    SIGTERM exit 0 within the drain grace."""
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
    args = [*CLI_MODEL, "--max-num-seqs", "8", "--enable-prefix-caching",
            "--hbm-utilization", "0.3", "--host", "127.0.0.1",
            "--port", str(port)]
    log_path = work / "server.log"
    with open(log_path, "w") as logf:
        proc = start_child(
            args, "kubernetes_gpu_cluster_tpu_torch.serving.api_server",
            cwd=REPO, env=env, stdout=logf, stderr=subprocess.STDOUT)
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


def check_entry(device, counters) -> dict:
    """Phase 17: ``graft_entry.entry()`` on the card (tinyllama-1.1b bf16
    at full width and depth, its strict kernel probes first): the decode
    step run eagerly (``paged_decode`` launched, counts set to 0 just
    before it), through the plain versions, then captured with
    ``torch.cuda.graph`` after a warm-up on a side stream and replayed:
    the same eight tokens all three ways. Logged: the replay's device ms
    beside one ``paged_decode`` call at the step's shapes."""
    from kubernetes_gpu_cluster_tpu_torch.config import get_model_config
    from kubernetes_gpu_cluster_tpu_torch.graft_entry import entry
    from kubernetes_gpu_cluster_tpu_torch.models import llama as M
    from kubernetes_gpu_cluster_tpu_torch.ops import attention as A
    from kubernetes_gpu_cluster_tpu_torch.ops import cuda as cuda_ops
    t0 = time.perf_counter()
    fn, args = entry()
    entry_s = time.perf_counter() - t0
    for mod in counters.values():
        mod.launches = 0
    eager = fn(*args)[0].clone()
    torch.cuda.synchronize()
    launches = {name: mod.launches for name, mod in counters.items()}
    if launches["paged_decode"] <= 0:
        raise RuntimeError(f"17: paged_decode never launched: {launches}")
    with mock.patch.object(M, "paged_decode_attention",
                           A.paged_decode_attention_plain):
        plain = fn(*args)[0].clone()
    main = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(main)
    with torch.cuda.stream(side):
        fn(*args)
    main.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = counters["paged_decode"].launches
    t0 = time.perf_counter()
    with cuda_ops.capture_scratch() as scratch, torch.cuda.graph(graph):
        out = fn(*args)[0]
    capture_s = time.perf_counter() - t0
    recorded = counters["paged_decode"].launches - before
    graph.replay()
    torch.cuda.synchronize()
    replayed = out.clone()
    if not (torch.equal(replayed, eager) and torch.equal(plain, eager)):
        raise RuntimeError(f"17: tokens differ: eager {eager.tolist()}, "
                           f"replayed {replayed.tolist()}, plain "
                           f"{plain.tolist()}")
    replay_ms = cuda_ms(graph.replay, 20)
    cfg = get_model_config("tinyllama-1.1b")
    _, kv, _, meta, *_ = args
    q = torch.randn((8, cfg.num_heads, cfg.head_dim), device=device).to(
        kv.k.dtype)
    cur = torch.randn((8, cfg.num_kv_heads, cfg.head_dim),
                      device=device).to(kv.k.dtype)
    decode_ms = graph_ms(lambda: counters["paged_decode"].paged_decode(
        q, kv.k, kv.v, meta.page_tables, meta.context_lens, cur, cur,
        cfg.head_dim ** -0.5, layer=0), 200)
    del graph, scratch, fn, args, kv, out
    gc.collect()
    torch.cuda.empty_cache()
    return {"tokens": eager.tolist(), "equal_eager_replay_plain": True,
            "entry_s": entry_s, "capture_s": capture_s,
            "launches": launches, "paged_decode_recorded": recorded,
            "replay_ms": replay_ms, "paged_decode_ms": decode_ms,
            "paged_decode_ms_x_layers": decode_ms * launches["paged_decode"]}


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
        # Each server's gauge counts its KV transfer programs with the rest.
        programs = {}
        for name, text, family in (("P", mP, "kv_gather"),
                                   ("D", mD, "kv_scatter")):
            eng = srv[name]["api"].engine.engine
            gauge = _metric(text, "kgct_jit_compiles_total")
            keys = transfer_keys("10a", eng)
            if not keys[family] or gauge != len(eng._programs.keys()):
                raise RuntimeError(f"10a: {name} kgct_jit_compiles_total "
                                   f"{gauge}, transfer programs {keys}")
            programs[name] = {"kgct_jit_compiles_total": gauge, **keys}
        out["10a"] = {"handoffs": rows, "counters": counts,
                      "programs": programs}
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
        proc = start_child(
            ["--replicas", replica_url, "--host", "127.0.0.1",
             "--port", str(port)],
            "kubernetes_gpu_cluster_tpu_torch.serving.router", cwd=REPO,
            env=env, stdout=logf, stderr=subprocess.STDOUT)
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
# Phase 15: the analysis package on the card (sanitizers and the linter)
# ---------------------------------------------------------------------------

ANALYSIS_PAGES = 80      # 15a's device pool: six running requests overflow it
ANALYSIS_SWAP_GB = 1.0   # 15a's host tier: 512 pages
INTERLEAVE_SEEDS = (1, 2, 3)


@contextlib.contextmanager
def sanitize_env(**env):
    """``KGCT_*`` variables set while engines are built (the sanitizers
    read them at construction), restored after."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def sync_sites():
    """Counts the synchronizing CUDA calls made inside the block
    (``torch.cuda.set_sync_debug_mode("warn")``: one warning each) by the
    source line that made them, into the yielded Counter."""
    sites: collections.Counter = collections.Counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield sites
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites.update(f"{Path(w.filename).name}:{w.lineno}" for w in caught
                 if "synchroniz" in str(w.message))


def _tensor_args(args) -> list:
    """The torch tensors among ``args`` and their batch fields: a hook must
    be handed host arrays only (``np.asarray`` of a CUDA tensor raises, a
    ``.cpu()`` inside the hook would be a hidden sync)."""
    out = []
    for a in args:
        for x in (a, *(getattr(a, f, None) for f in (
                "slot_mapping", "positions", "seg_ids", "draft_lens"))):
            if isinstance(x, torch.Tensor):
                out.append(type(a).__name__)
    return out


class HookAudit:
    """Wraps one engine's sanitizer hooks (in this script only): calls per
    hook (on_decode_dispatch split into decode windows and mixed steps'
    one-token windows, on_spec_dispatch into spec and spec×mixed by its
    ``seqs`` argument), host seconds inside them, and a refusal of any
    tensor."""

    def __init__(self, engine):
        san = engine._sanitizer
        self.checks = dict.fromkeys(("decode", "mixed", "spec", "spec_mixed",
                                     "spec_commit", "swap_restore",
                                     "outputs"), 0)
        self.host_s = 0.0

        def wrap(kind, fn):
            def hook(*args, **kw):
                bad = _tensor_args(list(args) + list(kw.values()))
                if bad:
                    raise RuntimeError(f"sanitizer hook {kind} handed a "
                                       f"device tensor: {bad}")
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                self.host_s += time.perf_counter() - t0
                self.checks[kind(args, kw) if callable(kind) else kind] += 1
                return out
            return hook

        san.on_decode_dispatch = wrap(
            lambda a, kw: "mixed" if a[2] == 1 else "decode",
            san.on_decode_dispatch)
        san.on_spec_dispatch = wrap(
            lambda a, kw: "spec" if kw.get("seqs") is None else "spec_mixed",
            san.on_spec_dispatch)
        san.on_spec_commit = wrap("spec_commit", san.on_spec_commit)
        san.check_outputs = wrap("outputs", san.check_outputs)
        engine.swapper.on_restored = wrap("swap_restore",
                                          engine.swapper.on_restored)


def analysis_workload(vocab: int):
    """Phase 4's workload shape at a size 15a's pool overflows: six
    150-230-token requests at step 0, then a 40-90-token one every three
    steps while they decode (each alone: a mixed or spec×mixed step), half
    of them repeating a random 8-32 token pattern (n-gram drafts), one
    seeded sampled request."""
    from kubernetes_gpu_cluster_tpu_torch.engine import SamplingParams
    rng = np.random.default_rng(SEED + 15)
    reqs = []
    for i in range(10):
        n = int(rng.integers(150, 231) if i < 6 else rng.integers(40, 91))
        prompt = [int(t) for t in rng.integers(1, vocab, n)]
        if i % 2:
            pattern = prompt[:int(rng.integers(8, 33))]
            prompt = (pattern * (n // len(pattern) + 1))[:n]
        max_tokens = int(rng.integers(48, 65))
        sp = (SamplingParams(max_tokens=max_tokens, temperature=0.8,
                             top_p=0.95, seed=4321) if i == 3 else
              SamplingParams(max_tokens=max_tokens, temperature=0.0))
        reqs.append((0 if i < 6 else 3 * (i - 5), f"q{i}", prompt, sp))
    return reqs


def _analysis_cfg(cfg_engine, **sched):
    from kubernetes_gpu_cluster_tpu_torch.config import (CacheConfig,
                                                         SchedulerConfig)
    return dataclasses.replace(
        cfg_engine, cache=CacheConfig(
            page_size=cfg_engine.cache.page_size, num_pages=ANALYSIS_PAGES,
            swap_space_gb=ANALYSIS_SWAP_GB),
        scheduler=SchedulerConfig(
            max_num_seqs=12, spec_decode_enabled=True,
            num_speculative_tokens=4, mixed_batch_enabled=True, **sched))


def check_sanitized_engine(cfg_engine, params, device, counters) -> dict:
    """15a and 15c: the same workload through a sanitized and a plain
    engine (n-gram spec, mixed on, swap forced by the pool): identical
    tokens, every hook kind checked, tokens/s both ways and the hooks' host
    ms per step; then both again under sync-debug mode, with equal counts
    of synchronizing calls."""
    from kubernetes_gpu_cluster_tpu_torch.engine import LLMEngine
    cfg = _analysis_cfg(cfg_engine)
    reqs = analysis_workload(cfg.model.vocab_size)
    hist = counters["flash_prefill_hist"]
    with sanitize_env(KGCT_SANITIZE=1):
        on = LLMEngine(cfg, params=params, device=device)
    off = LLMEngine(cfg, params=params, device=device)
    if on._sanitizer is None or off._sanitizer is not None:
        raise RuntimeError("KGCT_SANITIZE was not read at construction")
    audit = HookAudit(on)
    # The warm-up also runs under sync-debug mode: a warning torch gives
    # once a process (seen in the first measured run on the card) must not
    # land in 15c's counts.
    for eng in (on, off):
        with sync_sites():
            drive(eng, reqs[1:3], "warm", hist)
    for mod in counters.values():
        mod.launches = 0
    audit.checks = dict.fromkeys(audit.checks, 0)
    audit.host_s = 0.0
    run_on = drive(on, reqs, "a", hist)
    launches = {n: mod.launches for n, mod in counters.items()}
    checks = dict(audit.checks)
    run_off = drive(off, reqs, "a", hist)
    log("analysis sanitized:", _loggable(run_on), "checks:",
        json.dumps(checks), "launches:", json.dumps(launches))
    log("analysis plain:", _loggable(run_off))
    for kind in ("decode", "spec", "spec_mixed", "swap_restore", "outputs"):
        if checks[kind] <= 0:
            raise RuntimeError(f"sanitizer hook {kind} never ran: {checks}")
    for name in ("paged_decode", "flash_prefill", "flash_prefill_hist"):
        if launches[name] <= 0:
            raise RuntimeError(f"kernel {name} never launched in 15a")
    if run_on["tokens"] != run_off["tokens"] or \
            set(run_on["tokens"]) != {r[1] for r in reqs}:
        raise RuntimeError("the sanitizer changed the tokens")
    swaps = [eng.scheduler.num_preemptions_by_kind["swap"]
             for eng in (on, off)]
    if min(swaps) <= 0 or swaps[0] != swaps[1]:
        raise RuntimeError(f"swap preemptions {swaps}")
    sites, again = {}, {}
    for tag, eng in (("on", on), ("off", off)):
        with sync_sites() as sites[tag]:
            again[tag] = drive(eng, reqs, f"s{tag}", hist)
    # The census is live: a known synchronizing call is counted (since
    # PR 19 the engine itself may make none).
    with sync_sites() as probe:
        torch.ones(1, device=device).item()
    syncs = {tag: sum(c.values()) for tag, c in sites.items()}
    log("analysis sync-debug:", json.dumps(syncs), "by line:",
        json.dumps(dict(sites["on"].most_common())), "tokens/s:",
        json.dumps({t: r["tokens_per_s"] for t, r in again.items()}))
    if again["on"]["tokens"] != run_on["tokens"] or \
            again["off"]["tokens"] != run_on["tokens"]:
        raise RuntimeError("15c: the sync-debug runs changed the tokens")
    if sites["on"] != sites["off"] or sum(probe.values()) < 1:
        raise RuntimeError(
            f"15c: synchronizing calls {syncs}, probe {dict(probe)}, on - off "
            f"{dict(sites['on'] - sites['off'])}, off - on "
            f"{dict(sites['off'] - sites['on'])}")
    out = {"checks": checks, "checks_total": on._sanitizer.checks,
           "tokens_per_s_on": run_on["tokens_per_s"],
           "tokens_per_s_off": run_off["tokens_per_s"],
           "hook_ms_per_step": audit.host_s * 1e3 / run_on["steps"],
           "steps": run_on["steps"], "kinds": run_on["kinds"],
           "swap_preemptions": swaps[0], "launches": launches,
           "sync_calls": syncs,
           "tokens_per_s_sync_debug": {t: r["tokens_per_s"]
                                       for t, r in again.items()}}
    del on, off, audit
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_seeded_faults(cfg_engine, params, device) -> dict:
    """15b: ``nan_step_output`` raises SanitizerError in the step() call
    whose window it poisoned; ``kv_commit_stomp`` rewrites row 0's first
    draft slot to its committed position 0: with the sanitizer off the
    pool bytes there change, with it on the step is refused before any
    upload and the bytes stay."""
    from kubernetes_gpu_cluster_tpu_torch.analysis.sanitize import \
        SanitizerError
    from kubernetes_gpu_cluster_tpu_torch.engine import (LLMEngine,
                                                         SamplingParams)
    from kubernetes_gpu_cluster_tpu_torch.engine import engine as E
    from kubernetes_gpu_cluster_tpu_torch.engine.step_programs import \
        StaticBuffers
    from kubernetes_gpu_cluster_tpu_torch.resilience.faults import (
        configure_faults, get_injector)
    cfg = _analysis_cfg(cfg_engine)
    rng = np.random.default_rng(SEED + 16)
    pattern = [int(t) for t in rng.integers(1, cfg.model.vocab_size, 16)]
    sp = SamplingParams(max_tokens=32, temperature=0.0)
    out = {}

    with sanitize_env(KGCT_SANITIZE=1):
        eng = LLMEngine(cfg, params=params, device=device)
    configure_faults("nan_step_output:after=2,times=1")
    rule = get_injector().rules["nan_step_output"]
    eng.add_request("nan", pattern * 8, sp)
    raised = None
    try:
        for call in range(1, 64):
            fired = rule.fires
            try:
                eng.step()
            except SanitizerError as e:
                raised = (call, fired, rule.fires, str(e))
                break
    finally:
        configure_faults(None)
    if raised is None or raised[1:3] != (0, 1) or \
            "non-finite logprob" not in raised[3]:
        raise RuntimeError(f"15b nan_step_output not caught at its step: "
                           f"{raised}")
    out["nan_step_output"] = {"step_call": raised[0], "error": raised[3][:80]}
    del eng
    gc.collect()

    for sanitize in (False, True):
        with sanitize_env(KGCT_SANITIZE=int(sanitize)):
            eng = LLMEngine(cfg, params=params, device=device)
        seen = {"uploads": 0}
        up = eng._up
        upload = StaticBuffers.upload

        def counted_up(a, _up=up):
            seen["uploads"] += 1
            return _up(a)

        def counted_upload(bufs, arrays, _seen=seen):
            _seen["uploads"] += 1
            return upload(bufs, arrays)
        eng._up = counted_up

        def stomp(batch, page_size, S, token_start=0, _eng=eng, _seen=seen):
            page = batch.seqs[0].pages[0]
            _sync(device)
            kv = _eng.kv_cache
            _seen.update(page=page, at_stomp=_seen["uploads"],
                         before=(kv.k[:, page, 0].clone(),
                                 kv.v[:, page, 0].clone()))
            stomp_orig(batch, page_size, S, token_start)

        stomp_orig = E._stomp_committed_slot
        eng.add_request("stomp", pattern * 8, sp)
        configure_faults("kv_commit_stomp:times=1")
        error = None
        try:
            with mock.patch.object(E, "_stomp_committed_slot", stomp), \
                    mock.patch.object(StaticBuffers, "upload",
                                      counted_upload):
                while "page" not in seen and eng.has_unfinished_requests():
                    try:
                        eng.step()
                    except SanitizerError as e:
                        error = str(e)
                        break
        finally:
            configure_faults(None)
        if "page" not in seen:
            raise RuntimeError("15b: no spec step ran the stomp")
        _sync(device)
        kv = eng.kv_cache
        page = seen["page"]
        same = (torch.equal(kv.k[:, page, 0], seen["before"][0])
                and torch.equal(kv.v[:, page, 0], seen["before"][1]))
        uploads_after = seen["uploads"] - seen["at_stomp"]
        tag = "on" if sanitize else "off"
        log(f"15b kv_commit_stomp sanitizer {tag}: page {page} position 0 "
            f"bytes {'unchanged' if same else 'changed'}, uploads after the "
            f"stomp {uploads_after}, error {error!r}")
        if sanitize and (error is None or "COMMITTED slot" not in error
                         or not same or uploads_after):
            raise RuntimeError("15b: the stomp was not refused before the "
                               "upload")
        if not sanitize and (error is not None or same):
            raise RuntimeError("15b: with the sanitizer off the stomp did "
                               "not reach the pool (a vacuous fault)")
        out[f"kv_commit_stomp_{tag}"] = {
            "pool_bytes_changed": not same, "refused": error is not None,
            "uploads_after_stomp": uploads_after}
        del eng
        gc.collect()
    torch.cuda.empty_cache()
    return out


def check_interleave(cfg_engine, params, device) -> dict:
    """15d: ``AsyncLLMEngine`` with ``KGCT_SANITIZE_INTERLEAVE=1`` under
    three seeds serves four concurrent streams; each seed's sanitizer
    yielded at least once. The yields move admissions between steps, so a
    seed may batch the streams otherwise than the unperturbed run: where it
    stepped the same schedule (each step's kind, size and the requests it
    advanced, in row order) its tokens must be the unperturbed ones;
    where not, they are held as the tp phases hold a sum in another order
    (``_held_forced``: equal up to a first difference, then each token the
    top one teacher forced, or under ``RESUME_DRIFT`` of the logit std
    below it)."""
    from kubernetes_gpu_cluster_tpu_torch.config import CacheConfig
    from kubernetes_gpu_cluster_tpu_torch.engine import SamplingParams
    from kubernetes_gpu_cluster_tpu_torch.serving.async_engine import \
        AsyncLLMEngine
    cfg = dataclasses.replace(cfg_engine, cache=CacheConfig(
        page_size=cfg_engine.cache.page_size, num_pages=256))
    rng = np.random.default_rng(SEED + 17)
    prompts = [[int(t) for t in rng.integers(1, cfg.model.vocab_size, n)]
               for n in (48, 200, 500, 17)]
    sp = SamplingParams(max_tokens=16, temperature=0.0)
    runs, schedules, yields = {}, {}, {}
    for seed in (None, *INTERLEAVE_SEEDS):
        env = ({} if seed is None else
               {"KGCT_SANITIZE_INTERLEAVE": 1, "KGCT_INTERLEAVE_SEED": seed})
        with sanitize_env(**env):
            aeng = AsyncLLMEngine(cfg, params=params, device=device)
        izer = aeng._interleave
        if (izer is None) != (seed is None):
            raise RuntimeError("KGCT_SANITIZE_INTERLEAVE not read")
        eng, schedule = aeng.engine, []
        step = eng.step

        def recorded(_step=step, _eng=eng, _schedule=schedule):
            outs = _step()
            info = _eng._last_step_info
            # Each step's kind and size, and the requests it advanced in
            # row order: a seed may batch other requests, or the same ones
            # in other rows, at the same sizes, and a row's tokens depend
            # on its batch's order (the prefill's packing), captured or
            # eager alike.
            _schedule.append((tuple(info[:2]),
                              tuple(o.request_id for o in outs))
                             if info else None)
            return outs
        eng.step = recorded
        runs[seed] = [t for t, _ in asyncio.run(_streams(aeng, prompts, sp))]
        schedules[seed] = schedule
        if izer is not None:
            yields[seed] = sum(y for _, _, y in izer.trace)
            if not yields[seed]:
                raise RuntimeError(f"seed {seed}: no crossing yielded")
        del aeng, eng
        gc.collect()
    ties, equal, same_schedule, same_sizes = [], {}, {}, {}
    for seed in INTERLEAVE_SEEDS:
        same_schedule[seed] = schedules[seed] == schedules[None]
        same_sizes[seed] = [s and s[0] for s in schedules[seed]] == \
            [s and s[0] for s in schedules[None]]
        if same_schedule[seed] and runs[seed] != runs[None]:
            raise RuntimeError(f"interleave seed {seed}: the unperturbed "
                               "schedule gave other tokens")
        equal[seed] = sum(
            _held_forced(f"15d seed {seed} stream {i}", got, ref, prompts[i],
                         params, cfg.model, device, ties)
            for i, (got, ref) in enumerate(zip(runs[seed], runs[None])))
    torch.cuda.empty_cache()
    return {"seeds": list(INTERLEAVE_SEEDS), "yields": yields,
            "streams": len(prompts), "streams_equal": equal,
            "same_schedule": same_schedule, "same_sizes": same_sizes,
            "tokens_off_top": len(ties),
            "widest_gap_over_std": max((t["gap_over_std"] for t in ties),
                                       default=0.0)}


def check_draft_shadow(cfg_engine, params, device) -> dict:
    """15e: the draft-model proposer (the phase-4 model drafting for
    itself through its own pool) with ``KGCT_SANITIZE=1``: ``check_feed``
    ran on every planned feed, and the tokens equal a plain run's."""
    from kubernetes_gpu_cluster_tpu_torch.config import (CacheConfig,
                                                         SchedulerConfig)
    from kubernetes_gpu_cluster_tpu_torch.engine import (LLMEngine,
                                                         SamplingParams)
    cfg = dataclasses.replace(
        cfg_engine, cache=CacheConfig(page_size=cfg_engine.cache.page_size,
                                      num_pages=256),
        scheduler=SchedulerConfig(
            max_num_seqs=4, spec_decode_enabled=True,
            num_speculative_tokens=4, spec_draft_model=cfg_engine.model.name))
    rng = np.random.default_rng(SEED + 18)
    pattern = [int(t) for t in rng.integers(1, cfg.model.vocab_size, 12)]
    prompts = [pattern * 10,
               [int(t) for t in rng.integers(1, cfg.model.vocab_size, 90)]]
    sp = SamplingParams(max_tokens=24, temperature=0.0)
    toks, feeds = {}, 0
    for sanitize in (True, False):
        with sanitize_env(KGCT_SANITIZE=int(sanitize)):
            eng = LLMEngine(cfg, params=params, device=device,
                            draft_params=params)
        runner = eng.scheduler.spec_proposer
        if (runner._shadow is None) == sanitize:
            raise RuntimeError("the draft shadow did not follow "
                               "KGCT_SANITIZE")
        if sanitize:
            check = runner._shadow.check_feed

            def counted(*a, _check=check):
                nonlocal feeds
                feeds += 1
                return _check(*a)
            runner._shadow.check_feed = counted
        toks[sanitize] = [o.output_token_ids
                          for o in eng.generate(prompts, sp)]
        dispatches = runner.num_dispatches
        del eng, runner
        gc.collect()
    if feeds <= 0 or toks[True] != toks[False]:
        raise RuntimeError(f"15e: {feeds} feeds checked, tokens "
                           f"{'equal' if toks[True] == toks[False] else 'differ'}")
    torch.cuda.empty_cache()
    return {"feeds_checked": feeds, "draft_dispatches": dispatches}


def check_lint() -> dict:
    """15f: ``kgct-torch-lint`` over the port tree in this checkout."""
    import io
    from kubernetes_gpu_cluster_tpu_torch.analysis.cli import main as lint
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = lint([])
    summary = err.getvalue().strip().splitlines()[-1]
    if rc != 0 or "0 finding(s) (21 rule(s))" not in summary:
        raise RuntimeError(f"kgct-torch-lint: rc {rc}: {err.getvalue()}")
    return {"rc": rc, "summary": summary}


def check_analysis(cfg_engine, params, device, counters) -> dict:
    t0 = time.perf_counter()
    out = {"15a_15c": check_sanitized_engine(cfg_engine, params, device,
                                             counters)}
    out["15b"] = check_seeded_faults(cfg_engine, params, device)
    out["15d"] = check_interleave(cfg_engine, params, device)
    out["15e"] = check_draft_shadow(cfg_engine, params, device)
    out["15f"] = check_lint()
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# Phase 16: the decode window as captured CUDA graphs
# ---------------------------------------------------------------------------

GRAPH_PAGES = 512        # 16a's pools: 32 rows of 16-64 + 25 tokens
GRAPH_TOKENS = 25        # one from the prefill, then three chained windows
GRAPH_SEQS = 32          # buckets 1-32 of the default grid
GRAPH_KEYS = (12345, 54321)   # 16b's two step keys


def graph_buckets() -> tuple:
    """The default decode buckets up to ``GRAPH_SEQS``."""
    from kubernetes_gpu_cluster_tpu_torch.config import SchedulerConfig
    return tuple(b for b in SchedulerConfig().decode_buckets
                 if b <= GRAPH_SEQS)


def graph_params(n: int, kinds: str) -> list:
    """16a's rows of one wave of ``n``: "greedy" all greedy; "all" every
    sampled kind in turn, the full-sort row among them (the batch then
    takes the full sort); "wide" the same without it (a top_k 1000 row
    makes the batch take the 2048-wide window)."""
    from kubernetes_gpu_cluster_tpu_torch.engine import SamplingParams
    T = GRAPH_TOKENS
    if kinds == "greedy":
        return [SamplingParams(max_tokens=T, temperature=0.0)] * n
    rows = [
        SamplingParams(max_tokens=T, temperature=0.9, top_k=1000, seed=1603),
        SamplingParams(max_tokens=T, temperature=0.8, seed=1601),
        SamplingParams(max_tokens=T, temperature=1.0),          # unseeded
        SamplingParams(max_tokens=T, temperature=0.7, top_k=50, top_p=0.95,
                       seed=1602),
        SamplingParams(max_tokens=T, temperature=0.0, presence_penalty=0.6,
                       frequency_penalty=0.4,
                       logit_bias={13: 4.0, 17: -100.0}, logprobs=True,
                       top_logprobs=5),
        SamplingParams(max_tokens=T, temperature=0.6, frequency_penalty=0.5,
                       seed=1605, logprobs=True, top_logprobs=2),
    ]
    if kinds == "all":
        # Flat logits (temperature 5) and top_p 0.9999: no window covers
        # the mass, the full sort decides.
        rows.insert(1, SamplingParams(max_tokens=T, temperature=5.0,
                                      top_p=0.9999, seed=1604))
    return [rows[i % len(rows)] for i in range(n)]


def graph_waves(eng, vocab: int) -> list:
    """Per bucket 1-32: a greedy wave, an "all" wave, and (from 2 rows) a
    "wide" wave; prompts of 16-64 tokens, so one prefill step takes a
    whole wave and every window runs the wave's bucket. Returns per wave
    (params, outputs)."""
    rng = np.random.default_rng(SEED + 16)
    out = []
    for n in graph_buckets():
        for kinds in ("greedy", "all") + (("wide",) if n > 1 else ()):
            prompts = [[int(t) for t in rng.integers(1, vocab,
                                                     int(rng.integers(16,
                                                                      65)))]
                       for _ in range(n)]
            sps = graph_params(n, kinds)
            out.append((sps, eng.generate(prompts, sps)))
    return out


def _held_rows(graph_run, eager_run) -> dict:
    """Graph against eager, row by row: greedy and seeded rows must give
    the same tokens (their logprobs' largest difference is logged);
    unseeded rows are counted."""
    checked = unseeded_equal = unseeded = 0
    lp_diff = 0.0
    for (sps, g), (_, e) in zip(graph_run, eager_run):
        for sp, a, b in zip(sps, g, e):
            if sp.temperature > 0 and sp.seed is None:
                unseeded += 1
                unseeded_equal += a.output_token_ids == b.output_token_ids
                continue
            if a.output_token_ids != b.output_token_ids:
                raise RuntimeError(
                    f"16a: captured and eager tokens differ for {sp}: "
                    f"{a.output_token_ids} vs {b.output_token_ids}")
            checked += 1
            if a.output_logprobs:
                lp_diff = max(lp_diff, max(abs(x - y) for x, y in zip(
                    a.output_logprobs, b.output_logprobs)))
    return {"rows_equal": checked, "unseeded_rows": unseeded,
            "unseeded_equal": unseeded_equal, "max_logprob_diff": lp_diff}


def _step_key_replays(eng) -> dict:
    """16b: the engine refills the step key before every window, and the
    graph reads it. Two consecutive windows of one unseeded request carry
    different keys; then the ("sampled", 32) program is replayed three
    times on the same inputs turned unseeded (temperature 1, nothing
    filtered, penalised or biased) with keys k1, k2, k1: k1 twice gives
    the same tokens, k2 others. A key baked into the graph would give k1's
    tokens for k2."""
    from kubernetes_gpu_cluster_tpu_torch.engine import SamplingParams
    progs = eng._programs
    seen = []
    run = progs.run

    def recording(key):
        if key[0] == "sampled":
            seen.append(int(progs.buffers(key)["step_key"][0]))
        run(key)

    progs.run = recording
    try:
        eng.generate([[7] * 20], SamplingParams(max_tokens=GRAPH_TOKENS,
                                                temperature=1.0))
    finally:
        progs.run = run
    if len(seen) < 2 or len(set(seen)) != len(seen):
        raise RuntimeError(f"16b: windows' step keys {seen}")
    key = ("sampled", GRAPH_SEQS)
    bufs = progs.buffers(key)
    snap = {n: t.clone() for n, t in bufs.tensors.items()}
    outs = []
    for k in GRAPH_KEYS + GRAPH_KEYS[:1]:
        for n, t in snap.items():
            bufs[n].copy_(t)
        bufs["seed"].fill_(-1)
        bufs["temperature"].fill_(1.0)
        bufs["top_k"].zero_()
        bufs["top_p"].fill_(1.0)
        bufs["presence"].zero_()
        bufs["frequency"].zero_()
        bufs["bias_ids"].fill_(-1)
        bufs["step_key"].fill_(k)
        run(key)
        torch.cuda.synchronize()
        outs.append(bufs["out_tok"].clone())
    # The program's last window ran past every row's token budget (the
    # chain's successor of the wave's last window): from its second
    # substep on, a row reads KV its first substep wrote to the scrap
    # page, which every row writes, in no fixed order, and whose tokens
    # the host discards. The first substep reads the rows' committed KV
    # only: its column is compared, for the real rows (padded rows have
    # an all-zero page table and read the scrap page throughout).
    real = snap["page_tables"][:, 0] != 0
    a, b, c = (o[real, 0] for o in outs)
    rows = int((a != b).sum())
    if not torch.equal(a, c) or rows == 0:
        raise RuntimeError(f"16b: replays with keys {GRAPH_KEYS}: k1 twice "
                           f"equal {torch.equal(a, c)}, rows that differ "
                           f"under k2 {rows} of {int(real.sum())}")
    return {"window_keys": seen, "rows_differing_under_k2": rows,
            "rows": int(real.sum())}


async def _scrape_metrics(api) -> str:
    from kubernetes_gpu_cluster_tpu_torch.serving.http import Server
    srv = Server(api.build_app())
    await srv.start("127.0.0.1", 0)
    try:
        r = await http_call(srv.port, "GET", "/metrics")
    finally:
        await srv.close()
    if r["status"] != 200:
        raise RuntimeError(f"/metrics: {r['status']}")
    return r["body"]


def _capture_record(eng) -> dict:
    progs = eng._programs
    secs = progs.capture_seconds
    return {"programs": eng.compiled_step_variants(), "captures": len(secs),
            "capture_s_mean": sum(secs) / max(1, len(secs)),
            "capture_s_max": max(secs, default=0.0),
            "pool_bytes": progs.pool_bytes,
            "keys": [list(k) for k in progs.keys()]}


def _spec_fetch_sites(census) -> list:
    """Census sites inside the spec and spec×mixed steps or the draft
    round (``_step_spec``, ``_step_spec_mixed``, ``_wait_step``,
    ``DraftModelRunner._dispatch``): none since the spec family runs as
    step programs with one pinned fetch."""
    import inspect
    from kubernetes_gpu_cluster_tpu_torch.engine.engine import LLMEngine
    from kubernetes_gpu_cluster_tpu_torch.engine.spec.draft_model import \
        DraftModelRunner
    spans = []
    for fn in (LLMEngine._step_spec, LLMEngine._step_spec_mixed,
               LLMEngine._wait_step, DraftModelRunner._dispatch):
        lines, first = inspect.getsourcelines(fn)
        name = Path(inspect.getsourcefile(fn)).name
        spans.append((name, first, first + len(lines)))
    out = []
    for run in census.values():
        for site in run["by_line"]:
            name, _, line = site.rpartition(":")
            if any(name == n and a <= int(line) < b for n, a, b in spans):
                out.append(site)
    return sorted(set(out))


def check_graphs(cfg_engine, params, device, counters, card: str) -> dict:
    """Phase 16 on the phase-4 weights: 16a-16d and the graph/eager
    numbers (see the module docstring)."""
    from kubernetes_gpu_cluster_tpu_torch.config import (CacheConfig,
                                                         SchedulerConfig)
    from kubernetes_gpu_cluster_tpu_torch.engine import (LLMEngine,
                                                         SamplingParams)
    from kubernetes_gpu_cluster_tpu_torch.engine.step_programs import \
        CaptureError
    from kubernetes_gpu_cluster_tpu_torch.serving import build_server
    t0 = time.perf_counter()
    vocab = cfg_engine.model.vocab_size
    out = {}
    cfg16 = dataclasses.replace(
        cfg_engine, cache=CacheConfig(page_size=cfg_engine.cache.page_size,
                                      num_pages=GRAPH_PAGES),
        scheduler=SchedulerConfig(max_num_seqs=GRAPH_SEQS))
    eager_cfg = dataclasses.replace(cfg16, enforce_eager=True)

    # 16a: every bucket and variant, captured against eager.
    api = build_server(cfg16, params=params, device=device,
                       model_name=MODEL)
    graph = api.engine.engine
    eager = LLMEngine(eager_cfg, params=params, device=device,
                      eos_token_id=graph.eos_token_id)
    g_run = graph_waves(graph, vocab)
    e_run = graph_waves(eager, vocab)
    held = _held_rows(g_run, e_run)
    want = {(v, b) for v in ("greedy", "sampled") for b in graph_buckets()}
    windows = graph._programs.keys("greedy") + graph._programs.keys("sampled")
    if set(windows) != want or eager.compiled_step_variants():
        raise RuntimeError(f"16a: programs {windows}, eager "
                           f"{eager.compiled_step_variants()}")
    out["16a"] = {**held, **_capture_record(graph)}
    log("graphs 16a:", json.dumps(out["16a"]), "|", card)

    # 16b: the step key is an input of the graph, refilled every window.
    out["16b"] = _step_key_replays(graph)
    log("graphs 16b:", json.dumps(out["16b"]))

    # 16c: a second identical wave set captures nothing; /metrics agrees.
    before = (graph.compiled_step_variants(),
              len(graph._programs.capture_seconds))
    again = graph_waves(graph, vocab)
    after = (graph.compiled_step_variants(),
             len(graph._programs.capture_seconds))
    text = asyncio.run(_scrape_metrics(api))
    gauge = _metric(text, "kgct_jit_compiles_total")
    if after != before or gauge != after[0] or \
            _held_rows(again, e_run)["rows_equal"] != held["rows_equal"]:
        raise RuntimeError(f"16c: programs {before} -> {after}, /metrics "
                           f"{gauge}")
    out["16c"] = {"programs": after[0], "new_captures": after[1] - before[1],
                  "kgct_jit_compiles_total": gauge}
    log("graphs 16c:", json.dumps(out["16c"]))
    del api, graph, eager, g_run, e_run, again
    gc.collect()
    torch.cuda.empty_cache()

    # Phase 4's workload, captured against eager, in turns on one card.
    reqs = workload(vocab)
    hist = counters["flash_prefill_hist"]
    engines = {"graph": LLMEngine(cfg_engine, params=params, device=device)}
    engines["eager"] = LLMEngine(dataclasses.replace(cfg_engine,
                                                     enforce_eager=True),
                                 params=params, device=device)
    for eng in engines.values():
        drive(eng, reqs[1:3], "warm", hist)
    runs = {k: [] for k in engines}
    for tag in ("eager", "graph", "graph", "eager"):
        runs[tag].append(drive(engines[tag], reqs, f"t{len(runs[tag])}",
                               hist))
    first = runs["graph"][0]
    differ = {f"{k}{i}": {
        "same_schedule": r["schedule"] == first["schedule"],
        **{rid: _first_diff(t, first["tokens"].get(rid, []))
           for rid, t in r["tokens"].items()
           if t != first["tokens"].get(rid)}}
        for k, rs in runs.items() for i, r in enumerate(rs)
        if r["tokens"] != first["tokens"]}
    if differ:
        raise RuntimeError("phase 4 workload: captured and eager tokens "
                           "differ from the first captured run (request: "
                           f"first differing output) {differ}")
    out["phase4"] = {k: [r["tokens_per_s"] for r in rs]
                     for k, rs in runs.items()}
    out["phase4"]["capture"] = _capture_record(engines["graph"])
    log("graphs phase 4 tokens/s:", json.dumps(out["phase4"]), "|", card)
    del engines, runs
    gc.collect()
    torch.cuda.empty_cache()

    # 15c's census: synchronizing calls per step, captured and eager.
    cfg15 = _analysis_cfg(cfg_engine)
    reqs15 = analysis_workload(vocab)
    census = {}
    for tag, cfg in (("graph", cfg15),
                     ("eager", dataclasses.replace(cfg15,
                                                   enforce_eager=True))):
        eng = LLMEngine(cfg, params=params, device=device)
        with sync_sites():
            drive(eng, reqs15[1:3], "warm", hist)
        with sync_sites() as sites:
            run = drive(eng, reqs15, "c", hist)
        census[tag] = {"sync_calls": sum(sites.values()),
                       "steps": run["steps"],
                       "per_step": sum(sites.values()) / run["steps"],
                       "by_line": dict(sites.most_common()),
                       "kinds": run["kinds"]}
        census[tag]["tokens"] = run["tokens"]
        del eng
    if census["graph"].pop("tokens") != census["eager"].pop("tokens"):
        raise RuntimeError("15c census: captured and eager tokens differ")
    spec_sites = _spec_fetch_sites(census)
    if spec_sites:
        raise RuntimeError(f"15c census: spec steps still synchronize at "
                           f"{spec_sites}")
    out["census"] = census
    log("graphs census:", json.dumps(census), "|", card)

    # 16d: a host read injected into the window body fails its capture,
    # and leaves the caching allocator able to release memory.
    gc.collect()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    eng = LLMEngine(cfg16, params=params, device=device)
    bodies = eng._programs._bodies

    def leaky(body):
        def run(key, bufs):
            body(key, bufs)
            return int(bufs["out_tok"].reshape(-1)[0])
        return run

    eng._programs._bodies = {f: leaky(b) for f, b in bodies.items()}
    try:
        eng.generate([[5] * 30], SamplingParams(max_tokens=GRAPH_TOKENS))
    except CaptureError as err:
        out["16d"] = {"raised": type(err).__name__,
                      "cause": type(err.__cause__).__name__,
                      "message": str(err)[:200],
                      "programs": eng.compiled_step_variants()}
    else:
        raise RuntimeError("16d: a host read in a step body was captured")
    del eng, bodies
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out["16d"]["reserved_bytes"] = [reserved,
                                    torch.cuda.memory_reserved(device)]
    probe = torch.ones(4, device=device).sum()
    if float(probe) != 4.0 or out["16d"]["reserved_bytes"][1] > \
            reserved + (256 << 20):
        raise RuntimeError(f"16d: after the failed capture the card gives "
                           f"{float(probe)} for 4.0, reserved bytes "
                           f"{out['16d']['reserved_bytes']}")
    log("graphs 16d:", json.dumps(out["16d"]))

    # The filter tiers chosen on the device at this vocabulary: every tier
    # computed each call, the [B, V] full sort included (device time of
    # calls captured in a graph, which the host-branch version could not
    # be).
    from kubernetes_gpu_cluster_tpu_torch.ops import sampling as S
    gen = torch.Generator(device=device).manual_seed(SEED)
    scaled = torch.randn((GRAPH_SEQS, vocab), generator=gen, device=device)
    top_k = torch.full((GRAPH_SEQS,), 50, dtype=torch.int32, device=device)
    top_p = torch.full((GRAPH_SEQS,), 0.95, device=device)
    out["filters"] = {
        "B": GRAPH_SEQS, "V": vocab,
        "apply_filters_ms": graph_ms(
            lambda: S._apply_filters(scaled, top_k, top_p), 20),
        "full_sort_ms": graph_ms(
            lambda: torch.sort(scaled, dim=-1, descending=True), 20)}
    log("graphs filters:", json.dumps(out["filters"]), "|", card)
    out["seconds"] = time.perf_counter() - t0
    return out


STEP_TOKENS = 24          # 16f: new tokens per request
TTFT_PROMPT = 64          # 16f: the short prompt whose first token is timed
TTFT_REPS = 10


def step_requests(vocab: int) -> list:
    """16f's requests (arrival step, id, prompt, SamplingParams): pure
    prefills of one row (T 128, B 1) and of three (T 1024, B 4), then two
    prompts arriving while those decode, chunked beside them as mixed steps
    (a 700-token chunk: Tp 1024, R 8, W 64; a 2500-token prompt: Tp 2048
    over W 128, then Tp 512 over W 256); every sampling kind, logprobs on
    every row, EOS ignored so that every wave takes the same steps."""
    from kubernetes_gpu_cluster_tpu_torch.engine import SamplingParams
    rng = np.random.default_rng(SEED + 17)
    T = STEP_TOKENS
    kinds = [dict(temperature=0.0, top_logprobs=3),
             dict(temperature=0.8, seed=1701),
             dict(temperature=0.0, presence_penalty=0.5,
                  frequency_penalty=0.3, logit_bias={13: 3.0}),
             dict(temperature=0.7, top_k=50, top_p=0.95, seed=1702),
             dict(temperature=1.0),                         # unseeded
             dict(temperature=0.6, seed=1703, frequency_penalty=0.4,
                  top_logprobs=2)]
    shape = [(0, 100), (1, 150), (1, 200), (1, 250), (3, 700), (5, 2500)]
    return [(step, f"s{i}", [int(t) for t in rng.integers(1, vocab, n)],
             SamplingParams(max_tokens=T, logprobs=True, ignore_eos=True,
                           **kinds[i]))
            for i, (step, n) in enumerate(shape)]


def _serve(engine, reqs, tag: str) -> dict:
    """``reqs`` by arrival step; per request (tokens, logprobs)."""
    pending = sorted(reqs, key=lambda r: r[0])
    final, step = {}, 0
    while pending or engine.has_unfinished_requests():
        while pending and pending[0][0] <= step:
            _, rid, prompt, sp = pending.pop(0)
            engine.add_request(f"{tag}-{rid}", prompt, sp)
        for out in engine.step():
            if out.finished:
                final[out.request_id[len(tag) + 1:]] = (
                    out.output_token_ids, out.output_logprobs)
        step += 1
    return final


def _step_waves(engine, vocab: int, tag: str) -> dict:
    """16f's waves: the staggered requests, then a 3000-token prompt alone
    (solo chunks: T 2048 over W 128, then T 1024 over W 256)."""
    from kubernetes_gpu_cluster_tpu_torch.engine import SamplingParams
    out = _serve(engine, step_requests(vocab), tag)
    long = [int(t) for t in np.random.default_rng(SEED + 18).integers(
        1, vocab, 3000)]
    out.update(_serve(engine, [(0, "solo", long, SamplingParams(
        max_tokens=STEP_TOKENS, temperature=0.0, logprobs=True,
        ignore_eos=True))], tag))
    return out


UNSEEDED = ("s4",)        # 16f's unseeded row: its keys differ wave to wave


def _first_token_ms(engine, vocab: int) -> float:
    """Median ms from ``add_request`` of a ``TTFT_PROMPT``-token prompt on
    an idle engine to its first token (one step: the prefill and its
    fetch)."""
    from kubernetes_gpu_cluster_tpu_torch.engine import SamplingParams
    rng = np.random.default_rng(SEED + 19)
    times = []
    for i in range(TTFT_REPS + 1):
        prompt = [int(t) for t in rng.integers(1, vocab, TTFT_PROMPT)]
        t0 = time.perf_counter()
        engine.add_request(f"ttft-{i}", prompt,
                           SamplingParams(max_tokens=1, temperature=0.0))
        outs = engine.step()
        times.append((time.perf_counter() - t0) * 1e3)
        if not outs or not outs[0].finished:
            raise RuntimeError(f"16f: no first token in one step: {outs}")
    return float(np.median(times[1:]))        # the first one captures


def _sampling_stage_ms(engine, device, R: int = 32) -> dict:
    """The programs' sampling stage (``_sample_rows``: bias, penalties with
    a chunk's penalty histogram built inside (``build_counts`` of [R,
    out_cap]), the sampled path and its filter tiers or the argmax, top
    logprobs) on every one of R rows at the engine's vocabulary, device
    time at each gate mix (``gated_graph_ms``), and the histogram alone in
    a CUDA graph."""
    from kubernetes_gpu_cluster_tpu_torch.engine.sampling_params import \
        LOGIT_BIAS_CAP
    from kubernetes_gpu_cluster_tpu_torch.ops import sampling as S
    V = engine.model_config.vocab_size
    gen = torch.Generator(device=device).manual_seed(SEED)
    i32 = dict(dtype=torch.int32, device=device)
    bufs = {"bias_ids": torch.full((R, LOGIT_BIAS_CAP), -1, **i32),
            "bias_vals": torch.zeros((R, LOGIT_BIAS_CAP), device=device),
            "presence": torch.zeros(R, device=device),
            "frequency": torch.zeros(R, device=device),
            "step_key": torch.tensor([7], **i32),
            "seed": torch.full((R,), -1, **i32),
            "temperature": torch.full((R,), 0.8, device=device),
            "top_k": torch.full((R,), 50, **i32),
            "top_p": torch.full((R,), 0.95, device=device)}
    logits = torch.randn((R, V), generator=gen, device=device)
    pos = torch.arange(R, **i32)
    out_tokens = torch.full((R, engine._out_cap), -1, **i32)
    flags, gated = _open_flags(device)
    return {"R": R, "V": V,
            "sample_rows_ms": gated_graph_ms(lambda: engine._sample_rows(
                bufs, logits, lambda: S.build_counts(out_tokens, V), gated,
                pos), 20, flags),
            "build_counts_ms": graph_ms(lambda: S.build_counts(out_tokens,
                                                               V), 20)}


def check_step_programs(cfg_engine, params, device, card: str) -> dict:
    """16f on the phase-4 weights: a captured engine and an enforce_eager
    one serve ``_step_waves`` (pure prefill at two (T, B), solo chunks at
    two widths, mixed steps at three (Tp, R, W)): identical tokens and
    logprobs, every family captured, a second identical wave captures
    nothing and the gauge equals the programs built; then a short prompt's
    first token captured against eager, and the sampling stage's time at
    R 32 with its gates closed, at the sampled mix and all open (the JAX
    programs' lax.cond stages as conditional nodes)."""
    from kubernetes_gpu_cluster_tpu_torch.config import (CacheConfig,
                                                         SchedulerConfig)
    from kubernetes_gpu_cluster_tpu_torch.engine import LLMEngine
    from kubernetes_gpu_cluster_tpu_torch.engine.step_programs import \
        program_bytes
    from kubernetes_gpu_cluster_tpu_torch.serving import build_server
    t0 = time.perf_counter()
    vocab = cfg_engine.model.vocab_size
    cfg = dataclasses.replace(
        cfg_engine, cache=CacheConfig(page_size=cfg_engine.cache.page_size,
                                      num_pages=GRAPH_PAGES),
        scheduler=SchedulerConfig(max_num_seqs=GRAPH_SEQS))
    api = build_server(cfg, params=params, device=device, model_name=MODEL)
    graph = api.engine.engine
    eager = LLMEngine(dataclasses.replace(cfg, enforce_eager=True),
                      params=params, device=device,
                      eos_token_id=graph.eos_token_id)
    runs = {"graph": _step_waves(graph, vocab, "w1"),
            "eager": _step_waves(eager, vocab, "w1")}
    if runs["graph"] != runs["eager"]:
        diff = sorted(r for r in runs["graph"]
                      if runs["graph"][r] != runs["eager"].get(r))
        raise RuntimeError(f"16f: captured and eager differ for {diff}")
    progs = graph._programs
    keys = {f: progs.keys(f) for f in ("prefill", "prefill_hist", "mixed")}
    if (len(keys["prefill"]) < 2 or len(keys["prefill_hist"]) < 2
            or len(keys["mixed"]) < 2 or eager.compiled_step_variants()):
        raise RuntimeError(f"16f: programs {keys}, eager "
                           f"{eager.compiled_step_variants()}")
    out = {"16f": {"requests": len(runs["graph"]),
                   "keys": {f: [list(k) for k in ks]
                            for f, ks in keys.items()},
                   **_capture_record(graph),
                   "reckoned_bytes": program_bytes(cfg)}}
    before = (graph.compiled_step_variants(), len(progs.capture_seconds))
    again = _step_waves(graph, vocab, "w2")
    after = (graph.compiled_step_variants(), len(progs.capture_seconds))
    gauge = _metric(asyncio.run(_scrape_metrics(api)),
                    "kgct_jit_compiles_total")
    same = all(again[r] == runs["graph"][r] for r in again
               if r not in UNSEEDED)
    if not same or after != before or gauge != after[0]:
        raise RuntimeError(f"16f: second wave: programs {before} -> "
                           f"{after}, gauge {gauge}, greedy and seeded rows "
                           f"equal {same}")
    out["16f"].update(new_captures=after[1] - before[1], programs=after[0],
                      gauge=gauge)
    log("step programs 16f:", json.dumps(out["16f"]), "|", card)
    out["first_token_ms"] = {"graph": _first_token_ms(graph, vocab),
                             "eager": _first_token_ms(eager, vocab),
                             "prompt": TTFT_PROMPT}
    log("step programs 16f first token:", json.dumps(out["first_token_ms"]),
        "|", card)
    out["sampling"] = _sampling_stage_ms(graph, device)
    log("step programs 16f sampling stage:", json.dumps(out["sampling"]),
        "|", card)
    del api, graph, eager, runs, again
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def check_graph_int4(cfg_engine4, device, counters, card: str) -> dict:
    """16e: phase 4b's workload on an int4 engine, captured against eager
    on the same packed weights; ``int4_matmul`` launched by replays."""
    from kubernetes_gpu_cluster_tpu_torch.engine import LLMEngine
    reqs = workload(cfg_engine4.model.vocab_size, n_req=12, long_len=2500,
                    max_prompt=768, wave=1)
    hist = counters["flash_prefill_hist"]
    graph = LLMEngine(cfg_engine4, device=device)
    eager = LLMEngine(dataclasses.replace(cfg_engine4, enforce_eager=True),
                      params=graph.params, device=device)
    for eng in (graph, eager):
        drive(eng, reqs[1:3], "warm", hist)
    runs, launched = {}, {}
    for tag, eng in (("eager", eager), ("graph", graph)):
        for mod in counters.values():
            mod.launches = 0
        replays = eng._programs.replays
        runs[tag] = drive(eng, reqs, tag, hist)
        launched[tag] = {n: m.launches for n, m in counters.items()}
        launched[tag]["replays"] = eng._programs.replays - replays
    recorded = {repr(k): eng_launches for k, eng_launches in
                graph._programs.recorded_launches().items()}
    if runs["graph"]["tokens"] != runs["eager"]["tokens"]:
        raise RuntimeError("16e: captured and eager int4 tokens differ")
    if (launched["graph"]["replays"] <= 0
            or any(launched["graph"][n] != launched["eager"][n]
                   for n in counters)
            or not all(r.get("int4_matmul", 0) > 0
                       for r in recorded.values())):
        raise RuntimeError(f"16e: launches {launched}, recorded {recorded}")
    out = {"tokens_per_s": {t: r["tokens_per_s"] for t, r in runs.items()},
           "launches": launched, "recorded": recorded,
           "capture": _capture_record(graph),
           "kinds": runs["graph"]["kinds"]}
    log("graphs 16e int4:", json.dumps(out), "|", card)
    params4 = graph.params
    del graph, eager
    gc.collect()
    torch.cuda.empty_cache()
    out["spec"] = _int4_spec_round(cfg_engine4, params4, device, counters)
    log("graphs 16e int4 spec:", json.dumps(out["spec"]), "|", card)
    return out


def _int4_spec_round(cfg_engine4, params4, device, counters) -> dict:
    """16e's spec case: n-gram speculation (k 4, mixing on) on the int4
    weights, four repetitive requests, captured against enforce_eager:
    the same tokens and logprobs, and the verify programs' graphs hold the
    int4 kernel and the verify kernel."""
    from kubernetes_gpu_cluster_tpu_torch.engine import (LLMEngine,
                                                         SamplingParams)
    from kubernetes_gpu_cluster_tpu_torch.ops.cuda import spec_verify
    sc = dataclasses.replace(cfg_engine4.scheduler, spec_decode_enabled=True,
                             num_speculative_tokens=4,
                             mixed_batch_enabled=True)
    cfg = dataclasses.replace(cfg_engine4, scheduler=sc)
    rng = np.random.default_rng(SEED + 21)
    pattern = [int(t) for t in rng.integers(1, cfg.model.vocab_size, 16)]
    sp = SamplingParams(max_tokens=24, temperature=0.0, logprobs=True)
    reqs = [(2 * i, f"q{i}", (pattern * 40)[i:i + 100 + 150 * i], sp)
            for i in range(4)]
    counters = {**counters, "spec_verify": spec_verify}
    runs, recorded = {}, {}
    for tag, eager in (("graph", False), ("eager", True)):
        eng = LLMEngine(dataclasses.replace(cfg, enforce_eager=eager),
                        params=params4, device=device)
        runs[tag] = _spec_run(eng, reqs, tag, counters)
        if not eager:
            recorded = {repr(k): n for k, n in
                        eng._programs.recorded_launches().items()
                        if k[0] in ("spec", "spec_mixed")}
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    held = _held_spec("16e int4 spec", runs["graph"], runs["eager"], reqs)
    if (not recorded or not all(n.get("int4_matmul", 0) > 0
                                and n.get("spec_verify", 0) > 0
                                for n in recorded.values())
            or runs["graph"]["drafted"] <= 0):
        raise RuntimeError(f"16e int4 spec: recorded {recorded}, drafted "
                           f"{runs['graph']['drafted']}")
    return {"held": held, "recorded": recorded,
            "kinds": runs["graph"]["kinds"],
            "acceptance": runs["graph"]["acceptance"],
            "tokens_per_s": {t: r["tokens_per_s"] for t, r in runs.items()}}


# ---------------------------------------------------------------------------
# Phase 12: tensor and expert parallelism, ranks in child processes
# ---------------------------------------------------------------------------

RANK_LAYERS = 8      # phases 12, 12c, 13b: llama-3-8b's width, this depth
STREAMED_REQS = 4    # 14a: requests beside the long one (12 has 7); the
                     # fourth arrives while the others decode (a mixed step)
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
        procs.append(start_child(
            ["--tp-child",
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


def _param_gb(params) -> float:
    return sum(t.numel() * t.element_size()
               for t in [*params["layers"].values(),
                         *(v for k, v in params.items() if k != "layers")]
               ) / 1e9


def host_peak(load) -> tuple:
    """(``load()``, its seconds and this process's host peak over it:
    ``engine.weights.HostPeak``, the growth of the resident set, sampled
    every 2 ms, and exact where the kernel keeps a resettable ``VmHWM``).
    ``engine/weights.py`` reads with ``preadv``, never a memory map, so
    the resident set counts what the process holds."""
    from kubernetes_gpu_cluster_tpu_torch.engine.weights import HostPeak
    gc.collect()
    t0 = time.perf_counter()
    with HostPeak() as hp:
        out = load()
    return out, {"s": time.perf_counter() - t0, "peak_gb": hp.peak / 1e9,
                 "rss_before_gb": hp.before / 1e9, "exact": hp.exact}


def _held_to_draw(params, cfg, groups, device) -> int:
    """Every local tensor of ``params`` is ``torch.equal`` to
    ``shard_tensor`` of phase 4's draw of its full tensor (the seed's
    ``init_params`` on this card, one full tensor at a time, nothing
    kept). Returns the number of tensors compared."""
    from kubernetes_gpu_cluster_tpu_torch.models import llama as M
    from kubernetes_gpu_cluster_tpu_torch.parallel.sharding import \
        init_shard_fn
    shard = init_shard_fn(cfg, groups)
    seen, bad = [], []

    def check(name, full, top):
        local = shard(name, full, top)
        got = params[name] if top else params["layers"][name]
        seen.append(name)
        if not torch.equal(got, local):
            bad.append(name)
        return local[:0]
    M.init_params(cfg, torch.Generator(device=device).manual_seed(SEED),
                  device, shard=check)
    if bad or len(seen) != len(params["layers"]) + len(params) - 1:
        raise RuntimeError(f"streamed tensors differ from the seed's slices: "
                           f"{bad} ({len(seen)} compared)")
    return len(seen)


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
    params = None
    if spec.get("weights"):
        # 14a: this rank's slices streamed from the checkpoint, each held
        # to the seed's draw of the full tensor sliced by shard_tensor.
        from kubernetes_gpu_cluster_tpu_torch.engine.weights import \
            load_weights

        def load():
            out = load_weights(spec["weights"], model, device=device,
                               groups=groups)
            torch.cuda.synchronize(device)
            return out
        params, res["load"] = host_peak(load)
        res["load"]["tensors_equal"] = _held_to_draw(params, model, groups,
                                                     device)
        res["load"]["local_gb"] = _param_gb(params)
        if not spec.get("serve", True):
            Path(spec["out"]).write_text(json.dumps(res))
            import torch.distributed as dist
            dist.destroy_process_group()
            return
    if rank == 0:
        addrs = [f"127.0.0.1:{ctrl[2 * k]}" for k in range(1, world)]
        aeng = AsyncLLMEngine(cfg, params=params, device=device,
                              groups=groups, leader=DirectiveLeader(addrs))
        engine = aeng.engine
    else:
        engine = LLMEngine(cfg, params=params, device=device, groups=groups)
    del params
    torch.cuda.synchronize(device)
    res["init_s"] = time.perf_counter() - t0
    res["weight_gb"] = _param_gb(engine.params)
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
    """``got`` (a run on more than one rank, or 15d's perturbed run)
    equals ``ref`` (the reference run's tokens: the one-device engine's,
    or the unperturbed run's; None: none to compare) up to its first
    difference j. From j on, each token is, teacher forced on the
    one-device weights ``params`` (one prefill of prompt + got), the top
    token or under ``RESUME_DRIFT`` of the logits' deviation below it: the
    one-device greedy continuation of what came before, but for near-ties
    that another summation order (the all-reduce's, another batching) may
    flip. Each token off the top goes into ``ties``. Returns whether
    ``got`` equals ``ref``."""
    if not got:
        raise RuntimeError(f"{what}: no tokens")
    j = 0
    if ref is not None:
        j = _first_diff(got, ref)
        if j == min(len(got), len(ref)):
            if len(got) != len(ref):
                raise RuntimeError(f"{what}: {len(got)} tokens, the "
                                   f"reference run {len(ref)}")
            return True
        log(f"{what}: tokens differ from the reference run at output {j}")
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


def _hold_tp_lead(tag: str, what: str, ranks: list, reqs, ref, params,
                  cfg, device) -> tuple[list, list]:
    """Phase 12's checks of a tp 2 run against the tp=1 run ``ref``: the
    same step schedule, each request's tokens held by ``_held_forced``, the
    three attention kernels launched on every rank, every step kind run.
    Returns (the requests equal to tp=1, the tokens off the top)."""
    lead = ranks[0]
    _same_schedule(tag, lead["schedule"], ref["schedule"])
    ties: list = []
    equal = [rid for _, rid, prompt, _ in reqs if _held_forced(
        f"{what} {rid}", lead["tokens"][rid], ref["tokens"][rid],
        prompt, params, cfg, device, ties)]
    _launched(tag, ranks, ("paged_decode", "flash_prefill",
                           "flash_prefill_hist"))
    for kind in ("prefill", "chunked", "mixed", "decode"):
        if lead["kinds"].get(kind, 0) <= 0:
            raise RuntimeError(f"{tag}: no {kind} step ran: {lead['kinds']}")
    return equal, ties


def tp1_reference(cfg, params, device, n_req: int = 7
                  ) -> tuple[list, dict]:
    """Phase 12's requests (the long one and ``n_req`` more) and their run
    on the one-device engine (tp 1): the run tp 2 (12, 12d) and the
    streamed tp 2 ranks (14a, ``STREAMED_REQS``) are held to."""
    from kubernetes_gpu_cluster_tpu_torch.config import (
        CacheConfig, EngineConfig, SchedulerConfig)
    from kubernetes_gpu_cluster_tpu_torch.engine import LLMEngine
    from kubernetes_gpu_cluster_tpu_torch.ops.cuda import flash_prefill_hist
    reqs = tp_requests(cfg.vocab_size, n_req=n_req, long_len=TP_LONG)
    engine = LLMEngine(EngineConfig(
        model=cfg, seed=SEED, cache=CacheConfig(page_size=16,
                                                num_pages=TP_PAGES),
        scheduler=SchedulerConfig(max_num_seqs=TP_SEQS)), params=params,
        device=device)
    ref = drive(engine, reqs, "tp1", flash_prefill_hist)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return reqs, ref


def check_tp(cfg, params, device, card: str, devices: list,
             backend: str, abort: bool) -> tuple[dict, dict]:
    """Phase 12 (12d with NCCL on two cards): ``cfg`` (llama-3-8b bf16,
    its layers as given) at tp 2 against the tp=1 engine on the same seed;
    12c on the same ranks. Returns the record and the tp=1 run."""
    ps = 16
    reqs, ref = tp1_reference(cfg, params, device)
    tag = "12" if backend == "gloo" else "12d"
    t0 = time.perf_counter()
    ranks = spawn_ranks(tag, dict(model=cfg.name, quant=None, tp=2, ep=1,
                                  page_size=ps, pages=TP_PAGES,
                                  reqs=_req_spec(reqs), allreduce=True,
                                  abort=abort, layers=cfg.num_layers),
                        devices, backend, timeout_s=600)
    lead = ranks[0]
    equal, ties = _hold_tp_lead(tag, f"tp 2 ({backend})", ranks, reqs, ref,
                                params, cfg, device)
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
    return out, ref


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
                              "pages": TP_PAGES, "reqs": _req_spec(reqs),
                              "layers": cfg.num_layers},
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
    """One rank of phase 12e (13c, 14b): the server's CLI (the module
    ``spec["module"]``, ``api_server`` by default, run as ``__main__`` with
    ``spec["argv"]``) in this process. A rank of a group first joins it
    over gloo: two ranks share one card, where NCCL, the CLI's own choice
    on a card, refuses; 14b's one-rank Deployment joins nothing. Writes
    the kernel launches, counted from this process's first admitted
    request, and the engine's tokens by prompt to ``spec["out"]``."""
    import runpy

    import torch.distributed as dist

    from kubernetes_gpu_cluster_tpu_torch.engine.engine import LLMEngine
    from kubernetes_gpu_cluster_tpu_torch.ops.cuda import (
        flash_prefill, flash_prefill_hist, paged_decode)
    from kubernetes_gpu_cluster_tpu_torch.parallel import \
        initialize_distributed
    group = spec.get("group", True)
    if group:
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
    module = spec.get("module", "kubernetes_gpu_cluster_tpu_torch.serving."
                                "api_server")
    sys.argv = [module, *spec["argv"]]
    try:
        runpy.run_module(module, run_name="__main__", alter_sys=True)
    finally:
        Path(spec["out"]).write_text(json.dumps({
            "rank": spec["rank"],
            "launches": {n: m.launches if prompts else 0
                         for n, m in counters.items()},
            "requests": [[prompts[r], t] for r, t in tokens.items()]}))
        if group:
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
                 tag: str = "12e", argv: Optional[list] = None,
                 module: Optional[str] = None) -> dict:
    """Phase 12e (13c with ``flag`` --pipeline-parallel-size; 14b with a
    rendered pod's ``argv`` and command ``module``): the server's CLI at
    size 2 of ``flag``, two ``--distributed`` ranks on card 0 (each
    ``chip_smoke.py --cli-rank``). Requests over HTTP; the engine's tokens
    held to the one-device weights by teacher forcing; the attention
    kernels launched on both ranks; the follower's /health 200; SIGTERM
    drains rank 0, whose stop directive lets rank 1 exit, both with 0."""
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
        rank_argv = (argv or ["--model", MODEL, flag, "2", "--distributed",
                              "--hbm-utilization", "0.1",
                              "--max-num-seqs", "8"]) + [
            "--device", "cuda:0", "--host", "127.0.0.1",
            "--port", str(port if rank == 0 else health)]
        logs.append(open(work / f"rank{rank}.log", "w"))
        child = {"rank": rank, "device": "cuda:0", "argv": rank_argv,
                 "out": str(out)}
        if module:
            child["module"] = module
        procs.append(start_child(
            ["--cli-rank", json.dumps(child)],
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


CKPT_DIR = REPO / "build" / MODEL   # the name maps --model to the preset
CKPT_FILES = 4                      # HF's sharded save: ~4 GB files
CKPT_LAYERS = 32                    # full depth: 16.1 GB of bf16
DEPLOY_PROMPTS = (64, 300, 900, 2500)  # 14b: the Deployment's requests
DEPLOY_TOKENS = 16
TERM_GRACE_S = 150                  # the rendered terminationGracePeriod


def _hf_llama_tensors(params, cfg):
    """(HF name, the tensor as HF stores it) of llama ``params``, lazily:
    ``[out, in]`` matrices, one layer at a time."""
    yield "model.embed_tokens.weight", lambda: params["embed"]
    yield "model.norm.weight", lambda: params["final_norm"]
    yield "lm_head.weight", lambda: params["lm_head"].T
    hf = {"input_norm": "input_layernorm.weight",
          "post_attn_norm": "post_attention_layernorm.weight",
          "wq": "self_attn.q_proj.weight", "wk": "self_attn.k_proj.weight",
          "wv": "self_attn.v_proj.weight", "wo": "self_attn.o_proj.weight",
          "w_gate": "mlp.gate_proj.weight", "w_up": "mlp.up_proj.weight",
          "w_down": "mlp.down_proj.weight"}
    for layer in range(cfg.num_layers):
        for ours, theirs in hf.items():
            t = params["layers"][ours]
            yield (f"model.layers.{layer}.{theirs}",
                   (lambda t=t, layer=layer: t[layer].T) if t.dim() == 3
                   else (lambda t=t, layer=layer: t[layer]))


def write_checkpoint(params, cfg, path: Path, n_files: int) -> dict:
    """Phase 14: ``params`` (llama, bf16, on the card) as an HF
    safetensors checkpoint in ``n_files`` files of about equal size, with
    ``model.safetensors.index.json`` and ``config.json``. Plain Python: an
    8-byte little-endian header length, the JSON header of dtype, shape
    and offsets, then each tensor's bytes, copied off the card one layer
    at a time."""
    if cfg.num_layers != CKPT_LAYERS:
        raise RuntimeError(f"{cfg.name}: {cfg.num_layers} layers, the "
                           f"checkpoint is written at {CKPT_LAYERS}")
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    items = list(_hf_llama_tensors(params, cfg))
    shapes, sizes = {}, []
    for name, get in items:
        t = get()
        shapes[name] = list(t.shape)
        sizes.append(t.numel() * 2)
    per_file = -(-sum(sizes) // n_files)
    files: list[list] = [[]]
    acc = 0
    for (name, get), n in zip(items, sizes):
        if acc + n > per_file and files[-1] and len(files) < n_files:
            files.append([])
            acc = 0
        files[-1].append((name, get, n))
        acc += n
    t0 = time.perf_counter()
    weight_map = {}
    for i, group in enumerate(files):
        fname = f"model-{i + 1:05d}-of-{len(files):05d}.safetensors"
        header, at = {}, 0
        for name, _, n in group:
            header[name] = {"dtype": "BF16", "shape": shapes[name],
                            "data_offsets": [at, at + n]}
            at += n
            weight_map[name] = fname
        raw = json.dumps(header).encode()
        raw += b" " * (-len(raw) % 8)
        with open(path / fname, "wb") as f:
            f.write(len(raw).to_bytes(8, "little"))
            f.write(raw)
            for name, get, n in group:
                t = get().contiguous().view(torch.int16).cpu().numpy()
                f.write(t.tobytes())
    (path / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": sum(sizes)}, "weight_map": weight_map}))
    (path / "config.json").write_text(json.dumps({
        "architectures": ["LlamaForCausalLM"], "model_type": "llama",
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
        "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_norm_eps,
        "rope_scaling": dict(cfg.rope_scaling or ()) or None,
        "max_position_embeddings": cfg.max_model_len,
        "tie_word_embeddings": False, "torch_dtype": "bfloat16"}))
    secs = time.perf_counter() - t0
    return {"gb": sum(sizes) / 1e9, "files": len(files), "s": secs,
            "gb_per_s": sum(sizes) / 1e9 / secs}


def whole_load_child(spec: dict) -> None:
    """14a's whole-then-slice reading, in a process of its own: the whole
    checkpoint loaded on the host (``load_weights(device="cpu")``), then
    rank 0's tp 2 slices (``shard_params``), as every rank loaded before
    the streamed load; its seconds and host peak to ``spec["out"]``."""
    from kubernetes_gpu_cluster_tpu_torch.config import get_model_config
    from kubernetes_gpu_cluster_tpu_torch.engine.weights import load_weights
    from kubernetes_gpu_cluster_tpu_torch.parallel import make_mesh
    from kubernetes_gpu_cluster_tpu_torch.parallel.sharding import \
        shard_params
    cfg = get_model_config(MODEL)
    groups = make_mesh(tp=2, rank=0)
    local, rec = host_peak(lambda: shard_params(
        load_weights(spec["path"], cfg, device="cpu"), cfg, groups))
    rec["local_gb"] = _param_gb(local)
    Path(spec["out"]).write_text(json.dumps(rec))


def _whole_load_start(path: Path):
    """Start the whole-then-slice child (its own process: its host peak is
    its own, whatever runs beside it)."""
    out = TP_DIR / "14a-whole.json"
    out.unlink(missing_ok=True)
    TP_DIR.mkdir(parents=True, exist_ok=True)
    logf = open(TP_DIR / "14a-whole.log", "w")
    proc = start_child(
        ["--whole-load", json.dumps({"path": str(path), "out": str(out)})],
        stdout=logf, stderr=subprocess.STDOUT)
    return proc, logf, out


def _whole_load_finish(proc, logf, out: Path) -> dict:
    try:
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        logf.close()
    if rc != 0 or not out.exists():
        raise RuntimeError(f"14a whole load exited {rc}:\n"
                           + (TP_DIR / "14a-whole.log").read_text()[-3000:])
    return json.loads(out.read_text())


def check_streamed(cfg, params, device, card: str, path: Path,
                   tp_ref: dict) -> dict:
    """Phase 14a: two ranks on card 0 over gloo stream their slices of the
    phase-14 checkpoint, at tp 2 and at pp 2; every local tensor is
    ``torch.equal`` to ``shard_tensor`` of phase 4's weights (the seed's
    draw); each logs its load seconds and host peak, and a separate
    process, run beside them, the whole-then-slice path's. The tp 2 ranks
    then serve ``STREAMED_REQS`` of phase 12's requests on the streamed
    weights, held to ``tp_ref`` (their tp=1 run) as 12 holds its ranks."""
    ps = 16
    reqs = tp_requests(cfg.vocab_size, n_req=STREAMED_REQS, long_len=TP_LONG)
    base = dict(model=cfg.name, quant=None, ep=1, page_size=ps,
                pages=TP_PAGES, reqs=_req_spec(reqs), weights=str(path))
    out: dict = {}
    whole = _whole_load_start(path)
    try:
        _streamed_ranks(cfg, params, device, card, base, reqs, tp_ref, out)
    except BaseException:
        whole[0].kill()
        whole[0].wait()
        whole[1].close()
        raise
    out["whole"] = _whole_load_finish(*whole)
    w = out["whole"]
    log(f"14a whole-then-slice (tp 2 rank 0): {w['local_gb']:.3f} GB kept "
        f"after {w['s']:.2f} s, host peak {w['peak_gb']:.3f} GB over "
        f"{w['rss_before_gb']:.3f} (exact {w['exact']}) | {card}")
    return out


def _streamed_ranks(cfg, params, device, card: str, base: dict, reqs,
                    tp_ref: dict, out: dict) -> None:
    """14a's tp 2 and pp 2 rank pairs, each streaming its slices."""
    for axis in ("tp", "pp"):
        tag = f"14a-{axis}"
        sizes = {"tp": 1, "pp": 1, axis: 2}
        ranks = spawn_ranks(tag, dict(base, **sizes, serve=axis == "tp"),
                            [0, 0], "gloo", timeout_s=600)
        out[axis] = {"load": [r["load"] for r in ranks]}
        if axis == "tp":
            equal, ties = _hold_tp_lead(tag, "streamed tp 2", ranks, reqs,
                                        tp_ref, params, cfg, device)
            out[axis].update(
                equal_to_tp1=f"{len(equal)} of {len(reqs)}", near_ties=ties,
                tokens_per_s=ranks[0]["tokens_per_s"],
                launches=[r["launches"] for r in ranks])
        for r in ranks:
            ld = r["load"]
            log(f"{tag} rank {r['rank']}: {ld['tensors_equal']} tensors "
                f"equal to the seed's slices; {ld['local_gb']:.3f} GB "
                f"streamed in {ld['s']:.2f} s, host peak "
                f"{ld['peak_gb']:.3f} GB over {ld['rss_before_gb']:.3f} "
                f"(exact {ld['exact']}) | {card}")


def _values(path: Path, **vllm) -> dict:
    """14b's values: the reference schema, ``modelURL`` the checkpoint.
    ``--tokenizer byte`` follows the rendered ``--tokenizer <modelURL>``:
    an HF tokenizer needs ``transformers``, which the card's machine lacks,
    and the checkpoint ships none."""
    return {"servingEngineSpec": {"modelSpec": [{
        "name": "llama", "modelURL": str(path), "requestGPU": 1,
        "vllmConfig": {"gpuMemoryUtilization": 0.1,
                       "extraArgs": ["--tokenizer", "byte",
                                     "--max-num-seqs", "8"], **vllm}}]}}


async def _drive_deployment(port: int, probe: str, proc, prompts) -> dict:
    deadline = time.monotonic() + 600
    while True:
        if proc.poll() is not None:
            raise RuntimeError(f"14b: the pod exited {proc.returncode} "
                               "before its readiness probe passed")
        try:
            if (await http_call(port, "GET", probe))["status"] == 200:
                break
        except OSError:
            pass
        if time.monotonic() > deadline:
            raise RuntimeError(f"14b: {probe} on port {port} never passed")
        await asyncio.sleep(0.5)
    up_s = 600 - (deadline - time.monotonic())
    t0 = time.perf_counter()
    replies = [await http_call(port, "POST", "/v1/completions",
                               {"prompt": p, "max_tokens": DEPLOY_TOKENS,
                                "temperature": 0.0}) for p in prompts]
    for r in replies:
        if r["status"] != 200:
            raise RuntimeError(f"14b request: {r['status']} "
                               f"{r['body'][:300]}")
    return {"up_s": up_s, "wall_s": time.perf_counter() - t0,
            "bodies": [json.loads(r["body"]) for r in replies]}


def check_rendered(cfg, params, device, card: str, path: Path) -> dict:
    """Phase 14b: manifests rendered by ``deploy/render.py`` from values
    whose ``modelURL`` is the phase-14 checkpoint. (1) ``requestGPU: 1``:
    the Deployment's container (its command's module run by ``chip_smoke.py
    --cli-rank``, which records the engine's tokens, with the rendered
    args) on card 0; its readiness probe's path and port answered; four
    completions, each held to the in-process engine on phase 4's weights
    serving the prompt alone (equal, or teacher forced under
    ``RESUME_DRIFT``); SIGTERM, exit 0 within the rendered
    ``terminationGracePeriodSeconds``. (2) ``pipelineParallelSize: 2``:
    the StatefulSet's two pods as two ranks on card 0 through 13c's
    harness (gloo, ``KGCT_FOLLOWER_ADDRS``: pod DNS does not exist here),
    each streaming its stage; held as 13c holds its ranks."""
    import signal

    from kubernetes_gpu_cluster_tpu_torch.config import (
        CacheConfig, EngineConfig, SchedulerConfig)
    from kubernetes_gpu_cluster_tpu_torch.deploy.render import render_values
    from kubernetes_gpu_cluster_tpu_torch.engine import (LLMEngine,
                                                         SamplingParams)
    from kubernetes_gpu_cluster_tpu_torch.ops.cuda import build
    ms = render_values(_values(path))
    pod = ms["llama-engine-deployment.yaml"]["spec"]["template"]["spec"]
    c = pod["containers"][0]
    if c["resources"]["limits"].get("nvidia.com/gpu") != 1 or \
            pod["terminationGracePeriodSeconds"] != TERM_GRACE_S:
        raise RuntimeError(f"14b: unexpected Deployment pod {pod}")
    if c["command"][:2] != ["python", "-m"]:
        raise RuntimeError(f"14b: unexpected command {c['command']}")
    probe = c["readinessProbe"]["httpGet"]
    # The container's --port is its probe's; here the pod shares the host's
    # network, where a fixed port may be taken, so both move to a free one
    # (the StatefulSet's ranks below get theirs from 13c's harness).
    at = c["args"].index("--port") + 1
    if int(c["args"][at]) != probe["port"]:
        raise RuntimeError(f"14b: --port {c['args'][at]} but the readiness "
                           f"probe asks port {probe['port']}")
    port = _free_port()
    args = [*c["args"][:at], str(port), *c["args"][at + 1:]]
    rng = np.random.default_rng(SEED + 14)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)]
               for n in DEPLOY_PROMPTS]
    engine = LLMEngine(EngineConfig(
        model=cfg, seed=SEED, cache=CacheConfig(page_size=16,
                                                num_pages=1024),
        scheduler=SchedulerConfig(max_num_seqs=8)), params=params,
        device=device)
    greedy = SamplingParams(max_tokens=DEPLOY_TOKENS, temperature=0.0)
    ref = [engine.generate([p], greedy)[0].output_token_ids for p in prompts]
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    work = REPO / "build" / "deploy-14b"
    work.mkdir(parents=True, exist_ok=True)
    out_file = work / "deployment.json"
    out_file.unlink(missing_ok=True)
    # The runtime image's situation: no nvcc, the prebuilt kernels.
    kdir = build.kernel_dir()
    env = without_nvcc(dict(os.environ, TMPDIR=str(work),
                            KGCT_FLIGHT_DIR=str(work / "flight")), kdir)
    for e in c.get("env") or []:
        env[e["name"]] = e["value"]
    before = kernel_files(kdir)
    if set(before) != {f(n).name for n in build.KERNELS for f in (
            build.library_path, build.stamp_path, build.ptxas_path)}:
        raise RuntimeError(f"14b: {kdir} holds {sorted(before)}")
    with open(work / "deployment.log", "w") as logf:
        proc = start_child(
            ["--cli-rank",
             json.dumps({"rank": 0, "group": False, "module": c["command"][2],
                         "argv": args, "out": str(out_file)})],
            cwd=REPO, env=env, stdout=logf, stderr=subprocess.STDOUT)
        try:
            res = asyncio.run(_drive_deployment(port, probe["path"], proc,
                                                prompts))
            t0 = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=pod["terminationGracePeriodSeconds"])
            res["sigterm_exit_s"] = time.perf_counter() - t0
            if rc != 0:
                raise RuntimeError(f"14b: the pod exited {rc} after SIGTERM")
        except BaseException:
            logf.flush()
            log("14b deployment log tail:\n"
                + (work / "deployment.log").read_text()[-4000:])
            raise
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    after = kernel_files(kdir)
    if after != before:
        raise RuntimeError(f"14b: the pod changed {kdir}: {before} -> "
                           f"{after}")
    res.update(nvcc_on_path=False, kernel_files_unchanged=len(after))
    log(f"14b deployment: no nvcc reachable (PATH without it, no CUDA_HOME "
        f"or CUDA_PATH), {len(after)} libraries, stamps and ptxas reports "
        f"in {kdir} "
        "unchanged in size and mtime")
    served = {tuple(p): t for p, t in
              json.loads(out_file.read_text())["requests"]}
    ties: list = []
    equal = 0
    for i, (prompt, body, want) in enumerate(zip(prompts, res.pop("bodies"),
                                                 ref)):
        got = served.get(tuple(prompt))
        if got is None or body["usage"]["completion_tokens"] != len(got):
            raise RuntimeError(f"14b request {i}: served {got}, the reply "
                               f"says {body['usage']}")
        equal += _held_forced(f"14b deployment request {i}", got, want,
                              prompt, params, cfg, device, ties)
    res.update(equal_to_in_process=f"{equal} of {len(prompts)}",
               near_ties=ties)
    log(f"14b deployment: up in {res['up_s']:.1f} s, {len(prompts)} "
        f"requests in {res['wall_s']:.2f} s, {equal} of {len(prompts)} "
        f"equal to the in-process engine, exit 0 "
        f"{res['sigterm_exit_s']:.2f} s after SIGTERM | {card}")
    sts = render_values(_values(path, pipelineParallelSize=2))[
        "llama-engine-statefulset.yaml"]
    sc = sts["spec"]["template"]["spec"]["containers"][0]
    env = {e["name"]: e.get("value") for e in sc["env"]}
    if sts["spec"]["replicas"] != 2 or env["KGCT_NUM_PROCESSES"] != "2":
        raise RuntimeError(f"14b: unexpected StatefulSet {sts['spec']}")
    res["statefulset"] = check_cli_tp(
        cfg, params, device, card, "--pipeline-parallel-size", "14b",
        argv=sc["args"], module=sc["command"][2])
    return res


REFUSAL_BOUND_S = 60      # 14c (b): the refusal's exit, import included


def _ranks_of(pid: int) -> list:
    """pids of live processes that a server ``pid`` started as its ranks
    (``KGCT_PARENT_PID`` in their environment)."""
    mark = f"KGCT_PARENT_PID={pid}".encode()
    found = []
    for d in Path("/proc").iterdir():
        if d.name.isdigit():
            with contextlib.suppress(OSError):
                if mark in (d / "environ").read_bytes().split(b"\0"):
                    found.append(int(d.name))
    return found


def load_kernel_child(spec: dict) -> None:
    """14c (a): load one kernel library, as a wrapper's first call does."""
    from kubernetes_gpu_cluster_tpu_torch.ops.cuda import build
    build.library(spec["name"])


def check_image_refusals(card: str) -> dict:
    """Phase 14c: what the runtime image refuses, each in a child with no
    nvcc reachable. (a) ``build.library("paged_decode")`` over an empty
    kernel directory: non-zero, the kernel and the directory named, nothing
    written there. (b) The server's CLI at ``--tensor-parallel-size``
    ``device_count() + 1``, no ``--distributed``, the prebuilt kernels:
    non-zero within ``REFUSAL_BOUND_S`` with the start-time refusal, no
    engine built, no weight drawn, no rank left running."""
    from kubernetes_gpu_cluster_tpu_torch.ops.cuda import build
    res = {}
    empty = REPO / "build" / "kernels-14c"
    shutil.rmtree(empty, ignore_errors=True)
    empty.mkdir(parents=True)
    t0 = time.perf_counter()
    proc = start_child(["--load-kernel", json.dumps({"name": "paged_decode"})],
                       cwd=REPO, env=without_nvcc(dict(os.environ), empty),
                       stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                       text=True)
    _, err = proc.communicate(timeout=REFUSAL_BOUND_S)
    res["a"] = {"rc": proc.returncode, "s": time.perf_counter() - t0,
                "message": err.strip().splitlines()[-1] if err.strip() else ""}
    if proc.returncode == 0 or "paged_decode" not in err or \
            str(empty) not in err or any(empty.iterdir()):
        raise RuntimeError(f"14c (a): exit {proc.returncode}, stderr "
                           f"{err[-2000:]}, dir {list(empty.iterdir())}")
    shutil.rmtree(empty)
    tp = torch.cuda.device_count() + 1
    t0 = time.perf_counter()
    proc = start_child(["--model", MODEL, "--tensor-parallel-size", str(tp),
                        "--host", "127.0.0.1", "--port", str(_free_port())],
                       module="kubernetes_gpu_cluster_tpu_torch.serving."
                              "api_server",
                       cwd=REPO, env=without_nvcc(dict(os.environ),
                                                  build.kernel_dir()),
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True)
    try:
        out, _ = proc.communicate(timeout=REFUSAL_BOUND_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        raise RuntimeError(f"14c (b): tp {tp} still running after "
                           f"{REFUSAL_BOUND_S} s:\n{out[-3000:]}") from None
    secs = time.perf_counter() - t0
    left = _ranks_of(proc.pid)
    want = (f"refused: the layout tp {tp} x pp 1 (world {tp}) would start "
            f"ranks {list(range(1, tp))} on this pod")
    lines = out.strip().splitlines()
    res["b"] = {"rc": proc.returncode, "s": secs, "tp": tp,
                "message": lines[-1] if lines else "", "ranks_left": left}
    if proc.returncode == 0 or want not in out or left or \
            "initializing random weights" in out or "started ranks" in out:
        raise RuntimeError(f"14c (b): exit {proc.returncode} in {secs:.1f} s, "
                           f"ranks left {left}, output:\n{out[-3000:]}")
    log(f"14c: (a) exit {res['a']['rc']} in {res['a']['s']:.2f} s: "
        f"{res['a']['message']}")
    log(f"14c: (b) tp {tp} exit {res['b']['rc']} in {secs:.2f} s, no rank "
        f"left: {res['b']['message']} | {card}")
    return res


def check_node_layer(card: str) -> dict:
    """Phase 18: the H100 device plugin and its kubelet stand-in built by
    ``cluster/device-plugin-cuda``'s Makefile and held to the card's driver
    (``tools/node_layer.py``: the inventory against ``nvidia-smi``,
    ``Allocate``'s nodes and mounts, CUDA in a child through the mounts
    alone, SIGTERM). Its processes need no weights and run beside 12d and
    12b."""
    from kubernetes_gpu_cluster_tpu_torch.tools import node_layer
    t0 = time.perf_counter()
    res = node_layer.check(torch.cuda.device_count())
    res["s"] = time.perf_counter() - t0
    cuda = res["cuda"]
    log(f"18: built in {res['build_s']:.2f} s; registered "
        f"{res['inventory']['uuids']} (driver {res['inventory']['driver']}) "
        f"{res['register_ms']:.2f} ms after start; Allocate "
        f"{[round(us, 1) for us in res['allocate_us']]} us; CUDA through "
        f"the mounts alone with CUDA_VISIBLE_DEVICES="
        f"{cuda['env']['CUDA_VISIBLE_DEVICES']} (node {cuda['opened']}, "
        f"driver libraries {cuda['driver_libs']}); SIGTERM exit in "
        f"{res['stop_s']:.3f} s; {res['s']:.1f} s in all | {card}")
    return res


def checkpoint_phases(cfg, params, device, card: str, tp_ref: dict,
                      phase=lambda name: None) -> None:
    """Phase 14: the phase-4 weights written as an HF checkpoint; 14a the
    streamed load from it at tp 2 and pp 2; 14b rendered manifests that
    serve it. The checkpoint goes at the end, on failure too."""
    try:
        ckpt = write_checkpoint(params, cfg, CKPT_DIR, CKPT_FILES)
        log(f"checkpoint (14): {ckpt['gb']:.3f} GB in {ckpt['files']} files "
            f"in {ckpt['s']:.1f} s ({ckpt['gb_per_s']:.2f} GB/s) | {card}")
        phase(f"{MODEL} bf16 checkpoint (14)")
        log("streamed:", json.dumps(check_streamed(
            cfg, params, device, card, CKPT_DIR, tp_ref)), "|", card)
        phase(f"{MODEL} bf16 streamed load (14a)")
        log("deploy:", json.dumps(check_rendered(
            cfg, params, device, card, CKPT_DIR)), "|", card)
        phase(f"{MODEL} bf16 rendered manifests (14b)")
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import signal

    def stop(signum, frame):
        raise Stopped("chip_smoke: the run's time limit of "
                      f"{RUN_LIMIT_S} s" if signum == signal.SIGALRM
                      else "chip_smoke: SIGTERM")
    signal.signal(signal.SIGTERM, stop)
    signal.signal(signal.SIGALRM, stop)
    signal.alarm(RUN_LIMIT_S)
    from kubernetes_gpu_cluster_tpu_torch.config import (
        CacheConfig, EngineConfig, SchedulerConfig, get_model_config)
    from kubernetes_gpu_cluster_tpu_torch.engine.engine import \
        DEFAULT_PAGE_SIZE
    from kubernetes_gpu_cluster_tpu_torch.models import llama as M
    from kubernetes_gpu_cluster_tpu_torch.ops import attention as A
    from kubernetes_gpu_cluster_tpu_torch.ops import quant as Q
    from kubernetes_gpu_cluster_tpu_torch.ops.cuda import (
        build, flash_prefill, flash_prefill_hist, int4_matmul, paged_decode,
        spec_verify)

    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log("card:", card, "|", kind, "| torch", torch.__version__,
        "cuda", torch.version.cuda)
    log("host:", json.dumps({**host_memory(), **mount_of(REPO)}))

    t_phase = [time.perf_counter()]

    def phase(name: str) -> None:
        now = time.perf_counter()
        log(f"phase {name}: {now - t_phase[0]:.1f} s")
        log("host memory (GB):", json.dumps(host_memory()))
        t_phase[0] = now

    # Phase 1: build through the image's command; every child of this run
    # loads from the same kernel directory.
    os.environ["KGCT_KERNEL_DIR"] = str(build.kernel_dir())
    built = build_kernels(build, card)
    phase("build (1)")

    cfg = get_model_config(MODEL)
    ps = DEFAULT_PAGE_SIZE

    # Phase 2: kernels.
    rows = check_kernels(cfg, ps, cfg.max_model_len, device)
    rows.append(check_int4(cfg, device))
    for r in rows:
        if r["name"] == "spec_verify":
            r["ptxas"] = built["spec_verify_ptxas"]
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
    log("phase 4 tokens/s:", json.dumps({
        "runs": [eng["run1"]["tokens_per_s"], eng["run2_tokens_per_s"]],
        "483ea15": UNGATED_TOKENS_PER_S["4"]}), "|", card)
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

    # Phase 7a: n-gram speculative decoding on the same weights, its
    # captured programs against an enforce_eager twin (16g, first half).
    spec_counters = {**attn, "spec_verify": spec_verify}
    spec7a = check_spec_ngram(cfg_engine, params, device, spec_counters,
                              card)
    log("spec ngram:", json.dumps(spec7a))
    log("phase 7a tokens/s:", json.dumps({
        "spec_runs": [spec7a["tokens_per_s_spec"],
                      spec7a["tokens_per_s_spec_run2"]],
        "off": spec7a["tokens_per_s_off"],
        "483ea15": UNGATED_TOKENS_PER_S["7a"]}), "|", card)
    phase(f"{MODEL} bf16 spec (7a, 16g)")

    # Phase 8: the KV transfer layer on the same weights.
    swap = check_swap(cfg_engine, params, device, attn, SWAP_GB,
                      near_ties_only=False, eager_twin=True)
    swap["link"] = link_bound(device)
    log("swap:", json.dumps(swap), "|", card)
    log("handoff:", json.dumps(with_eager_twin(
        "8b", check_handoff, cfg_engine, params, device, attn)), "|", card)
    log("prefix spill:", json.dumps(with_eager_twin(
        "8c", check_prefix_spill, cfg_engine, params, device, attn)), "|",
        card)
    phase(f"{MODEL} bf16 KV transfer (8)")

    # Phase 10: the fleet plane on the same weights.
    log("fleet:", json.dumps(check_fleet(cfg_engine, params, device, attn)),
        "|", card)
    phase(f"{MODEL} bf16 fleet plane (10)")

    # Phase 11: the router in front of replicas on the same weights.
    log("router:", json.dumps(check_router(cfg_engine, params, device,
                                           attn)), "|", card)
    counters_clear("phase 11")
    gc.collect()
    torch.cuda.empty_cache()
    phase(f"{MODEL} bf16 router (11)")

    # Phase 15: the analysis package on the same weights.
    log("analysis:", json.dumps(check_analysis(cfg_engine, params, device,
                                               attn)), "|", card)
    gc.collect()
    torch.cuda.empty_cache()
    phase(f"{MODEL} bf16 analysis (15)")

    # Phase 16: the decode window's captured graphs on the same weights.
    log("graphs:", json.dumps(check_graphs(cfg_engine, params, device, attn,
                                           card)), "|", card)
    counters_clear("phase 16")
    phase(f"{MODEL} bf16 captured decode windows (16)")
    # Phase 16f: the prefill, solo-chunk and mixed programs.
    log("step programs:", json.dumps(check_step_programs(
        cfg_engine, params, device, card)), "|", card)
    # The phases below start processes that load the model on the host.
    release_host_cache()
    phase(f"{MODEL} bf16 captured prefill and mixed steps (16f)")

    # Phases 12 and 12c: tp 2 as two ranks on this card (gloo), held to
    # the tp=1 tokens of the same weights; then the group abort. 12, 12c
    # and 13b at RANK_LAYERS layers (the module docstring says why).
    cfg_ranks = cfg.replace(num_layers=RANK_LAYERS)
    params_ranks = M.init_params(cfg_ranks, torch.Generator(
        device=device).manual_seed(SEED), device)
    tp, _ = check_tp(cfg_ranks, params_ranks, device, card, [0, 0], "gloo",
                     abort=True)
    log("tp:", json.dumps(tp), "|", card)
    phase(f"{MODEL} bf16 tp 2 at {RANK_LAYERS} layers (12, 12c)")
    # Phase 12e: the server's CLI at tp 2, two --distributed ranks.
    log("cli tp:", json.dumps(check_cli_tp(cfg, params, device, card)), "|",
        card)
    phase(f"{MODEL} bf16 CLI tp 2 (12e)")
    # Phases 13 and 13b: pp 2 and sp 2 as two ranks on this card (gloo),
    # held to the one-device engine with mixed off; 13c the CLI at pp 2.
    log("pp:", json.dumps(check_pp_sp(cfg, params, device, card, "pp")),
        "|", card)
    phase(f"{MODEL} bf16 pp 2 (13)")
    log("sp:", json.dumps(check_pp_sp(cfg_ranks, params_ranks, device, card,
                                      "sp")), "|", card)
    phase(f"{MODEL} bf16 sp 2 at {RANK_LAYERS} layers (13b)")
    del params_ranks
    gc.collect()
    torch.cuda.empty_cache()
    log("cli pp:", json.dumps(check_cli_tp(
        cfg, params, device, card, "--pipeline-parallel-size", "13c")), "|",
        card)
    phase(f"{MODEL} bf16 CLI pp 2 (13c)")
    # 14a holds its streamed tp 2 ranks to the tp=1 run at full depth.
    _, tp_ref = tp1_reference(cfg, params, device, n_req=STREAMED_REQS)
    checkpoint_phases(cfg, params, device, card, tp_ref, phase)
    # Phase 14c: what the runtime image refuses, with no nvcc; phase 18:
    # the node layer. Their children load no weights, so they run beside
    # 12d and 12b.
    beside = concurrent.futures.ThreadPoolExecutor(2)
    image = beside.submit(check_image_refusals, card)
    node = beside.submit(check_node_layer, card)
    try:
        # Phase 12d: the same over NCCL, where two cards exist.
        if torch.cuda.device_count() >= 2:
            log("nccl tp:", json.dumps(check_tp(
                cfg, params, device, card, [0, 1], "nccl", abort=False)[0]))
            phase(f"{MODEL} bf16 nccl tp 2 (12d)")
        else:
            log("nccl tp: not run (1 card)")
        del params
        gc.collect()
        torch.cuda.empty_cache()

        # Phase 12b: expert parallelism, mixtral-8x7b int4 at ep 2.
        log("ep:", json.dumps(check_ep(
            get_model_config("mixtral-8x7b").replace(
                quantization="int4", quant_group_size=GROUP), device, card,
            EP_LAYERS)), "|", card)
        phase("mixtral-8x7b int4 ep 2 (12b)")
    finally:
        beside.shutdown(wait=True)
    log("image refusals:", json.dumps(image.result()))
    log("node layer:", json.dumps(node.result()), "|", card)
    phase("image refusals and node layer (14c and 18, beside 12d and 12b)")

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
    # Phase 16e: the same int4 workload, captured against eager.
    check_graph_int4(cfg_engine4, device, {**attn,
                                           "int4_matmul": int4_matmul}, card)

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
                                                   spec_counters, card)))
    phase("tinyllama-1.1b fp32 draft spec (7b, 16g)")

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

    # Phase 17: the entry twin's decode step, captured and replayed.
    log("entry:", json.dumps(check_entry(device, attn)), "|", card)
    phase("tinyllama-1.1b entry step (17)")

    eng["launches"]["int4_matmul"] = eng4["launches"]["int4_matmul"]
    eng["launches"]["spec_verify"] = spec7a["launches"]["spec_verify"]
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
    if sys.argv[1:2] in (["--tp-child"], ["--cli-rank"], ["--whole-load"],
                         ["--load-kernel"]):
        die_with_parent()
    if sys.argv[1:2] == ["--load-kernel"]:
        load_kernel_child(json.loads(sys.argv[2]))
        sys.exit(0)
    if sys.argv[1:2] == ["--tp-child"]:
        tp_child(json.loads(sys.argv[2]))
        sys.exit(0)
    if sys.argv[1:2] == ["--cli-rank"]:
        cli_rank_child(json.loads(sys.argv[2]))
        sys.exit(0)
    if sys.argv[1:2] == ["--whole-load"]:
        whole_load_child(json.loads(sys.argv[2]))
        sys.exit(0)
    try:
        sys.exit(main())
    finally:
        kill_children()
