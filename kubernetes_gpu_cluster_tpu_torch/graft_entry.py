"""Entry points of the port, the twin of the JAX package's root
``__graft_entry__.py``: a one-device compile check and a many-rank
sharding dry run.

- ``entry()`` returns one paged decode step on TinyLlama-1.1B, batch 8
  (forward, logits and sampling), built as the JAX ``entry()`` builds its
  jittable step; the port's counterpart of a jit compile is a CUDA graph
  capture, so the step is capturable: it reads nothing on the host and
  updates the pool in place. On a card it first runs the strict kernel
  probes: ``paged_decode`` at the step's shapes and ``flash_prefill`` at T
  128, through the dispatchers, each a kernel launch or an exception.
- ``dryrun_multichip(n)`` runs one serving step under each parallel mode
  of the port on tiny shapes, over ``n`` gloo ranks on the CPU (one
  process each): (a) dp×ep×tp through ``LLMEngine`` on the MoE model,
  (b) pp×tp×dp through the engine, (b2) the pipeline forward itself,
  (b3) paged decode at tp 2 on each rank's heads against the plain
  oracle, (c) the sp engine and ring attention against the plain oracle.

``python -m kubernetes_gpu_cluster_tpu_torch.graft_entry`` runs
``dryrun_multichip(8)``.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# The dry run's ranks: a shared deadline for all of them.
RANK_TIMEOUT_S = 300
_ROOT = Path(__file__).resolve().parent.parent
_MODULE = "kubernetes_gpu_cluster_tpu_torch.graft_entry"


def _factors(n: int, allow_pp: bool) -> dict:
    """Split n ranks over the layout's axes, exercising as many axes as n
    allows."""
    axes = {"dp": 1, "pp": 1, "ep": 1, "tp": 1}
    rem = n
    first = "pp" if allow_pp else "ep"
    if rem % 2 == 0:
        axes[first] = 2
        rem //= 2
    if rem % 2 == 0:
        axes["tp"] = 2
        rem //= 2
    axes["dp"] = rem
    return axes


def entry(model: str = "tinyllama-1.1b", device: torch.device | str = "cuda"):
    """(fn, example_args) of one paged decode step (forward + logits +
    sampling) on ``model``, batch 8: page size 16, 129 pages, 8 pages a
    sequence, every row at position 5 over a context of 6, greedy. Weights
    are random from seed 0. ``fn(*example_args)`` returns (next tokens
    [8] int32, the pool, updated in place)."""
    from .config import CacheConfig, get_model_config
    from .engine.kv_cache import allocate_kv_cache
    from .models import llama as model_lib
    from .ops.attention import (paged_decode_attention,
                                ragged_prefill_attention)
    from .ops.sampling import row_sample_keys, sample_tokens

    device = torch.device(device)
    cfg = get_model_config(model)
    cache = CacheConfig(page_size=16, num_pages=129)
    params = model_lib.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    kv = allocate_kv_cache(cfg, cache, 129, device)

    B, pages_per_seq = 8, 8
    i32 = dict(dtype=torch.int32, device=device)
    meta = model_lib.DecodeMeta(
        positions=torch.full((B,), 5, **i32),
        slot_mapping=torch.arange(B, **i32) * pages_per_seq * 16 + 16 + 5,
        page_tables=1 + torch.arange(B * pages_per_seq, **i32).reshape(
            B, pages_per_seq),
        context_lens=torch.full((B,), 6, **i32))
    tokens = torch.arange(B, **i32) + 7
    key = torch.ones((1,), **i32)           # the step key
    temperature = torch.zeros((B,), dtype=torch.float32, device=device)
    top_k = torch.zeros((B,), **i32)
    top_p = torch.ones((B,), dtype=torch.float32, device=device)

    if device.type == "cuda":
        # Strict kernel probes: each dispatcher launches its kernel on a
        # CUDA tensor or raises; there is no other path to fall back on.
        scale = cfg.head_dim ** -0.5
        qp = torch.zeros((B, cfg.num_heads, cfg.head_dim), dtype=kv.k.dtype,
                         device=device)
        curp = torch.zeros((B, cfg.num_kv_heads, cfg.head_dim),
                           dtype=kv.k.dtype, device=device)
        paged_decode_attention(qp, kv.k, kv.v, meta.page_tables,
                               meta.context_lens, curp, curp, scale, layer=0)
        T = 128
        qf = torch.zeros((T, cfg.num_heads, cfg.head_dim), dtype=kv.k.dtype,
                         device=device)
        kf = torch.zeros((T, cfg.num_kv_heads, cfg.head_dim),
                         dtype=kv.k.dtype, device=device)
        ragged_prefill_attention(qf, kf, kf, torch.zeros((T,), **i32),
                                 torch.arange(T, **i32), scale)
        torch.cuda.synchronize(device)

    def decode_step(params, kv, tokens, meta, key, temperature, top_k, top_p):
        hidden, kv, _ = model_lib.forward_decode(params, cfg, tokens, meta,
                                                 kv)
        logits = model_lib.compute_logits(params, cfg, hidden)
        keys = row_sample_keys(key, torch.full_like(tokens, -1),
                               meta.positions)
        next_tokens = sample_tokens(logits, keys, temperature, top_k, top_p,
                                    any_sampled=True, needs_filter=True)
        return next_tokens, kv

    return decode_step, (params, kv, tokens, meta, key, temperature, top_k,
                         top_p)


# -- the multi-rank dry run ----------------------------------------------------

def _say(groups_rank: int, *a) -> None:
    if groups_rank == 0:
        print(*a, flush=True)


def _dryrun_rank() -> None:
    """One rank of ``dryrun_multichip``: joins the gloo group from the
    ``KGCT_*`` environment and runs every phase; rank 0 prints the
    progress lines."""
    import torch.distributed as dist

    from .config import (CacheConfig, EngineConfig, ParallelConfig,
                         SchedulerConfig, get_model_config)
    from .engine import LLMEngine, SamplingParams
    from .engine.kv_cache import allocate_kv_cache
    from .models import llama as model_lib
    from .ops.attention import (paged_decode_attention,
                                paged_decode_attention_plain,
                                ragged_prefill_attention_plain)
    from .parallel import initialize_distributed, make_mesh
    from .parallel.pp import pipeline_forward
    from .parallel.sharding import local_kv_config, shard_params
    from .parallel.sp import ring_prefill_attention

    torch.set_num_threads(1)
    initialize_distributed(device="cpu", timeout_s=120)
    n = dist.get_world_size()
    rank = dist.get_rank()

    def engine(preset, sizes, decode_buckets):
        cfg = EngineConfig(
            model=get_model_config(preset),
            cache=CacheConfig(page_size=8, num_pages=33),
            scheduler=SchedulerConfig(
                max_num_seqs=4, max_prefill_tokens=64,
                decode_buckets=decode_buckets, prefill_buckets=(32, 64)),
            parallel=ParallelConfig(**sizes))
        return LLMEngine(cfg, device="cpu", groups=make_mesh(**sizes))

    def two_steps(eng, tag, prompts):
        for i, p in enumerate(prompts):
            eng.add_request(f"{tag}-{i}", p, SamplingParams(max_tokens=4))
        assert eng.step() != [], f"{tag}: the prefill step returned nothing"
        assert eng.step() != [], f"{tag}: the decode step returned nothing"

    # -- (a) dp x ep x tp through the full engine (MoE model) --------------
    ax = _factors(n, allow_pp=False)
    sizes = dict(tp=ax["tp"], ep=ax["ep"], dp=ax["dp"])
    _say(rank, f"[dryrun] dp x ep x tp engine step on layout {sizes}")
    two_steps(engine("debug-moe", sizes, (1, 2, 4)), "dry",
              [[1, 2, 3, 4, 5], [6, 7, 8]])
    _say(rank, "[dryrun] dp x ep x tp prefill+decode OK")

    # -- (b) pipeline parallelism through the engine: pp x tp x dp ---------
    ax = _factors(n, allow_pp=True)
    sizes = dict(tp=ax["tp"], pp=ax["pp"], dp=ax["dp"])
    _say(rank, f"[dryrun] PP engine step on layout {sizes}")
    eng = engine("debug-tiny", sizes, (2, 4))
    assert eng.pp_size == ax["pp"]
    two_steps(eng, "pp", [[1, 2, 3, 4, 5], [6, 7, 8]])
    _say(rank, "[dryrun] PP engine prefill+decode OK")

    # -- (b2) the pipeline forward itself -----------------------------------
    _say(rank, f"[dryrun] PP pipeline step on layout {sizes}")
    groups = make_mesh(**sizes)
    mcfg = get_model_config("debug-tiny")
    params = shard_params(model_lib.init_params(
        mcfg, torch.Generator().manual_seed(0), "cpu"), mcfg, groups)
    kv = allocate_kv_cache(local_kv_config(mcfg, groups),
                           CacheConfig(page_size=8, num_pages=17), 17, "cpu")
    M, T = 2, 8
    i32 = torch.int32
    tokens = torch.arange(M * T, dtype=i32) % 64 + 1
    meta = model_lib.PrefillMeta(
        seg_ids=torch.arange(M, dtype=i32).repeat_interleave(T),
        positions=torch.arange(T, dtype=i32).repeat(M),
        slot_mapping=torch.cat([(1 + 2 * m) * 8 + torch.arange(T, dtype=i32)
                                for m in range(M)]),
        logits_indices=torch.tensor([T - 1, 2 * T - 1], dtype=i32))
    hidden, kv, _ = pipeline_forward("prefill", params, mcfg, tokens, meta,
                                     kv, groups)
    logits = model_lib.compute_logits(params, mcfg, hidden, groups=groups)
    assert torch.isfinite(logits).all(), "pp prefill logits not finite"
    dmeta = model_lib.DecodeMeta(
        positions=torch.full((M,), T, dtype=i32),
        slot_mapping=torch.tensor([(2 + 2 * m) * 8 for m in range(M)],
                                  dtype=i32),
        page_tables=torch.tensor([[1 + 2 * m, 2 + 2 * m] for m in range(M)],
                                 dtype=i32),
        context_lens=torch.full((M,), T + 1, dtype=i32))
    hidden, kv, _ = pipeline_forward("decode", params, mcfg,
                                     torch.tensor([9, 11], dtype=i32), dmeta,
                                     kv, groups)
    logits = model_lib.compute_logits(params, mcfg, hidden, groups=groups)
    assert torch.isfinite(logits).all(), "pp decode logits not finite"
    _say(rank, "[dryrun] PP prefill+decode OK")

    # -- (b3) paged decode at tp 2 on each rank's heads ---------------------
    sizes = dict(tp=2, dp=n // 2)
    _say(rank, f"[dryrun] tp-sharded paged decode on layout {sizes}")
    groups = make_mesh(**sizes)
    rng = np.random.default_rng(7)
    B, P, ps, nkv, nh, hd = 2, 5, 8, 2, 4, 32

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    q, pk, pv = rand(B, nh, hd), rand(P, ps, nkv * hd), rand(P, ps, nkv * hd)
    kc, vc = rand(B, nkv, hd), rand(B, nkv, hd)
    pt = torch.tensor([[1, 2], [3, 4]], dtype=i32)
    cl = torch.tensor([ps + 1, 5], dtype=i32)
    h = slice(groups.tp_rank * nh // 2, (groups.tp_rank + 1) * nh // 2)
    g = slice(groups.tp_rank * nkv // 2, (groups.tp_rank + 1) * nkv // 2)
    cols = slice(g.start * hd, g.stop * hd)
    local = paged_decode_attention(q[:, h], pk[..., cols], pv[..., cols], pt,
                                   cl, kc[:, g], vc[:, g], 0.125)
    got = groups.all_gather(local, dim=1)
    ref = paged_decode_attention_plain(q, pk, pv, pt, cl, kc, vc, 0.125)
    assert torch.allclose(got, ref, atol=2e-5), (
        "tp-sharded decode diverged from the oracle")
    _say(rank, "[dryrun] tp-sharded paged decode OK")

    # -- (c) sequence parallelism: the sp engine and ring attention ---------
    sizes = dict(sp=n)
    _say(rank, f"[dryrun] SP engine step on layout {sizes}")
    eng = engine("debug-tiny", sizes, (2, 4))
    assert eng.sp_size == n
    two_steps(eng, "sp", [[1, 2, 3, 4, 5]])
    _say(rank, "[dryrun] SP engine prefill+decode OK")

    _say(rank, f"[dryrun] ring attention on layout {sizes}")
    groups = make_mesh(**sizes)
    T, nh, nkv, hd = 8 * n, 4, 2, 16
    rng = np.random.default_rng(3)
    q, k, v = rand(T, nh, hd), rand(T, nkv, hd), rand(T, nkv, hd)
    seg = torch.where(torch.arange(T) < T - 4, 0, -1).to(i32)
    pos = (torch.arange(T) % (T - 4)).to(i32)
    out = ring_prefill_attention(q, k, v, seg, pos, hd ** -0.5, groups=groups)
    ref = ragged_prefill_attention_plain(q, k, v, seg, pos, hd ** -0.5)
    assert torch.allclose(out, ref, atol=2e-5), (
        "ring attention diverged from the oracle")
    _say(rank, "[dryrun] ring attention (sp) OK")
    _say(rank, f"[dryrun] all multichip paths OK on {n} ranks")
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int) -> None:
    """Run the dry run's phases over ``n_devices`` gloo ranks on the CPU,
    one process each, whatever device the calling process uses. Prints
    rank 0's progress lines; raises on the first rank that failed, with
    the end of its error output."""
    coordinator = f"127.0.0.1:{_free_port()}"
    path = os.pathsep.join([str(_ROOT)] + [
        p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])
    procs = []
    for rank in range(n_devices):
        env = dict(os.environ, KGCT_COORDINATOR=coordinator,
                   KGCT_NUM_PROCESSES=str(n_devices),
                   KGCT_PROCESS_ID=str(rank), GLOO_SOCKET_IFNAME="lo",
                   OMP_NUM_THREADS="1", PYTHONPATH=path)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", _MODULE, "--rank"], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    deadline = time.monotonic() + RANK_TIMEOUT_S
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(
                    timeout=max(deadline - time.monotonic(), 1.0)))
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
                outs.append((out, err + "\n[killed at the deadline]"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    print(outs[0][0], end="", flush=True)
    for rank, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"dry run rank {rank} of {n_devices} failed "
                               f"(rc {p.returncode}):\n{err[-3000:]}")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        _dryrun_rank()
    else:
        dryrun_multichip(8)
