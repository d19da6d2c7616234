"""Split-plan sweep of the paged decode kernel on the card.

Run from the repository root on a machine with an H100:

    python -m kubernetes_gpu_cluster_tpu_torch.tools.decode_sweep

For each plan setting (the fewest keys per split, the most splits per
(sequence, kv head) and the blocks per SM the grid aims at:
``ops/cuda/paged_decode.py`` MIN_SPLIT_TOKENS, MAX_SPLITS and
BLOCKS_PER_SM) it times the bf16 kernel at llama-3-8b heads (nh 32, n_kv
8, hd 128) on the engine's decode table (512 pages of 16): B 32 over
contexts 512-2048, the same with one row at 8191 (one long sequence among
short ones), B 32 over 64-256, B 1 at 8191, B 8 at 8191 and B 32 at
context 0 (every block but split 0 exits: what the grid's empty blocks
cost). Each
time is the device time of calls captured in a CUDA graph; each result is
checked against ``paged_decode_attention_plain`` first. Prints one JSON line
per measurement and the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

from ..ops import attention as A
from ..ops.cuda import paged_decode as pd

NH, N_KV, HD, PS, PPS = 32, 8, 128, 16, 512
# (name, B, contexts drawn from [lo, hi], rows set to 8191)
SHAPES = [("B32_ctx512-2048", 32, 512, 2048, 0),
          ("B32_ctx512-2048_one8191", 32, 512, 2048, 1),
          ("B32_ctx64-256", 32, 64, 256, 0), ("B1_ctx8191", 1, 8191, 8191, 0),
          ("B8_ctx8191", 8, 8191, 8191, 0), ("B32_ctx0", 32, 0, 0, 0)]
# (MIN_SPLIT_TOKENS, MAX_SPLITS, BLOCKS_PER_SM); the first is the
# wrapper's default.
PLANS = [(512, 16, 4), (256, 32, 4), (256, 32, 2), (256, 32, 1),
         (256, 1, 2)]


def _inputs(rng, gen, B, lo, hi, n_long, device):
    ctx = rng.integers(lo, hi + 1, B).astype(np.int32)
    ctx[:n_long] = 8191
    n_pages = [-(-max(int(c) - 1, 0) // PS) for c in ctx]
    P = sum(n_pages) + 1
    perm = rng.permutation(np.arange(1, P)).astype(np.int32)
    tables = np.zeros((B, PPS), np.int32)
    o = 0
    for b, n in enumerate(n_pages):
        tables[b, :n] = perm[o:o + n]
        o += n
    kd = N_KV * HD

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(
            torch.bfloat16)
    return (rn(B, NH, HD), rn(2, P, PS, kd), rn(2, P, PS, kd),
            torch.from_numpy(tables).to(device),
            torch.from_numpy(ctx).to(device), rn(B, N_KV, HD),
            rn(B, N_KV, HD), HD ** -0.5), ctx


def graph_ms(fn, reps: int = 20) -> float:
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
    return e0.elapsed_time(e1) / reps


def main() -> int:
    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=device).manual_seed(0)
    cases = [(name, *_inputs(rng, gen, B, lo, hi, n_long, device))
             for name, B, lo, hi, n_long in SHAPES]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    defaults = pd.MIN_SPLIT_TOKENS, pd.MAX_SPLITS, pd.BLOCKS_PER_SM
    try:
        for setting in PLANS:
            pd.MIN_SPLIT_TOKENS, pd.MAX_SPLITS, pd.BLOCKS_PER_SM = setting
            pd._launch_cache.clear()
            for name, args, ctx in cases:
                got = pd.paged_decode(*args, layer=1)
                ref = A.paged_decode_attention_plain(*args, layer=1)
                err = float((got.float() - ref.float()).abs().max())
                if not err <= 2e-2:
                    raise RuntimeError(f"{name} {setting}: max abs error "
                                       f"{err}")
                nbytes = 2 * 2 * N_KV * HD * int(np.maximum(ctx - 1, 0).sum())
                print(json.dumps({
                    "shape": name, "min_split": setting[0],
                    "max_splits": setting[1], "blocks_per_sm": setting[2],
                    "splits": pd.plan(args[0].shape[0], N_KV, PPS, PS,
                                      sms).splits,
                    "ms": graph_ms(lambda: pd.paged_decode(*args, layer=1)),
                    "kv_bytes": nbytes, "max_abs_err": err}), flush=True)
    finally:
        pd.MIN_SPLIT_TOKENS, pd.MAX_SPLITS, pd.BLOCKS_PER_SM = defaults
        pd._launch_cache.clear()
    print(card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
