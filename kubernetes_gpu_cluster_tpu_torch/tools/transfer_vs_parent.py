"""The KV transfer layer of this tree against an older tree's, on the card.

Run from the repository root on a machine with an H100, with the older
tree unpacked in a directory (``git archive <commit> | tar -x -C DIR``):

    python -m kubernetes_gpu_cluster_tpu_torch.tools.transfer_vs_parent \
        --parent DIR [--order parent,tree,tree,parent]

Builds the kernels once into the kernel directory, then in one child
process per entry of ``--order``, in turns, with that tree's package and
``chip_smoke.py`` on the path (llama-3-8b bf16 weights from the script's
seed):

- the page pool an engine derives at the default configuration (page
  size 16, ``max_model_len`` 8192, 90% of the free memory after the
  weights), with step programs and with ``enforce_eager``;
- phase 8a (``chip_smoke.check_swap``: a 6144-page pool, a 2 GB pinned
  host tier, twelve requests served twice and once never preempted):
  swap GB/s each way;
- the handoff seam alone (``engine.kv_io``) between two engines of
  phase 8b's 1024-page pools: an export and an import of 19, 44, 69 and
  94 pages (8b's handoffs) and of 64 pages (its prefix), and the 64-page
  prefix imported in 16-page slices as 8b streams it, each six times in a
  row: the first call's ms (a transfer key's first use) and the median
  of the five after it.

Prints one JSON line per run, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

# One run, in the tree on sys.path.
CHILD = r'''
import dataclasses, gc, json, statistics, time
import numpy as np
import torch
import chip_smoke as C
from kubernetes_gpu_cluster_tpu_torch.config import (
    CacheConfig, EngineConfig, SchedulerConfig, get_model_config)
from kubernetes_gpu_cluster_tpu_torch.engine import LLMEngine
from kubernetes_gpu_cluster_tpu_torch.models import llama as M
from kubernetes_gpu_cluster_tpu_torch.ops.cuda import (
    flash_prefill, flash_prefill_hist, paged_decode)
REPS = 6
device = torch.device("cuda", 0)
cfg = get_model_config(C.MODEL)
params = M.init_params(cfg, torch.Generator(device=device).manual_seed(
    C.SEED), device)
res = {}
for eager in (False, True):
    eng = LLMEngine(EngineConfig(model=cfg, seed=C.SEED,
                                 enforce_eager=eager),
                    params=params, device=device)
    res["pool_pages_" + ("eager" if eager else "programs")] = \
        eng.scheduler.allocator.num_pages
    del eng
    gc.collect()
    torch.cuda.empty_cache()
cfg_engine = EngineConfig(model=cfg, seed=C.SEED,
                          cache=CacheConfig(page_size=16, num_pages=6144),
                          scheduler=SchedulerConfig(max_num_seqs=32))
attn = {"paged_decode": paged_decode, "flash_prefill": flash_prefill,
        "flash_prefill_hist": flash_prefill_hist}
out = C.check_swap(cfg_engine, params, device, attn, C.SWAP_GB, False)
res.update({k: out[k] for k in ("transfers", "transfers_run2")
            if k in out})
pair = dataclasses.replace(
    cfg_engine, cache=CacheConfig(page_size=16, num_pages=C.HANDOFF_PAGES),
    scheduler=SchedulerConfig(max_num_seqs=8, enable_prefix_caching=True))
a = LLMEngine(pair, params=params, device=device)
b = LLMEngine(pair, params=params, device=device)
rng = np.random.default_rng(C.SEED)


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def summary(ms, nbytes):
    rest = statistics.median(ms[1:])
    return {"first_ms": ms[0], "median_ms": rest,
            "median_gb_s": nbytes / rest / 1e6}


seam = []
for n, slices in ((19, 0), (44, 0), (69, 0), (94, 0), (64, 0), (64, 16)):
    src, dst = (sorted(int(p) for p in rng.choice(
        np.arange(1, C.HANDOFF_PAGES), n, replace=False)) for _ in "ab")
    exp, imp = [], []
    for _ in range(REPS):
        (k, v), ms = timed(lambda: a.kv_io.export_pages(src))
        exp.append(ms)
        if slices:
            def chunks():
                for j in range(0, n, slices):
                    b.kv_io.import_pages(dst[j:j + slices], k[:, j:j + slices],
                                         v[:, j:j + slices])
            imp.append(timed(chunks)[1])
        else:
            imp.append(timed(lambda: b.kv_io.import_pages(dst, k, v))[1])
    nbytes = k.nbytes + v.nbytes
    seam.append({"pages": n, "import_slices": slices or n, "bytes": nbytes,
                 "export": summary(exp, nbytes),
                 "import": summary(imp, nbytes)})
res["seam"] = seam
print("RESULT:" + json.dumps(res), flush=True)
'''


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()


def _run(tree: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=tree, env=env,
                          capture_output=True, text=True, timeout=900)
    line = next((ln for ln in proc.stdout.splitlines()
                 if ln.startswith("RESULT:")), None)
    if proc.returncode != 0 or line is None:
        raise RuntimeError(f"the run in {tree} exited {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    return json.loads(line[len("RESULT:"):])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--order", default="parent,tree,tree,parent")
    args = ap.parse_args(argv)
    from ..ops.cuda import build
    os.environ["KGCT_KERNEL_DIR"] = str(build.kernel_dir().resolve())
    print(json.dumps({"build_s": build.build()}), flush=True)
    card = _card()
    for which in args.order.split(","):
        tree = args.parent.resolve() if which == "parent" else REPO
        print(json.dumps({"tree": which, **_run(tree)}), "|", card,
              flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
