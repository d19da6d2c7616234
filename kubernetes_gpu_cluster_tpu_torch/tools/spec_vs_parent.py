"""Phase 7a's n-gram speculation (and phase 4's engine) of this tree
against an older tree's, on the card, with each run's first-use costs
split out.

Run from the repository root on a machine with an H100, with the older
tree unpacked in a directory (``git archive <commit> | tar -x -C DIR``):

    python -m kubernetes_gpu_cluster_tpu_torch.tools.spec_vs_parent \
        --parent DIR [--order parent,tree,tree,parent]

Builds both trees' kernels first, each into its own tree's default kernel
directory (the two trees' sources differ), the two builds at once. Then in
one child process per entry of ``--order``, in turns, with that tree's
package and ``chip_smoke.py`` on the path (llama-3-8b bf16 weights from
the script's seed): phase 7a's spec engine (``chip_smoke.check_spec_ngram``'s
configuration, workload and warm-up), run twice, and then a second engine
of the same configuration in the same process, run twice again. The
second engine's first run has no first use of the process (library loads,
first kernel calls), only its own captures. Then phase 4's engine
(``chip_smoke.check_engine``'s configuration, workload and warm-up), run
twice: its tokens/s as phase 4 reckons them.

For each run: wall seconds and tokens/s as phase 7a reckons them, steps
and step kinds, drafted and accepted tokens, and the steps that captured a
step program: how many, their wall seconds, and the seconds spent in
``StepPrograms._capture`` (the eager warm-up step and the capture) by
family; the other steps' wall seconds. Prints one JSON line per child,
then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BUILD = "kubernetes_gpu_cluster_tpu_torch.ops.cuda.build"

# One child, in the tree on sys.path.
CHILD = r'''
import dataclasses, gc, json, time
import torch
import chip_smoke as C
from kubernetes_gpu_cluster_tpu_torch.config import (
    CacheConfig, EngineConfig, SchedulerConfig, get_model_config)
from kubernetes_gpu_cluster_tpu_torch.engine import LLMEngine
from kubernetes_gpu_cluster_tpu_torch.engine.engine import DEFAULT_PAGE_SIZE
from kubernetes_gpu_cluster_tpu_torch.engine.step_programs import StepPrograms
from kubernetes_gpu_cluster_tpu_torch.models import llama as M
from kubernetes_gpu_cluster_tpu_torch.ops.cuda import (
    flash_prefill, flash_prefill_hist, paged_decode, spec_verify)
device = torch.device("cuda", 0)
cfg = get_model_config(C.MODEL)
params = M.init_params(cfg, torch.Generator(device=device).manual_seed(
    C.SEED), device)
counters = {"paged_decode": paged_decode, "flash_prefill": flash_prefill,
            "flash_prefill_hist": flash_prefill_hist,
            "spec_verify": spec_verify}
spans = []
capture = StepPrograms._capture


def timed_capture(self, key, body, bufs):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        return capture(self, key, body, bufs)
    finally:
        torch.cuda.synchronize()
        spans.append((key[0], time.perf_counter() - t0))


StepPrograms._capture = timed_capture
cfg_engine = EngineConfig(
    model=cfg, seed=C.SEED,
    cache=CacheConfig(page_size=DEFAULT_PAGE_SIZE, num_pages=6144),
    scheduler=SchedulerConfig(max_num_seqs=32))
sc = dataclasses.replace(cfg_engine.scheduler, spec_decode_enabled=True,
                         num_speculative_tokens=4, mixed_batch_enabled=True)
cfg_spec = dataclasses.replace(cfg_engine, scheduler=sc)
reqs = C._with_logprobs(C.spec_workload(cfg.vocab_size))


def run(engine, tag):
    steps, step = [], engine.step

    def timed_step():
        n, t0 = len(spans), time.perf_counter()
        out = step()
        steps.append((time.perf_counter() - t0, spans[n:]))
        return out
    engine.step = timed_step
    try:
        r = C._spec_run(engine, reqs, tag, counters)
    finally:
        engine.step = step
    caught = [s for s in steps if s[1]]
    by_family = {}
    for _, sp in caught:
        for fam, secs in sp:
            by_family[fam] = by_family.get(fam, 0.0) + secs
    return {"wall_s": r["wall_s"], "tokens_per_s": r["tokens_per_s"],
            "steps": r["steps"], "kinds": r["kinds"],
            "drafted": r["drafted"], "accepted": r["accepted"],
            "capture_steps": len(caught),
            "capture_step_s": sum(w for w, _ in caught),
            "capture_s_by_family": by_family,
            "other_step_s": sum(w for w, sp in steps if not sp)}


res = {}
for name in ("engine_1", "engine_2"):
    engine = LLMEngine(cfg_spec, params=params, device=device)
    n = len(spans)
    C.drive(engine, reqs[1:3], "warm", flash_prefill_hist)
    res[name] = {"warm_captures": len(spans) - n,
                 "run_1": run(engine, "a"), "run_2": run(engine, "b")}
    del engine
    gc.collect()
    torch.cuda.empty_cache()
wl = C.workload(cfg.vocab_size)
engine = LLMEngine(cfg_engine, params=params, device=device)
C.drive(engine, wl[1:3], "warm", flash_prefill_hist)
res["phase_4"] = {}
for tag in ("run_1", "run_2"):
    r = C.drive(engine, wl, tag, flash_prefill_hist)
    res["phase_4"][tag] = {"wall_s": r["wall_s"],
                           "tokens_per_s": r["tokens_per_s"],
                           "steps": r["steps"], "kinds": r["kinds"]}
del engine
print("RESULT:" + json.dumps(res), flush=True)
'''


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()


def _env(tree: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree))
    env.pop("KGCT_KERNEL_DIR", None)        # each tree's own build/kernels
    return env


def _build(trees: list[Path]) -> None:
    """Both trees' build commands at once; raises if either failed."""
    procs = [subprocess.Popen([sys.executable, "-m", BUILD], cwd=t,
                              env=_env(t), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for t in trees]
    for tree, proc in zip(trees, procs):
        out = proc.communicate(timeout=900)[0]
        if proc.returncode != 0:
            raise RuntimeError(f"the build in {tree} exited "
                               f"{proc.returncode}:\n{out[-4000:]}")
        print(json.dumps({"built": str(tree), "log_tail": out[-300:]}),
              flush=True)


def _run(tree: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=tree,
                          env=_env(tree), capture_output=True, text=True,
                          timeout=900)
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
    trees = {"parent": args.parent.resolve(), "tree": REPO}
    order = args.order.split(",")
    if not set(order) <= set(trees):
        ap.error(f"--order takes parent and tree, not {args.order}")
    _build([trees[w] for w in dict.fromkeys(order)])
    card = _card()
    for which in order:
        print(json.dumps({"tree": which, **_run(trees[which])}), "|", card,
              flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
