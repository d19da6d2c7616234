"""Phases 12, 12c, 12e and 12b (or 13, 13b and 13c) of ``chip_smoke.py``
alone, on the card.

Run from the repository root on a machine with an H100:

    python -m kubernetes_gpu_cluster_tpu_torch.tools.tp_phases \
        [--diagnose-12b] [--pp] [--sp]

Builds the kernels, draws llama-3-8b's bf16 weights from the script's seed
and runs its ``check_tp`` (12 and 12c: tp 2 as two ranks on card 0 over
gloo), ``check_cli_tp`` (12e: the server's CLI as two ``--distributed``
ranks) and then ``check_ep`` (12b: mixtral-8x7b int4 at ep 2), in minutes
instead of the whole script's. ``--pp`` runs ``check_pp_sp`` at pp 2 (13)
and the CLI at pp 2 (13c) instead, ``--sp`` ``check_pp_sp`` at sp 2
(13b); both flags run all three. ``--diagnose-12b`` first serves 12b's
requests on one device and teacher forces each request's tokens on the
same weights twice, through the int4 kernel and through its plain
version, printing the three widest gaps (over the logits' deviation) of
each. Prints one JSON line per phase and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

import torch


def _diagnose_12b(C, device) -> None:
    from ..config import (CacheConfig, EngineConfig, SchedulerConfig,
                          get_model_config)
    from ..engine import LLMEngine
    from ..models import llama as M
    from ..ops import quant as Q
    from ..ops.cuda import flash_prefill_hist
    cfg = get_model_config("mixtral-8x7b").replace(
        quantization="int4", quant_group_size=C.GROUP)
    reqs = C.tp_requests(cfg.vocab_size, n_req=C.EP_REQS - 1, long_len=1400)
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(
        C.SEED), device)
    engine = LLMEngine(EngineConfig(
        model=cfg, seed=C.SEED,
        cache=CacheConfig(page_size=16, num_pages=C.TP_PAGES // 2),
        scheduler=SchedulerConfig(max_num_seqs=C.TP_SEQS)), params=params,
        device=device)
    ref = C.drive(engine, reqs, "ep1", flash_prefill_hist)
    del engine
    kernel = Q.int4_matmul
    for _, rid, prompt, _ in reqs:
        toks = ref["tokens"][rid]
        gaps = {"kernel": C._forced_gaps(params, cfg, prompt, toks, device)}
        Q.int4_matmul = Q.int4_matmul_plain
        try:
            gaps["plain"] = C._forced_gaps(params, cfg, prompt, toks, device)
        finally:
            Q.int4_matmul = kernel
        print(json.dumps({"diagnose_12b": rid, "prompt": len(prompt),
                          "tokens": len(toks), **{
                              k: sorted(((g, i) for i, g in enumerate(v)),
                                        reverse=True)[:3]
                              for k, v in gaps.items()}}), flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--diagnose-12b", action="store_true")
    p.add_argument("--pp", action="store_true",
                   help="phases 13 and 13c (pp 2) instead of 12-12b")
    p.add_argument("--sp", action="store_true",
                   help="phase 13b (sp 2) instead of 12-12b")
    args = p.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import chip_smoke as C

    from ..config import get_model_config
    from ..models import llama as M
    from ..ops.cuda import build
    device = torch.device("cuda", 0)
    build.build()
    card = C.card_line()
    if args.diagnose_12b:
        _diagnose_12b(C, device)
    cfg = get_model_config(C.MODEL)
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(
        C.SEED), device)
    if args.pp or args.sp:
        if args.pp:
            print("pp:", json.dumps(C.check_pp_sp(cfg, params, device, card,
                                                  "pp")), flush=True)
        if args.sp:
            print("sp:", json.dumps(C.check_pp_sp(cfg, params, device, card,
                                                  "sp")), flush=True)
        if args.pp:
            print("cli pp:", json.dumps(C.check_cli_tp(
                cfg, params, device, card, "--pipeline-parallel-size",
                "13c")), flush=True)
        print(card)
        return
    print("tp:", json.dumps(C.check_tp(cfg, params, device, card, [0, 0],
                                       "gloo", abort=True)), flush=True)
    print("cli tp:", json.dumps(C.check_cli_tp(cfg, params, device, card)),
          flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print("ep:", json.dumps(C.check_ep(get_model_config(
        "mixtral-8x7b").replace(quantization="int4",
                                quant_group_size=C.GROUP),
        device, card, C.EP_LAYERS)), flush=True)
    print(card)


if __name__ == "__main__":
    main()
