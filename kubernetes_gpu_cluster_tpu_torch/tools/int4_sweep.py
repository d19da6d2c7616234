"""Tuning sweep and ablations of the int4 matmul kernel on the card.

Run from the repository root on a machine with an H100:

    python -m kubernetes_gpu_cluster_tpu_torch.tools.int4_sweep [--quick]
    python -m kubernetes_gpu_cluster_tpu_torch.tools.int4_sweep --ablate

The sweep builds ``csrc/int4_matmul.cu`` once per variant (``-D`` overrides
of ``KGCT_INT4_DECODE_STAGES``, ``KGCT_INT4_DECODE_WARPS``,
``KGCT_INT4_DECODE_MIN_BLOCKS`` and ``KGCT_INT4_PREFILL_STAGES``, all nvcc
runs started together) and, for each build and each grid the decode plan
could take (every count of blocks per SM up to what the occupancy API
allows, and every count of whole-tile slices that fits), times the kernel at
llama-3-8b projection shapes: device time of calls captured in a CUDA graph,
each call on another weight so none finds its weight in L2, beside cuBLAS on
the same x and the bf16 dequantized weight timed the same way. Each result
is checked against ``int4_matmul_plain`` first.

``--ablate`` builds the prefill tile with one part cut out of the source at
a time (its products, its decoding, its fold) and times each at
the prefill shapes, to show which part bounds the tile. Those builds compute
wrong results by design and are not checked.

Prints one JSON line per measurement and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import itertools
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import quant as Q
from ..ops.cuda import build
from ..ops.cuda import int4_matmul as C4

L2_BYTES = 50 * 2 ** 20
GS = 128
# (name, T, K, N): llama-3-8b projections at decode batches and prefills.
SHAPES = [("w_gate", 32, 4096, 14336), ("w_gate", 1, 4096, 14336),
          ("w_gate", 16, 4096, 14336), ("w_gate", 64, 4096, 14336),
          ("w_down", 32, 14336, 4096), ("lm_head", 32, 4096, 128256),
          ("qkv", 32, 4096, 6144), ("w_gate", 2048, 4096, 14336),
          ("w_gate", 512, 4096, 14336), ("w_down", 2048, 14336, 4096)]
DEFAULT = "d3w4b1p4"
# name: -D overrides (decode stages, decode warps, decode min blocks per
# SM, prefill stages).
VARIANTS = {
    name: {"KGCT_INT4_DECODE_STAGES": d, "KGCT_INT4_DECODE_WARPS": w,
           "KGCT_INT4_DECODE_MIN_BLOCKS": b, "KGCT_INT4_PREFILL_STAGES": p}
    for name, (d, w, b, p) in {
        DEFAULT: (3, 4, 1, 4), "d4w4b2p4": (4, 4, 2, 4),
        "d3w4b3p4": (3, 4, 3, 4), "d3w8b1p4": (3, 8, 1, 4),
        "d3w4b1p3": (3, 4, 1, 3)}.items()}
_DECODE_CALL = "      prefill_decode(smem + (jj % kPStages) * PStage::kBytes, t);\n"
_PRODUCT = ("wgmma_64x128(part, desc_a(xs + 32 * s), desc_b(bs + 2 * s * kAtom), "
            "s > 0 || !start);")
_FOLD = "          fold(acc, part, ss + (g - g_stage) * kPBN);\n"
# name: (text cut from the prefill tile's source, replacement)
ABLATIONS = {
    "whole": [],
    "no_products": [(_PRODUCT, "")],
    "no_decode": [(_DECODE_CALL, "")],
    "no_fold": [(_FOLD, "")],
}


def _build(tag: str, defines: dict, cuts=()) -> tuple[Path, list[str]]:
    """The library path and nvcc command of one build; ``cuts`` are applied
    to a copy of the source."""
    out = build.BUILD_DIR / "sweep" / tag
    out.mkdir(parents=True, exist_ok=True)
    src = build.CSRC / "int4_matmul.cu"
    if cuts:
        text = src.read_text()
        for old, new in cuts:
            if old not in text:
                raise RuntimeError(f"ablation {tag}: source text not found")
            text = text.replace(old, new)
        src = out / "int4_matmul.cu"
        src.write_text(text)
    return out / "libint4_matmul.so", [
        build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
        *(f"-D{k}={v}" for k, v in defines.items()),
        "-o", str(out / "libint4_matmul.so"), str(src)]


def _build_all(jobs: dict) -> dict:
    procs = {tag: subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True)
             for tag, (_, cmd) in jobs.items()}
    libs = {}
    for tag, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {tag}:\n{out}")
        regs = [ln.split(":")[-1].strip() for ln in out.splitlines()
                if "registers" in ln or ("spill" in ln and " 0 bytes spill" not in ln)]
        print(json.dumps({"build": tag, "ptxas": regs}), flush=True)
        libs[tag] = ctypes.CDLL(str(jobs[tag][0]))
    return libs


def graph_ms(fn, reps: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    g.replay()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def _operands(gen, T, K, N, dev):
    x = torch.randn(T, K, generator=gen, device=dev).to(torch.bfloat16)
    n = 1 + -(-2 * L2_BYTES // (K * N // 2 + 4 * (K // GS) * N))
    ws = [(torch.randint(-128, 128, (K // 2, N), generator=gen, device=dev,
                         dtype=torch.int8),
           torch.rand(K // GS, N, generator=gen, device=dev) * K ** -0.5 / 7)
          for _ in range(n)]
    return x, ws


def _use(lib: ctypes.CDLL, resident: int | None,
         splits: int | None = None) -> None:
    """Route the wrapper to ``lib``, at ``resident`` blocks per SM (None:
    what the occupancy API gives), or, with ``splits``, a decode grid of
    exactly that many blocks per output tile."""
    fn = lib.kgct_int4_matmul
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(C4.LaunchArgs),
                                           ctypes.c_bool, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.kgct_int4_matmul_resident.argtypes = [ctypes.c_int] * 3
    lib.kgct_int4_matmul_resident.restype = ctypes.c_int
    lib.kgct_int4_matmul_tile_cols.argtypes = [ctypes.c_int]
    lib.kgct_int4_matmul_tile_cols.restype = ctypes.c_int
    C4._lib = lambda: lib
    C4._launch_cache.clear()
    C4._scratch.clear()
    max_r = lib.kgct_int4_matmul_resident
    cols = lib.kgct_int4_matmul_tile_cols(C4.DECODE)

    @functools.lru_cache(maxsize=None)
    def plan_for(T, K, N, gs, x_dtype, device):
        kind, mt = C4.tile_shape(T, x_dtype == 1)
        r = max_r(x_dtype, kind, mt)
        p = C4.plan(T, K, N, gs, C4._sm_count(device),
                    r if resident is None else min(resident, r),
                    x_dtype == 1, cols)
        if splits is not None:
            p = p._replace(blocks=min(p.tiles * splits, p.tiles * p.groups))
        return p
    C4._plan_for = plan_for


def _cublas_ms(x, ws, K, N) -> float:
    n16 = 1 + -(-2 * L2_BYTES // (2 * K * N))
    dense = [(Q.unpack_int4(w).float().reshape(-1, GS, N) * s[:, None])
             .reshape(K, N).to(torch.bfloat16)
             for w, s in itertools.islice(itertools.cycle(ws), n16)]
    it16 = itertools.cycle(dense)
    return graph_ms(lambda: torch.matmul(x, next(it16)), 20)


def sweep(libs: dict, shapes, dev) -> None:
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, T, K, N in shapes:
        x, ws = _operands(gen, T, K, N, dev)
        ref = Q.int4_matmul_plain(x, *ws[0])
        lib_ms = _cublas_ms(x, ws, K, N)
        for tag, lib in libs.items():
            _use(lib, None)
            kind, mt = C4.tile_shape(T, True)
            top = lib.kgct_int4_matmul_resident(1, kind, mt)
            tiles = C4._plan_for(T, K, N, GS, 1, dev).tiles
            n_sm = C4._sm_count(dev)
            runs = [(r, None) for r in range(1, top + 1)]
            if kind == C4.DECODE:
                runs += [(None, sp) for sp in range(1, top * n_sm // tiles + 1)]
            for r, sp in runs:
                _use(lib, r, sp)
                got = C4.int4_matmul(x, *ws[0])
                err = float((got - ref).abs().max())
                if err > 1e-5 * float(ref.abs().max()):
                    raise RuntimeError(f"{tag} {name} T={T} r={r}: error {err}")
                it4 = itertools.cycle(ws)
                ms = graph_ms(lambda: C4.int4_matmul(x, *next(it4)), 20)
                p = C4._plan_for(T, K, N, GS, 1, dev)
                print(json.dumps({"build": tag, "shape": name, "T": T, "K": K,
                                  "N": N, "per_sm": r, "splits": sp,
                                  "blocks": p.blocks, "ms": ms,
                                  "cublas_ms": lib_ms}), flush=True)
        del x, ws, ref
        torch.cuda.empty_cache()


def ablate(libs: dict, shapes, dev) -> None:
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, T, K, N in shapes:
        x, ws = _operands(gen, T, K, N, dev)
        for tag, lib in libs.items():
            _use(lib, None)
            it4 = itertools.cycle(ws)
            print(json.dumps({"ablation": tag, "shape": name, "T": T, "K": K,
                              "N": N, "ms": graph_ms(
                                  lambda: C4.int4_matmul(x, *next(it4)), 10)}),
                  flush=True)
        del x, ws
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="the default build only, w_gate/w_down/prefill")
    ap.add_argument("--ablate", action="store_true",
                    help="the prefill tile with parts cut out, instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("int4_sweep: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    if args.ablate:
        libs = _build_all({f"ablate_{tag}": _build(f"ablate_{tag}", {}, cuts)
                           for tag, cuts in ABLATIONS.items()})
        ablate(libs, [s for s in SHAPES if s[1] > C4.DECODE_ROWS], dev)
    else:
        variants = {DEFAULT: VARIANTS[DEFAULT]} if args.quick else VARIANTS
        shapes = SHAPES
        if args.quick:
            shapes = [s for s in shapes if s[0] != "lm_head" and s[1] in (32, 2048)]
        libs = _build_all({tag: _build(tag, d) for tag, d in variants.items()})
        sweep(libs, shapes, dev)
    print(card)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    sys.exit(main())
