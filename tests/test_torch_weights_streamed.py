"""The port's shard-aware streamed load (``engine/weights.py``
``_load_streamed``) against whole-then-slice and the JAX package's streamed
load, on the CPU: ``tests/test_weights_streamed.py`` re-pointed at the port.

- Bit for bit equal to whole-then-slice (the whole load on the CPU, then
  ``shard_params``) on every rank of tp 2, pp 2 and pp 2 x tp 2 in bf16,
  fp32 and int8, int4 (gs 32) at pp 2 x tp 2, a Mixtral at ep 2 x tp 2
  unquantized, int8 and int4, the straddling 12 q / 6 kv heads at tp 4
  (one column run per kv head), and a checkpoint split over many files.
  These loads run every rank in this process through a layout without
  process groups (``make_mesh(..., rank=r)``): the load reads only the
  rank's coordinates.
- Each rank reads only its own bytes: an fp32 rank at tp 2 and pp 2 reads
  exactly the bytes of the tensors it keeps.
- Every rank's tensors equal the JAX streamed load's addressable shard at
  the same mesh position (``load_weights(path, cfg, shardings=...)`` on
  the conftest's CPU devices) wherever the two layouts agree.
- Two gloo ranks, each in its own process: at pp 2 a rank's host peak over
  the streamed load (``HostPeak``: growth of the resident set) is under
  0.7 x the model's bytes, the whole-then-slice path in the same rank at
  1.0 x or more; then port engines on streamed weights at tp 2 and pp 2
  give the greedy tokens of the JAX engines on the JAX streamed load, on
  the same meshes.
- The llama-3-70b load plan at pp 8 x tp 8 with the port's rules: a host of
  eight ranks stays far under 40 GB of host memory.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest
import torch

from kubernetes_gpu_cluster_tpu.config import CacheConfig as JCache
from kubernetes_gpu_cluster_tpu.config import EngineConfig as JEngineConfig
from kubernetes_gpu_cluster_tpu.config import SchedulerConfig as JSched
from kubernetes_gpu_cluster_tpu.engine import LLMEngine as JaxEngine
from kubernetes_gpu_cluster_tpu.engine import SamplingParams as JaxParams
from kubernetes_gpu_cluster_tpu.engine import weights as JW
from kubernetes_gpu_cluster_tpu.engine.engine import resolve_shardings
from kubernetes_gpu_cluster_tpu.parallel import make_mesh as jax_mesh
from kubernetes_gpu_cluster_tpu_torch.config import get_model_config
from kubernetes_gpu_cluster_tpu_torch.engine import weights as TW
from kubernetes_gpu_cluster_tpu_torch.models import llama as TM
from kubernetes_gpu_cluster_tpu_torch.parallel import make_mesh
from kubernetes_gpu_cluster_tpu_torch.parallel.sharding import (
    local_ranges, local_shape, rules_fn, shard_params)
from test_torch_parallel import finish_ranks, result_of, start_ranks

torch.set_num_threads(2)

GS = 32              # int4 group: divides the tiny dims and tp-2 row halves
CACHE = dict(page_size=8, num_pages=64)
SCHED = dict(max_num_seqs=4, max_prefill_tokens=64, decode_buckets=(1, 2, 4),
             prefill_buckets=(32, 64), decode_window=4)
PROMPTS = [[3, 17, 9, 44, 2, 7], [5] * 11, [1, 2, 3, 4, 5, 6, 7, 8, 9, 10]]
MAX_TOKENS = 10


def _save(model, path, **kw) -> str:
    model.save_pretrained(path, safe_serialization=True, **kw)
    return str(path)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """name -> a checkpoint dir that ``transformers`` saved here."""
    from transformers import (LlamaConfig, LlamaForCausalLM, MixtralConfig,
                              MixtralForCausalLM)
    root = tmp_path_factory.mktemp("streamed")
    small = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                 num_hidden_layers=2, num_attention_heads=4,
                 num_key_value_heads=2, max_position_embeddings=256)
    torch.manual_seed(0)
    dense = LlamaForCausalLM(LlamaConfig(**small)).eval()
    torch.manual_seed(1)
    moe = MixtralForCausalLM(MixtralConfig(
        **small, num_local_experts=4, num_experts_per_tok=2)).eval()
    torch.manual_seed(2)
    straddle = LlamaForCausalLM(LlamaConfig(**dict(
        small, hidden_size=96, num_attention_heads=12,
        num_key_value_heads=6, head_dim=8))).eval()
    torch.manual_seed(3)
    big = LlamaForCausalLM(LlamaConfig(
        vocab_size=512, hidden_size=256, intermediate_size=1024,
        num_hidden_layers=16, num_attention_heads=4, num_key_value_heads=4,
        max_position_embeddings=256)).eval()
    out = {"dense": _save(dense, root / "dense"),
           "moe": _save(moe, root / "moe"),
           "straddle": _save(straddle, root / "straddle"),
           "multi": _save(dense, root / "multi", max_shard_size="40KB"),
           "big": _save(big, root / "big", max_shard_size="5MB")}
    for name in ("multi", "big"):
        assert len([f for f in os.listdir(out[name])
                    if f.endswith(".safetensors")]) > 1, name
    return out


def _world(mesh: dict) -> int:
    return int(np.prod(list(mesh.values())))


def _assert_streamed_is_the_slice(path, cfg, mesh: dict) -> None:
    full = TW.load_weights(path, cfg, device="cpu")
    for rank in range(_world(mesh)):
        groups = make_mesh(**mesh, rank=rank)
        got = TW.load_weights(path, cfg, device="cpu", groups=groups)
        want = shard_params(full, cfg, groups)
        assert set(got) == set(want)
        assert set(got["layers"]) == set(want["layers"])
        for key in want["layers"]:
            assert torch.equal(got["layers"][key], want["layers"][key]), \
                (rank, key)
        for key in (k for k in want if k != "layers"):
            assert torch.equal(got[key], want[key]), (rank, key)


MESHES = {"tp2": dict(tp=2), "pp2": dict(pp=2), "pp2tp2": dict(pp=2, tp=2)}


@pytest.mark.parametrize("kind", ["bfloat16", "float32", "int8"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_streamed_matches_whole_then_slice(ckpts, mesh, kind):
    quant = kind if kind == "int8" else None
    cfg = TW.config_from_hf(ckpts["dense"]).replace(
        dtype="float32" if quant else kind, quantization=quant)
    _assert_streamed_is_the_slice(ckpts["dense"], cfg, MESHES[mesh])


def test_streamed_int4_pp2_tp2(ckpts):
    """pp x tp covers the layer split, the column-split scales and the
    group-aligned row-split quantization in one load."""
    cfg = TW.config_from_hf(ckpts["dense"]).replace(
        dtype="float32", quantization="int4", quant_group_size=GS)
    _assert_streamed_is_the_slice(ckpts["dense"], cfg, MESHES["pp2tp2"])


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_streamed_moe_ep2_tp2(ckpts, quant):
    cfg = TW.config_from_hf(ckpts["moe"]).replace(
        dtype="float32", quantization=quant, quant_group_size=GS)
    _assert_streamed_is_the_slice(ckpts["moe"], cfg, dict(ep=2, tp=2))


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_streamed_straddling_kv_heads_tp4(ckpts, quant):
    """12 q / 6 kv heads at tp 4: a rank's 3 q heads read kv heads
    (j, j, j+1) or (j, j+1, j+1); it reads one run of columns per kv head
    and keeps one kv head per local q head."""
    # int4 rows of wo at tp 4: 96 / 4 = 24, three groups of 8.
    cfg = TW.config_from_hf(ckpts["straddle"]).replace(
        dtype="float32", quantization=quant, quant_group_size=8)
    groups = make_mesh(tp=4, rank=0)
    rules = rules_fn(cfg, groups)
    shape = TM.param_layouts(cfg)[0]["wk"][0]
    cols = local_ranges(shape, rules("wk", False), cfg, groups)[-1]
    hd = cfg.head_dim
    assert cols == ((0, hd), (0, 2 * hd)), cols
    _assert_streamed_is_the_slice(ckpts["straddle"], cfg, dict(tp=4))


def test_streamed_multifile_checkpoint(ckpts):
    cfg = TW.config_from_hf(ckpts["multi"]).replace(dtype="float32")
    _assert_streamed_is_the_slice(ckpts["multi"], cfg, dict(tp=2))


@pytest.mark.parametrize("mesh", ["tp2", "pp2"])
def test_rank_reads_only_its_bytes(ckpts, mesh, monkeypatch):
    """An fp32 rank reads exactly the bytes of the fp32 tensors it keeps:
    no byte of another rank's slice leaves the file."""
    read = [0]
    fill = TW._Checkpoint._fill

    def counted(fd, buf, offset):
        read[0] += len(buf)
        return fill(fd, buf, offset)
    monkeypatch.setattr(TW._Checkpoint, "_fill", staticmethod(counted))
    cfg = TW.config_from_hf(ckpts["dense"]).replace(dtype="float32")
    for rank in range(2):
        read[0] = 0
        got = TW.load_weights(ckpts["dense"], cfg, device="cpu",
                              groups=make_mesh(**MESHES[mesh], rank=rank))
        header_bytes = read[0] - TW._nbytes(got)
        files = [f for f in os.listdir(ckpts["dense"])
                 if f.endswith(".safetensors")]
        # Besides the tensors: each file's 8-byte length and JSON header.
        with open(os.path.join(ckpts["dense"], files[0]), "rb") as f:
            n = int.from_bytes(f.read(8), "little")
        assert header_bytes == 8 + n, (rank, read[0], TW._nbytes(got))


# -- against the JAX streamed load ----------------------------------------------

JAX_CASES = {"tp2-int8": ("dense", dict(tp=2), "int8"),
             "pp2": ("dense", dict(pp=2), None),
             "ep2tp2-int4": ("moe", dict(ep=2, tp=2), "int4")}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_streamed_equals_the_jax_streamed_shards(ckpts, case):
    """Each rank's tensor is the JAX streamed load's shard on the device
    at the same mesh position, for every key whose layouts agree (the
    same local shape); every matmul weight is among them."""
    name, mesh, quant = JAX_CASES[case]
    path = ckpts[name]
    over = dict(dtype="float32", quantization=quant, quant_group_size=GS)
    jcfg = JW.config_from_hf(path).replace(**over)
    tcfg = TW.config_from_hf(path).replace(**over)
    jmesh = jax_mesh(**mesh)
    shardings, _ = resolve_shardings(jmesh, jcfg)
    jparams = JW.load_weights(path, jcfg, shardings=shardings)
    for rank, dev in enumerate(jmesh.devices.flat):
        got = TW.load_weights(path, tcfg, device="cpu",
                              groups=make_mesh(**mesh, rank=rank))
        compared = set()
        for store, jstore in ((got["layers"], jparams["layers"]),
                              (got, jparams)):
            for key, t in store.items():
                if key == "layers":
                    continue
                shard = next(s for s in jstore[key].addressable_shards
                             if s.device == dev)
                ref = np.asarray(shard.data)
                if ref.shape != tuple(t.shape):
                    continue
                np.testing.assert_array_equal(t.numpy(), ref,
                                              err_msg=f"{rank} {key}")
                compared.add(key)
        assert {"wq", "wk", "wv", "wo", "w_up", "w_down"} <= compared, \
            (rank, sorted(compared))


# -- two gloo ranks -------------------------------------------------------------

RANK_WORKER = r'''
import gc, json, os, sys
import torch
torch.set_num_threads(1)
sys.path.insert(0, os.environ["KGCT_REPO"])
from kubernetes_gpu_cluster_tpu_torch.parallel import (initialize_distributed,
                                                       make_mesh)
initialize_distributed(device="cpu", timeout_s=120)
import torch.distributed as dist
from kubernetes_gpu_cluster_tpu_torch.config import (
    CacheConfig, EngineConfig, ParallelConfig, SchedulerConfig)
from kubernetes_gpu_cluster_tpu_torch.engine import LLMEngine, SamplingParams
from kubernetes_gpu_cluster_tpu_torch.engine import weights as TW
from kubernetes_gpu_cluster_tpu_torch.parallel.sharding import shard_params


def peak(load):
    """(host peak over ``load()`` in bytes, what it returned)."""
    gc.collect()
    with TW.HostPeak() as hp:
        out = load()
    return hp.peak, out


out = {}
for job in json.load(open(os.environ["KGCT_TEST_JOBS"])):
    groups = make_mesh(**job["sizes"])
    cfg = TW.config_from_hf(job["path"]).replace(dtype="float32")
    streamed, params = peak(lambda: TW.load_weights(
        job["path"], cfg, device="cpu", groups=groups))
    res = {"streamed_peak": streamed, "local": TW._nbytes(params)}
    if job.get("whole"):
        del params
        res["whole_peak"], params = peak(lambda: shard_params(
            TW.load_weights(job["path"], cfg, device="cpu"), cfg, groups))
    if job.get("prompts"):
        eng = LLMEngine(EngineConfig(
            model=cfg, cache=CacheConfig(**job["cache"]),
            scheduler=SchedulerConfig(**job["sched"]),
            parallel=ParallelConfig(**job["sizes"], lockstep_check=True)),
            params=params, device="cpu", groups=groups)
        outs = eng.generate(job["prompts"], SamplingParams(
            max_tokens=job["max_tokens"], temperature=0.0))
        res["tokens"] = [o.output_token_ids for o in outs]
        del eng
    del params
    out[job["name"]] = res
print("RESULT:" + json.dumps(out), flush=True)
dist.destroy_process_group()
'''


def _model_bytes(cfg) -> int:
    """The unsharded model's bytes in the layout the engine keeps."""
    size = {"float": cfg.torch_dtype.itemsize, "int8": 1, "scale": 4}
    layers, top = TM.param_layouts(cfg)
    return sum(int(np.prod(shape)) * size[kind]
               for shape, kind in [*layers.values(), *top.values()])


def _jax_tokens(path, mesh: dict) -> list:
    cfg = JW.config_from_hf(path).replace(dtype="float32")
    jm = jax_mesh(**mesh)
    shardings, _ = resolve_shardings(jm, cfg)
    eng = JaxEngine(JEngineConfig(model=cfg, cache=JCache(**CACHE),
                                  scheduler=JSched(**SCHED)),
                    params=JW.load_weights(path, cfg, shardings=shardings),
                    mesh=jm)
    return [o.output_token_ids for o in eng.generate(
        PROMPTS, JaxParams(max_tokens=MAX_TOKENS, temperature=0.0))]


@pytest.mark.skipif(sys.platform != "linux", reason="localhost gloo test")
def test_two_process_streamed_load_peak_and_engines(ckpts, tmp_path):
    """Two gloo ranks. The first job in each fresh process: pp 2 on an
    16-layer model in 5 MB files, streamed peak < 0.7 x the model's bytes
    and whole-then-slice >= 1.0 x. Then engines on streamed weights at tp 2
    and pp 2 serve the JAX engines' greedy tokens."""
    jobs = [{"name": "peak", "path": ckpts["big"], "sizes": {"pp": 2},
             "whole": True}]
    for mesh in ("tp2", "pp2"):
        jobs.append({"name": mesh, "path": ckpts["dense"],
                     "sizes": MESHES[mesh], "prompts": PROMPTS,
                     "max_tokens": MAX_TOKENS, "cache": CACHE,
                     "sched": SCHED})
    (tmp_path / "jobs.json").write_text(json.dumps(jobs))
    script = tmp_path / "rank.py"
    script.write_text(RANK_WORKER)
    procs = start_ranks(script, 2, KGCT_TEST_JOBS=str(tmp_path / "jobs.json"))
    want = {mesh: _jax_tokens(ckpts["dense"], MESHES[mesh])
            for mesh in ("tp2", "pp2")}
    results = [result_of(o) for o in finish_ranks(procs)]
    model = _model_bytes(TW.config_from_hf(ckpts["big"]).replace(
        dtype="float32"))
    for rank, res in enumerate(results):
        peak = res["peak"]
        assert peak["local"] < 0.75 * model, (rank, peak, model)
        assert peak["streamed_peak"] < 0.7 * model, (rank, peak, model)
        assert peak["whole_peak"] >= 1.0 * model, (rank, peak, model)
        print(f"rank {rank}: streamed peak {peak['streamed_peak']}, whole "
              f"{peak['whole_peak']}, model {model} bytes")
        for mesh in ("tp2", "pp2"):
            assert res[mesh]["tokens"] == want[mesh], (rank, mesh)


# -- the 70B plan -------------------------------------------------------------------

def load_plan(cfg, sizes: dict, ranks_per_host: int) -> dict:
    """Host and card bytes of one rank's streamed load at ``sizes`` under
    the port's rules (rank 0's slices; every rank's are the same size):
    the card keeps its local tensors, the host at most the largest block
    a load holds at once (one layer's part of a layer tensor, or a whole
    top-level tensor and its transposed copy), in the checkpoint's bf16,
    or its fp32 copy where int8 quantizes. A host runs ``ranks_per_host``
    ranks at once."""
    groups = make_mesh(**sizes, rank=0)
    rules = rules_fn(cfg, groups)
    size = {"float": 2, "int8": 1, "scale": 4}
    card, block = 0, 0
    layers, top = TM.param_layouts(cfg)
    for params, is_top in ((layers, False), (top, True)):
        for name, (shape, kind) in params.items():
            local = local_shape(shape, rules(name, is_top), cfg, groups)
            n = int(np.prod(local))
            card += n * size[kind]
            per_block = n if is_top else n // local[0]
            held = per_block * (2 if is_top else 1) * (
                4 if kind == "int8" and cfg.quantization == "int8" else 2)
            block = max(block, held)
    return {"card_bytes": card, "host_bytes": block * ranks_per_host}


def test_70b_load_plan_under_40gb():
    """llama-3-70b at pp 8 x tp 8, one pod (a host of eight cards) per
    stage: each rank's card holds 1/64 of the stack and a host's eight
    loads together hold a few GB; the whole-then-slice path held the
    ~141 GB bf16 stack in every rank."""
    cfg = get_model_config("llama-3-70b")
    plan = load_plan(cfg, {"pp": 8, "tp": 8}, ranks_per_host=8)
    assert plan["host_bytes"] < 40e9, plan
    assert plan["host_bytes"] < 141e9 / 3, plan
    assert plan["card_bytes"] < 80e9 / 20, plan
    assert _model_bytes(cfg) > 140e9
