"""The port's checkpoint loading against HF ``transformers`` and the JAX
package, on the CPU.

A tiny ``LlamaForCausalLM`` is built and saved locally (nothing is
downloaded), in fp32 and in bf16. The port's logits from it must match
HF's at fp32 rtol/atol 2e-4 (as ``tests/test_weights.py`` holds the JAX
package: two fp32 implementations summing in different orders). The
port's ``load_weights`` must equal the JAX package's on the same directory
bit for bit, dense and quantized at load (int8, int4 with gs 32), and its
own safetensors reader must return what ``safetensors`` wrote.

The other families ``config_from_hf`` reads get the same checks from tiny
local checkpoints: ``Qwen2ForCausalLM`` (q/k/v biases),
``Qwen3ForCausalLM`` (qk norms, tied embeddings, q width != hidden),
``MixtralForCausalLM`` (router + experts) and ``OPTForCausalLM`` (its own
tensor names, LayerNorm biases, learned positions, tied head). Their
biases and norm weights are drawn at random before saving (HF initialises
them to 0 and 1, where a tensor loaded into the wrong place would go
unseen).
"""

import copy
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from safetensors.torch import save_file

from kubernetes_gpu_cluster_tpu.engine import weights as JW
from kubernetes_gpu_cluster_tpu_torch.config import CacheConfig
from kubernetes_gpu_cluster_tpu_torch.engine import weights as TW
from kubernetes_gpu_cluster_tpu_torch.engine.kv_cache import allocate_kv_cache
from kubernetes_gpu_cluster_tpu_torch.models import llama as TM
from kubernetes_gpu_cluster_tpu_torch.models import registry as TR
from kubernetes_gpu_cluster_tpu_torch.parallel import make_mesh, shard_params

torch.set_num_threads(2)

GS = 32


@pytest.fixture(scope="module")
def hf_llama(tmp_path_factory):
    """(HF model, fp32 checkpoint dir, bf16 checkpoint dir)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("USE_TF", "0")     # a torch model only: skip TensorFlow
        from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(0)
    model = LlamaForCausalLM(LlamaConfig(
        vocab_size=128, hidden_size=128, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, rope_theta=10000.0, rms_norm_eps=1e-5,
        tie_word_embeddings=False, attention_bias=False)).eval()
    root = tmp_path_factory.mktemp("hf")
    model.save_pretrained(root / "fp32", safe_serialization=True)
    copy.deepcopy(model).to(torch.bfloat16).save_pretrained(
        root / "bf16", safe_serialization=True)
    return model, str(root / "fp32"), str(root / "bf16")


def test_logits_match_hf(hf_llama):
    _logits_match_hf(*hf_llama[:2])


def _logits_match_hf(model, path):
    cfg = TW.config_from_hf(path).replace(dtype="float32")
    params = TW.load_weights(path, cfg, device="cpu")
    prompt = [1, 17, 99, 4, 63, 2, 118, 30]
    T = len(prompt)
    ar = torch.arange(T, dtype=torch.int32)
    meta = TM.PrefillMeta(torch.zeros(T, dtype=torch.int32), ar, ar, ar)
    kv = allocate_kv_cache(cfg, CacheConfig(page_size=16, num_pages=4), 4,
                           "cpu")
    normed, _, _ = TM.forward_prefill(params, cfg, torch.tensor(
        prompt, dtype=torch.int32), meta, kv)
    got = TM.compute_logits(params, cfg, normed).numpy()
    with torch.no_grad():
        want = model(torch.tensor([prompt])).logits[0].numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("method", [None, "int8", "int4"])
@pytest.mark.parametrize("ckpt", ["fp32", "bf16"])
def test_load_matches_jax_load(hf_llama, method, ckpt):
    """Dense and quantized-at-load params equal the JAX package's bit for
    bit: packed bytes, codes and scales, and float weights in the model
    dtype."""
    _load_matches_jax_load(hf_llama[1] if ckpt == "fp32" else hf_llama[2],
                           method, ckpt)


def _load_matches_jax_load(path, method, ckpt):
    kw = dict(dtype="float32" if ckpt == "fp32" else "bfloat16",
              quantization=method, quant_group_size=GS)
    want = JW.load_weights(path, JW.config_from_hf(path).replace(**kw))
    got = TW.load_weights(path, TW.config_from_hf(path).replace(**kw),
                          device="cpu")
    leaves = jax.tree_util.tree_leaves_with_path(want)
    assert len(leaves) == len(got["layers"]) + len(got) - 1
    for keys, w in leaves:
        g = got
        for k in keys:
            g = g[k.key]
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, keys
        if w.dtype == np.int8:
            assert g.dtype == torch.int8, keys
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            assert str(g.dtype) == f"torch.{w.dtype}", keys
            np.testing.assert_array_equal(g.float().numpy(),
                                          w.astype(np.float32))


def test_safetensors_reader(tmp_path):
    """Every dtype the port reads, across two files of one checkpoint."""
    g = torch.Generator().manual_seed(1)
    parts = [{"a.bf16": torch.randn(3, 5, generator=g).to(torch.bfloat16),
              "b.f32": torch.randn(7, generator=g),
              "c.empty": torch.zeros(0, 4)},
             {"d.i8": torch.randint(-128, 128, (4, 2), generator=g,
                                    dtype=torch.int8),
              "e.f16": torch.randn(2, 2, generator=g).half(),
              "f.i64": torch.arange(5)}]
    for i, part in enumerate(parts):
        save_file(part, str(tmp_path / f"model-{i}.safetensors"),
                  metadata={"format": "pt"})
    ckpt = TW._Checkpoint(str(tmp_path))
    for part in parts:
        for key, want in part.items():
            assert key in ckpt
            got = ckpt.get(key)
            assert got.dtype == want.dtype and torch.equal(got, want), key
    assert torch.equal(ckpt.get_t("a.bf16"), parts[0]["a.bf16"].T)
    # A file whose header promises more bytes than it holds is refused.
    bad = tmp_path / "bad"
    bad.mkdir()
    raw = (tmp_path / "model-0.safetensors").read_bytes()
    (bad / "model.safetensors").write_bytes(raw[:-8])
    with pytest.raises(ValueError, match="bytes for"):
        TW._Checkpoint(str(bad))


def test_config_and_unported_checkpoints(hf_llama, tmp_path, monkeypatch):
    path = hf_llama[1]
    got, want = TW.config_from_hf(path), JW.config_from_hf(path)
    for field in ("vocab_size", "hidden_size", "intermediate_size",
                  "num_layers", "num_heads", "num_kv_heads", "head_dim",
                  "rope_theta", "rope_scaling", "rms_norm_eps",
                  "max_model_len", "name"):
        assert getattr(got, field) == getattr(want, field), field
    cfg, wpath, tpath = TW.resolve_model(path)
    assert (cfg, wpath, tpath) == (got, path, path)
    assert TW.resolve_model("llama-3-8b")[1:] == (None, None)
    # A checkpoint that does not fit the config fails the streamed load too.
    with pytest.raises(ValueError, match="does not fit"):
        TW.load_weights(path, got.replace(
            intermediate_size=2 * got.intermediate_size), device="cpu",
            groups=make_mesh(tp=2, rank=0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TW.load_weights(path, got)


# -- the other families -------------------------------------------------------

def _families():
    """name -> (HF model class, its config): tiny, built locally."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("USE_TF", "0")
        import transformers as hf
    common = dict(vocab_size=128, hidden_size=128, intermediate_size=256,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, max_position_embeddings=256,
                  rope_theta=10000.0, rms_norm_eps=1e-5)
    return {
        "qwen2": (hf.Qwen2ForCausalLM, hf.Qwen2Config(
            **common, tie_word_embeddings=False)),
        "qwen3": (hf.Qwen3ForCausalLM, hf.Qwen3Config(
            **common, head_dim=48, tie_word_embeddings=True)),
        "mixtral": (hf.MixtralForCausalLM, hf.MixtralConfig(
            **common, num_local_experts=4, num_experts_per_tok=2,
            tie_word_embeddings=False)),
        "opt": (hf.OPTForCausalLM, hf.OPTConfig(
            vocab_size=128, hidden_size=128, ffn_dim=256,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=64, word_embed_proj_dim=128,
            do_layer_norm_before=True, activation_function="relu",
            enable_bias=True, tie_word_embeddings=True)),
    }


FAMILIES = ("qwen2", "qwen3", "mixtral", "opt")


@pytest.fixture(scope="module")
def hf_family(tmp_path_factory):
    """name -> (HF model, fp32 checkpoint dir, bf16 checkpoint dir)."""
    out = {}
    for i, (name, (cls, config)) in enumerate(_families().items()):
        torch.manual_seed(10 + i)
        model = cls(config).eval()
        with torch.no_grad():
            for pname, p in model.named_parameters():
                if pname.endswith("bias") or "norm" in pname:
                    p.copy_(torch.randn_like(p) * 0.2
                            + ("norm" in pname and "bias" not in pname))
        root = tmp_path_factory.mktemp(name)
        model.save_pretrained(root / "fp32", safe_serialization=True)
        copy.deepcopy(model).to(torch.bfloat16).save_pretrained(
            root / "bf16", safe_serialization=True)
        out[name] = (model, str(root / "fp32"), str(root / "bf16"))
    return out


@pytest.mark.parametrize("name", FAMILIES)
def test_family_logits_match_hf(hf_family, name):
    """The port's load + prefill + logits of each family against HF's
    forward at fp32 rtol/atol 2e-4."""
    _logits_match_hf(*hf_family[name][:2])


@pytest.mark.parametrize("name", FAMILIES)
def test_family_config_matches_jax(hf_family, name):
    path = hf_family[name][1]
    got, want = TW.config_from_hf(path), JW.config_from_hf(path)
    for field in (f.name for f in dataclasses.fields(want)):
        assert getattr(got, field) == getattr(want, field), field
    assert got.is_moe == (name == "mixtral")
    assert got.tie_word_embeddings == (name in ("qwen3", "opt"))


@pytest.mark.parametrize("method", [None, "int8", "int4"])
@pytest.mark.parametrize("ckpt", ["fp32", "bf16"])
@pytest.mark.parametrize("name", FAMILIES)
def test_family_load_matches_jax_load(hf_family, name, method, ckpt):
    """Every family's params, dense and quantized at load, equal the JAX
    package's load bit for bit (expert weights and scales included, no
    ``lm_head`` when tied)."""
    path = hf_family[name][1 if ckpt == "fp32" else 2]
    _load_matches_jax_load(path, method, ckpt)
    if name in ("qwen3", "opt"):
        cfg = TW.config_from_hf(path).replace(quantization=method,
                                              quant_group_size=GS)
        got = TW.load_weights(path, cfg, device="cpu")
        assert "lm_head" not in got and "lm_head_scale" not in got


def test_opt_config_refusals(hf_family, tmp_path):
    """OPT variants the model has no path for fail the config read."""
    hf = json.loads(open(f"{hf_family['opt'][1]}/config.json").read())
    for edit, match in (({"do_layer_norm_before": False}, "post-LN"),
                        ({"word_embed_proj_dim": 64}, "word_embed_proj_dim"),
                        ({"activation_function": "swish"}, "activation")):
        d = tmp_path / match
        d.mkdir()
        (d / "config.json").write_text(json.dumps({**hf, **edit}))
        with pytest.raises(ValueError, match=match):
            TW.config_from_hf(str(d))


def test_registry_resolves_presets_and_checkpoints(hf_family):
    """models/registry.py: a preset name (or an HF id ending in one) gives
    its config and random weights; a local checkpoint directory gives
    config_from_hf and the port's load of it."""
    assert TR.list_models() == sorted(TR.MODEL_PRESETS)
    r = TR.resolve("Qwen/Qwen3-4B")
    assert r.config == TR.get_model_config("qwen3-4b")
    assert (r.weights_path, r.tokenizer_path) == (None, None)
    assert TR.load(r) is None
    path = hf_family["mixtral"][1]
    r = TR.resolve(path, name="tiny-mixtral")
    assert r.config.name == "tiny-mixtral" and r.config.is_moe
    assert r.weights_path == r.tokenizer_path == path
    cfg = r.config.replace(dtype="float32")
    got = TR.load(TR.ResolvedModel(cfg, path, path), device="cpu")
    want = TW.load_weights(path, cfg, device="cpu")
    assert got.keys() == want.keys()
    assert all(torch.equal(got["layers"][k], want["layers"][k])
               for k in want["layers"])


@pytest.mark.parametrize("method", [None, "int4"])
@pytest.mark.parametrize("name", ["llama", "mixtral", "opt"])
def test_sharded_load_is_the_rank_slice_of_the_full_load(
        hf_llama, hf_family, name, method):
    """``load_weights(groups=)`` reads the whole checkpoint on the host and
    keeps one rank's slice: for every rank of tp 2 (x ep 2 for mixtral)
    the tensors equal ``shard_params`` of the full load, int4 scales
    included."""
    path = hf_llama[1] if name == "llama" else hf_family[name][1]
    cfg = TW.config_from_hf(path).replace(quantization=method,
                                          quant_group_size=GS)
    full = TW.load_weights(path, cfg, device="cpu")
    tp, ep = 2, 2 if cfg.is_moe else 1
    for rank in range(tp * ep):
        groups = make_mesh(tp=tp, ep=ep, rank=rank)
        got = TW.load_weights(path, cfg, device="cpu", groups=groups)
        want = shard_params(full, cfg, groups)
        assert set(got) == set(want)
        assert set(got["layers"]) == set(want["layers"])
        for key in want["layers"]:
            assert torch.equal(got["layers"][key], want["layers"][key]), key
        for key in (k for k in want if k != "layers"):
            assert torch.equal(got[key], want[key]), key
        assert got["layers"]["wq"].shape[-1] * tp == \
            full["layers"]["wq"].shape[-1]


@pytest.mark.parametrize("name", ["llama", "mixtral", "opt"])
def test_pp_load_keeps_the_stage_layers(hf_llama, hf_family, name):
    """Under pp 2 ``load_weights(groups=)`` keeps each stage's half of
    every stacked layer tensor and the embedding, final norm and head
    whole (with tp 2, their tp slices of those halves)."""
    path = hf_llama[1] if name == "llama" else hf_family[name][1]
    cfg = TW.config_from_hf(path)
    full = TW.load_weights(path, cfg, device="cpu")
    half = cfg.num_layers // 2
    for rank in range(2):
        got = TW.load_weights(path, cfg, device="cpu",
                              groups=make_mesh(pp=2, rank=rank))
        for key, t in full["layers"].items():
            assert torch.equal(got["layers"][key],
                               t[rank * half:(rank + 1) * half]), key
        for key in (k for k in full if k != "layers"):
            assert torch.equal(got[key], full[key]), key
    groups = make_mesh(pp=2, tp=2, rank=3)          # stage 1, tp rank 1
    got = TW.load_weights(path, cfg, device="cpu", groups=groups)
    want = shard_params(full, cfg, groups)
    for key in want["layers"]:
        assert torch.equal(got["layers"][key], want["layers"][key]), key
        assert got["layers"][key].shape[0] == half
