"""Weight loading: a local HF safetensors checkpoint -> the port's params.

The single-device host path of the JAX package's ``engine/weights.py``:
weights are read from a LOCAL directory (pre-staged, never downloaded at
serving time), HF's per-layer ``[out, in]`` matrices are transposed to the
right-multiply ``[in, out]`` layout and stacked along a leading ``[L]``
axis, matmul weights are quantized on the host when the config asks for it
(so the device never holds them at full precision), and the result is
uploaded to the engine's device.

The safetensors format is read here directly (an 8-byte little-endian
header length, a JSON header of dtype / shape / byte offsets, then the raw
tensor bytes), through ``numpy.memmap``, so the port needs no
``safetensors`` package.

Covered: every family ``config_from_hf`` reads: llama-class (Llama 1/2/3,
TinyLlama), Qwen2/2.5 (q/k/v biases), Qwen3 (qk norms, tied embeddings),
Mixtral (router and per-expert weights stacked ``[L, E, in, out]``) and
OPT (its own tensor names). Under tp/ep (``groups=``) the whole checkpoint
is read on the host and each rank uploads only its slices
(``parallel/sharding.py``). Not ported yet: the shard-aware streamed load
that reads only a rank's byte ranges (ROADMAP A7d), which raises
NotImplementedError.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Optional

import numpy as np
import torch

from ..config import ModelConfig, get_model_config
from ..models import llama as model_lib
from ..ops.quant import quantize_params
from ..parallel.sharding import init_shard_fn
from ..utils import get_logger
from .engine import resolve_device

logger = get_logger("engine.weights")

Params = dict[str, Any]

# safetensors dtype tag -> little-endian numpy dtype ("BF16" is read as
# int16 bits and viewed as torch.bfloat16).
_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "BF16": "<i2",
           "I64": "<i8", "I32": "<i4", "I16": "<i2", "I8": "i1", "U8": "u1",
           "BOOL": "?"}


def config_from_hf(path: str, name: Optional[str] = None) -> ModelConfig:
    """A ModelConfig from a local HF checkpoint's config.json: llama, qwen2,
    qwen3, mixtral and OPT architectures, no preset needed."""
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    arch = (hf.get("architectures") or ["LlamaForCausalLM"])[0]
    name = name or os.path.basename(os.path.normpath(path))
    if arch == "OPTForCausalLM":
        return _opt_config_from_hf(hf, name)
    num_heads = hf["num_attention_heads"]
    head_dim = hf.get("head_dim") or hf["hidden_size"] // num_heads
    rope_scaling = None
    if hf.get("rope_scaling"):
        from ..ops.rope import scaled_inv_freq
        raw = {k: v for k, v in hf["rope_scaling"].items()
               if isinstance(v, (str, int, float, bool))}
        # Validate now: an unsupported type must fail the load, not serve
        # with unscaled RoPE.
        scaled_inv_freq(head_dim, float(hf.get("rope_theta", 10000.0)), raw)
        rope_scaling = tuple(sorted(raw.items()))
    return ModelConfig(
        name=name,
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=num_heads,
        num_kv_heads=hf.get("num_key_value_heads", num_heads),
        head_dim=head_dim,
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        rope_scaling=rope_scaling,
        rms_norm_eps=float(hf.get("rms_norm_eps", 1e-5)),
        tie_word_embeddings=bool(hf.get("tie_word_embeddings", False)),
        attention_bias=bool(hf.get("attention_bias",
                                   arch == "Qwen2ForCausalLM")),
        qk_norm=arch == "Qwen3ForCausalLM",
        num_experts=hf.get("num_local_experts", 0),
        num_experts_per_tok=hf.get("num_experts_per_tok", 2),
        max_model_len=min(int(hf.get("max_position_embeddings", 4096)), 8192),
    )


def _validate_act(act: str) -> str:
    """Fail the load on an activation the model has no function for."""
    if act not in model_lib.MLP_ACTS:
        raise ValueError(f"unsupported activation_function {act!r}; "
                         f"supported: {sorted(model_lib.MLP_ACTS)}")
    return act


def _opt_config_from_hf(hf: dict, name: str) -> ModelConfig:
    """OPT (the reference's minimal-example model, facebook/opt-125m):
    learned positions (+2 offset), pre-LN LayerNorm with biases, a biased
    fc1/act/fc2 MLP, a tied head, MHA."""
    h = hf["hidden_size"]
    num_heads = hf["num_attention_heads"]
    if hf.get("word_embed_proj_dim", h) != h:
        raise ValueError("OPT word_embed_proj_dim != hidden_size (projected "
                         "embeddings) is not supported")
    if not hf.get("do_layer_norm_before", True):
        raise ValueError("OPT post-LN variants (do_layer_norm_before=false, "
                         "e.g. opt-350m) are not supported")
    bias = bool(hf.get("enable_bias", True))
    return ModelConfig(
        name=name,
        vocab_size=hf["vocab_size"],
        hidden_size=h,
        intermediate_size=hf["ffn_dim"],
        num_layers=hf["num_hidden_layers"],
        num_heads=num_heads,
        num_kv_heads=num_heads,
        head_dim=h // num_heads,
        tie_word_embeddings=bool(hf.get("tie_word_embeddings", True)),
        attention_bias=bias,
        norm_type="layernorm",
        pos_embedding="learned",
        mlp_type="mlp",
        mlp_act=_validate_act(hf.get("activation_function", "relu")),
        linear_bias=bias,
        max_model_len=min(int(hf.get("max_position_embeddings", 2048)), 8192),
    )


class _Checkpoint:
    """All *.safetensors files of a checkpoint dir behind one name->tensor
    lookup. Files are memory-mapped; a tensor is copied out per get()."""

    def __init__(self, path: str):
        files = sorted(f for f in os.listdir(path)
                       if f.endswith(".safetensors"))
        if not files:
            raise FileNotFoundError(f"no *.safetensors under {path}")
        self._maps: list[np.memmap] = []
        # name -> (file index, dtype tag, shape, first byte, end byte)
        self._index: dict[str, tuple] = {}
        for f in files:
            fp = os.path.join(path, f)
            with open(fp, "rb") as fh:
                (n,) = struct.unpack("<Q", fh.read(8))
                header = json.loads(fh.read(n))
            mm = np.memmap(fp, dtype=np.uint8, mode="r")
            i = len(self._maps)
            self._maps.append(mm)
            for key, meta in header.items():
                if key == "__metadata__":
                    continue
                tag, shape = meta["dtype"], tuple(meta["shape"])
                if tag not in _DTYPES:
                    raise ValueError(f"{fp}: {key}: unsupported dtype {tag}")
                begin, end = (8 + n + o for o in meta["data_offsets"])
                want = int(np.prod(shape)) * np.dtype(_DTYPES[tag]).itemsize
                if end - begin != want or end > mm.size:
                    raise ValueError(f"{fp}: {key}: {end - begin} bytes for "
                                     f"{tag}{list(shape)}")
                self._index[key] = (i, tag, shape, begin, end)
        logger.info("checkpoint %s: %d files, %d tensors", path, len(files),
                    len(self._index))

    def __contains__(self, key: str) -> bool:
        return key in self._index

    def get(self, key: str) -> torch.Tensor:
        i, tag, shape, begin, end = self._index[key]
        arr = self._maps[i][begin:end].view(_DTYPES[tag]).reshape(shape)
        t = torch.from_numpy(arr.copy())
        return t.view(torch.bfloat16) if tag == "BF16" else t

    def get_t(self, key: str) -> torch.Tensor:
        """Fetch a torch [out, in] matrix as [in, out]."""
        return self.get(key).T.contiguous()


def _stacker(ckpt: _Checkpoint, L: int, pre: str):
    """``stack(suffix, transpose=True)``: the ``[L, ...]`` tensor of the
    per-layer tensors ``pre.format(layer) + suffix``, holding one extra
    layer; ``[out, in]`` matrices come out as ``[in, out]``."""
    def stack(suffix: str, transpose: bool = True) -> torch.Tensor:
        read = ckpt.get_t if transpose else ckpt.get
        first = read(pre.format(0) + suffix)
        out = torch.empty((L,) + tuple(first.shape), dtype=first.dtype)
        out[0] = first
        for layer in range(1, L):
            out[layer] = read(pre.format(layer) + suffix)
        return out
    return stack


def load_weights(path: str, cfg: ModelConfig,
                 device: torch.device | str = "cuda",
                 dtype: Optional[torch.dtype] = None,
                 shardings: Optional[Any] = None, groups=None) -> Params:
    """Load a local HF checkpoint into the stacked-layer params of
    ``models/llama.py`` on ``device`` (the card unless the caller asks for
    the CPU). With ``cfg.quantization`` the matmul weights (experts
    included) and ``lm_head`` are quantized on the host before upload,
    bit-identically to the JAX package's load. ``groups``
    (``parallel.ParallelGroups``): slice on the host after the load and
    upload this rank's part only."""
    if shardings is not None:
        raise NotImplementedError("the shard-aware streamed load is not "
                                  "ported yet (ROADMAP A7d)")
    model_lib.check_supported(cfg)
    device = resolve_device(device)
    ckpt = _Checkpoint(path)
    dtype = dtype or cfg.torch_dtype
    if cfg.pos_embedding == "learned":
        return _place(_load_opt_host(ckpt, cfg), cfg, dtype, device, groups)
    L = cfg.num_layers
    pre = "model.layers.{}."
    stack = _stacker(ckpt, L, pre)
    layers = {
        "input_norm": stack("input_layernorm.weight", transpose=False),
        "post_attn_norm": stack("post_attention_layernorm.weight",
                                transpose=False),
        "wq": stack("self_attn.q_proj.weight"),
        "wk": stack("self_attn.k_proj.weight"),
        "wv": stack("self_attn.v_proj.weight"),
        "wo": stack("self_attn.o_proj.weight"),
    }
    if cfg.attention_bias:
        for ours, theirs in (("bq", "q_proj"), ("bk", "k_proj"),
                             ("bv", "v_proj")):
            layers[ours] = stack(f"self_attn.{theirs}.bias", transpose=False)
    if cfg.qk_norm:
        layers["q_norm"] = stack("self_attn.q_norm.weight", transpose=False)
        layers["k_norm"] = stack("self_attn.k_norm.weight", transpose=False)
    if cfg.is_moe:
        layers["router"] = stack("block_sparse_moe.gate.weight")
        for ours, theirs in (("w_gate", "w1"), ("w_up", "w3"),
                             ("w_down", "w2")):
            layers[ours] = _stack_experts(ckpt, cfg, pre, theirs)
    else:
        layers["w_gate"] = stack("mlp.gate_proj.weight")
        layers["w_up"] = stack("mlp.up_proj.weight")
        layers["w_down"] = stack("mlp.down_proj.weight")
    params: Params = {
        "embed": ckpt.get("model.embed_tokens.weight"),
        "final_norm": ckpt.get("model.norm.weight"),
        "layers": layers,
    }
    _head(ckpt, cfg, params)
    return _place(params, cfg, dtype, device, groups)


def _stack_experts(ckpt: _Checkpoint, cfg: ModelConfig, pre: str,
                   w_name: str) -> torch.Tensor:
    """Mixtral's ``block_sparse_moe.experts.{e}.{w_name}`` of every layer
    as one ``[L, E, in, out]`` tensor."""
    L, E = cfg.num_layers, cfg.num_experts
    key = pre + "block_sparse_moe.experts.{}." + w_name + ".weight"
    first = ckpt.get_t(key.format(0, 0))
    out = torch.empty((L, E) + tuple(first.shape), dtype=first.dtype)
    for layer in range(L):
        for e in range(E):
            out[layer, e] = ckpt.get_t(key.format(layer, e))
    return out


def _head(ckpt: _Checkpoint, cfg: ModelConfig, params: Params) -> None:
    """``lm_head`` unless the config ties it to the embedding; a checkpoint
    without one ties it although its config does not say so."""
    if cfg.tie_word_embeddings:
        return
    if "lm_head.weight" in ckpt:
        params["lm_head"] = ckpt.get_t("lm_head.weight")
    else:
        params["lm_head"] = params["embed"].T.contiguous()


def _load_opt_host(ckpt: _Checkpoint, cfg: ModelConfig) -> Params:
    """An HF OPTForCausalLM checkpoint -> the model's params (host). The
    per-layer pre-MLP norm is ``final_layer_norm`` inside each layer,
    distinct from the decoder's ``model.decoder.final_layer_norm``."""
    stack = _stacker(ckpt, cfg.num_layers, "model.decoder.layers.{}.")
    layers = {
        "input_norm": stack("self_attn_layer_norm.weight", transpose=False),
        "input_norm_b": stack("self_attn_layer_norm.bias", transpose=False),
        "post_attn_norm": stack("final_layer_norm.weight", transpose=False),
        "post_attn_norm_b": stack("final_layer_norm.bias", transpose=False),
        "wq": stack("self_attn.q_proj.weight"),
        "wk": stack("self_attn.k_proj.weight"),
        "wv": stack("self_attn.v_proj.weight"),
        "wo": stack("self_attn.out_proj.weight"),
        "w_up": stack("fc1.weight"),
        "w_down": stack("fc2.weight"),
    }
    if cfg.attention_bias:
        for ours, theirs in (("bq", "q_proj"), ("bk", "k_proj"),
                             ("bv", "v_proj")):
            layers[ours] = stack(f"self_attn.{theirs}.bias", transpose=False)
    if cfg.linear_bias:
        layers["bo"] = stack("self_attn.out_proj.bias", transpose=False)
        layers["b_up"] = stack("fc1.bias", transpose=False)
        layers["b_down"] = stack("fc2.bias", transpose=False)
    params: Params = {
        "embed": ckpt.get("model.decoder.embed_tokens.weight"),
        "pos_embed": ckpt.get("model.decoder.embed_positions.weight"),
        "final_norm": ckpt.get("model.decoder.final_layer_norm.weight"),
        "final_norm_b": ckpt.get("model.decoder.final_layer_norm.bias"),
        "layers": layers,
    }
    _head(ckpt, cfg, params)
    return params


def _place(params: Params, cfg: ModelConfig, dtype: torch.dtype,
           device: torch.device, groups=None) -> Params:
    """Quantize on the host (the device never holds full-precision matmul
    weights), check every shape against the model's layout, keep this
    rank's slice under ``groups``, take float weights to ``dtype``, and
    upload."""
    if cfg.quantization:
        params = quantize_params(params, cfg.quantization,
                                 cfg.quant_group_size)
    want_layers, want_top = model_lib.param_layouts(cfg)
    shard = (init_shard_fn(cfg, groups) if groups is not None
             and groups.world_size > 1 else None)

    def put(name: str, t: torch.Tensor, shape, kind) -> torch.Tensor:
        if tuple(t.shape) != shape:
            raise ValueError(f"checkpoint {name}: shape {tuple(t.shape)} "
                             f"!= {shape} for {cfg.name}")
        if shard is not None:
            t = shard(name, t, name in want_top)
        return (t.to(dtype) if kind == "float" else t).to(device)

    out: Params = {"layers": {name: put(name, params["layers"][name], *spec)
                              for name, spec in want_layers.items()}}
    out.update({name: put(name, params[name], *spec)
                for name, spec in want_top.items()})
    n_bytes = sum(t.numel() * t.element_size()
                  for t in [*out["layers"].values(),
                            *(v for k, v in out.items() if k != "layers")])
    logger.info("loaded %s: %.2f GB on %s (%s)", cfg.name, n_bytes / 1e9,
                device, cfg.quantization or dtype)
    return out


def resolve_model(model_url: str, name: Optional[str] = None):
    """``modelURL`` semantics (HF id OR local path): a local directory with
    config.json -> (config_from_hf, weights path, tokenizer path);
    otherwise a preset name -> (preset config, None, None), served with
    random weights."""
    if os.path.isdir(model_url) and os.path.exists(
            os.path.join(model_url, "config.json")):
        return config_from_hf(model_url, name), model_url, model_url
    return get_model_config(model_url), None, None
