"""Weight loading: a local HF safetensors checkpoint -> the port's params.

The port of the JAX package's ``engine/weights.py``: weights are read from
a LOCAL directory (pre-staged, never downloaded at serving time), HF's
per-layer ``[out, in]`` matrices are transposed to the right-multiply
``[in, out]`` layout and stacked along a leading ``[L]`` axis, matmul
weights are quantized on the host when the config asks for it (so the
device never holds them at full precision), and the result is uploaded to
the engine's device.

The safetensors format is read here directly (an 8-byte little-endian
header length, a JSON header of dtype / shape / byte offsets, then the raw
tensor bytes), so the port needs no ``safetensors`` package.

Covered: every family ``config_from_hf`` reads: llama-class (Llama 1/2/3,
TinyLlama), Qwen2/2.5 (q/k/v biases), Qwen3 (qk norms, tied embeddings),
Mixtral (router and per-expert weights stacked ``[L, E, in, out]``) and
OPT (its own tensor names).

Under tp/ep/pp/sp (``groups=`` of more than one rank) the load streams:
each rank reads only the byte ranges of its own slices (its stage's
layers, its heads, columns, rows, experts and vocab rows; the index ranges
come from ``parallel.sharding.local_ranges``, the source ``shard_tensor``
slices by) and writes them into its tensors on the device one layer block
at a time, so no host holds the stacked model. OPT, as in the JAX package,
reads the whole checkpoint and keeps the rank's slice.

Memory is read with ``os.preadv`` straight into the buffer that keeps the
bytes, never through a memory map: a mapped page stays in the process's
resident set until it is unmapped, so a mapped ranged read would make a
streamed load look as large as the bytes it touched. With reads, the
resident set grows by what the process holds; a load's host peak is the
growth of the resident set over it (``HostPeak``).
"""

from __future__ import annotations

import json
import os
import struct
import time
from typing import Any, Optional

import numpy as np
import torch

from ..config import ModelConfig, get_model_config
from ..models import llama as model_lib
from ..ops.quant import (quantize_params, quantize_tensor,
                         quantize_tensor_int4)
from ..parallel.sharding import (Runs, init_shard_fn, local_ranges,
                                 local_shape, rules_fn)
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
    lookup. A tensor is read with ``os.preadv`` straight into the buffer
    that keeps it: ``get`` reads a whole tensor, ``read`` only the byte
    ranges of the rows and columns asked for. Nothing is memory-mapped, so
    the process's resident memory grows by what it keeps, not by what it
    has read (a mapped page stays resident until it is unmapped)."""

    def __init__(self, path: str):
        files = sorted(f for f in os.listdir(path)
                       if f.endswith(".safetensors"))
        if not files:
            raise FileNotFoundError(f"no *.safetensors under {path}")
        self._fds: list[int] = []
        # name -> (file index, dtype tag, shape, first byte)
        self._index: dict[str, tuple] = {}
        # Tensor bytes read, their reads and seconds (the load's log line).
        self.bytes_read, self.reads, self.read_s = 0, 0, 0.0
        try:
            for f in files:
                self._open(os.path.join(path, f))
        except BaseException:
            self.close()
            raise
        logger.info("checkpoint %s: %d files, %d tensors", path, len(files),
                    len(self._index))

    def _open(self, fp: str) -> None:
        fd = os.open(fp, os.O_RDONLY)
        i = len(self._fds)
        self._fds.append(fd)
        size = os.fstat(fd).st_size
        (n,) = struct.unpack("<Q", self._pread(fd, 8, 0))
        header = json.loads(self._pread(fd, n, 8))
        for key, meta in header.items():
            if key == "__metadata__":
                continue
            tag, shape = meta["dtype"], tuple(meta["shape"])
            if tag not in _DTYPES:
                raise ValueError(f"{fp}: {key}: unsupported dtype {tag}")
            if key in self._index:
                raise ValueError(f"{fp}: {key} is in another file too")
            begin, end = (8 + n + o for o in meta["data_offsets"])
            want = int(np.prod(shape)) * np.dtype(_DTYPES[tag]).itemsize
            if end - begin != want or end > size:
                raise ValueError(f"{fp}: {key}: {end - begin} bytes for "
                                 f"{tag}{list(shape)}")
            self._index[key] = (i, tag, shape, begin)

    @staticmethod
    def _pread(fd: int, n: int, offset: int) -> bytes:
        buf = bytearray(n)
        _Checkpoint._fill(fd, memoryview(buf), offset)
        return bytes(buf)

    @staticmethod
    def _fill(fd: int, buf: memoryview, offset: int) -> None:
        while buf:
            got = os.preadv(fd, [buf], offset)
            if got <= 0:
                raise EOFError(f"checkpoint file ends before byte {offset}")
            buf, offset = buf[got:], offset + got

    def close(self) -> None:
        for fd in self._fds:
            os.close(fd)
        self._fds = []

    def __enter__(self) -> "_Checkpoint":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __contains__(self, key: str) -> bool:
        return key in self._index

    def shape(self, key: str) -> tuple:
        return self._index[key][2]

    def read(self, key: str, rows: Optional[Runs] = None,
             cols: Optional[Runs] = None) -> torch.Tensor:
        """Ranged read of ``key`` in its on-disk layout (``[out, in]`` for
        a matrix): the rows in ``rows`` and, of a 2-D tensor, the columns in
        ``cols``, each a sequence of [start, stop) runs concatenated in
        order (None: the whole axis). Only those bytes leave the file."""
        i, tag, shape, begin = self._index[key]
        fd, np_dtype = self._fds[i], np.dtype(_DTYPES[tag])
        item = np_dtype.itemsize
        if len(shape) not in (1, 2):
            raise ValueError(f"{key}: ranged reads take 1-D and 2-D "
                             f"tensors, not {list(shape)}")
        rows = rows or ((0, shape[0]),)
        width = shape[1] if len(shape) == 2 else 1
        whole = cols is None or tuple(cols) == ((0, width),)
        cols = ((0, width),) if whole else tuple(cols)
        n_rows = sum(b - a for a, b in rows)
        n_cols = sum(b - a for a, b in cols)
        out = np.empty((n_rows, n_cols), dtype=np_dtype)
        flat = memoryview(out.reshape(-1).view(np.uint8))
        at, t0 = 0, time.perf_counter()
        # One read per run of whole rows, else per row and column run.
        runs = ([(begin + r0 * width * item, (r1 - r0) * width * item)
                 for r0, r1 in rows] if whole else
                [(begin + (r * width + c0) * item, (c1 - c0) * item)
                 for r0, r1 in rows for r in range(r0, r1)
                 for c0, c1 in cols])
        for offset, n in runs:
            self._fill(fd, flat[at:at + n], offset)
            at += n
        self.reads += len(runs)
        self.bytes_read += at
        self.read_s += time.perf_counter() - t0
        t = torch.from_numpy(out.reshape(n_rows, n_cols) if len(shape) == 2
                             else out.reshape(n_rows))
        return t.view(torch.bfloat16) if tag == "BF16" else t

    def get(self, key: str) -> torch.Tensor:
        t = self.read(key)
        return t.reshape(self._index[key][2])

    def get_t(self, key: str) -> torch.Tensor:
        """Fetch a torch [out, in] matrix as [in, out]."""
        return self.get(key).T.contiguous()


def _layer_keys(cfg: ModelConfig) -> dict[str, tuple[str, bool]]:
    """Each layer param -> (its HF tensor after ``model.layers.{layer}.``,
    ``{e}`` standing for the expert; whether it is an ``[out, in]`` matrix,
    kept here as ``[in, out]``). Llama-class, Qwen2/3 and Mixtral."""
    keys = {"input_norm": ("input_layernorm.weight", False),
            "post_attn_norm": ("post_attention_layernorm.weight", False),
            "wq": ("self_attn.q_proj.weight", True),
            "wk": ("self_attn.k_proj.weight", True),
            "wv": ("self_attn.v_proj.weight", True),
            "wo": ("self_attn.o_proj.weight", True)}
    if cfg.attention_bias:
        for ours, theirs in (("bq", "q_proj"), ("bk", "k_proj"),
                             ("bv", "v_proj")):
            keys[ours] = (f"self_attn.{theirs}.bias", False)
    if cfg.qk_norm:
        keys["q_norm"] = ("self_attn.q_norm.weight", False)
        keys["k_norm"] = ("self_attn.k_norm.weight", False)
    if cfg.is_moe:
        keys["router"] = ("block_sparse_moe.gate.weight", True)
        for ours, theirs in (("w_gate", "w1"), ("w_up", "w3"),
                             ("w_down", "w2")):
            keys[ours] = (f"block_sparse_moe.experts.{{e}}.{theirs}.weight",
                          True)
    else:
        keys["w_gate"] = ("mlp.gate_proj.weight", True)
        keys["w_up"] = ("mlp.up_proj.weight", True)
        keys["w_down"] = ("mlp.down_proj.weight", True)
    return keys


_PRE = "model.layers.{}."
_EMBED = "model.embed_tokens.weight"


def _stack(ckpt: _Checkpoint, L: int, key: str, matrix: bool,
           E: int = 0) -> torch.Tensor:
    """The ``[L, ...]`` (``[L, E, ...]`` with experts) tensor of the
    per-layer tensors ``key.format(layer, e=expert)``, holding one extra
    layer; ``[out, in]`` matrices come out as ``[in, out]``."""
    read = ckpt.get_t if matrix else ckpt.get
    lead = (L, E) if E else (L,)
    first = read(key.format(0, e=0))
    out = torch.empty(lead + tuple(first.shape), dtype=first.dtype)
    for pos in np.ndindex(*lead):
        out[pos] = read(key.format(pos[0], e=pos[-1]))
    return out


def load_weights(path: str, cfg: ModelConfig,
                 device: torch.device | str = "cuda",
                 dtype: Optional[torch.dtype] = None,
                 groups=None) -> Params:
    """Load a local HF checkpoint into the stacked-layer params of
    ``models/llama.py`` on ``device`` (the card unless the caller asks for
    the CPU). With ``cfg.quantization`` the matmul weights (experts
    included) and ``lm_head`` are quantized on the host before upload,
    bit-identically to the JAX package's load. ``groups``
    (``parallel.ParallelGroups``) of more than one rank: the load streams
    (``_load_streamed``), reading only this rank's byte ranges; OPT reads
    the whole checkpoint and keeps this rank's slice, as the JAX package
    does."""
    model_lib.check_supported(cfg)
    device = resolve_device(device)
    dtype = dtype or cfg.torch_dtype
    with _Checkpoint(path) as ckpt:
        if cfg.pos_embedding == "learned":
            return _place(_load_opt_host(ckpt, cfg), cfg, dtype, device,
                          groups)
        if groups is not None and groups.world_size > 1:
            return _load_streamed(ckpt, cfg, dtype, device, groups)
        L, E = cfg.num_layers, cfg.num_experts
        layers = {name: _stack(ckpt, L, _PRE + key, matrix,
                               E if "{e}" in key else 0)
                  for name, (key, matrix) in _layer_keys(cfg).items()}
        params: Params = {"embed": ckpt.get(_EMBED),
                          "final_norm": ckpt.get("model.norm.weight"),
                          "layers": layers}
        _head(ckpt, cfg, params)
        return _place(params, cfg, dtype, device)


def _head_key(ckpt: _Checkpoint) -> str:
    """``lm_head``'s tensor; a checkpoint without one ties it although
    its config does not say so."""
    return "lm_head.weight" if "lm_head.weight" in ckpt else _EMBED


def _head(ckpt: _Checkpoint, cfg: ModelConfig, params: Params) -> None:
    """``lm_head`` unless the config ties it to the embedding."""
    if not cfg.tie_word_embeddings:
        params["lm_head"] = ckpt.get_t(_head_key(ckpt))


def _cut(t: torch.Tensor, axis: int, runs: Runs) -> torch.Tensor:
    """The runs of ``t`` on ``axis``, concatenated."""
    parts = [t.narrow(axis, a, b - a) for a, b in runs]
    return parts[0] if len(parts) == 1 else torch.cat(parts, axis)


def _positions(lead: tuple[Runs, ...]):
    """(local, global) index tuples over the leading axes' runs."""
    idx = [[i for a, b in runs for i in range(a, b)] for runs in lead]
    for local in np.ndindex(*(len(x) for x in idx)):
        yield local, tuple(x[j] for x, j in zip(idx, local))


def _load_streamed(ckpt: _Checkpoint, cfg: ModelConfig, dtype: torch.dtype,
                   device: torch.device, groups) -> Params:
    """The shard-aware load: each local parameter is built from ranged
    reads of this rank's rows and columns (``parallel.sharding
    .local_ranges``, the source ``shard_tensor`` slices by), per layer of
    its stage and per expert of its ep slice, and written into its tensor
    on ``device``; then the next. The host holds one layer's block of one
    parameter at a time (with ``device`` the CPU, also the local params);
    never the stacked model.

    Quantization equals quantize-the-whole-tensor-then-slice (``_place``)
    bit for bit:

    - int8 scales are per output channel over the whole input axis: a
      block is read with every input row (column-split weights have them
      all; row-split ``wo`` / ``w_down`` read their full row block for the
      scale), quantized, and cut to this rank's input rows;
    - int4 scales are per (input group, output channel): a block is read
      at this rank's input rows only, which must start and end on group
      boundaries (``sharding.validate`` checks the row-split ones), and
      quantized alone;
    - the kv-head straddle reads one run of columns per kv head."""
    rules = rules_fn(cfg, groups)
    want_layers, want_top = model_lib.param_layouts(cfg)
    quant, gs = cfg.quantization, cfg.quant_group_size

    def build(name: str, key_of, n_lead: int, matrix: bool,
              top: bool) -> dict:
        """``name`` (and its scale) on ``device``: ``key_of(position)`` is
        the HF tensor at a position of the leading axes (layer, expert)."""
        want = want_top if top else want_layers
        stored, kind = want[name]
        shape = stored
        if kind == "int8" and quant == "int4":
            shape = stored[:-2] + (stored[-2] * 2, stored[-1])
        ranges = local_ranges(shape, rules(name, top), cfg, groups, name)
        lead, tail = ranges[:n_lead], ranges[n_lead:]
        disk = ckpt.shape(key_of((0,) * n_lead))
        if disk != (tuple(reversed(shape[n_lead:])) if matrix
                     else shape[n_lead:]):
            raise ValueError(f"checkpoint {name}: shape {list(disk)} does "
                             f"not fit {tuple(shape)} for {cfg.name}")
        n_local = tuple(sum(b - a for a, b in runs) for runs in lead)
        out: dict[str, torch.Tensor] = {}
        for local, pos in _positions(lead):
            key = key_of(pos)
            if not matrix:
                parts = {name: ckpt.read(key, *tail)}
            elif kind == "float":
                # The host moves the block as read; the transpose (and
                # the cast) run on the device.
                parts = {name: ckpt.read(key, tail[1], tail[0]).to(device).T}
            elif quant == "int8":
                w, scale = quantize_tensor(ckpt.read(key, tail[1]).T)
                parts = {name: _cut(w, 0, tail[0]), name + "_scale": scale}
            else:
                for a, b in tail[0]:
                    if a % gs or b % gs or a % 2 or b % 2:
                        raise ValueError(
                            f"int4 {name}: rows [{a}, {b}) of this rank do "
                            f"not start and end on {gs}-row groups")
                w, scale = quantize_tensor_int4(
                    ckpt.read(key, tail[1], tail[0]).T, gs)
                parts = {name: w, name + "_scale": scale}
            for pname, part in parts.items():
                if pname not in out:
                    out[pname] = torch.empty(
                        n_local + tuple(part.shape),
                        dtype=dtype if want[pname][1] == "float"
                        else part.dtype, device=device)
                out[pname][local] = part
        for pname, t in out.items():
            expect = local_shape(want[pname][0], rules(pname, top), cfg,
                                 groups)
            if tuple(t.shape) != expect:
                raise ValueError(f"{pname}: streamed {tuple(t.shape)}, this "
                                 f"rank's slice is {expect}")
        return out

    layers: Params = {}
    for name, (key, matrix) in _layer_keys(cfg).items():
        expert = "{e}" in key
        layers.update(build(
            name, lambda pos, key=key: (_PRE + key).format(pos[0],
                                                           e=pos[-1]),
            2 if expert else 1, matrix, top=False))
    params: Params = {"layers": layers}
    params.update(build("embed", lambda pos: _EMBED, 0, False, top=True))
    params.update(build("final_norm", lambda pos: "model.norm.weight", 0,
                        False, top=True))
    if not cfg.tie_word_embeddings:
        head = _head_key(ckpt)
        params.update(build("lm_head", lambda pos: head, 0, True, top=True))
    logger.info("loaded %s streamed: %.2f GB on %s (rank %d of %d, %s); "
                "%.2f GB read in %d reads, %.2f s of reading", cfg.name,
                _nbytes(params) / 1e9, device, groups.rank,
                groups.world_size, quant or dtype, ckpt.bytes_read / 1e9,
                ckpt.reads, ckpt.read_s)
    return params


def _nbytes(params: Params) -> int:
    return sum(t.numel() * t.element_size()
               for t in [*params["layers"].values(),
                         *(v for k, v in params.items() if k != "layers")])


def _load_opt_host(ckpt: _Checkpoint, cfg: ModelConfig) -> Params:
    """An HF OPTForCausalLM checkpoint -> the model's params (host). The
    per-layer pre-MLP norm is ``final_layer_norm`` inside each layer,
    distinct from the decoder's ``model.decoder.final_layer_norm``."""
    def stack(suffix: str, transpose: bool = True) -> torch.Tensor:
        return _stack(ckpt, cfg.num_layers, "model.decoder.layers.{}."
                      + suffix, transpose)
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
    logger.info("loaded %s: %.2f GB on %s (%s)", cfg.name,
                _nbytes(out) / 1e9, device, cfg.quantization or dtype)
    return out


def host_rss() -> int:
    """This process's resident set in bytes (``/proc/self/statm``)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


class HostPeak:
    """The host peak of a block: the largest resident set over it less the
    one at its start. A thread samples ``host_rss`` every ``INTERVAL_S``;
    where the kernel keeps ``VmHWM`` and lets ``/proc/self/clear_refs``
    reset it at the start, the mark counts too, so no short spike is
    missed (``exact``). Use as ``with HostPeak() as hp: ...``, then
    ``hp.peak`` (bytes) and ``hp.before``."""

    INTERVAL_S = 0.002

    def __init__(self):
        self.before = self.peak = 0
        self.exact = False

    def _hwm(self) -> int:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) * 1024
        return 0

    def __enter__(self) -> "HostPeak":
        import threading
        try:
            with open("/proc/self/clear_refs", "w") as f:
                f.write("5")
            self.exact = self._hwm() > 0
        except OSError:
            self.exact = False
        self.before = self._top = host_rss()
        self._stop = threading.Event()

        def sample():
            while not self._stop.wait(self.INTERVAL_S):
                self._top = max(self._top, host_rss())
        self._thread = threading.Thread(target=sample, daemon=True,
                                        name="kgct-host-peak")
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()
        top = max(self._top, host_rss(), self._hwm() if self.exact else 0)
        self.peak = top - self.before


def resolve_model(model_url: str, name: Optional[str] = None):
    """``modelURL`` semantics (HF id OR local path): a local directory with
    config.json -> (config_from_hf, weights path, tokenizer path);
    otherwise a preset name -> (preset config, None, None), served with
    random weights."""
    if os.path.isdir(model_url) and os.path.exists(
            os.path.join(model_url, "config.json")):
        return config_from_hf(model_url, name), model_url, model_url
    return get_model_config(model_url), None, None
