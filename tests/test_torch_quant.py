"""The port's weight-only quantization against the JAX package, on the CPU.

``debug-tiny`` (fp32) with ``quant_group_size=32``, so every matmul has at
least four groups. JAX is the reference on the same numpy inputs; its int4
reference is ``int4_matmul_xla`` (the Pallas interpret path does not run on
this jax, see ROADMAP C). Tolerances:

- quantizers, pack/unpack and quantize_params: bit-identical;
- int4 matmul and ``_dot``: rtol 2e-5 / atol 2e-4, as the JAX package's own
  int4 tests (fp32 sums of exact products, different summation order);
- forward logits: fp32 atol 1e-4, as ``tests/test_torch_model.py``;
- greedy engine output: token-identical.

``debug-moe`` (4 experts, top 2, random norm weights) runs the same
checks: its ``[L, E, in, out]`` expert weights quantize bit-identically,
each expert reaches the int4 matmul as one contiguous 2-D slice per call,
and its forwards and greedy engine output match JAX at int8 and int4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_gpu_cluster_tpu.config import CacheConfig as JCache
from kubernetes_gpu_cluster_tpu.config import EngineConfig as JEngineConfig
from kubernetes_gpu_cluster_tpu.config import SchedulerConfig as JSched
from kubernetes_gpu_cluster_tpu.config import get_model_config as jax_model
from kubernetes_gpu_cluster_tpu.engine import LLMEngine as JaxEngine
from kubernetes_gpu_cluster_tpu.engine import SamplingParams as JaxParams
from kubernetes_gpu_cluster_tpu.engine.kv_cache import KVCache as JKV
from kubernetes_gpu_cluster_tpu.models import llama as JM
from kubernetes_gpu_cluster_tpu.ops import quant as JQ
from kubernetes_gpu_cluster_tpu_torch.config import (CacheConfig,
                                                     EngineConfig,
                                                     SchedulerConfig,
                                                     get_model_config)
from kubernetes_gpu_cluster_tpu_torch.engine import LLMEngine, SamplingParams
from kubernetes_gpu_cluster_tpu_torch.engine.kv_cache import KVCache as TKV
from kubernetes_gpu_cluster_tpu_torch.models import llama as TM
from kubernetes_gpu_cluster_tpu_torch.ops import quant as TQ
from kubernetes_gpu_cluster_tpu_torch.ops.cuda import int4_matmul as C4
from test_torch_model import both_packages, variant_cfgs, variant_params

torch.set_num_threads(2)

GS = 32
METHODS = ("int8", "int4")
ATOL = 1e-4
PS, P = 8, 20


def _cfgs(method):
    kw = dict(quantization=method, quant_group_size=GS)
    return jax_model("debug-tiny").replace(**kw), \
        get_model_config("debug-tiny").replace(**kw)


def _t(a):
    return torch.from_numpy(np.array(a))      # a writable copy


# -- quantizers ---------------------------------------------------------------

@pytest.mark.parametrize("as_torch", [False, True])
def test_quantizers_bit_identical(as_torch):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((2, 128, 24)).astype(np.float32)
    w[0, :, 3] = 0.0                        # an all-zero channel: the 1e-8 floor
    src = _t(w) if as_torch else w
    for jfn, tfn in ((JQ.quantize_tensor, TQ.quantize_tensor),
                     (lambda a: JQ.quantize_tensor_int4(a, GS),
                      lambda a: TQ.quantize_tensor_int4(a, GS))):
        for want, got in zip(jfn(w), tfn(src)):
            got = got.numpy() if as_torch else got
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        TQ.int4_group_scale(src, GS).numpy() if as_torch
        else TQ.int4_group_scale(src, GS), JQ.int4_group_scale(w, GS))


@pytest.mark.parametrize("as_torch", [False, True])
def test_pack_unpack_every_byte(as_torch):
    """All 256 byte values: unpack sign-extends both nibbles exactly as the
    JAX package does, and pack inverts it."""
    packed = np.arange(-128, 128, dtype=np.int8).reshape(64, 4)
    want = JQ.unpack_int4(packed)
    assert want.min() == -8 and want.max() == 7
    got = TQ.unpack_int4(_t(packed) if as_torch else packed)
    got = got.numpy() if as_torch else got
    np.testing.assert_array_equal(got, want)
    back = TQ.pack_int4(_t(want) if as_torch else want)
    np.testing.assert_array_equal(back.numpy() if as_torch else back, packed)
    with pytest.raises(ValueError, match="even"):
        TQ.pack_int4(np.zeros((3, 2), np.int8))


def test_quantize_params_bit_identical():
    dense = jax.tree.map(np.asarray, JM.init_params(jax_model("debug-tiny"),
                                                    jax.random.key(0)))
    for method in METHODS:
        want = JQ.quantize_params(jax.tree.map(np.copy, dense), method, GS)
        got = TQ.quantize_params(jax.tree.map(_t, dense), method, GS)
        flat_w = jax.tree_util.tree_leaves_with_path(want)
        assert len(flat_w) == len(jax.tree.leaves(got))
        for path, w in flat_w:
            g = got
            for k in path:
                g = g[k.key]
            np.testing.assert_array_equal(g.numpy(), w)
    with pytest.raises(ValueError, match="unsupported quantization"):
        TQ.quantize_params({"layers": {}}, "fp8")


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("as_torch", [False, True])
def test_quantize_params_moe_bit_identical(method, as_torch):
    """The 4-D expert weights ``[L, E, in, out]`` quantize per expert as
    the JAX package does, bit for bit; the router and the norms stay
    float."""
    jcfg, _ = variant_cfgs("moe")
    dense = variant_params(jcfg, 4)
    want = JQ.quantize_params(jax.tree.map(np.copy, dense), method, GS)
    src = jax.tree.map(_t, dense) if as_torch else jax.tree.map(np.copy,
                                                                 dense)
    got = TQ.quantize_params(src, method, GS)
    assert set(got["layers"]) == set(want["layers"])
    L, E, d, ff = 2, 4, 128, 256
    packed = 2 if method == "int4" else 1
    assert want["layers"]["w_down"].shape == (L, E, ff // packed, d)
    assert want["layers"]["router"].dtype == np.float32
    assert "router_scale" not in got["layers"]
    for store, ref in ((got["layers"], want["layers"]), (got, want)):
        for name, w in ref.items():
            if name == "layers":
                continue
            g = store[name]
            g = g.numpy() if as_torch else g
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)


# -- the int4 matmul ----------------------------------------------------------

@pytest.mark.parametrize("K,N,gs", [(512, 256, 128), (256, 128, 64),
                                    (256, 100, 32)])
def test_int4_matmul_plain_matches_xla(K, N, gs):
    rng = np.random.default_rng(7)
    w = rng.standard_normal((K, N)).astype(np.float32)
    x = rng.standard_normal((5, K)).astype(np.float32)
    packed, scale = JQ.quantize_tensor_int4(w, gs)
    want = np.asarray(JQ.int4_matmul_xla(jnp.asarray(x), jnp.asarray(packed),
                                         jnp.asarray(scale)))
    got = TQ.int4_matmul(_t(x), _t(packed), _t(scale))    # CPU: the plain path
    assert got.dtype == torch.float32 and got.shape == (5, N)
    assert got.is_contiguous()        # the attention kernels downstream need it
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-4)
    # bf16 activations (products exact in fp32): against the explicit
    # dequant, since XLA:CPU has no bf16 x bf16 -> f32 batched dot.
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    got = TQ.int4_matmul_plain(_t(xb).to(torch.bfloat16), _t(packed),
                               _t(scale))
    np.testing.assert_allclose(got.numpy(), xb @ _dequant(packed, scale),
                               rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("T,K,N,gs", [
    (1, 4096, 4096, 128), (32, 4096, 14336, 128), (32, 14336, 4096, 128),
    (32, 4096, 1024, 32), (32, 4096, 128256, 128), (2048, 4096, 14336, 128),
    (1, 128, 96, 32), (33, 512, 100, 32), (7, 3072, 1024, 48)])
@pytest.mark.parametrize("resident", [1, 3])
def test_int4_kernel_launch_plan(T, K, N, gs, resident):
    """The kernel wrapper's host-side launch math (no card needed): the
    work is cut in whole scale groups, the blocks' ranges cover every
    (tile, group) unit exactly once, every block gets the same number of
    groups to within one, and the grid is either every resident block of
    132 SMs (every SM the same bytes) or whole-tile slices that load the
    busiest SM within 5% of the mean."""
    p = C4.plan(T, K, N, gs, sms=132, resident=resident)
    if T > C4.DECODE_ROWS:
        assert (p.kind, p.tile_rows) == (C4.PREFILL, 128)
    else:
        assert p.kind == C4.DECODE
        assert p.mt == (1 if T <= 16 else 2 if T <= 32 else 4)
        assert p.tile_rows == 16 * p.mt
    # fp32 x keeps the decode tile at any T.
    q = C4.plan(T, K, N, gs, sms=132, resident=resident, x_bf16=False)
    assert q.kind == C4.DECODE and q.mt == (1 if T <= 16 else 2 if T <= 32
                                            else 4)
    assert p.groups * gs == K
    assert p.tile_cols == (C4.PREFILL_COLS if p.kind == C4.PREFILL
                           else C4.DECODE_COLS)
    assert p.tiles == -(-N // p.tile_cols) * -(-T // p.tile_rows)
    if p.kind == C4.PREFILL:        # whole tiles, strided over the grid
        assert p.blocks == min(p.tiles, 132 * resident)
        return
    units = p.tiles * p.groups
    assert p.blocks <= min(units, 132 * resident)
    ranges = [C4.block_units(p, b) for b in range(p.blocks)]
    assert ranges[0][0] == 0 and ranges[-1][1] == units
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    sizes = [hi - lo for lo, hi in ranges]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    if p.blocks == min(units, 132 * resident):
        return                  # balanced: the same bytes on every SM
    # Aligned: S whole-tile slices per tile, no block across two tiles,
    # and the busiest SM within 5% of the mean.
    assert p.blocks % p.tiles == 0
    assert all(lo // p.groups == (hi - 1) // p.groups for lo, hi in ranges)
    assert -(-p.blocks // 132) <= C4.ALIGNED_IMBALANCE * p.blocks / 132


@pytest.mark.parametrize("T,K,N,resident,blocks", [
    (32, 4096, 14336, 2, 264),      # w_gate: 224 aligned blocks, 18% off
    (32, 14336, 4096, 2, 256),      # w_down: 8 slices per tile, 3% off
    (1, 4096, 14336, 3, 396),
    (2048, 4096, 14336, 1, 132)])
def test_int4_kernel_launch_plan_choice(T, K, N, resident, blocks):
    """Which grid the plan takes at llama-3-8b shapes on 132 SMs."""
    assert C4.plan(T, K, N, 128, sms=132, resident=resident).blocks == blocks


def _dequant(packed, scale):
    K, N = packed.shape[0] * 2, packed.shape[1]
    gs = K // scale.shape[0]
    return (JQ.unpack_int4(packed).astype(np.float32).reshape(-1, gs, N)
            * scale[:, None, :]).reshape(K, N)


@pytest.mark.parametrize("method", ["dense", "int8", "int4"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dot_matches_jax(method, dtype):
    rng = np.random.default_rng(8)
    w = rng.standard_normal((128, 48)).astype(np.float32)
    lp = {"w": w}
    if method != "dense":
        lp = JQ.quantize_params({"layers": {"wq": w}}, method, GS)["layers"]
        lp = {"w": lp["wq"], "w_scale": lp["wq_scale"]}
    jdt = getattr(jnp, dtype)
    x = jnp.asarray(rng.standard_normal((6, 128)), jdt)
    jlp = {k: jnp.asarray(v, jdt) if v.dtype == np.float32 and k == "w"
           else jnp.asarray(v) for k, v in lp.items()}
    if method == "int4" and dtype == "bfloat16":
        # XLA:CPU has no bf16 x bf16 -> f32 batched dot: explicit dequant.
        want = np.asarray(x, np.float32) @ _dequant(lp["w"], lp["w_scale"])
    else:
        want = np.asarray(JM._dot(x, jlp, "w", use_pallas=False))
    tdt = getattr(torch, dtype)
    tlp = {k: _t(np.asarray(v, np.float32)).to(tdt)
           if v.dtype == jdt else _t(np.asarray(v)) for k, v in jlp.items()}
    got = TM._dot(_t(np.asarray(x, np.float32)).to(tdt), tlp, "w")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-4)


# -- the model ----------------------------------------------------------------

# debug-tiny at both rungs, then debug-moe (random norm weights) at both.
MODELS = METHODS + ("moe-int8", "moe-int4")


def _weights(model, seed):
    """(JAX config, port config, numpy params): JAX's quantize_params of a
    dense weight set of ``model``."""
    method = model.removeprefix("moe-")
    if model.startswith("moe-"):
        jcfg, tcfg = variant_cfgs("moe", quantization=method,
                                  quant_group_size=GS)
        dense = variant_params(jcfg.replace(quantization=None), seed)
    else:
        jcfg, tcfg = _cfgs(method)
        dense = jax.tree.map(np.asarray, JM.init_params(
            jax_model("debug-tiny"), jax.random.key(seed)))
    return jcfg, tcfg, JQ.quantize_params(dense, method, GS)


@pytest.fixture(scope="module", params=MODELS)
def qmodel(request):
    """One quantized weight set (JAX's quantize_params of a dense one) in
    both packages, plus a random starting pool."""
    jcfg, tcfg, np_params = _weights(request.param, 2)
    jp, tp = both_packages(jcfg, tcfg, np_params)
    rng = np.random.default_rng(0)
    kd = tcfg.num_kv_heads * tcfg.head_dim
    pool = [rng.standard_normal((tcfg.num_layers, P, PS, kd)).astype(
        np.float32) for _ in range(2)]
    return jcfg, tcfg, jp, tp, pool


def _decode_meta():
    tables = np.array([[1, 2, 3], [4, 5, 0], [6, 7, 8], [0, 0, 0]], np.int32)
    pos = np.array([5, 12, 20, 0], np.int32)    # row 3 is padding (ctx 0)
    ctx = np.array([6, 13, 21, 0], np.int32)
    slots = np.array([t[p // PS] * PS + p % PS
                      for t, p in zip(tables, pos)], np.int32)
    slots[3] = 0
    return tables, pos, ctx, slots


def _run_both(kind, jcfg, tcfg, jp, tp, pool):
    rng = np.random.default_rng(3)
    jkv = JKV(k=jnp.asarray(pool[0]), v=jnp.asarray(pool[1]))
    tkv = TKV(k=_t(pool[0].copy()), v=_t(pool[1].copy()))
    if kind == "prefill":
        lens, T = [10, 17, 8], 40
        seg = np.full(T, -1, np.int32)
        pos = np.zeros(T, np.int32)
        slots = np.zeros(T, np.int32)
        last, o, page = [], 0, 1
        for s, n in enumerate(lens):
            seg[o:o + n], pos[o:o + n] = s, np.arange(n)
            slots[o:o + n] = page * PS + np.arange(n)
            page += -(-n // PS)
            last.append(o + n - 1)
            o += n
        arrs = (seg, pos, slots, np.array(last, np.int32))
        tok = rng.integers(0, tcfg.vocab_size, T).astype(np.int32)
        jout = JM.forward_prefill(jp, jcfg, jnp.asarray(tok), JM.PrefillMeta(
            *map(jnp.asarray, arrs)), jkv, use_pallas=False)
        tout = TM.forward_prefill(tp, tcfg, _t(tok), TM.PrefillMeta(
            *map(_t, arrs)), tkv)
    elif kind == "decode":
        tables, pos, ctx, slots = _decode_meta()
        tok = np.array([3, 77, 500, 0], np.int32)
        jout = JM.forward_decode(jp, jcfg, jnp.asarray(tok), JM.DecodeMeta(
            *map(jnp.asarray, (pos, slots, tables, ctx))), jkv,
            use_pallas=False)
        tout = TM.forward_decode(tp, tcfg, _t(tok), TM.DecodeMeta(
            *map(_t, (pos, slots, tables, ctx))), tkv)
    else:   # mixed: an 11-token chunk over 9 history tokens + 4 decode rows
        Tp, chunk, hist = 16, 11, 9
        tables, dpos, ctx, dslots = _decode_meta()
        T = Tp + len(dpos)
        tok = rng.integers(0, tcfg.vocab_size, T).astype(np.int32)
        chunk_pages = np.array([14, 15, 16], np.int32)
        cpt = np.zeros((1, 4), np.int32)
        cpt[0, :3] = chunk_pages
        seg = np.full(T, -1, np.int32)
        seg[:chunk] = 0
        pos = np.zeros(T, np.int32)
        pos[:chunk] = hist + np.arange(chunk)
        pos[Tp:] = dpos
        slots = np.zeros(T, np.int32)
        cp = pos[:chunk]
        slots[:chunk] = chunk_pages[cp // PS] * PS + cp % PS
        slots[Tp:] = dslots
        lidx = np.array([Tp, Tp + 1, Tp + 2, chunk - 1], np.int32)
        jout = JM.forward_mixed(jp, jcfg, jnp.asarray(tok), JM.MixedMeta(
            *map(jnp.asarray, (seg, pos, slots, lidx, cpt)), jnp.int32(hist),
            jnp.asarray(tables), jnp.asarray(ctx)), jkv, use_pallas=False,
            use_pallas_hist=False)
        tout = TM.forward_mixed(tp, tcfg, _t(tok), TM.MixedMeta(
            *map(_t, (seg, pos, slots, lidx, cpt)), hist, _t(tables),
            _t(ctx)), tkv)
    return jout, tout


@pytest.mark.parametrize("kind", ["prefill", "decode", "mixed"])
def test_forward_logits_match_jax(qmodel, kind):
    jcfg, tcfg, jp, tp, pool = qmodel
    (jn, _, jh), (tn, _, th) = _run_both(kind, jcfg, tcfg, jp, tp, pool)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL, rtol=0)
    jl = np.asarray(JM.compute_logits(jp, jcfg, jn, use_pallas=False))
    tl = TM.compute_logits(tp, tcfg, tn)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), jl, atol=ATOL, rtol=0)


def test_moe_int4_experts_reach_the_kernel_as_2d_slices(monkeypatch):
    """Each int4 expert matmul reaches ``int4_matmul`` (the kernel on the
    card) as one contiguous 2-D weight slice and its 2-D scales: per
    layer 4 attention + 3 x E expert calls, then the head."""
    _, tcfg = variant_cfgs("moe", quantization="int4", quant_group_size=GS)
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    seen = []

    def record(x, w, scale):
        seen.append((tuple(w.shape), w.is_contiguous(), scale.dim()))
        return TQ.int4_matmul_plain(x, w, scale)

    monkeypatch.setattr(TQ, "int4_matmul", record)
    tables, pos, ctx, slots = _decode_meta()
    kd = tcfg.num_kv_heads * tcfg.head_dim
    kv = TKV(k=torch.zeros(tcfg.num_layers, P, PS, kd),
             v=torch.zeros(tcfg.num_layers, P, PS, kd))
    h, _, _ = TM.forward_decode(tp, tcfg, _t(np.array([3, 7, 9, 0],
                                                      np.int32)),
                                TM.DecodeMeta(*map(_t, (pos, slots, tables,
                                                        ctx))), kv)
    TM.compute_logits(tp, tcfg, h)
    E, L, d, ff = 4, 2, 128, 256
    assert len(seen) == L * (4 + 3 * E) + 1
    experts = [s for s in seen if s[0] in ((d // 2, ff), (ff // 2, d))]
    assert len(experts) == L * 3 * E
    assert all(contig and sdim == 2 for _, contig, sdim in seen)


def test_init_params_quantized_layout_and_seed():
    """Random quantized init: the stored layouts of the config's rung,
    int8 codes in range, f32 scales, and a function of the seed."""
    for method in METHODS:
        _, cfg = _cfgs(method)
        a = TM.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
        b = TM.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
        layers, top = TM.param_layouts(cfg)
        d, nh_hd = cfg.hidden_size, cfg.num_heads * cfg.head_dim
        L = cfg.num_layers
        if method == "int4":
            assert layers["wq"] == ((L, d // 2, nh_hd), "int8")
            assert layers["wq_scale"] == ((L, d // GS, nh_hd), "scale")
        else:
            assert layers["wq"] == ((L, d, nh_hd), "int8")
            assert layers["wq_scale"] == ((L, nh_hd), "scale")
        for got, want in ((a["layers"], layers), (a, top)):
            for name, (shape, kind) in want.items():
                t = got[name]
                assert tuple(t.shape) == shape, name
                assert t.dtype == {"int8": torch.int8, "scale": torch.float32,
                                   "float": cfg.torch_dtype}[kind], name
        assert int(a["layers"]["w_up"].min()) >= (-128 if method == "int4"
                                                   else -127)
        assert all(torch.equal(a["layers"][k], b["layers"][k])
                   for k in a["layers"])
        assert torch.equal(a["lm_head"], b["lm_head"])
    with pytest.raises(ValueError, match="unsupported quantization"):
        TM.check_supported(get_model_config("debug-tiny").replace(
            quantization="fp8"))


def test_params_from_numpy_rejects_float_codes():
    _, tcfg = _cfgs("int8")
    np_params = jax.tree.map(lambda t: t.numpy(), TM.init_params(
        tcfg, torch.Generator().manual_seed(0), "cpu"))
    TM.params_from_numpy(np_params, tcfg, "cpu")      # the int8 layout loads
    np_params["layers"]["wq"] = np_params["layers"]["wq"].astype(np.float32)
    with pytest.raises(ValueError, match="must be int8"):
        TM.params_from_numpy(np_params, tcfg, "cpu")


# -- the engine ---------------------------------------------------------------

# tests/test_torch_engine.py's workload, with one prefill and one decode
# bucket: the reference engine then compiles five programs, not a dozen.
CACHE = dict(page_size=8, num_pages=24)
SCHED = dict(max_num_seqs=4, max_prefill_tokens=64, decode_buckets=(4,),
             prefill_buckets=(64,), decode_window=4)
PROMPT_LENS = (5, 40, 100, 17, 9, 70)
MAX_TOKENS = 20


@pytest.mark.parametrize("method", MODELS)
def test_greedy_engine_matches_jax_engine(method, monkeypatch):
    """The test_torch_engine workload (chunked prefill, mixed steps, decode
    windows, preemption) on random quantized weights (debug-tiny: JAX's
    quantized init; debug-moe: quantize_params of random dense experts):
    token-identical."""
    if method in METHODS:
        jcfg, tcfg = _cfgs(method)
        np_params = jax.tree.map(np.asarray, JM.init_params(
            jcfg, jax.random.key(3)))
    else:
        jcfg, tcfg, np_params = _weights(method, 6)
    jp, tp = both_packages(jcfg, tcfg, np_params)
    rng = np.random.default_rng(0)
    prompts = [[int(x) for x in rng.integers(1, 500, n)] for n in PROMPT_LENS]
    jeng = JaxEngine(JEngineConfig(model=jcfg, cache=JCache(**CACHE),
                                   scheduler=JSched(**SCHED)), params=jp)
    want = [o.output_token_ids for o in jeng.generate(
        prompts, JaxParams(max_tokens=MAX_TOKENS, temperature=0.0))]
    calls = {"forward_prefill": 0, "forward_prefill_hist": 0,
             "forward_mixed": 0, "forward_decode": 0}

    def counted(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    for name in calls:
        monkeypatch.setattr(TM, name, counted(name, getattr(TM, name)))
    eng = LLMEngine(EngineConfig(model=tcfg, cache=CacheConfig(**CACHE),
                                 scheduler=SchedulerConfig(**SCHED)),
                    params=tp, device="cpu")
    got = [o.output_token_ids for o in eng.generate(
        prompts, SamplingParams(max_tokens=MAX_TOKENS, temperature=0.0))]
    assert got == want
    assert all(n > 0 for n in calls.values()), calls
    assert eng.scheduler.num_preemptions > 0
