"""The port's KV wire and its HTTP client, engine-free, on the CPU.

- The JAX package's engine-free wire cases, re-pointed at the port's
  ``serving/handoff.py`` and ``serving/fleet_cache.py`` (K/V as torch
  tensors): ``test_disagg.py``'s ``TestHandoffWireCodec`` and
  ``TestBoundedFetch`` (its stub prefill replica on the port's
  ``http.Server``, fetched by the port's client), ``test_fleet_cache.py``'s
  ``TestPullPolicy``, ``TestPrefixStreamCodec`` and ``TestSpillQueue``,
  ``test_wire_integrity.py``'s ``TestIntegrityCodec`` and
  ``TestPeerScoreboard``, and ``test_migration.py``'s
  ``TestMigrationStore``.
- Byte identity with the JAX codec: for states drawn from a seed (fp32 and
  bf16, integrity on and off; handoff frame, prefix stream, spill frame)
  the port's bytes equal the JAX package's, and each package decodes the
  other's frames to equal arrays.
- The client of ``serving/http.py``: Content-Length, chunked and
  read-to-EOF bodies, the wall bound, https refused cleanly by a plain
  peer, and the bounds on a response's lines and headers.
- The import pin: ``serving.api_server``, ``serving.handoff`` and
  ``serving.fleet_cache`` load none of ``jax``, ``aiohttp``, ``ml_dtypes``
  or the JAX package.
"""

import asyncio
import json
import struct
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

import kubernetes_gpu_cluster_tpu.serving.handoff as J
from kubernetes_gpu_cluster_tpu_torch.config import get_model_config
from kubernetes_gpu_cluster_tpu_torch.serving.fleet_cache import (
    DEFAULT_FLOPS, PEER_QUARANTINE_S, PEER_QUARANTINE_THRESHOLD,
    PEER_SCORE_START, PeerScoreboard, PullPolicy, SpillQueue,
    build_pull_policy, kv_bytes_per_token, prefill_flops_per_token)
from kubernetes_gpu_cluster_tpu_torch.serving.handoff import (
    HANDOFF_MAGIC, MigrationStore, PrefixStreamDecoder, ProtocolSkewError,
    WireCorruptionError, decode_handoff, decode_spill_frame, encode_handoff,
    encode_prefix_frames, encode_spill_frame, fetch_handoff,
    handoff_request_body, push_handoff, verify_import_state)
from kubernetes_gpu_cluster_tpu_torch.serving.http import (
    MAX_HEADERS, MAX_LINE, Application, ClientError, ClientSession,
    Response, Server, StreamResponse)

REPO = Path(__file__).resolve().parents[1]


def _kv(n_pages=5, dtype="float32", seed=0):
    """(k, v) as port tensors [2, n, 16, 64], drawn from ``seed``."""
    k = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (2, n_pages, 16, 64)).astype(np.float32))
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return k.to(dt), (k + 1).to(dt)


def _state(n_pages=5, dtype="float32", **extra):
    k, v = _kv(n_pages, dtype)
    st = {"model": "debug-tiny", "page_size": 16, "dtype": dtype,
          "matched_tokens": n_pages * 16,
          "prompt_token_ids": list(range(n_pages * 16)),
          "k": k, "v": v}
    st.update(extra)
    return st


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A port tensor as the JAX codec wants it (bf16 as ml_dtypes)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _jax_state(state: dict) -> dict:
    return {k: (_to_numpy(v) if k in ("k", "v") else v)
            for k, v in state.items()}


def _same(np_arr, t: torch.Tensor) -> bool:
    """The JAX side's numpy array and the port's tensor hold equal bytes
    in the same dtype and shape."""
    return (str(np_arr.dtype) == str(t.dtype).removeprefix("torch.")
            and tuple(np_arr.shape) == tuple(t.shape)
            and np_arr.tobytes() == t.contiguous().view(torch.uint8)
            .numpy().tobytes())


def _header_of(blob) -> dict:
    """A handoff frame's JSON header, parsed without the codec."""
    m = len(HANDOFF_MAGIC)
    (hlen,) = struct.unpack(">I", bytes(blob[m:m + 4]))
    return json.loads(bytes(blob[m + 4:m + 4 + hlen]))


# -- test_disagg.py --------------------------------------------------------

class TestHandoffWireCodec:
    def _state(self, dtype="float32"):
        k = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (2, 3, 16, 64)).astype(np.float32)).to(
            {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype])
        return {"model": "debug-tiny", "page_size": 16, "dtype": dtype,
                "prompt_token_ids": [1, 2, 3], "output_token_ids": [7],
                "output_logprobs": [-0.5], "output_top_logprobs": [],
                "k": k, "v": k + 1}

    def test_roundtrip(self):
        state = self._state()
        out = decode_handoff(encode_handoff(state))
        assert out["prompt_token_ids"] == [1, 2, 3]
        assert out["output_token_ids"] == [7]
        assert torch.equal(out["k"], state["k"])
        assert torch.equal(out["v"], state["v"])

    def test_bfloat16_roundtrip(self):
        """Served pools on the card are bf16: the codec round-trips them
        through a byte view, with no ml_dtypes."""
        state = self._state("bfloat16")
        out = decode_handoff(encode_handoff(state))
        assert out["k"].dtype == torch.bfloat16
        assert torch.equal(out["k"], state["k"])

    def test_corrupt_frames_rejected(self):
        data = encode_handoff(self._state())
        with pytest.raises(ValueError, match="magic"):
            decode_handoff(b"NOTAKV" + data[6:])
        with pytest.raises(ValueError, match="!= 2 x"):
            decode_handoff(data[:-7])          # truncated payload
        with pytest.raises(ValueError):
            decode_handoff(data[:10])          # truncated header

    def test_request_body_forwards_sampling_and_tenant_fields_only(self):
        body = {"prompt": "ignored", "temperature": 0.5, "seed": 3,
                "stream": True, "max_tokens": 99, "user": "u"}
        fwd = handoff_request_body([1, 2], body)
        assert fwd == {"prompt_token_ids": [1, 2], "temperature": 0.5,
                       "seed": 3, "user": "u"}


class TestBoundedFetch:
    """The decode side's pull is bounded in bytes and never trusts an
    oversized response (a stub prefill replica on the port's server,
    fetched by the port's client)."""

    def test_oversized_blob_rejected(self):
        async def scenario():
            async def kv(request):
                return Response(body=b"x" * 4096)

            app = Application()
            app.add_post("/internal/kv_handoff", kv)
            server = Server(app)
            await server.start("127.0.0.1", 0)
            url = f"http://127.0.0.1:{server.port}"
            sess = ClientSession()
            try:
                with pytest.raises(RuntimeError, match="bound"):
                    await fetch_handoff(sess, url, {}, "rid",
                                        max_bytes=1024, timeout_s=5)
                data = await fetch_handoff(sess, url, {}, "rid",
                                           max_bytes=8192, timeout_s=5)
                assert len(data) == 4096
                # Non-200 raises with a bounded error peek.
                with pytest.raises(RuntimeError, match="404"):
                    await fetch_handoff(sess, url + "/nope", {}, "rid",
                                        max_bytes=8192, timeout_s=5)
                # The push direction: a non-200 is a RuntimeError naming it.
                with pytest.raises(RuntimeError, match="rejected 404"):
                    await push_handoff(sess, url + "/nope", b"blob", "rid",
                                       timeout_s=5)
            finally:
                await sess.close()
                await server.close()
        asyncio.run(scenario())

    def test_streamed_blob_over_the_bound_rejected(self):
        """A chunked response declares no length: the bounded read
        (``read(max_bytes + 1)``) still refuses it."""
        async def scenario():
            async def kv(request):
                resp = StreamResponse()
                await resp.prepare(request)
                for _ in range(4):
                    await resp.write(b"y" * 1000)
                return resp

            app = Application()
            app.add_post("/internal/kv_handoff", kv)
            server = Server(app)
            await server.start("127.0.0.1", 0)
            url = f"http://127.0.0.1:{server.port}"
            try:
                with pytest.raises(RuntimeError, match="exceeds the local"):
                    await fetch_handoff(ClientSession(), url, {}, "rid",
                                        max_bytes=3000, timeout_s=5)
                data = await fetch_handoff(ClientSession(), url, {}, "rid",
                                           max_bytes=4000, timeout_s=5)
                assert bytes(data) == b"y" * 4000
            finally:
                await server.close()
        asyncio.run(scenario())


# -- test_fleet_cache.py ---------------------------------------------------

class TestPullPolicy:
    def _policy(self, link=1e9, flops=1e9, kvb=1000.0, fpt=1000.0, mn=16):
        return PullPolicy(link_bytes_per_s=link, flops_per_s=flops,
                          kv_bytes_per_token=kvb, flops_per_token=fpt,
                          min_tokens=mn)

    def test_fast_link_slow_compute_pulls(self):
        p = self._policy(link=1e9, flops=1e6)
        assert p.pull_beats_recompute(64)

    def test_slow_link_fast_compute_skips(self):
        p = self._policy(link=1e3, flops=1e9)
        assert not p.pull_beats_recompute(64)

    def test_sub_page_matches_never_pull(self):
        p = self._policy(link=1e12, flops=1.0, mn=16)
        assert not p.pull_beats_recompute(15)
        assert p.pull_beats_recompute(16)

    def test_build_policy_mirrors_roofline_accounting(self):
        mcfg = get_model_config("debug-tiny")
        pol = build_pull_policy(mcfg, page_size=16, itemsize=4,
                                backend="cpu")
        assert pol.kv_bytes_per_token == kv_bytes_per_token(mcfg, 4)
        assert pol.flops_per_token == prefill_flops_per_token(mcfg)
        assert pol.min_tokens == 16
        h, inter = mcfg.hidden_size, mcfg.intermediate_size
        attn = (h * mcfg.num_heads * mcfg.head_dim
                + 2 * h * mcfg.num_kv_heads * mcfg.head_dim
                + mcfg.num_heads * mcfg.head_dim * h)
        assert pol.flops_per_token == 2 * mcfg.num_layers * (
            attn + 3 * h * inter)

    def test_device_defaults_and_env_overrides(self, monkeypatch):
        """The port prices recompute by the engine's device type: the
        card's own measured figure for cuda, the reference's for cpu, and
        no TPU entry; the two env knobs still override."""
        assert set(DEFAULT_FLOPS) == {"cuda", "cpu"}
        mcfg = get_model_config("llama-3-8b")
        pol = build_pull_policy(mcfg, 16, 2, "cuda")
        assert pol.flops_per_s == DEFAULT_FLOPS["cuda"]
        assert build_pull_policy(mcfg, 16, 2, "cpu").flops_per_s == 5e9
        monkeypatch.setenv("KGCT_FLEET_FLOPS", "1e12")
        monkeypatch.setenv("KGCT_FLEET_BW_GBPS", "100")
        pol = build_pull_policy(mcfg, 16, 2, "cuda")
        assert pol.flops_per_s == 1e12
        assert pol.link_bytes_per_s == 100e9


class TestPrefixStreamCodec:
    def test_roundtrip_across_dribbled_feeds(self):
        state = _state()
        blob = b"".join(bytes(p) for p in
                        encode_prefix_frames(state, chunk_pages=2))
        dec = PrefixStreamDecoder()
        got = []
        for i in range(0, len(blob), 1000):
            got.extend(dec.feed(blob[i:i + 1000]))
        assert dec.done and dec.header["matched_tokens"] == 80
        assert torch.equal(torch.cat([ck for ck, _ in got], 1), state["k"])
        assert torch.equal(torch.cat([cv for _, cv in got], 1), state["v"])
        assert [ck.shape[1] for ck, _ in got] == [2, 2, 1]

    def test_corrupt_frames_rejected(self):
        blob = b"".join(bytes(p) for p in encode_prefix_frames(_state()))
        with pytest.raises(ValueError, match="magic"):
            PrefixStreamDecoder().feed(b"NOTAPF1!" + blob[8:])
        with pytest.raises(ValueError, match="trailing"):
            PrefixStreamDecoder().feed(blob + b"x")
        dec = PrefixStreamDecoder()
        dec.feed(blob[:-5])
        assert not dec.done      # truncated: never silently complete

    def test_spill_frame_roundtrip(self):
        k, v = _kv(1, seed=1)
        blob = encode_spill_frame("ab" * 16, k, v, "debug-tiny", 16)
        digest, header, k2, v2 = decode_spill_frame(blob)
        assert digest == "ab" * 16
        assert header["model"] == "debug-tiny"
        assert torch.equal(k2, k) and torch.equal(v2, v)
        with pytest.raises(ValueError):
            decode_spill_frame(blob[:-3])


class TestSpillQueue:
    def test_bounded_drop_oldest(self):
        q = SpillQueue(cap=2)
        assert q.offer("a", None, None)
        assert q.offer("b", None, None)
        assert not q.offer("c", None, None)   # displaced the oldest
        assert q.dropped == 1
        assert q.pop()[0] == "b"
        assert q.pop()[0] == "c"
        assert q.pop() is None


# -- test_wire_integrity.py ------------------------------------------------

class TestIntegrityCodec:
    def test_integrity_off_is_pre_extension_wire_dialect(self):
        st = _state()
        blob = bytes(encode_handoff(st))
        hdr = _header_of(blob)
        assert "page_crc" not in hdr and "frame_crc" not in hdr
        dec = decode_handoff(blob)
        assert "_integrity" not in dec
        verify_import_state(dec)  # no-op without the stash
        assert torch.equal(dec["k"], st["k"])
        part0 = next(iter(encode_prefix_frames(_state())))
        phdr = json.loads(bytes(part0[12:]))
        assert "page_crc" not in phdr and "frame_crc" not in phdr

    def test_handoff_roundtrip_with_integrity(self):
        st = _state()
        blob = encode_handoff(st, integrity=True)
        hdr = _header_of(blob)
        assert len(hdr["page_crc"]["k"]) == 5 and "frame_crc" in hdr
        dec = decode_handoff(blob)
        assert torch.equal(dec["k"], st["k"])
        assert torch.equal(dec["v"], st["v"])
        assert "_integrity" in dec
        verify_import_state(dec)
        assert "_integrity" not in dec

    def test_require_integrity_rejects_pre_integrity_frame(self):
        blob = encode_handoff(_state())
        with pytest.raises(ProtocolSkewError, match="pre-integrity"):
            decode_handoff(blob, require_integrity=True)

    def test_flipped_payload_byte_detected_and_named(self):
        blob = bytearray(encode_handoff(_state(), integrity=True))
        blob[-1] ^= 0xFF  # last byte = v payload, final page
        with pytest.raises(WireCorruptionError,
                           match=r"v page 4 checksum mismatch"):
            decode_handoff(blob)

    def test_tampered_crc_list_fails_frame_digest(self):
        blob = bytes(encode_handoff(_state(), integrity=True))
        hdr = _header_of(blob)
        hdr["page_crc"]["k"][0] ^= 1
        hb = json.dumps(hdr).encode()
        m = len(HANDOFF_MAGIC)
        (hlen,) = struct.unpack(">I", blob[m:m + 4])
        forged = (HANDOFF_MAGIC + struct.pack(">I", len(hb)) + hb
                  + blob[m + 4 + hlen:])
        with pytest.raises(WireCorruptionError,
                           match="frame digest mismatch"):
            decode_handoff(forged)

    def test_import_seam_recheck_catches_post_decode_rot(self):
        dec = decode_handoff(encode_handoff(_state(), integrity=True))
        dec["k"][0, 2, 0, 0] += 1.0  # bit-rot while parked host-side
        with pytest.raises(WireCorruptionError,
                           match="k page 2 checksum mismatch"):
            verify_import_state(dec)

    def test_prefix_stream_verifies_incrementally(self):
        parts = [bytearray(p) for p in
                 encode_prefix_frames(_state(), chunk_pages=2,
                                      integrity=True)]
        assert len(parts) == 4  # header + 3 slabs (2+2+1 pages)
        parts[1][10] ^= 0xFF  # first slab -> pages 0-1
        dec = PrefixStreamDecoder()
        dec.feed(bytes(parts[0]))
        with pytest.raises(WireCorruptionError, match="page [01]"):
            dec.feed(bytes(parts[1]))

    def test_prefix_stream_clean_roundtrip_with_integrity(self):
        st = _state()
        blob = b"".join(bytes(p) for p in
                        encode_prefix_frames(st, chunk_pages=2,
                                             integrity=True))
        dec = PrefixStreamDecoder(require_integrity=True)
        got = []
        for i in range(0, len(blob), 1000):
            got.extend(dec.feed(blob[i:i + 1000]))
        assert dec.done
        assert torch.equal(torch.cat([ck for ck, _ in got], 1), st["k"])

    def test_prefix_stream_skew_raises_at_header(self):
        parts = list(encode_prefix_frames(_state(), chunk_pages=2))
        with pytest.raises(ProtocolSkewError, match="pre-integrity"):
            PrefixStreamDecoder(require_integrity=True).feed(
                bytes(parts[0]))

    def test_spill_frame_roundtrip_corrupt_and_skew(self):
        k, v = _kv(1, seed=1)
        frame = encode_spill_frame("ab" * 32, k, v, "debug-tiny", 16,
                                   integrity=True)
        digest, header, gk, gv = decode_spill_frame(
            frame, require_integrity=True)
        assert digest == "ab" * 32 and torch.equal(gk, k)
        bad = bytearray(frame)
        bad[-1] ^= 0xFF
        with pytest.raises(WireCorruptionError, match="checksum mismatch"):
            decode_spill_frame(bytes(bad))
        plain = encode_spill_frame("ab" * 32, k, v, "debug-tiny", 16)
        with pytest.raises(ProtocolSkewError):
            decode_spill_frame(plain, require_integrity=True)

    def test_bfloat16_pages_checksum_cleanly(self):
        st = _state(dtype="bfloat16")
        dec = decode_handoff(encode_handoff(st, integrity=True))
        verify_import_state(dec)
        assert torch.equal(dec["k"], st["k"])


class TestPeerScoreboard:
    def _board(self):
        t = [0.0]
        sb = PeerScoreboard(clock=lambda: t[0])
        return sb, t

    def test_corruption_quarantines_instantly(self):
        sb, _ = self._board()
        assert sb.score("p") == PEER_SCORE_START
        assert sb.record_corruption("p") is True
        assert sb.quarantined("p") and sb.quarantines == {"p": 1}
        assert sb.retry_after_s("p") == pytest.approx(PEER_QUARANTINE_S)

    def test_timeouts_take_three(self):
        sb, _ = self._board()
        assert not sb.record_timeout("p") and not sb.quarantined("p")
        assert not sb.record_timeout("p") and not sb.quarantined("p")
        assert sb.record_timeout("p") is True
        assert sb.quarantined("p")
        assert sb.score("p") < PEER_QUARANTINE_THRESHOLD

    def test_window_extension_does_not_recount(self):
        sb, t = self._board()
        assert sb.record_corruption("p")
        t[0] = 10.0
        assert sb.record_corruption("p") is False
        assert sb.quarantines == {"p": 1}
        assert sb.retry_after_s("p") == pytest.approx(PEER_QUARANTINE_S)

    def test_window_decays_and_probe_recovers(self):
        sb, t = self._board()
        sb.record_corruption("p")
        t[0] = PEER_QUARANTINE_S / 2
        assert sb.retry_after_s("p") == pytest.approx(PEER_QUARANTINE_S / 2)
        t[0] = PEER_QUARANTINE_S + 1
        assert not sb.quarantined("p") and sb.retry_after_s("p") == 0.0
        sb.record_ok("p")
        assert sb.score("p") >= PEER_QUARANTINE_THRESHOLD
        assert not sb.quarantined("p")
        assert sb.record_corruption("p") is True
        assert sb.quarantines == {"p": 2}

    def test_refailure_after_lapse_recounts(self):
        sb, t = self._board()
        sb.record_corruption("p")
        t[0] = PEER_QUARANTINE_S + 1
        assert sb.record_corruption("p") is True
        assert sb.quarantines == {"p": 2} and sb.quarantined("p")

    def test_score_recovery_is_capped(self):
        sb, _ = self._board()
        sb.record_timeout("p")
        for _ in range(5):
            sb.record_ok("p")
        assert sb.score("p") == PEER_SCORE_START


# -- test_migration.py -----------------------------------------------------

class TestMigrationStore:
    def test_cap_evicts_oldest(self):
        store = MigrationStore(cap=3, ttl_s=60.0)
        for i in range(5):
            store.put(f"r{i}", {"i": i})
        assert len(store) == 3
        assert store.pop("r0") is None and store.pop("r1") is None
        assert store.pop("r4") == {"i": 4}

    def test_ttl_expires(self):
        now = [0.0]
        store = MigrationStore(cap=4, ttl_s=10.0, clock=lambda: now[0])
        store.put("a", {"x": 1})
        now[0] = 5.0
        store.put("b", {"x": 2})
        now[0] = 10.5
        assert store.pop("a") is None
        assert store.pop("b") == {"x": 2}

    def test_repush_replaces_and_pop_consumes(self):
        store = MigrationStore(cap=2, ttl_s=60.0)
        store.put("a", {"v": 1})
        store.put("a", {"v": 2})
        assert len(store) == 1
        assert store.pop("a") == {"v": 2}
        assert store.pop("a") is None


# -- byte identity with the JAX codec --------------------------------------

CASES = [pytest.param(dt, integ, id=f"{dt}-{'crc' if integ else 'plain'}")
         for dt in ("float32", "bfloat16") for integ in (False, True)]


def _handoff_state(dtype):
    return _state(dtype=dtype, output_token_ids=[7, 9],
                  output_logprobs=[-0.5, -1.25e-3],
                  output_top_logprobs=[[[7, -0.5], [3, -2.0]]],
                  sampling={"max_tokens": 8, "temperature": 0.0,
                            "stop_token_ids": [2], "seed": None},
                  mid_stream=True)


@pytest.mark.parametrize("dtype,integ", CASES)
def test_handoff_frame_bytes_equal_jax(dtype, integ):
    st = _handoff_state(dtype)
    port = encode_handoff(st, integrity=integ)
    jax_frame = J.encode_handoff(_jax_state(st), integrity=integ)
    assert bytes(port) == bytes(jax_frame)
    # Each package decodes the other's frame to the same arrays.
    mine = decode_handoff(jax_frame, require_integrity=integ)
    theirs = J.decode_handoff(port, require_integrity=integ)
    for key in ("k", "v"):
        assert torch.equal(mine[key], st[key])
        assert _same(theirs[key], st[key])
    verify_import_state(mine)
    J.verify_import_state(theirs)
    assert {k: v for k, v in mine.items() if k not in ("k", "v")} == \
        {k: v for k, v in theirs.items() if k not in ("k", "v")}


@pytest.mark.parametrize("dtype,integ", CASES)
def test_prefix_stream_bytes_equal_jax(dtype, integ):
    st = _state(n_pages=7, dtype=dtype, start_tokens=16)
    port = b"".join(bytes(p) for p in
                    encode_prefix_frames(st, chunk_pages=3, integrity=integ))
    jax_stream = b"".join(bytes(p) for p in J.encode_prefix_frames(
        _jax_state(st), chunk_pages=3, integrity=integ))
    assert port == jax_stream
    dec, jdec = (PrefixStreamDecoder(require_integrity=integ),
                 J.PrefixStreamDecoder(require_integrity=integ))
    mine, theirs = [], []
    for i in range(0, len(port), 777):
        mine += dec.feed(jax_stream[i:i + 777])
        theirs += jdec.feed(port[i:i + 777])
    assert dec.done and jdec.done and dec.header == jdec.header
    assert torch.equal(torch.cat([k for k, _ in mine], 1), st["k"])
    assert _same(np.concatenate([v for _, v in theirs], 1), st["v"])


@pytest.mark.parametrize("dtype,integ", CASES)
def test_spill_frame_bytes_equal_jax(dtype, integ):
    k, v = _kv(1, dtype, seed=5)
    port = encode_spill_frame("cd" * 32, k, v, "debug-tiny", 16,
                              integrity=integ)
    jax_frame = J.encode_spill_frame("cd" * 32, _to_numpy(k), _to_numpy(v),
                                     "debug-tiny", 16, integrity=integ)
    assert port == jax_frame
    digest, header, gk, gv = decode_spill_frame(jax_frame,
                                                require_integrity=integ)
    jdigest, jheader, jk, jv = J.decode_spill_frame(port,
                                                    require_integrity=integ)
    assert digest == jdigest == "cd" * 32 and header == jheader
    assert torch.equal(gk, k) and torch.equal(gv, v)
    assert _same(jk, k) and _same(jv, v)


# -- the client ------------------------------------------------------------

async def _raw_server(payload: bytes, then_close: bool = True):
    """A peer that answers any request with ``payload`` verbatim."""
    async def handle(reader, writer):
        await reader.read(65536)
        writer.write(payload)
        await writer.drain()
        if then_close:
            writer.close()
        else:
            await asyncio.sleep(30)
    server = await asyncio.start_server(handle, "127.0.0.1", 0)
    return server, server.sockets[0].getsockname()[1]


def _echo_app():
    app = Application(client_max_size=1 << 24)

    async def echo(request):
        return Response(body=bytes(request.body),
                        headers={"X-Seen-Type": request.content_type})

    async def chunked(request):
        resp = StreamResponse(headers={"Content-Type": "text/plain"})
        await resp.prepare(request)
        for i in range(7):
            await resp.write(b"%d" % i * 1000)
        await resp.write_eof()
        return resp

    async def slow(request):
        await asyncio.sleep(5)
        return Response(text="late")

    app.add_post("/echo", echo)
    app.add_get("/chunked", chunked)
    app.add_get("/slow", slow)
    return app


def _with_server(app, fn):
    async def scenario():
        server = Server(app)
        await server.start("127.0.0.1", 0)
        try:
            return await fn(f"http://127.0.0.1:{server.port}",
                            ClientSession())
        finally:
            await server.close()
    return asyncio.run(scenario())


class TestClient:
    def test_content_length_body_both_ways(self):
        body = bytes(range(256)) * 3000

        async def fn(base, sess):
            async with sess.post(base + "/echo", data=body) as r:
                assert r.status == 200
                assert r.content_length == len(body)
                assert r.headers["x-seen-type"] == "application/octet-stream"
                first = await r.read(1000)
                rest = await r.read()
            assert bytes(first + rest) == body
            async with sess.post(base + "/echo", json={"a": [1, 2]}) as r:
                assert r.headers["X-Seen-Type"] == "application/json"
                assert await r.json() == {"a": [1, 2]}
        _with_server(_echo_app(), fn)

    def test_chunked_body_in_pieces(self):
        async def fn(base, sess):
            async with sess.get(base + "/chunked") as r:
                assert r.content_type == "text/plain"
                assert r.content_length is None
                pieces = [p async for p in r.iter_chunked(300)]
            assert max(map(len, pieces)) <= 300
            assert b"".join(pieces) == b"".join(b"%d" % i * 1000
                                                for i in range(7))
        _with_server(_echo_app(), fn)

    def test_body_read_to_eof(self):
        async def scenario():
            server, port = await _raw_server(
                b"HTTP/1.1 200 OK\r\nContent-Type: text/plain\r\n\r\n"
                + b"z" * 5000)
            try:
                async with ClientSession().get(
                        f"http://127.0.0.1:{port}/x", timeout_s=5) as r:
                    assert r.status == 200 and r.content_length is None
                    assert bytes(await r.read()) == b"z" * 5000
            finally:
                server.close()
        asyncio.run(scenario())

    def test_total_timeout(self):
        async def fn(base, sess):
            with pytest.raises(asyncio.TimeoutError):
                async with sess.get(base + "/slow", timeout_s=0.2):
                    pass
        _with_server(_echo_app(), fn)

    def test_timeout_covers_the_body(self):
        """The wall bound runs on while the body is read: a peer that
        stalls mid-body times out too."""
        async def scenario():
            server, port = await _raw_server(
                b"HTTP/1.1 200 OK\r\nContent-Length: 100\r\n\r\nabc",
                then_close=False)
            try:
                with pytest.raises(asyncio.TimeoutError):
                    async with ClientSession().get(
                            f"http://127.0.0.1:{port}/", timeout_s=0.3) as r:
                        await r.read()
            finally:
                server.close()
        asyncio.run(scenario())

    def test_https_to_a_plain_peer_fails_cleanly(self):
        import ssl

        async def fn(base, sess):
            with pytest.raises((ssl.SSLError, ConnectionError)):
                async with sess.get(base.replace("http:", "https:")
                                    + "/chunked", timeout_s=5):
                    pass
        _with_server(_echo_app(), fn)

    @pytest.mark.parametrize("payload,match", [
        (b"HTTP/1.1 200 OK\r\nX-Big: " + b"a" * (MAX_LINE + 10) + b"\r\n\r\n",
         "header line over"),
        (b"HTTP/1.1 200 OK\r\nTransfer-Encoding: chunked\r\n\r\n"
         + b"f" * (MAX_LINE + 10) + b"\r\n", "chunk-size line over"),
        (b"HTTP/1.1 200 OK\r\n"
         + b"".join(b"X-%d: 1\r\n" % i for i in range(MAX_HEADERS + 1))
         + b"\r\n", "too many"),
        (b"HTTP/1.1 200 OK\r\nTransfer-Encoding: chunked\r\n\r\nzz\r\n",
         "malformed chunk size"),
        (b"SPDY/9 200 OK\r\n\r\n", "malformed status line"),
    ], ids=["header-line", "chunk-size-line", "header-count", "chunk-size",
            "status-line"])
    def test_framing_bounds(self, payload, match):
        async def scenario():
            server, port = await _raw_server(payload)
            try:
                with pytest.raises(ClientError, match=match):
                    async with ClientSession().get(
                            f"http://127.0.0.1:{port}/", timeout_s=5) as r:
                        await r.read()
            finally:
                server.close()
        asyncio.run(scenario())


def test_fleet_modules_import_no_jax_aiohttp_or_ml_dtypes():
    """The card's machine has none of them: the server, the codec and the
    fleet cache load none of ``jax``, ``aiohttp``, ``ml_dtypes`` or the JAX
    package."""
    code = (
        "import sys\n"
        "import kubernetes_gpu_cluster_tpu_torch.serving.api_server\n"
        "import kubernetes_gpu_cluster_tpu_torch.serving.handoff\n"
        "import kubernetes_gpu_cluster_tpu_torch.serving.fleet_cache\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'aiohttp', 'ml_dtypes', "
        "'kubernetes_gpu_cluster_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
