"""KV wire protocol of the fleet plane: the JAX package's
``serving/handoff.py`` on torch tensors, byte for byte the same wire.

A decode replica pulls a finished prefill's committed KV pages plus the
sequence state from the prefill replica's ``POST /internal/kv_handoff`` and
imports them as committed history (``LLMEngine.import_request``, no
prefill replay); a draining replica pushes a running sequence the same way;
the fleet prefix cache streams cached prefix pages and spills evicted ones.
This module owns the parts the api_server composes:

- the frame codecs: magic, a bounded JSON header (sequence state + array
  shape, the dtype spelled as the JAX package spells it), then the raw K
  and V bytes. No pickle anywhere: a corrupt payload can fail validation
  but never execute. The port's K/V are CPU tensors; the bytes are read
  and written through a ``uint8`` view, so ``bfloat16`` needs nothing
  beyond torch (the JAX package needs ``ml_dtypes`` for it);
- the integrity extension: with ``integrity=True`` the JSON header carries
  per-page CRC32 checksums (zlib's) over the K|V slabs plus a whole-frame
  digest, verified on decode (incrementally for the streamed prefix
  codec) and again at the import seam by :func:`verify_import_state`. A
  mismatch raises :class:`WireCorruptionError`; a pre-integrity frame at a
  receiver that requires checksums raises :class:`ProtocolSkewError` (both
  ValueError subclasses). Integrity off emits the pre-extension frames;
- the bounded peer calls (:func:`fetch_handoff`, :func:`push_handoff`) on
  the standard-library client of ``serving/http.py``: the response size
  is capped by the local pool's byte size and the exchange by a wall
  bound, so one wedged peer cannot hang or balloon a replica; every
  failure degrades to local recompute, the same tokens, slower.

For the same state the frames equal the JAX codec's byte for byte (the
header is ``json.dumps`` of the same keys in the same order, with Python
scalars), so a mixed fleet of JAX and port replicas interoperates, and each
package decodes the other's frames.

Decoded K/V are copied out of the frame into tensors of their own: the
payload follows a JSON header of any length, so a tensor over the frame
itself would be misaligned for its dtype.
"""

from __future__ import annotations

import json
import struct
import time
import zlib
from typing import Optional

import numpy as np
import torch

from ..engine.kv_cache import dtype_name
from .errors import QOS_TIER_HEADER, REQUEST_ID_HEADER
from .http import ClientSession

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


class WireCorruptionError(ValueError):
    """A frame whose bytes do not match its own declared checksums: a
    bit-flip in transit, a truncation that still parses, or a peer that
    serves stale pages under a fresh header. Subclasses ValueError so every
    degrade-to-recompute catch handles it; callers that care (metrics,
    peer scoreboards) can still tell it apart."""


class ProtocolSkewError(ValueError):
    """A peer speaking the pre-integrity wire dialect to a receiver that
    requires checksums: the negotiation failure is the finding, not worth
    a decode attempt. HTTP seams answer it with a 426-style rejection."""


def _torch_dtype(name: str) -> torch.dtype:
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported KV dtype {name!r}") from None


def _host(t: torch.Tensor) -> torch.Tensor:
    """A contiguous CPU tensor over ``t``'s values (itself when it is one)."""
    return t.detach().to("cpu").contiguous()


def _bytes_of(t: torch.Tensor) -> np.ndarray:
    """``t`` (contiguous, on the host) as a writable numpy ``uint8`` array
    over the same memory, its last axis widened by the element size."""
    return t.view(torch.uint8).numpy()


def _page_crcs(t: torch.Tensor) -> list:
    """Per-page CRC32 of one KV tensor laid out ``[L, n_pages, ps, kd]``:
    page ``p``'s checksum folds over every layer's contiguous ``[ps, kd]``
    slab, exactly the bytes that carry that page on the wire whichever
    codec sent them. Dtype-agnostic (a byte view)."""
    b = _bytes_of(_host(t))
    out = []
    for p in range(b.shape[1]):
        c = 0
        for layer in range(b.shape[0]):
            c = zlib.crc32(b[layer, p], c)
        out.append(c)
    return out


def _frame_crc(k_crcs: list, v_crcs: list, payload_bytes: int) -> int:
    """Whole-frame digest: CRC32 over the packed per-page checksum lists
    plus the payload byte count, so a header whose checksum list was
    altered in transit fails before any per-page compare."""
    packed = struct.pack(f">{len(k_crcs)}I", *k_crcs) \
        + struct.pack(f">{len(v_crcs)}I", *v_crcs) \
        + struct.pack(">Q", payload_bytes)
    return zlib.crc32(packed)


def _check_integrity_header(header: dict, n_pages: int, payload_bytes: int,
                            require: bool, what: str):
    """Pop and validate the integrity fields of a decoded JSON header.
    Returns ``(k_crcs, v_crcs)``, or None when the frame carries none and
    ``require`` is False. Raises :class:`ProtocolSkewError` when required
    but absent, :class:`WireCorruptionError` on a malformed or
    self-inconsistent integrity header."""
    pc = header.pop("page_crc", None)
    fc = header.pop("frame_crc", None)
    if pc is None or fc is None:
        if require:
            raise ProtocolSkewError(
                f"{what}: peer speaks the pre-integrity wire dialect "
                "(no page_crc/frame_crc header fields)")
        return None
    try:
        k_crcs = [int(c) for c in pc["k"]]
        v_crcs = [int(c) for c in pc["v"]]
    except (TypeError, KeyError, ValueError):
        raise WireCorruptionError(
            f"{what}: malformed page_crc header") from None
    if len(k_crcs) != n_pages or len(v_crcs) != n_pages:
        raise WireCorruptionError(
            f"{what}: page_crc lists cover {len(k_crcs)}/{len(v_crcs)} "
            f"pages, frame carries {n_pages}")
    if _frame_crc(k_crcs, v_crcs, payload_bytes) != int(fc):
        raise WireCorruptionError(f"{what}: frame digest mismatch")
    return k_crcs, v_crcs


def _verify_pages(what: str, name: str, t: torch.Tensor, want: list,
                  start: int = 0) -> None:
    got = _page_crcs(t)
    if got != want:
        bad = start + next(i for i, (g, w) in enumerate(zip(got, want))
                           if g != w)
        raise WireCorruptionError(
            f"{what}: {name} page {bad} checksum mismatch")


def verify_import_state(state: dict) -> None:
    """The import-seam verify: re-checksum the K/V of a decoded state
    against the stash its decode left (``_integrity``), popping the stash
    either way so the engine's import validation never sees it. Called
    right before every ``import_request``-family commit. No-op for frames
    without integrity fields. Raises :class:`WireCorruptionError` naming
    the first bad page."""
    integ = state.pop("_integrity", None)
    if integ is None:
        return
    for name in ("k", "v"):
        _verify_pages("import state", name, state[name], integ[name])


# Frame: MAGIC + u32 header length + JSON header + k bytes + v bytes.
HANDOFF_MAGIC = b"KGCT-KV1"
# A JSON header larger than this is corrupt, not big: it carries token id
# lists and scalars, never KV content.
HEADER_MAX_BYTES = 8 << 20
# Wall bound for one pull (connect + prefill compute + transfer): the
# prefill replica may be running a long prompt; a decode replica that gives
# up just recomputes locally.
HANDOFF_TIMEOUT_S = 120.0

# Client body fields the decode replica forwards so the prefill replica
# samples the FIRST token exactly as a colocated engine would, plus the QoS
# tenant keys the prefill replica resolves the request's tier from (the
# pull carries no client headers).
FORWARDED_SAMPLING_FIELDS = (
    "temperature", "top_p", "top_k", "seed", "presence_penalty",
    "frequency_penalty", "logit_bias", "stop_token_ids", "logprobs",
    "session_id", "user",
)


def _kv_header(state: dict, k: torch.Tensor, v: torch.Tensor,
               integrity: bool, **extra) -> dict:
    """The JSON header of a handoff or prefix frame, its keys in the JAX
    codec's order: the state without K/V, ``k_shape``, ``extra`` and, with
    integrity on, the checksum fields."""
    header = {key: val for key, val in state.items()
              if key not in ("k", "v")}
    header["k_shape"] = [int(d) for d in k.shape]
    header.update(extra)
    if integrity:
        k_crcs, v_crcs = _page_crcs(k), _page_crcs(v)
        header["page_crc"] = {"k": k_crcs, "v": v_crcs}
        header["frame_crc"] = _frame_crc(k_crcs, v_crcs,
                                         k.nbytes + v.nbytes)
    return header


def encode_handoff(state: dict, integrity: bool = False) -> bytearray:
    """Engine export dict (``LLMEngine.export_held`` / ``export_running``)
    -> one binary frame. K and V are copied straight into their slices of
    one preallocated buffer (no temporaries, no join), so a burst of
    exports peaks at the frames themselves. The state keeps no reference
    into the frame, and the frame none to the state's (pinned) tensors.

    ``integrity`` stamps the integrity extension into the header; off is
    the pre-extension frame."""
    k, v = _host(state["k"]), _host(state["v"])
    header_bytes = json.dumps(_kv_header(state, k, v, integrity)).encode()
    off = len(HANDOFF_MAGIC) + 4 + len(header_bytes)
    out = bytearray(off + k.nbytes + v.nbytes)
    out[:off] = HANDOFF_MAGIC + struct.pack(">I", len(header_bytes)) \
        + header_bytes
    _copy_into(out, off, k)
    _copy_into(out, off + k.nbytes, v)
    return out


def _copy_into(buf: bytearray, offset: int, t: torch.Tensor) -> None:
    if t.nbytes:
        np.frombuffer(buf, np.uint8, count=t.nbytes, offset=offset)[:] = \
            _bytes_of(t).reshape(-1)


def _tensor_from(data, offset: int, shape: tuple, dtype: torch.dtype
                 ) -> torch.Tensor:
    """A new tensor of ``shape``/``dtype`` holding the frame's bytes at
    ``offset`` (a copy: see the module docstring)."""
    t = torch.empty(shape, dtype=dtype)
    if t.nbytes:
        _bytes_of(t).reshape(-1)[:] = np.frombuffer(
            data, np.uint8, count=t.nbytes, offset=offset)
    return t


def decode_handoff(data, require_integrity: bool = False) -> dict:
    """Binary frame -> the engine import state dict, K/V as CPU tensors.
    Raises ValueError on any structural mismatch (truncated frame,
    oversized header, byte-count drift): the caller treats that as a failed
    handoff and recomputes.

    Frames with the integrity extension are verified here (frame digest,
    then every page of K and V) and their checksums stashed under
    ``_integrity`` for :func:`verify_import_state`. ``require_integrity``
    rejects pre-integrity frames with :class:`ProtocolSkewError`."""
    m = len(HANDOFF_MAGIC)
    if data[:m] != HANDOFF_MAGIC:
        raise ValueError("handoff blob: bad magic")
    if len(data) < m + 4:
        raise ValueError("handoff blob: truncated header length")
    (hlen,) = struct.unpack(">I", data[m:m + 4])
    if hlen > HEADER_MAX_BYTES:
        raise ValueError(f"handoff blob: header {hlen} bytes exceeds bound")
    off = m + 4
    try:
        header = json.loads(data[off:off + hlen])
    except ValueError as e:
        raise ValueError(f"handoff blob: bad header JSON ({e})") from None
    off += hlen
    try:
        shape = tuple(int(d) for d in header.pop("k_shape"))
        dtype = _torch_dtype(str(header["dtype"]))
    except (KeyError, TypeError) as e:
        raise ValueError(f"handoff blob: malformed header ({e!r})") from None
    nbytes = int(np.prod(shape)) * dtype.itemsize
    if len(data) != off + 2 * nbytes:
        raise ValueError(
            f"handoff blob: payload {len(data) - off} bytes != 2 x {nbytes}")
    crcs = _check_integrity_header(header, int(shape[1]), 2 * nbytes,
                                   require_integrity, "handoff blob")
    header["k"] = _tensor_from(data, off, shape, dtype)
    header["v"] = _tensor_from(data, off + nbytes, shape, dtype)
    if crcs is not None:
        for name, want in zip(("k", "v"), crcs):
            _verify_pages("handoff blob", name, header[name], want)
        header["_integrity"] = {"k": crcs[0], "v": crcs[1]}
    return header


def handoff_request_body(prompt_token_ids: list, body: dict) -> dict:
    """The JSON body a decode replica sends the prefill replica: the
    already-tokenized prompt (the prefill side must not re-tokenize) plus
    the sampling fields that shape the first token."""
    fwd = {"prompt_token_ids": list(prompt_token_ids)}
    for field in FORWARDED_SAMPLING_FIELDS:
        if field in body and body[field] is not None:
            fwd[field] = body[field]
    return fwd


# -- fleet-prefix stream codec ----------------------------------------------
#
# A prefix pull wants the importer to scatter pages as they arrive off the
# socket, so the wire interleaves K and V per page chunk: PREFIX_MAGIC +
# u32 header length + JSON header (model/page_size/dtype/matched_tokens/
# prompt_token_ids/k_shape/chunk_pages) + one [k_chunk][v_chunk] slab per
# chunk of ``chunk_pages`` pages (the last may be short).

PREFIX_MAGIC = b"KGCT-PF1"

# Pages per streamed chunk: small enough that a chunk scatter never blocks
# the worker noticeably, large enough that per-chunk overhead stays small.
PREFIX_CHUNK_PAGES = 4

# Wall bound for one prefix pull: connect + gather + transfer, no prefill
# compute hides inside it.
PREFIX_PULL_TIMEOUT_S = 30.0


def encode_prefix_frames(state: dict,
                         chunk_pages: int = PREFIX_CHUNK_PAGES,
                         integrity: bool = False):
    """Engine export dict (``LLMEngine.export_prefix``) -> an iterator of
    wire slabs: the header first, then one contiguous ``[k|v]`` slab per
    page chunk, so the importer can scatter before the tail pages left the
    owner. ``integrity`` stamps the checksum fields into the header."""
    k, v = _host(state["k"]), _host(state["v"])
    hb = json.dumps(_kv_header(state, k, v, integrity,
                               chunk_pages=int(chunk_pages))).encode()
    yield PREFIX_MAGIC + struct.pack(">I", len(hb)) + hb
    n = k.shape[1]
    for i in range(0, n, chunk_pages):
        ck = k[:, i:i + chunk_pages].contiguous()
        cv = v[:, i:i + chunk_pages].contiguous()
        slab = bytearray(ck.nbytes + cv.nbytes)
        _copy_into(slab, 0, ck)
        _copy_into(slab, ck.nbytes, cv)
        yield slab


class PrefixStreamDecoder:
    """Incremental decoder of the prefix stream: feed socket chunks in, get
    ``(k_chunk, v_chunk)`` CPU tensors out as soon as each completes.
    ``header`` is set once the first feed crossed the header boundary;
    ``done`` once every advertised page was yielded. Raises ValueError on
    any structural mismatch (bad magic, oversized header, trailing bytes).

    A stream whose header carries the integrity extension is verified
    chunk by chunk, before the importer can scatter it
    (:class:`WireCorruptionError` at the corrupt chunk);
    ``require_integrity`` rejects pre-integrity streams at the header
    (:class:`ProtocolSkewError`)."""

    def __init__(self, require_integrity: bool = False):
        # bytearray: += is amortized O(1).
        self._buf = bytearray()
        self.header: Optional[dict] = None
        self._shape = None          # (L, n_pages, ps, kd)
        self._dtype = None
        self._chunk_pages = 0
        self._yielded_pages = 0
        self._require_integrity = require_integrity
        self._crcs = None           # (k_crcs, v_crcs) when integrity on

    @property
    def done(self) -> bool:
        return (self._shape is not None
                and self._yielded_pages >= self._shape[1])

    def _try_header(self) -> None:
        m = len(PREFIX_MAGIC)
        if len(self._buf) < m + 4:
            return
        if self._buf[:m] != PREFIX_MAGIC:
            raise ValueError("prefix stream: bad magic")
        (hlen,) = struct.unpack(">I", self._buf[m:m + 4])
        if hlen > HEADER_MAX_BYTES:
            raise ValueError(
                f"prefix stream: header {hlen} bytes exceeds bound")
        if len(self._buf) < m + 4 + hlen:
            return
        try:
            header = json.loads(bytes(self._buf[m + 4:m + 4 + hlen]))
        except ValueError as e:
            raise ValueError(
                f"prefix stream: bad header JSON ({e})") from None
        # Missing or garbage fields surface as ValueError, the one class
        # every caller's degrade-to-recompute (and the spill 400) catches.
        try:
            shape = tuple(int(d) for d in header.pop("k_shape"))
            self._chunk_pages = int(header.pop("chunk_pages", 0))
            dtype = _torch_dtype(str(header["dtype"]))
        except ValueError:
            raise
        except Exception as e:
            raise ValueError(
                f"prefix stream: malformed header ({e!r})") from None
        if len(shape) != 4 or any(d < 1 for d in shape):
            raise ValueError(f"prefix stream: bad k_shape {shape}")
        if self._chunk_pages < 1:
            raise ValueError("prefix stream: bad chunk_pages")
        payload = 2 * int(np.prod(shape)) * dtype.itemsize
        self._crcs = _check_integrity_header(
            header, int(shape[1]), payload, self._require_integrity,
            "prefix stream")
        self._shape = shape
        self._dtype = dtype
        self.header = header
        del self._buf[:m + 4 + hlen]

    def feed(self, data) -> list:
        """The ``(k_chunk, v_chunk)`` tensors, each ``[L, c, ps, kd]``,
        completed by this feed (copies: valid after further feeds)."""
        self._buf += data
        if self.header is None:
            self._try_header()
            if self.header is None:
                return []
        out = []
        L, n, ps, kd = self._shape
        per_page = L * ps * kd * self._dtype.itemsize
        while self._yielded_pages < n:
            c = min(self._chunk_pages, n - self._yielded_pages)
            slab = 2 * c * per_page
            if len(self._buf) < slab:
                break
            ck = _tensor_from(self._buf, 0, (L, c, ps, kd), self._dtype)
            cv = _tensor_from(self._buf, c * per_page, (L, c, ps, kd),
                              self._dtype)
            if self._crcs is not None:
                start = self._yielded_pages
                for name, t, want in (("k", ck, self._crcs[0]),
                                      ("v", cv, self._crcs[1])):
                    _verify_pages("prefix stream", name, t,
                                  want[start:start + c], start)
            out.append((ck, cv))
            del self._buf[:slab]
            self._yielded_pages += c
        if self.done and self._buf:
            raise ValueError(
                f"prefix stream: {len(self._buf)} trailing bytes")
        return out


def encode_spill_frame(digest_hex: str, k: torch.Tensor, v: torch.Tensor,
                       model: str, page_size: int,
                       integrity: bool = False) -> bytes:
    """One remote-spilled page -> one prefix-stream frame (single chunk)
    whose header carries the chained digest instead of token ids: the
    receiver parks it in its HOST tier keyed by the digest
    (``LLMEngine.accept_remote_spill``)."""
    state = {"model": model, "page_size": page_size,
             "dtype": dtype_name(k.dtype), "digest": digest_hex,
             "k": k, "v": v}
    return b"".join(bytes(part) for part in
                    encode_prefix_frames(state, chunk_pages=1,
                                         integrity=integrity))


def decode_spill_frame(data, require_integrity: bool = False
                       ) -> tuple[str, dict, torch.Tensor, torch.Tensor]:
    """Inverse of :func:`encode_spill_frame`: (digest_hex, header, k, v).
    Raises ValueError on any mismatch (checksum mismatches as
    :class:`WireCorruptionError`, pre-integrity frames under
    ``require_integrity`` as :class:`ProtocolSkewError`)."""
    dec = PrefixStreamDecoder(require_integrity=require_integrity)
    chunks = dec.feed(data)
    if dec.header is None or not dec.done or len(chunks) != 1:
        raise ValueError("spill frame: truncated or multi-chunk")
    digest = dec.header.get("digest")
    if not isinstance(digest, str):
        raise ValueError("spill frame: missing digest")
    return digest, dec.header, chunks[0][0], chunks[0][1]


# Wall bound for one mid-stream migration PUSH (connect + transfer): the
# blob is already in host memory and every second here extends the drain.
# A push that misses it falls back to wait-it-out.
MIGRATE_PUSH_TIMEOUT_S = 20.0

# Parked-migration bounds: a receiving replica holds at most this many
# mid-stream states, each for at most this long, before the router's
# failover re-dispatch claims it (or never comes: client gone).
MIGRATION_PARK_CAP = 64
MIGRATION_PARK_TTL_S = 120.0


class MigrationStore:
    """Bounded parking lot for pushed mid-stream migration states on the
    RECEIVING replica: a drain push parks the decoded state here (host
    memory only); the router's ``/internal/resume`` re-dispatch claims it
    by request id and imports it then. Entries expire by TTL and the store
    is capacity-bounded (oldest evicted first)."""

    def __init__(self, cap: int = MIGRATION_PARK_CAP,
                 ttl_s: float = MIGRATION_PARK_TTL_S,
                 clock=None):
        self.cap = cap
        self.ttl_s = ttl_s
        self._clock = clock if clock is not None else time.monotonic
        self._entries: dict[str, tuple[float, dict]] = {}

    def __len__(self) -> int:
        self._expire()
        return len(self._entries)

    def _expire(self) -> None:
        now = self._clock()
        dead = [rid for rid, (deadline, _) in self._entries.items()
                if deadline <= now]
        for rid in dead:
            del self._entries[rid]

    def put(self, request_id: str, state: dict) -> None:
        self._expire()
        # A re-push for the same id replaces (the newer snapshot wins);
        # otherwise evict oldest-deadline entries to stay under cap.
        self._entries.pop(request_id, None)
        while len(self._entries) >= self.cap:
            oldest = min(self._entries, key=lambda r: self._entries[r][0])
            del self._entries[oldest]
        self._entries[request_id] = (self._clock() + self.ttl_s, state)

    def pop(self, request_id: str) -> Optional[dict]:
        self._expire()
        entry = self._entries.pop(request_id, None)
        return entry[1] if entry is not None else None


async def _error_snippet(resp) -> str:
    """Bounded error peek: the envelope is small; never slurp an unbounded
    error body into memory."""
    return (await resp.read(2048)).decode("utf-8", errors="replace")[:200]


async def push_handoff(session: ClientSession, peer_url: str, blob,
                       request_id: str,
                       timeout_s: float = MIGRATE_PUSH_TIMEOUT_S) -> None:
    """POST a mid-stream migration blob to ``peer_url``'s
    ``/internal/kv_handoff`` (the octet-stream content type selects the
    push direction). Raises on any non-200 or timeout: the caller keeps
    the sequence local (wait-it-out drain)."""
    async with session.post(
            f"{peer_url.rstrip('/')}/internal/kv_handoff", data=blob,
            headers={REQUEST_ID_HEADER: request_id,
                     "Content-Type": "application/octet-stream"},
            timeout_s=timeout_s) as resp:
        if resp.status != 200:
            raise RuntimeError(f"migration push rejected {resp.status}: "
                               f"{await _error_snippet(resp)}")
        await resp.read()


async def fetch_handoff(session: ClientSession, prefill_url: str,
                        payload: dict, request_id: str, max_bytes: int,
                        timeout_s: float = HANDOFF_TIMEOUT_S,
                        qos_tier: Optional[str] = None) -> bytearray:
    """POST the handoff request and read the blob with both bounds
    applied. Raises on any non-200, oversized or timed-out response: the
    caller falls back to local recompute. ``qos_tier``: the decode
    replica's resolved tier, forwarded so a header-classed request keeps
    its class on the prefill replica."""
    headers = {REQUEST_ID_HEADER: request_id}
    if qos_tier is not None:
        headers[QOS_TIER_HEADER] = qos_tier
    async with session.post(
            f"{prefill_url.rstrip('/')}/internal/kv_handoff", json=payload,
            headers=headers, timeout_s=timeout_s) as resp:
        if resp.status != 200:
            raise RuntimeError(f"handoff upstream {resp.status}: "
                               f"{await _error_snippet(resp)}")
        if resp.content_length is not None and \
                resp.content_length > max_bytes:
            raise RuntimeError(
                f"handoff blob {resp.content_length} bytes exceeds the "
                f"local bound {max_bytes}")
        data = await resp.read(max_bytes + 1)
        if len(data) > max_bytes:
            raise RuntimeError(
                f"handoff blob exceeds the local bound {max_bytes}")
        return data
