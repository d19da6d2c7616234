"""Tokenization for the serving layer: text in / text out.

The engine works purely in token ids; the server layer owns the tokenizer and
string-level stop handling (the contract stated at engine/sequence.py: stop
STRINGS are evaluated here, stop TOKEN ids in the engine). The reference's
user contract is an OpenAI API over text (reference ``old_README.md:1472-1476``);
its models shipped with HF tokenizer files pre-staged on every node
(``old_README.md:1482-1561``) — mirrored here by ``load_tokenizer`` accepting a
local path.

Two implementations:

- ``HFTokenizer``: wraps a ``transformers`` AutoTokenizer loaded from a local
  directory (zero-egress environments cannot download; deployment pre-stages
  files the way the reference staged /models).
- ``ByteTokenizer``: self-contained UTF-8 byte-level tokenizer (no files).
  Used for debug models, tests, and as the guaranteed-available fallback.

``IncrementalDetokenizer`` turns a stream of token ids into a stream of text
deltas with stop-string scanning: emitted text is held back by the longest
stop-string prefix that could still complete, so a stop string split across
window boundaries is never leaked to the client.
"""

from __future__ import annotations

from typing import Optional, Protocol, Sequence


class Tokenizer(Protocol):
    eos_token_id: Optional[int]

    def encode(self, text: str) -> list[int]: ...
    def decode(self, ids: Sequence[int]) -> str: ...


class ByteTokenizer:
    """UTF-8 bytes shifted by 3 (0=pad, 1=bos, 2=eos). vocab_size=259."""

    PAD, BOS, EOS = 0, 1, 2
    OFFSET = 3

    def __init__(self, add_bos: bool = True):
        self.add_bos = add_bos
        self.eos_token_id = self.EOS
        self.vocab_size = 256 + self.OFFSET

    def encode(self, text: str) -> list[int]:
        ids = [b + self.OFFSET for b in text.encode("utf-8")]
        return [self.BOS] + ids if self.add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(t - self.OFFSET for t in ids
                     if self.OFFSET <= t < 256 + self.OFFSET)
        return data.decode("utf-8", errors="replace")


class HFTokenizer:
    """transformers AutoTokenizer wrapper (local files only in this env)."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(path)
        self.eos_token_id = self._tok.eos_token_id
        self.vocab_size = len(self._tok)

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text)

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)

    def apply_chat_template(self, messages: list[dict]) -> str:
        return self._tok.apply_chat_template(
            messages, tokenize=False, add_generation_prompt=True)


def load_tokenizer(name_or_path: Optional[str]) -> Tokenizer:
    """Resolve a tokenizer: a local path -> HFTokenizer; None or "byte" ->
    ByteTokenizer (debug models / tests / no staged files)."""
    if name_or_path in (None, "byte", "bytes"):
        return ByteTokenizer()
    return HFTokenizer(name_or_path)


def apply_chat_template(tokenizer: Tokenizer, messages: list[dict]) -> str:
    """Chat-messages -> prompt string. Uses the model's own template when the
    tokenizer ships one; otherwise a minimal role-tagged fallback."""
    fn = getattr(tokenizer, "apply_chat_template", None)
    if fn is not None:
        try:
            return fn(messages)
        except Exception:
            pass
    parts = [f"<|{m.get('role', 'user')}|>\n{m.get('content', '')}"
             for m in messages]
    return "\n".join(parts) + "\n<|assistant|>\n"


class IncrementalDetokenizer:
    """Token-id stream -> text-delta stream with stop-string handling.

    decode() is re-run over the full output ids each push and diffed against
    the previously emitted prefix — O(n) per call in output length, robust to
    tokenizers whose token boundaries do not align with character boundaries
    (UTF-8 multibyte, BPE merges).
    """

    def __init__(self, tokenizer: Tokenizer, stop: Sequence[str] = ()):
        self.tokenizer = tokenizer
        self.stop = [s for s in stop if s]
        self._ids: list[int] = []
        self._emitted = 0          # chars of decoded text already released
        self._stopped = False
        # Max chars that must be held back so a partially-matched stop string
        # can still complete: longest stop minus 1.
        self._holdback = max((len(s) for s in self.stop), default=1) - 1

    @property
    def stopped(self) -> bool:
        return self._stopped

    @property
    def text(self) -> str:
        return self.tokenizer.decode(self._ids)

    def push(self, ids: Sequence[int], final: bool = False) -> str:
        """Feed new token ids; returns the text delta safe to emit now.
        After a stop string matches, the delta ends right before the stop
        string and ``stopped`` flips — callers should abort the request."""
        if self._stopped:
            return ""
        self._ids.extend(ids)
        text = self.tokenizer.decode(self._ids)
        for s in self.stop:
            # Scan from just before the emitted point: the stop string may
            # straddle the emitted/held-back boundary.
            start = max(0, self._emitted - len(s) + 1)
            idx = text.find(s, start)
            if idx != -1:
                self._stopped = True
                delta = text[self._emitted:idx]
                self._emitted = idx
                return delta
        limit = len(text) if final else max(self._emitted,
                                            len(text) - self._holdback)
        # A partial UTF-8 sequence at the stream end decodes to U+FFFD and
        # would be rewritten once the next token completes it — hold it back.
        while limit > self._emitted and not final and text[limit - 1] == "�":
            limit -= 1
        delta = text[self._emitted:limit]
        self._emitted = limit
        return delta
