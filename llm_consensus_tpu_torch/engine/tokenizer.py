"""Tokenizers for the inference engine.

The reference never tokenizes — text goes to the Gemini API verbatim
(``src/main.rs:82-86``). A local engine needs token ids, so this module
provides :class:`ByteTokenizer` — dependency-free byte-level tokenizer
(UTF-8 bytes offset past the special ids). Deterministic, reversible,
works with the tiny test configs and in fully offline environments.
The HuggingFace ``load_tokenizer`` of the JAX package is not ported yet.

The surface is ``encode``, ``decode``, ``vocab_size``, ``bos_id``,
``eos_id``, ``pad_id``.
"""

from __future__ import annotations

import abc
from typing import Sequence


class Tokenizer(abc.ABC):
    """Minimal tokenizer interface used by the engine."""

    vocab_size: int
    bos_id: int
    eos_id: int
    pad_id: int

    @abc.abstractmethod
    def encode(self, text: str, add_bos: bool = True) -> list[int]: ...

    @abc.abstractmethod
    def decode(self, ids: Sequence[int]) -> str: ...


class ByteTokenizer(Tokenizer):
    """Byte-level tokenizer: id = byte + 3. Ids 0/1/2 are pad/bos/eos.

    Round-trips arbitrary UTF-8 text; vocab is 259 ids. Model configs used
    with this tokenizer need ``vocab_size >= 259``.
    """

    def __init__(self) -> None:
        self.pad_id = 0
        self.bos_id = 1
        self.eos_id = 2
        self._offset = 3
        self.vocab_size = 256 + self._offset

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        # surrogateescape mirrors decode(): text carved out of decoded
        # model output (stop sequences, prefix keys) may carry lone
        # surrogates standing in for invalid bytes; encoding them back
        # to those bytes keeps encode(decode(ids)) == ids.
        ids = [
            b + self._offset
            for b in text.encode("utf-8", errors="surrogateescape")
        ]
        return [self.bos_id] + ids if add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        # Ignore ids outside the byte range — models whose vocab exceeds
        # 259 (e.g. test configs with padded vocabs) can sample them.
        data = bytes(
            i - self._offset
            for i in ids
            if self._offset <= i < self._offset + 256
        )
        # surrogateescape, not replace: invalid bytes must decode to
        # DISTINCT characters (U+DC80+byte) or the decode is lossy in a
        # way that breaks stop-sequence position arithmetic — with
        # errors="replace" every invalid byte aliases to U+FFFD, so a
        # stop string carved from decoded text str.find()-matches at an
        # EARLIER aliased position and the trim cuts the wrong prefix
        # (the engine/batcher stop contract trims at the earliest true
        # occurrence). surrogateescape is also reversible, preserving
        # the class promise that decode round-trips arbitrary bytes.
        return data.decode("utf-8", errors="surrogateescape")
