"""Tokenizers for the inference engine.

The reference never tokenizes — text goes to the Gemini API verbatim
(``src/main.rs:82-86``). A local engine needs token ids, so this module
provides :class:`ByteTokenizer` — dependency-free byte-level tokenizer
(UTF-8 bytes offset past the special ids). Deterministic, reversible,
works with the tiny test configs and in fully offline environments.
:class:`HFTokenizer` wraps a ``transformers`` tokenizer read from a local
directory (:func:`load_tokenizer`, which falls back to bytes; importing
this module never needs ``transformers``).

The surface is ``encode``, ``decode``, ``vocab_size``, ``bos_id``,
``eos_id``, ``pad_id``.
"""

from __future__ import annotations

import abc
import os
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


class HFTokenizer(Tokenizer):
    """Wrapper over a locally available ``transformers`` tokenizer."""

    def __init__(self, tok) -> None:
        self._tok = tok
        self.vocab_size = len(tok)
        self.bos_id = tok.bos_token_id if tok.bos_token_id is not None else 1
        self.eos_id = tok.eos_token_id if tok.eos_token_id is not None else 2
        pad = tok.pad_token_id
        self.pad_id = pad if pad is not None else self.eos_id

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = self._tok.encode(text, add_special_tokens=False)
        return [self.bos_id] + ids if add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=True)


def load_tokenizer(path: str | None = None) -> Tokenizer:
    """The HF tokenizer in the local directory ``path``; the
    :class:`ByteTokenizer` when ``path`` is None, not a directory, or
    holds nothing ``transformers`` can load (or ``transformers`` is not
    installed). Never reads the network (``local_files_only=True``)."""
    if path and os.path.isdir(path):
        try:
            from transformers import AutoTokenizer

            return HFTokenizer(AutoTokenizer.from_pretrained(path, local_files_only=True))
        except Exception:  # noqa: BLE001 - any load failure -> byte fallback
            pass
    return ByteTokenizer()
