"""Stop-sequence rules of the engine's batch path.

The rules the port's :class:`~llm_consensus_tpu_torch.engine.engine.
InferenceEngine` and continuous batcher need, copied from
``llm_consensus_tpu.utils.stops``:

- :func:`earliest_stop_cut` — where to trim the final text (earliest
  occurrence of any stop; the stop itself is removed by the caller).
- :class:`VisibleIdFilter` and :func:`stop_tail_window` — the batcher's
  per-token host check: decode a tail window of the generated ids, and
  confirm a window hit against the full text.
- :func:`single_token_stop_ids` — the ids the decode loop may terminate
  on exactly (stops that encode to one id).

``derived_stop_screen`` (the multi-round decode's device screen) is not
ported yet.
"""

from __future__ import annotations

from typing import Iterable, Sequence


def earliest_stop_cut(text: str, stops: Iterable[str]) -> int:
    """Index of the earliest occurrence of any stop in ``text``; -1 if
    none occurs. Ties across stops resolve to the smallest index."""
    return min(
        (i for s in stops if (i := text.find(s)) >= 0),
        default=-1,
    )


class VisibleIdFilter:
    """Sizes the stop-check tail window by VISIBLE token count.

    Incremental stop checks decode only a tail window of token ids
    (:func:`stop_tail_window`), which assumes every id decodes to >= 1
    byte. Ids that decode to the empty string on their own would stretch
    a stop across more than ``window`` tokens, so the tail slice is
    extended until it holds ``window`` ids that decode to >= 1 character,
    without dropping the empty ones (they contribute bytes in context).
    Only ``skip_ids`` (EOS) are removed. Per-id emptiness is memoized;
    the backward scan is bounded at ``8 * window`` ids.
    """

    def __init__(self, tokenizer, skip_ids: Iterable[int] = ()):
        self._tok = tokenizer
        self._skip = frozenset(int(i) for i in skip_ids)
        self._empty: dict[int, bool] = {}

    def _is_empty(self, t: int) -> bool:
        e = self._empty.get(t)
        if e is None:
            e = self._tok.decode([t]) == ""
            self._empty[t] = e
        return e

    def visible_tail(self, ids: Sequence[int], window: int) -> list[int]:
        """Contiguous tail of ``ids`` containing ``window`` ids that
        decode to >= 1 character (``skip_ids`` removed), scanning back at
        most ``8 * window`` ids."""
        if window <= 0:
            return []
        visible = 0
        span = 0
        for t in reversed(ids[-8 * window :]):
            span += 1
            t = int(t)
            if t in self._skip or self._is_empty(t):
                continue
            visible += 1
            if visible >= window:
                break
        return [int(t) for t in ids[-span:] if int(t) not in self._skip]

    def confirmed_stop_hit(
        self,
        ids: Sequence[int],
        stops: Sequence[str],
        window: int,
        full_text,
    ) -> bool:
        """Tail-window scan, then a confirm against the full decoded text
        (``full_text``, a zero-argument callable run only on a window
        hit): a tail window can decode differently from the full text at
        its head, and retiring on such a false positive would truncate a
        row that the final trim then finds no stop in."""
        if not stops:
            return False
        text = self._tok.decode(self.visible_tail(ids, window))
        if not any(s in text for s in stops):
            return False
        full = full_text()
        return any(s in full for s in stops)


def stop_tail_window(tokenizer, stops: Iterable[str], slack: int = 8) -> int:
    """Tail-token window width for incremental stop checks: the longest
    stop's byte length (every visible token decodes to >= 1 byte; its
    encoded length is kept as a floor), plus ``slack`` for a multibyte
    character or another stop's prefix straddling the window head.
    ``surrogateescape`` keeps stops carved from decoded model output
    (lone surrogates standing for invalid bytes) at one byte each."""
    stops = list(stops)
    if not stops:
        return 0
    span = max(
        max(
            len(s.encode("utf-8", errors="surrogateescape")),
            len(tokenizer.encode(s, add_bos=False)),
        )
        for s in stops
    )
    return span + slack


def single_token_stop_ids(tokenizer, stops: Iterable[str]) -> tuple[int, ...]:
    """Stops that tokenize to exactly one id — the EXACT device-side
    terminators (a row sampling one of them finishes as if it sampled
    EOS). The engine's batch decode loop has always device-stopped
    these; the derivation lives here so the multi-round batcher and the
    engine read the same rule. Order-preserving, deduplicated."""
    ids = []
    for s in stops:
        enc = tokenizer.encode(s, add_bos=False)
        if len(enc) == 1:
            ids.append(int(enc[0]))
    return tuple(dict.fromkeys(ids))
