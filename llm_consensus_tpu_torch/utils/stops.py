"""Stop-sequence rules of the engine's batch path.

The two rules the port's :class:`~llm_consensus_tpu_torch.engine.engine.
InferenceEngine` needs, copied from ``llm_consensus_tpu.utils.stops``:

- :func:`earliest_stop_cut` — where to trim the final text (earliest
  occurrence of any stop; the stop itself is removed by the caller).
- :func:`single_token_stop_ids` — the ids the decode loop may terminate
  on exactly (stops that encode to one id).

The incremental-check helpers of the JAX package (multi-token stops,
streaming, the continuous batcher) are not ported yet.
"""

from __future__ import annotations

from typing import Iterable


def earliest_stop_cut(text: str, stops: Iterable[str]) -> int:
    """Index of the earliest occurrence of any stop in ``text``; -1 if
    none occurs. Ties across stops resolve to the smallest index."""
    return min(
        (i for s in stops if (i := text.find(s)) >= 0),
        default=-1,
    )


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
