"""Answer aggregation: majority vote, weighted vote, logit pooling.

The reference's only aggregation rule is *unanimity* — every panelist's
feedback must be ``Good`` (``src/main.rs:316-325``), with forced approval
at the round cap (``:308-311``). Per SURVEY.md §7(c) and BASELINE.json,
the rebuild generalizes this to N-way self-consistency:

- :func:`majority_vote` / :func:`weighted_vote` — host-side aggregation
  over canonicalized answers (heterogeneous panels use persona weights).
- :func:`logit_pool` — pool candidates by total probability mass
  (sum of per-candidate sequence probabilities per distinct answer).
- :func:`self_consistency` — end-to-end: one batched N-way sample on an
  :class:`InferenceEngine`, canonicalize, vote.
"""

from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass

import numpy as np

# ---------------------------------------------------------------------------
# Canonicalization
# ---------------------------------------------------------------------------

_NUM_RE = re.compile(r"-?\$?\d[\d,]*(?:\.\d+)?")


def extract_final_number(text: str) -> str | None:
    """Extract a final numeric answer (GSM8K-style EM key).

    Honors an explicit ``#### <answer>`` marker when present, else takes
    the last number in the text. Commas/dollar signs are stripped;
    ``42.0`` canonicalizes to ``42``.
    """
    marker = text.rsplit("####", 1)
    hay = marker[1] if len(marker) == 2 else text
    matches = _NUM_RE.findall(hay)
    if not matches:
        return None
    raw = matches[-1].replace(",", "").replace("$", "")
    try:
        val = float(raw)
    except ValueError:
        return None
    return str(int(val)) if val == int(val) else str(val)


def canonicalize(text: str) -> str:
    """Default answer key: final number when present, else normalized text."""
    num = extract_final_number(text)
    if num is not None:
        return num
    return " ".join(text.strip().lower().split())


# ---------------------------------------------------------------------------
# Host-side voting
# ---------------------------------------------------------------------------


@dataclass
class VoteResult:
    winner: str  # canonical key of the winning answer
    text: str  # a representative raw answer carrying the winning key
    tally: dict[str, float]
    n_candidates: int


def _vote(
    answers: list[str],
    scores: list[float],
    key_fn,
) -> VoteResult:
    if not answers:
        raise ValueError("no answers to vote over")
    tally: dict[str, float] = defaultdict(float)
    rep: dict[str, str] = {}
    for ans, sc in zip(answers, scores):
        k = key_fn(ans)
        tally[k] += sc
        rep.setdefault(k, ans)
    winner = max(tally.items(), key=lambda kv: kv[1])[0]
    return VoteResult(
        winner=winner,
        text=rep[winner],
        tally=dict(tally),
        n_candidates=len(answers),
    )


def majority_vote(answers: list[str], key_fn=canonicalize) -> VoteResult:
    """Uniform one-candidate-one-vote (self-consistency, Wang et al.)."""
    return _vote(answers, [1.0] * len(answers), key_fn)


def weighted_vote(
    answers: list[str], weights: list[float], key_fn=canonicalize
) -> VoteResult:
    """Per-candidate weights — heterogeneous panels vote with persona
    weights (BASELINE.md config[3])."""
    if len(weights) != len(answers):
        raise ValueError("weights and answers must align")
    return _vote(answers, list(weights), key_fn)


def logit_pool(
    answers: list[str], logprobs: list[float], key_fn=canonicalize
) -> VoteResult:
    """Pool by probability mass: each candidate contributes
    ``exp(logprob)`` (normalized over the batch for stability)."""
    if len(logprobs) != len(answers):
        raise ValueError("logprobs and answers must align")
    lp = np.asarray(logprobs, np.float64)
    w = np.exp(lp - lp.max())  # softmax-style stabilization
    return _vote(answers, list(w / w.sum()), key_fn)


# ---------------------------------------------------------------------------
# End-to-end self-consistency over an engine
# ---------------------------------------------------------------------------


@dataclass
class SelfConsistencyResult:
    vote: VoteResult
    candidates: list[str]
    logprobs: list[float]
    total_tokens: int


def self_consistency(
    engine,
    prompt: str,
    n: int,
    temperature: float = 0.7,
    seed: int = 0,
    max_new_tokens: int | None = None,
    method: str = "majority",
    key_fn=canonicalize,
) -> SelfConsistencyResult:
    """N-way self-consistency: ONE batched sample of n candidates on the
    engine, then vote. ``method``: majority | logit_pool (the on-device
    ``device_majority`` reducer waits for the port's parallel slice).
    """
    if method not in ("majority", "logit_pool"):
        raise ValueError(f"unknown aggregation method {method!r}")
    results = engine.generate_texts(
        [prompt] * n,
        temperatures=[temperature] * n,
        seed=seed,
        max_new_tokens=max_new_tokens,
    )
    texts = [r.text for r in results]
    lps = [r.logprob for r in results]
    if method == "majority":
        vote = majority_vote(texts, key_fn)
    else:
        vote = logit_pool(texts, lps, key_fn)
    return SelfConsistencyResult(
        vote=vote,
        candidates=texts,
        logprobs=lps,
        total_tokens=sum(r.num_tokens for r in results),
    )
