"""Consensus wire protocol: typed messages exchanged between the coordinator
and panel members.

Parity target: the reference's actix message types (``src/main.rs:7-69``) —
``Feedback``, ``Register``, ``AskQuestion``, ``AnswerQuestion``,
``AnswerReadinessRequest``, ``GetAnswer``, ``EvaluateAnswer``,
``AnswerEvaluation``, ``RefineAnswer``, ``AnswerRefinement``, ``Reset``.

Differences from the reference, by design (SURVEY.md §5 quirk #6):
every in-flight message carries an ``epoch`` (one per question) and a
``round`` (one per evaluation fan-out), so a stale evaluation from round k
arriving after ``feedback.clear()`` for round k+1 is *dropped* instead of
corrupting the tally. The reference has no such tags and exhibits that race.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


class Feedback(enum.Enum):
    """Panel verdict on an answer (reference ``src/main.rs:8-12``)."""

    GOOD = "Good"
    NEEDS_REFINEMENT = "NeedsRefinement"


@dataclass(frozen=True)
class AskQuestion:
    """Request an answer to a question (reference ``src/main.rs:22-25``)."""

    question: str
    epoch: int = 0


@dataclass(frozen=True)
class AnswerQuestion:
    """A proposer's answer (reference ``src/main.rs:27-30``)."""

    answer: str
    author: str
    epoch: int = 0


@dataclass(frozen=True)
class EvaluateAnswer:
    """Fan-out request asking one panelist to judge the current answer
    (reference ``src/main.rs:41-46``)."""

    question: str
    answer: str
    epoch: int = 0
    round: int = 0


@dataclass(frozen=True)
class AnswerEvaluation:
    """A panelist's verdict (reference ``src/main.rs:48-54``)."""

    name: str
    evaluation: Feedback
    reasoning: str = ""
    epoch: int = 0
    round: int = 0


@dataclass(frozen=True)
class RefineAnswer:
    """Request that a dissenting panelist rewrite the answer
    (reference ``src/main.rs:56-61``)."""

    question: str
    answer: str
    epoch: int = 0
    round: int = 0


@dataclass(frozen=True)
class AnswerRefinement:
    """The refined answer (reference ``src/main.rs:63-65``)."""

    answer: str
    author: str = ""
    epoch: int = 0
    round: int = 0


@dataclass
class TranscriptEvent:
    """One entry of the consensus transcript (observability subsystem; the
    reference only has ``debug!`` log lines, e.g. ``src/main.rs:263,281``)."""

    kind: str
    epoch: int
    round: int
    payload: dict = field(default_factory=dict)
