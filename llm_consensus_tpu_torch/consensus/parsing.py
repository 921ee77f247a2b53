"""Evaluation-response parsing as pure, unit-testable functions.

Parity target: the reference parses the judge's reply inline in the actor
handler (``src/main.rs:139-153``): split on newlines, drop empty lines, take
the first line with all spaces removed, map ``Good``/``NeedsRefinement``;
anything else logs an error and counts as ``NeedsRefinement`` (SURVEY.md §5
quirk #4). Remaining lines (joined with blank lines) are the reasoning.
"""

from __future__ import annotations

import logging

from llm_consensus_tpu_torch.consensus.messages import Feedback

log = logging.getLogger(__name__)


def parse_evaluation(text: str) -> tuple[Feedback, str]:
    """Parse a judge's raw reply into (verdict, reasoning).

    Mirrors reference ``src/main.rs:139-153``: first non-empty line,
    space-stripped, must be exactly ``Good`` or ``NeedsRefinement``; an
    unrecognized verdict is logged and treated as ``NeedsRefinement``.
    An entirely empty reply is likewise ``NeedsRefinement``.
    """
    lines = [ln for ln in text.split("\n") if ln != ""]
    if not lines:
        log.error("Empty response from EvaluateAnswer")
        return Feedback.NEEDS_REFINEMENT, ""
    verdict_raw = lines[0].replace(" ", "")
    reasoning = "\n\n".join(lines[1:])
    if verdict_raw == "Good":
        return Feedback.GOOD, reasoning
    if verdict_raw == "NeedsRefinement":
        return Feedback.NEEDS_REFINEMENT, reasoning
    log.error("Unexpected response from EvaluateAnswer: %s", text)
    return Feedback.NEEDS_REFINEMENT, reasoning
