"""Deterministic fake backends for protocol tests.

The reference has no tests and no fake backend (SURVEY.md §4); its seam is
``call_gemini(prompt) -> text`` (``src/main.rs:82-86``). These fakes plug
into that exact seam so the consensus state machine can be driven through
unanimous / split / round-cap / stale-message paths without any model.
"""

from __future__ import annotations

import asyncio
import re
from collections.abc import Callable

from llm_consensus_tpu_torch.backends.base import (
    Backend,
    GenerationRequest,
    GenerationResult,
)


class FakeBackend(Backend):
    """Rule-based fake: classify the prompt kind and respond deterministically.

    By default every evaluation approves (``Good``), so a single
    propose -> evaluate round reaches unanimity — the happy path.
    Pass ``evaluator`` / ``answerer`` / ``refiner`` callables to script
    dissent, malformed verdicts, etc.
    """

    def __init__(
        self,
        answerer: Callable[[str], str] | None = None,
        evaluator: Callable[[str], str] | None = None,
        refiner: Callable[[str], str] | None = None,
        latency: float = 0.0,
    ):
        self._answerer = answerer or (lambda p: f"Echo: {_question_of(p)}")
        self._evaluator = evaluator or (lambda p: "Good\nLooks fine.")
        self._refiner = refiner or (lambda p: f"Refined: {_answer_of(p)}")
        self._latency = latency
        self.calls: list[str] = []  # raw prompts, for assertions

    async def generate_batch(
        self, requests: list[GenerationRequest]
    ) -> list[GenerationResult]:
        if self._latency:
            await asyncio.sleep(self._latency)
        results = []
        for req in requests:
            self.calls.append(req.prompt)
            kind = classify_prompt(req.prompt)
            if kind == "evaluate":
                text = self._evaluator(req.prompt)
            elif kind == "refine":
                text = self._refiner(req.prompt)
            else:
                text = self._answerer(req.prompt)
            results.append(GenerationResult(text=text, num_tokens=len(text.split())))
        return results


class ScriptedBackend(Backend):
    """Returns scripted responses in FIFO order regardless of prompt.

    Useful for driving exact multi-round traces through the coordinator.
    """

    def __init__(self, script: list[str]):
        self.script = list(script)
        self.calls: list[str] = []

    async def generate_batch(
        self, requests: list[GenerationRequest]
    ) -> list[GenerationResult]:
        results = []
        for req in requests:
            self.calls.append(req.prompt)
            if not self.script:
                raise AssertionError("ScriptedBackend ran out of responses")
            results.append(GenerationResult(text=self.script.pop(0)))
        return results


def classify_prompt(prompt: str) -> str:
    """Heuristically classify which protocol step produced a prompt.

    Keyed off distinguishing phrases of the three prompt builders
    (reference ``src/main.rs:95,118,173``).
    """
    if "answer by consensus" in prompt and "evaluate this answer" in prompt:
        return "evaluate"
    if "you said it needed refinement" in prompt:
        return "refine"
    return "answer"


_QUESTION_RE = re.compile(r"Question: (.*)")
_ANSWER_RE = re.compile(r"Answer: (.*)")


def _question_of(prompt: str) -> str:
    m = _QUESTION_RE.search(prompt)
    if m:
        return m.group(1)
    # Initial-answer prompt: question is the text after the double newline
    # (reference src/main.rs:95).
    parts = prompt.split("\n\n", 1)
    return parts[1] if len(parts) > 1 else prompt


def _answer_of(prompt: str) -> str:
    m = _ANSWER_RE.search(prompt)
    return m.group(1) if m else prompt
