"""Consensus coordinator: the propose -> panel-evaluate -> refine state machine.

Parity target: the reference's ``Coordinator`` actix actor
(``src/main.rs:187-348``) — state {question, feedback map, answer,
evaluation_count} (``:189-195``), handlers for AskQuestion (``:220-239``,
random proposer), AnswerQuestion (``:242-256``, broadcast evaluate to ALL
panelists including the author), AnswerEvaluation (``:259-291``, tally; on
any dissent pick a random dissenter to refine), AnswerRefinement
(``:293-314``, round cap: below cap re-broadcast evaluation, at cap force
all feedback to Good), AnswerReadinessRequest (``:316-325``) and GetAnswer
(``:327-336``) read path, Reset (``:338-345``).

TPU-native redesign decisions (SURVEY.md §7 step 3):

- **No actors.** A plain state machine with pure transition methods
  (``on_answer`` / ``on_evaluation`` / ``on_refinement``) plus an asyncio
  runner (``run``). Concurrency lives in the backend, not the protocol.
- **Epoch/round tags** on every message; stale messages are dropped
  (fixes the reference race where a late round-k evaluation lands after
  ``feedback.clear()`` for round k+1 — SURVEY.md §5 quirk #6).
- **Batched fan-out.** A panel evaluation round is ONE
  ``Backend.generate_batch`` call — on TPU the whole panel is a batch axis
  of a single device program, not N HTTP requests
  (reference ``src/main.rs:250-253``).
- **Configurable round cap** (the reference hard-codes 5 with a TODO at
  ``src/main.rs:299-300``).
- **Failure detection**: per-call timeout + retries; a failed evaluation
  degrades to ``NeedsRefinement`` instead of panicking (the reference
  ``expect``-panics on any backend error, ``src/main.rs:85,97,138,178``).

PyTorch port: the same state machine as
``llm_consensus_tpu.consensus.coordinator``, without the gateway's
metrics and request-tracing hooks (they come with the serving slice).
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import random
from dataclasses import dataclass, field

from llm_consensus_tpu_torch.backends.base import (
    Backend,
    BackendError,
    GenerationRequest,
    GenerationResult,
    SamplingParams,
)
from llm_consensus_tpu_torch.consensus.messages import (
    AnswerEvaluation,
    AnswerQuestion,
    AnswerRefinement,
    EvaluateAnswer,
    Feedback,
    RefineAnswer,
    TranscriptEvent,
)
from llm_consensus_tpu_torch.consensus.parsing import parse_evaluation
from llm_consensus_tpu_torch.consensus.personas import Persona
from llm_consensus_tpu_torch.consensus.prompts import (
    answer_prompt,
    evaluation_prompt,
    refinement_prompt,
)
log = logging.getLogger(__name__)


@dataclass(frozen=True)
class CoordinatorConfig:
    # Max evaluation rounds; the reference hard-codes 5
    # ("TODO: Make max count configurable.", src/main.rs:299-300).
    max_rounds: int = 5
    # RNG seed for proposer/refiner selection; None = nondeterministic
    # (the reference uses thread_rng, src/main.rs:229,272).
    seed: int | None = None
    # Per-backend-call timeout (seconds); None disables. Failure-detection
    # subsystem — NOT PRESENT in the reference (SURVEY.md §5).
    call_timeout: float | None = None
    # Retries per backend call before declaring failure.
    retries: int = 1
    # Sampling params used for panel calls unless a persona overrides.
    sampling: SamplingParams = field(default_factory=SamplingParams)
    # Consensus phase -> model routing: with a multi-model
    # backend (serving.modelset.ModelSetBackend), map
    # "propose"/"evaluate"/"refine" to member names — propose on the
    # small proposer, judge/refine on the large — and every request of
    # that phase carries the mapped model tag (overriding any
    # per-persona model). None (default) = per-persona models only.
    # Phases absent from the map fall back the same way. ``ModelSet.phase_models()`` builds the canonical map.
    phase_models: dict[str, str] | None = None


@dataclass
class ConsensusResult:
    answer: str
    rounds: int
    # True if the final answer was genuinely endorsed by a unanimous panel;
    # False when the round cap forced termination (the reference silently
    # overwrites feedback to Good at the cap, src/main.rs:308-311 —
    # SURVEY.md §5 quirk #5; we surface the distinction).
    endorsed: bool
    author: str
    feedback: dict[str, Feedback]
    transcript: list[TranscriptEvent]


class Coordinator:
    """Drives one panel through the consensus protocol.

    Offers two API styles:

    - :meth:`run` — sequential async runner returning a
      :class:`ConsensusResult` (the idiomatic entry point).
    - REPL-parity methods mirroring the reference message surface:
      :meth:`ask_question` (spawns a background task),
      :meth:`answer_ready`, :meth:`get_answer`, :meth:`reset`
      (reference ``src/main.rs:442-470``).
    """

    def __init__(
        self,
        panel: list[Persona],
        backend: Backend,
        config: CoordinatorConfig | None = None,
        backends: dict[str, Backend] | None = None,
    ):
        if not panel:
            raise ValueError("panel must contain at least one persona")
        names = [p.name for p in panel]
        if len(set(names)) != len(names):
            # The reference silently clobbers duplicate names in its actor
            # map (src/main.rs:214) — SURVEY.md §5 quirk #6; we reject.
            raise ValueError(f"duplicate persona names in panel: {names}")
        self.panel = list(panel)
        self.backend = backend
        self.backends = backends or {}
        self.config = config or CoordinatorConfig()
        self._rng = random.Random(self.config.seed)

        # Protocol state (reference src/main.rs:189-195).
        self.epoch = 0
        self.current_question: str | None = None
        self.answer: str | None = None
        self.answer_author: str | None = None
        self.feedback: dict[str, Feedback] = {}
        self.evaluation_count = 0
        self._forced_termination = False
        self.transcript: list[TranscriptEvent] = []
        self._task: asyncio.Task | None = None

    # ------------------------------------------------------------------
    # Registration / reset (reference src/main.rs:210-218, :198-203)
    # ------------------------------------------------------------------

    def register(self, persona: Persona, backend: Backend | None = None) -> None:
        """Add a panelist (reference ``Register``, ``src/main.rs:210-218``)."""
        if any(p.name == persona.name for p in self.panel):
            raise ValueError(f"persona {persona.name!r} already registered")
        self.panel.append(persona)
        if backend is not None:
            self.backends[persona.name] = backend
        log.debug("%s registered with Coordinator.", persona.name)

    def reset(self) -> None:
        """Clear per-question state, keep the panel
        (reference ``reset``, ``src/main.rs:198-203``); bumps the epoch so
        any in-flight stale message is dropped."""
        self._reset_state()
        self._task = None

    def _reset_state(self) -> None:
        # Used by run() at question start: clears protocol state WITHOUT
        # dropping the background-task handle that ask_question holds.
        self.current_question = None
        self.answer = None
        self.answer_author = None
        self.feedback.clear()
        self.evaluation_count = 0
        self._forced_termination = False
        self.epoch += 1

    # ------------------------------------------------------------------
    # Pure state transitions (unit-testable; epoch/round staleness checks)
    # ------------------------------------------------------------------

    def _stale(self, epoch: int, round_: int | None = None) -> bool:
        if epoch != self.epoch:
            return True
        return round_ is not None and round_ != self.evaluation_count

    def on_answer(self, msg: AnswerQuestion) -> list[EvaluateAnswer]:
        """Accept a proposed answer; emit the evaluation fan-out
        (reference ``src/main.rs:242-256``). The author is included in the
        fan-out, as in the reference broadcast (quirk #2)."""
        if self._stale(msg.epoch):
            log.debug("Dropping stale AnswerQuestion (epoch %d)", msg.epoch)
            return []
        self.answer = msg.answer
        self.answer_author = msg.author
        self.evaluation_count += 1
        self.feedback.clear()
        self._event("answer", {"author": msg.author, "answer": msg.answer})
        assert self.current_question is not None
        return [
            EvaluateAnswer(
                question=self.current_question,
                answer=msg.answer,
                epoch=self.epoch,
                round=self.evaluation_count,
            )
            for _ in self.panel
        ]

    def on_evaluation(
        self, msg: AnswerEvaluation
    ) -> tuple[str, RefineAnswer] | None:
        """Record one verdict; when the tally is complete and non-unanimous,
        pick a random dissenter and emit a refinement request
        (reference ``src/main.rs:259-291``). Stale (wrong epoch/round)
        verdicts are dropped — the fix for SURVEY.md §5 quirk #6."""
        if self._stale(msg.epoch, msg.round):
            log.debug(
                "Dropping stale AnswerEvaluation from %s (epoch %d round %d)",
                msg.name,
                msg.epoch,
                msg.round,
            )
            return None
        log.debug(
            "%s evaluated the answer as %s. %s",
            msg.name,
            msg.evaluation.value,
            msg.reasoning,
        )
        self.feedback[msg.name] = msg.evaluation
        self._event(
            "evaluation",
            {"name": msg.name, "verdict": msg.evaluation.value, "reasoning": msg.reasoning},
        )
        if len(self.feedback) != len(self.panel):
            return None
        if all(f is Feedback.GOOD for f in self.feedback.values()):
            return None
        dissenters = [
            name
            for name, f in self.feedback.items()
            if f is Feedback.NEEDS_REFINEMENT
        ]
        refiner = self._rng.choice(dissenters)
        log.debug("Asking %s to refine the answer.", refiner)
        assert self.current_question is not None and self.answer is not None
        return refiner, RefineAnswer(
            question=self.current_question,
            answer=self.answer,
            epoch=self.epoch,
            round=self.evaluation_count,
        )

    def on_refinement(self, msg: AnswerRefinement) -> list[EvaluateAnswer]:
        """Accept a refined answer. Below the round cap, clear feedback and
        re-emit the evaluation fan-out; at the cap, force-approve
        (reference ``src/main.rs:293-314``; cap semantics = quirk #5:
        the final answer may be un-endorsed)."""
        if self._stale(msg.epoch, msg.round):
            log.debug(
                "Dropping stale AnswerRefinement (epoch %d round %d)",
                msg.epoch,
                msg.round,
            )
            return []
        self.answer = msg.answer
        if msg.author:
            self.answer_author = msg.author
        self._event("refinement", {"author": msg.author, "answer": msg.answer})
        if self.evaluation_count < self.config.max_rounds:
            self.evaluation_count += 1
            self.feedback.clear()
            log.debug("Asking actors to evaluate new answer.")
            assert self.current_question is not None
            return [
                EvaluateAnswer(
                    question=self.current_question,
                    answer=msg.answer,
                    epoch=self.epoch,
                    round=self.evaluation_count,
                )
                for _ in self.panel
            ]
        log.debug("Evaluated the maximum number of times. Breaking the loop.")
        self._forced_termination = True
        for name in self.feedback:
            self.feedback[name] = Feedback.GOOD
        return []

    def answer_ready(self) -> bool:
        """Readiness predicate (reference ``src/main.rs:316-325``)."""
        return (
            self.answer is not None
            and bool(self.feedback)
            and len(self.feedback) == len(self.panel)
            and all(f is Feedback.GOOD for f in self.feedback.values())
        )

    def get_answer(self) -> str:
        """Read the answer; error string when absent
        (reference ``src/main.rs:327-336``)."""
        if self.answer is not None:
            return self.answer
        return "System error: Requested answer when answer was not ready."

    # ------------------------------------------------------------------
    # Async runner
    # ------------------------------------------------------------------

    async def run(self, question: str) -> ConsensusResult:
        """Drive one question to consensus and return the result."""
        self._reset_state()
        epoch = self.epoch
        self.current_question = question
        self._event("question", {"question": question})

        # Random proposer (reference src/main.rs:228-234; quirk #1).
        proposer = self._rng.choice(self.panel)
        log.debug("Received AskQuestion: %s", question)
        result = await self._call_persona(
            proposer, answer_prompt(question), required=True,
            phase="propose",
        )
        fanout = self.on_answer(
            AnswerQuestion(answer=result.text, author=proposer.name, epoch=epoch)
        )

        while fanout:
            # Panel fan-out as ONE batched backend call per backend group
            # (the reference sends N concurrent HTTP requests,
            # src/main.rs:250-253; on TPU this is one batched decode).
            assert self.answer is not None
            round_ = self.evaluation_count
            texts = await self._generate_for_panel(
                [
                    evaluation_prompt(question, self.answer, p)
                    for p in self.panel
                ],
                phase="evaluate",
            )
            refinement_request: tuple[str, RefineAnswer] | None = None
            for persona, text in zip(self.panel, texts):
                verdict, reasoning = parse_evaluation(text)
                out = self.on_evaluation(
                    AnswerEvaluation(
                        name=persona.name,
                        evaluation=verdict,
                        reasoning=reasoning,
                        epoch=epoch,
                        round=round_,
                    )
                )
                if out is not None:
                    refinement_request = out
            if refinement_request is None:
                break  # unanimous
            refiner_name, refine_msg = refinement_request
            refiner = self._persona(refiner_name)
            rres = await self._call_persona(
                refiner,
                refinement_prompt(
                    refine_msg.question, refine_msg.answer, refiner
                ),
                required=True,
                phase="refine",
            )
            fanout = self.on_refinement(
                AnswerRefinement(
                    answer=rres.text,
                    author=refiner.name,
                    epoch=epoch,
                    round=round_,
                )
            )

        final = ConsensusResult(
            answer=self.get_answer(),
            rounds=self.evaluation_count,
            endorsed=self.answer_ready() and not self._forced_termination,
            author=self.answer_author or "",
            feedback=dict(self.feedback),
            transcript=list(self.transcript),
        )
        log.info("Final answer: %s", final.answer)
        return final

    # REPL-parity surface (reference src/main.rs:442-470) -----------------

    async def ask_question(self, question: str) -> bool:
        """Start answering in the background (reference ``AskQuestion`` send
        + polling loop contract, ``src/main.rs:442-459``)."""
        if self._task is not None and not self._task.done():
            return False
        self._task = asyncio.create_task(self.run(question))
        return True

    async def wait_for_answer(self, poll_interval: float = 0.0) -> str:
        """Await completion (replaces the reference's 500 ms hot-spin poll,
        ``src/main.rs:448-459``, with a real await)."""
        if self._task is None:
            return self.get_answer()
        await self._task
        return self.get_answer()

    # ------------------------------------------------------------------
    # Backend plumbing: grouping, timeout, retries
    # ------------------------------------------------------------------

    def _persona(self, name: str) -> Persona:
        for p in self.panel:
            if p.name == name:
                return p
        raise KeyError(name)

    def _backend_for(self, persona: Persona) -> Backend:
        return self.backends.get(persona.name, self.backend)

    def _model_for(self, persona: Persona, phase: str | None) -> str | None:
        """The model tag one phase call carries: the phase-routing map
        wins (cross-model consensus), else the persona's own."""
        pm = self.config.phase_models
        if phase is not None and pm:
            routed = pm.get(phase)
            if routed is not None:
                return routed
        return persona.model

    def _params_for(self, persona: Persona) -> SamplingParams:
        base = self.config.sampling
        if persona.temperature is None:
            return base
        return dataclasses.replace(base, temperature=persona.temperature)

    async def _generate_for_panel(
        self, prompts: list[str], phase: str | None = None
    ) -> list[str]:
        """Batch prompts per backend (heterogeneous panels use several) and
        run the groups concurrently. A failed evaluation degrades to a
        ``NeedsRefinement`` verdict instead of crashing the protocol."""
        groups: dict[int, tuple[Backend, list[int], list[GenerationRequest]]] = {}
        for i, (persona, prompt) in enumerate(zip(self.panel, prompts)):
            backend = self._backend_for(persona)
            key = id(backend)
            if key not in groups:
                groups[key] = (backend, [], [])
            groups[key][1].append(i)
            groups[key][2].append(
                GenerationRequest(
                    prompt=prompt,
                    params=self._params_for(persona),
                    model=self._model_for(persona, phase),
                )
            )

        texts: list[str] = [""] * len(prompts)

        async def _run_group(backend: Backend, idxs: list[int], reqs) -> None:
            try:
                results = await self._with_supervision(
                    lambda: backend.generate_batch(reqs)
                )
            except BackendError as e:
                log.error("Evaluation batch failed: %s", e)
                results = [
                    GenerationResult(text="NeedsRefinement\nBackend failure: " + str(e))
                    for _ in reqs
                ]
            for i, r in zip(idxs, results):
                texts[i] = r.text

        await asyncio.gather(
            *(_run_group(b, idxs, reqs) for b, idxs, reqs in groups.values())
        )
        return texts

    async def _call_persona(
        self,
        persona: Persona,
        prompt: str,
        required: bool,
        phase: str | None = None,
    ) -> GenerationResult:
        backend = self._backend_for(persona)
        req = GenerationRequest(
            prompt=prompt,
            params=self._params_for(persona),
            model=self._model_for(persona, phase),
        )
        try:
            return await self._with_supervision(lambda: backend.generate(req))
        except BackendError:
            if required:
                raise
            return GenerationResult(text="")

    async def _with_supervision(self, thunk):
        """Timeout + bounded retries around a backend call (failure-detection
        subsystem; the reference panics instead, ``src/main.rs:85,97``)."""
        attempts = max(1, self.config.retries + 1)
        last: Exception | None = None
        for attempt in range(attempts):
            try:
                coro = thunk()
                if self.config.call_timeout is not None:
                    return await asyncio.wait_for(coro, self.config.call_timeout)
                return await coro
            except (asyncio.TimeoutError, BackendError, OSError) as e:
                last = e
                log.warning(
                    "Backend call failed (attempt %d/%d): %s", attempt + 1, attempts, e
                )
        raise BackendError(f"backend call failed after {attempts} attempts: {last}")

    def _event(self, kind: str, payload: dict) -> None:
        self.transcript.append(
            TranscriptEvent(
                kind=kind,
                epoch=self.epoch,
                round=self.evaluation_count,
                payload=payload,
            )
        )
