"""Prompt builders for the consensus protocol.

Parity targets in the reference:
- answer prompt: ``src/main.rs:95``
- evaluation rubric with two few-shot examples: ``src/main.rs:111-136``
- refinement prompt: ``src/main.rs:166-175``

Both rubric-bearing prompts strip every double-quote character before being
sent (``.replace('\"', '')`` at ``src/main.rs:136,175``) — preserved here as
documented behavior so downstream eval parsing sees the same distribution.
"""

from __future__ import annotations

from llm_consensus_tpu_torch.consensus.personas import Persona


def answer_prompt(question: str) -> str:
    """Initial-answer prompt (reference ``src/main.rs:95``)."""
    return (
        "Please answer the following question without referring to yourself "
        f"as a language model:\n\n{question}"
    )


def evaluation_prompt(question: str, answer: str, persona: Persona) -> str:
    """Panel-evaluation rubric (reference ``src/main.rs:111-136``).

    Instructs the judge to emit exactly ``Good`` or ``NeedsRefinement`` on the
    first line and reasoning on following lines; off-domain judges must answer
    ``Good`` (the reference's abstention-maps-to-approve rule,
    ``src/main.rs:122``).
    """
    prompt = f"""
---
Question: {question}
---
Answer: {answer}
---
Your Instructions:
You are part of a team of LLMs that were given the above question to answer by consensus. The first model chosen answered with the answer above. You need to evaluate this answer based on your knowledge domain of {persona.domain}. The only answers you may provide are Good and NeedsRefinement.

Consider how the answer might indirectly or tangentially relate to the domain. A direct connection is not required. Focus on how the answer could enable, inspire, or be used in activities related to the domain. Specifically, you should consider aspects like:{persona.tuning}

The most important part of choosing your answer is whether the question is related to your domain at all. If it is not, then you should answer exactly Good since you are not qualified to evaluate the answer. Otherwise, if you think this was a good answer, respond with exactly Good. If you think this was a bad answer, respond with exactly NeedsRefinement. Additionally, you must also provide reasoning for why you think this answer is Good or NeedsRefinement answer by putting that reasoning on a new line.
---
Examples:

Question: What's a good beginner programming language?
Answer: Python
Your domain: art and imagination
Evaluation: Good
Reasoning: This isn't related to your domain.

Question: How can I make my software easier to update?
Answer: Decoupling
Your domain: technical rigor
Evaluation: NeedsRefinement
Reasoning: Decoupling and high cohesion are only one aspect of maintainable software, and the answer doesn't go into enough detail."""
    return prompt.replace('"', "")


def refinement_prompt(question: str, answer: str, persona: Persona) -> str:
    """Refinement prompt (reference ``src/main.rs:166-175``)."""
    prompt = f"""
---
Question: {question}
---
Answer: {answer}
---
Your Instructions:
A user asked this question, and they received the specified answer. When asked to evaluate this answer, you said it needed refinement. Please refine the answer as necessary for your knowledge domain, {persona.domain}.

Specifically, keep the following things in mind while refining the answer. They do not need to be included, but they should influence your refinement:{persona.tuning}"""
    return prompt.replace('"', "")
