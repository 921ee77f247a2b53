"""Persona (panel member) definitions.

The reference hard-codes four personas inline in ``main``
(``src/main.rs:359-426``): each has a ``name``, a knowledge ``domain``, and a
ten-bullet ``tuning`` string that conditions its evaluation/refinement
prompts. Here personas are plain data, loadable from JSON/dict config
(fixing the hard-coding noted in SURVEY.md §7 step 4), and may additionally
pin a *model* and *sampling params* so heterogeneous panels (different
weights per persona, BASELINE.md config[3]) are expressible.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path


@dataclass(frozen=True)
class Persona:
    name: str
    domain: str
    tuning: str
    # TPU-build extensions (absent in the reference):
    model: str | None = None  # model preset name; None = panel default
    weight: float = 1.0  # vote weight for weighted aggregation
    temperature: float | None = None  # sampling override

    @staticmethod
    def from_dict(d: dict) -> "Persona":
        return Persona(
            name=d["name"],
            domain=d["domain"],
            tuning=d["tuning"],
            model=d.get("model"),
            weight=float(d.get("weight", 1.0)),
            temperature=d.get("temperature"),
        )

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "domain": self.domain,
            "tuning": self.tuning,
            "model": self.model,
            "weight": self.weight,
            "temperature": self.temperature,
        }


def load_panel(path: str | Path) -> list[Persona]:
    """Load a panel from a JSON file: a list of persona dicts."""
    data = json.loads(Path(path).read_text())
    return [Persona.from_dict(d) for d in data]


def save_panel(panel: list[Persona], path: str | Path) -> None:
    Path(path).write_text(json.dumps([p.to_dict() for p in panel], indent=2))


# The default panel ships the same four domain personas as the reference
# (``src/main.rs:359-426``): names, domains, and the ten tuning bullets per
# persona match the reference's inline literals so a switching user gets the
# same panel behavior out of the box.

_HIGH_SOCIETY_TUNING = """
* Social norms, values, and beliefs
* Historical context and events
* Cultural diversity and traditions
* Social structures and institutions (e.g., family, education, government)
* Impact on human behavior and interactions
* Ethical and moral considerations
* Current events and social issues
* Demographics and population trends
* Communication styles and languages
* Arts, literature, and folklore as reflections of society"""

_TECHNICIAN_TUNING = """
* Accuracy and precision of information
* Specific measurements, quantities, and units
* Technical specifications and standards
* Detailed procedures and processes
* Scientific principles and theories
* Mathematical formulas and equations
* Logical reasoning and problem-solving
* Causality and cause-and-effect relationships
* Step-by-step explanations and instructions
* Attention to detail and completeness"""

_ART_BOY_TUNING = """
* Creative expression and generation across various mediums (visual, auditory, written, etc.)
* Tools and techniques for artistic creation (digital and traditional)
* Exploration of emotions, ideas, and concepts through art
* Imagination, innovation, and originality
* Aesthetic qualities and principles (e.g., composition, color, form)
* Art history, movements, and styles
* Cultural and social influences on art
* Potential for visualizing data or creating simulations for artistic purposes
* Interactive art and installations
* The role of art in communication and storytelling"""

_PROGRAMMING_NERD_TUNING = """
* Algorithms and data structures
* Programming languages and paradigms
* Software engineering principles
* Computer architecture and hardware
* Networking and distributed systems
* Artificial intelligence and machine learning
* Cybersecurity and data privacy
* Computational theory and complexity
* Databases and data management
* Operating systems and system programming"""


def default_panel() -> list[Persona]:
    """The reference's four-persona panel (``src/main.rs:359-426``)."""
    return [
        Persona("High Society", "Society and Culture", _HIGH_SOCIETY_TUNING),
        Persona("The Technician", "Technical Detail", _TECHNICIAN_TUNING),
        Persona("Art Boy", "Art and Imagination", _ART_BOY_TUNING),
        Persona("Programming Nerd", "Computer Science", _PROGRAMMING_NERD_TUNING),
    ]
