"""Device choice for the port's entry points.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``, as the tests do). Without a card they raise: nothing
falls back to the CPU quietly.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run on the CPU"
        )
    return dev


def to_device(node, device: torch.device):
    """A parameter tree (nested dicts of tensors or quantized leaves,
    anything with ``.to``) moved to ``device``."""
    if isinstance(node, dict):
        return {k: to_device(v, device) for k, v in node.items()}
    return node.to(device)
