"""Device choice for the port's entry points.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``, as the tests do). Without a card they raise: nothing
falls back to the CPU quietly.
"""

from __future__ import annotations

import numpy as np
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


def h2d(x, device: torch.device, dtype=None) -> torch.Tensor:
    """A host value (number, list, numpy array) as a tensor on ``device``.

    The value is copied first, so a later host mutation can never reach
    the device. To the card the copy goes from a freshly pinned buffer
    with ``non_blocking=True``: it is ordered on the current stream like
    a kernel, and the host does not wait for the work already queued
    there (a copy from pageable memory would). PyTorch's pinned-memory
    allocator hands a buffer out again only after its copy has run.
    """
    t = torch.from_numpy(np.array(x))
    if dtype is not None:
        t = t.to(dtype)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
