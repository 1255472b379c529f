"""The device rule of the port: the card is the default, the CPU is asked for.

Every entry point takes ``device="cuda"`` and passes it through
``resolve_device``.  Without a GPU that raises, unless the caller asked for
``"cpu"`` explicitly — nothing quietly carries on on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "to_device", "counter_generator"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Normalize ``device`` and check that it exists.

    ``"cuda"`` resolves to the current CUDA device with its index, so two
    resolved devices compare equal exactly when they are the same card.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but no CUDA device is "
                "available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"device {str(device)!r} requested but only "
                               f"{torch.cuda.device_count()} CUDA device(s) "
                               "are visible")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}; "
                         "expected 'cuda[:i]' or 'cpu'")
    return dev


def to_device(tree, device: torch.device):
    """Move every tensor of a nested dict/list tree to ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def counter_generator(*counters: int,
                      device: str | torch.device = "cpu") -> torch.Generator:
    """A generator on ``device`` seeded from the integers ``counters``
    alone (e.g. ``(seed, step, shard)``), through numpy's ``SeedSequence``:
    the same counters give the same draws on every run, so a resumed run
    needs no generator state."""
    key = np.random.SeedSequence(list(counters)).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(key[0]))
