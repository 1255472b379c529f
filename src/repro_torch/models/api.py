"""Family-dispatched model API of the port (``repro.models.api``): every
decoder-only architecture exposes the same entry points, so serving is
architecture-agnostic.

    init_params(cfg, generator, device)    → params (default on the card)
    forward(params, cfg, batch)            → logits (B, S, V)
    prefill_fn(params, cfg, batch)         → (last-token logits, cache)
    decode_fn(params, cfg, cache, tokens)  → (logits, cache)
    init_cache(cfg, batch, max_len, device)→ zero caches

Only the dense family runs so far; ``transformer`` raises for the others,
naming their ROADMAP item (queue A item 14).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig

__all__ = ["InputShape", "SHAPES", "init_params", "forward", "prefill_fn",
           "decode_fn", "init_cache"]


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: str | torch.device = "cuda") -> dict:
    return transformer.init_params(cfg, generator, device)


def forward(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    return transformer.forward(params, cfg, batch["tokens"])


def prefill_fn(params: dict, cfg: ModelConfig, batch: dict) -> tuple:
    return transformer.prefill(params, cfg, batch["tokens"])


def decode_fn(params: dict, cfg: ModelConfig, cache: dict,
              tokens: torch.Tensor) -> tuple:
    return transformer.decode_step(params, cfg, cache, tokens)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: str | torch.device = "cuda") -> dict:
    return transformer.init_cache(cfg, batch, max_len, device)
