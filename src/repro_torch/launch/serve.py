"""Batched LM serving loop (``repro.launch.serve``): continuous-batching
slots over the family-agnostic model API, carried over unchanged.

  * a fixed pool of ``slots`` sequences with one shared ``max_len`` KV cache
    and one shared position (slots admitted together share the timeline),
  * ``run()`` admits up to ``slots`` queued requests once, left-pads their
    prompts with token 0 and teacher-forces them through decode steps, then
    decodes greedily one token per active slot per step,
  * a sequence that hits EOS or its budget frees its slot; a request left in
    the queue waits for the next ``run()``.

The engine decodes only (plain attention over the cache); the kernel path of
the LM is ``transformer.prefill`` / ``api.prefill_fn``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
        --reduced --device cpu

Without ``--device cpu`` it runs on the card, and raises where there is none.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import time

import torch

from repro_torch import configs
from repro_torch.device import counter_generator, resolve_device
from repro_torch.models import api
from repro_torch.models.config import ModelConfig

# the CLI's synthetic load: one admission of REQUESTS prompts on SLOTS slots
SLOTS, MAX_LEN, REQUESTS, PROMPT_LEN, NEW_TOKENS, SEED = 4, 256, 4, 16, 16, 0


@dataclasses.dataclass
class Request:
    prompt: list
    max_new_tokens: int = 16
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params: dict, slots: int = 4,
                 max_len: int = 256, eos_id: int | None = None,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.device = resolve_device(device)
        self.cache = api.init_cache(cfg, slots, max_len, self.device)
        self.active: list = [None] * slots
        self.budget = [0] * slots
        self.queue: collections.deque = collections.deque()

    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        for s in range(self.slots):
            if self.active[s] is None and self.queue:
                req = self.queue.popleft()
                self.active[s] = req
                self.budget[s] = req.max_new_tokens

    def _decode(self, tokens: list) -> torch.Tensor:
        toks = torch.tensor(tokens, dtype=torch.long, device=self.device)
        logits, self.cache = api.decode_fn(self.params, self.cfg, self.cache,
                                           toks[:, None])
        return logits

    def run(self, max_steps: int = 512) -> list:
        """Simple batch mode: admit up to ``slots`` requests, prefill each by
        teacher-forcing its prompt through decode steps, then decode."""
        finished = []
        self._admit()
        # shorter prompts are left-padded with 0s; their outputs are ignored
        # until the prompt ends
        prompts = [r.prompt if r else [0] for r in self.active]
        plen = max((len(p) for p in prompts), default=1)
        prompts = [[0] * (plen - len(p)) + list(p) for p in prompts]
        logits = None
        for t in range(plen):
            logits = self._decode([p[t] for p in prompts])
        step = 0
        while any(r is not None for r in self.active) and step < max_steps:
            nxt = logits[:, -1].argmax(-1).tolist()
            for s, r in enumerate(self.active):
                if r is None:
                    continue
                r.out.append(nxt[s])
                self.budget[s] -= 1
                if (self.eos_id is not None and nxt[s] == self.eos_id) \
                        or self.budget[s] <= 0:
                    r.done = True
                    finished.append(r)
                    self.active[s] = None
            logits = self._decode(nxt)
            step += 1
        return finished


def main(argv=None) -> list:
    """Serve ``REQUESTS`` synthetic prompts of ``PROMPT_LEN`` tokens with
    random weights from ``SEED``; prints each request's tokens and the wall
    time."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b",
                    choices=configs.ARCH_NAMES)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = (configs.get_reduced if args.reduced else configs.get_config)(
        args.arch)
    device = resolve_device(args.device)
    params = api.init_params(cfg, counter_generator(SEED, device=device),
                             device)
    engine = ServingEngine(cfg, params, SLOTS, MAX_LEN, device=device)
    gen = counter_generator(SEED, 1)
    for _ in range(REQUESTS):
        prompt = torch.randint(1, cfg.vocab_size, (PROMPT_LEN,),
                               generator=gen).tolist()
        engine.submit(Request(prompt, NEW_TOKENS))
    t0 = time.perf_counter()
    done = engine.run()
    wall = time.perf_counter() - t0
    for i, r in enumerate(done):
        print(f"req {i}: {len(r.prompt)} prompt tokens -> {r.out}")
    print(f"served {len(done)} of {REQUESTS} requests in {wall:.3f} s "
          f"on {device} ({cfg.name})")
    return done


if __name__ == "__main__":
    main()
