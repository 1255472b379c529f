"""First-order optimizers over the port's param trees (plain functions, not
``torch.optim``) — the off-chip BP baselines of the PINN trainer.

``adamw``     — f32 m/v and an int32 step count,
``adafactor`` — factored second moments (rows / columns over the last two
                axes) for leaves of two or more dimensions,
``sgd``       — momentum SGD.

State trees mirror the param tree leaf for leaf, with the JAX package's
keys, shapes and dtypes, so a checkpoint's ``opt`` subtree written here is
restored by ``repro.checkpoint.restore_checkpoint`` against the JAX
package's ``opt.init`` and the other way round.  The arithmetic follows
``repro.optim.optimizers`` operation for operation (bias corrections from
an f32 count, ``sqrt(v / b2c) + eps``); updates run outside autograd.

Port of ``repro.optim.optimizers``; ``default_optimizer_for`` (the LM
trainer's per-arch choice), ``compression`` and the ZO trainer steps of
``repro.optim`` are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.zoo import tree_leaves, tree_map

__all__ = ["Optimizer", "adamw", "adafactor", "sgd", "get_optimizer"]

PyTree = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree], tuple]  # (grads, state, params)
    name: str = "opt"


def _zeros(tree) -> PyTree:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), tree)


def _count(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


# ---------------------------------------------------------------------- AdamW

def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    """Decoupled weight decay acts on every leaf, as in the JAX package:
    a leaf whose gradient the caller zeroes still shrinks by
    ``lr · weight_decay`` a step."""
    def init(params):
        return {"m": _zeros(params), "v": _zeros(params),
                "count": _count(params)}

    @torch.no_grad()
    def update(grads, state, params):
        c = state["count"] + 1
        b1c = 1.0 - b1 ** c.to(torch.float32)
        b2c = 1.0 - b2 ** c.to(torch.float32)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_
                     + (1 - b2) * torch.square(g.float()), state["v"], grads)
        upd = tree_map(
            lambda m_, v_, p: (-lr * ((m_ / b1c) / (torch.sqrt(v_ / b2c) + eps)
                                      + weight_decay * p.float())).to(p.dtype),
            m, v, params)
        new_params = tree_map(lambda p, u: p + u, params, upd)
        return new_params, {"m": m, "v": v, "count": c}

    return Optimizer(init=init, update=update, name="adamw")


# ------------------------------------------------------------------ Adafactor

def adafactor(lr: float = 1e-3, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0) -> Optimizer:
    """Factored second-moment estimator (Shazeer & Stern 2018), no momentum;
    leaves of two or more dimensions keep row and column statistics over
    their last two axes."""

    def init(params):
        def leaf(p):
            if p.ndim >= 2:
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32,
                                          device=p.device)}
            return {"v": torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)}
        return {"v": tree_map(leaf, params), "count": _count(params)}

    @torch.no_grad()
    def update(grads, state, params):
        c = state["count"] + 1
        beta = 1.0 - c.to(torch.float32) ** (-decay)

        def leaf(g, s, p):
            g = g.float()
            g2 = torch.square(g) + eps
            if p.ndim >= 2:
                vr = beta * s["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
                vc = beta * s["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
                r_factor = torch.rsqrt(
                    vr / torch.mean(vr, dim=-1, keepdim=True) + eps)
                c_factor = torch.rsqrt(vc + eps)
                u = g * r_factor[..., None] * c_factor[..., None, :]
                new_s = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(v + eps)
                new_s = {"v": v}
            # update clipping (RMS)
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            return (p - lr * u.float()).to(p.dtype), new_s

        # the state's per-leaf dicts sit where params has a leaf: walk the
        # params' structure and take them whole (JAX's flatten_up_to)
        out = _map_up_to(lambda p, g, s: leaf(g, s, p), params, grads,
                         state["v"])
        new_params = _map_up_to(lambda p, o: o[0], params, out)
        new_v = _map_up_to(lambda p, o: o[1], params, out)
        return new_params, {"v": new_v, "count": c}

    return Optimizer(init=init, update=update, name="adafactor")


def _map_up_to(fn, tree, *rest):
    """``fn`` over the leaves of ``tree``, each with whatever sits at the
    same place in ``rest``: a subtree there is passed whole."""
    if isinstance(tree, dict):
        return {k: _map_up_to(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_up_to(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


# ----------------------------------------------------------------------- SGD

def sgd(lr: float = 1e-2, momentum: float = 0.9) -> Optimizer:
    def init(params):
        return {"m": _zeros(params)}

    @torch.no_grad()
    def update(grads, state, params):
        m = tree_map(lambda m_, g: momentum * m_ + g.float(), state["m"],
                     grads)
        new_params = tree_map(lambda p, m_: (p.float() - lr * m_).to(p.dtype),
                              params, m)
        return new_params, {"m": m}

    return Optimizer(init=init, update=update, name="sgd")


def get_optimizer(name: str, lr: float | None = None) -> Optimizer:
    if name == "adamw":
        return adamw(lr=lr or 3e-4)
    if name == "adafactor":
        return adafactor(lr=lr or 1e-3)
    if name == "sgd":
        return sgd(lr=lr or 1e-2)
    raise KeyError(name)
