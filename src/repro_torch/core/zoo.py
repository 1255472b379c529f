"""Zeroth-order (BP-free) optimization — the paper's §3.3.

SPSA gradient estimator (paper Eq. 5):

    ∇̂_Φ L(Φ) = Σ_{i=1..N} (1/(Nμ)) [ L(Φ + μ ξ_i) − L(Φ) ] ξ_i ,
    ξ_i ~ N(0, I_d)

and the ZO-signSGD update (paper Eq. 6):

    Φ_t ← Φ_{t−1} − α · sign(∇̂_Φ L(Φ)).

Parameters are trees of dicts and lists of tensors, walked in the JAX
package's order (dict keys sorted, list order kept), so a ξ stack the JAX
side made maps onto the same leaves here.  Only forward evaluations are
taken: no autograd anywhere in this module.

The N perturbations are drawn once as a stacked tree (``sample_
perturbations``); the base evaluation rides along as perturbation 0, so
one step evaluates all N+1 (2N+1 antithetic) models in one batched call of
``batched_loss_fn: stacked_params -> (P,) losses`` (e.g.
``pinn.residual_losses_stacked``), and the gradient reuses the same ξ
stack as one tensordot per leaf.  Fixed buffers (``trainable_mask`` False,
the photonic ±1 diags) carry zero ξ, so they are neither probed nor moved.

The sequential path (``loss_fn`` and no ``batched_loss_fn``) evaluates
the models one at a time, the order a photonic chip with one physical mesh
runs them in: the base loss first, then N separate ``loss_fn`` calls
(``spsa_losses``).  It draws the same stacked ξ from the same generator as
the fused path, so the two paths of one seed probe the same directions.

Random draws come from an explicit ``torch.Generator`` on the params'
device; ``zo_signsgd_step`` re-seeds it per step from ``(seed, step)``
(``device.counter_generator``), so a resumed run redraws the same ξ.
Torch's generators do not give JAX's threefry bits: the parity tests feed
both packages the same ξ arrays (``xis=``).

Distributed ZO: every worker regenerates the same ξ from the shared
generator seed, evaluates its slice ``index_shard=(lo, hi)`` of the N
losses (``spsa_losses``), and one ``all_reduce`` over a process ``group``
(where the JAX package takes an ``axis_name``) merges the zero-scattered
N-vector, so every worker rebuilds the same gradient from O(N) scalars
(``spsa_gradient``).  The two-axis version, with collocation-batch
sharding and the padded [base, ξ_1..ξ_N] stack, is
``repro_torch.parallel.zo_shard``.

Port of ``repro.core.zoo``; the vmapped generic evaluator
(``vectorized``) and the plain ĝ step (``sign_update=False``) are not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.device import counter_generator

__all__ = ["SPSAConfig", "tree_leaves", "tree_map", "sample_perturbation",
           "sample_perturbations", "perturbed_stack", "spsa_losses",
           "spsa_gradient_from_losses", "spsa_gradient", "ZOState",
           "zo_signsgd_step", "apply_update", "all_reduce_sum"]

PyTree = Any


@dataclasses.dataclass(frozen=True)
class SPSAConfig:
    num_samples: int = 10     # N in Eq. (5) — the paper uses 10 per step
    mu: float = 0.01          # sampling radius μ
    antithetic: bool = False  # ±μ pairs (beyond the paper)


def tree_leaves(tree) -> list:
    """Leaves in the JAX package's flattening order: dict keys sorted,
    list and tuple order kept."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of same-structured ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _unflatten_like(tree, leaves: list):
    """Rebuild ``tree``'s structure from leaves in ``tree_leaves`` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return next(it)

    return build(tree)


def _mask_flags(params: PyTree, mask: PyTree | None) -> list:
    leaves = tree_leaves(params)
    if mask is None:
        return [True] * len(leaves)
    flags = tree_leaves(mask)
    if len(flags) != len(leaves):
        raise ValueError(
            f"trainable mask has {len(flags)} leaves, params have "
            f"{len(leaves)} — the mask must mirror the params tree")
    return [bool(f) for f in flags]


def sample_perturbations(generator: torch.Generator, params: PyTree, n: int,
                         mask: PyTree | None = None) -> PyTree:
    """All N perturbations as one stacked tree (leading axis n): ξ ~ N(0, I)
    drawn leaf by leaf in flattening order on the leaf's device, exactly
    zero on buffer leaves (``mask`` False)."""
    flags = _mask_flags(params, mask)
    leaves = [torch.randn((n, *leaf.shape), generator=generator,
                          dtype=leaf.dtype, device=leaf.device) if train
              else torch.zeros((n, *leaf.shape), dtype=leaf.dtype,
                               device=leaf.device)
              for leaf, train in zip(tree_leaves(params), flags)]
    return _unflatten_like(params, leaves)


def sample_perturbation(generator: torch.Generator, params: PyTree,
                        mask: PyTree | None = None) -> PyTree:
    """One ξ ~ N(0, I) with the structure of ``params`` (zero on buffers)."""
    return tree_map(lambda z: z[0],
                    sample_perturbations(generator, params, 1, mask))


def perturbed_stack(params: PyTree, xis: PyTree, cfg: SPSAConfig) -> PyTree:
    """The parameter sets one batched step evaluates, stacked on a leading
    axis: Φ (a zero perturbation) first, then Φ + μ ξ_i for each i, then
    Φ − μ ξ_i when antithetic."""
    def stack(p, z):
        zero = torch.zeros_like(z[:1])
        z = torch.cat([zero, z, -z] if cfg.antithetic else [zero, z])
        return p + cfg.mu * z

    return tree_map(stack, params, xis)


def spsa_gradient_from_losses(perturbed_losses: torch.Tensor,
                              base_loss: torch.Tensor, cfg: SPSAConfig,
                              xis: PyTree) -> PyTree:
    """Eq. (5) from the (N,) loss vector and the stacked ξ it was taken
    at: one tensordot per leaf.  Antithetic losses are already
    ``(L+ − L−)/2`` and the base cancels."""
    deltas = perturbed_losses if cfg.antithetic \
        else perturbed_losses - base_loss
    coefs = deltas / (cfg.num_samples * cfg.mu)               # (N,)
    return tree_map(lambda z: torch.tensordot(coefs.to(z.dtype), z, dims=1),
                    xis)


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over the ranks of ``group`` (a new tensor on ``t``'s
    device).  ``gloo`` reduces host tensors: a CUDA tensor crosses to the
    host for the collective and back, which for the O(N) loss scalars of
    distributed ZO is a few dozen bytes."""
    host = dist.get_backend(group) == "gloo" and t.device.type != "cpu"
    buf = t.detach().to("cpu", copy=True) if host else t.detach().clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(t.device) if host else buf


def spsa_losses(loss_fn: Callable[[PyTree], torch.Tensor] | None,
                params: PyTree, generator: torch.Generator | None,
                cfg: SPSAConfig, xis: PyTree | None = None,
                trainable_mask: PyTree | None = None,
                index_shard: tuple | None = None,
                batched_loss_fn: Callable[[PyTree], torch.Tensor] | None
                = None) -> torch.Tensor:
    """The N perturbed losses L(Φ + μ ξ_i) — ``(L(Φ + μ ξ_i) − L(Φ − μ
    ξ_i)) / 2`` when antithetic — as an (N,) f32 vector.  ``xis`` is the
    stacked ξ (``sample_perturbations``); without it the stack is drawn
    from ``generator``.

    Sequential by default: one ``loss_fn`` call each, in order.  With
    ``batched_loss_fn`` the slice goes through it as one stack.
    ``index_shard=(lo, hi)`` evaluates only i ∈ [lo, hi), a worker's
    slice, and leaves zeros elsewhere: the vector is ready for a sum over
    the workers, each of which used the same generator seed."""
    n = cfg.num_samples
    lo, hi = index_shard if index_shard is not None else (0, n)
    if xis is None:
        xis = sample_perturbations(generator, params, n, trainable_mask)
    if hi <= lo:
        return torch.zeros(n, dtype=torch.float32,
                           device=tree_leaves(params)[0].device)
    if batched_loss_fn is not None:
        local = tree_map(lambda z: z[lo:hi], xis)
        vals = batched_loss_fn(tree_map(lambda p, z: p + cfg.mu * z,
                                        params, local))
        if cfg.antithetic:
            lm = batched_loss_fn(tree_map(lambda p, z: p + (-cfg.mu) * z,
                                          params, local))
            vals = 0.5 * (vals - lm)
        vals = vals.to(torch.float32)
    else:
        losses = []
        for i in range(lo, hi):
            xi = tree_map(lambda z: z[i], xis)
            lp = loss_fn(tree_map(lambda p, z: p + cfg.mu * z, params, xi))
            if cfg.antithetic:
                lm = loss_fn(tree_map(lambda p, z: p + (-cfg.mu) * z,
                                      params, xi))
                lp = 0.5 * (lp - lm)
            losses.append(lp.to(torch.float32))
        vals = torch.stack(losses)
    if (lo, hi) == (0, n):
        return vals
    out = vals.new_zeros(n)
    out[lo:hi] = vals
    return out


def spsa_gradient(params: PyTree, generator: torch.Generator,
                  cfg: SPSAConfig,
                  batched_loss_fn: Callable[[PyTree], torch.Tensor] | None
                  = None,
                  trainable_mask: PyTree | None = None,
                  loss_fn: Callable[[PyTree], torch.Tensor] | None = None,
                  xis: PyTree | None = None,
                  index_shard: tuple | None = None,
                  group=None) -> tuple:
    """Eq. (5): returns ``(grad, base_loss)``.

    With ``batched_loss_fn`` the base model rides along as a zero
    perturbation, so it sees all N+1 (2N+1 antithetic) parameter sets at
    once.  Without it the path is sequential: ``loss_fn`` of the base
    params, then ``spsa_losses``.  Both draw the stacked ξ from
    ``generator`` first, unless ``xis`` hands it over.

    ``index_shard=(lo, hi)`` runs a worker's part of distributed ZO: the
    base loss (``loss_fn``, or the batched evaluator on the params alone)
    and the losses of slice [lo, hi) only.  With a process ``group`` the
    N-vector is summed over its ranks before the reconstruction, so every
    worker holds the same gradient."""
    n = cfg.num_samples
    if batched_loss_fn is None and loss_fn is None:
        raise ValueError("spsa_gradient needs loss_fn (sequential) or "
                         "batched_loss_fn (fused)")
    if xis is None:
        xis = sample_perturbations(generator, params, n, trainable_mask)
    if batched_loss_fn is not None and index_shard is None:
        all_l = batched_loss_fn(perturbed_stack(params, xis, cfg))
        base = all_l[0]
        losses = (0.5 * (all_l[1:n + 1] - all_l[n + 1:]) if cfg.antithetic
                  else all_l[1:]).to(torch.float32)
    else:
        base = (loss_fn(params) if loss_fn is not None else
                batched_loss_fn(tree_map(lambda p: p[None], params))[0])
        losses = spsa_losses(loss_fn, params, generator, cfg, xis=xis,
                             index_shard=index_shard,
                             batched_loss_fn=batched_loss_fn)
    if group is not None:
        losses = all_reduce_sum(losses, group)
    return spsa_gradient_from_losses(losses, base, cfg, xis), base


@dataclasses.dataclass
class ZOState:
    """The optimizer's state: the step count and the seed every step's
    generator is derived from."""

    step: int = 0
    seed: int = 0

    def as_tree(self) -> dict:
        """Checkpoint form (int64 tensors)."""
        return {"seed": torch.tensor(self.seed, dtype=torch.int64),
                "step": torch.tensor(self.step, dtype=torch.int64)}

    @classmethod
    def from_tree(cls, tree: dict) -> "ZOState":
        return cls(step=int(tree["step"]), seed=int(tree["seed"]))


def zo_signsgd_step(params: PyTree, state: ZOState, lr: float,
                    cfg: SPSAConfig,
                    batched_loss_fn: Callable[[PyTree], torch.Tensor] | None
                    = None,
                    trainable_mask: PyTree | None = None,
                    loss_fn: Callable[[PyTree], torch.Tensor] | None = None,
                    xis: PyTree | None = None) -> tuple:
    """One Eq. (6) update Φ ← Φ − α · sign(∇̂L), with ξ drawn on the
    params' device from ``counter_generator(state.seed, state.step)``, or
    the stacked ``xis`` handed over in its place: fused through
    ``batched_loss_fn``, or sequential through ``loss_fn`` when that is
    None.  Buffer leaves (mask False) have zero ξ, so zero gradient, and
    leave the update bit-identical.  Returns ``(params, state,
    base_loss)``."""
    gen = None
    if xis is None:
        device = tree_leaves(params)[0].device
        gen = counter_generator(state.seed, state.step, device=device)
    grad, base = spsa_gradient(params, gen, cfg, batched_loss_fn,
                               trainable_mask, loss_fn=loss_fn, xis=xis)
    return (apply_update(params, grad, lr),
            ZOState(step=state.step + 1, seed=state.seed), base)


def apply_update(params: PyTree, grad: PyTree, lr: float) -> PyTree:
    """Eq. (6): Φ − α · sign(ĝ)."""
    return tree_map(lambda p, g: p - lr * torch.sign(g).to(p.dtype), params,
                    grad)
