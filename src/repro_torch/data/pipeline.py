"""Deterministic, restart-safe PDE data streams for ZO training.

Each step's batch is drawn from a generator keyed by ``(seed, step,
shard)`` alone, so resuming from step k regenerates exactly the batches
from k on, with no state to checkpoint.  The collocation stream owns shard
0 and the boundary/data term stream shard 1 of the same key space.
Batches are drawn on the CPU (the same batch for a seed on every device);
the caller moves them.

These are not the JAX package's streams: its keys are threefry
(``jax.random.fold_in``), these are ``torch.Generator`` seeded through
numpy's ``SeedSequence``, so the two packages draw different points from
the same seed.  Parity tests hand both packages the same arrays.

A coefficient-conditioned problem's collocation rows carry a coefficient
draw a row, or, with ``coeffs_per_step`` C, C draws a step tiled over the
batch (``tile_coeff_draws``).

Port of the PINN part of ``repro.data.pipeline``; the LM token streams
are not ported yet.
"""

from __future__ import annotations

from typing import Iterator

import torch

from repro_torch import pde as pde_lib
from repro_torch.core import spectral
from repro_torch.device import counter_generator

__all__ = ["pde_collocation_iterator", "pde_term_batch_iterator",
           "pde_line_grid_iterator", "tile_coeff_draws"]


def tile_coeff_draws(draws: torch.Tensor, n: int) -> torch.Tensor:
    """(C, K) coefficient draws → (n, K) rows: ceil(n / C) consecutive rows
    share each draw, the last group cut at n."""
    return torch.repeat_interleave(draws, -(-n // draws.shape[0]),
                                   dim=0)[:n]


def pde_collocation_iterator(n: int, seed: int = 0, start_step: int = 0,
                             pde: str | None = None,
                             problem: pde_lib.PDEProblem | None = None,
                             coeffs_per_step: int | None = None
                             ) -> Iterator[torch.Tensor]:
    """Collocation batches ``(n, net_dim)`` from the problem's own sampler
    (``problem``, else the registered ``pde``), one per step from
    ``start_step`` on.

    ``coeffs_per_step`` C (conditioned problems only) replaces the
    sampler's draw a row by C draws a step, tiled over the batch: whole
    groups of points share a scenario, which steadies early conditioned
    training.  The points are the sampler's own; the C draws come from the
    counters ``(seed, step, 0, 1)``."""
    if problem is None:
        problem = pde_lib.get_problem(pde)
    if coeffs_per_step is not None:
        spec = problem.coeff_spec
        if spec is None:
            raise ValueError(
                f"coeffs_per_step set but PDE {problem.name!r} is not "
                "coefficient-conditioned")
        if not 1 <= coeffs_per_step <= n:
            raise ValueError(f"coeffs_per_step must be in [1, {n}], "
                             f"got {coeffs_per_step}")
    step = start_step
    while True:
        xt = problem.sample_collocation(counter_generator(seed, step, 0), n)
        if coeffs_per_step is not None:
            draws = spec.sample(counter_generator(seed, step, 0, 1),
                                coeffs_per_step)
            xt = torch.cat([xt[:, :problem.in_dim],
                            tile_coeff_draws(draws, n)], dim=-1)
        yield xt
        step += 1


def pde_term_batch_iterator(n: int, seed: int = 0, start_step: int = 0,
                            pde: str | None = None,
                            problem: pde_lib.PDEProblem | None = None
                            ) -> Iterator[dict]:
    """One ``{term_name: (x, target)}`` dict per step for every boundary
    and data term of ``problem.loss_terms()`` — the ``term_batches=`` form
    ``core.pinn.residual_loss`` takes.  Term i of ``loss_terms()`` draws
    from fold i of shard 1, ``n`` rows per term; terms whose sampler
    returns None are skipped, and a problem with no such terms yields
    empty dicts."""
    if problem is None:
        problem = pde_lib.get_problem(pde)
    terms = [(i, t) for i, t in enumerate(problem.loss_terms())
             if t.kind != "collocation" and t.sample is not None]
    step = start_step
    while True:
        out = {}
        for i, t in terms:
            batch = t.sample(counter_generator(seed, step, 1, i), n)
            if batch is not None:
                out[t.name] = batch
        yield out
        step += 1


def pde_line_grid_iterator(n_anchors: int, seed: int = 0,
                           start_step: int = 0, pde: str | None = None,
                           problem: pde_lib.PDEProblem | None = None,
                           points: int | None = None) -> Iterator[tuple]:
    """The spectral estimator's collocation stream: ``(anchors, rows)`` a
    step, ``anchors`` (B, net_dim) from the problem's sampler with the
    collocation stream's keys (at batch B the anchors are that stream's
    points), ``rows`` the deduped line grids through them
    (``spectral_line_rows``, M = ``points`` or the problem's).  The loss
    paths rebuild the rows from the anchors, so trainers feed only the
    anchors; the rows are for whoever meters the inference bill."""
    if problem is None:
        problem = pde_lib.get_problem(pde)
    M = problem.spectral_points if points is None else points
    step = start_step
    while True:
        anchors = problem.sample_collocation(
            counter_generator(seed, step, 0), n_anchors)
        yield anchors, spectral.spectral_line_rows(
            anchors, problem.in_dim, M, problem.spectral_extent)
        step += 1
