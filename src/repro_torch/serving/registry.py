"""Solver registry: named, inference-ready ``TensorPinn`` solvers on one device.

A ``LoadedSolver`` is a checkpoint (or in-memory params) pushed through the
one-time preparation the request path must never pay for: TONN
mesh→TT-core densification with the chip's noise baked in
(``TensorPinn.prepare_params``, one grouped launch on the card; a
quantized config's DAC phase snap goes with it), and the move to the
registry's device.  An ``onn`` solver has nothing to bake: its meshes run
on every request, so it keeps the chip's noise (``LoadedSolver.noise``).

Checkpoints written by the JAX package's ``launch/train.py`` load by name:
their ``meta.json`` carries the ``PINNConfig`` under ``"pinn"``.  What the
port cannot rebuild it refuses, never ignores:

  * a noise-enabled checkpoint of the JAX package carries no chip noise:
    its noise was sampled from the training seed with JAX's threefry
    generator, which torch does not reproduce — pass the noise itself as
    ``hw_noise=`` (a numpy tree from the JAX side).  The port's trainer
    saves the noise beside the params, so its checkpoints need nothing.

A conditioned checkpoint (``coeff_spec`` in meta) loads with its trained
coefficient ranges rebound onto a fresh problem, so serving normalizes
and validates with the ranges the solver was trained on, not the
registry's defaults; such meta on an unconditioned PDE raises.

A quantized checkpoint (``quant.enabled`` in its config) loads with the
model built from that config, so it serves the quantized solver it was
trained as.  The loss-term weights a checkpoint records (``term_weights``)
are set on the loaded solver's problem.

Port of ``repro.serving.registry``.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from repro_torch import interop
from repro_torch import pde as pde_lib
from repro_torch.checkpoint import read_checkpoint_meta, restore_checkpoint
from repro_torch.core import pinn
from repro_torch.device import resolve_device, to_device

__all__ = ["LoadedSolver", "SolverRegistry"]


@dataclasses.dataclass
class LoadedSolver:
    """One inference-ready solver: prepared params on the device and the
    model/problem objects the engine builds its programs against."""

    name: str
    model: pinn.TensorPinn
    params: dict                 # prepared: TONN cores densified at load
    noise: dict | None = None    # the chip noise the forward still reads
    step: int | None = None      # checkpoint step, None for in-memory
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def problem(self):
        return self.model.problem

    @property
    def in_dim(self) -> int:
        return self.model.in_dim

    @property
    def coeff_spec(self):
        """The trained coefficient ranges (None: unconditioned), which the
        engine packs net_dim-wide rows and validates requests by."""
        return self.model.problem.coeff_spec

    @property
    def n_coeffs(self) -> int:
        return self.model.problem.n_coeffs

    @property
    def net_dim(self) -> int:
        return self.model.problem.net_dim


class SolverRegistry:
    """Name-keyed ``LoadedSolver`` store; every solver lives on ``device``."""

    def __init__(self, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self._solvers: dict[str, LoadedSolver] = {}

    def _check_device(self, device) -> None:
        dev = resolve_device(device)
        if dev != self.device:
            raise ValueError(f"this registry serves on {self.device}, "
                             f"not {dev}")

    # ---------------------------------------------------------------- access
    def get(self, name: str) -> LoadedSolver:
        if name not in self._solvers:
            raise KeyError(f"unknown solver {name!r}; "
                           f"loaded: {sorted(self._solvers)}")
        return self._solvers[name]

    def names(self) -> tuple:
        return tuple(sorted(self._solvers))

    def __contains__(self, name: str) -> bool:
        return name in self._solvers

    def __len__(self) -> int:
        return len(self._solvers)

    # -------------------------------------------------------------- register
    def register(self, name: str, model: pinn.TensorPinn, params: dict,
                 hw_noise: dict | None = None, step: int | None = None,
                 meta: dict | None = None) -> LoadedSolver:
        """Register an in-memory solver: params (and ``hw_noise``) are moved
        to the registry's device and prepared there, once."""
        if model.uses_noise and hw_noise is None:
            raise ValueError(f"solver {name!r} has the noise model on; "
                             "pass the chip's hw_noise")
        if not model.uses_noise and hw_noise is not None:
            raise ValueError(f"solver {name!r} uses no hardware noise, "
                             "but hw_noise was given")
        params = to_device(params, self.device)
        if hw_noise is not None:
            hw_noise = to_device(hw_noise, self.device)
        with torch.no_grad():
            prepared, noise = model.prepare_params(params, hw_noise)
        solver = LoadedSolver(name=name, model=model, params=prepared,
                              noise=noise, step=step, meta=meta or {})
        self._solvers[name] = solver
        return solver

    def load_checkpoint(self, name: str, directory: str | os.PathLike,
                        cfg: pinn.PINNConfig | None = None,
                        step: int | None = None,
                        hw_noise: dict | None = None,
                        device: str | torch.device = "cuda") -> LoadedSolver:
        """Load a ``TensorPinn`` checkpoint written by the JAX package's
        ``launch/train.py``, the port's, or ``checkpoint.save_checkpoint``,
        and register it under ``name``.  The ``params`` subtree is read,
        and the ``hw_noise`` subtree where the checkpoint has one (the
        port's trainer saves the chip noise there).

        ``hw_noise`` is the chip's noise tree as numpy arrays (the JAX
        ``TensorPinn.sample_noise`` output); a noise-enabled tonn or onn
        checkpoint without the subtree needs it, and when given it takes
        the place of the subtree."""
        self._check_device(device)
        meta = read_checkpoint_meta(directory, step)
        step = meta["step"]  # pin: meta and arrays must be one checkpoint
        if cfg is None:
            if "pinn" not in meta:
                raise ValueError(
                    f"checkpoint {directory} predates solver metadata "
                    "(no 'pinn' key in meta.json); pass cfg= explicitly")
            cfg = pinn.config_from_meta(meta["pinn"])
        problem = None
        if "coeff_spec" in meta:
            # the trained (possibly --coeff-range overridden) ranges, not
            # the registry's defaults, normalize and validate serving
            problem = pde_lib.get_problem(cfg.pde)
            if problem.coeff_spec is None:
                raise ValueError(
                    f"checkpoint meta has coeff_spec but PDE {cfg.pde!r} "
                    "is not coefficient-conditioned")
            problem.coeff_spec = pde_lib.CoeffSpec.from_meta(
                meta["coeff_spec"])
        if "term_weights" in meta:
            # the trained loss composition (--term-weight/--bc-weight)
            # travels in the checkpoint: restored, a validation pass through
            # the loaded solver reproduces the trained loss; names the
            # problem does not know are dropped
            if problem is None:
                problem = pde_lib.get_problem(cfg.pde)
            known = {t.name for t in problem.loss_terms()}
            problem.set_term_weights({k: v for k, v
                                      in meta["term_weights"].items()
                                      if k in known})
        model = pinn.TensorPinn(cfg, problem=problem)
        gen = torch.Generator().manual_seed(0)
        like = {"params": model.init(gen)}
        if model.uses_noise and hw_noise is None:
            if not any(k.startswith("hw_noise/")
                       for k in meta.get("keys", ())):
                raise ValueError(
                    f"checkpoint {directory} has the noise model on and "
                    "carries no chip noise: a JAX-written checkpoint's noise "
                    "was drawn from the training seed with JAX's threefry "
                    "generator, which torch cannot reproduce; pass the "
                    "noise tree as hw_noise= (numpy arrays of the JAX "
                    "TensorPinn.sample_noise output)")
            like["hw_noise"] = model.sample_noise(gen)   # the tree's shape
        restored, meta = restore_checkpoint(directory, like, step)
        if hw_noise is not None:
            restored["hw_noise"] = interop.noise_from_numpy(hw_noise,
                                                            self.device)
        return self.register(name, model, restored["params"],
                             hw_noise=restored.get("hw_noise"),
                             step=meta.get("step"), meta=meta)

    def register_fresh(self, name: str, cfg: pinn.PINNConfig, seed: int = 0,
                       device: str | torch.device = "cuda") -> LoadedSolver:
        """Register a freshly initialized (UNTRAINED) solver whose weights
        and chip noise come from ``seed`` — benchmark and smoke-test
        convenience; inference cost is a trained solver's."""
        self._check_device(device)
        model = pinn.TensorPinn(cfg)
        gen = torch.Generator().manual_seed(seed)
        params = model.init(gen)
        return self.register(name, model, params,
                             hw_noise=model.sample_noise(gen))
