"""Slot-batched PDE inference engine.

A request is a batch of query points ``(x, t)`` for a named solver; the
engine serves mixed traffic through a fixed pool of ``slots`` slots of
``slot_points`` points each.  The invariants:

  * **one program per key, shape-stable** — exactly one program per
    ``(solver, dtype[, quant tag][, c{K}], slot-shape)``, built the first
    time the key sees traffic and counted in ``stats["compiles"]``.  A
    program is a closure over the solver's prepared on-device params; its
    input is always the FULL pool ``(slots·slot_points, net_dim)`` and any
    other shape raises, as the JAX package's AOT executable does.  A
    conditioned solver's rows carry the request's coefficients after the
    point (augmented at submit), so one ``c{K}``-tagged program serves
    every coefficient instance of its family with no rebuild.
  * **pad-to-slot** — a chunk shorter than a slot pads with an in-domain
    fill point, idle slots evaluate pure fill; every row's arithmetic is
    independent of the other rows (the TT kernel's summation order per
    element is fixed), so padding cannot change a served value.
  * **continuous admission** — requests queue in a deque; every step packs
    chunks of the head request(s) into free slots (a request larger than
    the pool spans steps).  A slot lives for one step.

Repeated queries short-circuit through the ``StencilCache`` at submit time:
hits never occupy a slot.  A request's ``quant`` (a ``QuantConfig``) selects
a quantized program of its own, and its cache entries live under the
config's tag, so quantized and f32 values never answer each other's
queries; a conditioned request's keys are its augmented rows, so two
coefficient instances never share an entry.  Only float32 requests are
served in this port so far; other dtypes raise at submit.

Port of ``repro.serving.engine``.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import pinn
from repro_torch.device import resolve_device
from repro_torch.kernels import quant as quant_lib
from repro_torch.serving.cache import StencilCache
from repro_torch.serving.registry import SolverRegistry

__all__ = ["PointRequest", "PdeServingEngine"]


def _quant_tag(quant) -> str:
    """The quant config's tag for program and cache keys; empty when
    quantization is off, so the f32 key formats stay as they were."""
    return "" if quant is None else quant.tag()


@dataclasses.dataclass
class PointRequest:
    """One client query: evaluate ``u`` of ``solver`` at ``points``.

    ``out`` is filled in place (same order as ``points``); ``done`` flips
    when every point is served; ``latency_s`` covers submit → completion,
    queue wait included.  ``quant`` (a ``QuantConfig``, None for f32)
    requests quantized serving.  ``coeffs`` (one ``(K,)`` vector of raw
    coefficient values, e.g. ``[r, sigma]``) selects the instance of a
    conditioned solver's family, and must lie in its trained ranges.
    ``dtype`` mirrors the JAX request; anything but float32 raises at
    submit.
    """

    solver: str
    points: np.ndarray                    # (n, in_dim) physical points
    dtype: Any = np.float32
    quant: Any = None                     # QuantConfig | None (None = f32)
    coeffs: Any = None                    # (K,) raw coefficients | None
    out: np.ndarray | None = None         # (n,) served u-values
    done: bool = False
    t_submit: float = 0.0
    t_done: float = 0.0
    # internal bookkeeping (engine-owned)
    _miss_idx: np.ndarray | None = None   # positions still to compute
    _keys: list | None = None             # cache keys of the misses
    _cursor: int = 0                      # misses packed into slots so far
    _inflight: int = 0                    # chunks currently in slots

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit


@dataclasses.dataclass
class _Slot:
    """One occupied slot: a chunk of a request's miss-points."""

    req: PointRequest
    offset: int     # chunk start within req._miss_idx
    count: int      # chunk length (<= slot_points)


class PdeServingEngine:
    """Continuous-batching point-query server over a ``SolverRegistry``."""

    def __init__(self, registry: SolverRegistry, slots: int = 8,
                 slot_points: int = 256,
                 cache: StencilCache | None = None,
                 enable_cache: bool = True,
                 device: str | torch.device = "cuda"):
        if slots <= 0 or slot_points <= 0:
            raise ValueError("slots and slot_points must be positive")
        self.device = resolve_device(device)
        if self.device != registry.device:
            raise ValueError(f"engine on {self.device} cannot serve a "
                             f"registry on {registry.device}")
        self.registry = registry
        self.slots = slots
        self.slot_points = slot_points
        self.cache = cache if cache is not None else (
            StencilCache() if enable_cache else None)
        self.queue: collections.deque[PointRequest] = collections.deque()
        self.active: list[_Slot | None] = [None] * slots
        self._programs: dict = {}  # (solver, dtype[, quant][, cK], S, C)
        self._fill: dict = {}          # solver -> in-domain fill point
        self.stats = {"compiles": 0, "steps": 0, "program_runs": 0,
                      "points_served": 0, "points_padded": 0,
                      "requests_done": 0, "peak_active_slots": 0,
                      "cache_hits": 0, "cache_misses": 0,
                      "cache_evictions": 0}

    def _sync_cache_stats(self) -> None:
        """Mirror the ``StencilCache`` counters into ``stats``."""
        if self.cache is not None:
            self.stats["cache_hits"] = self.cache.hits
            self.stats["cache_misses"] = self.cache.misses
            self.stats["cache_evictions"] = self.cache.evictions

    # ------------------------------------------------------------ programs
    def _pool_shape(self, width: int) -> tuple:
        return (self.slots * self.slot_points, width)

    def _program(self, solver_name: str, quant=None) -> Callable:
        """The full-pool float32 forward of ``(solver_name, quant)``, built
        (and counted) once per key.

        A quantized request rebinds the solver's model to the request's
        config, as the JAX package does (a request without weight
        quantization so serves unquantized cores, even from a quantized
        solver); an f32 request serves the solver's own model.  A prepared
        tonn solver is already densified, so request-level ``phase_bits``
        does not bite it; only solvers quantized at train or load time
        carry DAC-snapped phases.  An onn solver's meshes run in every
        program, with the chip's noise, so a request's ``phase_bits`` snaps
        them there.  Weight quantization is folded in at
        build, as the JAX package's compile folds it: the frozen cores are
        fake-quantized once here and the program runs the f32 chain over
        them.  ``fake_quant`` is idempotent, so the values are the quantized
        model's, and a run pays nothing for the quantization."""
        solver = self.registry.get(solver_name)
        tag = _quant_tag(quant)
        ctag = f"c{solver.n_coeffs}" if solver.coeff_spec is not None else ""
        key = (solver_name, "float32", *((tag,) if tag else ()),
               *((ctag,) if ctag else ()), self.slots, self.slot_points)
        program = self._programs.get(key)
        if program is None:
            model, params, noise = solver.model, solver.params, solver.noise
            if tag:
                model = pinn.TensorPinn(
                    dataclasses.replace(model.cfg, quant=quant),
                    problem=model.problem)
            q = model.cfg.quant
            if q.weights:
                params = {k: ([quant_lib.fake_quant(c, q) for c in v]
                              if k.startswith("cores") else v)
                          for k, v in params.items()}
                # the DAC snap stays: onn's meshes run in the forward
                model = pinn.TensorPinn(
                    dataclasses.replace(model.cfg,
                                        quant=dataclasses.replace(
                                            q, dtype=None)),
                    problem=model.problem)
            shape = self._pool_shape(solver.net_dim)
            device = self.device

            def program(pts: torch.Tensor) -> torch.Tensor:
                if (tuple(pts.shape) != shape or pts.dtype != torch.float32
                        or pts.device != device):
                    raise ValueError(
                        f"program {key} takes a float32 {shape} pool on "
                        f"{device}, got {pts.dtype} {tuple(pts.shape)} on "
                        f"{pts.device}")
                with torch.no_grad():
                    return model.u(params, pts, noise)

            self._programs[key] = program
            self.stats["compiles"] += 1
        return program

    def warmup(self, solver_name: str | None = None, quant=None) -> None:
        """Build AND run the ``(solver, quant)`` program(s) once on a
        pure-fill pool, so the first real request pays neither the build
        nor first-launch set-up (kernel library load included).  ``None``
        warms every solver."""
        names = (self.registry.names() if solver_name is None
                 else (solver_name,))
        for name in names:
            program = self._program(name, quant)
            width = self.registry.get(name).net_dim
            buf = np.broadcast_to(self._fill_point(name),
                                  self._pool_shape(width))
            program(torch.tensor(buf, dtype=torch.float32,
                                 device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _fill_point(self, solver_name: str) -> np.ndarray:
        """A fixed in-domain row for pad rows and idle slots (its outputs
        are discarded; it only must not produce NaN/inf): a conditioned
        solver's carries in-range sampled coefficients."""
        p = self._fill.get(solver_name)
        if p is None:
            problem = self.registry.get(solver_name).problem
            p = problem.sample_collocation(
                torch.Generator().manual_seed(0), 1)[0].numpy()
            self._fill[solver_name] = p.astype(np.float64)
        return self._fill[solver_name]

    # -------------------------------------------------------------- submit
    def submit(self, req: PointRequest) -> PointRequest:
        """Enqueue a request; cache hits are served immediately and only
        the misses ever occupy slots.  Returns the request (its ``out`` /
        ``done`` fields are updated in place as the engine steps)."""
        if np.dtype(req.dtype) != np.float32:
            raise NotImplementedError(
                f"{np.dtype(req.dtype).name} serving is not ported yet; "
                "the port serves float32")
        pts = np.asarray(req.points, np.float64)
        if pts.ndim != 2 or pts.shape[0] == 0:
            raise ValueError(f"points must be (n>0, in_dim), "
                             f"got {pts.shape}")
        solver = self.registry.get(req.solver)
        if pts.shape[1] != solver.in_dim:
            raise ValueError(f"solver {req.solver!r} takes in_dim="
                             f"{solver.in_dim} points, got {pts.shape}")
        # a conditioned/unconditioned mismatch is the client's error,
        # caught before any state changes, both ways
        spec = solver.coeff_spec
        if spec is None:
            if req.coeffs is not None:
                raise ValueError(
                    f"solver {req.solver!r} is not coefficient-conditioned "
                    "but the request carries coeffs; drop them or query a "
                    "conditioned solver")
        else:
            if req.coeffs is None:
                raise ValueError(
                    f"solver {req.solver!r} is coefficient-conditioned on "
                    f"({', '.join(spec.names)}); pass PointRequest(coeffs="
                    f"[{', '.join(spec.names)}]) with values in the "
                    "trained ranges")
            coeffs = np.asarray(req.coeffs, np.float64).reshape(-1)
            spec.check_in_range(coeffs)   # arity and trained range
            req.coeffs = coeffs
            # augmented once here: the cache keys, the slot packing and the
            # net_dim-wide pool see plain rows
            pts = np.concatenate(
                [pts, np.broadcast_to(coeffs, (pts.shape[0], spec.n))],
                axis=1)
        req.points = pts
        req.t_submit = time.perf_counter()
        req.out = np.empty(pts.shape[0], np.float64)
        if self.cache is not None:
            keys = self.cache.keys_for(req.solver, req.dtype, pts,
                                       quant_tag=_quant_tag(req.quant))
            hit_idx, hit_vals, miss_idx = self.cache.lookup(keys)
            if len(hit_idx):
                req.out[hit_idx] = hit_vals
            req._miss_idx = miss_idx
            req._keys = keys
            self._sync_cache_stats()
        else:
            req._miss_idx = np.arange(pts.shape[0])
            req._keys = None
        if len(req._miss_idx) == 0:       # fully cached: done at submit
            req.done = True
            req.t_done = time.perf_counter()
            self.stats["requests_done"] += 1
            return req
        self.queue.append(req)
        return req

    # ---------------------------------------------------------- step logic
    def _admit(self) -> None:
        """Pack head-of-queue chunks into free slots; the head request may
        stay partly packed until the next step's free slots."""
        free = [s for s in range(self.slots) if self.active[s] is None]
        while free and self.queue:
            req = self.queue[0]
            remaining = len(req._miss_idx) - req._cursor
            count = min(remaining, self.slot_points)
            self.active[free.pop()] = _Slot(req, req._cursor, count)
            req._cursor += count
            req._inflight += 1
            if req._cursor >= len(req._miss_idx):
                self.queue.popleft()

    def step(self) -> int:
        """One engine step: admit, run every (solver, quant) group's
        full-pool program once, scatter results, retire slots.  Returns the
        number of request points served this step."""
        self._admit()
        groups: dict = {}
        for s, slot in enumerate(self.active):
            if slot is not None:
                groups.setdefault((slot.req.solver,
                                   _quant_tag(slot.req.quant)), []).append(s)
        if not groups:
            return 0
        self.stats["steps"] += 1
        self.stats["peak_active_slots"] = max(
            self.stats["peak_active_slots"],
            sum(len(v) for v in groups.values()))
        served = 0
        for (solver_name, _tag), slot_ids in groups.items():
            program = self._program(solver_name,
                                    self.active[slot_ids[0]].req.quant)
            width = self.registry.get(solver_name).net_dim
            # full-pool input: fill point everywhere, then the group's
            # chunks in their slots (pad-to-slot)
            buf = np.broadcast_to(
                self._fill_point(solver_name),
                (self.slots, self.slot_points, width)).astype(
                    np.float32, copy=True)
            for s in slot_ids:
                slot = self.active[s]
                idx = slot.req._miss_idx[slot.offset:slot.offset
                                         + slot.count]
                buf[s, :slot.count] = slot.req.points[idx]
            u = program(torch.from_numpy(buf.reshape(
                self._pool_shape(width))).to(self.device))
            u = u.cpu().numpy().reshape(self.slots, self.slot_points)
            self.stats["program_runs"] += 1
            for s in slot_ids:
                slot = self.active[s]
                req = slot.req
                idx = req._miss_idx[slot.offset:slot.offset + slot.count]
                vals = u[s, :slot.count]
                req.out[idx] = vals
                if self.cache is not None:
                    self.cache.insert([req._keys[i] for i in idx], vals)
                served += slot.count
                self.stats["points_padded"] += self.slot_points - slot.count
                req._inflight -= 1
                if req._inflight == 0 and \
                        req._cursor >= len(req._miss_idx):
                    req.done = True
                    req.t_done = time.perf_counter()
                    self.stats["requests_done"] += 1
                self.active[s] = None     # slot recycles next step
            # idle slots of this group's program run are pure padding
            self.stats["points_padded"] += \
                (self.slots - len(slot_ids)) * self.slot_points
        self.stats["points_served"] += served
        self._sync_cache_stats()
        return served

    def run(self, max_steps: int | None = None) -> int:
        """Drain the queue: step until nothing is queued or in flight.
        Returns total points served."""
        total = 0
        for _ in (range(max_steps) if max_steps is not None
                  else itertools.count()):
            if not self.queue and all(s is None for s in self.active):
                break
            total += self.step()
        return total

    # ----------------------------------------------------------- reporting
    def serving_stats(self) -> dict:
        self._sync_cache_stats()
        out = dict(self.stats)
        out["queued"] = len(self.queue)
        out["programs"] = sorted(
            "|".join(map(str, k)) for k in self._programs)
        if self.cache is not None:
            out["cache"] = self.cache.stats()
        return out
