"""Training launcher for the tensor PINN on the GPU.

Trains the paper's TT-compressed sine PINN (``--arch hjb-pinn`` /
``tensor-pinn``) on a registered PDE with ZO-signSGD — forward evaluations
only — through the fused multi-perturbation step: each step draws N SPSA
perturbations, densifies all N+1 perturbed sets of every TONN core mesh
in one launch (the ``mesh_densify_stacked`` kernel), and runs the FD
stencil through every perturbed model at once (the
``tt_contract_batched`` kernel).  ``--sequential`` evaluates the N+1
models one at a time instead, the order a chip with one physical mesh
runs (plain FD stencil, each TT layer one ``tt_contract`` launch).
``--pinn-mode onn`` trains the paper's ONN baseline (``ONN_ONCHIP``:
every weight an SVD pair of full MZI meshes, run on the activations with
the chip's noise) the same two ways: the fused step puts the stencil
through six stacked meshes (``mesh_apply_stacked``; the hidden-width
meshes take its streamed design), ``--sequential`` four meshes per loss
evaluation.  ``--optimizer adamw|adafactor|sgd`` trains the paper's
off-chip BP baselines (``--pinn-mode dense``, ``tt``, or ``tonn`` mapped
onto the noisy hardware, or ``onn``) with autograd through
``residual_loss``: on the card each TT layer runs the ``tt_contract``
kernel forward and ``tt_contract_grad`` backward, tonn's meshes densify in
one grouped launch forward and one backward (``mesh_densify_stacked``,
``mesh_densify_grad``), and onn's meshes run the mesh kernel forward (the
resident design, or at hidden 1024 the wide routes A and B) and its
backward (``mesh_apply_stacked_grad``: the resident backward, or the
warp-rows one after route A and the dense one after route B).

    python -m repro_torch.launch.train --arch tensor-pinn --pde hjb-20d \\
        --pinn-noise --steps 50 --batch 100 --ckpt-dir ckpts/hjb-20d

runs the paper's ``TONN_ONCHIP_FUSED`` configuration on the card (the
default device; ``--device cpu`` runs the plain versions on the CPU,
``--reduced`` the hidden-64 CI size).  A problem with a boundary loss term
(``--pde helmholtz-2d``) draws a boundary batch a step and adds
``λ·MSE(u(xb), 0)`` to every loss of the stack (two more
``tt_contract_batched`` launches a step); ``--bc-weight`` sets λ and
``--term-weight NAME=W`` any term's weight, both recorded in the
checkpoint's ``term_weights``, and a problem with more than one term logs
each term's loss.  ``--estimator spectral`` (``--spectral-points M``)
takes derivatives by FFT over per-axis line grids through the batch's
anchors instead of the FD stencil: the stacked step puts the shared line
rows through every perturbed model in two ``tt_contract_batched``
launches.  ``--estimator auto`` takes the problem's own estimator: ns-2d
(``--pde ns-2d``, on a ``Domain`` with a Fourier feature map) trains by
the spectral one with its ``ic`` and ``data`` terms, two launches more
each.  A coefficient-conditioned problem (``--pde
black-scholes-100d-rs``, ``heat-10d-kappa``, ``hjb-10d-lam``) trains one
model over its coefficient range: its rows carry the coefficients after
the point (103 columns for black-scholes-100d-rs, inside the same padded
input), ``--coeff-range NAME=LO:HI[,...]`` and ``--coeff-dist
uniform|loguniform`` rebind the trained ranges, ``--coeffs-per-step C``
draws C scenarios a step tiled over the batch, and the trained ranges go
into the checkpoint's meta (``coeff_spec``) for serving.
``--quant int8|fp8_e4m3`` (with
``--quant-block``, default 32) and ``--phase-bits`` train it
quantization-aware: block-scaled TT cores (the
``tt_contract_batched_quant`` kernel in place of ``tt_contract_batched``)
and DAC-snapped phases.  Checkpoints are the JAX package's format with the
same meta (``pinn`` with the quant config, ``pde``, ``seed``,
``term_weights``) and the same subtrees (``params``, and ``zo`` or the BP
optimizer's ``opt``), so ``serving.SolverRegistry.load_checkpoint`` serves
them; a checkpoint ``step_<k>`` holds the params after k updates, and
``--resume`` continues from it with the batches and perturbations of steps
k, k+1, ... exactly as an uninterrupted run draws them.  The chip's
fabrication noise is drawn from the seed (``init_solver``) and saved beside
the params as the ``hw_noise`` subtree, so a noise-enabled checkpoint
serves on its own.  Such a checkpoint records the seed as ``train_seed``,
not ``seed``: the JAX package's registry would redraw the chip from a
``seed`` with its own generator and serve another chip, and without one it
asks for the noise instead.

``--shard perturbation|batch|both`` with ``--mesh PxB`` trains by
distributed ZO (``repro_torch.parallel.zo_shard``): the launcher spawns
P·B ranks in a ``gloo`` world (on ``cuda`` rank r takes ``cuda:{r %
device_count()}``, the kernels built before the spawn), each evaluates its
slice of the N+1 stacked losses on its shard of the batch, and a step's
only traffic is O(N) f32 scalars; the params stay replicated, so the run's
losses, params and checkpoints are the unsharded run's up to f32
reassociation.  Rank 0 alone prints and checkpoints; a rank that fails
fails the run.  ``--async-ckpt`` writes checkpoints on a thread (the
tensors copied to the host first).  A ``StragglerWatchdog`` times every
step and prints a straggle as the JAX trainer does.

Port of the ``train_pinn`` branch of ``repro.launch.train``.  Every flag
of that launcher this port does not have yet exits with the ROADMAP item
that ports it; so do ``--quant`` / ``--phase-bits`` with a BP optimizer
(the backward is f32 only) or with ``onn``, and a BP optimizer with
``onn`` where a mesh takes the owner walk, which has no backward (item
6c-3: hidden past 1024).  ``--estimator stein`` exits
too, naming the reference trainer's own fault (``STEIN_REFUSAL``).
"""

from __future__ import annotations

import argparse
import dataclasses
import math

import torch

from repro_torch import pde as pde_lib
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.hjb_pinn import pinn_config, pinn_reduced
from repro_torch.core import pinn, zoo
from repro_torch.data import pde_collocation_iterator, pde_term_batch_iterator
from repro_torch.device import counter_generator, resolve_device, to_device
from repro_torch.kernels.quant import QuantConfig
from repro_torch.optim import get_optimizer
from repro_torch.parallel import zo_shard
from repro_torch.runtime import StragglerWatchdog

__all__ = ["PINN_ARCHS", "TrainResult", "init_solver", "train_pinn", "main"]

PINN_ARCHS = ("hjb-pinn", "tensor-pinn")

# The reference trainer builds its losses with no PRNG key, and its Stein
# branch asserts one (repro.launch.train's loss closures →
# repro.core.pinn.residual_loss), so it cannot train with Stein; the port
# adds no training path the reference lacks.  The Stein API takes an
# explicit generator or directions (pinn.residual_loss[es_stacked]).
STEIN_REFUSAL = (
    "--estimator stein: the reference trainer passes no PRNG key to its "
    "Stein loss (src/repro/launch/train.py:281-290 -> "
    "src/repro/core/pinn.py:775 'stein estimator needs a PRNG key'), so "
    "neither trainer takes it (ROADMAP queue C, 'Stein CLI'); call "
    "pinn.residual_loss / residual_losses_stacked with a generator or z")


@dataclasses.dataclass
class TrainResult:
    """What a training run leaves: the model, its final params and the
    chip noise (on the run's device), and the per-step history."""

    model: pinn.TensorPinn
    params: dict
    hw_noise: dict | None
    losses: list            # base loss of every step run
    step_seconds: list      # host wall time of every step run
    val_mse: float | None   # after the last step (None: no exact solution)
    opt_state: dict | None = None  # the optimizer's final state, as saved
    straggles: int = 0      # steps the watchdog flagged (rank 0's)
    ranks: list | None = None  # distributed: each rank's losses, launches


def init_solver(model: pinn.TensorPinn, seed: int) -> tuple:
    """``(params, hw_noise)`` of a run with ``seed``, on the CPU: the same
    weights and the same chip for a seed on every device."""
    return (model.init(counter_generator(seed)),
            model.sample_noise(counter_generator(seed, 99)))


def _checkpoint_tree(params: dict, aux_name: str, aux: dict,
                     hw_noise: dict | None) -> dict:
    """What a checkpoint holds: the params, the optimizer's state under
    ``aux_name`` (``zo`` or ``opt``, as the JAX package names them) and,
    with the noise model on, the chip's noise."""
    tree = {"params": params, aux_name: aux}
    if hw_noise is not None:
        tree["hw_noise"] = hw_noise
    return tree


def _checkpoint_meta(cfg, problem, seed: int, noise_saved: bool) -> dict:
    """Self-describing meta: the serving registry rebuilds the solver from
    it alone.  With the chip's noise saved the seed goes under
    ``train_seed``: the JAX registry redraws a noise-on chip from a
    ``seed`` key (another chip than the port's), and raises without one.
    A conditioned problem's trained ranges go under ``coeff_spec``:
    serving normalizes with them and refuses coefficients outside them."""
    meta = {"pinn": pinn.config_to_meta(cfg), "pde": problem.name,
            "train_seed" if noise_saved else "seed": seed}
    if problem.coeff_spec is not None:
        meta["coeff_spec"] = problem.coeff_spec.to_meta()
    meta["term_weights"] = problem.term_weights()
    return meta


def _bp_step_fn(model, opt, mask: dict, hw_noise: dict | None):
    """The off-chip BP step: ``loss, grads`` by autograd of
    ``pinn.residual_loss``, zero gradients on the fixed buffers (mask
    False: they are not asked for), then ``opt.update``.  Returns
    ``step(params, opt_state, xt, tb) -> (params, opt_state, loss)``."""
    def step(params, opt_state, xt, tb):
        p = zoo.tree_map(lambda t, train: t.detach().requires_grad_(train),
                         params, mask)
        # tonn: one grouped densification, its backward one launch too
        prepared, noise = model.prepare_params(p, hw_noise)
        loss = pinn.residual_loss(model, prepared, xt, noise,
                                  term_batches=tb)
        wanted = [t for t in zoo.tree_leaves(p) if t.requires_grad]
        found = dict(zip(map(id, wanted), torch.autograd.grad(
            loss, wanted, materialize_grads=True)))
        grads = zoo.tree_map(
            lambda t: found[id(t)] if t.requires_grad else torch.zeros_like(t),
            p)
        new_params, new_state = opt.update(grads, opt_state, params)
        return new_params, new_state, loss.detach()

    return step


def _parse_coeff_ranges(text: str) -> dict:
    """``name=lo:hi[,name=lo:hi]`` → {name: (lo, hi)} for --coeff-range."""
    out = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            name, rng = part.split("=")
            lo, hi = (float(v) for v in rng.split(":"))
        except ValueError:
            raise SystemExit(
                f"--coeff-range: malformed entry {part!r} "
                "(expected name=lo:hi[,name=lo:hi])")
        out[name.strip()] = (lo, hi)
    if not out:
        raise SystemExit("--coeff-range: no ranges given")
    return out


def _conditioned_problem(args):
    """``--pde`` with its ``--coeff-range`` / ``--coeff-dist`` overrides as
    a problem instance, or None without overrides (the model then resolves
    the name).  The overrides rebind ``coeff_spec`` on a fresh instance:
    the ranges drive sampling, normalization and validation, never the
    residual, which reads the raw coefficients off the rows."""
    if not (args.coeff_range or args.coeff_dist):
        return None
    problem = pde_lib.get_problem(args.pde)
    if problem.coeff_spec is None:
        families = [n for n in pde_lib.available()
                    if pde_lib.get_problem(n).coeff_spec is not None]
        raise SystemExit(
            f"--coeff-range/--coeff-dist need a coefficient-conditioned "
            f"PDE; {args.pde!r} is not (try one of {families})")
    ranges = _parse_coeff_ranges(args.coeff_range) if args.coeff_range else {}
    try:
        problem.coeff_spec = problem.coeff_spec.with_ranges(
            ranges, dist=args.coeff_dist)
    except ValueError as e:
        raise SystemExit(f"--coeff-range: {e}")
    return problem


def _parse_term_weights(entries) -> dict:
    """Repeated ``--term-weight NAME=W[,NAME=W]`` → {name: float}."""
    out = {}
    for text in entries:
        for part in text.split(","):
            part = part.strip()
            if not part:
                continue
            try:
                name, w = part.split("=")
                out[name.strip()] = float(w)
            except ValueError:
                raise SystemExit(
                    f"--term-weight: malformed entry {part!r} "
                    "(expected NAME=W[,NAME=W])")
    if not out:
        raise SystemExit("--term-weight: no weights given")
    return out


def _apply_term_weights(args, problem) -> dict:
    """``--term-weight`` / ``--bc-weight`` as ``set_term_weights``
    overrides on ``problem``.  ``--bc-weight`` sets every boundary-kind
    term (helmholtz-2d's λ); an explicit ``--term-weight`` for the same
    name wins.  Returns the applied overrides."""
    tw = _parse_term_weights(args.term_weight) if args.term_weight else {}
    if args.bc_weight is not None:
        b_names = [t.name for t in problem.loss_terms()
                   if t.kind == "boundary"]
        if not b_names:
            raise SystemExit(f"--bc-weight: PDE {problem.name!r} has no "
                             "boundary-kind loss term")
        for name in b_names:
            tw.setdefault(name, args.bc_weight)
    if tw:
        try:
            problem.set_term_weights(tw)
        except ValueError as e:
            raise SystemExit(f"--term-weight: {e}")
    return tw


def _pinn_config(args) -> pinn.PINNConfig:
    """The run's ``PINNConfig`` from its flags."""
    build = pinn_reduced if args.reduced else pinn_config
    overrides = {"hidden": args.hidden} if args.hidden else {}
    if args.estimator:
        # the estimator travels in the config, and so into the checkpoint's
        # meta for serving and resume
        overrides["deriv"] = args.estimator
    if args.spectral_points:
        overrides["spectral_points"] = args.spectral_points
    if args.quant or args.phase_bits:
        # quantization-aware ZO training: fake-quant inside the loss
        overrides["quant"] = QuantConfig(
            enabled=True, dtype=args.quant, block=args.quant_block,
            phase_bits=args.phase_bits)
    return build(pde=args.pde, mode=args.pinn_mode, fused=not args.sequential,
                 noise=args.pinn_noise, **overrides)


def _unported(args) -> list:
    """(flag, ROADMAP queue A item) of every flag set that this port does
    not have yet."""
    bp = args.optimizer not in (None, "zo-signsgd")
    held = pinn.onn_no_backward_ports(_pinn_config(args)) if bp else []
    checks = [
        (bool(held),
         f"BP training of --pinn-mode onn at widths {held} (--optimizer "
         f"{args.optimizer}; those meshes take the owner walk, which has no "
         "backward kernel)", "6c-3"),
        (args.pinn_mode == "onn" and (args.quant or args.phase_bits),
         "quantization-aware training of --pinn-mode onn", 11),
        (bp and (args.quant or args.phase_bits),
         f"quantization-aware BP training (--optimizer {args.optimizer})",
         11),
        (args.seq is not None, "--seq", 14),
        (args.compress_grads, "--compress-grads", 14),
        (args.zo_vectorized, "--zo-vectorized", 14),
    ]
    return [(flag, item) for on, flag, item in checks if on]


def _build_model(args, say=print) -> pinn.TensorPinn:
    """The run's model with its term weights applied."""
    model = pinn.TensorPinn(_pinn_config(args),
                            problem=_conditioned_problem(args))
    problem = model.problem
    if args.coeffs_per_step is not None and problem.coeff_spec is None:
        raise SystemExit(f"--coeffs-per-step needs a coefficient-"
                         f"conditioned PDE; {problem.name!r} is not")
    if _apply_term_weights(args, problem):
        say("[pinn] term weights: "
            + " ".join(f"{k}={v:g}"
                       for k, v in problem.term_weights().items()))
    return model


def _kernel_launches() -> dict:
    """Every counted kernel wrapper's launches in this process."""
    from repro_torch.kernels import mesh_apply, tt_contract
    return {name: getattr(mod, name).launches for mod, names in (
        (tt_contract, ("tt_contract", "tt_contract_batched",
                       "tt_contract_batched_quant", "tt_contract_grad")),
        (mesh_apply, ("mesh_densify_stacked", "mesh_apply_stacked",
                      "mesh_densify_grad", "mesh_apply_stacked_grad",
                      "mesh_product_grad"))) for name in names}


def train_pinn(args, mesh: zo_shard.ZOMesh | None = None) -> TrainResult:
    """Training of ``args.pde`` on ``args.device``: ZO-signSGD (fused, or
    ``--sequential``) by default, the BP baselines with ``--optimizer``.
    With ``mesh`` (``--shard``) this process is one rank of the
    distributed ZO step; rank 0 alone prints, validates and checkpoints."""
    lead = mesh is None or mesh.rank in (None, mesh.ranks[0])
    say = print if lead else (lambda *a, **k: None)
    model = _build_model(args, say)
    cfg, problem = model.cfg, model.problem
    device = resolve_device(args.device)
    say(f"[pinn] pde={problem.name} in_dim={problem.in_dim} "
        f"mode={cfg.mode} hidden={cfg.hidden} deriv={cfg.deriv} "
        f"fused={cfg.use_fused_kernel} device={device}"
        + (f" quant={cfg.quant.tag()}" if cfg.quant.enabled else ""))
    if problem.coeff_spec is not None:
        spec = problem.coeff_spec
        say("[pinn] conditioned on "
            + ", ".join(f"{n}∈[{lo:g}, {hi:g}]" for n, lo, hi
                        in zip(spec.names, spec.lo, spec.hi))
            + f" ({spec.dist}); net_in={problem.net_dim}")
    if mesh is not None:
        say(f"[pinn] distributed ZO mesh pert={mesh.shape['pert']} "
            f"batch={mesh.shape['batch']} (shard={args.shard})")

    params, hw_noise = init_solver(model, args.seed)
    params = to_device(params, device)
    if hw_noise is not None:
        hw_noise = to_device(hw_noise, device)
    # neither ZO nor BP may move the fixed photonic ±1 diags by their
    # gradient (AdamW's weight decay still shrinks them, as in JAX)
    mask = model.trainable_mask(params)
    sizes = [(leaf.numel(), t) for leaf, t in
             zip(zoo.tree_leaves(params), zoo.tree_leaves(mask))]
    say(f"[pinn] trainable params: {sum(n for n, t in sizes if t)} "
        f"(+ {sum(n for n, t in sizes if not t)} fixed buffers)")
    val = (problem.sample_collocation(counter_generator(args.seed, 1234),
                                      1000).to(device)
           if problem.has_exact_solution and lead else None)

    ckpt_meta = _checkpoint_meta(cfg, problem, args.seed,
                                 noise_saved=hw_noise is not None)
    # every rank restores from the directory; rank 0 alone writes to it
    mgr = (CheckpointManager(args.ckpt_dir, keep=3, save_every=args.ckpt_every,
                             async_save=args.async_ckpt)
           if args.ckpt_dir else None)
    watchdog = StragglerWatchdog(
        on_straggle=lambda s: say(f"[watchdog] straggler at step {s.step}: "
                                  f"{s.duration_s:.3f}s vs median "
                                  f"{s.median_s:.3f}s", flush=True))

    opt_name = args.optimizer or "zo-signsgd"
    if opt_name == "zo-signsgd":
        scfg = zoo.SPSAConfig(num_samples=args.zo_samples, mu=0.01)
        aux_name, aux = "zo", zoo.ZOState(step=0, seed=args.seed + 1)
        lr0 = args.lr or 2e-3
        half_life = max(args.steps // 3, 1)

    if mesh is not None:
        # this rank's slice of the stacked losses on its batch shard; the
        # term batches are replicated whole
        dist_step = zo_shard.make_distributed_zo_step(
            mesh, lambda sp, x, tb: pinn.residual_losses_stacked(
                model, sp, x, hw_noise, term_batches=tb),
            scfg, trainable_mask=mask)

        def step_fn(params, state, xt, tb, step):
            return dist_step(params, state, xt, tb,
                             lr0 * 0.5 ** (step / half_life))
    elif opt_name == "zo-signsgd":
        def step_fn(params, state, xt, tb, step):
            def loss_fn(p):
                return pinn.residual_loss(model, p, xt, hw_noise,
                                          term_batches=tb)

            def batched_loss_fn(sp):
                return pinn.residual_losses_stacked(model, sp, xt, hw_noise,
                                                    term_batches=tb)

            return zoo.zo_signsgd_step(
                params, state, lr0 * 0.5 ** (step / half_life), scfg,
                batched_loss_fn=None if args.sequential else batched_loss_fn,
                trainable_mask=mask, loss_fn=loss_fn)
    else:
        # the off-chip BP baseline on the ideal (or noisy) model; the
        # optimizer carries its own learning rate
        opt = get_optimizer(opt_name, lr=args.lr)
        aux_name, aux = "opt", opt.init(params)
        bp_step = _bp_step_fn(model, opt, mask, hw_noise)

        def step_fn(params, opt_state, xt, tb, step):
            return bp_step(params, opt_state, xt, tb)

    def aux_tree(aux):
        return aux.as_tree() if aux_name == "zo" else aux

    start_step = 0
    if mgr and args.resume:
        try:
            restored, meta = mgr.restore_latest(
                {"params": params, aux_name: aux_tree(aux)})
        except FileNotFoundError:
            pass
        else:
            params = restored["params"]
            aux = (zoo.ZOState.from_tree(restored["zo"]) if aux_name == "zo"
                   else restored["opt"])
            start_step = meta["step"]
            say(f"[resume] step {start_step}")

    colloc = pde_collocation_iterator(args.batch, seed=args.seed,
                                      start_step=start_step, problem=problem,
                                      coeffs_per_step=args.coeffs_per_step)
    terms = pde_term_batch_iterator(max(args.batch // 4, 8), seed=args.seed,
                                    start_step=start_step, problem=problem)
    multi_term = len(problem.loss_terms()) > 1
    losses, seconds = [], []
    for step in range(start_step, args.steps):
        xt = next(colloc).to(device)
        tb = to_device(next(terms), device)
        watchdog.start_step()
        params, aux, loss = step_fn(params, aux, xt, tb, step)
        losses.append(float(loss))                  # waits for the step
        seconds.append(watchdog.end_step(step).duration_s)
        if step % args.log_every == 0 and lead:
            msg = f"step {step} loss {losses[-1]:.4e} ({seconds[-1]:.2f}s)"
            with torch.no_grad():
                if multi_term:
                    pt = pinn.per_term_losses(model, params, xt, hw_noise,
                                              term_batches=tb)
                    msg += " [" + " ".join(f"{k}={float(v):.3e}"
                                           for k, v in pt.items()) + "]"
                if val is not None:
                    mse = pinn.validation_mse(model, params, val, hw_noise)
                    msg += f" val MSE {float(mse):.4e}"
            print(msg, flush=True)
        if mgr and lead and mgr.should_save(step + 1):
            mgr.save(step + 1, _checkpoint_tree(params, aux_name,
                                                aux_tree(aux), hw_noise),
                     {"step": step + 1, **ckpt_meta})

    if mgr and lead:
        mgr.save(args.steps, _checkpoint_tree(params, aux_name, aux_tree(aux),
                                              hw_noise),
                 {"step": args.steps, **ckpt_meta})
        mgr.wait()
    val_mse = None
    if val is not None:
        with torch.no_grad():
            val_mse = float(pinn.validation_mse(model, params, val, hw_noise))
        say(f"[pinn] final val MSE {val_mse:.4e}")
    say(f"[watchdog] {watchdog.straggles} straggling steps of "
        f"{len(watchdog.history)}")
    say("[train] done")
    return TrainResult(model, params, hw_noise, losses, seconds, val_mse,
                       aux_tree(aux), watchdog.straggles)


def _distributed_layout(args) -> tuple:
    """(P, B) of ``--shard`` / ``--mesh``, with the JAX trainer's exits.
    Without ``--mesh`` the layout spans the visible cards (one rank on
    the CPU)."""
    opt_name = args.optimizer or "zo-signsgd"
    if opt_name != "zo-signsgd":
        raise SystemExit(f"--shard is distributed ZO only "
                         f"(got --optimizer {opt_name}); the BP baselines "
                         "do not shard")
    if args.sequential:
        raise SystemExit("--shard needs the stacked evaluator; "
                         "drop --sequential")
    spec = args.mesh
    if spec:
        n = math.prod(int(v) for v in spec.split("x"))
    else:
        n = (torch.cuda.device_count()
             if resolve_device(args.device).type == "cuda" else 1)
    try:
        p, b = zo_shard.mesh_shape(spec, args.shard, n)
    except ValueError as e:
        raise SystemExit(f"--mesh: {e}")
    if args.batch % b:
        raise SystemExit(f"--batch {args.batch} not divisible by the "
                         f"{b}-way batch axis")
    return p, b


def _train_rank(rank: int, world: int, args) -> dict:
    """One rank of a ``--shard`` run (``zo_shard.run_ranks``): its card,
    its part of the training, and what the parent needs back — rank 0's
    final state, every rank's losses and kernel launches."""
    if resolve_device(args.device).type == "cuda":
        card = f"cuda:{torch.cuda.current_device()}"   # set by run_ranks
        args = argparse.Namespace(**{**vars(args), "device": card})
    res = train_pinn(args, zo_shard.make_zo_mesh(args.mesh, args.shard))
    out = {"rank": rank, "losses": res.losses, "launches": _kernel_launches()}
    if rank == 0:
        out.update(params=to_device(res.params, torch.device("cpu")),
                   hw_noise=(None if res.hw_noise is None else
                             to_device(res.hw_noise, torch.device("cpu"))),
                   step_seconds=res.step_seconds, val_mse=res.val_mse,
                   opt_state=res.opt_state, straggles=res.straggles)
    return out


def train_distributed(args) -> TrainResult:
    """``--shard``: P·B ranks spawned for the distributed ZO step, or this
    process alone for a 1×1 layout.  Returns rank 0's result, its tensors
    on ``args.device``."""
    p, b = _distributed_layout(args)
    if p * b == 1:
        return train_pinn(args, zo_shard.make_zo_mesh("1x1", args.shard))
    device = resolve_device(args.device)
    if device.type == "cuda":
        # one nvcc a kernel here, not one a rank
        from repro_torch.kernels import _build
        for name in ("tt_contract", "mesh_apply"):
            _build.build(name)
    args = argparse.Namespace(**{**vars(args), "mesh": f"{p}x{b}"})
    outs = zo_shard.run_ranks(_train_rank, p * b, args, device=device)
    lead = outs[0]
    noise = lead["hw_noise"]
    return TrainResult(
        _build_model(args, lambda *a, **k: None),
        to_device(lead["params"], device),
        None if noise is None else to_device(noise, device),
        lead["losses"], lead["step_seconds"], lead["val_mse"],
        lead["opt_state"], lead["straggles"],
        [{"rank": o["rank"], "losses": o["losses"],
          "launches": o["launches"]} for o in outs])


def main(argv=None) -> TrainResult:
    ap = argparse.ArgumentParser(
        description="BP-free ZO training of the tensor PINN (PyTorch/CUDA)")
    ap.add_argument("--arch", required=True,
                    help=f"one of {PINN_ARCHS}; the LM archs are not "
                         "ported yet")
    ap.add_argument("--reduced", action="store_true",
                    help="CI size: hidden 64, 3 TT cores")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=None,
                    help="initial learning rate (default 2e-3), halved "
                         "every steps/3")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without a GPU only cpu runs")
    ap.add_argument("--pde", default="hjb-20d",
                    help="registered PDE workload (repro_torch.pde)")
    ap.add_argument("--pinn-mode", default="tonn",
                    choices=["dense", "onn", "tt", "tonn"])
    ap.add_argument("--hidden", type=int, default=None,
                    help="override the PINN hidden width")
    ap.add_argument("--zo-samples", type=int, default=10,
                    help="N SPSA perturbations per ZO step (paper: 10)")
    ap.add_argument("--pinn-noise", action="store_true",
                    help="enable the fabrication-noise model")
    ap.add_argument("--estimator", default=None,
                    choices=[None, "fd", "fd_fast", "stein", "spectral",
                             "auto"],
                    help="derivative estimator: central FD (fd, fd_fast), "
                         "spectral line grids, or auto (the problem's own); "
                         "default the config's (fd_fast when fused)")
    ap.add_argument("--spectral-points", type=int, default=None,
                    help="line-grid size M a differentiated axis for the "
                         "spectral estimator (default: the problem's)")
    ap.add_argument("--quant", default=None, choices=[None, "int8", "fp8_e4m3"],
                    help="quantization-aware training: block-scaled TT-core "
                         "quantization")
    ap.add_argument("--quant-block", type=int, default=32,
                    help="absmax-scaling block size for --quant")
    ap.add_argument("--phase-bits", type=int, default=None,
                    help="DAC resolution of the trainable MZI phases "
                         "(quantization-aware training)")
    ap.add_argument("--optimizer", default=None,
                    choices=[None, "adamw", "adafactor", "sgd", "zo-signsgd"],
                    help="zo-signsgd (default: the paper's BP-free on-chip "
                         "training) or an off-chip BP baseline")
    ap.add_argument("--sequential", action="store_true",
                    help="photonic-realism order: one perturbed model at a "
                         "time instead of the fused stacked program")
    ap.add_argument("--term-weight", action="append", default=None,
                    help="NAME=W[,NAME=W]: override loss-term weights "
                         "(repeatable; names from the problem's loss_terms)")
    ap.add_argument("--bc-weight", type=float, default=None,
                    help="weight of the boundary-kind loss term(s), λ in "
                         "L = L_r + λ·L_b; --term-weight wins for a name")
    ap.add_argument("--coeff-range", default=None,
                    help="override the trained coefficient ranges of a "
                         "conditioned PDE: name=lo:hi[,name=lo:hi] "
                         "(e.g. kappa=0.5:2.0)")
    ap.add_argument("--coeff-dist", default=None,
                    choices=[None, "uniform", "loguniform"],
                    help="coefficient sampling distribution override")
    ap.add_argument("--coeffs-per-step", type=int, default=None,
                    help="grouped scenario sampling: C coefficient draws "
                         "a step tiled over the batch instead of a draw "
                         "a point")
    ap.add_argument("--shard", default=None,
                    choices=["perturbation", "batch", "both"],
                    help="distributed ZO over a ('pert', 'batch') layout "
                         "of spawned ranks: shard the SPSA sweep, the "
                         "collocation batch, or both (O(N) scalars on the "
                         "wire a step)")
    ap.add_argument("--mesh", default=None,
                    help="with --shard: PERTxBATCH ranks (e.g. 2x1); "
                         "default: one rank a visible card")
    ap.add_argument("--async-ckpt", action="store_true",
                    help="write checkpoints on a thread")
    # flags of repro.launch.train that exit here (see _unported)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--zo-vectorized", action="store_true")
    args = ap.parse_args(argv)

    if args.arch not in PINN_ARCHS:
        raise SystemExit(f"--arch {args.arch}: the LM archs are not ported "
                         "yet (ROADMAP queue A, item 14); the port trains "
                         f"{PINN_ARCHS}")
    if args.estimator == "stein":
        raise SystemExit(STEIN_REFUSAL)
    unported = _unported(args)
    if unported:
        raise SystemExit("; ".join(
            f"{flag} is not ported yet (ROADMAP queue A, item {item})"
            for flag, item in unported))
    if args.shard:
        return train_distributed(args)
    return train_pinn(args)


if __name__ == "__main__":
    main()
