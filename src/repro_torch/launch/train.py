"""BP-free training launcher for the tensor PINN on the GPU.

Trains the paper's TT-compressed sine PINN (``--arch hjb-pinn`` /
``tensor-pinn``) on a registered PDE with ZO-signSGD — forward evaluations
only — through the fused multi-perturbation step: each step draws N SPSA
perturbations, densifies all N+1 perturbed sets of every TONN core mesh
in one launch (the ``mesh_densify_stacked`` kernel), and runs the FD
stencil through every perturbed model at once (the
``tt_contract_batched`` kernel).

    python -m repro_torch.launch.train --arch tensor-pinn --pde hjb-20d \\
        --pinn-noise --steps 50 --batch 100 --ckpt-dir ckpts/hjb-20d

runs the paper's ``TONN_ONCHIP_FUSED`` configuration on the card (the
default device; ``--device cpu`` runs the plain versions on the CPU,
``--reduced`` the hidden-64 CI size).  ``--quant int8|fp8_e4m3`` (with
``--quant-block``, default 32) and ``--phase-bits`` train it
quantization-aware: block-scaled TT cores (the
``tt_contract_batched_quant`` kernel in place of ``tt_contract_batched``)
and DAC-snapped phases.  Checkpoints are the JAX package's format with the
same meta (``pinn`` with the quant config, ``pde``, ``seed``,
``term_weights``),
so ``serving.SolverRegistry.load_checkpoint`` serves them; a checkpoint
``step_<k>`` holds the params after k updates, and ``--resume`` continues
from it with the batches and perturbations of steps k, k+1, ... exactly as
an uninterrupted run draws them.  The chip's fabrication noise is drawn
from the seed (``init_solver``) and saved beside the params as the
``hw_noise`` subtree, so a noise-enabled checkpoint serves on its own (the
JAX package reads only the subtrees it asks for, and still restores the
params).

Port of the ``train_pinn`` branch of ``repro.launch.train``.  Every flag
of that launcher this port does not have yet exits with the ROADMAP item
that ports it.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.hjb_pinn import pinn_config, pinn_reduced
from repro_torch.core import pinn, zoo
from repro_torch.data import pde_collocation_iterator, pde_term_batch_iterator
from repro_torch.device import counter_generator, resolve_device, to_device
from repro_torch.kernels.quant import QuantConfig

__all__ = ["PINN_ARCHS", "TrainResult", "init_solver", "train_pinn", "main"]

PINN_ARCHS = ("hjb-pinn", "tensor-pinn")


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


def init_solver(model: pinn.TensorPinn, seed: int) -> tuple:
    """``(params, hw_noise)`` of a run with ``seed``, on the CPU: the same
    weights and the same chip for a seed on every device."""
    return (model.init(counter_generator(seed)),
            model.sample_noise(counter_generator(seed, 99)))


def _checkpoint_tree(params: dict, state: zoo.ZOState,
                     hw_noise: dict | None) -> dict:
    """What a checkpoint holds: the params, the ZO state and, with the
    noise model on, the chip's noise."""
    tree = {"params": params, "zo": state.as_tree()}
    if hw_noise is not None:
        tree["hw_noise"] = hw_noise
    return tree


def _unported(args) -> list:
    """(flag, ROADMAP queue A item) of every flag set that this port does
    not have yet."""
    checks = [
        (args.pinn_mode in ("dense", "onn"), f"--pinn-mode {args.pinn_mode}",
         6),
        (args.sequential, "--sequential", 6),
        (args.optimizer not in (None, "zo-signsgd"),
         f"--optimizer {args.optimizer}", 6),
        (args.estimator == "stein", "--estimator stein", 8),
        (args.term_weight, "--term-weight", 8),
        (args.bc_weight is not None, "--bc-weight", 8),
        (args.estimator == "spectral", "--estimator spectral", 9),
        (args.spectral_points is not None, "--spectral-points", 9),
        (args.coeff_range is not None, "--coeff-range", 10),
        (args.coeff_dist is not None, "--coeff-dist", 10),
        (args.coeffs_per_step is not None, "--coeffs-per-step", 10),
        (args.pinn_mode == "onn" and (args.quant or args.phase_bits),
         "quantization-aware training of --pinn-mode onn", 11),
        (args.shard is not None, "--shard", 13),
        (args.mesh is not None, "--mesh", 13),
        (args.async_ckpt, "--async-ckpt", 13),
        (args.seq is not None, "--seq", 14),
        (args.compress_grads, "--compress-grads", 14),
        (args.zo_vectorized, "--zo-vectorized", 14),
    ]
    return [(flag, item) for on, flag, item in checks if on]


def train_pinn(args) -> TrainResult:
    """BP-free ZO-signSGD training of ``args.pde`` on ``args.device``."""
    build = pinn_reduced if args.reduced else pinn_config
    overrides = {"hidden": args.hidden} if args.hidden else {}
    if args.estimator:
        overrides["deriv"] = args.estimator
    if args.quant or args.phase_bits:
        # quantization-aware ZO training: fake-quant inside the loss
        overrides["quant"] = QuantConfig(
            enabled=True, dtype=args.quant, block=args.quant_block,
            phase_bits=args.phase_bits)
    cfg = build(pde=args.pde, mode=args.pinn_mode, noise=args.pinn_noise,
                **overrides)
    device = resolve_device(args.device)
    model = pinn.TensorPinn(cfg)
    problem = model.problem
    print(f"[pinn] pde={problem.name} in_dim={problem.in_dim} "
          f"mode={cfg.mode} hidden={cfg.hidden} deriv={cfg.deriv} "
          f"fused={cfg.use_fused_kernel} device={device}"
          + (f" quant={cfg.quant.tag()}" if cfg.quant.enabled else ""))

    params, hw_noise = init_solver(model, args.seed)
    params = to_device(params, device)
    if hw_noise is not None:
        hw_noise = to_device(hw_noise, device)
    # ZO must neither perturb nor sign-update the fixed photonic ±1 diags
    mask = model.trainable_mask(params)
    sizes = [(leaf.numel(), t) for leaf, t in
             zip(zoo.tree_leaves(params), zoo.tree_leaves(mask))]
    print(f"[pinn] trainable params: {sum(n for n, t in sizes if t)} "
          f"(+ {sum(n for n, t in sizes if not t)} fixed buffers)")
    val = (problem.sample_collocation(counter_generator(args.seed, 1234),
                                      1000).to(device)
           if problem.has_exact_solution else None)

    # self-describing checkpoints: the serving registry rebuilds the
    # solver from the meta alone
    ckpt_meta = {"pinn": pinn.config_to_meta(cfg), "pde": problem.name,
                 "seed": args.seed, "term_weights": problem.term_weights()}
    mgr = (CheckpointManager(args.ckpt_dir, keep=3, save_every=args.ckpt_every)
           if args.ckpt_dir else None)

    scfg = zoo.SPSAConfig(num_samples=args.zo_samples, mu=0.01)
    state = zoo.ZOState(step=0, seed=args.seed + 1)
    lr0 = args.lr or 2e-3
    half_life = max(args.steps // 3, 1)

    start_step = 0
    if mgr and args.resume:
        try:
            restored, meta = mgr.restore_latest(
                {"params": params, "zo": state.as_tree()})
        except FileNotFoundError:
            pass
        else:
            params = restored["params"]
            state = zoo.ZOState.from_tree(restored["zo"])
            start_step = meta["step"]
            print(f"[resume] step {start_step}")

    colloc = pde_collocation_iterator(args.batch, seed=args.seed,
                                      start_step=start_step, problem=problem)
    terms = pde_term_batch_iterator(max(args.batch // 4, 8), seed=args.seed,
                                    start_step=start_step, problem=problem)
    losses, seconds = [], []
    for step in range(start_step, args.steps):
        xt = next(colloc).to(device)
        tb = to_device(next(terms), device)
        t0 = time.perf_counter()
        params, state, loss = zoo.zo_signsgd_step(
            params, state, lr0 * 0.5 ** (step / half_life), scfg,
            batched_loss_fn=lambda sp: pinn.residual_losses_stacked(
                model, sp, xt, hw_noise, term_batches=tb),
            trainable_mask=mask)
        losses.append(float(loss))                  # waits for the step
        seconds.append(time.perf_counter() - t0)
        if step % args.log_every == 0:
            msg = f"step {step} loss {losses[-1]:.4e} ({seconds[-1]:.2f}s)"
            if val is not None:
                mse = pinn.validation_mse(model, params, val, hw_noise)
                msg += f" val MSE {float(mse):.4e}"
            print(msg, flush=True)
        if mgr and mgr.should_save(step + 1):
            mgr.save(step + 1, _checkpoint_tree(params, state, hw_noise),
                     {"step": step + 1, **ckpt_meta})

    if mgr:
        mgr.save(args.steps, _checkpoint_tree(params, state, hw_noise),
                 {"step": args.steps, **ckpt_meta})
    val_mse = None
    if val is not None:
        val_mse = float(pinn.validation_mse(model, params, val, hw_noise))
        print(f"[pinn] final val MSE {val_mse:.4e}")
    print("[train] done")
    return TrainResult(model, params, hw_noise, losses, seconds, val_mse)


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
                             "auto"])
    ap.add_argument("--quant", default=None, choices=[None, "int8", "fp8_e4m3"],
                    help="quantization-aware training: block-scaled TT-core "
                         "quantization")
    ap.add_argument("--quant-block", type=int, default=32,
                    help="absmax-scaling block size for --quant")
    ap.add_argument("--phase-bits", type=int, default=None,
                    help="DAC resolution of the trainable MZI phases "
                         "(quantization-aware training)")
    # flags of repro.launch.train that exit here (see _unported)
    ap.add_argument("--optimizer", default=None,
                    choices=[None, "adamw", "adafactor", "sgd", "zo-signsgd"])
    ap.add_argument("--sequential", action="store_true")
    ap.add_argument("--shard", default=None,
                    choices=["perturbation", "batch", "both"])
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--async-ckpt", action="store_true")
    ap.add_argument("--spectral-points", type=int, default=None)
    ap.add_argument("--coeff-range", default=None)
    ap.add_argument("--coeff-dist", default=None,
                    choices=[None, "uniform", "loguniform"])
    ap.add_argument("--coeffs-per-step", type=int, default=None)
    ap.add_argument("--term-weight", action="append", default=None)
    ap.add_argument("--bc-weight", type=float, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--zo-vectorized", action="store_true")
    args = ap.parse_args(argv)

    if args.arch not in PINN_ARCHS:
        raise SystemExit(f"--arch {args.arch}: the LM archs are not ported "
                         "yet (ROADMAP queue A, item 14); the port trains "
                         f"{PINN_ARCHS}")
    unported = _unported(args)
    if unported:
        raise SystemExit("; ".join(
            f"{flag} is not ported yet (ROADMAP queue A, item {item})"
            for flag, item in unported))
    return train_pinn(args)


if __name__ == "__main__":
    main()
