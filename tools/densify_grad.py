#!/usr/bin/env python3
"""The grouped mesh calls of another checkout against this one's, in
turns, in one process on one GPU: ``mesh_densify_grad`` (the grouped
backward) and ``mesh_densify_stacked`` (the grouped forward) on the
paper's 8 core matrices.

    python3 tools/densify_grad.py PARENT_SRC [--rounds N]

PARENT_SRC is the ``src`` of another checkout (a ``git archive`` of the
parent commit under ``build/``).  Its ``kernels/mesh_apply.py`` is loaded
as a module of its own, its ``csrc/mesh_apply.cu`` built by ``nvcc`` with
this checkout's flags into this checkout's build directory, and its
wrappers bound to that library; the rest of the port (layouts, plans)
is this checkout's.  On the same inputs (``chip_smoke.densify_inputs``,
noise on, S = 1 and 11):

  * backward arms: ``parent`` (its host code and kernel), ``change``
    (this checkout's wrapper: the group template and the design it
    picks) and ``template+block`` (this checkout's wrapper forced onto
    the block design, the parent's kernel: the host half alone), run
    parent, change, block, block, change, parent for ``--rounds`` rounds;
    each arm's call back to back on CUDA events (``ms``), its host time
    (``host_ms``: the host's clock over calls that do not wait for the
    card) and its kernel alone in a trace (``kernel_device_ms``).  The
    block arm must give the parent's bits (the same kernel on the same
    descriptors), the change within ``chip_smoke.MESH_GRAD_BOUND`` of
    ``ref.mesh_densify_grad_ref``, two calls of each bit-equal.
  * forward arms: ``parent`` and ``change`` likewise; the outputs
    bit-equal (the forward's kernel is the same).
  * an empty kernel's launch (``chip_smoke._empty_launch``): the floor.

Prints one ``[densify-grad]`` JSON line a case and the card's name and
power limit.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import json
import subprocess
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CASES = {"s1-noise": 1, "s11-noise": 11}


def parent_module(src: Path):
    """The parent's ``kernels/mesh_apply.py`` as module
    ``parent_mesh_apply``, its library built from its own ``.cu``."""
    from repro_torch.kernels import _build
    cu = src / "repro_torch" / "kernels" / "csrc" / "mesh_apply.cu"
    digest = hashlib.sha256(cu.read_bytes()).hexdigest()[:16]
    lib = _build.BUILD_DIR / f"libparent_mesh_apply-{digest}.so"
    if not lib.is_file():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                               str(lib), str(cu)], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {cu}:\n{proc.stderr}")
    spec = importlib.util.spec_from_file_location(
        "parent_mesh_apply", src / "repro_torch" / "kernels" / "mesh_apply.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._build = types.SimpleNamespace(
        load_library=lambda name: ctypes.CDLL(str(lib)))
    return mod


def equal(a, b) -> bool:
    import torch
    return all(torch.equal(x, y) for t, u in zip(a, b)
               for x, y in zip(t if isinstance(t, tuple) else (t,),
                               u if isinstance(u, tuple) else (u,)))


def measure(chip_smoke, fn, fill) -> dict:
    prof = chip_smoke._profile(fn, match="mesh_densify",
                               lead=lambda: fill.fill_(0.0))
    return {"ms": chip_smoke._time_ms(fn, 200),
            "host_ms": chip_smoke._host_ms(fn, 200),
            "kernel_device_ms": prof["match_ms"],
            "kernels_per_call": prof["match_kernels"]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("densify_grad: no CUDA device", file=sys.stderr)
        return 2
    src = Path(sys.argv[1]).resolve()
    rounds = (int(sys.argv[sys.argv.index("--rounds") + 1])
              if "--rounds" in sys.argv else 2)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke
    import repro_torch
    from repro_torch.kernels import mesh_apply as mesh
    from repro_torch.kernels import ref
    device = repro_torch.resolve_device("cuda")
    _, _, card = chip_smoke.phase_device()
    parent = parent_module(src)
    fill = torch.empty(1, device=device)
    out = {"parent_src": str(src), "cases": []}
    for label, S in CASES.items():
        pms, ps, nzs, model, _ = chip_smoke.densify_inputs(
            1024, 4, S, True, None, device, 3300 + S)
        gen = torch.Generator().manual_seed(3400 + S)
        dW = [torch.randn((S, pm.out_dim, pm.in_dim), generator=gen).to(
            device) for pm in pms]
        grads = {
            "parent": lambda: parent.mesh_densify_grad(pms, ps, nzs, model,
                                                       dW),
            "change": lambda: mesh.mesh_densify_grad(pms, ps, nzs, model,
                                                     dW),
            "template+block": lambda: mesh.mesh_densify_grad(
                pms, ps, nzs, model, dW, design="block")}
        forwards = {
            "parent": lambda: parent.mesh_densify_stacked(pms, ps, nzs,
                                                          model),
            "change": lambda: mesh.mesh_densify_stacked(pms, ps, nzs, model)}
        got = {arm: fn() for arm, fn in grads.items()}
        if not all(equal(got[arm], fn()) for arm, fn in grads.items()):
            raise AssertionError(f"{label}: two calls of an arm differ")
        if not equal(got["template+block"], got["parent"]):
            raise AssertionError(f"{label}: the block design through the "
                                 "template differs from the parent's call")
        plain = ref.mesh_densify_grad_ref(pms, ps, nzs, model, dW, True)
        errs = [chip_smoke._grad_share("mesh_densify_grad", label, a, b)
                for t, u in zip(got["change"], plain) for a, b in zip(t, u)]
        fwd = {arm: fn() for arm, fn in forwards.items()}
        if not equal(fwd["change"], fwd["parent"]):
            raise AssertionError(f"{label}: the forward's outputs differ "
                                 "from the parent's")
        row = {"case": label, "S": S, "design": mesh.densify_grad_design(pms),
               "warps": mesh.densify_grad_warps(pms),
               "max_err_over_bound": max(
                   e / (chip_smoke.MESH_GRAD_BOUND * m) for e, m in errs),
               "forward_bitwise_equal_parent": True,
               "block_bitwise_equal_parent": True,
               "backward": {arm: [] for arm in grads},
               "forward": {arm: [] for arm in forwards}}
        order = ["parent", "change", "template+block"]
        for _ in range(rounds):
            for arm in order + order[::-1]:
                row["backward"][arm].append(measure(chip_smoke, grads[arm],
                                                    fill))
            for arm in ("parent", "change", "change", "parent"):
                row["forward"][arm].append(measure(chip_smoke, forwards[arm],
                                                   fill))
        row.update(chip_smoke._empty_launch(fill))
        out["cases"].append(row)
        print(f"[densify-grad] {json.dumps(row)}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
