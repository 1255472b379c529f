#!/usr/bin/env python3
"""The resident mesh backward of another checkout against this one's, in
turns, in one process on one GPU.

    python3 tools/mesh_apply_grad.py PARENT_SRC [--rounds N] [--sweep]
                                     [--variants]

PARENT_SRC is the ``src`` of another checkout (a ``git archive`` of the
parent commit under ``build/``), loaded as ``tools/densify_grad.py`` loads
it: its ``kernels/mesh_apply.py`` a module of its own on a library built
from its own ``csrc/mesh_apply.cu``.  On ``chip_smoke.MESH_GRAD_CASES``'
``p64-4300``, ``p64-4300-tr``, ``v21-100-tr`` and ``v21-4300-tr`` (the
same inputs as ``chip_smoke.py``'s ``mesh-grad`` phase):

  * arms ``parent`` (its ``mesh_apply_stacked_grad``), ``change`` (this
    checkout's, the design ``resident_grad_design`` picks) and ``block``
    (this checkout's forced onto the block design,
    ``mesh._forced_resident``), run parent, change,
    block, block, change, parent for ``--rounds`` rounds; each arm's call
    back to back on CUDA events (``ms``), its host time (``host_ms``) and
    its kernels alone in a trace (``kernel_device_ms``,
    ``kernels_per_call``, ``kernel_each_ms``);
  * checks: the change within ``chip_smoke.MESH_GRAD_BOUND`` ·
    max|plain| of ``ref.mesh_apply_grad_ref`` and its dx bit-equal to the
    plain version's; the block arm bit-equal to the parent (the same
    kernel); two calls of each arm bit-equal;
  * the bound (``chip_smoke._apply_grad_bound``) and an empty kernel's
    launch (``chip_smoke._empty_launch``).

``--sweep`` also times the warp design's kernel alone at other warps a
block, blocks an SM and least groups a column (the module's
``RES_WARP_*``),
each checked bit-equal to the default's dx and within the bound.
``--variants`` also runs ``p16-4300`` and times, at the launch's own
columns and at ``VARIANT_COLUMNS`` block columns, the warp design with its
columns folded in the launch against summed by ``mesh_grad_sum_kernel``,
and each at a chunk of 1 and of 2 row groups a warp walk (the launch
``resident_grad_warp_config`` gives, its fold and chunk replaced), in
two passes, the second in reverse order: the kernels of a call alone,
and the call back to back; each within the bound, its dx the default's
bits, the fold and the sum kernel bit-equal to each other.  Prints one
``[mesh-apply-grad]`` JSON line a case and the card's name and power
limit.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CASES = ("p64-4300", "p64-4300-tr", "v21-100-tr", "v21-4300-tr")
SWEEP = [(w, b, g) for w in (8, 12, 16, 24, 32) for b in (1, 2)
         for g in (8,)]
VARIANT_COLUMNS = (16, 24, 32, 48, 64)


def inputs(chip_smoke, device, label):
    """The inputs ``chip_smoke._mesh_grad_case`` makes for ``label``."""
    import torch
    from repro_torch.kernels import mesh_apply as mesh
    i = list(chip_smoke.MESH_GRAD_CASES).index(label)
    kind, S, B, shared, transpose = chip_smoke.MESH_GRAD_CASES[label]
    layout = chip_smoke._grad_layout(kind)
    gen = torch.Generator().manual_seed(3500 + i)
    phases = torch.randn((S, *layout.phase_shape()), generator=gen).to(
        device)
    diag = torch.where(torch.rand((S, layout.ports), generator=gen) < 0.5,
                       -1.0, 1.0).to(device)
    x = torch.randn((B, layout.ports) if shared else (S, B, layout.ports),
                    generator=gen).to(device)
    y = mesh.mesh_apply_stacked(layout, phases, diag, x, transpose)
    dy = torch.randn(y.shape, generator=gen).to(device)
    return layout, phases, diag, x, y, dy, transpose, S, B, shared


def measure(chip_smoke, fn, fill) -> dict:
    prof = chip_smoke._profile(fn, match="mesh_",
                               lead=lambda: fill.fill_(0.0))
    return {"ms": chip_smoke._time_ms(fn, 200),
            "host_ms": chip_smoke._host_ms(fn, 200),
            "kernel_device_ms": prof["match_ms"],
            "kernels_per_call": prof["match_kernels"],
            "kernel_each_ms": prof.get("match_each_ms")}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("mesh_apply_grad: no CUDA device", file=sys.stderr)
        return 2
    src = Path(sys.argv[1]).resolve()
    rounds = (int(sys.argv[sys.argv.index("--rounds") + 1])
              if "--rounds" in sys.argv else 2)
    sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "tools")]
    import chip_smoke
    import densify_grad
    import repro_torch
    from repro_torch.kernels import mesh_apply as mesh
    from repro_torch.kernels import ref
    device = repro_torch.resolve_device("cuda")
    _, _, card = chip_smoke.phase_device()
    parent = densify_grad.parent_module(src)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    fill = torch.empty(1, device=device)
    cases = CASES + (("p16-4300",) if "--variants" in sys.argv else ())
    for label in cases:
        layout, phases, diag, x, y, dy, tr, S, B, shared = inputs(
            chip_smoke, device, label)
        arms = {
            "parent": lambda: parent.mesh_apply_stacked_grad(
                layout, phases, diag, y, dy, tr),
            "change": lambda: mesh.mesh_apply_stacked_grad(
                layout, phases, diag, y, dy, tr),
            "block": lambda: forced_block(mesh, layout, phases, diag, y, dy,
                                          tr)}
        got = {arm: fn() for arm, fn in arms.items()}
        if not all(densify_grad.equal(got[arm], fn())
                   for arm, fn in arms.items()):
            raise AssertionError(f"{label}: two calls of an arm differ")
        if not densify_grad.equal(got["block"], got["parent"]):
            raise AssertionError(f"{label}: the block design differs from "
                                 "the parent's")
        pdx, pdph = ref.mesh_apply_grad_ref(layout, phases, diag, x, y, dy,
                                            tr)
        dx, dph = got["change"]
        dxs = dx.sum(0) if shared else dx
        errs = [chip_smoke._grad_share("mesh_apply_stacked_grad", label, a,
                                       b) for a, b in ((dxs, pdx),
                                                       (dph, pdph))]
        design = mesh.resident_grad_design(layout)
        pairs, R, warps, cols, per, chunk, fold = \
            mesh.resident_grad_warp_config(layout, S, B, sms)
        row = {"case": label, "ports": layout.ports, "levels": layout.levels,
               "S": S, "rows": B, "transpose": tr, "resident_design": design,
               "pairs": pairs, "rows_per_warp": R, "warps": warps,
               "block_columns": cols, "groups_per_column": per,
               "chunk": chunk, "fold": fold,
               "max_err_over_bound": max(
                   e / (chip_smoke.MESH_GRAD_BOUND * m) for e, m in errs),
               "dx_bitwise_equal_plain": bool(torch.equal(dxs, pdx)),
               "block_bitwise_equal_parent": True,
               "repeat_bitwise_equal": True,
               "arms": {arm: [] for arm in arms}}
        row["bound_ms"], row["bound_by"] = chip_smoke._apply_grad_bound(
            layout, S, B, "resident")
        order = ["parent", "change", "block"]
        for _ in range(rounds):
            for arm in order + order[::-1]:
                row["arms"][arm].append(measure(chip_smoke, arms[arm], fill))
        if "--sweep" in sys.argv:
            row["sweep"] = sweep(chip_smoke, mesh, layout, phases, diag, y,
                                 dy, tr, dx, pdph, fill, S, B, sms)
        if "--variants" in sys.argv:
            row["variants"] = variants(chip_smoke, mesh, layout, phases, diag,
                                       y, dy, tr, dx, pdph, fill, S, B, sms)
        row.update(chip_smoke._empty_launch(fill))
        print(f"[mesh-apply-grad] {json.dumps(row)}", flush=True)
    print(card, flush=True)
    return 0


def forced_block(mesh, layout, phases, diag, y, dy, tr):
    with mesh._forced_resident("block"):
        return mesh.mesh_apply_stacked_grad(layout, phases, diag, y, dy, tr)


def variants(chip_smoke, mesh, layout, phases, diag, y, dy, tr, dx, pdph,
             fill, S, B, sms) -> list:
    """The warp design at its own columns and at ``VARIANT_COLUMNS`` (by
    ``RES_WARP_MIN_GROUPS``), each folded and summed by the sum kernel,
    at a chunk of 1 and 2 (warps: the groups a column over the chunk, at
    most the launch's most), in two passes; see the module's text."""
    import torch
    config = mesh.resident_grad_warp_config
    L, K = layout.levels, layout.slots
    most = max(1, min(mesh.RES_WARP_WARPS, (
        mesh.SMEM_MAX_BYTES - mesh._res_warp_tables(layout)) // (4 * L * K)))
    R = config(layout, S, B, sms)[1]
    groups = -(-B // R)
    settings = [None] + [-(-groups // c) for c in VARIANT_COLUMNS
                         if c < groups]
    arms = [(g, fold, chunk) for g in settings for fold in (True, False)
            for chunk in (1, 2)]
    keep = mesh.RES_WARP_MIN_GROUPS
    out = {arm: {"min_groups": arm[0], "fold": arm[1], "chunk": arm[2],
                 "runs": []} for arm in arms}

    def run(arm):
        g, fold, chunk = arm
        mesh.RES_WARP_MIN_GROUPS = keep if g is None else g
        pairs, R, _, cols, per, _, _ = config(layout, S, B, sms)
        if cols == 1 and not fold:
            return None
        launch = (pairs, R, min(-(-per // chunk), most), cols, per, chunk,
                  fold and cols > 1)
        mesh.resident_grad_warp_config = lambda *a: launch

        def call():
            return mesh.mesh_apply_stacked_grad(layout, phases, diag, y, dy,
                                                tr)
        got = call()
        if not torch.equal(got[0], dx):
            raise AssertionError(f"variant {arm}: dx differs")
        chip_smoke._grad_share("mesh_apply_stacked_grad", f"variant {arm}",
                               got[1], pdph)
        prof = chip_smoke._profile(call, match="mesh_",
                                   lead=lambda: fill.fill_(0.0))
        return got[1], {"config": list(launch),
                        "kernel_device_ms": prof["match_ms"],
                        "kernels_per_call": prof["match_kernels"],
                        "kernel_each_ms": prof.get("match_each_ms"),
                        "ms": chip_smoke._time_ms(call, 100)}

    try:
        for order in (arms, arms[::-1]):
            sums = {}
            for arm in order:
                got = run(arm)
                if got is None:
                    continue
                sums[arm] = got[0]
                out[arm]["runs"].append(got[1])
            for (g, fold, chunk), d in sums.items():
                other = sums.get((g, not fold, chunk))
                if other is not None and not torch.equal(d, other):
                    raise AssertionError(f"variant {(g, chunk)}: the fold "
                                         "and the sum kernel differ")
    finally:
        mesh.RES_WARP_MIN_GROUPS = keep
        mesh.resident_grad_warp_config = config
    return [v for v in out.values() if v["runs"]]


def sweep(chip_smoke, mesh, layout, phases, diag, y, dy, tr, dx, pdph, fill,
          S, B, sms) -> list:
    """The warp design's kernel alone at each ``SWEEP`` setting of
    (``RES_WARP_WARPS``, ``RES_WARP_BLOCKS_PER_SM``,
    ``RES_WARP_MIN_GROUPS``), its dx the default's bits, its dphases
    within the bound."""
    import torch
    names = ("RES_WARP_WARPS", "RES_WARP_BLOCKS_PER_SM",
             "RES_WARP_MIN_GROUPS")
    keep = [getattr(mesh, n) for n in names]
    out = []
    try:
        for setting in SWEEP:
            for n, v in zip(names, setting):
                setattr(mesh, n, v)

            def call():
                return mesh.mesh_apply_stacked_grad(layout, phases, diag, y,
                                                    dy, tr)
            got = call()
            if not torch.equal(got[0], dx):
                raise AssertionError(f"sweep {setting}: dx differs")
            chip_smoke._grad_share("mesh_apply_stacked_grad",
                                   f"sweep {setting}", got[1], pdph)
            prof = chip_smoke._profile(call, match="mesh_",
                                       lead=lambda: fill.fill_(0.0))
            out.append({"setting": dict(zip(names, setting)),
                        "config": list(mesh.resident_grad_warp_config(
                            layout, S, B, sms)),
                        "kernel_device_ms": prof["match_ms"],
                        "kernels_per_call": prof["match_kernels"],
                        "kernel_each_ms": prof.get("match_each_ms"),
                        "ms": chip_smoke._time_ms(call, 100)})
    finally:
        for n, v in zip(names, keep):
            setattr(mesh, n, v)
    return out


if __name__ == "__main__":
    sys.exit(main())
