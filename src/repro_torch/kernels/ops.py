"""Entry points of the port's kernels, dispatched on the tensor's device.

A tensor on the CPU takes the kernel's plain PyTorch version; a CUDA tensor
launches the hand-written kernel, which raises on anything it cannot take.
There is no switch that sends CUDA tensors to the plain version.

Autograd: on the card ``tt_contract`` itself carries its hand-written
backward (``tt_contract_grad``) whenever an input requires grad, and so do
the mesh entries where autograd needs one: ``mesh_densify_stacked`` goes
through ``mesh_apply.MeshDensifyFn`` (the grouped backward,
``mesh_densify_grad``: the tonn BP baselines' densification) and
``mesh_apply`` / ``mesh_apply_stacked`` through ``mesh_apply.MeshApplyFn``
(``mesh_apply_stacked_grad``: onn's BP; the resident backward up to ~138
ports, and up to 1024 ports the backward of the forward's wide route: the
dense one after route B, the warp-rows one after route A).  The plain versions on the CPU are differentiated by
autograd natively.  The batched TT kernels, the owner walk's mesh layouts
(item 6c-3) and the attention kernel have no backward, so their entries
raise on a CUDA input that requires grad while grad is enabled, before the
launch (``_no_backward``): the ZO steps run without grad and the BP
baselines go through ``tt_linear``.

``quant`` (a ``kernels.quant.QuantConfig``, or None) follows the JAX
package's ``repro.kernels.ops``: with weight quantization on, the TT layers
see block-scaled cores.  With ``quant`` None or without weight
quantization every path is the unquantized one, bit for bit.  With
``phase_bits`` the photonic densification snaps the commanded phases to the
DAC grid before the noise model (``mesh_densify_stacked``, and
``PhotonicMatrix`` around ``mesh_apply_stacked``).
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import photonic as _ph
from repro_torch.core import tt as tt_lib
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mesh_apply as _mesh
from repro_torch.kernels import quant as _quant
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import tt_contract as _ttc

__all__ = ["tt_linear", "tt_linear_batched", "mesh_apply",
           "mesh_apply_stacked", "mesh_densify_stacked", "attention"]


def _weight_quant(quant) -> bool:
    return quant is not None and quant.weights


_NO_BACKWARD_WHY = {
    "mesh": "the layout takes the owner walk (pairs of wires that are not "
            "adjacent, or more than 1024 ports), whose backward is ROADMAP "
            "queue A, item 6c-3; the resident backward holds up to ~138 "
            "ports and the warp-rows backward route A's layouts",
    "tt_batched": "the ZO steps run it without grad, and the BP baselines "
                  "go through tt_linear (tt_contract and its backward)",
    "attention": "an attention backward is ROADMAP queue A, item 14a",
}


def _needs_grad(tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _no_backward(name: str, tensors, kind: str = "mesh") -> None:
    """Raise if autograd would need a backward through a kernel that has
    none (``kind`` names why, and what to use instead)."""
    if _needs_grad(tensors):
        raise ValueError(
            f"{name} on the card has no backward, and an input requires "
            f"grad: {_NO_BACKWARD_WHY[kind]}")


def _mesh_stacked(name: str, layout: _ph.MeshLayout, phases: torch.Tensor,
                  diag: torch.Tensor, x: torch.Tensor,
                  transpose: bool) -> torch.Tensor:
    """The card's standalone mesh: under grad through ``MeshApplyFn``
    where a backward holds the layout (``mesh_apply.grad_design``),
    raising before any launch where none does (the owner walk's layouts,
    item 6c-3); else the forward launch alone."""
    if _needs_grad((phases, diag, x)):
        if _mesh.grad_design(layout) is None:
            _no_backward(name, (phases, diag, x))
        return _mesh.apply_autograd(layout, phases, diag, x, transpose)
    return _mesh.mesh_apply_stacked(layout, phases, diag, x, transpose)


def tt_linear(x: torch.Tensor, cores: Sequence[torch.Tensor],
              spec: tt_lib.TTSpec, quant=None) -> torch.Tensor:
    """``y = x @ W(cores)^T``: x (..., N) → (..., M).  With weight
    quantization the cores are fake-quantized and the f32 chain runs over
    them (the single chain serves only; the JAX package does the same).
    Differentiable on both devices."""
    if _weight_quant(quant):
        cores = [_quant.fake_quant(c, quant) for c in cores]
    if x.device.type == "cpu":
        return _ref.tt_contract_ref(x, cores, spec)
    return _ttc.tt_contract(x, cores, spec)


def tt_linear_batched(x: torch.Tensor, cores: Sequence[torch.Tensor],
                      spec: tt_lib.TTSpec, quant=None,
                      shared_x: bool | None = None) -> torch.Tensor:
    """P stacked TT-linears in one program — the ZO multi-perturbation
    path.  cores: each ``(P, r, m, n, r')``; x ``(..., N)`` shared or
    ``(P, ..., N)`` per entry (``shared_x=None``: 2-D is shared) →
    ``(P, *batch_axes, M)``.  With weight quantization the card runs the
    block-quantized kernel."""
    if _weight_quant(quant):
        if x.device.type == "cpu":
            return _ref.tt_contract_batched_quant_ref(x, cores, spec, quant,
                                                      shared_x)
        _no_backward("tt_contract_batched_quant", (x, *cores), "tt_batched")
        return _ttc.tt_contract_batched_quant(x, cores, spec, quant, shared_x)
    if x.device.type == "cpu":
        return _ref.tt_contract_batched_ref(x, cores, spec, shared_x)
    _no_backward("tt_contract_batched", (x, *cores), "tt_batched")
    return _ttc.tt_contract_batched(x, cores, spec, shared_x)


def mesh_apply(layout: _ph.MeshLayout, phases: torch.Tensor,
               diag: torch.Tensor, x: torch.Tensor,
               transpose: bool = False) -> torch.Tensor:
    """One MZI mesh: phases ``(levels, slots)``, diag ``(P,)``, x
    ``(..., P)`` → ``(..., P)``.  On the card the S = 1 view of
    ``mesh_apply_stacked``, one launch."""
    if x.device.type == "cpu":
        return _ph.mesh_apply(layout, phases, diag, x, transpose)
    rows = x.reshape(-1, layout.ports).contiguous()
    y = _mesh_stacked("mesh_apply", layout, phases[None], diag, rows,
                      transpose)
    return y.reshape(x.shape)


def mesh_apply_stacked(layout: _ph.MeshLayout, phases: torch.Tensor,
                       diag: torch.Tensor, x: torch.Tensor,
                       transpose: bool = False) -> torch.Tensor:
    """S stacked MZI meshes of one layout in one program: phases
    ``(S, levels, slots)``, diag ``(P,)`` or ``(S, P)``, x ``(B, P)``
    shared or ``(S, B, P)`` → ``(S, B, P)``.  On the card the layout picks
    the kernel's design (``mesh_apply.mesh_design``) and, for a wide one,
    the layout, S and B its route (``mesh_apply.wide_route``); a layout
    none holds raises.  Under grad the backward ``mesh_apply.grad_design``
    picks follows (``mesh_apply.MeshApplyFn``); the owner walk's layouts,
    for which it picks none, raise (item 6c-3)."""
    if x.device.type == "cpu":
        return _ph.mesh_apply_stacked(layout, phases, diag, x, transpose)
    return _mesh_stacked("mesh_apply_stacked", layout, phases, diag, x,
                         transpose)


def mesh_densify_stacked(matrices: Sequence[_ph.PhotonicMatrix],
                         params: Sequence[dict], noises: Sequence,
                         noise_model: _ph.NoiseModel | None = None,
                         quant=None) -> list:
    """``to_dense_stacked`` of G photonic matrices in one program — a ZO
    step's whole densification: ``(S, out_dim, in_dim)`` per matrix,
    contiguous (its TT core's memory).  On the card one launch of the
    grouped kernel, which raises for a matrix whose meshes do not fit a
    block; under grad its backward is one launch of the grouped backward
    (``mesh_apply.MeshDensifyFn``), which takes no DAC snap (item 11)."""
    if params[0]["sigma"].device.type == "cpu":
        return _ph.mesh_densify_stacked(matrices, params, noises,
                                        noise_model, quant)
    if _needs_grad([t for p in params for t in p.values()]):
        return _mesh.densify_autograd(matrices, params, noises, noise_model,
                                      quant)
    return _mesh.mesh_densify_stacked(matrices, params, noises, noise_model,
                                      quant)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: int | None = None,
              scale: float | None = None) -> torch.Tensor:
    """Attention with GQA and causal / sliding-window masks: q
    ``(B, H, Sq, D)``, k and v ``(B, KH, Sk, D)`` → ``(B, H, Sq, D)``.  On
    the card the flash-attention kernel (the dtype picks its design), which
    raises on what it cannot take (a head dim over 128, a bf16 head dim
    that is not a multiple of 8, a dtype other than f32 / bf16)."""
    if q.device.type == "cpu":
        return _ref.attention_ref(q, k, v, causal, window, scale)
    _no_backward("flash_attention", (q, k, v), "attention")
    return _fa.flash_attention(q, k, v, causal, window, scale)
