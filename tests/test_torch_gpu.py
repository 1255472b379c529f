"""Tests that need the card: the CUDA kernels (``tt_contract`` and its
backward ``tt_contract_grad``, ``tt_contract_batched``,
``tt_contract_batched_quant``,
``mesh_apply_stacked`` in its resident design and its three wide routes,
``mesh_densify_stacked``, the mesh backwards ``mesh_densify_grad`` and
``mesh_apply_stacked_grad`` in its three designs, ``flash_attention``)
against their plain PyTorch versions, onn's ZO step, served values (f32 and quantized) against a direct forward,
quantization codes made on the card against the CPU's, one ZO training
step (f32 and quantization-aware) on the card against the same step
through the plain path on the CPU, and a reduced LM's prefill and decode
on the card against the CPU, the BP and sequential ZO training steps
on the card against the CPU, and a conditioned family's coefficient grid
and served pool on the card.

Run on a machine with an NVIDIA GPU (Hopper, ``sm_90a``) and ``nvcc``:

    python -m pytest -m gpu tests/test_torch_gpu.py

Without a card every test skips with that reason.  This file imports no JAX:
the machine with the card does not have it.

Tolerances: kernel against plain ``max|kernel − plain| ≤ 1e-5·max|plain| +
1e-6`` (the same f32 products summed in another order); served against a
direct forward ``rtol = atol = 1e-6`` (the head's matmul may pick another
cuBLAS algorithm for another batch size); the card against the CPU's plain
path ``rtol = atol = 1e-5``; a ZO step's stencil u-values within 1e-4 of
``max|u|`` (f32 chains summed in other orders, and sin/cos from two
libraries) and its losses within ``rtol = 1e-1`` (the FD residual squares
second differences, amplifying those rounding differences by 1/h²).  The
three TT kernels run one body, which sums each element in one order, so
``tt_contract`` is held to ``tt_contract_batched`` at P = 1 bit for bit,
each batched entry to ``tt_contract``, and the quantized kernel, which
quantizes the f32 cores in its launch, to ``tt_contract_batched`` on the
fake-quantized cores; the plain quantizer's codes and scales on the card
to the CPU's bit for bit, and the kernel's quantized cores, read back
through an identity input, to ``fake_quant_stacked`` bit for bit.  The
mesh kernels round every operation on its own in the plain version's order
and take sin/cos from the functions torch runs on the card, so they are
held to their plain versions on the card bit for bit; the wide meshes'
route B (``dense``: route A densifies, a 3xTF32 tensor-core product
multiplies) is held to the f32 bound.  ``flash_attention`` is held to ``attention_ref`` within
``ref.attention_bound`` elementwise: the same f32 bound, and in bf16 one
bf16 ulp of the element's own |plain| more (the two round f32 results that
differ in the last bits); a row that sees no key must be exact zeros.  A reduced f32 LM on the card against the CPU:
logits and caches within 1e-5 of their max magnitude.  ``tt_contract_grad``:
dx at the forward's bound against the plain reverse chain, each dG_k within
``tt_contract.grad_bound`` of the plain chain in float64 (its summation
depth times the magnitudes it adds), and two calls bit for bit.  The
mesh backwards against ``ref.mesh_densify_grad_ref`` /
``mesh_apply_grad_ref`` within ``1e-4·max|plain|`` per output (the
resident one recovers its states level by level), two calls bit for bit.
A BP step's gradients of a u-level functional card vs CPU within
``1e-4·max|grad|`` per leaf.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from repro_torch import configs
from repro_torch.core import photonic, pinn, tt, zoo
from repro_torch.core.photonic import NoiseModel
from repro_torch.device import counter_generator, to_device
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mesh_apply as mesh
from repro_torch.kernels import quant as quant_lib
from repro_torch.kernels import tt_contract as ttc
from repro_torch.models import transformer
from repro_torch.serving import PdeServingEngine, PointRequest, SolverRegistry

pytestmark = pytest.mark.gpu

# label -> (spec, batch): the served pool and a large batch at the paper's
# spec, the reduced config's spec at a batch off the tile, rank 4 non-square
KERNEL_CASES = {
    "paper-2048": (tt.PAPER_TONN_SPEC, 2048),
    "paper-65536": (tt.PAPER_TONN_SPEC, 65536),
    "reduced-1000": (tt.auto_factorize(64, 64, L=3, max_rank=2), 1000),
    "rank4-777": (tt.auto_factorize(256, 512, L=3, max_rank=4), 777),
}


RANK4 = tt.auto_factorize(256, 512, L=3, max_rank=4)

# label -> (spec, P, x shape without its leading P, shared): the three
# launches of a training step at the paper's config (N = 10, batch 100),
# a rank-4 non-square spec off the tile, and extra batch axes
BATCHED_CASES = {
    "layer0-rows": (tt.PAPER_TONN_SPEC, 11, (100,), True),
    "layer0-columns": (tt.PAPER_TONN_SPEC, 11, (21,), True),
    "hidden-stencil": (tt.PAPER_TONN_SPEC, 11, (4300,), False),
    "rank4-777": (RANK4, 3, (777,), False),
    "rank4-shared-axes": (RANK4, 3, (3, 5), True),
}

# label -> (ports, S, B, shared x, transpose): the TONN densification of
# the paper's core meshes (V transposed on the identity, U on the
# per-entry activations), and a 64-port mesh
MESH_CASES = {
    "v16-identity": (16, 11, 16, True, True),
    "v4-identity": (4, 11, 4, True, True),
    "u4-per-entry": (4, 11, 16, False, False),
    "u16-per-entry": (16, 11, 4, False, False),
    "u16-shared": (16, 11, 16, True, False),
    "p64-per-entry": (64, 3, 37, False, True),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run "
                    "`python -m pytest -m gpu tests/test_torch_gpu.py`")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _chain_inputs(spec, batch, seed, device):
    gen = torch.Generator().manual_seed(seed)
    cores = [c.to(device) for c in tt.tt_init(gen, spec)]
    x = torch.randn((batch, spec.in_dim), generator=gen).to(device)
    return cores, x


def _assert_kernel_close(y_k, y_p):
    torch.cuda.synchronize()
    assert torch.isfinite(y_k).all()
    err = (y_k - y_p).abs().max().item()
    assert err <= 1e-5 * y_p.abs().max().item() + 1e-6, err


@pytest.mark.parametrize("label", sorted(KERNEL_CASES))
def test_kernel_matches_plain(cuda, label):
    spec, batch = KERNEL_CASES[label]
    cores, x = _chain_inputs(spec, batch, seed=len(label), device=cuda)
    _assert_kernel_close(ttc.tt_contract(x, cores, spec),
                         ref.tt_contract_ref(x, cores, spec))


def test_dispatch_launches_the_kernel_with_batch_axes(cuda):
    spec = tt.PAPER_TONN_SPEC
    cores, x = _chain_inputs(spec, 15, seed=1, device=cuda)
    before = ttc.tt_contract.launches
    y = ops.tt_linear(x.reshape(3, 5, spec.in_dim), cores, spec)
    assert ttc.tt_contract.launches == before + 1
    assert tuple(y.shape) == (3, 5, spec.out_dim)
    _assert_kernel_close(y.reshape(15, -1), ref.tt_contract_ref(x, cores, spec))


def test_rows_do_not_depend_on_their_tile(cuda):
    """A row's value is the same bits wherever it lands in the grid, so
    the engine's padding cannot change a served value.  The batch is large
    enough for the fiber body's full tile, and not a multiple of it."""
    spec = tt.PAPER_TONN_SPEC
    cores, x = _chain_inputs(spec, 6637, seed=2, device=cuda)
    tile = ttc.fiber_tile(spec, len(x)).rows
    assert tile == ttc.fiber_tile(spec).rows and len(x) % tile
    y = ttc.tt_contract(x, cores, spec)
    for shift in (1, 3, tile + 1):
        assert torch.equal(ttc.tt_contract(x[shift:].contiguous(), cores,
                                           spec), y[shift:])


@pytest.mark.parametrize("label", sorted(KERNEL_CASES) + ["paper-6637"])
def test_tt_contract_equals_the_batched_kernel_bitwise(cuda, label):
    """``tt_contract`` gives the bits of ``tt_contract_batched`` at P = 1:
    two launches of one body, which sums every output element in one
    order, on tiles of their own rows."""
    spec, batch = KERNEL_CASES.get(label, (tt.PAPER_TONN_SPEC, 6637))
    cores, x = _chain_inputs(spec, batch, seed=len(label), device=cuda)
    y = ttc.tt_contract(x, cores, spec)
    y_b = ttc.tt_contract_batched(x, [c[None] for c in cores], spec)
    assert torch.equal(y, y_b[0])


def test_fiber_body_takes_odd_widths_and_unaligned_x(cuda):
    """The x and y tiles move as float4 only where the widths and pointers
    allow: an x that starts 4 bytes off a 16-byte boundary, and a spec of
    widths 13 → 7, take the scalar accesses and give the same bits."""
    spec = tt.PAPER_TONN_SPEC
    cores, x = _chain_inputs(spec, 301, seed=4, device=cuda)
    buf = torch.empty(x.numel() + 1, device=cuda)
    off = buf[1:].view_as(x)
    off.copy_(x)
    assert off.is_contiguous() and off.data_ptr() % 16 == 4
    y = ttc.tt_contract(x, cores, spec)
    assert torch.equal(ttc.tt_contract(off, cores, spec), y)
    quant = quant_lib.QuantConfig(enabled=True)
    stacked = [torch.stack([c, 0.5 * c]) for c in cores]
    assert torch.equal(
        ttc.tt_contract_batched_quant(off, stacked, spec, quant),
        ttc.tt_contract_batched_quant(x, stacked, spec, quant))
    odd = tt.auto_factorize(7, 13, L=2, max_rank=3)
    assert odd.in_dim % 4 and odd.out_dim % 4
    cores, x = _chain_inputs(odd, 37, seed=5, device=cuda)
    y = ttc.tt_contract(x, cores, odd)
    _assert_kernel_close(y, ref.tt_contract_ref(x, cores, odd))
    assert torch.equal(y, ttc.tt_contract_batched(
        x, [c[None] for c in cores], odd)[0])


def test_wrapper_refuses_what_the_kernel_cannot_take(cuda):
    spec = tt.auto_factorize(64, 64, L=3, max_rank=2)
    cores, x = _chain_inputs(spec, 8, seed=3, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ttc.tt_contract(x[::2], cores, spec)
    with pytest.raises(TypeError, match="float32"):
        ttc.tt_contract(x.double(), cores, spec)
    with pytest.raises(ValueError, match="in_dim"):
        ttc.tt_contract(x[:, :32].contiguous(), cores, spec)
    with pytest.raises(ValueError, match="core 0"):
        ttc.tt_contract(x, [c.cpu() for c in cores], spec)
    assert ttc.tt_contract(x[:0], cores, spec).shape == (0, spec.out_dim)
    # a fiber past the cap: (r·n_k, m_k·r') = (16, 96) at the first step
    wide = tt.auto_factorize(96, 128, L=2, max_rank=8)
    cores, x = _chain_inputs(wide, 8, seed=3, device=cuda)
    before = ttc.tt_contract.launches
    with pytest.raises(ValueError, match="at most 32"):
        ttc.tt_contract(x, cores, wide)
    assert ttc.tt_contract.launches == before


@pytest.mark.parametrize("name", ["tt_contract", "mesh_apply",
                                  "flash_attention"])
def test_build_is_cached_by_source_hash(cuda, name):
    lib = _build.build(name)
    assert lib.parent == _build.BUILD_DIR and lib.is_file()
    assert _build.build(name) == lib


def _stacked_inputs(spec, P, x_shape, shared, seed, device):
    gen = torch.Generator().manual_seed(seed)
    per = [tt.tt_init(gen, spec) for _ in range(P)]
    cores = [torch.stack([c[k] for c in per]).to(device)
             for k in range(spec.L)]
    lead = () if shared else (P,)
    x = torch.randn((*lead, *x_shape, spec.in_dim), generator=gen).to(device)
    return cores, x


@pytest.mark.parametrize("label", sorted(BATCHED_CASES))
def test_batched_kernel_matches_plain(cuda, label):
    spec, P, x_shape, shared = BATCHED_CASES[label]
    cores, x = _stacked_inputs(spec, P, x_shape, shared, len(label), cuda)
    y = ttc.tt_contract_batched(x, cores, spec, shared_x=shared)
    assert tuple(y.shape) == (P, *x_shape, spec.out_dim)
    _assert_kernel_close(y, ref.tt_contract_batched_ref(x, cores, spec,
                                                        shared_x=shared))


@pytest.mark.parametrize("label", ["layer0-rows", "layer0-columns",
                                   "hidden-stencil", "rank4-777"])
def test_batched_entry_equals_tt_contract_bitwise(cuda, label):
    """Entry p of the batched kernel runs tt_contract's chain: the same
    bits as tt_contract(x[p], cores[p]), with x shared and per entry, at
    tiles of 1 (layer 0's columns) to 16 rows."""
    spec, P, x_shape, shared = BATCHED_CASES[label]
    cores, x = _stacked_inputs(spec, P, x_shape, shared, 7, cuda)
    y = ttc.tt_contract_batched(x, cores, spec, shared_x=shared)
    for p in range(P):
        single = ttc.tt_contract(x if shared else x[p].contiguous(),
                                 [c[p].contiguous() for c in cores], spec)
        assert torch.equal(y[p], single), p


def test_batched_rows_do_not_depend_on_their_tile(cuda):
    """The hidden layer's rows at the full fiber tile, shifted across its
    blocks, give the same bits."""
    spec, P, x_shape, _ = BATCHED_CASES["hidden-stencil"]
    cores, x = _stacked_inputs(spec, P, x_shape, False, 3, cuda)
    tile = ttc.fiber_tile(spec, P * x_shape[0]).rows
    assert tile == ttc.fiber_tile(spec).rows and x_shape[0] % tile
    y = ttc.tt_contract_batched(x, cores, spec)
    for shift in (1, 3, tile + 2):
        assert torch.equal(ttc.tt_contract_batched(
            x[:, shift:].contiguous(), cores, spec), y[:, shift:])


def test_batched_dispatch_counts_its_launches(cuda):
    spec, P, x_shape, shared = BATCHED_CASES["rank4-shared-axes"]
    cores, x = _stacked_inputs(spec, P, x_shape, shared, 5, cuda)
    before = ttc.tt_contract_batched.launches
    y = ops.tt_linear_batched(x, cores, spec, shared_x=True)
    assert ttc.tt_contract_batched.launches == before + 1
    assert tuple(y.shape) == (P, *x_shape, spec.out_dim)
    with pytest.raises(ValueError, match="contiguous"):
        ttc.tt_contract_batched(x.transpose(0, 1), cores, spec)
    with pytest.raises(ValueError, match="core 1"):
        ttc.tt_contract_batched(x, [cores[0]] + [c[:1] for c in cores[1:]],
                                spec)


def _mesh_inputs(ports, S, B, shared, seed, device):
    layout = photonic.rectangular_layout(ports)
    gen = torch.Generator().manual_seed(seed)
    phases = torch.randn((S, *layout.phase_shape()), generator=gen)
    diag = torch.where(torch.rand((S, ports), generator=gen) < 0.5, -1.0, 1.0)
    x = torch.randn((B, ports) if shared else (S, B, ports), generator=gen)
    return layout, phases.to(device), diag.to(device), x.to(device)


@pytest.mark.parametrize("label", sorted(MESH_CASES))
def test_mesh_kernel_matches_plain(cuda, label):
    ports, S, B, shared, transpose = MESH_CASES[label]
    layout, phases, diag, x = _mesh_inputs(ports, S, B, shared, len(label),
                                           cuda)
    for d in (diag, diag[0].contiguous()):             # (S, P) and (P,)
        before = mesh.mesh_apply_stacked.launches
        y = ops.mesh_apply_stacked(layout, phases, d, x, transpose)
        assert mesh.mesh_apply_stacked.launches == before + 1
        assert tuple(y.shape) == (S, B, ports)
        plain = photonic.mesh_apply_stacked(layout, phases, d, x, transpose)
        _assert_kernel_close(y, plain)
        # products and sums rounded one by one, in the plain order
        assert torch.equal(y, plain)


def test_mesh_kernel_is_one_launch_and_one_allocation(cuda):
    """The standalone entry builds no tables on the host: one call is one
    allocation (its output) and one kernel on the card."""
    from torch.profiler import ProfilerActivity, profile

    ports, S, B, shared, transpose = MESH_CASES["v16-identity"]
    layout, phases, diag, x = _mesh_inputs(ports, S, B, shared, 1, cuda)
    mesh.mesh_apply_stacked(layout, phases, diag, x, transpose)   # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        seen = chip_smoke.aten_ops(lambda: mesh.mesh_apply_stacked(
            layout, phases, diag, x, transpose))
        torch.cuda.synchronize()
    assert [f.__name__.split(".")[0] for f in seen] == ["empty"]
    kernels = [e.name for e in p.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "mesh_apply_kernel" in kernels[0], kernels


# label -> (hidden, tt_L, S): the 8 core matrices of the paper's config at
# N = 10 and at one entry, the 6 of the reduced config at S = 3
DENSIFY_CASES = {"paper-11": (1024, 4, 11), "paper-1": (1024, 4, 1),
                 "reduced-3": (64, 3, 3)}


@pytest.mark.parametrize("bits", [None, 8])
@pytest.mark.parametrize("noisy", [False, True])
@pytest.mark.parametrize("label", sorted(DENSIFY_CASES))
def test_densify_kernel_matches_plain(cuda, label, noisy, bits):
    """The grouped kernel over all of a model's core matrices (G = 8 or 6)
    and over each one alone (G = 1) is bit-equal to the plain twin on the
    card, in one launch per call, and close to the CPU's."""
    hidden, tt_L, S = DENSIFY_CASES[label]
    pms, ps, nzs, model, quant = chip_smoke.densify_inputs(
        hidden, tt_L, S, noisy, bits, cuda, seed=S, mixed_diag=True)
    plain = photonic.mesh_densify_stacked(pms, ps, nzs, model, quant)
    before = (mesh.mesh_densify_stacked.launches,
              mesh.mesh_apply_stacked.launches)
    got = ops.mesh_densify_stacked(pms, ps, nzs, model, quant)
    assert (mesh.mesh_densify_stacked.launches,
            mesh.mesh_apply_stacked.launches) == (before[0] + 1, before[1])
    torch.cuda.synchronize()
    for w, want in zip(got, plain, strict=True):
        assert w.is_contiguous() and torch.equal(w, want)
    for g in range(len(pms)):
        one = mesh.mesh_densify_stacked(pms[g:g + 1], ps[g:g + 1],
                                        nzs[g:g + 1], model, quant)
        assert torch.equal(one[0], plain[g])
    cpu = torch.device("cpu")
    on_cpu = photonic.mesh_densify_stacked(
        pms, [to_device(p, cpu) for p in ps],
        [None if nz is None else to_device(nz, cpu) for nz in nzs], model,
        quant)
    for w, want in zip(got, on_cpu):
        _assert_kernel_close(w.cpu(), want)


def test_densify_kernel_refuses_what_it_cannot_take(cuda):
    """A matrix whose meshes do not fit a block raises on the card (there
    is no plain fallback there), and so do CPU tensors and a group larger
    than one launch takes."""
    pms, ps, nzs, model, quant = chip_smoke.densify_inputs(
        64, 3, 3, True, 8, cuda, seed=3, mixed_diag=True)
    wide = photonic.PhotonicMatrix(110, 110)
    p = {k: v.expand(3, *v.shape).contiguous().to(cuda)
         for k, v in wide.init(torch.Generator().manual_seed(0)).items()}
    with pytest.raises(ValueError, match="shared memory"):
        ops.mesh_densify_stacked([wide], [p], [None], None, None)
    with pytest.raises(ValueError, match="1..20"):
        ops.mesh_densify_stacked(pms * 4, ps * 4, nzs * 4, model, quant)
    with pytest.raises(ValueError, match="matrix 1 u gamma"):
        ops.mesh_densify_stacked(pms, ps, [nzs[0], to_device(
            nzs[1], torch.device("cpu")), *nzs[2:]], model, quant)


def _routes_counted(launch, route):
    """``launch()``'s result; asserts it added one launch to ``route`` and
    none to any other design."""
    before = dict(mesh.mesh_apply_stacked.design_launches)
    y = launch()
    after = mesh.mesh_apply_stacked.design_launches
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == route) for k in after}
    return y


def test_mesh_kernel_refuses_a_layout_over_shared_memory(cuda):
    """A layout whose tables pass the resident design's shared memory
    takes a wide route on the card (it never runs the plain version
    there), and the resident launch function still refuses it."""
    for ports in (160, 1024):
        layout, phases, diag, x = _mesh_inputs(ports, 1, 2, True, 0, cuda)
        assert mesh.wide_route(layout, 1, 2) == "warp_rows"
        y = _routes_counted(
            lambda: ops.mesh_apply_stacked(layout, phases, diag, x),
            "warp_rows")
        assert torch.equal(y, photonic.mesh_apply_stacked(layout, phases,
                                                          diag, x))
        with pytest.raises(ValueError, match="shared memory"):
            mesh.launch_resident(layout, phases, diag, x)
    assert mesh.rows_per_block(photonic.rectangular_layout(138)) >= 1


# label -> (layout kind, ports, S, B, shared x, transpose): onn's 1024-port
# meshes (the columns feed of layer 0, a per-entry transposed feed, 11 x
# 300 rows), a 160-port mesh at a batch off every tile, and a Reck-ordered
# layout of decompose_orthogonal (509 levels)
WIDE_CASES = {
    "rect1024-shared": ("rect", 1024, 3, 21, True, False),
    "rect1024-per-entry-tr": ("rect", 1024, 3, 37, False, True),
    "rect1024-11x300": ("rect", 1024, 11, 300, False, False),
    "rect160-777": ("rect", 160, 3, 777, False, False),
    "reck256-per-entry-tr": ("reck", 256, 2, 19, False, True),
}


def _wide_inputs(label, device, cases=None):
    kind, ports, S, B, shared, transpose = (cases or WIDE_CASES)[label]
    if kind == "rect":
        layout = photonic.rectangular_layout(ports)
    elif kind == "skew":
        layout = chip_smoke.skew_layout(ports)
    else:
        q, _ = np.linalg.qr(np.random.RandomState(ports).standard_normal(
            (ports, ports)))
        layout = photonic.decompose_orthogonal(q)[0]
    gen = torch.Generator().manual_seed(len(label))
    phases = torch.randn((S, *layout.phase_shape()), generator=gen)
    diag = torch.where(torch.rand((S, ports), generator=gen) < 0.5, -1.0, 1.0)
    x = torch.randn((B, ports) if shared else (S, B, ports), generator=gen)
    return (layout, phases.to(device), diag.to(device), x.to(device),
            transpose)


@pytest.mark.parametrize("label", sorted(WIDE_CASES))
def test_streamed_kernel_matches_plain_bitwise(cuda, label):
    """Route A (warp rows) against the plain version on the card, bit for
    bit (every product and sum rounded on its own in the plain order),
    diag ``(S, P)`` and ``(P,)``, one route A launch a call; where the
    dispatch picks route A it takes it too."""
    layout, phases, diag, x, transpose = _wide_inputs(label, cuda)
    assert mesh.mesh_design(layout) == "wide" and mesh.adjacent_pairs(layout)
    S, B = phases.shape[0], x.shape[-2]
    for d in (diag, diag[0].contiguous()):
        y = _routes_counted(lambda: mesh.launch_warp_rows(
            layout, phases, d, x, transpose), "warp_rows")
        plain = photonic.mesh_apply_stacked(layout, phases, d, x, transpose)
        _assert_kernel_close(y, plain)
        assert torch.equal(y, plain)
        if mesh.wide_route(layout, S, B) == "warp_rows":
            assert torch.equal(_routes_counted(
                lambda: ops.mesh_apply_stacked(layout, phases, d, x,
                                               transpose), "warp_rows"), y)


# label -> (layout kind, ports, S, B, shared x, transpose): route B's cases
DENSE_CASES = {
    "rect1024-1100": ("rect", 1024, 3, 1100, False, False),
    "rect1024-1100-shared-tr": ("rect", 1024, 3, 1100, True, True),
    "rect160-777": ("rect", 160, 3, 777, False, False),
    "rect160-777-shared-tr": ("rect", 160, 3, 777, True, True),
    "reck256-600-tr": ("reck", 256, 2, 600, False, True),
}


@pytest.mark.parametrize("label", sorted(DENSE_CASES))
def test_dense_route_within_the_f32_bound(cuda, label):
    """Route B (route A densifies each entry's mesh, a 3xTF32 tensor-core
    kernel multiplies) within ``1e-5·max|plain| + 1e-6`` of the plain
    version, x shared and per entry, transposed and not, ports off every
    tile; one route B launch a call, and the dispatch takes it where the
    rows per entry reach the threshold."""
    layout, phases, diag, x, transpose = _wide_inputs(label, cuda,
                                                      DENSE_CASES)
    S, B = phases.shape[0], x.shape[-2]
    y = _routes_counted(lambda: mesh.launch_dense(
        layout, phases, diag, x, transpose), "dense")
    plain = photonic.mesh_apply_stacked(layout, phases, diag, x, transpose)
    assert tuple(y.shape) == tuple(plain.shape)
    _assert_kernel_close(y, plain)
    assert (mesh.wide_route(layout, S, B) == "dense") == (
        B >= mesh.DENSE_MIN_ROWS_PER_PORT * layout.ports)
    if mesh.wide_route(layout, S, B) == "dense":
        _routes_counted(lambda: ops.mesh_apply_stacked(
            layout, phases, diag, x, transpose), "dense")


def test_owner_walk_on_a_layout_whose_pairs_are_not_adjacent(cuda):
    """A 160-port layout of pairs (a, a+2) takes the owner walk by
    dispatch, bit for bit against the plain version; route A and route B
    refuse it."""
    cases = {"skew160": ("skew", 160, 3, 200, False, True)}
    layout, phases, diag, x, transpose = _wide_inputs("skew160", cuda, cases)
    assert mesh.mesh_design(layout) == "wide"
    assert mesh.wide_route(layout, 3, 200) == "owner_walk"
    y = _routes_counted(lambda: ops.mesh_apply_stacked(
        layout, phases, diag, x, transpose), "owner_walk")
    assert torch.equal(y, photonic.mesh_apply_stacked(layout, phases, diag,
                                                      x, transpose))
    for launch in (mesh.launch_warp_rows, mesh.launch_dense):
        with pytest.raises(ValueError, match="adjacent"):
            launch(layout, phases, diag, x, transpose)


@pytest.mark.parametrize("label", sorted(MESH_CASES))
def test_streamed_entry_equals_the_resident_bitwise(cuda, label):
    """Where the resident design holds the layout, route A and the owner
    walk give its bits, and each counts its own launches."""
    ports, S, B, shared, transpose = MESH_CASES[label]
    layout, phases, diag, x = _mesh_inputs(ports, S, B, shared, len(label),
                                           cuda)
    y_r = _routes_counted(lambda: mesh.launch_resident(
        layout, phases, diag, x, transpose), "resident")
    y_w = _routes_counted(lambda: mesh.launch_owner_walk(
        layout, phases, diag, x, transpose), "owner_walk")
    y_a = _routes_counted(lambda: mesh.launch_warp_rows(
        layout, phases, diag, x, transpose), "warp_rows")
    torch.cuda.synchronize()
    assert torch.equal(y_w, y_r) and torch.equal(y_a, y_r)


def test_mesh_entries_refuse_grad_on_the_card(cuda):
    """The owner walk has no backward (item 6c-3): on its layouts (here
    160 ports paired (a, a+2)) a CUDA input that requires grad raises
    while grad is enabled, and passes under ``no_grad``."""
    layout = chip_smoke.skew_layout(160)
    gen = torch.Generator().manual_seed(0)
    phases = torch.randn((1, *layout.phase_shape()), generator=gen).to(cuda)
    diag = torch.where(torch.rand((1, 160), generator=gen) < 0.5, -1.0,
                       1.0).to(cuda)
    x = torch.randn((2, 160), generator=gen).to(cuda)
    phases.requires_grad_()
    with pytest.raises(ValueError, match="no backward.*item 6c-3"):
        ops.mesh_apply(layout, phases[0], diag[0], x)
    with torch.no_grad():
        y = ops.mesh_apply(layout, phases[0], diag[0], x)
    assert torch.equal(y, photonic.mesh_apply(layout, phases[0].detach(),
                                              diag[0], x))


def test_batched_tt_and_attention_refuse_grad_on_the_card(cuda):
    """``ops.tt_linear_batched`` (f32 and int8) and ``ops.attention`` have
    no backward on the card: a CUDA input that requires grad raises while
    grad is enabled, and the same calls under ``no_grad`` launch, equal to
    their plain versions (phase 3's bound)."""
    spec = tt.PAPER_TONN_SPEC
    gen = torch.Generator().manual_seed(5)
    cores = [c[None].to(cuda) for c in tt.tt_init(gen, spec)]
    x = torch.randn((7, spec.in_dim), generator=gen).to(cuda)
    x.requires_grad_()
    int8 = quant_lib.QuantConfig(enabled=True, dtype="int8")
    q = torch.randn((1, 2, 16, 32), generator=gen).to(cuda)
    kv = torch.randn((1, 1, 16, 32), generator=gen).to(cuda)
    q.requires_grad_()
    calls = {
        "tt_contract_batched": (
            lambda: ops.tt_linear_batched(x, cores, spec),
            lambda: ref.tt_contract_batched_ref(x.detach(), cores, spec)),
        "tt_contract_batched_quant": (
            lambda: ops.tt_linear_batched(x, cores, spec, quant=int8),
            lambda: ref.tt_contract_batched_quant_ref(x.detach(), cores,
                                                      spec, int8)),
        "flash_attention": (
            lambda: ops.attention(q, kv, kv),
            lambda: ref.attention_ref(q.detach(), kv, kv))}
    for name, (call, plain) in calls.items():
        counter = ttc if name.startswith("tt") else fa
        before = getattr(counter, name).launches
        with pytest.raises(ValueError, match="no backward"):
            call()
        assert getattr(counter, name).launches == before
        with torch.no_grad():
            y = call()
        assert getattr(counter, name).launches == before + 1
        want = plain()
        assert y.grad_fn is None
        assert (y - want).abs().max().item() <= \
            1e-5 * want.abs().max().item() + 1e-6, name


def test_prepare_params_is_one_grouped_launch_as_plain(cuda):
    """tonn's ``prepare_params`` (serving's load, the sequential ZO path)
    is one ``mesh_densify_stacked`` launch on the card, bit-equal to the
    plain per-matrix densification it replaced
    (``prepare_params_plain``), noise and 8-bit phases on."""
    cfg = pinn.PINNConfig(hidden=1024, mode="tonn", tt_L=4,
                          noise=NoiseModel(enabled=True),
                          quant=quant_lib.QuantConfig(enabled=True,
                                                      dtype=None,
                                                      phase_bits=8))
    model = pinn.TensorPinn(cfg)
    params = to_device(model.init(counter_generator(0)), cuda)
    noise = to_device(model.sample_noise(counter_generator(0, 99)), cuda)
    before = mesh.mesh_densify_stacked.launches
    with torch.no_grad():
        prepared, eff = model.prepare_params(params, noise)
    assert mesh.mesh_densify_stacked.launches == before + 1 and eff is None
    plain, _ = model.prepare_params_plain(params, noise)
    torch.cuda.synchronize()
    for i in (0, 1):
        for a, b in zip(prepared[f"cores{i}"], plain[f"cores{i}"]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("hidden", [64, 1024])
def test_onn_zo_step_on_the_card_matches_the_cpu(cuda, hidden):
    """onn's stacked FD stencil and (P,) losses on the card against the
    same params, ξ, batch and noise through the plain path on the CPU.
    Each stencil pass runs six stacked meshes: at hidden 1024 two resident
    (layer 0's 21-port V mesh, on the rows and on the identity columns)
    and four wide ones (layer 0's U mesh on the 96 rows and 21 columns by
    route A, the hidden layer's V and U on 43 x 96 rows by route B); at
    hidden 64 all six resident."""
    cfg = pinn.PINNConfig(hidden=hidden, mode="onn", deriv="fd_fast",
                          use_fused_kernel=True,
                          noise=NoiseModel(enabled=True))
    model = pinn.TensorPinn(cfg)
    params = model.init(counter_generator(0))
    noise = model.sample_noise(counter_generator(0, 99))
    xt = model.problem.sample_collocation(counter_generator(1), 96)
    n = 3 if hidden == 64 else 1        # the CPU's plain 1024-level meshes
    scfg = zoo.SPSAConfig(num_samples=n)
    xis = zoo.sample_perturbations(counter_generator(2), params, n,
                                   model.trainable_mask(params))
    stacked = zoo.perturbed_stack(params, xis, scfg)

    def step(device):
        sp, nz = to_device(stacked, device), to_device(noise, device)
        x = xt.to(device)
        u = model.fd_u_stencil_stacked(sp, x, model.fd_step, nz)
        return u.cpu(), pinn.residual_losses_stacked(model, sp, x, nz).cpu()

    before = dict(mesh.mesh_apply_stacked.design_launches)
    u_card, l_card = step(cuda)
    torch.cuda.synchronize()
    after = mesh.mesh_apply_stacked.design_launches
    wide = 2 if hidden == 1024 else 0
    assert {k: after[k] - before[k] for k in after} == {
        "resident": 2 * (6 - 2 * wide), "warp_rows": 2 * wide,
        "dense": 2 * wide, "owner_walk": 0}
    u_cpu, l_cpu = step(torch.device("cpu"))
    assert torch.isfinite(u_card).all() and torch.isfinite(l_card).all()
    assert (u_card - u_cpu).abs().max() <= 1e-4 * u_cpu.abs().max()
    np.testing.assert_allclose(l_card.numpy(), l_cpu.numpy(), rtol=1e-1)


@pytest.mark.parametrize("hidden,tt_L", [(64, 3), (1024, 4)])
def test_zo_step_on_the_card_matches_the_cpu(cuda, hidden, tt_L):
    """One ZO step's stacked stencil u-values and (P,) losses on the card
    against the same params, ξ, batch and noise through the plain path on
    the CPU; each stencil pass launches 3 batched chains and densifies
    every core mesh in one grouped launch, with no standalone mesh."""
    cfg = pinn.PINNConfig(hidden=hidden, mode="tonn", tt_L=tt_L,
                          deriv="fd_fast", use_fused_kernel=True,
                          noise=NoiseModel(enabled=True))
    model = pinn.TensorPinn(cfg)
    params = model.init(counter_generator(0))
    noise = model.sample_noise(counter_generator(0, 99))
    # 96 points average the FD noise of the losses (a 1-ulp difference in
    # u moves a point's residual by ~0.1) under the rtol
    xt = model.problem.sample_collocation(counter_generator(1), 96)
    scfg = zoo.SPSAConfig(num_samples=3)
    xis = zoo.sample_perturbations(counter_generator(2), params, 3,
                                   model.trainable_mask(params))
    stacked = zoo.perturbed_stack(params, xis, scfg)

    def step(device):
        sp, nz = to_device(stacked, device), to_device(noise, device)
        x = xt.to(device)
        prepared = model.prepare_params_stacked(sp, nz)
        u = model.fd_u_stencil_stacked(prepared, x, model.fd_step)
        return u.cpu(), pinn.residual_losses_stacked(model, sp, x, nz).cpu()

    counters = (ttc.tt_contract_batched, mesh.mesh_densify_stacked,
                mesh.mesh_apply_stacked)
    before = [fn.launches for fn in counters]
    u_card, l_card = step(cuda)
    torch.cuda.synchronize()
    # two stencil passes above (u, then the losses), each on freshly
    # densified cores: 2 × (3 chains, 1 grouped densification)
    assert [fn.launches - b for fn, b in zip(counters, before)] == \
        [2 * 3, 2, 0]
    u_cpu, l_cpu = step(torch.device("cpu"))
    assert torch.isfinite(u_card).all() and torch.isfinite(l_card).all()
    assert (u_card - u_cpu).abs().max() <= 1e-4 * u_cpu.abs().max()
    np.testing.assert_allclose(l_card.numpy(), l_cpu.numpy(), rtol=1e-1)


def test_served_matches_direct_on_the_card(cuda):
    """The paper's solver (hjb-20d, tonn, hidden 1024, noise on) and
    heat-10d (tt) served from one pool on the card."""
    reg = SolverRegistry(device=cuda)
    reg.register_fresh("hjb", pinn.PINNConfig(
        hidden=1024, mode="tonn", tt_rank=2, tt_L=4, pde="hjb-20d",
        use_fused_kernel=True, noise=NoiseModel(enabled=True)),
        seed=0, device=cuda)
    reg.register_fresh("heat", pinn.PINNConfig(
        hidden=1024, mode="tt", tt_rank=2, tt_L=4, pde="heat-10d"),
        seed=1, device=cuda)
    eng = PdeServingEngine(reg, slots=8, slot_points=256, device=cuda)
    rng = np.random.RandomState(0)
    traffic = [(("hjb", "heat")[i % 2], n) for i, n in
               enumerate([1, 256, 97, 3000, 40, 511])]
    before = ttc.tt_contract.launches
    reqs = [eng.submit(PointRequest(name, rng.uniform(
        0.02, 0.98, (n, reg.get(name).in_dim)).astype(np.float32)))
        for name, n in traffic]
    eng.run()
    torch.cuda.synchronize()
    assert ttc.tt_contract.launches - before == 2 * eng.stats["program_runs"]
    assert eng.stats["compiles"] == 2
    for r in reqs:
        assert r.done and np.isfinite(r.out).all()
        s = reg.get(r.solver)
        pts = torch.tensor(r.points, dtype=torch.float32)
        with torch.no_grad():
            direct = s.model.u(s.params, pts.to(cuda)).cpu().numpy()
            plain = s.model.u(to_device(s.params, torch.device("cpu")),
                              pts).numpy()
        np.testing.assert_allclose(r.out, direct, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(r.out, plain, rtol=1e-5, atol=1e-5)


# label -> (spec, P, x shape without P, shared, block): the three launches
# of a QAT step at the paper's config (core sizes 64: no padding at block
# 32), and the rank-4 spec (core sizes 256, 1024 and 128) at blocks that
# divide them and at block 24, which pads every core's last run
QUANT_CASES = {
    "layer0-rows": (tt.PAPER_TONN_SPEC, 11, (100,), True, 32),
    "layer0-columns": (tt.PAPER_TONN_SPEC, 11, (21,), True, 32),
    "hidden-stencil": (tt.PAPER_TONN_SPEC, 11, (4300,), False, 32),
    "paper-b24": (tt.PAPER_TONN_SPEC, 3, (50,), False, 24),
    "rank4-777-b32": (RANK4, 3, (777,), False, 32),
    "rank4-777-b16": (RANK4, 3, (777,), False, 16),
    "rank4-777-b24": (RANK4, 3, (777,), False, 24),
    "rank4-shared-axes-b16": (RANK4, 3, (3, 5), True, 16),
}


def _codes(q):
    return q.view(torch.uint8) if q.dtype == torch.float8_e4m3fn else q


@pytest.mark.parametrize("dtype", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("label", sorted(QUANT_CASES))
def test_quant_kernel_matches_plain_and_the_f32_kernel(cuda, label, dtype):
    """The quantized kernel, which quantizes the f32 cores in its launch,
    against ``tt_contract_batched_quant_ref``, and bit for bit against
    ``tt_contract_batched`` on the fake-quantized cores; an all-zero block
    and padded last runs included."""
    spec, P, x_shape, shared, block = QUANT_CASES[label]
    quant = quant_lib.QuantConfig(enabled=True, dtype=dtype, block=block)
    cores, x = _stacked_inputs(spec, P, x_shape, shared, len(label), cuda)
    cores[1][0].view(-1)[:block].zero_()
    before = ttc.tt_contract_batched_quant.launches
    y = ops.tt_linear_batched(x, cores, spec, quant=quant, shared_x=shared)
    assert ttc.tt_contract_batched_quant.launches == before + 1
    assert tuple(y.shape) == (P, *x_shape, spec.out_dim)
    _assert_kernel_close(y, ref.tt_contract_batched_quant_ref(
        x, cores, spec, quant, shared_x=shared))
    fq = [quant_lib.fake_quant_stacked(c, quant) for c in cores]
    assert torch.equal(y, ttc.tt_contract_batched(x, fq, spec,
                                                  shared_x=shared))


def _near_rounding_edges(absmax: float, qmax: float) -> torch.Tensor:
    """Values x of a run with this absmax whose ``x / scale`` and
    ``x * (1 / scale)`` give different codes (int8 for qmax 127, e4m3 for
    448): they tell an IEEE division from a multiply by the reciprocal."""
    grid = (torch.arange(128.0) if qmax == 127.0 else torch.arange(
        127, dtype=torch.uint8).view(torch.float8_e4m3fn).float())
    scale = torch.tensor(absmax) / torch.tensor(qmax)
    x = (grid[1:] + grid[:-1]) / 2 * scale
    x = torch.cat([x, torch.nextafter(x, torch.zeros(())),
                   torch.nextafter(x, torch.full((), 2 * absmax))])

    def code(v):
        return (torch.round(v) if qmax == 127.0
                else v.to(torch.float8_e4m3fn).float())

    return x[(x.abs() < absmax)
             & (code(x / scale) != code(x * torch.reciprocal(scale)))]


def _hard_cores(P: int, n: int, block: int) -> torch.Tensor:
    """(P, n) values for the quantizer: magnitudes over 2^±29, a run of
    zeros, rows whose runs have absmax 127 or 448 (scale 1) and values on
    the int8 and the e4m3 rounding ties, e4m3 subnormals among them, rows
    of values a reciprocal would round to other codes, and rows of one
    sign."""
    gen = torch.Generator().manual_seed(block)
    c = torch.randn((P, n), generator=gen) * torch.exp(
        torch.empty((P, n)).uniform_(-20, 20, generator=gen))
    c[0, :block] = 0.0
    c[1] = torch.tensor([127.0, 0.5, 1.5, 2.5, -3.5, 126.5, -0.5,
                         64.5]).repeat(n // 8)
    c[2] = torch.tensor([448.0, 1.0625, 17.0, 3 * 2.0**-10, 2.0**-10,
                         -5 * 2.0**-10, 208.0, -232.0]).repeat(n // 8)
    c[3] = c[3].abs()
    c[4] = -c[4].abs()
    for row, (absmax, qmax) in ((5, (100.0, 127.0)), (6, (12345.0, 448.0))):
        edges = _near_rounding_edges(absmax, qmax)
        assert len(edges) > 0
        c[row] = edges.repeat(-(-n // len(edges)))[:n]
        c[row, ::7] = absmax           # in every run of 7 or more
    return c


@pytest.mark.parametrize("dtype", ["int8", "fp8_e4m3"])
def test_kernel_quantizes_cores_to_fake_quant_bits(cuda, dtype):
    """The kernel's quantized cores, read back through an identity input
    (one core, 32 × 8: y[p] = W_pᵀ, each element one fmaf by 1.0), equal
    ``fake_quant_stacked``'s on the card and on the CPU, bit for bit, at
    blocks that divide the core and blocks that pad it."""
    spec = tt.TTSpec((32,), (8,), (1, 1))
    eye = torch.eye(8, device=cuda)
    for block in (32, 24, 7, 1):
        quant = quant_lib.QuantConfig(enabled=True, dtype=dtype, block=block)
        c = _hard_cores(64, 256, block)
        cores = [c.reshape(64, 1, 32, 8, 1).to(cuda)]
        y = ttc.tt_contract_batched_quant(eye, cores, spec, quant)
        got = y.transpose(1, 2).reshape(64, 256)
        want = quant_lib.fake_quant_stacked(cores[0], quant).reshape(64, 256)
        assert torch.equal(got, want), (block, int((got != want).sum()))
        assert torch.equal(got.cpu(), quant_lib.fake_quant_stacked(c, quant))


@pytest.mark.parametrize("dtype", ["int8", "fp8_e4m3"])
def test_codes_made_on_the_card_equal_the_cpus(cuda, dtype):
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((11, 3, 7, 5), generator=gen) * torch.exp(
        torch.empty((11, 3, 7, 5)).uniform_(-8, 8, generator=gen))
    x[4] = 0.0
    for block in (7, 16, 32):
        quant = quant_lib.QuantConfig(enabled=True, dtype=dtype, block=block)
        q_d, s_d = quant_lib.quantize_blockwise_stacked(x.to(cuda), quant)
        q_c, s_c = quant_lib.quantize_blockwise_stacked(x, quant)
        assert torch.equal(_codes(q_d).cpu(), _codes(q_c))
        assert torch.equal(s_d.cpu(), s_c)
        assert torch.equal(quant_lib.fake_quant_stacked(x.to(cuda),
                                                        quant).cpu(),
                           quant_lib.fake_quant_stacked(x, quant))
    for bits in (6, 8):
        assert torch.equal(quant_lib.quantize_phases(x.to(cuda), bits).cpu(),
                           quant_lib.quantize_phases(x, bits))


def test_quant_wrapper_refuses_what_the_kernel_cannot_take(cuda):
    spec, P, x_shape, shared, _ = QUANT_CASES["rank4-777-b32"]
    cores, x = _stacked_inputs(spec, P, (9,), False, 2, cuda)
    quant = quant_lib.QuantConfig(enabled=True)
    with pytest.raises(ValueError, match="not enabled"):
        ttc.tt_contract_batched_quant(x, cores, spec,
                                      quant_lib.QuantConfig())
    with pytest.raises(ValueError, match="contiguous"):
        ttc.tt_contract_batched_quant(x.transpose(0, 1), cores, spec, quant)
    with pytest.raises(ValueError, match="core 0"):
        ttc.tt_contract_batched_quant(x, [cores[0].cpu(), *cores[1:]], spec,
                                      quant)
    assert ttc.tt_contract_batched_quant(x[:, :0], cores, spec,
                                         quant).shape == (P, 0, spec.out_dim)
    wide = tt.auto_factorize(96, 128, L=2, max_rank=8)
    cores, x = _stacked_inputs(wide, 2, (9,), True, 2, cuda)
    with pytest.raises(ValueError, match="at most 32"):
        ttc.tt_contract_batched_quant(x, cores, wide, quant)


@pytest.mark.parametrize("hidden,tt_L", [(64, 3), (1024, 4)])
def test_qat_zo_step_on_the_card_matches_the_cpu(cuda, hidden, tt_L):
    """One QAT ZO step (int8 block 32, 8-bit phases): the densified cores
    on the card against the CPU's, then the stacked stencil u-values and
    (P,) losses on the card against the CPU's plain path on the card's
    densified cores (a weight code that the two devices' last-ulp
    differences put across a rounding edge would move a core value by a
    whole quantization step).  The two stencil passes on the densified
    cores launch 3 quantized chains each and no f32 chain; the
    densification is one grouped launch, with no standalone mesh."""
    cfg = pinn.PINNConfig(hidden=hidden, mode="tonn", tt_L=tt_L,
                          deriv="fd_fast", use_fused_kernel=True,
                          noise=NoiseModel(enabled=True),
                          quant=quant_lib.QuantConfig(enabled=True,
                                                      phase_bits=8))
    model = pinn.TensorPinn(cfg)
    params = model.init(counter_generator(0))
    noise = model.sample_noise(counter_generator(0, 99))
    xt = model.problem.sample_collocation(counter_generator(1), 96)
    xis = zoo.sample_perturbations(counter_generator(2), params, 3,
                                   model.trainable_mask(params))
    stacked = zoo.perturbed_stack(params, xis, zoo.SPSAConfig(num_samples=3))
    counters = (ttc.tt_contract_batched_quant, ttc.tt_contract_batched,
                mesh.mesh_densify_stacked, mesh.mesh_apply_stacked)
    before = [fn.launches for fn in counters]
    prep_card = model.prepare_params_stacked(to_device(stacked, cuda),
                                             to_device(noise, cuda))
    u_card = model.fd_u_stencil_stacked(prep_card, xt.to(cuda),
                                        model.fd_step).cpu()
    l_card = pinn.residual_losses_stacked(model, prep_card, xt.to(cuda)).cpu()
    torch.cuda.synchronize()
    assert [fn.launches - b for fn, b in zip(counters, before)] == \
        [2 * 3, 0, 1, 0]
    prep_cpu = model.prepare_params_stacked(stacked, noise)
    for i in range(2):
        for a, b in zip(prep_card[f"cores{i}"], prep_cpu[f"cores{i}"]):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-6)
    shared = to_device(prep_card, torch.device("cpu"))
    u_cpu = model.fd_u_stencil_stacked(shared, xt, model.fd_step)
    l_cpu = pinn.residual_losses_stacked(model, shared, xt)
    assert torch.isfinite(u_card).all() and torch.isfinite(l_card).all()
    assert (u_card - u_cpu).abs().max() <= 1e-4 * u_cpu.abs().max()
    np.testing.assert_allclose(l_card.numpy(), l_cpu.numpy(), rtol=1e-1)


def test_quantized_serving_on_the_card(cuda):
    """int8 and fp8 requests beside f32 ones: each served value equals a
    direct forward of its config, one program per (solver, config), two
    ``tt_contract`` launches per program run."""
    reg = SolverRegistry(device=cuda)
    reg.register_fresh("hjb", pinn.PINNConfig(
        hidden=1024, mode="tonn", tt_rank=2, tt_L=4, pde="hjb-20d",
        use_fused_kernel=True, noise=NoiseModel(enabled=True)),
        seed=0, device=cuda)
    eng = PdeServingEngine(reg, slots=4, slot_points=256, device=cuda)
    quants = [None, quant_lib.QuantConfig(enabled=True),
              quant_lib.QuantConfig(enabled=True, dtype="fp8_e4m3")]
    rng = np.random.RandomState(1)
    before = ttc.tt_contract.launches
    traffic = [(quants[i % 3], rng.uniform(0.02, 0.98, (n, 21)).astype(
        np.float32)) for i, n in enumerate([5, 300, 77, 1100, 256, 31])]
    reqs = [eng.submit(PointRequest("hjb", pts, quant=q))
            for q, pts in traffic]
    eng.run()
    torch.cuda.synchronize()
    assert ttc.tt_contract.launches - before == 2 * eng.stats["program_runs"]
    assert eng.stats["compiles"] == 3
    s = reg.get("hjb")
    for (q, pts), r in zip(traffic, reqs):
        model = s.model if q is None else pinn.TensorPinn(
            dataclasses.replace(s.model.cfg, quant=q), problem=s.problem)
        with torch.no_grad():
            direct = model.u(s.params, torch.tensor(pts, device=cuda))
        np.testing.assert_allclose(r.out, direct.cpu().numpy(), rtol=1e-6,
                                   atol=1e-6)


# label -> (B, H, KH, Sq, Sk, D, causal, window): chunked prefill, one
# query, causal rows that see no key, the reduced qwen shape (D 24), a
# window off the 64-wide tiles, and lengths off the tiles at D 64, 120, 128
FLASH_CASES = {
    "chunked-prefill": (2, 16, 2, 256, 2304, 128, True, None),
    "single-query": (4, 16, 2, 1, 300, 128, True, None),
    "masked-rows": (1, 4, 2, 64, 32, 32, True, None),
    "reduced-qwen": (2, 4, 2, 200, 200, 24, True, None),
    "window-120": (1, 8, 2, 333, 333, 120, True, 70),
    "d64-ragged-chunk": (2, 8, 2, 190, 250, 64, True, None),
    "d120-bidirectional": (1, 4, 4, 129, 200, 120, False, None),
    "d128-ragged": (1, 8, 2, 300, 300, 128, True, None),
}


def _attention_inputs(case, dtype, seed, device):
    B, H, KH, Sq, Sk, D = case[:6]
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen).to(device=device, dtype=dtype)
            for shape in ((B, H, Sq, D), (B, KH, Sk, D), (B, KH, Sk, D))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("label", sorted(FLASH_CASES))
def test_flash_kernel_matches_plain(cuda, label, dtype):
    case = FLASH_CASES[label]
    causal, window = case[6:]
    q, k, v = _attention_inputs(case, getattr(torch, dtype), len(label),
                                cuda)
    out = fa.flash_attention(q, k, v, causal, window)
    plain = ref.attention_ref(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert out.dtype == q.dtype and torch.isfinite(out).all()
    diff = (out.float() - plain.float()).abs()
    assert (diff <= ref.attention_bound(plain)).all(), diff.max().item()
    Sq, Sk = case[3], case[4]
    if Sq > Sk:
        assert torch.equal(out[:, :, :Sq - Sk],
                           torch.zeros_like(out[:, :, :Sq - Sk]))


def test_flash_dispatch_counts_and_takes_strided_views(cuda):
    q, k, v = _attention_inputs(FLASH_CASES["reduced-qwen"], torch.float32,
                                1, cuda)
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)
    before = fa.flash_attention.launches
    out = ops.attention(qt, k, v)
    assert fa.flash_attention.launches == before + 1
    assert torch.equal(out, fa.flash_attention(q, k, v))


def test_flash_designs_count_their_launches(cuda):
    """bf16 goes to the wgmma design and f32 to the simple one; each
    launch counts once in the total and once for its design."""
    case = FLASH_CASES["d128-ragged"]
    before = dict(fa.flash_attention.design_launches)
    total = fa.flash_attention.launches
    for dtype in (torch.bfloat16, torch.float32, torch.bfloat16):
        ops.attention(*_attention_inputs(case, dtype, 5, cuda))
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == total + 3
    assert fa.flash_attention.design_launches == {
        "wgmma": before["wgmma"] + 2, "simple": before["simple"] + 1}


def test_flash_bf16_reads_strided_views_in_place(cuda):
    """``attention_fwd``'s transposed q, k, v ((B, S, H, D) memory): the
    bf16 design reads them through their own tensor maps, bit-equal to the
    contiguous call, and allocates nothing but the output (H == KH, so a
    copy of any input would be another allocation of the output's size)."""
    B, S, H, D = 2, 300, 8, 128
    gen = torch.Generator().manual_seed(6)
    views = [torch.randn((B, S, H, D), generator=gen).to(
        device=cuda, dtype=torch.bfloat16).transpose(1, 2) for _ in range(3)]
    assert not any(t.is_contiguous() for t in views)
    want = fa.flash_attention(*(t.contiguous() for t in views))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    base = torch.cuda.memory_allocated(cuda)
    got = fa.flash_attention(*views)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated(cuda) - base
    assert torch.equal(got, want)
    assert grown < 2 * got.numel() * got.element_size(), grown


def test_flash_wrapper_refuses_what_the_kernel_cannot_take(cuda):
    q, k, v = _attention_inputs((1, 4, 2, 8, 8, 136), torch.float32, 2, cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, k, v)
    q, k, v = _attention_inputs((1, 4, 2, 8, 8, 16), torch.float16, 3, cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention(q, k, v)
    q, k, v = _attention_inputs((1, 4, 3, 8, 8, 16), torch.float32, 4, cuda)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="need"):
        fa.flash_attention(q, k.cpu(), v)
    q, k, v = _attention_inputs((1, 4, 2, 8, 8, 20), torch.bfloat16, 5, cuda)
    with pytest.raises(ValueError, match="16 bytes"):
        fa.flash_attention(q, k, v)


def test_reduced_lm_on_the_card_matches_the_cpu(cuda):
    """A 2-layer reduced qwen (f32) from one params tree: prefill (one
    kernel launch per layer) and a decode step on the card against the
    plain path on the CPU."""
    cfg = configs.get_reduced("qwen2.5-3b")
    params = transformer.init_params(cfg, counter_generator(0), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 65),
                           generator=torch.Generator().manual_seed(5))
    card = to_device(params, cuda)
    before = fa.flash_attention.launches
    logits, cache = transformer.prefill(card, cfg, tokens[:, :64].to(cuda),
                                        max_len=65)
    assert fa.flash_attention.launches - before == cfg.num_layers
    dec, cache = transformer.decode_step(card, cfg, cache,
                                         tokens[:, 64:].to(cuda))
    assert fa.flash_attention.launches - before == cfg.num_layers
    c_logits, c_cache = transformer.prefill(params, cfg, tokens[:, :64],
                                            max_len=65)
    c_dec, c_cache = transformer.decode_step(params, cfg, c_cache,
                                             tokens[:, 64:])
    for got, want in ((logits, c_logits), (dec, c_dec),
                      (cache["k_0"], c_cache["k_0"]),
                      (cache["v_0"], c_cache["v_0"])):
        err = (got.cpu() - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item(), err


# label -> (spec, rows, need_dx): the three BP launches of the paper's
# config at batch 100 (layer 0 on the rows and on the 21 identity columns,
# the hidden layer on the stencil's 4300 rows), the reduced spec off the
# tile, the rank-4 non-square spec, a 4096-wide spec
GRAD_CASES = {
    "layer0-rows": (tt.PAPER_TONN_SPEC, 100, False),
    "layer0-columns": (tt.PAPER_TONN_SPEC, 21, False),
    "hidden-stencil": (tt.PAPER_TONN_SPEC, 4300, True),
    "reduced-1000": (tt.auto_factorize(64, 64, L=3, max_rank=2), 1000, True),
    "rank4-777": (RANK4, 777, True),
    # rows of 8192 floats, steps not in place: 2 of the 4 states saved
    "wide-777": (tt.auto_factorize(4096, 4096, L=4, max_rank=2), 777, True),
}


def _grad_inputs(label, device):
    spec, batch, need_dx = GRAD_CASES[label]
    cores, x = _chain_inputs(spec, batch, seed=3000 + len(label),
                             device=device)
    gen = torch.Generator().manual_seed(len(label))
    dy = torch.randn((batch, spec.out_dim), generator=gen).to(device)
    return spec, cores, x, dy, need_dx


@pytest.mark.parametrize("label", sorted(GRAD_CASES))
def test_grad_kernel_matches_plain(cuda, label):
    spec, cores, x, dy, need_dx = _grad_inputs(label, cuda)
    before = ttc.tt_contract_grad.launches
    dx, grads = ttc.tt_contract_grad(x, cores, spec, dy, need_dx)
    assert ttc.tt_contract_grad.launches == before + 1
    pdx, _ = ref.tt_contract_grad_ref(x, cores, spec, dy, need_dx)
    _, exact = ref.tt_contract_grad_ref(
        x.double(), [c.double() for c in cores], spec, dy.double(), False)
    torch.cuda.synchronize()
    if need_dx:
        _assert_kernel_close(dx, pdx)
    else:
        assert dx is None and pdx is None
    for g, e, b, shape in zip(grads, exact,
                              ttc.grad_bound(x, cores, spec, dy),
                              spec.core_shapes):
        assert tuple(g.shape) == shape and torch.isfinite(g).all()
        assert ((g.double() - e).abs() <= b).all()


@pytest.mark.parametrize("label", ["hidden-stencil", "layer0-columns"])
def test_grad_kernel_repeats_bit_for_bit(cuda, label):
    """No float atomics: two calls give the same bits."""
    spec, cores, x, dy, need_dx = _grad_inputs(label, cuda)
    a = ttc.tt_contract_grad(x, cores, spec, dy, need_dx)
    b = ttc.tt_contract_grad(x, cores, spec, dy, need_dx)
    assert all(torch.equal(p, q) for p, q in zip(a[1], b[1]))
    assert (a[0] is None) == (b[0] is None)
    if need_dx:
        assert torch.equal(a[0], b[0])


def test_tt_linear_under_autograd_runs_the_backward_kernel(cuda):
    """On the card ``ops.tt_linear`` differentiates through the kernels:
    the output has a grad_fn, the cores get nonzero gradients from
    ``tt_contract_grad``, and ``tt_contract`` called directly carries the
    same backward."""
    spec, cores, x, dy, _ = _grad_inputs("reduced-1000", cuda)
    cores = [c.requires_grad_() for c in cores]
    before = (ttc.tt_contract.launches, ttc.tt_contract_grad.launches)
    y = ops.tt_linear(x, cores, spec)
    assert y.grad_fn is not None
    y.backward(dy)
    assert (ttc.tt_contract.launches - before[0],
            ttc.tt_contract_grad.launches - before[1]) == (1, 1)
    _, want = ref.tt_contract_grad_ref(x, [c.detach() for c in cores], spec,
                                       dy, need_dx=False)
    for c, w in zip(cores, want):
        assert c.grad.abs().max() > 0
        _assert_kernel_close(c.grad, w)
    direct = ttc.tt_contract(x, cores, spec)
    assert direct.grad_fn is not None and torch.equal(direct, y)


@pytest.mark.parametrize("mode,hidden", [("tt", 1024), ("tonn", 1024),
                                         ("dense", 1024), ("onn", 64)])
def test_bp_step_on_the_card_matches_the_cpu(cuda, mode, hidden):
    """One BP step of the trainer's config (fd_fast): 3 forward and 3
    backward TT launches (none in dense and onn), tonn's one grouped
    densification and one grouped backward, onn's (hidden 64) 6 resident
    meshes and 6 resident backwards, nonzero core gradients, and the
    gradients of a u-level functional card (through the kernels'
    backwards) vs CPU; the step never reaches ``prepare_params_plain``."""
    from repro_torch.launch import train
    from repro_torch.optim import get_optimizer
    cfg = pinn.PINNConfig(hidden=hidden, mode=mode, tt_L=4, deriv="fd_fast",
                          use_fused_kernel=True,
                          noise=NoiseModel(enabled=mode in ("tonn", "onn")))
    model = pinn.TensorPinn(cfg)
    params = model.init(counter_generator(0))
    noise = model.sample_noise(counter_generator(0, 99))
    xt = model.problem.sample_collocation(counter_generator(1), 100)
    w = torch.randn(100, generator=torch.Generator().manual_seed(2))
    opt = get_optimizer("adamw")

    def grads(device, fn):
        p = zoo.tree_map(lambda t, m: t.to(device).requires_grad_(m),
                         params, model.trainable_mask(params))
        nz = None if noise is None else to_device(noise, device)
        # tonn: the densification BP differentiates, as the BP step's
        prepared, nz = model.prepare_params(p, nz)
        out = fn(prepared, xt.to(device), nz)
        return [g.cpu() for g in torch.autograd.grad(
            out, [t for t in zoo.tree_leaves(p) if t.requires_grad])]

    counters = (ttc.tt_contract, ttc.tt_contract_grad,
                mesh.mesh_densify_stacked, mesh.mesh_densify_grad,
                mesh.mesh_apply_stacked, mesh.mesh_apply_stacked_grad)
    before = [fn.launches for fn in counters]
    step = train._bp_step_fn(model, opt, model.trainable_mask(params),
                             None if noise is None
                             else to_device(noise, cuda))
    p_card = to_device(params, cuda)
    plain = model.prepare_params_plain
    model.prepare_params_plain = None          # the step must not reach it
    try:
        new, _, loss = step(p_card, opt.init(p_card), xt.to(cuda), {})
    finally:
        model.prepare_params_plain = plain
    torch.cuda.synchronize()
    chains = 3 if mode in ("tt", "tonn") else 0
    grouped = 1 if mode == "tonn" else 0
    meshes = 6 if mode == "onn" else 0
    assert [fn.launches - b for fn, b in zip(counters, before)] == \
        [chains, chains, grouped, grouped, meshes, meshes]
    assert torch.isfinite(loss)

    def u_fn(p, x, nz):
        return torch.sum(model.u(p, x, nz) * w.to(x.device))

    card, cpu = grads(cuda, u_fn), grads(torch.device("cpu"), u_fn)
    for a, b in zip(card, cpu):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max() <= 1e-4 * b.abs().max() + 1e-12
    assert all(g.abs().max() > 0 for g in card)     # the cores' included


def test_sequential_zo_step_launches_one_chain_per_layer(cuda):
    """``--sequential``: each of the N+1 loss evaluations densifies the
    core meshes in one grouped launch and runs the plain FD stencil
    through two ``tt_contract`` launches; no batched chain and no
    standalone mesh."""
    cfg = pinn.PINNConfig(hidden=64, mode="tonn", tt_L=3, deriv="fd",
                          noise=NoiseModel(enabled=True))
    model = pinn.TensorPinn(cfg)
    params = to_device(model.init(counter_generator(0)), cuda)
    noise = to_device(model.sample_noise(counter_generator(0, 99)), cuda)
    xt = model.problem.sample_collocation(counter_generator(1), 16).to(cuda)
    counters = (ttc.tt_contract, ttc.tt_contract_batched,
                mesh.mesh_densify_stacked, mesh.mesh_apply_stacked)
    before = [fn.launches for fn in counters]
    _, _, loss = zoo.zo_signsgd_step(
        params, zoo.ZOState(0, 1), 1e-3, zoo.SPSAConfig(num_samples=3),
        trainable_mask=model.trainable_mask(params),
        loss_fn=lambda p: pinn.residual_loss(model, p, xt, noise))
    torch.cuda.synchronize()
    assert [fn.launches - b for fn, b in zip(counters, before)] == \
        [2 * 4, 0, 4, 0]
    assert torch.isfinite(loss)


# ------------------------------------------------------- the mesh backwards

MESH_GRAD_BOUND = chip_smoke.MESH_GRAD_BOUND     # of max|plain|, per output


def _grad_close(got, plain):
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got - plain).abs().max() <= \
        MESH_GRAD_BOUND * plain.abs().max() + 1e-12


@pytest.mark.parametrize("noisy", [False, True])
@pytest.mark.parametrize("tt_L,S", [(4, 1), (4, 11), (2, 3)])
def test_densify_grad_kernel_matches_plain(cuda, tt_L, S, noisy):
    """The grouped backward on the paper's 8 core matrices (the warp
    design, every state kept) and on tt_L 2's 32 x 64 and 64 x 32 ones
    (the block design, their states recovered) against
    ``ref.mesh_densify_grad_ref`` making the same choice: one launch a
    call through the design ``densify_grad_design`` picks, and two calls
    bit for bit.  The paper's matrices through the block design forced
    too."""
    pms, ps, nzs, model, _ = chip_smoke.densify_inputs(1024, tt_L, S, noisy,
                                                       None, cuda, 40 + S)
    gen = torch.Generator().manual_seed(S)
    dW = [torch.randn((S, pm.out_dim, pm.in_dim), generator=gen).to(cuda)
          for pm in pms]
    design = mesh.densify_grad_design(pms)
    assert design == ("warp" if tt_L == 4 else "block")
    forced = [None] + (["block"] if design == "warp" else [])
    for force in forced:
        used = force or design
        before = mesh.mesh_densify_grad.launches
        by_design = dict(mesh.mesh_densify_grad.design_launches)
        got = mesh.mesh_densify_grad(pms, ps, nzs, model, dW, design=force)
        assert mesh.mesh_densify_grad.launches == before + 1
        by_design[used] += 1
        assert mesh.mesh_densify_grad.design_launches == by_design
        want = ref.mesh_densify_grad_ref(
            pms, ps, nzs, model, dW, True if used == "warp" else
            [mesh.densify_grad_saves(pm) for pm in pms])
        for trio, wtrio in zip(got, want):
            for a, b in zip(trio, wtrio):
                assert a.shape == b.shape
                _grad_close(a, b)
        again = mesh.mesh_densify_grad(pms, ps, nzs, model, dW,
                                       design=force)
        assert all(torch.equal(a, b) for t, u in zip(got, again)
                   for a, b in zip(t, u))
    if design == "block":
        with pytest.raises(ValueError, match="no 'warp' design"):
            mesh.mesh_densify_grad(pms, ps, nzs, model, dW, design="warp")


# label -> (ports, S, rows, shared x, transpose): the resident backward at
# onn's BP launches (hidden 64: 4300 stencil rows; layer 0's 21-port V mesh
# on the 100 rows) and the paper's 16-port meshes, and an 80-port mesh the
# dispatch sends to the block design; the warp-rows backward
# at 1024 ports on rows whose forward takes route A (300, 21 shared) and
# route B (1600), at 160 ports (W = 8) and S = 3, and at 144 ports on one
# block column
MESH_GRAD_CASES = {
    "p16-4300": (16, 1, 4300, False, False),
    "p16-4300-tr": (16, 1, 4300, False, True),
    "p64-4300": (64, 1, 4300, False, False),
    "p64-4300-tr": (64, 1, 4300, False, True),
    "p80-4300": (80, 1, 4300, False, False),
    "v21-100-tr": (21, 1, 100, True, True),
    "v21-100": (21, 1, 100, True, False),
    "p16-s11": (16, 11, 37, False, True),
    "p1024-300": (1024, 1, 300, False, False),
    "p1024-21-shared-tr": (1024, 1, 21, True, True),
    "p1024-1600-tr": (1024, 1, 1600, False, True),
    "p160-777-s3": (160, 3, 777, False, False),
    "p144-3-shared": (144, 2, 3, True, False),
}


@pytest.mark.parametrize("label", sorted(MESH_GRAD_CASES))
def test_mesh_grad_kernel_matches_plain(cuda, label):
    """The mesh backward of the layout's design (resident up to 138 ports,
    warp rows past them) against ``ref.mesh_apply_grad_ref``: dx and
    dphases, one launch of that design; two calls bit for bit."""
    ports, S, B, shared, transpose = MESH_GRAD_CASES[label]
    layout, phases, diag, x = _mesh_inputs(ports, S, B, shared, len(label),
                                           cuda)
    y = mesh.mesh_apply_stacked(layout, phases, diag, x, transpose)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(
        ports)).to(cuda)
    design = mesh.grad_design(layout)
    assert design == ("resident" if ports <= 138 else "warp_rows")
    resident = (mesh.resident_grad_design(layout) if design == "resident"
                else None)
    if resident is not None:    # the warp design up to 64 ports
        assert resident == ("warp" if ports <= 64 else "block")
    pdx, pdph = ref.mesh_apply_grad_ref(layout, phases, diag, x, y, dy,
                                        transpose)
    grad = mesh.mesh_apply_stacked_grad
    # the design the layout picks and, for a resident layout, the block
    # design forced
    for force in ((None, "block") if resident == "warp" else (None,)):
        res = force or resident
        with (mesh._forced_resident(force) if force
              else contextlib.nullcontext()):
            before = (grad.launches, grad.design_launches[design],
                      grad.resident_launches.get(res))
            dx, dph = grad(layout, phases, diag, y, dy, transpose)
            assert (grad.launches, grad.design_launches[design],
                    grad.resident_launches.get(res)) == (
                before[0] + 1, before[1] + 1,
                None if res is None else before[2] + 1)
            _grad_close(dx.sum(0) if shared else dx, pdx)
            _grad_close(dph, pdph)
            dx2, dph2 = grad(layout, phases, diag, y, dy, transpose)
            assert torch.equal(dx, dx2) and torch.equal(dph, dph2)
            only, none = grad(layout, phases, diag, y, dy, transpose,
                              need_dphases=False)
            assert none is None and torch.equal(only, dx)
            if resident is not None:
                # dx is the plain version's bits; dphases alone its own
                assert torch.equal(dx.sum(0) if shared else dx, pdx)
                none, only = grad(layout, phases, diag, y, dy, transpose,
                                  need_dx=False)
                assert none is None and torch.equal(only, dph)
    if resident is not None and resident != "warp":
        with pytest.raises(ValueError, match="no 'warp' design"), \
                mesh._forced_resident("warp"):
            grad(layout, phases, diag, y, dy, transpose)


def test_resident_warp_design_refuses_what_it_does_not_take(cuda):
    """Forced onto a layout it does not take (a 33-port mesh whose pairs
    are not adjacent, a 65-port rectangular one), the warp design raises
    before any launch; so does any resident design forced onto a layout
    the resident backward does not hold."""
    grad = mesh.mesh_apply_stacked_grad
    wide = photonic.rectangular_layout(65)
    odd = photonic.schedule_ops(33, [(a, (a + 5) % 33) for a in range(0, 33,
                                                                      2)])
    for layout in (wide, odd):
        assert mesh.resident_grad_design(layout) == "block"
        S, B = 1, 9
        phases = torch.zeros((S, *layout.phase_shape()), device=cuda)
        diag = torch.ones(layout.ports, device=cuda)
        y = torch.randn((S, B, layout.ports), device=cuda)
        before = grad.launches
        with pytest.raises(ValueError, match="no 'warp' design"), \
                mesh._forced_resident("warp"):
            grad(layout, phases, diag, y, y)
        assert grad.launches == before
    lay = photonic.rectangular_layout(160)
    y = torch.randn((1, 3, 160), device=cuda)
    with pytest.raises(ValueError, match="not the resident one"), \
            mesh._forced_resident("block"):
        grad(lay, torch.zeros((1, *lay.phase_shape()), device=cuda),
             torch.ones(160, device=cuda), y, y)


@pytest.mark.parametrize("B,transpose", [(300, False), (1600, True)])
def test_wide_mesh_autograd_on_the_card_matches_plain_autograd(cuda, B,
                                                               transpose):
    """``ops.mesh_apply_stacked`` under autograd at onn's 1024 ports (the
    forward through route A at 300 rows and the warp-rows backward; route
    B at 1600 and the dense backward: the backward follows the forward's
    route) against autograd of the plain version on the same card."""
    layout, phases, diag, x = _mesh_inputs(1024, 1, B, False, B, cuda)
    p1, x1 = phases.clone().requires_grad_(), x.clone().requires_grad_()
    before = dict(mesh.mesh_apply_stacked_grad.design_launches)
    y = ops.mesh_apply_stacked(layout, p1, diag, x1, transpose)
    w = torch.randn(y.shape, generator=torch.Generator().manual_seed(1)).to(
        cuda)
    got = torch.autograd.grad((y * w).sum(), (p1, x1))
    design = "warp_rows" if B == 300 else "dense"
    assert mesh.grad_design(layout, 1, B) == design
    assert {k: v - before[k] for k, v in
            mesh.mesh_apply_stacked_grad.design_launches.items()} == {
        d: int(d == design) for d in mesh.GRAD_DESIGNS}
    p2, x2 = phases.clone().requires_grad_(), x.clone().requires_grad_()
    want = torch.autograd.grad((photonic.mesh_apply_stacked(
        layout, p2, diag, x2, transpose) * w).sum(), (p2, x2))
    for a, b in zip(got, want):
        _grad_close(a, b)


# label -> (ports, S, rows, shared x, transpose): the dense backward at the
# hidden layer's meshes of an onn BP step at hidden 1024 (1024 ports on
# 4300 stencil rows, the V^T mesh transposed), on a shared x at S = 2, and
# 160 ports at S = 3
MESH_DENSE_GRAD_CASES = {
    "p1024-4300": (1024, 1, 4300, False, False),
    "p1024-4300-tr": (1024, 1, 4300, False, True),
    "p1024-4300-shared": (1024, 2, 4300, True, False),
    "p160-777-s3": (160, 3, 777, False, False),
}


@pytest.mark.parametrize("label", sorted(MESH_DENSE_GRAD_CASES))
def test_dense_grad_kernel_matches_plain(cuda, label):
    """The dense backward (x and M from route B's forward) against
    ``ref.mesh_apply_dense_grad_ref`` on the same M and against the rows'
    ``ref.mesh_apply_grad_ref``, within ``MESH_GRAD_BOUND``·max|plain|:
    one launch of design ``dense`` and one ``mesh_product_grad`` (both
    products) a call, two calls bit for bit, dx alone equal to the full
    call's."""
    ports, S, B, shared, transpose = MESH_DENSE_GRAD_CASES[label]
    layout, phases, diag, x = _mesh_inputs(ports, S, B, shared, len(label),
                                           cuda)
    assert mesh.grad_design(layout, S, B) == "dense"
    y, dense = mesh.launch_dense_keep(layout, phases, diag, x, transpose)
    assert torch.equal(y, mesh.launch_dense(layout, phases, diag, x,
                                            transpose))
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(
        ports)).to(cuda)
    grad = mesh.mesh_apply_stacked_grad
    before = (grad.launches, grad.design_launches["dense"],
              mesh.mesh_product_grad.launches)
    dx, dph = grad(layout, phases, diag, None, dy, transpose, x=x,
                   dense=dense)
    assert (grad.launches, grad.design_launches["dense"],
            mesh.mesh_product_grad.launches) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    dxs = dx.sum(0) if shared else dx
    pdx, pdph = ref.mesh_apply_dense_grad_ref(layout, phases, diag, x,
                                              dense, dy, transpose)
    _grad_close(dxs, pdx)
    _grad_close(dph, pdph)
    rdx, rdph = ref.mesh_apply_grad_ref(layout, phases, diag, x, y, dy,
                                        transpose)
    _grad_close(dxs, rdx)
    _grad_close(dph, rdph)
    dx2, dph2 = grad(layout, phases, diag, None, dy, transpose, x=x,
                     dense=dense)
    assert torch.equal(dx, dx2) and torch.equal(dph, dph2)
    only, none = grad(layout, phases, diag, None, dy, transpose, True,
                      False, x=x, dense=dense)
    assert none is None and torch.equal(only, dx)


def test_dense_backward_autograd_on_a_shared_x(cuda):
    """``ops.mesh_apply_stacked`` under autograd at 1024 ports on 1536
    shared rows, S = 2 (route B forward, the dense backward, dx summed
    over the stack) against autograd of the plain version (~38 GB of
    saved levels, handed back after)."""
    layout, phases, diag, x = _mesh_inputs(1024, 2, 1536, True, 11, cuda)
    p1, x1 = phases.clone().requires_grad_(), x.clone().requires_grad_()
    before = mesh.mesh_apply_stacked_grad.design_launches["dense"]
    y = ops.mesh_apply_stacked(layout, p1, diag, x1)
    w = torch.randn(y.shape, generator=torch.Generator().manual_seed(2)).to(
        cuda)
    got = torch.autograd.grad((y * w).sum(), (p1, x1))
    assert mesh.mesh_apply_stacked_grad.design_launches["dense"] == \
        before + 1
    p2, x2 = phases.clone().requires_grad_(), x.clone().requires_grad_()
    want = torch.autograd.grad((photonic.mesh_apply_stacked(
        layout, p2, diag, x2) * w).sum(), (p2, x2))
    torch.cuda.empty_cache()
    for a, b in zip(got, want):
        _grad_close(a, b)


def test_mesh_autograd_on_the_card_matches_plain_autograd(cuda):
    """``ops.mesh_apply_stacked`` and ``ops.mesh_densify_stacked`` under
    autograd on the card (the kernels' Functions) against autograd of the
    plain versions on the same card."""
    layout, phases, diag, x = _mesh_inputs(64, 2, 300, False, 7, cuda)
    p1, x1 = phases.clone().requires_grad_(), x.clone().requires_grad_()
    y = ops.mesh_apply_stacked(layout, p1, diag, x1, True)
    w = torch.randn(y.shape, generator=torch.Generator().manual_seed(1)).to(
        cuda)
    got = torch.autograd.grad((y * w).sum(), (p1, x1))
    p2, x2 = phases.clone().requires_grad_(), x.clone().requires_grad_()
    want = torch.autograd.grad((photonic.mesh_apply_stacked(
        layout, p2, diag, x2, True) * w).sum(), (p2, x2))
    for a, b in zip(got, want):
        _grad_close(a, b)
    pms, ps, nzs, model, _ = chip_smoke.densify_inputs(1024, 4, 1, True,
                                                       None, cuda, 9)
    for p in ps:
        for k in ("phases_u", "phases_v", "sigma"):
            p[k].requires_grad_()
    leaves = [p[k] for p in ps for k in ("phases_u", "phases_v", "sigma")]
    # a random weighting of the cores (Σ W² alone does not move with the
    # phases: the meshes are orthogonal)
    gen = torch.Generator().manual_seed(2)
    r = [torch.randn((1, pm.out_dim, pm.in_dim), generator=gen).to(cuda)
         for pm in pms]
    got = torch.autograd.grad(sum((c * w).sum() for c, w in zip(
        ops.mesh_densify_stacked(pms, ps, nzs, model), r)), leaves)
    want = torch.autograd.grad(sum((c * w).sum() for c, w in zip(
        photonic.mesh_densify_stacked(pms, ps, nzs, model), r)), leaves)
    for a, b in zip(got, want):
        _grad_close(a, b)


@pytest.mark.parametrize("noisy", [False, True])
def test_prepare_params_backward_is_one_grouped_launch(cuda, noisy):
    """tonn's ``prepare_params`` under autograd on the card: one grouped
    forward and one grouped backward launch, its gradients against those
    of ``prepare_params_plain`` on the card; two backwards give the same
    bits."""
    cfg = pinn.PINNConfig(hidden=1024, mode="tonn", tt_L=4,
                          noise=NoiseModel(enabled=noisy))
    model = pinn.TensorPinn(cfg)
    params = to_device(model.init(counter_generator(0)), cuda)
    noise = model.sample_noise(counter_generator(0, 99))
    noise = None if noise is None else to_device(noise, cuda)
    mask = model.trainable_mask(params)
    gen = torch.Generator().manual_seed(3)

    def grads(prepare):
        p = zoo.tree_map(lambda t, m: t.detach().requires_grad_(m), params,
                         mask)
        prepared, _ = prepare(p, noise)
        cores = [c for i in (0, 1) for c in prepared[f"cores{i}"]]
        gen.manual_seed(3)
        out = sum((c * torch.randn(c.shape, generator=gen).to(cuda)).sum()
                  for c in cores)
        # the core meshes' phases and sigmas (the other leaves make no core)
        return torch.autograd.grad(out, [
            t for i in (0, 1) for t in zoo.tree_leaves(p[f"pcores{i}"])
            if t.requires_grad])

    before = (mesh.mesh_densify_stacked.launches,
              mesh.mesh_densify_grad.launches)
    got = grads(model.prepare_params)
    assert (mesh.mesh_densify_stacked.launches - before[0],
            mesh.mesh_densify_grad.launches - before[1]) == (1, 1)
    want = grads(model.prepare_params_plain)
    for a, b in zip(got, want):
        _grad_close(a, b)
    again = grads(model.prepare_params)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("mode", ["tonn", "onn"])
def test_bp_runs_repeat_bit_for_bit(cuda, mode):
    """Two 5-step BP runs of the trainer (tonn at hidden 1024, onn at 64,
    noise on) give the same losses and params, bit for bit: the mesh
    backwards sum in a fixed order."""
    from repro_torch.launch import train
    argv = ["--arch", "tensor-pinn", "--pde", "hjb-20d", "--pinn-mode", mode,
            "--pinn-noise", "--optimizer", "adamw", "--steps", "5",
            "--batch", "100", "--log-every", "10", "--hidden",
            "1024" if mode == "tonn" else "64"]
    a, b = train.main(argv), train.main(argv)
    assert a.losses == b.losses
    assert all(torch.equal(p, q) for p, q in zip(zoo.tree_leaves(a.params),
                                                 zoo.tree_leaves(b.params)))


def _spectral_stack(pde, P=3, hidden=1024, tt_L=4):
    """A tonn model (noise on) of ``pde`` with its own estimator or
    spectral, a perturbation stack of P entries and its chip noise."""
    cfg = pinn.PINNConfig(hidden=hidden, mode="tonn", tt_L=tt_L, pde=pde,
                          deriv="spectral", use_fused_kernel=True,
                          noise=NoiseModel(enabled=True))
    model = pinn.TensorPinn(cfg)
    params = model.init(counter_generator(0))
    noise = model.sample_noise(counter_generator(0, 99))
    xis = zoo.sample_perturbations(counter_generator(2), params, P - 1,
                                   model.trainable_mask(params))
    stacked = zoo.perturbed_stack(params, xis,
                                  zoo.SPSAConfig(num_samples=P - 1))
    return model, stacked, noise


@pytest.mark.parametrize("pde", ["hjb-20d", "ns-2d"])
def test_spectral_stacked_loss_on_the_card_matches_the_cpu(cuda, pde):
    """The stacked spectral loss at the paper's width on the card against
    the CPU's plain path: u over the shared line rows within 1e-4 of
    max|u|, the losses at ``rtol 1e-1`` (the FD floor's: the spectral ∂²
    amplifies u's differences by k_max² ≤ (16π)² < 1/h²); 2
    ``tt_contract_batched`` launches and 1 grouped densification a loss,
    no layer-0 identity-columns launch."""
    model, stacked, noise = _spectral_stack(pde)
    xt = model.problem.sample_collocation(counter_generator(1), 16)

    def losses(device):
        return pinn.residual_losses_stacked(
            model, to_device(stacked, device), xt.to(device),
            to_device(noise, device)).cpu()

    counters = (ttc.tt_contract_batched, mesh.mesh_densify_stacked)
    before = [fn.launches for fn in counters]
    l_card = losses(cuda)
    torch.cuda.synchronize()
    assert [fn.launches - b for fn, b in zip(counters, before)] == [2, 1]
    l_cpu = losses(torch.device("cpu"))
    rows = pinn._spectral_rows(model, xt)
    u = [model.u_stacked(model.prepare_params_stacked(
        to_device(stacked, d), to_device(noise, d)), rows.to(d)).cpu()
        for d in (cuda, torch.device("cpu"))]
    assert torch.isfinite(u[0]).all() and torch.isfinite(l_card).all()
    assert (u[0] - u[1]).abs().max() <= 1e-4 * u[1].abs().max()
    np.testing.assert_allclose(l_card.numpy(), l_cpu.numpy(), rtol=1e-1)


@pytest.mark.parametrize("M,per,axes", [(16, "window", 21),
                                        (17, "periodic", 21),
                                        (16, ("periodic", "periodic",
                                              "window"), 3)])
def test_spectral_derivs_on_the_card_match_the_oracle(cuda, M, per, axes):
    """``spectral_derivs`` on CUDA tensors (cuFFT) held to the float64
    oracle as the CPU's is: within twice the CPU's distance from it, or
    twice the f32 floor ε·max|v|·k_max^p."""
    from repro_torch.core import spectral
    v = 1.7 * torch.randn((11, 100, axes, M), generator=counter_generator(3))
    oracle = spectral.spectral_derivs_ref(v.numpy(), 1.0, per)
    card = spectral.spectral_derivs(v.to(cuda), 1.0, per)
    cpu = spectral.spectral_derivs(v, 1.0, per)
    for p, (c, h, r) in enumerate(zip(card, cpu, oracle), start=1):
        assert c.device == v.to(cuda).device and c.dtype == torch.float32
        floor = (np.finfo(np.float32).eps * float(v.abs().max())
                 * (np.pi * M) ** p)
        bound = 2 * max(float(np.abs(h.numpy() - r).max()), floor)
        assert float(np.abs(c.cpu().numpy() - r).max()) <= bound, p


def test_ns2d_u_stacked_on_the_card_matches_the_cpu(cuda):
    """ns-2d's feature-mapped forward at the paper's width over its line
    rows and its ic rows: card against CPU within 1e-4 of max|u|."""
    model, stacked, noise = _spectral_stack("ns-2d")
    assert model.feat_in == 5 and model.in_pad == 1024
    xt = model.problem.sample_collocation(counter_generator(1), 100)
    zb, _ = model.problem.initial_batch(counter_generator(4), 25)
    out = []
    for d in (cuda, torch.device("cpu")):
        prep = model.prepare_params_stacked(to_device(stacked, d),
                                            to_device(noise, d))
        out.append([model.u_stacked(prep, x.to(d)).cpu()
                    for x in (pinn._spectral_rows(model, xt), zb)])
    for card, cpu in zip(*out):
        assert torch.isfinite(card).all()
        assert (card - cpu).abs().max() <= 1e-4 * cpu.abs().max()


def _coeff_model():
    """black-scholes-100d-rs at the paper's width (tonn, noise on): 103
    columns inside the 1024-wide padded input."""
    from repro_torch.configs.hjb_pinn import pinn_config
    model = pinn.TensorPinn(pinn_config(pde="black-scholes-100d-rs",
                                        mode="tonn", noise=True))
    assert model.net_in == 103 and model.in_pad == 1024
    return model


def test_u_coeff_grid_stacked_on_the_card_matches_the_cpu(cuda):
    """(P, C, B) u over 4 coefficient vectors × 50 points for 3 stacked
    parameter sets through one stacked forward: 2 ``tt_contract_batched``
    launches and 1 grouped densification on the card, within 1e-4 of
    max|u| of the CPU's plain path."""
    model = _coeff_model()
    params = model.init(counter_generator(0))
    noise = model.sample_noise(counter_generator(0, 99))
    xis = zoo.sample_perturbations(counter_generator(2), params, 2,
                                   model.trainable_mask(params))
    stacked = zoo.perturbed_stack(params, xis, zoo.SPSAConfig(num_samples=2))
    pts = model.problem.sample_collocation(counter_generator(1),
                                           50)[:, :model.in_dim]
    coeffs = model.problem.coeff_spec.sample(counter_generator(3), 4)
    counters = (ttc.tt_contract_batched, mesh.mesh_densify_stacked)
    out = []
    for d in (cuda, torch.device("cpu")):
        before = [fn.launches for fn in counters]
        prep = model.prepare_params_stacked(to_device(stacked, d),
                                            to_device(noise, d))
        out.append(model.u_coeff_grid_stacked(prep, pts.to(d),
                                              coeffs.to(d)).cpu())
        if d.type == "cuda":
            torch.cuda.synchronize()
            assert [fn.launches - b for fn, b in zip(counters, before)] \
                == [2, 1]
    card, cpu = out
    assert tuple(card.shape) == (3, 4, 50) and torch.isfinite(card).all()
    assert (card - cpu).abs().max() <= 1e-4 * cpu.abs().max()


def test_conditioned_pool_served_on_the_card(cuda):
    """A conditioned solver served on the card at 4 coefficient instances
    by one ``c2`` program, built once: each request's u equals the
    solver's ``model.u`` on its augmented rows (``rtol = atol = 1e-6``)
    and the CPU's plain path (1e-5)."""
    reg = SolverRegistry(device=cuda)
    s = reg.register_fresh("bs", _coeff_model().cfg, seed=0, device=cuda)
    eng = PdeServingEngine(reg, slots=4, slot_points=256, device=cuda)
    eng.warmup()
    pts = s.problem.sample_collocation(counter_generator(5),
                                       300)[:, :s.in_dim].numpy()
    reqs = [eng.submit(PointRequest("bs", pts, coeffs=c)) for c in
            ([0.02, 0.25], [0.05, 0.4], [0.09, 0.55], [0.03, 0.59])]
    eng.run()
    assert eng.stats["compiles"] == 1
    assert eng.serving_stats()["programs"] == ["bs|float32|c2|4|256"]
    for r in reqs:
        assert r.done and np.isfinite(r.out).all()
        rows = torch.tensor(r.points, dtype=torch.float32)
        with torch.no_grad():
            direct = s.model.u(s.params, rows.to(cuda)).cpu().numpy()
            plain = s.model.u(to_device(s.params, torch.device("cpu")),
                              rows).numpy()
        np.testing.assert_allclose(r.out, direct, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(r.out, plain, rtol=1e-5, atol=1e-5)
    assert not np.allclose(reqs[0].out, reqs[2].out)
