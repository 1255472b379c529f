"""Tests that need the card: the CUDA ``tt_contract`` kernel against its plain
PyTorch version, and served values against a direct forward, on the GPU.

Run on a machine with an NVIDIA GPU (Hopper, ``sm_90a``) and ``nvcc``:

    python -m pytest -m gpu tests/test_torch_gpu.py

Without a card every test skips with that reason.  This file imports no JAX:
the machine with the card does not have it.

Tolerances: kernel against plain ``max|kernel − plain| ≤ 1e-5·max|plain| +
1e-6`` (the same f32 products summed in another order); served against a
direct forward ``rtol = atol = 1e-6`` (the head's matmul may pick another
cuBLAS algorithm for another batch size); the card against the CPU's plain
path ``rtol = atol = 1e-5``.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import pinn, tt
from repro_torch.core.photonic import NoiseModel
from repro_torch.device import to_device
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import tt_contract as ttc
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
    the engine's padding cannot change a served value."""
    spec = tt.PAPER_TONN_SPEC
    cores, x = _chain_inputs(spec, 301, seed=2, device=cuda)
    y = ttc.tt_contract(x, cores, spec)
    for shift in (1, 3, ttc.rows_per_block(spec) + 1):
        assert torch.equal(ttc.tt_contract(x[shift:].contiguous(), cores,
                                           spec), y[shift:])


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


def test_build_is_cached_by_source_hash(cuda):
    lib = _build.build("tt_contract")
    assert lib.parent == _build.BUILD_DIR and lib.is_file()
    assert _build.build("tt_contract") == lib


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
