"""The port's photonic cost model and Table 2 against the JAX package's.

``repro_torch.core.costmodel`` is pure Python over the port's TT specs, so
it must give the JAX module's numbers exactly: integers equal, floats to
``rtol = 1e-12`` (the same float expressions; only the TT spec objects
come from another package).  Table 2's rows must be equal dict for dict.
"""

import dataclasses

import pytest

from benchmarks import table2_cost, torch_table2_cost
from repro.core import costmodel as jcm
from repro_torch.core import costmodel as tcm

# (hidden, rank, L, space_dim, spsa_samples, batch, epochs); the first is
# the paper's
CASES = [(1024, 2, 4, 20, 10, 100, 5000), (64, 2, 3, 20, 10, 100, 600),
         (256, 4, 2, 10, 5, 64, 100), (512, 3, 4, 20, 20, 50, 1000),
         (16, 2, 2, 1, 1, 8, 1)]


def _same(got, want):
    got, want = dataclasses.asdict(got), dataclasses.asdict(want)
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        if isinstance(w, float):
            assert g == pytest.approx(w, rel=1e-12, abs=0), key
        else:
            assert type(g) is type(w) and g == w, key


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_cost_model_matches_jax(case):
    hidden, rank, L, space_dim, samples, batch, epochs = case
    in_dim = space_dim + 1
    jdev, tdev = jcm.DeviceConstants(), tcm.DeviceConstants()
    _same(tdev, jdev)
    for name in ("onn_spec", "tonn1_spec", "tonn2_spec"):
        kw = {} if name == "onn_spec" else {"rank": rank, "L": L}
        want = getattr(jcm, name)(hidden, in_dim, **kw)
        got = getattr(tcm, name)(hidden, in_dim, **kw)
        _same(got, want)
        assert got.latency_per_inference_ns(tdev) == pytest.approx(
            want.latency_per_inference_ns(jdev), rel=1e-12, abs=0)
        _same(tcm.training_efficiency(got, tdev, space_dim, samples, batch,
                                      1, epochs),
              jcm.training_efficiency(want, jdev, space_dim, samples, batch,
                                      1, epochs))
    assert tcm._tt_mzis(tcm._tt_specs(hidden, in_dim, rank, L)) \
        == jcm._tt_mzis(jcm._tt_specs(hidden, in_dim, rank, L))


def test_cost_model_gives_the_paper_numbers():
    """The numbers the paper's abstract and Table 2 rest on, as the model
    derives them: 2,095,104 ONN MZIs (paper 2.10e6), 4.2e4 inferences an
    epoch, 1.3545 J and 1.151 s over 5,000 epochs (paper 1.36 J, 1.15 s).
    TONN-1's MZI count from mesh algebra is 1,008 (the paper's 1.79e3), so
    the ratio to ONN is 2,078.5 where the paper has 1.17e3."""
    onn, tonn1 = tcm.onn_spec(), tcm.tonn1_spec()
    assert onn.num_mzis == 2_095_104
    assert tonn1.num_mzis == 1_008 and tcm.tonn2_spec().num_mzis == 28
    tr = tcm.training_efficiency(tonn1)
    assert tr.inferences_per_epoch == 42_000
    assert tr.total_energy_j == pytest.approx(42_000 * 6.45e-9 * 5000)
    assert tr.total_latency_s == pytest.approx(42_000 * 5.48e-9 * 5000)
    assert abs(tr.total_energy_j / 1.36 - 1) < 0.01
    assert abs(tr.total_latency_s / 1.15 - 1) < 0.01


def test_table2_rows_match_jax():
    assert torch_table2_cost.PAPER == table2_cost.PAPER
    assert torch_table2_cost.run() == table2_cost.run()
