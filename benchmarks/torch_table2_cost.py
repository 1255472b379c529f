"""Paper Table 2 + §4.2 training-efficiency reproduction from the analytic
photonic cost model of the PyTorch port (``repro_torch.core.costmodel``);
the port of ``benchmarks/table2_cost.py``, row for row and key for key.

    PYTHONPATH=src python benchmarks/torch_table2_cost.py

Paper targets: ONN 2.10e6 MZIs; TONN-1 1.79e3 MZIs, 6.45 nJ, 550 ns;
TONN-2 28 MZIs, 5.05 nJ, 3604 ns; training = 4.2e4 inferences/epoch,
1.36 J and 1.15 s over 5000 epochs (TONN-1).
"""

from __future__ import annotations

from repro_torch.core import costmodel as cm

PAPER = {
    "ONN": {"mzis": 2.10e6, "latency_ns": 600.0},
    "TONN-1": {"mzis": 1.79e3, "energy_j": 6.45e-9, "latency_ns": 550.0},
    "TONN-2": {"mzis": 28, "energy_j": 5.05e-9, "latency_ns": 3604.0},
    "training": {"inferences_per_epoch": 4.2e4, "total_energy_j": 1.36,
                 "total_latency_s": 1.15},
}


def run() -> list:
    dev = cm.DeviceConstants()
    rows = []
    for spec in (cm.onn_spec(), cm.tonn1_spec(), cm.tonn2_spec()):
        lat = spec.latency_per_inference_ns(dev)
        ref = PAPER[spec.name]
        rows.append({
            "name": f"table2/{spec.name}",
            "params": spec.params,
            "mzis": spec.num_mzis,
            "mzis_paper": ref.get("mzis"),
            "latency_ns": round(lat, 1),
            "latency_ns_paper": ref.get("latency_ns"),
            "energy_j": spec.energy_per_inference_j,
            "energy_j_paper": ref.get("energy_j"),
            "footprint_mm2": spec.footprint_mm2,
        })
    tr = cm.training_efficiency(cm.tonn1_spec())
    ref = PAPER["training"]
    rows.append({
        "name": "table2/training-efficiency(TONN-1)",
        "inferences_per_epoch": tr.inferences_per_epoch,
        "inferences_per_epoch_paper": ref["inferences_per_epoch"],
        "total_energy_j": (None if tr.total_energy_j is None
                           else round(tr.total_energy_j, 3)),
        "total_energy_j_paper": ref["total_energy_j"],
        "total_latency_s": round(tr.total_latency_s, 3),
        "total_latency_s_paper": ref["total_latency_s"],
        "mzi_reduction_vs_onn": round(
            cm.onn_spec().num_mzis / cm.tonn1_spec().num_mzis, 1),
        "mzi_reduction_paper": 1.17e3,
    })
    return rows


if __name__ == "__main__":
    for r in run():
        print(r)
