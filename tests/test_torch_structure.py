"""Rules the port keeps whatever its numbers: it imports no JAX and nothing of
the JAX package, its entry points run on the card unless the CPU is asked
for, its kernels are picked by the tensor's device (no switch), and
``chip_smoke.py`` refuses to report without a GPU."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch import device as device_lib
from repro_torch.core import pinn as tpinn
from repro_torch.kernels import _build
from repro_torch.launch import serve as lm_serve
from repro_torch.launch import serve_pde, train
from repro_torch.models import api as lm_api
from repro_torch.serving import PdeServingEngine, SolverRegistry

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
# files that run where no JAX is installed: the package, the chip scripts
# (every tool and every port benchmark) and the tests that need the card
JAX_FREE = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "tools").glob("*.py"))
            + sorted((ROOT / "benchmarks").glob("torch_*.py"))
            + [ROOT / "tests" / "test_torch_gpu.py",
               ROOT / "tests" / "torch_dist_ranks.py"])
FORBIDDEN_ROOTS = {"jax", "jaxlib", "repro"}


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", JAX_FREE, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = _imported_roots(path) & FORBIDDEN_ROOTS
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.serving, repro_torch.launch.serve_pde, "
            "repro_torch.launch.train, repro_torch.launch.serve, "
            "repro_torch.models.api, repro_torch.configs, "
            "repro_torch.parallel.zo_shard, repro_torch.optim.zo, "
            "repro_torch.runtime.watchdog, repro_torch.runtime.elastic; "
            "[repro_torch.configs.get_config(a) "
            "for a in repro_torch.configs.ARCH_NAMES]; "
            "bad = [m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


DISTRIBUTED_MODULES = ("parallel/__init__.py", "parallel/zo_shard.py",
                       "optim/zo.py", "runtime/__init__.py",
                       "runtime/watchdog.py", "runtime/elastic.py")


@pytest.mark.parametrize("rel", DISTRIBUTED_MODULES)
def test_distributed_zo_modules_exist_and_are_jax_free(rel):
    """The distributed-ZO slice mirrors its reference module for module;
    each file is in ``JAX_FREE`` and imports neither JAX nor the JAX
    package (the reference's ``parallel`` is a namespace package)."""
    path, ref = PORT / rel, ROOT / "src" / "repro" / rel
    assert path.is_file()
    assert ref.is_file() or (rel.endswith("__init__.py") and ref.parent.is_dir())
    assert path in JAX_FREE
    assert not _imported_roots(path) & FORBIDDEN_ROOTS


def test_the_tt_chain_has_one_body():
    """All three TT entries run the fiber body: the element body and its
    tiling are gone, and the quantized entry quantizes in its launch, not
    through the PyTorch quantizer."""
    for path in (PORT / "kernels" / "tt_contract.py",
                 PORT / "kernels" / "csrc" / "tt_contract.cu"):
        src = path.read_text()
        for name in ("chain_rows", "rows_per_block",
                     "quantize_blockwise_stacked"):
            assert name not in src, f"{name} in {path.relative_to(ROOT)}"
    cu = (PORT / "kernels" / "csrc" / "tt_contract.cu").read_text()
    assert cu.count("chain_fibers(") == 4      # its definition, 3 kernels


def test_no_env_switch_picks_a_kernel():
    for path in PORT.rglob("*.py"):
        assert "REPRO_KERNEL_MODE" not in path.read_text(), path
    ops_src = (PORT / "kernels" / "ops.py").read_text()
    assert "environ" not in ops_src and "except" not in ops_src


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_a_gpu(tmp_path, alone):
    """No CUDA device (this machine), in the checkout and copied alone into
    an empty directory: a non-zero exit and no result line."""
    script = ROOT / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert '"kernels"' not in proc.stdout


def test_zo_step_script_refuses_without_a_gpu():
    """The ZO-step measuring script needs the card too: no number from the
    CPU under a device metric's name."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, str(ROOT / "tools" / "zo_step.py"),
                           str(ROOT / "src")], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "[zo-step]" not in proc.stdout and "ms" not in proc.stdout


def test_fiber_rows_script_refuses_without_a_gpu():
    """So does the sweep of the TT fiber body's rows per block."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable,
                           str(ROOT / "tools" / "tt_fiber_rows.py")],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert "[fiber-rows]" not in proc.stdout and "ms" not in proc.stdout


def test_dist_identity_script_refuses_without_a_gpu():
    """The distributed-identity diagnosis defaults to the card too."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable,
                           str(ROOT / "tools" / "dist_identity.py")],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert "[dist-identity]" not in proc.stdout and "ms" not in proc.stdout


def test_mesh_rows_grad_script_refuses_without_a_gpu():
    """So does the warp-rows backward's check and configuration sweep."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable,
                           str(ROOT / "tools" / "mesh_rows_grad.py")],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert "[mesh-rows-grad]" not in proc.stdout and "ms" not in proc.stdout


@pytest.mark.parametrize("tool,args,tag", [
    ("mesh_apply_grad.py", ["build/parent/src"], "[mesh-apply-grad]"),
    ("mesh_apply_grad_phases.py", [], "[phases]")])
def test_resident_grad_scripts_refuse_without_a_gpu(tool, args, tag):
    """So do the resident backward's parent-in-turns timing and its phase
    stamps: no number, and nothing built, without the card."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, str(ROOT / "tools" / tool),
                           *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert tag not in proc.stdout and "ms" not in proc.stdout


def test_table1_script_refuses_without_a_gpu(tmp_path):
    """So does the Table 1 script at its default device: no row runs and
    nothing is written."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PYTHONPATH"] = str(ROOT / "src")
    out = tmp_path / "table1.json"
    proc = subprocess.run([sys.executable,
                           str(ROOT / "benchmarks" / "torch_table1_hjb.py"),
                           "--out", str(out)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "table1/" not in proc.stdout and not out.exists()


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_is_the_card(no_gpu, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_lib.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SolverRegistry()
    reg = SolverRegistry(device="cpu")
    cfg = tpinn.PINNConfig(hidden=16, mode="tt", tt_L=3, pde="heat-10d")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        reg.register_fresh("heat", cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        reg.load_checkpoint("heat", tmp_path)
    reg.register_fresh("heat", cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PdeServingEngine(reg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_pde.main(["--ckpt", f"heat={tmp_path}", "--synthetic", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "tensor-pinn", "--pde", "hjb-20d", "--reduced",
                    "--steps", "1"])
    eng = PdeServingEngine(reg, device="cpu")
    assert eng.device == torch.device("cpu")


def test_lm_entry_points_default_to_the_card(no_gpu):
    cfg = configs.get_reduced("qwen2.5-3b")
    gen = device_lib.counter_generator(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_api.init_params(cfg, gen)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_api.init_cache(cfg, 1, 8)
    params = lm_api.init_params(cfg, gen, "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_serve.ServingEngine(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_serve.main(["--arch", "qwen2.5-3b", "--reduced"])
    eng = lm_serve.ServingEngine(cfg, params, device="cpu")
    assert eng.cache["k_0"].device == torch.device("cpu")


def test_resolve_device_rules(no_gpu):
    assert device_lib.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        device_lib.resolve_device("meta")
    reg = SolverRegistry(device="cpu")
    cfg = tpinn.PINNConfig(hidden=16, mode="tt", tt_L=3, pde="heat-10d")
    tree = {"a": [torch.zeros(1)], "b": torch.ones(2)}
    moved = device_lib.to_device(tree, torch.device("cpu"))
    assert moved["a"][0].device.type == "cpu" and set(moved) == {"a", "b"}
    reg.register_fresh("heat", cfg, device="cpu")
    assert reg.names() == ("heat",) and "heat" in reg and len(reg) == 1
    with pytest.raises(KeyError):
        reg.get("hjb")


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No fallback: without nvcc the build raises, and builds only from the
    checkout's sources into its ignored build directory."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "CUDA_ROOT", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("tt_contract")
    assert _build.CSRC_DIR == PORT / "kernels" / "csrc"
    assert (_build.CSRC_DIR / "tt_contract.cu").is_file()
    assert "build/" in (ROOT / ".gitignore").read_text().split()
    assert np.all([f in _build.NVCC_FLAGS
                   for f in ("arch=compute_90a,code=sm_90a", "-shared")])
