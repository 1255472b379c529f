"""Model configurations of the port: the paper's PINN (``hjb_pinn``) and the
assigned LM architectures, ``get_config(name)`` / ``get_reduced(name)``
(the copy of ``repro.configs``; only the ``dense`` family runs so far)."""

import importlib

_MODULES = {
    "starcoder2-7b": "starcoder2_7b",
    "qwen2.5-3b": "qwen2_5_3b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "yi-6b": "yi_6b",
    "whisper-base": "whisper_base",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "mamba2-780m": "mamba2_780m",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "dbrx-132b": "dbrx_132b",
    "jamba-1.5-large-398b": "jamba_1_5_large",
}

ARCH_NAMES = tuple(_MODULES)


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str):
    return _mod(name).CONFIG


def get_reduced(name: str):
    return _mod(name).REDUCED
