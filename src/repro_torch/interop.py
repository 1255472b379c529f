"""The weight carrier: numpy pytrees from the JAX package → the port's tensors.

The JAX package's params and hardware-noise pytrees are nested dicts and
lists of arrays (tonn's ``pcores0/1/phases_u``, onn's ``p0/phases_u`` and
``p0/u/gamma``: nothing here is keyed to a mode); converted leaf by leaf
to numpy (``np.asarray``) they can be handed to ``params_from_numpy`` /
``noise_from_numpy``, and both packages then compute the same thing.  The same goes for the trees of ZO
training: stacked params (a leading perturbation axis P on every leaf) and
ξ stacks (``zoo.sample_perturbations``) convert leaf by leaf through
``params_from_numpy``.  JAX's threefry bits and torch's generators differ,
so agreement never rests on seeds — only on arrays.

``lm_params_from_numpy`` does the same for the JAX LM's params
(``repro.models.api.init_params``), whose leaves may be bfloat16.

``tree_from_flat`` rebuilds a tree from ``/``-joined path keys, the format
of a checkpoint's ``arrays.npz`` (``pcores0/1/u/gamma``): a noise tree
saved that way is what ``launch.serve_pde --hw-noise`` reads.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_numpy", "noise_from_numpy", "lm_params_from_numpy",
           "tree_from_flat"]


def _tensors(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v, device) for v in tree]
    arr = np.asarray(tree)
    if arr.dtype != np.float32:
        raise TypeError(f"expected float32 leaves, got {arr.dtype}")
    return torch.tensor(arr, device=device)


def params_from_numpy(tree, device: str | torch.device) -> dict:
    """A JAX ``TensorPinn`` params tree (numpy leaves) as tensors on
    ``device``, in the port's params layout (which is the same tree); a
    stacked params tree or a ξ stack converts the same way."""
    return _tensors(tree, torch.device(device))


def noise_from_numpy(tree, device: str | torch.device) -> dict | None:
    """A JAX hardware-noise tree (``TensorPinn.sample_noise``, numpy
    leaves) as tensors on ``device``; None stays None."""
    return None if tree is None else _tensors(tree, torch.device(device))


def _lm_tensor(leaf, device: torch.device) -> torch.Tensor:
    arr = np.array(leaf)                  # a writable, contiguous copy
    # JAX's bfloat16 arrives as ml_dtypes.bfloat16, which torch cannot read
    # (and which the machine with the card may not have): same bits, as
    # uint16, viewed as torch.bfloat16
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(
            torch.bfloat16).to(device)
    if arr.dtype != np.float32:
        raise TypeError(f"expected float32 or bfloat16 LM params, got "
                        f"{arr.dtype}")
    return torch.from_numpy(arr).to(device)


def lm_params_from_numpy(tree, device: str | torch.device) -> dict:
    """A JAX LM params tree (numpy leaves, e.g. ``jax.tree.map(np.asarray,
    params)``) as tensors on ``device``, dtype for dtype, in the port's
    layout (which is the same tree: ``embed/table``, ``layers_0/...``)."""
    device = torch.device(device)
    if isinstance(tree, dict):
        return {k: lm_params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [lm_params_from_numpy(v, device) for v in tree]
    return _lm_tensor(tree, device)


def tree_from_flat(flat: dict) -> dict:
    """``{"a/0/b": arr, ...}`` → ``{"a": [{"b": arr}]}``: path components
    that are all digits index lists, the others key dicts."""
    root: dict = {}
    for key, leaf in flat.items():
        node = root
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            idx = sorted(node, key=int)
            if [int(k) for k in idx] != list(range(len(idx))):
                raise ValueError(f"list indices {idx} are not 0..n-1")
            return [lists(node[k]) for k in idx]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)
