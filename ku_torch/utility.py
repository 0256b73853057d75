"""Model persistence: JSON architecture + ``.npz`` weight archive.

The same two-file format as ``ku/utility.py``: ``<name>.json`` holds the
spec dict and ``<name>.npz`` the parameters of a nested dict, flattened to
``/``-joined keys. Files written by either package load in the other.
Parameters keep ``ku``'s names and layouts (``rbm_weight`` is (V, H)).
"""

from __future__ import annotations

import json
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts (and lists/tuples, keyed by index) → ``{'a/b': array}``."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: _to_numpy(tree)}
    flat: Dict[str, np.ndarray] = {}
    for key, value in items:
        flat.update(_flatten(value, f"{prefix}/{key}" if prefix else str(key)))
    return flat


def _unflatten(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.asarray(value)
    return tree


def _leaf_to_tensor(leaf, device) -> torch.Tensor:
    arr = np.array(leaf)
    if arr.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.from_numpy refuses: carry the
        # bits across unchanged.
        return torch.from_numpy(arr.view(np.uint16).view(np.int16)).view(
            torch.bfloat16).to(torch.device(device))
    return torch.from_numpy(arr).to(torch.device(device))


def _leaf_to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        import ml_dtypes  # ships with jax; needed only to hand bf16 back

        return leaf.detach().cpu().view(torch.int16).numpy().view(
            ml_dtypes.bfloat16)
    return _to_numpy(leaf)


def params_from_numpy(tree, device="cuda"):
    """A nested dict of numpy arrays (``ku``'s parameters) → the same dict
    of torch tensors on ``device``, names, shapes and dtypes unchanged
    (``ml_dtypes.bfloat16`` arrays become ``torch.bfloat16`` bit for bit)."""
    if isinstance(tree, Mapping):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return _leaf_to_tensor(tree, device)


def params_to_numpy(tree):
    """Inverse of :func:`params_from_numpy`: tensors → numpy arrays."""
    if isinstance(tree, Mapping):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return _leaf_to_numpy(tree)


def state_dict_from_tree(tree, device="cuda", batch_stats=None) -> Dict[str, torch.Tensor]:
    """``ku``'s nested parameters (flax names such as
    ``block0/MultiHeadAttention_1/W_Q``) → a flat state dict of tensors on
    ``device``, keyed ``block0.MultiHeadAttention_1.W_Q``, which the port's
    modules load with ``load_state_dict(..., strict=True)``. Layouts and
    dtypes stay ``ku``'s (bf16 bit for bit). ``batch_stats``, ``ku``'s
    collection of that name (``truncation/moving_mean``), joins under the
    same naming: the port keeps it in buffers (``truncation.moving_mean``)."""
    flat = _flatten(tree)
    if batch_stats is not None:
        stats = _flatten(batch_stats)
        clash = flat.keys() & stats.keys()
        if clash:
            raise ValueError(f"names in both params and batch_stats: {sorted(clash)}")
        flat.update(stats)
    return {key.replace("/", "."): _leaf_to_tensor(value, device)
            for key, value in flat.items()}


def variables_from_module(module: torch.nn.Module) -> Dict[str, Any]:
    """A module's state as ``ku``'s variables: ``{"params": parameters,
    "batch_stats": persistent buffers}``, each a nested dict of numpy
    arrays under ``ku``'s names; the inverse of loading
    :func:`state_dict_from_tree` with ``batch_stats``."""
    state = module.state_dict()
    params = {name for name, _ in module.named_parameters()}
    return {
        "params": tree_from_state_dict({k: v for k, v in state.items() if k in params}),
        "batch_stats": tree_from_state_dict(
            {k: v for k, v in state.items() if k not in params}),
    }


def tree_from_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`state_dict_from_tree`: a nested dict of numpy
    arrays under ``ku``'s names."""
    return _unflatten({key.replace(".", "/"): _leaf_to_numpy(value)
                       for key, value in state_dict.items()})


def save_model_jh5(spec: Any, params, name: str) -> None:
    """Save the spec → ``<name>.json`` and params → ``<name>.npz``."""
    with open(name + ".json", "w") as f:
        json.dump(spec, f, indent=2, default=str)
    np.savez(name + ".npz", **_flatten(params))


def load_model_jh5(name: str) -> Tuple[Any, Dict[str, Any]]:
    """Load (spec, params) written by :func:`save_model_jh5` here or in
    ``ku``; params come back as a nested dict of numpy arrays."""
    with open(name + ".json") as f:
        spec = json.load(f)
    with np.load(name + ".npz") as data:
        params = _unflatten({k: data[k] for k in data.files})
    return spec, params


def save_weights(params, path: str) -> None:
    np.savez(path if path.endswith(".npz") else path + ".npz", **_flatten(params))


def load_weights(path: str) -> Dict[str, Any]:
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        return _unflatten({k: data[k] for k in data.files})
