"""Keras ``.h5`` weight files (port of ``ku/io/keras_h5.py``): read the
reference's saves and graft them onto the port's parameter trees, and write
parameters back in Keras 2's layout.

The file format is framework-free and read with h5py, imported inside the
functions so that ``ku_torch`` imports without it:

- a whole-model save keeps its weights under the ``model_weights`` root
  group, a ``save_weights`` file at the root; either way the owning group
  has a ``layer_names`` attribute, and each layer group a ``weight_names``
  attribute (``dense_1/kernel:0``) naming its datasets.
- Keras' Dense kernels are (in, out) and its convs (kh, kw, in, out), the
  layouts the port keeps (flax's), so arrays cross without a transpose.

Parameter trees are nested dicts of numpy arrays or tensors under flax's
names, as ``ku_torch.utility.tree_from_state_dict`` /
``variables_from_module`` give them; load a grafted tree back with
``ku_torch.utility.load_variables``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch


def _decode(x):
    return x.decode("utf8") if isinstance(x, bytes) else str(x)


def _base(name: str) -> str:
    return name.split("/")[-1].split(":")[0]


def load_keras_h5_weights(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """Read a Keras h5 file → ``{layer_name: {weight_name: array}}``, the
    weight names being the datasets' basenames without ``:0`` (``kernel``,
    ``bias``, ``rbm_weight``…). Reads whole-model saves and ``save_weights``
    files."""
    import h5py

    out: Dict[str, Dict[str, np.ndarray]] = {}
    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        if "layer_names" in root.attrs:
            layer_names = [_decode(n) for n in root.attrs["layer_names"]]
        else:
            layer_names = list(root.keys())
        for lname in layer_names:
            if lname not in root:
                continue
            g = root[lname]
            weights: Dict[str, np.ndarray] = {}
            if "weight_names" in g.attrs:
                for wname in g.attrs["weight_names"]:
                    wname = _decode(wname)
                    weights[_base(wname)] = np.asarray(g[wname])
            else:
                def visit(name, obj, _w=weights):
                    if isinstance(obj, h5py.Dataset):
                        _w[_base(name)] = np.asarray(obj)

                g.visititems(visit)
            if weights:
                out[lname] = weights
    return out


_NAME_SYNONYMS = {
    # flax parameter name → the names the reference / Keras side uses.
    "kernel": ("kernel", "rbm_weight", "depthwise_kernel"),
    "bias": ("bias", "rbm_hidden_bias", "hidden_bias"),
    "embedding": ("embeddings", "embedding"),
    "scale": ("gamma",),
    "mean": ("moving_mean",),
    "var": ("moving_variance",),
}


def _like(arr, leaf):
    """``arr`` as the leaf it replaces: a tensor of the leaf's dtype and
    device, or a numpy array of its dtype."""
    if isinstance(leaf, torch.Tensor):
        return torch.as_tensor(np.asarray(arr)).to(dtype=leaf.dtype, device=leaf.device)
    return np.asarray(arr, dtype=np.asarray(leaf).dtype)


def graft_keras_weights(params, h5_weights: Dict[str, Dict[str, np.ndarray]],
                        rename: Optional[Dict[str, str]] = None, strict: bool = False):
    """Graft Keras h5 weights onto a nested parameter tree by layer name and
    shape.

    ``params``: ``{'layer': {'kernel': …}}``, any nesting; the FIRST path
    component naming a layer of ``h5_weights`` (after ``rename``,
    ``{port_layer: keras_layer}``) selects the source group. Within a layer
    a leaf takes the first unused array of its synonyms (kernel/bias/…) with
    its shape, else the one unused array of its shape, the leaves taken in
    sorted key order as in ``ku``. Returns
    ``(new_params, report)``, the report listing the grafted and unmatched
    leaves by path; ``strict=True`` raises on any unmatched leaf.
    ``h5_weights`` is never changed: which arrays a call used is its own
    bookkeeping, so one file grafts onto several models."""
    rename = rename or {}
    grafted, unmatched = [], []
    used_by_layer: Dict[str, set] = {}

    def pick(layer, layer_arrays, pname, shape):
        used = used_by_layer.setdefault(layer, set())
        for cand in _NAME_SYNONYMS.get(pname, (pname,)):
            if cand in layer_arrays and cand not in used:
                if layer_arrays[cand].shape == tuple(shape):
                    used.add(cand)
                    return layer_arrays[cand]
        hits = [k for k, v in layer_arrays.items()
                if k not in used and getattr(v, "shape", None) == tuple(shape)]
        if len(hits) == 1:
            used.add(hits[0])
            return layer_arrays[hits[0]]
        return None

    def leaf(names, value):
        layer = next((rename.get(n, n) for n in names[:-1] if rename.get(n, n) in h5_weights),
                     None)
        path = "/".join(names)
        arr = None if layer is None else pick(layer, h5_weights[layer], names[-1],
                                               tuple(value.shape))
        if arr is None:
            unmatched.append(path)
            return value
        grafted.append(path)
        return _like(arr, value)

    def walk(node, names):
        # Leaves in sorted key order, as jax walks ku's dicts: the order
        # decides which leaf takes a shared array.
        if isinstance(node, Mapping):
            done = {k: walk(node[k], names + [str(k)]) for k in sorted(node)}
            return {k: done[k] for k in node}
        return leaf(names, node) if hasattr(node, "shape") else node

    new_params = walk(params, [])
    report = {"grafted": grafted, "unmatched": unmatched}
    if strict and unmatched:
        raise ValueError(f"unmatched params: {unmatched}")
    return new_params, report


def save_keras_h5(path: str, layers: Dict[str, Dict[str, np.ndarray]],
                  layer_order=None) -> None:
    """Write ``{layer_name: {weight_name: array}}`` as a Keras-2
    ``save_weights`` file (the reverse of :func:`load_keras_h5_weights`):
    root ``layer_names``, a group a layer with ``weight_names`` of
    ``<layer>/<weight>:0`` entries naming its float32 datasets."""
    import h5py

    names = list(layers) if layer_order is None else list(layer_order)
    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = [n.encode("utf8") for n in names]
        f.attrs["backend"] = b"tensorflow"
        f.attrs["keras_version"] = b"2.15.0"
        for lname in names:
            g = f.create_group(lname)
            wnames = [f"{lname}/{w}:0" for w in layers[lname]]
            g.attrs["weight_names"] = [w.encode("utf8") for w in wnames]
            for w, arr in layers[lname].items():
                g.create_dataset(f"{lname}/{w}:0", data=_numpy(arr, np.float32))


def _numpy(arr, dtype=None) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    return np.asarray(arr, dtype=dtype)


def flax_to_keras_layers(params, sep: str = ".") -> Dict[str, Dict[str, np.ndarray]]:
    """Flatten a nested parameter tree to ``{layer: {weight: array}}``: a
    layer is any dict that owns an array directly, named by the
    ``sep``-joined path from the root ("root" at the root). Feed the result
    to :func:`save_keras_h5`."""
    out: Dict[str, Dict[str, np.ndarray]] = {}

    def walk(node, path):
        if not isinstance(node, Mapping):
            return
        direct = {k: _numpy(v) for k, v in node.items()
                  if hasattr(v, "shape") and not isinstance(v, Mapping)}
        if direct:
            out[sep.join(path) if path else "root"] = direct
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, path + [k])

    walk(params, [])
    return out


def save_reference_rbm_h5(params, path: str, layer_name: str = "rbm") -> None:
    """Write RBM parameters in the reference's Keras layout, the inverse of
    :func:`load_reference_rbm_h5`: ``rbm_weight`` and ``rbm_hidden_bias``
    only, since the reference's visible bias is a raw ``K.variable`` that
    never reaches its h5 files."""
    save_keras_h5(path, {
        layer_name: {
            "rbm_weight": _numpy(params["rbm_weight"], np.float32),
            "rbm_hidden_bias": _numpy(params["hidden_bias"], np.float32),
        }
    })


def load_reference_rbm_h5(path: str, layer_name: str = "rbm"):
    """Read the reference RBM's weights out of a Keras h5 save → the RBM
    parameter dict (numpy). The reference's visible bias is not in its
    files (see :func:`save_reference_rbm_h5`): it comes back as zeros, as
    the reference itself would reload it."""
    weights = load_keras_h5_weights(path)
    if layer_name not in weights:
        raise KeyError(f"layer {layer_name!r} not in {sorted(weights)} of {path}")
    w = weights[layer_name]
    rbm_w = w.get("rbm_weight", w.get("kernel"))
    bh = w.get("rbm_hidden_bias", w.get("bias"))
    if rbm_w is None or bh is None:
        raise KeyError(f"rbm weights not found in layer {layer_name!r}: {sorted(w)}")
    return {
        "rbm_weight": np.asarray(rbm_w, np.float32),
        "hidden_bias": np.asarray(bh, np.float32),
        "visible_bias": np.zeros((rbm_w.shape[0],), np.float32),
    }
