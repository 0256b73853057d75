"""Weight-only int8 quantization for the serving path, and its W8A8 variant.

Port of ``ku/nn/quant.py``. Quantization is symmetric per output channel:
``s_j = max_i |W_ij| / 127`` and ``Q = round(W / s)`` (an all-zero column
gets s = 1), with no zero points. A quantized projection holds ``Q`` (int8,
(in, out)) and ``<name>_scale`` (f32, (out,)) and computes
``(x @ Q) · s``, which equals ``x @ (Q · s)``: the int8 weight is converted
to x's dtype in the product and the scale multiplies the output columns.

``"w8a8"`` also quantizes the activations per token at run time
(:func:`int8_act_matmul`), so that each projection is one int8 × int8 →
int32 product, ``torch._int_mm``: lossy, where weight-only is exact given
the quantized weights.

Usage, parameters as data, no retraining::

    model_q = Transformer(..., quant_weights=True, device=..., dtype=...)
    model_q.load_state_dict(quantize_weights(float_model.state_dict(), model_q))

The int8 kernels and the scales are parameters that take no gradient, so
:func:`ku_torch.utility.variables_from_module` hands them back under
``ku``'s names and ``state_dict_from_tree`` loads ``ku``'s quantized
parameters as they are. Build a quantized model in its serving dtype
(``dtype=torch.bfloat16``) rather than casting it with ``.to(dtype)``,
which would cast the f32 scales too.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

__all__ = ["QuantDense", "quantize_weights", "int8_act_matmul"]

# torch._int_mm on a CUDA tensor takes more than 16 rows and K, N
# multiples of 8, and cuBLASLt found no int8 product for 24 rows at K < 128
# with N >= 32 (torch 2.11, CUDA 12.8, H100). A decode step has a row a
# sequence, so the card's rows are padded with zeros to a multiple of 8 of
# at least _INT_MM_MIN_ROWS, K to at least _INT_MM_MIN_K and N to a multiple
# of 8; zeros add nothing to the sums, and the padding is sliced off.
_INT_MM_MIN_ROWS = 24
_INT_MM_MIN_K = 128


def _127(x):
    """127 as a tensor on x's device: PyTorch's CUDA division by a Python
    number multiplies by its reciprocal, which can round an ulp away from
    the quotient that the CPU (and ku) compute."""
    return torch.tensor(127.0, device=x.device)


def _pad_to(x, dim, size):
    if x.shape[dim] == size:
        return x
    shape = list(x.shape)
    shape[dim] = size - x.shape[dim]
    return torch.cat([x, x.new_zeros(shape)], dim)


def _int_mm(a, b):
    """int8 (M, K) @ int8 (K, N) → int32 (M, N) by one ``torch._int_mm``; on
    a CUDA tensor padded to what that product takes
    (``int8_act_matmul.padded`` counts the calls whose rows were padded)."""
    int8_act_matmul.int_mm_calls += 1
    if a.device.type != "cuda":
        return torch._int_mm(a.contiguous(), b)
    (m, k), n = a.shape, b.shape[1]
    rows = max(_INT_MM_MIN_ROWS, -(-m // 8) * 8)
    kp = max(_INT_MM_MIN_K, -(-k // 8) * 8)
    if rows != m:
        int8_act_matmul.padded += 1
    a = _pad_to(_pad_to(a, 0, rows), 1, kp)
    b = _pad_to(_pad_to(b, 0, kp), 1, -(-n // 8) * 8)
    return torch._int_mm(a, b)[:m, :n]


def int8_act_matmul(x, wq8, col_scale):
    """W8A8 dynamic product: per-token int8 activations × int8 weights.

    Each row of x is quantized symmetrically (its largest |entry| maps to
    127), the int8 rows go through one int8 × int8 → int32 product, and the
    result is rescaled as ``y · a_s · s_col`` in f32, in ``ku``'s order of
    operations, then cast to x's dtype."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    a_s = amax.clamp_min(1e-20) / _127(amax)
    xq = torch.round(xf / a_s).clamp(-127, 127).to(torch.int8)
    y = _int_mm(xq.reshape(-1, xq.shape[-1]), wq8).reshape(
        *x.shape[:-1], wq8.shape[-1])
    return (y.float() * a_s * col_scale.float()).to(x.dtype)


int8_act_matmul.int_mm_calls = int8_act_matmul.padded = 0


def quant_weight(shape, device=None):
    """An int8 kernel (zeros) and its f32 column scales (ones), as
    parameters that take no gradient: ku's quantized template."""
    return (nn.Parameter(torch.zeros(shape, dtype=torch.int8, device=device),
                         requires_grad=False),
            nn.Parameter(torch.ones(shape[-1], dtype=torch.float32, device=device),
                         requires_grad=False))


def quant_project(x, wq8, scale, act_quant: bool):
    """``x @ (wq8 · scale)`` as ``ku`` computes it: weight-only
    ``(x @ wq8.to(x.dtype)) · scale.to(x.dtype)``, or W8A8."""
    if act_quant:
        return int8_act_matmul(x, wq8, scale)
    return (x @ wq8.to(x.dtype)) * scale.to(x.dtype)


class QuantDense(nn.Module):
    """``ku.nn.QuantDense``: flax's Dense with an int8 ``kernel`` (in,
    features), f32 ``kernel_scale`` (features,) and ``bias`` (features,;
    none with ``use_bias=False``). ``act_quant`` switches the forward from
    weight-only to W8A8."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 act_quant: bool = False, *, device="cuda", dtype=None):
        super().__init__()
        self.act_quant = act_quant
        self.kernel, self.kernel_scale = quant_weight((in_features, features), device)
        self.bias = (nn.Parameter(torch.zeros(features, device=device, dtype=dtype))
                     if use_bias else None)

    def forward(self, x):
        y = quant_project(x, self.kernel, self.kernel_scale, self.act_quant)
        return y if self.bias is None else y + self.bias.to(y.dtype)


def _quantize_leaf(w):
    """Symmetric per-output-channel int8 of a weight: (q int8, scale f32),
    ``ku``'s ``_quantize_leaf`` bit for bit."""
    w = w.detach().float()
    reduce_dims = tuple(range(w.dim() - 1))  # all but the output channel
    s = (w.abs().amax(dim=reduce_dims) if reduce_dims else w.abs()) / _127(w)
    s = torch.where(s == 0, torch.ones_like(s), s)  # all-zero column: q = 0
    q = torch.round(w / s).clamp(-127, 127).to(torch.int8)
    return q, s


def _nest(flat: Mapping[str, Any]) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def _unnest(tree, prefix: str = "") -> dict:
    flat = {}
    for key, value in tree.items():
        name = f"{prefix}.{key}" if prefix else key
        flat.update(_unnest(value, name) if isinstance(value, dict) else {name: value})
    return flat


def quantize_weights(params, template):
    """Map trained float parameters onto a quantized model's template.

    ``params``: the float model's state dict (``float_model.state_dict()``,
    or ``ku``'s parameters through
    :func:`ku_torch.utility.state_dict_from_tree`). ``template``: the
    quantized module or its state dict. Walks the template as ``ku`` does:
    each int8 leaf is quantized from ``params`` with its ``<name>_scale``
    beside it; every other leaf is copied through from ``params`` with its
    dtype kept (the template's value where ``params`` lacks it, as for a
    bias-free checkpoint). Returns a state dict for ``load_state_dict``.
    Raises ``ku``'s errors for a missing module or weight and a shape that
    differs."""
    if isinstance(template, nn.Module):
        template = template.state_dict()

    def rec(tpl, src, path):
        out = {}
        for name, leaf in tpl.items():
            if isinstance(leaf, dict):
                if name not in src:
                    raise ValueError(f"params missing module "
                                     f"{'/'.join(path + (name,))}")
                out[name] = rec(leaf, src[name], path + (name,))
            elif name.endswith("_scale") and name[:-6] in tpl:
                continue  # produced with its base kernel below
            elif leaf.dtype == torch.int8:
                w = src.get(name)
                if w is None:
                    raise ValueError(f"params missing weight "
                                     f"{'/'.join(path + (name,))}")
                if tuple(w.shape) != tuple(leaf.shape):
                    raise ValueError(f"{'/'.join(path + (name,))}: shape "
                                     f"{tuple(w.shape)} != template "
                                     f"{tuple(leaf.shape)}")
                q, s = _quantize_leaf(w)
                out[name] = q
                out[name + "_scale"] = s
            else:
                out[name] = src[name] if name in src else leaf
        return out

    return _unnest(rec(_nest(template), _nest(params), ()))
