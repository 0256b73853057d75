"""Layer-spec model representation (port of ``ku/engine_ext/spec.py``).

A model that wants structural operations (reversal into a decoder, the
progressive truncation, splicing) is declared as a sequence of
:class:`LayerSpec`s, plain data, and compiled to a module by
:class:`Stack`. Specs are frozen and hashable, with a JSON round trip.

Where torch differs from flax:

- torch builds parameters eagerly, so a :class:`Stack` takes the input's
  shape (batch axis included, as ``ku``'s ``infer_shapes`` takes it) and
  sizes each layer from the shape flowing into it. :func:`infer_shapes`
  builds each layer on the ``meta`` device and runs a meta tensor through
  it, where ``ku`` runs ``jax.eval_shape``.
- The Stack's submodules are named by their spec's ``name`` and keep
  flax's parameter names and layouts (Dense ``kernel`` (in, out); conv
  kernels (*spatial, in, out); ``dense_bn``'s ``Dense_0`` / ``BatchNorm_0``
  with buffers ``mean`` / ``var``; ``gcn_weight``), so its state dict is
  ``ku``'s variables under '.'-joined names and ``select_params`` /
  ``merge_params`` stay name filters.

Tensors are channels-last, as ``ku``'s are: ``flatten`` and ``reshape``
act on the logical (N, *spatial, C) order; ``conv*`` pad as XLA's SAME does
(asymmetric at stride 2 on odd sizes); ``conv*_transpose`` is
``lax.conv_transpose`` with the kernel unflipped; ``upsampling*`` repeats
each spatial axis.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ku_torch.initializers_ext.initializers import lecun_normal
from ku_torch.nn.common import normalize_tuple, resolve_activation
from ku_torch.nn.convolution import conv_nd, conv_transpose_nd
from ku_torch.nn.dense_composite import DenseBatchNormalization
from ku_torch.nn.gnn import GraphConvolutionNetwork
from ku_torch.nn.transformer import Dense


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer: ``kind`` selects the builder, ``config`` its kwargs."""

    kind: str
    name: str
    config: Tuple[Tuple[str, Any], ...] = ()

    @property
    def cfg(self) -> Dict[str, Any]:
        return dict(self.config)

    def with_config(self, **updates) -> "LayerSpec":
        cfg = self.cfg
        cfg.update(updates)
        return LayerSpec(self.kind, self.name, tuple(sorted(cfg.items())))

    def to_json(self):
        return {"kind": self.kind, "name": self.name, "config": self.cfg}

    @classmethod
    def from_json(cls, d):
        cfg = {k: tuple(v) if isinstance(v, list) else v for k, v in d["config"].items()}
        return cls(d["kind"], d["name"], tuple(sorted(cfg.items())))


def spec(kind: str, name: str, **config) -> LayerSpec:
    canon = {k: tuple(v) if isinstance(v, list) else v for k, v in config.items()}
    return LayerSpec(kind, name, tuple(sorted(canon.items())))


# -- builders ---------------------------------------------------------------

_CONV_RANK = {"conv1d": 1, "separable_conv1d": 1, "conv2d": 2, "conv3d": 3}
_CONV_T_RANK = {"conv1d_transpose": 1, "conv2d_transpose": 2, "conv3d_transpose": 3}
_FUNCTIONAL = ("activation", "flatten", "reshape", "upsampling1d", "upsampling2d",
               "upsampling3d")


class Conv(nn.Module):
    """flax ``nn.Conv`` (channels-last, ``transpose=False``) or
    ``nn.ConvTranspose`` (``transpose=True``): ``kernel`` (*k, in, out),
    lecun-normal, ``bias`` zeros."""

    def __init__(self, rank: int, in_features: int, features: int, kernel_size,
                 strides=1, padding: str = "SAME", use_bias: bool = True,
                 transpose: bool = False, *, device="cuda", dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rank, self.transpose = rank, transpose
        self.strides = normalize_tuple(strides, rank)
        self.padding = str(padding).upper()
        shape = normalize_tuple(kernel_size, rank) + (in_features, features)
        self.kernel = nn.Parameter(lecun_normal()(shape, generator, device, dtype))
        self.bias = (nn.Parameter(torch.zeros(features, device=device, dtype=dtype))
                     if use_bias else None)

    def forward(self, x):
        if self.transpose:
            y = conv_transpose_nd(x, self.kernel, self.strides, self.padding, self.rank)
        else:
            y = conv_nd(x, self.kernel, self.strides, self.padding, self.rank)
        return y if self.bias is None else y + self.bias


def _build(s: LayerSpec, in_shape: Tuple[int, ...], *, device="cuda", dtype=None,
           generator: Optional[torch.Generator] = None) -> Optional[nn.Module]:
    """The module of one spec, sized by the shape flowing into it; None for
    the functional kinds."""
    c, kind = s.cfg, s.kind
    kw = dict(device=device, dtype=dtype, generator=generator)
    if kind == "dense":
        return Dense(in_shape[-1], c["units"], use_bias=c.get("use_bias", True), **kw)
    if kind == "dense_bn":
        return DenseBatchNormalization(in_shape[-1], c["units"],
                                       activation=c.get("activation"),
                                       dropout_rate=c.get("dropout_rate"), **kw)
    if kind in _CONV_RANK or kind in _CONV_T_RANK:
        transpose = kind in _CONV_T_RANK
        rank = (_CONV_T_RANK if transpose else _CONV_RANK)[kind]
        return Conv(rank, in_shape[-1], c["filters"], c["kernel_size"],
                    strides=c.get("strides", 1), padding=c.get("padding", "SAME"),
                    use_bias=c.get("use_bias", True), transpose=transpose, **kw)
    if kind == "gcn":
        return GraphConvolutionNetwork(c["n_node"], in_shape[-1], c["d_out"],
                                       output_adjacency=c.get("output_adjacency", False),
                                       activation=c.get("activation"), **kw)
    if kind in _FUNCTIONAL:
        return None
    raise ValueError(f"unknown layer kind {kind!r}")


def _apply_functional(s: LayerSpec, x):
    c = s.cfg
    if s.kind == "activation":
        return resolve_activation(c["activation"])(x)
    if s.kind == "flatten":
        return x.reshape(x.shape[0], -1)
    if s.kind == "reshape":
        return x.reshape((x.shape[0],) + tuple(c["target_shape"]))
    if s.kind.startswith("upsampling"):
        rank = int(s.kind[-2])
        for axis, r in zip(range(1, rank + 1), normalize_tuple(c.get("size", 2), rank)):
            x = torch.repeat_interleave(x, r, dim=axis)
        return x
    raise AssertionError(s.kind)


def _apply_layer(s: LayerSpec, layer: Optional[nn.Module], x, adjacency,
                 deterministic: bool):
    """One spec on ``x``, as ``ku``'s Stack applies it: the functional
    kinds, then the layer with the spec's ``activation`` after it (but for
    ``dense_bn`` and ``gcn``, which apply their own); ``gcn`` reads the
    adjacency."""
    if s.kind in _FUNCTIONAL:
        return _apply_functional(s, x)
    if s.kind == "gcn":
        out = layer([x, adjacency])
        return out[0] if s.cfg.get("output_adjacency", False) else out
    if s.kind == "dense_bn":
        return layer(x, deterministic=deterministic)
    x = layer(x)
    act = s.cfg.get("activation")
    return resolve_activation(act)(x) if act is not None else x


def _out_shape(s: LayerSpec, in_shape, adjacency_shape) -> Tuple[int, ...]:
    """The output shape of one spec on ``in_shape``, from a meta tensor."""
    layer = _build(s, in_shape, device="meta")
    x = torch.empty(in_shape, device="meta")
    a = (torch.empty(adjacency_shape, device="meta") if adjacency_shape is not None
         else None)
    return tuple(_apply_layer(s, layer, x, a, True).shape)


def _adjacency_shape(specs, input_shape, adjacency_shape):
    if adjacency_shape is not None:
        return tuple(adjacency_shape)
    for s in specs:
        if s.kind == "gcn":
            n = s.cfg["n_node"]
            return (input_shape[0], n, n)
    return None


def infer_shapes(specs: Sequence[LayerSpec], input_shape: Tuple[int, ...],
                 adjacency_shape: Optional[Tuple[int, ...]] = None):
    """The shape flowing INTO each layer, then the final output shape: one
    more entry than ``specs``. Nothing is computed: each layer runs on the
    ``meta`` device."""
    adjacency_shape = _adjacency_shape(specs, input_shape, adjacency_shape)
    shapes = [tuple(input_shape)]
    for s in specs:
        shapes.append(_out_shape(s, shapes[-1], adjacency_shape))
    return shapes


class Stack(nn.Module):
    """Sequential model compiled from a spec tuple for inputs of
    ``input_shape`` (batch axis included; any batch size runs). Call as
    ``stack(x, deterministic=...)``, or ``stack([x, adjacency], ...)`` for
    GCN layers, which thread the adjacency through."""

    def __init__(self, specs: Sequence[LayerSpec], input_shape: Tuple[int, ...],
                 adjacency_shape: Optional[Tuple[int, ...]] = None, *, device="cuda",
                 dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.specs = tuple(specs)
        self.shapes = infer_shapes(self.specs, input_shape, adjacency_shape)
        for s, in_shape in zip(self.specs, self.shapes):
            layer = _build(s, in_shape, device=device, dtype=dtype, generator=generator)
            if layer is not None:
                self.add_module(s.name, layer)

    @property
    def output_shape(self) -> Tuple[int, ...]:
        return self.shapes[-1]

    def forward(self, x, deterministic: bool = True):
        adjacency = None
        if isinstance(x, (list, tuple)):
            x, adjacency = x
        for s in self.specs:
            x = _apply_layer(s, self._modules.get(s.name), x, adjacency, deterministic)
        return x
