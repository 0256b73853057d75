"""Autoencoder construction by structural encoder reversal (port of
``ku/backprop/autoencoder.py``).

The decoder is not designed by hand: it mirrors an encoder declared as a
:class:`~ku_torch.engine_ext.spec.LayerSpec` list, layer by layer from the
innermost, with the shapes from :func:`~ku_torch.engine_ext.spec.infer_shapes`:
Dense → Dense(input dim); ``dense_bn`` → the same composite; a conv1d
(strided: upsampling first) → a same-shape conv1d; conv2d / conv3d → their
transposes at the same strides; GCN → GCN(d_in); flatten → reshape back;
activations mirror themselves; anything else raises.

Where torch differs: modules build their parameters eagerly, so the
decoder's :class:`Stack` is sized from the encoder's output shape, and
:class:`SymSkipAutoencoder` sizes each mirror group from the concatenated
input it receives. Parameter names stay ``ku``'s: ``encoder`` / ``decoder``
children for :class:`Autoencoder`, the spec names directly for
:class:`SymSkipAutoencoder`.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ku_torch.engine_ext.spec import (
    LayerSpec,
    Stack,
    _apply_layer,
    _build,
    _out_shape,
    infer_shapes,
    spec,
)


def _reverse_one(s: LayerSpec, in_shape: Tuple[int, ...],
                 out_shape: Tuple[int, ...]) -> Tuple[LayerSpec, ...]:
    """Mirror one spec. ``in_shape`` / ``out_shape``: the ENCODER layer's
    shapes; the emitted decoder specs map out_shape → in_shape."""
    c = s.cfg
    rname = f"{s.name}_rev"
    if s.kind == "dense":
        return (spec("dense", rname, units=in_shape[-1], activation=c.get("activation")),)
    if s.kind == "dense_bn":
        return (spec("dense_bn", rname, units=in_shape[-1], activation=c.get("activation"),
                     dropout_rate=c.get("dropout_rate")),)
    if s.kind in ("conv1d", "separable_conv1d"):
        strides = c.get("strides", 1)
        stride = strides[0] if isinstance(strides, (tuple, list)) else strides
        out = []
        if stride > 1:
            out.append(spec("upsampling1d", rname + "_up", size=stride))
        out.append(spec("conv1d", rname, filters=in_shape[-1], kernel_size=c["kernel_size"],
                        strides=1, padding="same", activation=c.get("activation")))
        return tuple(out)
    if s.kind in ("conv2d", "conv3d"):
        return (spec(f"{s.kind}_transpose", rname, filters=in_shape[-1],
                     kernel_size=c["kernel_size"], strides=c.get("strides", 1),
                     padding=c.get("padding", "same"), activation=c.get("activation")),)
    if s.kind == "gcn":
        return (spec("gcn", rname, n_node=c["n_node"], d_out=in_shape[-1],
                     output_adjacency=c.get("output_adjacency", False),
                     activation=c.get("activation")),)
    if s.kind == "activation":
        return (s,)
    if s.kind == "flatten":
        return (spec("reshape", rname, target_shape=tuple(in_shape[1:])),)
    raise ValueError(f"layer kind {s.kind!r} is not reversible")


def reverse_groups(encoder_specs: Sequence[LayerSpec], input_shape: Tuple[int, ...]):
    """Per-encoder-layer mirror groups, innermost first: ``groups[j]``
    mirrors encoder layer ``n-1-j``."""
    shapes = infer_shapes(encoder_specs, input_shape)
    return tuple(_reverse_one(encoder_specs[i], shapes[i], shapes[i + 1])
                 for i in range(len(encoder_specs) - 1, -1, -1))


def reverse_specs(encoder_specs: Sequence[LayerSpec],
                  input_shape: Tuple[int, ...]) -> Tuple[LayerSpec, ...]:
    """The decoder's spec list, mirroring the encoder, output layer first."""
    return tuple(s for group in reverse_groups(encoder_specs, input_shape) for s in group)


def reverse_model(encoder_specs: Sequence[LayerSpec], input_shape: Tuple[int, ...], *,
                  device="cuda", dtype=None, generator=None) -> Stack:
    """The decoder :class:`Stack` for an encoder spec list, taking the
    encoder's output."""
    encoder_out = infer_shapes(encoder_specs, input_shape)[-1]
    return Stack(reverse_specs(encoder_specs, input_shape), encoder_out, device=device,
                 dtype=dtype, generator=generator)


def make_decoder_from_encoder(encoder_specs, input_shape, **kw) -> Stack:
    return reverse_model(encoder_specs, input_shape, **kw)


class Autoencoder(nn.Module):
    """Encoder + structurally reversed decoder: ``decoder(encoder(x))``."""

    def __init__(self, encoder_specs: Sequence[LayerSpec],
                 decoder_specs: Sequence[LayerSpec], input_shape: Tuple[int, ...], *,
                 device="cuda", dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.encoder = Stack(encoder_specs, input_shape, **kw)
        self.decoder = Stack(decoder_specs, self.encoder.output_shape, **kw)

    def forward(self, x, deterministic: bool = True):
        return self.decoder(self.encoder(x, deterministic=deterministic),
                            deterministic=deterministic)

    def encode(self, x, deterministic: bool = True):
        return self.encoder(x, deterministic=deterministic)

    def decode(self, z, deterministic: bool = True):
        return self.decoder(z, deterministic=deterministic)


def make_autoencoder_from_encoder(encoder_specs, input_shape, **kw) -> Autoencoder:
    return Autoencoder(tuple(encoder_specs), reverse_specs(encoder_specs, input_shape),
                       input_shape, **kw)


class SymSkipAutoencoder(nn.Module):
    """Autoencoder with U-Net-style symmetric skip connections: the mirror
    group of encoder layer i takes the previous group's output concatenated
    on the channel axis with encoder layer i's output (the innermost group
    takes the code alone). Layers are named by their specs."""

    def __init__(self, encoder_specs: Sequence[LayerSpec],
                 decoder_groups: Sequence[Sequence[LayerSpec]], input_shape: Tuple[int, ...],
                 *, device="cuda", dtype=None, generator=None):
        super().__init__()
        self.encoder_specs = tuple(encoder_specs)
        self.decoder_groups = tuple(tuple(g) for g in decoder_groups)
        kw = dict(device=device, dtype=dtype, generator=generator)
        enc_shapes = infer_shapes(self.encoder_specs, input_shape)
        for s, shape in zip(self.encoder_specs, enc_shapes):
            self._add(s, shape, kw)
        n = len(self.encoder_specs)
        shape = enc_shapes[-1]
        for j, group in enumerate(self.decoder_groups):
            if j > 0:
                skip = enc_shapes[n - j]  # the output of encoder layer n-1-j
                shape = tuple(shape[:-1]) + (shape[-1] + skip[-1],)
            for s in group:
                self._add(s, shape, kw)
                shape = _out_shape(s, shape, None)

    def _add(self, s, shape, kw):
        layer = _build(s, shape, **kw)
        if layer is not None:
            self.add_module(s.name, layer)

    def _run(self, s, x, deterministic):
        return _apply_layer(s, self._modules.get(s.name), x, None, deterministic)

    def forward(self, x, deterministic: bool = True):
        outs = []
        for s in self.encoder_specs:
            x = self._run(s, x, deterministic)
            outs.append(x)
        n = len(self.encoder_specs)
        for j, group in enumerate(self.decoder_groups):
            if j > 0:
                x = torch.cat([x, outs[n - 1 - j]], dim=-1)
            for s in group:
                x = self._run(s, x, deterministic)
        return x


def make_autoencoder_with_sym_sc(encoder_specs, input_shape, **kw) -> SymSkipAutoencoder:
    return SymSkipAutoencoder(tuple(encoder_specs), reverse_groups(encoder_specs, input_shape),
                              input_shape, **kw)
