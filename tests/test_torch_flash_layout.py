"""How the flash kernels' wrappers route a launch, without a card.

``flash_route`` picks the kernels by dtype and head width (bf16 up to 128
wide on the tensor cores, anything else on the CUDA cores), and
``flash_layout`` the layout in which a tensor-core launch reads q, k, v
(and dO): "a", rows unit-stride along the head; "b", the forward's k and v
read in place along the keys (the serving prefill's view of the slot-minor
cache); "c", anything else, which the wrapper copies into rows first. Both
are pure functions of shapes, strides, start addresses and dtypes, so they
run here on CPU tensors. On the card the C entries report the route and
layout they launched, and tests/test_torch_cuda.py and chip_smoke.py hold
that against these.
"""

import types

import pytest
import torch

from ku_torch.kernels import flash_attention as fa

BF = torch.bfloat16


def _rows(b, h, n, d):
    return torch.zeros(b, h, n, d, dtype=BF)


def _cache_view(b, hkv, d, slots):
    """The prefill's read of a (B, Hkv, D, S) slot-minor cache."""
    return torch.zeros(b, hkv, d, slots, dtype=BF).transpose(2, 3)


def _q_strided(b, h, n, d):
    return torch.zeros(b, h, n, 2 * d, dtype=BF)[..., ::2]


def _q_offset(b, h, n, d):
    """2 bytes off 16: one element into a flat buffer."""
    return torch.zeros(b * h * n * d + 1, dtype=BF)[1:].view(b, h, n, d)


# name: (q, k, v, dO or None, the layout, tensors a launch copies)
LAYOUTS = {
    "rows_contiguous": (lambda: (_rows(2, 4, 9, 64), _rows(2, 2, 9, 64), _rows(2, 2, 9, 64),
                                 None), "a", 0),
    "split_heads_views": (lambda: tuple(torch.zeros(2, 9, h, 64, dtype=BF).transpose(1, 2)
                                        for h in (4, 2, 2)) + (None,), "a", 0),
    "autograd_do_transposed": (lambda: (_rows(2, 4, 9, 64), _rows(2, 2, 9, 64),
                                        _rows(2, 2, 9, 64),
                                        torch.zeros(2, 9, 4, 64, dtype=BF).transpose(1, 2)),
                               "a", 0),
    "slot_minor_cache": (lambda: (_rows(2, 4, 9, 128), _cache_view(2, 2, 128, 64),
                                  _cache_view(2, 2, 128, 64), None), "b", 0),
    "slot_minor_cache_narrow_value": (lambda: (_rows(1, 2, 9, 40), _cache_view(1, 1, 40, 24),
                                               _cache_view(1, 1, 24, 24), None), "b", 0),
    "cache_in_the_backward": (lambda: (_rows(2, 4, 9, 128), _cache_view(2, 2, 128, 64),
                                       _cache_view(2, 2, 128, 64), _rows(2, 4, 9, 128)),
                              "c", 2),
    "cache_width_203": (lambda: (_rows(2, 4, 9, 128), _cache_view(2, 2, 128, 203),
                                 _cache_view(2, 2, 128, 203), None), "c", 2),
    "cache_from_slot_4": (lambda: (_rows(1, 2, 9, 64), _cache_view(1, 1, 64, 72)[:, :, 4:],
                                   _cache_view(1, 1, 64, 72)[:, :, 4:], None), "c", 2),
    "k_rows_v_cache": (lambda: (_rows(1, 2, 9, 64), _rows(1, 1, 64, 64),
                                _cache_view(1, 1, 64, 64), None), "c", 1),
    "q_strided": (lambda: (_q_strided(1, 4, 9, 64), _rows(1, 2, 9, 64), _rows(1, 2, 9, 64),
                           None), "c", 1),
    "q_offset_2_bytes": (lambda: (_q_offset(1, 2, 9, 64), _rows(1, 1, 9, 64),
                                  _rows(1, 1, 9, 64), _rows(1, 2, 9, 64)), "c", 1),
    "rows_72_bytes_apart": (lambda: (_rows(1, 2, 9, 36), _rows(1, 2, 9, 36),
                                     _rows(1, 2, 9, 12), _rows(1, 2, 9, 12)), "c", 4),
    "single_rows_36_wide": (lambda: (_rows(1, 1, 1, 36), _rows(1, 1, 9, 64)[:, :, :1, :36],
                                     _rows(1, 1, 1, 36), None), "a", 0),
}


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_flash_layout_of_each_stride_pattern(name):
    make, layout, copied = LAYOUTS[name]
    q, k, v, do = make()
    tensors = (q, k, v) + (() if do is None else (do,))
    assert fa.flash_layout(*tensors) == layout
    entry = types.SimpleNamespace(copies=0)
    got_layout, got = fa._for_mma(entry, *tensors)
    assert got_layout == layout and entry.copies == copied
    for t, g in zip(tensors, got):
        if layout == "c":
            assert fa._mma_ready(g) and g.shape == t.shape and torch.equal(g, t)
        assert (g is t) == (layout != "c" or fa._mma_ready(t))


@pytest.mark.parametrize("dtype,d,route", [
    (BF, 128, "mma"), (BF, 40, "mma"), (BF, 160, "f32"),
    (torch.float32, 64, "f32"), (torch.float32, 160, "f32"),
])
def test_flash_route_by_dtype_and_width(dtype, d, route):
    assert fa.flash_route(dtype, d) == route


@pytest.mark.parametrize("entry", ["fwd", "dq", "dkv"])
@pytest.mark.parametrize("refusal", ["heads", "window", "cpu"])
def test_flash_wrappers_refuse_without_a_card(entry, refusal):
    """Shapes are checked before devices, so what the kernels refuse is
    refused the same way on any device; CPU tensors never reach a kernel
    (and never fall back to the plain versions)."""
    q = torch.zeros(1, 4, 3, 8)
    k = torch.zeros(1, 3, 3, 8) if refusal == "heads" else q
    kw = dict(window=2) if refusal == "window" else {}
    lse = torch.zeros(1, 4, 3)
    call = {"fwd": lambda: fa.flash_fwd_cuda(q, k, k, **kw),
            "dq": lambda: fa.flash_bwd_dq_cuda(q, k, k, q, lse, lse, **kw),
            "dkv": lambda: fa.flash_bwd_dkv_cuda(q, k, k, q, lse, lse, **kw)}[entry]
    match = {"heads": "multiple", "window": "window requires", "cpu": "CUDA tensors"}[refusal]
    launches = (fa.flash_fwd_cuda.launches, fa.flash_bwd_dq_cuda.launches,
                fa.flash_bwd_dkv_cuda.launches)
    with pytest.raises(ValueError, match=match):
        call()
    assert (fa.flash_fwd_cuda.launches, fa.flash_bwd_dq_cuda.launches,
            fa.flash_bwd_dkv_cuda.launches) == launches
