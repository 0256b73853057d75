"""The port's I/O extras on the CPU: Keras h5 files against ku's functions,
the ``torch.export`` round trip and its refusal of the hand-written
kernels, and the native C++ loader (built into ``ku_torch/_build/``).

- Keras h5: each package reads the files the other writes, and grafting
  the same file onto the same tree (synonyms, the unique-shape fallback,
  ``rename``, ``strict``, the reference RBM layout) gives ku's arrays and
  report. Trees are the port's, as ``tree_from_state_dict`` gives them.
- Export: a module and a function over it, exported and reloaded, equal
  the eager call; a module that reaches a kernel wrapper raises
  ``KernelTraceError`` naming that wrapper.
- The loader: the letterbox against the numpy oracle of
  tests/test_native_loader.py (within 1e-4, zero letterbox rows), submit
  order at 4 threads, PNG decode against ``read_png`` when built with
  libpng, a corrupt file counted, over-popping raising, and a build that
  fails naming the compiler's output. ku's loader is not called: it
  builds into ku/native/.
"""

import numpy as np
import pytest
import torch

from ku.io import keras_h5 as ku_h5
from ku_torch.io import (
    export_fn,
    flax_to_keras_layers,
    graft_keras_weights,
    load_exported,
    load_keras_h5_weights,
    load_reference_rbm_h5,
    save_keras_h5,
    save_reference_rbm_h5,
)
from ku_torch.kernels._build import KernelTraceError
from ku_torch.nn.transformer import Dense
from ku_torch.utility import load_variables, tree_from_state_dict

h5py = pytest.importorskip("h5py")
CPU = "cpu"


def _write_keras2_h5(path, layers, model_weights_group=True):
    """Keras 2's h5 weight layout, as tests/test_keras_h5.py writes it."""
    with h5py.File(path, "w") as f:
        root = f.create_group("model_weights") if model_weights_group else f
        root.attrs["layer_names"] = np.array([n.encode() for n in layers], dtype="S")
        for lname, weights in layers.items():
            g = root.create_group(lname)
            wnames = []
            for wname, arr in weights.items():
                full = f"{lname}/{wname}:0"
                g.create_dataset(full, data=arr)
                wnames.append(full.encode())
            g.attrs["weight_names"] = np.array(wnames, dtype="S")


def _arrays(rng, *shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


class TwoDense(torch.nn.Module):
    def __init__(self, a="dense_a", b="dense_b"):
        super().__init__()
        self.names = (a, b)
        self.add_module(a, Dense(4, 8, device=CPU))
        self.add_module(b, Dense(8, 2, device=CPU))

    def forward(self, x):
        a, b = (getattr(self, n) for n in self.names)
        return b(torch.relu(a(x)))


def _tree(module):
    return tree_from_state_dict(module.state_dict())


def _equal_trees(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], dict):
            _equal_trees(got[k], want[k])
        else:
            g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
            np.testing.assert_array_equal(g, np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("model_weights_group", [True, False])
def test_load_matches_ku(tmp_path, model_weights_group):
    rng = np.random.default_rng(0)
    k1, b1, k2, b2 = _arrays(rng, (4, 8), (8,), (8, 2), (2,))
    path = str(tmp_path / "m.h5")
    _write_keras2_h5(path, {"dense_a": {"kernel": k1, "bias": b1},
                            "dense_b": {"kernel": k2, "bias": b2}}, model_weights_group)
    _equal_trees(load_keras_h5_weights(path), ku_h5.load_keras_h5_weights(path))


def test_graft_onto_a_port_module_matches_ku(tmp_path):
    """Grafted arrays and report equal ku's on the same tree; the grafted
    tree loads strictly and computes the Keras model's function."""
    rng = np.random.default_rng(1)
    k1, b1, k2, b2 = _arrays(rng, (4, 8), (8,), (8, 2), (2,))
    path = str(tmp_path / "m.h5")
    _write_keras2_h5(path, {"dense_a": {"kernel": k1, "bias": b1},
                            "dense_b": {"kernel": k2, "bias": b2}})
    model = TwoDense()
    tree = _tree(model)
    got, report = graft_keras_weights(tree, load_keras_h5_weights(path), strict=True)
    want, ku_report = ku_h5.graft_keras_weights(tree, ku_h5.load_keras_h5_weights(path),
                                                strict=True)
    assert report == ku_report and len(report["grafted"]) == 4
    _equal_trees(got, want)
    load_variables(model, {"params": got})
    x = rng.standard_normal((3, 4)).astype(np.float32)
    np.testing.assert_allclose(model(torch.from_numpy(x)).detach().numpy(),
                               np.maximum(x @ k1 + b1, 0.0) @ k2 + b2, rtol=1e-5, atol=1e-5)


def test_graft_rename_shape_fallback_and_tensor_leaves(tmp_path):
    """A renamed layer whose weights have other names, found by unique
    shape; tensor leaves come back as tensors of their dtype; the loaded
    dict is not changed, so a second graft finds the same arrays."""
    rng = np.random.default_rng(2)
    k, b = _arrays(rng, (4, 8), (8,))
    path = str(tmp_path / "w.h5")
    _write_keras2_h5(path, {"old_name": {"some_matrix": k, "some_vec": b}},
                     model_weights_group=False)
    loaded = load_keras_h5_weights(path)
    model = TwoDense(a="new_name")
    params = {"new_name": dict(model.new_name.named_parameters())}
    got, report = graft_keras_weights(params, loaded, rename={"new_name": "old_name"},
                                      strict=True)
    want, ku_report = ku_h5.graft_keras_weights({"new_name": _tree(model.new_name)},
                                                ku_h5.load_keras_h5_weights(path),
                                                rename={"new_name": "old_name"}, strict=True)
    assert report == ku_report
    assert isinstance(got["new_name"]["kernel"], torch.Tensor)
    assert got["new_name"]["kernel"].dtype == torch.float32
    _equal_trees(got, want)
    again, _ = graft_keras_weights(params, loaded, rename={"new_name": "old_name"},
                                   strict=True)
    _equal_trees(again, want)
    assert set(loaded["old_name"]) == {"some_matrix", "some_vec"}


def test_synonyms_strict_and_unmatched_like_ku(tmp_path):
    """Keras' names for flax's (rbm_weight / rbm_hidden_bias, gamma,
    moving_mean, moving_variance); an ambiguous leaf and a layer absent from
    the file stay unmatched, as in ku, and ``strict`` raises in both."""
    rng = np.random.default_rng(3)
    w, bh, g, mm, mv, e1, e2 = _arrays(rng, (6, 3), (3,), (3,), (3,), (3,), (5,), (5,))
    path = str(tmp_path / "s.h5")
    _write_keras2_h5(path, {
        "rbm": {"rbm_weight": w, "rbm_hidden_bias": bh},
        "bn": {"gamma": g, "moving_mean": mm, "moving_variance": mv},
        "amb": {"p": e1, "q": e2},
    })
    tree = {"rbm": {"kernel": np.zeros((6, 3), np.float32), "bias": np.zeros(3, np.float32)},
            "bn": {"scale": np.ones(3, np.float32), "mean": np.zeros(3, np.float32),
                   "var": np.ones(3, np.float32)},
            "amb": {"x": np.zeros(5, np.float32)},
            "absent": {"kernel": np.zeros((2, 2), np.float32)}}
    got, report = graft_keras_weights(tree, load_keras_h5_weights(path))
    want, ku_report = ku_h5.graft_keras_weights(tree, ku_h5.load_keras_h5_weights(path))
    assert report == ku_report
    assert sorted(report["unmatched"]) == ["absent/kernel", "amb/x"]
    _equal_trees(got, want)
    np.testing.assert_array_equal(got["rbm"]["kernel"], w)
    np.testing.assert_array_equal(got["bn"]["var"], mv)
    for graft, loaded in ((graft_keras_weights, load_keras_h5_weights(path)),
                          (ku_h5.graft_keras_weights, ku_h5.load_keras_h5_weights(path))):
        with pytest.raises(ValueError, match="unmatched"):
            graft(tree, loaded, strict=True)


def test_files_cross_both_ways(tmp_path):
    """The port's writer read by ku and ku's writer read by the port, bit
    for bit; ``flax_to_keras_layers`` flattens a nested tree (tensors or
    numpy) as ku's does."""
    rng = np.random.default_rng(4)
    nested = {"dense_a": {"kernel": torch.from_numpy(_arrays(rng, (4, 8))[0]),
                          "bias": torch.zeros(8)},
              "block": {"inner": {"kernel": torch.from_numpy(_arrays(rng, (8, 4))[0]),
                                  "bias": torch.ones(4)}}}
    layers = flax_to_keras_layers(nested)
    want = ku_h5.flax_to_keras_layers(tree_from_state_dict(
        {"dense_a.kernel": nested["dense_a"]["kernel"], "dense_a.bias": nested["dense_a"]["bias"],
         "block.inner.kernel": nested["block"]["inner"]["kernel"],
         "block.inner.bias": nested["block"]["inner"]["bias"]}))
    _equal_trees(layers, want)
    assert set(layers) == {"dense_a", "block.inner"}
    ours, theirs = str(tmp_path / "port.h5"), str(tmp_path / "ku.h5")
    save_keras_h5(ours, layers)
    ku_h5.save_keras_h5(theirs, want)
    _equal_trees(ku_h5.load_keras_h5_weights(ours), want)
    _equal_trees(load_keras_h5_weights(theirs), want)


def test_reference_rbm_layout_both_ways(tmp_path):
    """The reference RBM's file: rbm_weight and rbm_hidden_bias only, the
    visible bias back as zeros, in both directions; the loaded parameters
    drive the port's RBM."""
    from ku_torch.ebm import RBM

    rng = np.random.default_rng(5)
    params = dict(zip(("rbm_weight", "hidden_bias", "visible_bias"),
                      _arrays(rng, (64, 16), (16,), (64,))))
    ours, theirs = str(tmp_path / "port_rbm.h5"), str(tmp_path / "ku_rbm.h5")
    save_reference_rbm_h5({k: torch.from_numpy(v) for k, v in params.items()}, ours)
    ku_h5.save_reference_rbm_h5(params, theirs)
    for path in (ours, theirs):
        for load in (load_reference_rbm_h5, ku_h5.load_reference_rbm_h5):
            back = load(path)
            np.testing.assert_array_equal(back["rbm_weight"], params["rbm_weight"])
            np.testing.assert_array_equal(back["hidden_bias"], params["hidden_bias"])
            assert (back["visible_bias"] == 0).all()
    with h5py.File(ours, "r") as f:
        assert sorted(f["rbm"].attrs["weight_names"].astype(str)) == [
            "rbm/rbm_hidden_bias:0", "rbm/rbm_weight:0"]
    with pytest.raises(KeyError):
        load_reference_rbm_h5(ours, layer_name="nope")
    rbm = RBM({"lr": 1e-3, "batch_size": 8, "epochs": 1}, 16, input_dim=64, device=CPU)
    rbm.params = {k: torch.from_numpy(v) for k, v in load_reference_rbm_h5(ours).items()}
    assert rbm.transform(rng.integers(0, 2, size=(4, 64)).astype(np.float32)).shape == (4, 16)


# -- export -----------------------------------------------------------------------------


class BNNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        from ku_torch.nn import BatchNorm

        self.Dense_0 = Dense(6, 5, device=CPU, generator=torch.Generator().manual_seed(0))
        self.BatchNorm_0 = BatchNorm(5, device=CPU)
        with torch.no_grad():
            self.BatchNorm_0.mean.uniform_(-1, 1)
            self.BatchNorm_0.var.uniform_(0.5, 2)

    def forward(self, x, deterministic: bool = True):
        return torch.tanh(self.BatchNorm_0(self.Dense_0(x), deterministic))


@pytest.mark.parametrize("as_function", [False, True])
def test_export_round_trip(tmp_path, as_function):
    net = BNNet()
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((3, 6)).astype(np.float32))
    fn = (lambda v: net(v, deterministic=True)) if as_function else net
    path = str(tmp_path / "net.pt2")
    export_fn(fn, (x,), path)
    loaded = load_exported(path)
    x2 = x * 2.0
    for v in (x, x2):
        np.testing.assert_allclose(loaded.call(v).detach().numpy(),
                                   net(v).detach().numpy(), rtol=1e-6, atol=0)


def _flash(q):
    from ku_torch.kernels import flash_attention as fa

    return fa.flash_fwd_cuda(q, q, q)[0]


def _decode(q):
    from ku_torch.kernels import decode_attention as da

    k = q[:, :, 0, :, None].expand(-1, -1, -1, 8).contiguous()  # (B, Hkv, D, S)
    return da.decode_attention_cuda(q, k, k, torch.full((q.shape[0],), 8, dtype=torch.int32))


@pytest.mark.parametrize("wrapper,call", [("flash_fwd_cuda", _flash),
                                          ("decode_attention_cuda", _decode)])
def test_export_refuses_a_kernel_wrapper_by_name(tmp_path, wrapper, call):
    """A module whose path reaches a hand-written kernel's wrapper cannot
    be traced: the export raises naming the wrapper, and writes nothing."""
    class Net(torch.nn.Module):
        def forward(self, q):
            return call(q)

    q = torch.zeros(1, 2, 8, 16) if wrapper == "flash_fwd_cuda" else torch.zeros(1, 2, 1, 16)
    path = tmp_path / "k.pt2"
    with pytest.raises(KernelTraceError, match=wrapper):
        export_fn(Net(), (q,), str(path))
    assert not path.exists()


# -- the native loader ---------------------------------------------------------------------

from ku_torch import native  # noqa: E402


@pytest.fixture
def needs_loader():
    """Build the loader here, inside the test: a build decided at import
    time could give the test workers different collections."""
    if not native.available():
        pytest.skip(f"the native loader does not build here: {native.build_error()}")


def _bilinear_oracle(img, oh, ow):
    """tests/test_native_loader.py's half-pixel bilinear oracle."""
    ih, iw, c = img.shape
    out = np.zeros((oh, ow, c), np.float32)
    for y in range(oh):
        sy = max((y + 0.5) * ih / oh - 0.5, 0.0)
        y0 = int(sy)
        y1 = min(y0 + 1, ih - 1)
        fy = sy - y0
        for x in range(ow):
            sx = max((x + 0.5) * iw / ow - 0.5, 0.0)
            x0 = int(sx)
            x1 = min(x0 + 1, iw - 1)
            fx = sx - x0
            top = img[y0, x0] + (img[y0, x1] - img[y0, x0]) * fx
            bot = img[y1, x0] + (img[y1, x1] - img[y1, x0]) * fx
            out[y, x] = top + (bot - top) * fy
    return out


def letterbox_oracle(img, oh, ow):
    """The loader's output by the oracle: the aspect-kept resize, centred,
    in [-1, 1], zeros around it."""
    ih, iw, _ = img.shape
    f32 = np.float32  # the size in float32, as loader.cpp computes it
    scale = min(f32(oh) / f32(ih), f32(ow) / f32(iw))
    rh, rw = min(int(f32(ih) * scale), oh), min(int(f32(iw) * scale), ow)
    top, left = (oh - rh) // 2, (ow - rw) // 2
    out = np.zeros((oh, ow, img.shape[2]), np.float32)
    out[top:top + rh, left:left + rw] = (
        _bilinear_oracle(img.astype(np.float32), rh, rw) * (2.0 / 255.0) - 1.0)
    return out, (top, left, rh, rw)


def test_loader_builds_into_the_port(needs_loader):
    from pathlib import Path

    lib = Path(native.load()._name)
    assert lib.parent == Path(native.__file__).resolve().parent.parent / "_build"
    assert lib.name.startswith("libku_loader_") and lib.suffix == ".so"
    assert lib == native.library_path(bool(native.load().ku_loader_has_png()))


@pytest.mark.parametrize("shape", [(37, 53, 3), (53, 37, 3), (20, 20, 3)])
def test_loader_matches_the_oracle(needs_loader, shape):
    img = np.random.default_rng(7).integers(0, 256, size=shape).astype(np.uint8)
    pipe = native.NativeImagePipeline(out_h=32, out_w=32, n_threads=1)
    pipe.submit(img)
    out = pipe.get()
    pipe.close()
    want, (top, left, rh, rw) = letterbox_oracle(img, 32, 32)
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4)
    assert np.abs(out[:top]).max(initial=0) == 0.0
    assert np.abs(out[top + rh:]).max(initial=0) == 0.0
    assert np.abs(out[:, :left]).max(initial=0) == 0.0


def test_loader_keeps_submit_order_at_4_threads(needs_loader):
    n = 48
    pipe = native.NativeImagePipeline(out_h=8, out_w=8, n_threads=4, capacity=64)
    for i in range(n):
        size = 8 if i % 2 == 0 else 300
        pipe.submit(np.full((size, size, 3), i, np.uint8))
    for i in range(n):
        out = pipe.get()
        assert int(round((out[4, 4, 0] + 1.0) * 255.0 / 2.0)) == i
    assert pipe.pending() == 0
    pipe.close()


def test_loader_overpop_raises(needs_loader):
    pipe = native.NativeImagePipeline(out_h=8, out_w=8, n_threads=2)
    pipe.submit(np.zeros((8, 8, 3), np.uint8))
    pipe.get()
    with pytest.raises(RuntimeError, match="no result"):
        pipe.get()
    with pytest.raises(ValueError):
        pipe.submit(np.zeros((8, 8), np.uint8))
    pipe.close()


def test_loader_decodes_pngs_like_read_png(needs_loader, tmp_path):
    """submit_file (libpng in the workers) equals submit of the image that
    ``read_png`` decodes, in order; a corrupt file gives a zeroed image in
    its slot and counts in errors()."""
    from ku_torch.image_utils import read_png, write_png

    pipe = native.NativeImagePipeline(out_h=16, out_w=16, n_threads=2)
    if not pipe.supports_files():
        pipe.close()
        pytest.skip("loader built without libpng")
    rng = np.random.default_rng(8)
    paths = []
    for i in range(6):
        p = str(tmp_path / f"img_{i}.png")
        write_png(p, rng.integers(0, 256, size=(24 + 4 * i, 20, 3), dtype=np.uint8))
        paths.append(p)
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png at all")
    for p in paths[:3] + [str(bad)] + paths[3:]:
        pipe.submit_file(p)
    from_files = pipe.get_batch(7)
    assert pipe.errors() == 1
    assert np.abs(from_files[3]).max() == 0.0
    for p in paths:
        pipe.submit(read_png(p))
    from_memory = pipe.get_batch(6)
    np.testing.assert_allclose(np.delete(from_files, 3, axis=0), from_memory, rtol=0, atol=0)
    pipe.close()


def test_failed_build_names_the_compiler_output(tmp_path, monkeypatch):
    """A source that does not compile raises with g++'s message, for both
    builds, and leaves no library or temporary file behind."""
    bad = tmp_path / "loader.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        native.load()
    assert "with libpng" in str(err.value) and "without libpng" in str(err.value)
    assert "error" in str(err.value)
    assert not native.available() and "g++ failed" in native.build_error()
    assert list((tmp_path / "_build").iterdir()) == []
