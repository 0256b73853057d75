"""The threaded C++ image loader (port of ``ku/native``), bound with ctypes.

:class:`NativeImagePipeline` wraps ``ku_torch/csrc/loader.cpp`` (a copy of
``ku``'s: a thread pool that resizes uint8 HWC images into aspect-preserving
letterboxes in [-1, 1] off the GIL, delivered in submit order; with libpng,
it also decodes PNG files in the workers). See the source's header comment.

The library is built with ``g++`` at first use into ``ku_torch/_build/``
(git-ignored), named by the hash of the source and of the compiler flags:
first with libpng (``-DKU_HAS_PNG -lpng -lz``), then, if that fails,
without it; :meth:`NativeImagePipeline.supports_files` says which build
loaded. A build is written to a temporary file and published with one
``os.replace``, so concurrent first uses (test workers) never load a half
written library. ``ku`` builds with ``-march=native``; here the flags name
no host's instruction set, since a built library can travel with a copied
checkout to another machine. A failed build raises with the compiler's
output; :func:`available` reports it as False and :func:`build_error`
returns that output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "loader.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
_PNG = ("-DKU_HAS_PNG", "-lpng", "-lz")
_lock = threading.Lock()
_lib = None
_error: str | None = None


def library_path(png: bool) -> Path:
    """The library's path: ``libku_loader_<hash>.so``, the hash over the
    source and the flags of that build."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_FLAGS + (_PNG if png else ())).encode())
    return _BUILD_DIR / f"libku_loader_{h.hexdigest()[:16]}.so"


def _compile(png: bool) -> Path:
    """Build one variant unless it exists; raises with g++'s output."""
    out = library_path(png)
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=out.name + ".", suffix=".tmp", dir=_BUILD_DIR)
    os.close(fd)
    try:
        cmd = ["g++", *_FLAGS, str(_SRC), "-o", tmp, *(_PNG if png else ())]
        run = subprocess.run(cmd, capture_output=True, text=True)
        if run.returncode != 0:
            raise RuntimeError(f"g++ failed ({' '.join(cmd)}):\n{run.stderr.strip()}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.ku_loader_create.restype = ctypes.c_void_p
    lib.ku_loader_create.argtypes = [ctypes.c_int] * 5
    lib.ku_loader_submit.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
                                     ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.ku_loader_get.restype = ctypes.c_int
    lib.ku_loader_get.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
    lib.ku_loader_pending.restype = ctypes.c_long
    lib.ku_loader_pending.argtypes = [ctypes.c_void_p]
    lib.ku_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.ku_loader_submit_file.restype = ctypes.c_int
    lib.ku_loader_submit_file.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ku_loader_errors.restype = ctypes.c_long
    lib.ku_loader_errors.argtypes = [ctypes.c_void_p]
    lib.ku_loader_has_png.restype = ctypes.c_int
    lib.ku_loader_has_png.argtypes = []
    return lib


def load() -> ctypes.CDLL:
    """The loader's library, built if needed (libpng first); raises
    ``RuntimeError`` with both builds' compiler output if neither builds."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        errors = []
        for png in (True, False):
            try:
                _lib = _bind(_compile(png))
                _error = None
                return _lib
            except (RuntimeError, OSError) as err:
                errors.append(f"[{'with' if png else 'without'} libpng] {err}")
        _error = "\n".join(errors)
        raise RuntimeError(f"native loader did not build:\n{_error}")


def available() -> bool:
    """Whether the library builds and loads here (the failure's compiler
    output is :func:`build_error`)."""
    try:
        load()
        return True
    except RuntimeError:
        return False


def build_error() -> str | None:
    return _error


class NativeImagePipeline:
    """Threaded native resize + normalize + prefetch.

    >>> pipe = NativeImagePipeline(out_h=128, out_w=128)
    >>> for img in raw_uint8_images: pipe.submit(img)
    >>> batch = pipe.get_batch(len(raw_uint8_images))  # (N, 128, 128, 3) in [-1, 1]
    """

    def __init__(self, out_h: int, out_w: int, channels: int = 3, n_threads: int = 4,
                 capacity: int = 64):
        self._lib = load()
        self.out_h, self.out_w, self.channels = out_h, out_w, channels
        self._handle = self._lib.ku_loader_create(n_threads, capacity, out_h, out_w, channels)

    @staticmethod
    def available() -> bool:
        return available()

    def submit(self, img: np.ndarray) -> None:
        """Enqueue one HWC uint8 image (any size and channels)."""
        img = np.ascontiguousarray(img, np.uint8)
        if img.ndim != 3:
            raise ValueError(f"submit takes an HWC image, got shape {img.shape}")
        h, w, c = img.shape
        self._lib.ku_loader_submit(self._handle,
                                   img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, c)

    def submit_file(self, path: str) -> None:
        """Enqueue a PNG file: read, libpng decode and resize all run in a
        worker. Needs a libpng build (:meth:`supports_files`). A file that
        does not decode gives a zeroed image in its place and counts in
        :meth:`errors`."""
        if self._lib.ku_loader_submit_file(self._handle, os.fsencode(path)) != 0:
            raise RuntimeError("native loader built without libpng; "
                               "decode in Python and use submit()")

    def supports_files(self) -> bool:
        """True when the loader was built with libpng."""
        return bool(self._lib.ku_loader_has_png())

    def errors(self) -> int:
        """Failed file decodes so far."""
        return int(self._lib.ku_loader_errors(self._handle))

    def get(self) -> np.ndarray:
        """Blocking pop of one (out_h, out_w, channels) float32 image in
        [-1, 1], in SUBMIT order. Raises if nothing is pending."""
        out = np.empty((self.out_h, self.out_w, self.channels), np.float32)
        if self._lib.ku_loader_get(self._handle,
                                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))) != 0:
            raise RuntimeError("native loader: no result available (nothing pending or "
                               "loader stopping)")
        return out

    def get_batch(self, n: int) -> np.ndarray:
        return np.stack([self.get() for _ in range(n)])

    def pending(self) -> int:
        return int(self._lib.ku_loader_pending(self._handle))

    def close(self):
        if self._handle:
            self._lib.ku_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
