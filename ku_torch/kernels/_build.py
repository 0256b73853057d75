"""Build a kernel source from ``ku_torch/csrc`` into a shared library.

Each kernel is one ``.cu`` file with a plain C interface, compiled by
``nvcc`` for ``sm_90a`` at first use into ``ku_torch/_build`` (git-ignored)
and loaded with ``ctypes`` by its wrapper. The library's file name carries
the hash of the source and of the headers it includes, so an edited
source or header is rebuilt and an unchanged one is not. Every kernel
keeps its own library, so a failed build names its own source.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Iterable, List, Tuple

BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class KernelTraceError(RuntimeError):
    """A hand-written kernel's wrapper was reached by a tracer
    (``torch.export``, ``torch.compile``): the kernels launch through
    ``ctypes`` on ``data_ptr()``, which fake tensors do not have."""


def refuse_tracing(name: str, *tensors) -> None:
    """Raise :class:`KernelTraceError` naming the wrapper ``name`` if any of
    ``tensors`` is a fake tensor or a compiler is tracing. The kernels are
    not registered as ``torch.library`` custom ops with fake
    implementations, so a traced program cannot hold them; the wrapper
    never swaps in its plain version instead."""
    import torch

    plain = (torch.Tensor, torch.nn.Parameter)
    if not torch.compiler.is_compiling() and all(type(t) in plain for t in tensors):
        return  # eager tensors: the usual case, a few type checks a launch
    from torch._subclasses.fake_tensor import is_fake

    if torch.compiler.is_compiling() or any(
            isinstance(t, torch.Tensor) and is_fake(t) for t in tensors):
        raise KernelTraceError(
            f"{name} launches a hand-written CUDA kernel through ctypes on data_ptr(), "
            "which torch.export / torch.compile cannot trace: its fake tensors have no "
            "storage. The kernels would need registering as torch.library custom ops "
            "with fake implementations (ROADMAP.md §2)")


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the kernels are built with the "
                           "CUDA toolkit at first use")
    return path


def library_path(source: Path, name: str, flags: Tuple[str, ...] = ()) -> Path:
    """The library's path, named by the hash of the source, of the headers
    it includes from its own directory (``#include "x.cuh"``) and of any
    extra compiler flags."""
    source = Path(source)
    text = source.read_bytes()
    h = hashlib.sha256(text)
    for header in re.findall(rb'^#include "([^"]+)"', text, re.M):
        h.update((source.parent / header.decode()).read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_many(specs: Iterable[tuple]) -> List[Tuple[Path, str]]:
    """Compile every ``(source, name)`` or ``(source, name, flags)`` not
    built yet, one ``nvcc`` process per spec, all started together (flags:
    extra compiler arguments, such as ``("-DCD_PROBE",)``).

    Returns one (library path, compiler output) per spec, in order: the
    output of the build that made the library, kept beside it as
    ``<library>.log`` (empty when that file is gone). Raises naming the
    first source that failed."""
    specs = [(Path(spec[0]), spec[1], tuple(spec[2]) if len(spec) > 2 else ())
             for spec in specs]
    jobs = []
    for src, name, flags in specs:
        lib = library_path(src, name, flags)
        if lib.exists():
            jobs.append((src, lib, None, None))
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen([nvcc(), *NVCC_FLAGS, *flags, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        jobs.append((src, lib, tmp, proc))
    results, failed = [], []
    for src, lib, tmp, proc in jobs:
        log = lib.with_suffix(".log")
        if proc is None:
            results.append((lib, log.read_text() if log.exists() else ""))
            continue
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {src}:\n{out}")
            continue
        log.write_text(out)
        os.replace(tmp, lib)
        results.append((lib, out))
    if failed:
        raise RuntimeError("\n".join(failed))
    return results


def build(source: Path, name: str, flags: Tuple[str, ...] = ()) -> Tuple[Path, str]:
    """Compile one source if it has not been built yet.

    Returns (library path, compiler output), as :func:`build_many`."""
    return build_many([(source, name, flags)])[0]
