"""Build and load the port's CUDA kernels.

Each source in ``csrc/`` is compiled by its own plain ``nvcc``
process, all started together, and the objects are linked into one
shared library with a C interface (no PyTorch headers, so the build
takes seconds), loaded with ``ctypes``.  The library lives in
``_build/`` (ignored by git) under a name keyed on a hash of the
sources, so a changed source is rebuilt at first use and an unchanged
one is loaded as it is.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the kernels' launch functions (see csrc/*.cu)
_SIGNATURES = {
    "uvic_fct_tracer_step": [_P] * 16 + [_I] * 4 + [_F, _I, _I, _P],
    "uvic_congrad": [_P] * 12 + [_I] * 8 + [_F, _F, _P],
    "uvic_congrad_max_clusters": [_I, _I],
    "uvic_fct_tracer_blocks_per_sm": [_I, _I],
    "uvic_region_means_apply": [_P] * 4 + [_I] * 5 + [_P],
    "uvic_region_means_blocks_per_sm": [_I, _I, _I],
}


class _Library:
    """The loaded shared library, built on first use."""

    def __init__(self):
        self.lib = None
        self.build_seconds = None
        self.build_log = ""

    def get(self):
        if self.lib is None:
            self._load()
        return self.lib

    def _load(self):
        srcs = sorted(CSRC.glob("*.cu"))
        digest = hashlib.sha256()
        for p in srcs + sorted(CSRC.glob("*.cuh")) + [Path(__file__)]:
            digest.update(p.name.encode())
            digest.update(p.read_bytes())
        so = BUILD / f"libuvic_kernels_{digest.hexdigest()[:16]}.so"
        t0 = time.perf_counter()
        if not so.exists():
            nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
            BUILD.mkdir(exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            objs = [tmp.with_name(f"{tmp.name}.{s.stem}.o") for s in srcs]
            procs = [subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for s, o in zip(srcs, objs)]
            self.build_log = "".join(p.communicate()[0] for p in procs)
            try:
                if any(p.returncode for p in procs):
                    raise RuntimeError("nvcc failed:\n" + self.build_log)
                link = subprocess.run(
                    [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                    capture_output=True, text=True)
                self.build_log += link.stdout + link.stderr
                if link.returncode != 0:
                    raise RuntimeError("nvcc failed:\n" + self.build_log)
            finally:
                for o in objs:
                    o.unlink(missing_ok=True)
            os.replace(tmp, so)
        self.build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self.lib = lib


LIBRARY = _Library()


def launch(name, *args):
    """Call a kernel's C launch function on PyTorch's current stream and
    raise if the launch was refused."""
    fn = getattr(LIBRARY.get(), name)
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def check_cuda(name, tensors, dtype=torch.float32):
    """Device, dtype, shape and contiguity checks of a kernel's inputs:
    ``tensors`` maps a name to ``(tensor, shape)``; a None tensor (an
    absent optional input) and a None shape are not checked.  Every
    tensor must lie on the current card, whose stream the kernel is
    launched on (``launch``): a pointer into another card's memory would
    be an illegal address there, or read silently through peer access."""
    card = None
    for key, (t, shape) in tensors.items():
        if t is None:
            continue
        if t.is_cuda and card is None:
            card = torch.cuda.current_device()
        if (t.is_cuda and t.device.index == card and t.dtype == dtype
                and t.is_contiguous()
                and (shape is None or t.shape == shape)):
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {key} is on {t.device}, not cuda")
        if t.device.index != card:
            raise ValueError(f"{name}: {key} is on {t.device}, the current "
                             f"card is cuda:{card}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} is {t.dtype}, not {dtype}")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"not {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")


def ptr(t):
    return None if t is None else t.data_ptr()
