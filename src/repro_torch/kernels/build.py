"""Build and load the port's CUDA kernels (plain C interface, ``ctypes``).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library under ``build/kernels/`` at the root of the checkout, named
by a hash of the source, the shared ``csrc/*.cuh`` headers and the flags,
so an edited source or header rebuilds and an
unchanged one loads at once. Nothing is built when a module is imported:
the first launch (or :func:`build_all`) builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
KERNELS = ("escrow_admit", "txn_megastep", "ramp_read", "lattice_merge",
           "flash_attention", "rwkv6_scan")

_loaded: dict[str, object] = {}   # kernel name -> its C entry point


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand is not None and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from csrc/ at first use")


def library_path(name: str) -> Path:
    # every source includes from csrc/, so a header edit rebuilds them all
    text = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = library_path(name)
    if out.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> str:
    if job is None:
        return ""
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)   # atomic: a concurrent build sees all or none
    return log


def build_all(names=KERNELS) -> dict[str, str]:
    """Build every named kernel, one ``nvcc`` per source, all started
    together. Returns each build's compiler log ('' when it was cached)."""
    jobs = {n: _start(n) for n in names}
    return {n: _finish(n, job) for n, job in jobs.items()}


def load(name: str, argtypes: list):
    """The C entry point ``<name>_launch`` of the kernel's shared library,
    built on first use; it returns a CUDA error code (``int``)."""
    fn = _loaded.get(name)
    if fn is None:
        _finish(name, _start(name))
        fn = getattr(ctypes.CDLL(str(library_path(name))), f"{name}_launch")
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _loaded[name] = fn
    return fn


def check(name: str, err: int) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def check_tensor(x, name: str, dtype, shape) -> None:
    """Raise unless ``x`` is a contiguous CUDA tensor of ``dtype`` and
    ``shape``: what a kernel's raw pointer arguments assume."""
    if x.device.type != "cuda" or x.dtype != dtype or \
            tuple(x.shape) != tuple(shape) or not x.is_contiguous():
        raise ValueError(f"{name}: want a contiguous CUDA {dtype} tensor of "
                         f"shape {tuple(shape)}, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
