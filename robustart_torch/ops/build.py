"""Build the port's hand-written CUDA kernels and bind them with ctypes.

Every kernel source ``csrc/<name>.cu`` has a plain C entry point and includes
no PyTorch header, so one ``nvcc`` call builds it into a shared library in
seconds. The library goes to ``build/kernels/`` inside the checkout (listed
in ``.gitignore``) under a name that carries a hash of the source and the
flags: a changed source is built anew, an unchanged one is found and reused.

- :func:`build` starts one ``nvcc`` for each named kernel whose library is
  missing, all at once, and waits for every one of them;
- :func:`library` builds one kernel if needed and loads it (once per
  process); each kernel module binds its entry point from it at first launch.

Flags: ``sm_90a`` (Hopper), ``-O3``, and no fast math. ``--cudart shared``
links the CUDA runtime that PyTorch has already loaded, so a kernel launches
on PyTorch's streams on the device that ``torch.cuda.device`` selects.
Nothing here runs when a module is imported: the CPU tests import every
module, and there is no ``nvcc`` on a machine without CUDA.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Iterable

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
# inside the checkout, listed in .gitignore
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNELS = ("fused_noise", "warp_bilinear", "motion_taps", "glass_shuffle", "chamfer",
           "linear_fused", "attention_core", "dwconv_ln", "token_mlp", "dense_block")
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
    "-Xcompiler", "-fPIC", "-shared", "--cudart", "shared",
)


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else on ``PATH``."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library is (or will be) built."""
    source = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(source + "\0".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str] = KERNELS) -> list[str]:
    """Build the named kernels' libraries that do not exist yet, one ``nvcc``
    each, all started together, and wait for all. Returns the names it
    built. Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
            jobs[name] = (proc, tmp, out)
        errors = []
        for name, (proc, tmp, out) in jobs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{name}.cu: nvcc exited with {proc.returncode}\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)  # atomic: a concurrent build finds it whole
    finally:
        for proc, _, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if errors:
        raise RuntimeError("building the CUDA kernels failed:\n" + "\n".join(errors))
    return list(jobs)


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """Kernel ``name``'s library, built at first use and loaded once."""
    build((name,))
    return ctypes.CDLL(str(library_path(name)))


def bind(name: str, entry: str, argtypes: list) -> ctypes._CFuncPtr:
    """C function ``entry`` of kernel ``name``, typed: it returns the
    ``cudaError_t`` of its launch as an int."""
    fn = getattr(library(name), entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


# the working-type argument of the kernels that take either type
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def check_aligned(t: torch.Tensor, what: str) -> None:
    """Raise unless ``t``'s data starts on 16 bytes (the kernels' vector loads)."""
    if t.data_ptr() % 16:
        raise ValueError(f"{what} must start on a 16-byte boundary")


def check_cuda_tensor(t: torch.Tensor, what: str, dtype: torch.dtype) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype``."""
    if t.device.type != "cuda":
        raise ValueError(f"{what} must be on cuda, not {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, not {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def launch(fn: ctypes._CFuncPtr, device: torch.device, *args) -> None:
    """Call a bound entry point on ``device``'s current stream; raise if the
    launch was refused."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed with cudaError {err}")
