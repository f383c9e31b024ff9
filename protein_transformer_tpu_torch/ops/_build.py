"""Build and load the port's hand-written CUDA kernels.

Each kernel library is one ``csrc/<name>.cu`` file with a plain C
interface; it may include the ``csrc/*.cuh`` headers. It is compiled with
``nvcc`` for Hopper (``sm_90a``) into a shared library at first use, under
``build/torch_kernels/`` at the root of the checkout, and loaded with
``ctypes``. The library's file name carries a hash of the source, the
headers and the flags, so an edited source or header is rebuilt and a stale
library is never loaded. A failed build raises; nothing falls back to a
plain version. What ``ptxas -v`` says of each kernel (registers, shared
memory, spills) is kept beside the library (``ptxas_log``). Each op module
picks its path with ``resolve_impl`` and calls its library through
``launch``.

Nothing here runs at import time: the CPU tests import this module on
machines that have no CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
IMPLS = ("auto", "cuda", "torch")


def resolve_impl(impl: str, device: torch.device, what: str) -> str:
    """'auto' -> 'cuda' for tensors on a CUDA device, else 'torch'; raises
    for a value outside IMPLS, naming the op ``what``."""
    if impl not in IMPLS:
        raise ValueError(f"unknown {what} impl {impl!r}; expected one of "
                         f"{IMPLS}")
    if impl == "auto":
        return "cuda" if torch.device(device).type == "cuda" else "torch"
    return impl


def find_nvcc() -> str:
    """Path of ``nvcc``: $CUDA_HOME/bin, then $PATH, then DEFAULT_NVCC."""
    cuda_home = os.environ.get("CUDA_HOME")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(DEFAULT_NVCC)
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "cannot build the port's CUDA kernels: nvcc not found (looked in "
        "$CUDA_HOME/bin, $PATH and " + str(DEFAULT_NVCC) + "). Install the "
        "CUDA toolkit or set CUDA_HOME.")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` into a shared library; return its path."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if out.is_file():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {src.name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    _log_path(out).write_text(proc.stderr)
    os.replace(tmp, out)
    return out


def _log_path(lib: Path) -> Path:
    return lib.with_name(lib.name + ".ptxas.txt")


def ptxas_log(name: str) -> str:
    """What ptxas printed when ``build(name)`` compiled the library: each
    kernel's registers, shared memory and spill bytes."""
    return _log_path(build(name)).read_text()


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library ``name``, once per
    process."""
    return ctypes.CDLL(str(build(name)))


def launch(lib: ctypes.CDLL, name: str, fn: str, device, *args) -> None:
    """Call ``fn`` of the loaded library ``name`` with ``args`` and the
    current stream of ``device``; raise with the library's
    ``<name>_error_string`` on a non-zero CUDA error code."""
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = getattr(lib, fn)(*args, stream)
    if err:
        raise RuntimeError(f"{fn} kernel launch failed: "
                           + getattr(lib, f"{name}_error_string")(err)
                           .decode())
