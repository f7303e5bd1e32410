"""Build and load the port's CUDA kernels.

The kernels under ``mcmcpp_tpu_torch/csrc/`` are compiled by hand with
``nvcc`` for Hopper (``sm_90a``) into one shared library with a plain C
interface, loaded with :mod:`ctypes` (no PyTorch headers, so a build takes
seconds). The build runs at first use, never at import, and lands in
``build/kernels/`` beside the package; the library's file name carries a
hash of the sources and flags, so an edited ``.cu`` file rebuilds.

A missing ``nvcc`` or a failed compile raises: there is no fallback.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (neither on PATH nor under CUDA_HOME); the CUDA "
            "kernels of mcmcpp_tpu_torch need the CUDA toolkit to build"
        )
    return str(path)


def library_path():
    """Path of the shared library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmcmcpp_torch_kernels_{h.hexdigest()[:16]}.so"


def build():
    """Compile the kernels if the library for these sources is missing."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a temporary name, then rename: concurrent builds never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.cache
def load_library():
    """Build (if needed) and load the kernel library, with its C signatures."""
    lib = ctypes.CDLL(str(build()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn = lib.mcmcpp_fused_stretch_half_f32
    # every pointer and the stream as c_void_p: a bare Python int would be
    # passed as a 32-bit C int and cut the address
    fn.argtypes = [ptr] * 10 + [i32, i32, ctypes.c_float, ptr]
    fn.restype = i32
    return lib
