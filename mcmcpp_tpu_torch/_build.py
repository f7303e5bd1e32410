"""Build and load the port's CUDA kernels.

The kernels under ``mcmcpp_tpu_torch/csrc/`` are compiled by hand with
``nvcc`` for Hopper (``sm_90a``) into one shared library with a plain C
interface, loaded with :mod:`ctypes` (no PyTorch headers, so a build takes
seconds). Each ``.cu`` source compiles in its own ``nvcc`` process, all
started together, and one more links the objects. The build runs at first
use, never at import, and lands in ``build/kernels/`` beside the package;
the library's file name carries a hash of the sources (headers included)
and flags, so an edited source rebuilds. The compilers' output, with
``ptxas``'s register and shared-memory counts, is kept beside the library
as ``<name>.log``.

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
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
# --split-compile 0 optimises a source's kernels on all the host's cores:
# the fused kernel's eight instantiations took 68 s in one thread and 41 s
# split, the P <= 64 one alone setting the pace (nvcc 12.9, 8 cores)
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "--split-compile", "0",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _sources():
    """The ``.cu`` files, each compiled on its own."""
    return sorted(CSRC.glob("*.cu"))


def _hashed_files():
    return sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")])


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
    for src in _hashed_files():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmcmcpp_torch_kernels_{h.hexdigest()[:16]}.so"


def log_path():
    """The compilers' output of the last build of :func:`library_path`."""
    return library_path().with_suffix(".log")


def _run_all(cmds):
    """Run the commands concurrently; raise on the first failure. Returns
    their joined output. No process outlives the call."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    try:
        outs = [p.communicate()[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}"
            )
    return "".join(outs)


def build():
    """Compile the kernels if the library for these sources is missing."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile into a private directory and rename the library into place:
    # concurrent builds never load a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in _sources()]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                        for src, obj in zip(_sources(), objs)])
        lib = str(Path(tmp) / out.name)
        log += _run_all([[nvcc, *ARCH, "-shared", "-o", lib, *objs]])
        out.with_suffix(".log").write_text(log)
        os.replace(lib, out)
    return out


@functools.cache
def load_library():
    """Build (if needed) and load the kernel library, with its C signatures."""
    lib = ctypes.CDLL(str(build()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    i64, f32 = ctypes.c_longlong, ctypes.c_float
    u64 = ctypes.c_ulonglong
    # every pointer and the stream as c_void_p, the Philox key as
    # c_ulonglong: a bare Python int would be passed as a 32-bit C int and
    # cut the address or the key
    signatures = {
        "mcmcpp_fused_stretch_half_f32":
            [ptr] * 4 + [u64] + [ptr] * 4 + [i32, i64, i64, i32, f32, ptr],
        "mcmcpp_fused_stretch_wide_f32":
            [ptr] * 4 + [u64] + [ptr] * 4 + [i32, i64, i64, i32, f32, ptr,
                                              ptr],
        "mcmcpp_fused_stretch_wide_loads_only_f32":
            [ptr] * 4 + [u64] + [ptr] * 4 + [i32, i64, i64, i32, f32, ptr,
                                              ptr],
        "mcmcpp_fused_stretch_wide_forced_mma_f32":
            [ptr] * 4 + [u64] + [ptr] * 4 + [i32, i64, i64, i32, f32, ptr],
        "mcmcpp_fused_stretch_wide_layout": [i32, ptr],
        "mcmcpp_fused_stretch_wide_scratch_bytes": [i32, ptr],
        "mcmcpp_fused_stretch_wide_split_l_f32": [ptr, i32, ptr, ptr],
        "mcmcpp_stretch_propose_f32":
            [ptr] * 3 + [u64] + [ptr] * 2 + [i64, i64, i64, i32, f32, ptr],
        "mcmcpp_stretch_accept_f32":
            [ptr] * 5 + [u64] + [ptr] * 3 + [i64, i64, i32, ptr],
        "mcmcpp_unit_uniforms_f32": [u64, ptr, ptr, i64, ptr],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i32
    lib.mcmcpp_fused_stretch_half_smem_bytes.argtypes = [i32]
    lib.mcmcpp_fused_stretch_half_smem_bytes.restype = i64
    return lib
