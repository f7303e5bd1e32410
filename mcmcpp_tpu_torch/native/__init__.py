"""ctypes binding of the native C++ chain arena (``chain_store.cpp``).

The port's copy of ``mcmcpp_tpu/native``: the same C interface and the same
:class:`NativeChainStore`. Where the JAX package is built by ``make``, this
one builds itself with ``g++`` at first use (never at import) into
``build/native/`` beside the package: the library's file name carries a hash
of the source and flags, the compiler's output is kept beside it as
``<name>.log``, and the library is compiled in a private directory and
renamed into place, so processes racing the build never load half a file.

:func:`load` builds and loads, and raises if ``g++`` is missing or the
build fails (no fallback). :func:`available` only asks whether the library
for this source is already built and loads, which is what
``Chain(backend="auto")`` asks before it picks the arena over numpy.

The arena stores bytes: rows of any item size, float32 and float64, and the
raw bits of bfloat16 and the 8-bit floats (a :class:`~mcmcpp_tpu_torch.chain.
BitsDtype`'s ``bits``), so every store tier is held bit for bit.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "chain_store.cpp"
TEST_SOURCE = _PKG / "test_chain_store.cpp"
BUILD_DIR = _PKG.parents[1] / "build" / "native"
# no -march=native: a build may travel to another host of the same arch
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall", "-Wextra")
SANITIZE_FLAGS = ("-O1", "-g", "-std=c++17", "-fsanitize=address,undefined",
                  "-fno-omit-frame-pointer")


def _cxx():
    found = shutil.which(os.environ.get("CXX", "g++"))
    if found is None:
        raise RuntimeError(
            "g++ not found on PATH: the native chain store of "
            "mcmcpp_tpu_torch builds with it (or use backend='numpy')")
    return found


def _hashed(name, flags, sources):
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}"


def library_path():
    """Path of the shared library for the current source and flags."""
    return _hashed("libmcmcpp_torch_chain", CXX_FLAGS, [SOURCE]).with_suffix(
        ".so")


def _compile(out, flags, sources):
    """Compile ``sources`` into ``out`` unless it exists; the compiler's
    output goes beside it as ``<out>.log``. Raises on a failed build."""
    if out.exists():
        return out
    cxx = _cxx()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        part = Path(tmp) / out.name
        cmd = [cxx, *flags, "-o", str(part), *map(str, sources)]
        done = subprocess.run(cmd, capture_output=True, text=True)
        log = done.stdout + done.stderr
        Path(str(out) + ".log").write_text(log)
        if done.returncode != 0:
            raise RuntimeError(
                f"g++ failed ({done.returncode}): {' '.join(cmd)}\n{log}")
        os.replace(part, out)
    return out


def build():
    """Compile the arena if the library for this source is missing."""
    return _compile(library_path(), CXX_FLAGS, [SOURCE])


def _bind(lib):
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    signatures = {
        "mc_chain_create": ([i64, i64, i64, i64], ptr),
        "mc_chain_append": ([ptr, i64, ptr, ptr], i64),
        "mc_chain_steps": ([ptr], i64),
        "mc_chain_bytes": ([ptr], i64),
        "mc_chain_read_count": ([ptr, i64, i64], i64),
        "mc_chain_read": ([ptr, ptr, ptr, i64, i64], None),
        "mc_chain_compact": ([ptr, i64, i64], None),
        "mc_chain_clear": ([ptr], None),
        "mc_chain_destroy": ([ptr], None),
    }
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


@functools.cache
def load():
    """Build (if needed) and load the library, with its C signatures."""
    return _bind(ctypes.CDLL(str(build())))


def available():
    """Whether the library for this source is built and loads (no build)."""
    if not library_path().exists():
        return False
    try:
        load()
    except OSError:
        return False
    return True


def run_sanitized_test():
    """Build ``test_chain_store.cpp`` with the arena under AddressSanitizer
    and UBSan and run it; returns its output, raises if it fails."""
    exe = _hashed("test_chain_store_asan", SANITIZE_FLAGS,
                  [SOURCE, TEST_SOURCE])
    _compile(exe, SANITIZE_FLAGS, [SOURCE, TEST_SOURCE])
    done = subprocess.run([str(exe)], capture_output=True, text=True,
                          timeout=300)
    if done.returncode != 0:
        raise RuntimeError(f"{exe.name} failed ({done.returncode}):\n"
                           f"{done.stdout}{done.stderr}")
    return done.stdout


class NativeChainStore:
    """Owner of one C chain-store handle: (S, W, P) rows and (S, W) logp
    rows of one item size (``dtype``: an ``np.dtype`` or a ``BitsDtype``,
    whose ``bits`` array holds the rows), byte-capped at ``max_bytes``."""

    def __init__(self, n_walkers, n_params, max_bytes, dtype):
        self._lib = load()
        self.n_walkers = int(n_walkers)
        self.n_params = int(n_params)
        self.dtype = dtype
        self.held = np.dtype(getattr(dtype, "bits", dtype))
        self._h = self._lib.mc_chain_create(
            self.n_walkers, self.n_params, int(max_bytes),
            self.held.itemsize)
        if not self._h:
            raise MemoryError("mc_chain_create failed")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.mc_chain_destroy(h)
            self._h = None

    @staticmethod
    def _cptr(arr):
        return arr.ctypes.data_as(ctypes.c_void_p)

    def append(self, positions, logps):
        """Append held (S, W, P) rows and (S, W) logps; False when the byte
        cap cut them short."""
        positions = np.ascontiguousarray(positions, self.held)
        logps = np.ascontiguousarray(logps, self.held)
        if positions.shape[1:] != (self.n_walkers, self.n_params) or (
                logps.shape != positions.shape[:2]):
            raise ValueError("append takes (S, W, P) rows and (S, W) logps")
        steps = positions.shape[0]
        taken = self._lib.mc_chain_append(
            self._h, steps, self._cptr(positions), self._cptr(logps))
        return taken == steps

    @property
    def n_steps(self):
        return self._lib.mc_chain_steps(self._h)

    @property
    def nbytes(self):
        return self._lib.mc_chain_bytes(self._h)

    def read(self, burn_in=0, thin=1):
        """Every ``thin``-th held row after ``burn_in``: (pos, logp)."""
        n = self._lib.mc_chain_read_count(self._h, burn_in, thin)
        pos = np.empty((n, self.n_walkers, self.n_params), self.held)
        logp = np.empty((n, self.n_walkers), self.held)
        self._lib.mc_chain_read(self._h, self._cptr(pos), self._cptr(logp),
                                burn_in, thin)
        return pos, logp

    def compact(self, burn_in=0, thin=1):
        self._lib.mc_chain_compact(self._h, burn_in, thin)

    def clear(self):
        self._lib.mc_chain_clear(self._h)
