"""The port's native C++ chain arena (``mcmcpp_tpu_torch/native``) against
its numpy backend, mirroring ``tests/test_native_chain.py``: the same rows
give the same bits back, for float32, float64 and the reduced tiers held as
raw bits (bfloat16, float8_e4m3fn, float8_e5m2), through ``get``,
``get_logp``, ``iter_steps``, ``compact``, ``clear`` and the byte cap. The
library builds with ``g++`` at first use; its C++ test runs under
AddressSanitizer and UBSan. A failed build raises. These tests skip only
where ``g++`` is missing.
"""

import shutil

import numpy as np
import pytest
import torch

from mcmcpp_tpu_torch import EnsembleSampler, native, skewed_gaussian
from mcmcpp_tpu_torch.chain import Chain

torch.set_num_threads(1)

DTYPES = [np.float32, np.float64, "bfloat16", "float8_e4m3fn", "float8_e5m2"]
IDS = ["float32", "float64", "bfloat16", "float8_e4m3fn", "float8_e5m2"]


@pytest.fixture(scope="module")
def built():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this box")
    return native.build()


def _rows(rng, s, w, p):
    """float32 rows over a wide range (beyond e4m3's 448, below the
    subnormals of the 8-bit tiers) and logps."""
    x = (rng.standard_normal((s, w, p))
         * 10.0 ** rng.uniform(-4, 3, (s, w, p))).astype(np.float32)
    return x, (50 * rng.standard_normal((s, w))).astype(np.float32)


def _fill(chain, seed, chunks=(3, 5, 2)):
    rng = np.random.default_rng(seed)
    for s in chunks:
        x, lp = _rows(rng, s, chain.n_walkers, chain.n_params)
        chain.append(torch.from_numpy(x), torch.from_numpy(lp))


def _pair(dtype, **kw):
    return (Chain(6, 3, dtype=dtype, backend="native", **kw),
            Chain(6, 3, dtype=dtype, backend="numpy", **kw))


def _same(a, b, **kw):
    for held in (True, False):
        np.testing.assert_array_equal(a.get(held=held, **kw),
                                      b.get(held=held, **kw))
        np.testing.assert_array_equal(a.get_logp(held=held, **kw),
                                      b.get_logp(held=held, **kw))


def test_backend_selected(built):
    assert Chain(4, 2, backend="native").backend == "native"
    assert Chain(4, 2, backend="numpy").backend == "numpy"
    assert Chain(4, 2, backend="auto").backend == "native"
    assert Chain(4, 2, dtype="bfloat16").backend == "native"
    # a wider logp plane stays on numpy; native refuses it
    assert Chain(4, 2, dtype="float8_e4m3fn",
                 logp_dtype="bfloat16").backend == "numpy"
    with pytest.raises(ValueError, match="one dtype"):
        Chain(4, 2, dtype="float8_e4m3fn", logp_dtype="bfloat16",
              backend="native")


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_parity_append_read(built, dtype):
    a, b = _pair(dtype)
    _fill(a, 0)
    _fill(b, 0)
    assert a.n_steps == b.n_steps == 10 and a.nbytes == b.nbytes
    _same(a, b)
    _same(a, b, burn_in=2, thin=3)
    _same(a, b, burn_in=1, thin=2, flat=True)
    for ra, rb in zip(a.iter_steps(burn_in=1, thin=4),
                      b.iter_steps(burn_in=1, thin=4)):
        np.testing.assert_array_equal(ra, rb)
    assert len(list(a.iter_psets())) == 10 * 6


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_parity_compact_and_clear(built, dtype):
    a, b = _pair(dtype)
    _fill(a, 1, chunks=(20, 15))
    _fill(b, 1, chunks=(20, 15))
    a.compact(burn_in=5, thin=4)
    b.compact(burn_in=5, thin=4)
    assert a.n_steps == b.n_steps == 8 and a.nbytes == b.nbytes
    _same(a, b)
    a.compact(burn_in=-3)
    b.compact(burn_in=-3)
    _same(a, b)
    a.clear(), b.clear()
    assert a.n_steps == b.n_steps == 0 and a.nbytes == 0
    assert a.get().shape == b.get().shape == (0, 6, 3)
    _fill(a, 2)
    _fill(b, 2)
    _same(a, b)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"],
                         ids=["float32", "bfloat16"])
def test_byte_cap_end_of_chain(built, dtype):
    item = np.dtype(np.float32).itemsize if dtype is np.float32 else 2
    row = 6 * 4 * item  # W·(P+1)·itemsize
    a, b = _pair(dtype, max_bytes=7 * row)
    pos = torch.ones((5, 6, 3))
    logp = torch.zeros((5, 6))
    for c in (a, b):
        assert c.append(pos, logp) is True  # 5 of 7 used
        assert c.append(pos, logp) is False  # only 2 more fit
        assert c.append(pos, logp) is False and c.n_steps == 7
    _same(a, b)


def test_block_boundary_crossing(built):
    """An append longer than one arena block (64 MiB) round-trips: 1 MiB
    rows of the 8-bit tier, 64 to a block."""
    a = Chain(1024, 1023, dtype="float8_e4m3fn", backend="native")
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 256, (70, 1024, 1023), dtype=np.uint8)
    bits[bits == 0x7F] = 0  # keep NaN codes out of the float view
    lp = rng.integers(0, 256, (70, 1024), dtype=np.uint8)
    lp[lp == 0x7F] = 0
    pos = torch.from_numpy(bits).view(torch.float8_e4m3fn)
    assert a.append(pos, torch.from_numpy(lp).view(torch.float8_e4m3fn))
    np.testing.assert_array_equal(a.get(held=True), bits)
    np.testing.assert_array_equal(a.get_logp(held=True), lp)
    np.testing.assert_array_equal(a.get(burn_in=60, thin=7, held=True),
                                  bits[60::7])


@pytest.mark.parametrize("store_dtype", [None, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_sampler_runs_equal_on_both_backends(built, store_dtype):
    """The same seeded run stored in either backend reads back the same
    bits."""
    out = []
    for backend in ("native", "numpy"):
        s = EnsembleSampler(skewed_gaussian(0.13, device="cpu"), 32, 2,
                            seed=5, batched=True, device="cpu",
                            store_dtype=store_dtype,
                            chain=Chain(32, 2, dtype=store_dtype or
                                        np.float32, backend=backend))
        s.init_ball(np.zeros(2), 0.5)
        assert s.run_mcmc(60, thin=3)
        assert s.chain.backend == backend
        out.append((s.chain.get(held=True), s.chain.get_logp(held=True)))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][1], out[1][1])


def test_sanitized_cpp_test_passes(built):
    assert "ASAN tests passed" in native.run_sanitized_test()


def test_build_is_keyed_on_the_source_and_lands_in_build(built):
    assert built == native.library_path() and built.exists()
    assert built.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "native")
    assert built.with_suffix(".so.log").exists()
    assert native.available()


@pytest.fixture
def fresh(tmp_path, monkeypatch):
    """An empty build directory and no loaded library."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    native.load.cache_clear()
    yield tmp_path
    native.load.cache_clear()


def test_auto_takes_numpy_until_the_library_is_built(built, fresh):
    assert not native.available()
    assert Chain(4, 2).backend == "numpy"
    native.build()
    assert native.available() and Chain(4, 2).backend == "native"


def test_missing_compiler_raises(fresh, monkeypatch):
    monkeypatch.setenv("CXX", "no-such-compiler")
    with pytest.raises(RuntimeError, match="not found"):
        Chain(4, 2, backend="native")
    assert not (fresh / "native").exists()
    assert Chain(4, 2).backend == "numpy"


def test_failed_build_raises_and_leaves_no_library(built, fresh, monkeypatch):
    bad = fresh / "chain_store.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        Chain(4, 2, backend="native")
    assert not list((fresh / "native").glob("*.so"))
    assert list((fresh / "native").glob("*.so.log"))
