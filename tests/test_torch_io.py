"""The port's writers and ArviZ export against the JAX package's.

The same outputs (a scalar, a matrix, histograms, a whole corner set, a chain),
made from a numpy seed, go through both packages' ``DataWriter``: the CSV and
binary engines' files must be byte-equal, the NPZ archives equal array by array
and in their meta (a zip carries its time of writing, so its bytes are not
compared). Mirrors the writer cases of ``tests/test_io.py`` and the ensemble
cases of ``tests/test_export.py`` with the port's sampler on the CPU; the
checkpoint cases are in ``tests/test_torch_checkpoint.py``.
"""

import numpy as np
import pytest
import torch

import mcmcpp_tpu.io as jio
from mcmcpp_tpu.analysis import CornerHistograms as JCornerHistograms
from mcmcpp_tpu.export import to_inference_dict as jax_to_inference_dict
from mcmcpp_tpu_torch import Chain, EnsembleSampler, skewed_gaussian
from mcmcpp_tpu_torch import io as pio
from mcmcpp_tpu_torch.analysis import CornerHistograms
from mcmcpp_tpu_torch.export import to_arviz, to_inference_dict
from mcmcpp_tpu_torch.io.engines import read_npz

torch.set_num_threads(1)

ENGINES = ["CsvEngine", "BinaryEngine", "NpzEngine"]


def _rows():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((30, 16, 2)).astype(np.float32),
            rng.standard_normal((30, 16)).astype(np.float32))


def _write_everything(io, corner_cls, chain, engine):
    pos, _ = _rows()
    ch = corner_cls(n_bins=8).calculate(pos)
    with io.DataWriter(engine) as w:
        w.add(io.ScalarOutput("acceptance", 0.4375, meta={"unit": "1"}))
        w.add(io.MatrixOutput("cov", np.cov(pos.reshape(-1, 2).T)))
        counts, edges = ch.hist1d[0]
        w.add(io.Hist1dOutput("h1", counts, edges))
        c2, xe, ye = ch.hist2d[(0, 1)]
        w.add(io.Hist2dOutput("h2", c2, xe, ye, meta={"pair": [0, 1]}))
        w.add(io.HistMultiOutput("corner", ch))
        w.add(io.ChainOutput("chain", chain, burn_in=3, thin=2,
                             meta={"run": "r1"}))
        w.add("raw", np.arange(6.0).reshape(2, 3))


def _chains():
    from mcmcpp_tpu.chain import Chain as JChain

    pos, lp = _rows()
    pc, jc = Chain(16, 2), JChain(16, 2, backend="numpy")
    assert pc.append(pos, lp) and jc.append(pos, lp)
    return pc, jc


@pytest.mark.parametrize("engine", ENGINES)
def test_writers_files_equal_the_jax_packages(tmp_path, engine):
    pc, jc = _chains()
    name = "out.npz" if engine == "NpzEngine" else "out"
    _write_everything(pio, CornerHistograms, pc,
                      getattr(pio, engine)(tmp_path / "p" / name))
    _write_everything(jio, JCornerHistograms, jc,
                      getattr(jio, engine)(tmp_path / "j" / name))
    if engine == "NpzEngine":
        got, got_meta = read_npz(tmp_path / "p" / name)
        want, want_meta = jio.engines.read_npz(tmp_path / "j" / name)
        assert sorted(got) == sorted(want) and got_meta == want_meta
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
        assert got_meta["chain_samples"] == {"run": "r1", "burn_in": 3,
                                             "thin": 2}
        return
    files = sorted(f.name for f in (tmp_path / "j" / name).iterdir())
    assert files == sorted(f.name for f in (tmp_path / "p" / name).iterdir())
    assert len(files) >= 17
    for f in files:
        assert (tmp_path / "p" / name / f).read_bytes() == \
            (tmp_path / "j" / name / f).read_bytes(), f


def test_npz_round_trip_of_a_sampled_chain(tmp_path):
    s = EnsembleSampler(skewed_gaussian(device="cpu"), 16, 2, seed=0,
                        batched=True, device="cpu",
                        store_dtype=torch.bfloat16)
    s.init_ball(np.zeros(2), scale=0.3, seed=1)
    s.run_mcmc(50)
    target = tmp_path / "chain"  # the engine adds the suffix
    with pio.DataWriter(pio.NpzEngine(target)) as w:
        w.add(pio.ChainOutput("chain", s.chain, meta={"run": "r1"}))
        w.add(pio.ScalarOutput("accept", s.acceptance_fraction))
    arrays, meta = read_npz(tmp_path / "chain.npz")
    # a reduced chain is written cast up, as the analysis reads it
    assert arrays["chain_samples"].dtype == np.float32
    np.testing.assert_array_equal(arrays["chain_samples"], s.get_samples())
    np.testing.assert_array_equal(arrays["chain_logp"], s.get_log_probs())
    assert meta["chain_samples"]["run"] == "r1"
    assert arrays["accept"] == pytest.approx(s.acceptance_fraction)


def test_writer_aborts_on_exception(tmp_path):
    for engine, artifact in [
        (pio.NpzEngine(tmp_path / "t"), tmp_path / "t.npz"),
        (pio.BinaryEngine(tmp_path / "bin"),
         tmp_path / "bin" / "manifest.json"),
    ]:
        with pytest.raises(RuntimeError, match="boom"):
            with pio.DataWriter(engine) as w:
                w.add("x", np.ones(3))
                raise RuntimeError("boom")
        assert not artifact.exists(), artifact


def test_hdf5_engine_keeps_its_import_guard(tmp_path):
    try:
        import h5py  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="requires h5py"):
            pio.Hdf5Engine(tmp_path / "out.h5").open()
        return
    pc, _ = _chains()
    with pio.DataWriter(pio.Hdf5Engine(tmp_path / "out.h5")) as w:
        w.add(pio.ChainOutput("chain", pc))
    with h5py.File(tmp_path / "out.h5", "r") as f:
        np.testing.assert_array_equal(f["chain_samples"][...], pc.get())


def test_io_exports_the_jax_names():
    assert pio.__all__ == jio.__all__
    for name in pio.__all__:
        assert getattr(pio, name).__module__.startswith("mcmcpp_tpu_torch.io")


class _Stored:
    """What ``to_inference_dict`` asks of a sampler, over fixed rows."""

    def __init__(self, pos, lp):
        self.pos, self.lp = pos, lp

    def get_samples(self, burn_in=0, thin=1):
        return self.pos[burn_in::thin]

    def get_log_probs(self, burn_in=0, thin=1):
        return self.lp[burn_in::thin]


@pytest.mark.parametrize("kw", [{}, {"burn_in": 10, "thin": 2}])
def test_inference_dict_equals_the_jax_packages(kw):
    pos, lp = _rows()

    def constrain(flat):
        return {"mu": flat[:, 0], "pair": np.stack([flat, -flat], axis=1)}

    ppc = {"y": np.arange(pos[kw.get("burn_in", 0)::kw.get("thin", 1)]
                          .size // 2 * 3, dtype=np.float64).reshape(-1, 3)}
    for model, pp in [(None, None), (constrain, ppc)]:
        got = to_inference_dict(_Stored(pos, lp), model=model,
                                posterior_predictive=pp, **kw)
        want = jax_to_inference_dict(_Stored(pos, lp), model=model,
                                     posterior_predictive=pp, **kw)
        assert sorted(got) == sorted(want)
        for group in want:
            assert sorted(got[group]) == sorted(want[group])
            for key in want[group]:
                np.testing.assert_array_equal(got[group][key],
                                              want[group][key])


def test_flat_export_shapes_and_order():
    s = EnsembleSampler(skewed_gaussian(device="cpu"), 16, 2, seed=0,
                        batched=True, device="cpu")
    s.init_ball(np.zeros(2), scale=0.3)
    s.run_mcmc(50)
    d = to_inference_dict(s)
    assert set(d) == {"posterior", "sample_stats"}
    theta = d["posterior"]["theta"]
    assert theta.shape == (16, 50, 2)  # (chain, draw, param)
    assert d["sample_stats"]["lp"].shape == (16, 50)
    raw = s.get_samples()
    np.testing.assert_array_equal(theta[3, 7], raw[7, 3])
    d2 = to_inference_dict(s, burn_in=10, thin=2)
    assert d2["posterior"]["theta"].shape == (16, 20, 2)
    try:
        import arviz  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="arviz is not installed"):
            to_arviz(s)
