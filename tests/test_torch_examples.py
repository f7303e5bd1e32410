"""The port's example programs, run in process on the CPU at a reduced
length: the reference's three test programs print their oracle beside the
estimate and return 0 inside their tolerances, non-zero outside; the
eight-schools DSL program runs its whole workflow at a few chains."""

import pytest
import torch

from mcmcpp_tpu_torch.examples import (
    actime,
    data_assimilation,
    hierarchical,
    inner_benchmark,
    regime_switching,
    skewed_gaussian,
    ssm_mle,
    state_space,
    streaming,
)

torch.set_num_threads(1)


def test_skewed_gaussian_example_passes_and_writes_csv(tmp_path, capsys):
    rc = skewed_gaussian.main(["--device", "cpu", "--mover", "fused",
                               "--steps", "4000", "--burn", "500",
                               "--outdir", str(tmp_path / "out")])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "true covariance" in out and "convergence" in out
    assert (tmp_path / "out" / "covariance.csv").exists()
    assert len(list((tmp_path / "out").glob("corner_*.csv"))) == 7


def test_skewed_gaussian_example_fails_outside_its_tolerance(capsys):
    """Far too short a run from a tight ball: the covariance is off."""
    rc = skewed_gaussian.main(["--device", "cpu", "--mover", "stretch",
                               "--steps", "64", "--burn", "0", "--walkers",
                               "8"])
    assert rc == 1 and "FAILED" in capsys.readouterr().out


def test_actime_example(capsys):
    assert actime.main(["--device", "cpu", "--steps", "8192", "--rtol",
                        "0.3"]) == 0
    assert "true tau" in capsys.readouterr().out
    assert actime.main(["--device", "cpu", "--steps", "512", "--walkers",
                        "8"]) == 1


@pytest.mark.parametrize("flops", [[], ["--flops"]])
def test_inner_benchmark_example(capsys, flops):
    assert inner_benchmark.main(["--device", "cpu", "--steps", "300",
                                 "--walkers", "240", *flops]) == 0
    out = capsys.readouterr().out
    assert "walker-updates/s" in out and "oracle 0.390625" in out


def test_examples_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU")
    with pytest.raises(RuntimeError, match="is_available"):
        inner_benchmark.main(["--steps", "1"])


def test_hierarchical_example(capsys):
    """Eight schools through the DSL, ChEES and run_until_converged at 8
    chains and a short budget (as the JAX package's test runs its example
    at 16 chains)."""
    assert hierarchical.main(["--device", "cpu", "--chains", "8",
                              "--warmup", "100", "--max-steps", "200",
                              "--check-every", "200"]) == 0
    out = capsys.readouterr().out
    assert "mu" in out and "posterior-predictive" in out
    assert "10 unconstrained parameters" in out


def jax_eight_schools_reference(chains=512, warmup=1000, steps=4000, thin=2,
                                seed=123):
    """The reference numbers of ``chip_smoke.py`` phase 12 (b): the JAX
    package's ChEES on the JAX eight-schools example's model, on the CPU,
    with the means and Monte-Carlo standard errors (its own
    ``effective_sample_size``) of mu and tau, and the same means by
    quadrature of the marginal posterior p(mu, tau | y) (theta integrated
    out). Not a test: ``PYTHONPATH=. python tests/test_torch_examples.py``
    prints them (about 30 s)."""
    import sys
    from pathlib import Path

    import jax
    import numpy as np
    from scipy.stats import norm

    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    sys.path.insert(0, str(root / "examples"))
    jax.config.update("jax_platforms", "cpu")
    import hierarchical as jax_example

    from mcmcpp_tpu import CheesHMCSampler
    from mcmcpp_tpu import analysis as jan

    logp, dim, constrain = jax_example.build_model().build()
    s = CheesHMCSampler(logp, n_chains=chains, n_params=dim, seed=seed)
    s.init_ball(np.zeros(dim), scale=0.5)
    s.warmup(warmup)
    s.run(steps, thin=thin)
    x = s.get_samples()
    d = constrain(x.reshape(-1, dim))
    out = {"rhat": float(jan.potential_scale_reduction(x).max())}
    for name in ("mu", "tau"):
        v = d[name].reshape(x.shape[0], x.shape[1])
        ess = float(jan.effective_sample_size(v[:, :, None])[0])
        out[name] = (float(v.mean()), float(v.std() / np.sqrt(ess)))
    m, t = np.meshgrid(np.linspace(-60, 60, 2401), np.linspace(1e-6, 80, 4001),
                       indexing="ij")
    lp = norm.logpdf(m, 0, 10) + norm.logpdf(t, 0, 10)
    for y, sd in zip(jax_example.Y, jax_example.SIGMA):
        lp += norm.logpdf(y, m, np.sqrt(sd ** 2 + t ** 2))
    w = np.exp(lp - lp.max())
    w /= w.sum()
    out["quadrature"] = (float((w * m).sum()), float((w * t).sum()))
    return out


if __name__ == "__main__":
    print(jax_eight_schools_reference())


def test_state_space_example_quick(capsys):
    """The time-series slice end to end at ``--quick`` size: the exact FFBS
    + conjugate variance Gibbs loop, PMMH on stochastic volatility, the
    discrete FFBS + Dirichlet Gibbs loop and the structural forecast, each
    inside the JAX program's own bounds (trajectory RMSE under the
    observation noise, |μ − truth| < 0.8, state accuracy > 0.85, seasonal
    correlation > 0.85 with 3σ coverage ≥ 0.75)."""
    assert state_space.main(["--quick", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for section in ("local level", "stochastic volatility", "sticky 2-state",
                    "structural decomposition"):
        assert section in out


@pytest.mark.parametrize("program,argv,marker", [
    (regime_switching, ["--quick"], "regime-classification"),
    (streaming, ["--quick"], "log BF"),
    (data_assimilation, ["--quick"], "analysis RMSE"),
    (ssm_mle, ["--quick"], "IF2 MLE"),
], ids=["regime_switching", "streaming", "data_assimilation", "ssm_mle"])
def test_time_series_examples_quick(program, argv, marker, capsys):
    """The other four time-series programs at their ``--quick`` size, each
    inside the JAX program's bounds (RBPF regime accuracy > 0.7; the
    prequential Bayes factor below 1 at the switch and above 3 at the end;
    the EnKF's RMSE below 0.6 of the climatology; IF2 within (0.05, 0.10) of
    the exact Kalman MLE, tests/test_if2.py's bounds)."""
    assert program.main(argv + ["--device", "cpu"]) == 0
    assert marker in capsys.readouterr().out
