"""The port's later example programs that run NUTS on a DSL model or
interwoven Gibbs with a Cholesky factor in every leapfrog, in process on the
CPU. ``bayesian_workflow`` runs at ``--quick --dim 6``, as the JAX package's
own test runs its program, and passes its checks. ``dp_mixture`` and
``gp_hyperparams`` take 10 and 4 minutes at ``--quick`` in one CPU thread
(NUTS reaches its depth cap of 8 on every mixture transition; every Gibbs
leapfrog factors six jitter levels of a 48 × 48 Gram), so their tests drive the
whole program through ``run()`` at a few steps and check what it reports;
their gates are held at the programs' default widths on the card
(``chip_smoke.py`` phase 14)."""

import numpy as np
import pytest
import torch

from mcmcpp_tpu_torch.examples import (
    bayesian_workflow,
    dp_mixture,
    gp_hyperparams,
)

torch.set_num_threads(1)


def test_bayesian_workflow_example(capsys):
    assert bayesian_workflow.main(["--quick", "--dim", "6", "--device",
                                   "cpu"]) == 0
    out = capsys.readouterr().out
    assert "divergent transitions" in out and "ArviZ export groups" in out


def test_dp_mixture_example_runs_the_whole_program(capsys):
    out = dp_mixture.run(120, quick=True, device="cpu", chains=4, warmup=20,
                         steps=30, max_depth=4)
    assert out["ok"]  # --quick skips the gates, as in the JAX program
    w = out["w_mean"]
    assert w.shape == (dp_mixture.K,) and abs(w.sum() - 1.0) < 1e-5
    assert 0.0 < out["l1"] < 2.0 and 1 <= out["active"] <= dp_mixture.K
    assert out["post"]["mu"].shape == (4 * (30 - 6), dp_mixture.K)
    # the ordered prior holds on every draw
    assert (np.diff(out["post"]["mu"], axis=1) > 0).all()
    assert "predictive-density L1 error" in capsys.readouterr().out


def test_gp_hyperparams_example_runs_the_whole_program(capsys):
    out = gp_hyperparams.run(device="cpu", chains=4, burn=20, keep=40)
    assert out["h"].shape == (4 * 10, 2) and np.isfinite(out["h"]).all()
    assert 0.0 < out["rmse"] < 1.0
    assert set(out["failed"]) <= {"lengthscale off", "amplitude off",
                                  "lengthscale spread off",
                                  "latent reconstruction degraded"}
    text = capsys.readouterr().out
    assert "log lengthscale" in text and "exact" in text


@pytest.mark.parametrize("mod", [bayesian_workflow, dp_mixture,
                                 gp_hyperparams])
def test_examples_default_to_the_card(mod):
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU")
    with pytest.raises(RuntimeError, match="is_available"):
        mod.main(["--quick"])
