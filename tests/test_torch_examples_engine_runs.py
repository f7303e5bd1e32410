"""The port's later example programs whose ``--quick`` runs fit a CPU test,
run in process on the CPU: each prints its checks and returns 0 inside the
JAX program's bounds (``examples/evidence.py``: the three engines within 1
nat, the Bayes factor above 5; ``examples/gp_latent.py``: more than 80% of
the latents inside the 2-sd band) or the bounds this port gives the checks
that the JAX program only prints (see each program's docstring)."""

import pytest
import torch

from mcmcpp_tpu_torch.examples import (
    evidence,
    function_space,
    gp_latent,
    gradient_inference,
    tempering_and_dsl,
)

torch.set_num_threads(1)


def test_evidence_example(capsys):
    assert evidence.main(["--quick", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "decisive for M2" in out and "quadrature" in out


def test_gradient_inference_example(capsys):
    assert gradient_inference.main(["--quick", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for name in ("NUTS", "HMC", "MALA", "SMC", "ADVI"):
        assert name in out


def test_function_space_example(capsys):
    assert function_space.main(["--quick", "--device", "cpu"]) == 0
    assert "dimension-robust" in capsys.readouterr().out


def test_function_space_example_fails_outside_its_bounds(capsys):
    """A few steps from the prior: the posterior means are still off."""
    assert function_space.main(["--device", "cpu", "--steps", "8",
                                "--chains", "2"]) == 1
    assert "FAILED" in capsys.readouterr().out


def test_gp_latent_example(capsys):
    assert gp_latent.main(["--quick", "--device", "cpu"]) == 0
    assert "truth within 2sd band" in capsys.readouterr().out


def test_tempering_and_dsl_example(capsys):
    assert tempering_and_dsl.main(["--quick", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[dsl] posterior mu" in out and "[pt] fraction in right mode" in out


@pytest.mark.parametrize("mod", [
    evidence, function_space, gp_latent, gradient_inference,
    tempering_and_dsl])
def test_examples_default_to_the_card(mod):
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU")
    with pytest.raises(RuntimeError, match="is_available"):
        mod.main(["--quick"])
