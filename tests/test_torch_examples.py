"""The port's three example programs (the reference's test programs), run in
process on the CPU at a reduced length: each prints its oracle beside the
estimate and returns 0 inside its tolerances, non-zero outside."""

import pytest
import torch

from mcmcpp_tpu_torch.examples import actime, inner_benchmark, skewed_gaussian

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
