"""A sharded engine's kernels on the card (marked ``cuda``, skipped without
one; imports no JAX, so that it runs on the card's machine):
SMC's ensemble mutation with ``FusedStretchMove`` over two thread ranks of
one card launches ``stretch_propose`` and ``stretch_accept`` on each rank's
rows (row0 = 0 and n/2) against the gathered other half, and the run equals
the unsharded one bit for bit.

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider -q \\
        -m cuda tests/test_torch_sharded_engines_card.py
"""

import pytest
import torch

import mcmcpp_tpu_torch as mt
# the helper beside this file (pytest puts the test directory on sys.path;
# an installed top-level ``tests`` package can shadow this directory)
from torch_sharded_engine_cases import (
    ThreadWalkerLayout,
    assemble,
    logp,
    run_in_threads,
)


@pytest.mark.cuda
def test_sharded_smc_runs_the_split_kernels_at_a_row_offset():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from mcmcpp_tpu_torch.ops import fused_stretch as fs

    dev = torch.device("cuda")

    def run(mesh):
        kw = {"device": "cuda"} if mesh is None else {"mesh": mesh}
        smc = mt.SMCSampler(
            logp, lambda t: -0.5 * torch.sum((t - 1.0) ** 2, -1) / 0.5,
            lambda g, n: torch.randn((n, 3), generator=g, device=dev), 1024,
            3, seed=0, n_mcmc=2, mover=mt.FusedStretchMove(), batched=True,
            **kw)
        smc.run(max_stages=10)
        return smc

    want = run(None)
    for name in fs.LAUNCHES:
        fs.LAUNCHES[name] = 0
    got = run_in_threads(2, lambda lay: run(ThreadWalkerLayout(
        lay.world_size, lay.rank, dev, exchange=lay.exchange)))
    assert fs.LAUNCHES["stretch_propose"] > 0
    assert fs.LAUNCHES["stretch_accept"] > 0
    assert fs.LAUNCHES["fused_stretch_half"] == 0
    assert (assemble("particles:", [g.particles for g in got])
            == want.particles).all()
    assert all(g.log_evidence == want.log_evidence for g in got)
