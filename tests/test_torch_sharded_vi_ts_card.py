"""Sharded engines of this layer on the card (marked ``cuda``, skipped
without one; imports no JAX, so that it runs on the card's machine): SVGD,
IBIS and the particle filter over two thread ranks of one card, holding
rows 0…n/2−1 and n/2…n−1. The filter's hooks draw nothing and its
resampling uniforms come from the caller's CUDA generator, which the
hooks' fork must not move: it equals the unsharded run bit for bit. IBIS equals the unsharded run on the card bit for bit (the rows of
both ranks put together, the replicated trace on each). SVGD's rank takes
its rows of φ from a (n/2, N) × (N, 2P + 1) product, whose rows cuBLAS does
not compute with the bits of the (N, N) × (N, 2P + 1) product's (another
kernel for another height): its cloud holds the unsharded one to float32
rounding, and every rank's |φ| trace is the same.

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider -q \\
        -m cuda tests/test_torch_sharded_vi_ts_card.py
"""

import pytest
import torch

import mcmcpp_tpu_torch as mt
# the helper beside this file (pytest puts the test directory on sys.path;
# an installed top-level ``tests`` package can shadow this directory)
from torch_sharded_engine_cases import ThreadWalkerLayout, run_in_threads


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the sharded engines run on the "
                    "card here")
    return torch.device("cuda")


def _on(dev):
    """Two thread ranks' layouts on ``dev``."""
    return lambda lay: ThreadWalkerLayout(lay.world_size, lay.rank, dev,
                                          exchange=lay.exchange)


def _target(t):
    return -0.5 * torch.sum((t - 1.0) ** 2, -1) + 0.1 * torch.sin(t[..., 0])


@pytest.mark.cuda
def test_sharded_svgd_on_the_card_equals_the_unsharded_run():
    dev = _card()
    on = _on(dev)

    def run(mesh):
        kw = {"device": "cuda"} if mesh is None else {"mesh": mesh}
        s = mt.SVGD(_target, 1024, 5, batched=True, **kw)
        s.init(scale=2.0, seed=5)
        return s.fit(20)

    want = run(None)
    got = run_in_threads(2, lambda lay: run(on(lay)))
    assert [g.particles.shape[0] for g in got] == [512, 512]
    torch.testing.assert_close(torch.cat([g.particles for g in got]),
                               want.particles, rtol=1e-4, atol=1e-5)
    assert torch.equal(got[0].grad_norm_history, got[1].grad_norm_history)
    torch.testing.assert_close(got[0].grad_norm_history,
                               want.grad_norm_history, rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
def test_sharded_ibis_on_the_card_equals_the_unsharded_run():
    dev = _card()
    on = _on(dev)
    data = 0.8 + torch.randn(64, generator=torch.Generator().manual_seed(1))

    def run(mesh):
        kw = {"device": "cuda"} if mesh is None else {"mesh": mesh}
        s = mt.IBISSampler(
            lambda t: -0.125 * t[:, 0] ** 2,
            lambda t, rows: -0.5 * (rows[None, :] - t[:, :1]) ** 2,
            lambda g, n: 2.0 * torch.randn((n, 1), generator=g,
                                           device=g.device), 1 << 14, 1,
            batch_size=4, seed=3, batched=True, **kw)
        s.update(data)
        return s

    want = run(None)
    got = run_in_threads(2, lambda lay: run(on(lay)))
    assert want.n_resamples > 0
    assert torch.equal(torch.cat([g.state.particles for g in got]),
                       want.state.particles)
    for g in got:
        assert g.log_evidence_trace == want.log_evidence_trace
        assert g.n_resamples == want.n_resamples


@pytest.mark.cuda
def test_sharded_filter_on_the_card_keeps_the_callers_draws():
    dev = _card()
    on = _on(dev)
    n = 1 << 12
    x0 = torch.randn((n, 1), generator=torch.Generator(
        device=dev).manual_seed(2), device=dev)
    ys = torch.sin(torch.arange(50, device=dev) / 4.0)

    def ssm(rank):
        return mt.StateSpaceModel(
            lambda g, m, th: x0[rank * m:(rank + 1) * m].clone(),
            lambda g, x, t, th: 0.9 * x + 0.3 * torch.sin(x + t),
            lambda y, x, t, th: -0.5 * ((y[0] - x[..., 0]) / 0.6) ** 2)

    def run(mesh):
        kw = {"device": "cuda"} if mesh is None else {"mesh": mesh}
        gen = torch.Generator(device=dev).manual_seed(3)
        r = mt.particle_filter(gen, ssm(0 if mesh is None else mesh.rank),
                               None, ys, n, ess_frac=0.7, **kw)
        return r, torch.rand(2, generator=gen, device=dev)

    want, after = run(None)
    assert (want.ess < 0.7 * n).any() and (want.ess >= 0.7 * n).any()
    for r, a in run_in_threads(2, lambda lay: run(on(lay))):
        assert torch.equal(r.loglik, want.loglik)
        assert torch.equal(r.filter_means, want.filter_means)
        assert torch.equal(a, after)
