"""``run_until_converged`` of the port against the JAX package's, and on the
port's sampler.

Replay: one seeded AR(1) chain is fed row by row through a stub sampler into
both packages' ``run_until_converged``; the two ``ConvergenceReport``s must
agree field by field (the decisions, counts and reasons exactly; τ to rtol
1e-4, since each package's ``autocorr_time`` runs its own float32 FFT; R-hat,
mESS and nested R-hat, which are numpy in both, exactly). The rest mirrors the
ensemble cases of ``tests/test_convergence.py`` with the sampler on the CPU.
"""

import numpy as np
import pytest
import torch

from mcmcpp_tpu.convergence import run_until_converged as jax_run_until_converged
from mcmcpp_tpu_torch import AutoRegressiveMove, EnsembleSampler
from mcmcpp_tpu_torch.convergence import ConvergenceReport, run_until_converged
from mcmcpp_tpu_torch.ops.random import make_generator

torch.set_num_threads(1)

TAU_RTOL = 1e-4


def _ar1_rows(n_rows, n_walkers, phis, seed):
    rng = np.random.default_rng(seed)
    phis = np.asarray(phis)
    x = np.zeros((n_rows, n_walkers, phis.shape[0]))
    x[0] = rng.standard_normal(x.shape[1:])
    for t in range(1, n_rows):
        x[t] = phis * x[t - 1] + np.sqrt(1 - phis ** 2) * rng.standard_normal(
            x.shape[1:])
    return x.astype(np.float32)


class ReplaySampler:
    """A sampler whose every run hands out the next stored rows of a chain
    made beforehand (and reports the byte cap after ``cap_rows``)."""

    def __init__(self, rows, cap_rows=None):
        self.rows, self.n_params = rows, rows.shape[-1]
        self.stored, self.cap_rows = 0, cap_rows
        self.device = "cpu"  # where run_until_converged takes the ACT

    def run_mcmc(self, n_steps, thin=1):
        self.stored += n_steps // thin
        if self.cap_rows is not None and self.stored >= self.cap_rows:
            self.stored = self.cap_rows
            return False
        assert self.stored <= self.rows.shape[0]
        return True

    def get_samples(self):
        return self.rows[:self.stored]


CASES = {
    "converges": (dict(max_steps=4000, check_every=400, act_multiplier=20.0),
                  None),
    "thinned-rhat-mess": (dict(max_steps=8000, check_every=800, thin=2,
                               rhat_threshold=1.05, mess_rule=True,
                               act_multiplier=20.0), None),
    "mess-too-tight": (dict(max_steps=3000, check_every=600,
                            act_multiplier=5.0, mess_rule=(0.05, 1e-4)),
                       None),
    "nested-gate": (dict(max_steps=3000, check_every=500,
                         nested_superchains=4, act_multiplier=10.0), None),
    "nested-impossible": (dict(max_steps=2000, check_every=500,
                               act_multiplier=1.0, tau_rtol=1.0,
                               nested_superchains=4,
                               nested_rhat_threshold=1.0), None),
    "budget": (dict(max_steps=900, check_every=300, act_multiplier=1000.0),
               None),
    "window-open": (dict(max_steps=40, check_every=10), None),
    "capacity-early": (dict(max_steps=5000, check_every=3), 5),
    "capacity-late": (dict(max_steps=5000, check_every=100,
                           act_multiplier=1000.0), 250),
}


@pytest.mark.parametrize("case", list(CASES))
def test_replayed_chain_gives_the_jax_report(case):
    kw, cap = CASES[case]
    rows = _ar1_rows(4000, 16, [0.5, 0.8], seed=1)
    seen_p, seen_j = [], []
    got = run_until_converged(ReplaySampler(rows, cap), callback=seen_p.append,
                              **kw)
    want = jax_run_until_converged(ReplaySampler(rows, cap),
                                   callback=seen_j.append, multihost=False,
                                   **kw)
    assert isinstance(got, ConvergenceReport)
    assert got._fields == want._fields
    assert len(seen_p) == len(seen_j)
    for g, w in zip(seen_p + [got], seen_j + [want]):
        assert (g.converged, g.steps_run, g.stored_steps, g.checks,
                g.reason) == (w.converged, w.steps_run, w.stored_steps,
                              w.checks, w.reason)
        np.testing.assert_allclose(g.tau, w.tau, rtol=TAU_RTOL,
                                   equal_nan=True)
        np.testing.assert_array_equal(g.rhat, w.rhat)
        np.testing.assert_array_equal(g.mess, w.mess)
        if w.nested is None:
            assert g.nested is None
        else:
            np.testing.assert_array_equal(g.nested, w.nested)
    expected = {"converges": "converged", "thinned-rhat-mess": "converged",
                "nested-gate": "converged", "mess-too-tight": "mESS",
                "nested-impossible": "nested rhat", "budget": "exhausted",
                "window-open": "exhausted",
                "capacity-early": "chain capacity reached",
                "capacity-late": "chain capacity reached"}[case]
    assert expected in got.reason


def test_multihost_is_not_ported_and_defaults_off():
    """multihost=True is ported now: in one process it gates on the
    collective global statistics, which equal the local ones there, so it
    takes the local decision; the default (None) is off outside a process
    group of more than one rank (the two-rank gate is in
    tests/test_torch_sharded.py)."""
    rows = _ar1_rows(100, 8, [0.5], seed=2)
    glob = run_until_converged(ReplaySampler(rows), max_steps=50,
                               check_every=25, multihost=True)
    rep = run_until_converged(ReplaySampler(rows), max_steps=50,
                              check_every=25)
    assert rep.checks == glob.checks == 2
    assert (glob.converged, glob.reason) == (rep.converged, rep.reason)
    np.testing.assert_array_equal(glob.tau, rep.tau)


def _ar_sampler(phi, n_walkers, seed, **kw):
    mover = AutoRegressiveMove(offsets=[0.0], phis=[phi], variances=[1.0])
    s = EnsembleSampler(lambda x: torch.zeros_like(x[:, 0]), n_walkers, 1,
                        mover=mover, seed=seed, batched=True, device="cpu",
                        **kw)
    s.set_initial_walker_pos(mover.initial_positions(
        make_generator(seed, 0, "cpu"), n_walkers, device="cpu"))
    return s


def test_converges_on_fast_mixing_ar1():
    """AR(1) phi=0.8 (tau=9): converges within the budget, the chain at
    least act_multiplier·tau long and the reported tau near the truth."""
    s = _ar_sampler(0.8, 64, 0)
    seen = []
    rep = run_until_converged(s, max_steps=12000, check_every=400,
                              act_multiplier=20, callback=seen.append)
    assert rep.converged and rep.reason == "converged", rep
    assert rep.steps_run < 12000
    assert rep.stored_steps > 20 * rep.tau.max()
    assert abs(rep.tau[0] - 9.0) / 9.0 < 0.25
    assert len(seen) == rep.checks and seen[-1] == rep
    assert s.run_mcmc(10)  # the sampler goes on


def test_budget_exhaustion_reports_unconverged():
    s = _ar_sampler(0.999, 32, 1)
    rep = run_until_converged(s, max_steps=400, check_every=200)
    assert not rep.converged
    assert "exhausted" in rep.reason and rep.steps_run == 400


def test_bad_args_rejected():
    s = _ar_sampler(0.5, 8, 0)
    with pytest.raises(ValueError):
        run_until_converged(s, max_steps=0)
    with pytest.raises(ValueError):
        run_until_converged(s, max_steps=10, check_every=0)


def test_capacity_reached_before_usable_chain():
    s = _ar_sampler(0.5, 32, 2, max_chain_bytes=4 * 32 * 2 * 4)  # 4 rows
    rep = run_until_converged(s, max_steps=5000, check_every=100)
    assert rep.reason == "chain capacity reached"
    assert rep.steps_run <= 200


def test_mess_rule_gates_convergence():
    def logp(x):
        return -0.5 * (x * x).sum(dim=1)

    def make(seed):
        s = EnsembleSampler(logp, 64, 2, seed=seed, batched=True,
                            device="cpu")
        s.init_ball(np.zeros(2), scale=0.5, seed=seed + 1)
        return s

    rep = run_until_converged(make(0), max_steps=400, check_every=200,
                              act_multiplier=5.0, tau_rtol=0.5,
                              mess_rule=(0.05, 0.5))
    assert rep.converged and rep.mess > 0, rep
    rep2 = run_until_converged(make(2), max_steps=400, check_every=200,
                               act_multiplier=5.0, tau_rtol=0.5,
                               mess_rule=(0.05, 1e-4))
    assert not rep2.converged and "mESS" in rep2.reason
