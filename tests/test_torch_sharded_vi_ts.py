"""``mesh=`` of the variational and time-series engines on the CPU: NeuTra,
ADVI, SVGD, Pathfinder, the particle filter, smoother and forecast, PMMH,
the RBPF and its forecast, IF2, IBIS, SMC², the EnKF/ETKF, EKI and EKS.

Mirrors the JAX package's mesh tests: ``tests/test_ibis.py:125``,
``test_eks.py:128``, ``test_svgd.py:70``, ``test_pathfinder.py:91``,
``test_smc_vi.py:86``, ``test_neutra.py:363`` and the ``mesh=`` arguments of
the filters, RBPF, IF2, PMMH, SMC² and the EnKF.

- In one process, the ranks of a layout are threads (``tests/
  torch_sharded_engine_cases.py``). Every engine sharded over R ∈ {2, 4}
  ranks equals the unsharded engine bit for bit
  (``tests/torch_sharded_vi_ts_cases.py``): the engines whose draws are all
  their own (rule (a) of ``mcmcpp_tpu_torch/parallel/mesh.py``) as they
  are, the filters, RBPF, PMMH, SMC² and the EnKF with hooks that draw
  nothing (rule (b)); ADVI and NeuTra hold JAX's 2e-3 over R > 1 and are
  bit for bit in a group of one.
- With drawn hook noise over R ∈ {2, 4}, the local-level filter's
  likelihood holds the exact Kalman likelihood within 4 Monte Carlo
  standard errors, and the ranks' forked generators differ.
- The four runs that JAX's tests make on its 8-device CPU mesh (IBIS, EKS,
  SVGD, Pathfinder, at sizes that split over 8) are replayed over 8 thread
  ranks with JAX's draws, within the unsharded replays' tolerances.
- Two processes join a gloo group once, in a module fixture, and run every
  case; checkpoints over two ranks are refused.
- On the card: ``tests/test_torch_sharded_vi_ts_card.py`` (no JAX).
"""

import functools
import importlib
import inspect
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmcpp_tpu_torch as mt
from mcmcpp_tpu import IBISSampler as JIBIS
from mcmcpp_tpu.parallel.mesh import make_walker_mesh as j_walker_mesh
from mcmcpp_tpu.utils.buffers import pad_to_capacity
from mcmcpp_tpu_torch.models import lgss as tl
from mcmcpp_tpu_torch.parallel.mesh import WalkerLayout, hook_generator
from tests.torch_sharded_engine_cases import ThreadWalkerLayout, \
    run_in_threads
from tests.torch_sharded_vi_ts_cases import (
    ENGINES,
    check,
    noise_free_ssm,
    noise_free_switching,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
# the unsharded replays' tolerance (tests/test_torch_{ibis_smc2,
# enkf_ukf_eks,vi_svgd,pathfinder_laplace}.py, float64)
REPLAY_TOL = 1e-9
CLOSE = ("advi", "advi_full_rank", "neutra")


@functools.lru_cache(maxsize=None)
def unsharded(name):
    return ENGINES[name](None)


# -- in one process: the ranks are threads ------------------------------------


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(ENGINES))
def test_engine_shards_equal_the_unsharded_engine(name, world):
    check(name, run_in_threads(world, ENGINES[name]), unsharded(name), world)


@pytest.mark.parametrize("name", CLOSE)
def test_gradient_sums_are_bit_for_bit_in_a_group_of_one(name):
    """ADVI's and NeuTra's all-reduce does no arithmetic over one rank."""
    check(name, run_in_threads(1, ENGINES[name]), unsharded(name), 1)


def test_the_cases_take_every_branch():
    """The bitwise cases resample, move and accept: IBIS resamples, SMC²
    rejuvenates (and accepts some moves), the filter resamples some steps
    and not others, PMMH accepts some proposals and rejects others."""
    assert unsharded("ibis")["same:resamples"] > 0
    assert unsharded("smc2")["same:moved"] > 0
    assert 0 < unsharded("smc2")["same:accept"] < 1
    ess = unsharded("pf_bootstrap")["same:ess"].numpy()
    assert (ess < 0.7 * 32).any() and (ess >= 0.7 * 32).any()
    for name in ("pmmh_filter", "pmmh_exact"):
        acc = unsharded(name)["same:accept"]
        assert 0 < acc.mean() < 1, name
    assert any(unsharded("smc2_stage")[f"same:moved{t}"] for t in range(4))


def test_hook_generators_are_the_callers_alone_and_forks_over_more_ranks():
    """Rule (b): in a group of one the hooks get the caller's generator
    itself; over R > 1 ranks each rank's fork draws its own stream, taking
    a fork leaves the caller's generator where it was, a second fork from
    the unmoved generator draws another stream, and a generator seeded
    alike forks alike (a replay)."""
    g = torch.Generator().manual_seed(0)
    assert hook_generator(None, g) is g
    assert run_in_threads(1, lambda m: hook_generator(m, g) is g) == [True]

    def forks(mesh):
        gen = torch.Generator().manual_seed(0)
        first = torch.rand(4, generator=hook_generator(mesh, gen))
        second = torch.rand(4, generator=hook_generator(mesh, gen))
        again = torch.rand(4, generator=hook_generator(
            mesh, torch.Generator().manual_seed(0)))
        return first, second, again, torch.rand(2, generator=gen)

    fresh = torch.rand(2, generator=torch.Generator().manual_seed(0))
    for world in (2, 4):
        got = run_in_threads(world, forks)
        for a in range(world):
            for b in range(a):
                assert not torch.equal(got[a][0], got[b][0])
            assert not torch.equal(got[a][0], got[a][1])
            assert torch.equal(got[a][2], got[a][0])
            assert torch.equal(got[a][3], fresh)


def _local_level():
    sig_q, sig_r, m0, p0 = 0.35, 0.6, 1.0, 2.0

    def obs(y, x, t, th):
        z = (y[0] - x[:, 0]) / sig_r
        return -0.5 * z * z - np.log(sig_r) - 0.5 * np.log(2 * np.pi)

    ssm = mt.StateSpaceModel(
        lambda g, n, th: m0 + np.sqrt(p0) * torch.randn((n, 1), generator=g),
        lambda g, x, t, th: x + sig_q * torch.randn(x.shape, generator=g),
        obs)
    params = tl.lgss_params(A=1.0, b=0.0, Q=sig_q ** 2, H=1.0, c=0.0,
                            R=sig_r ** 2, m0=m0, P0=p0, dtype=torch.float64,
                            device="cpu")
    return ssm, params


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_filter_with_drawn_noise_holds_the_kalman_likelihood(world):
    """The local level over T = 20 with 256 particles, the hooks drawing on
    each rank's forked generator: over 16 seeds, the mean of p̂/p (p̂ is
    unbiased) is 1 within 4 Monte Carlo standard errors; the ranks'
    blocks of the first cloud differ (no two ranks share a stream), and
    the run is not the unsharded one (another draw)."""
    rng = np.random.default_rng(0)
    x = 1.0 + np.cumsum(0.35 * rng.standard_normal(20))
    ys = (x + 0.6 * rng.standard_normal(20)).astype(np.float32)
    ssm, params = _local_level()
    exact = float(tl.lgss_loglik(params, torch.from_numpy(ys).double()[
        :, None], method="sequential"))

    def runs(mesh):
        out = [mt.particle_filter(s, ssm, None, ys, 256, mesh=mesh)
               for s in range(16)]
        first = mt.particle_filter(99, ssm, None, ys, 256, mesh=mesh,
                                   return_particles=True)
        return [float(r.loglik) for r in out], first.particles[0]

    got = run_in_threads(world, runs)
    lls = np.asarray(got[0][0], np.float64)
    assert all(g[0] == got[0][0] for g in got)  # replicated on every rank
    ratio = np.exp(lls - exact)
    se = ratio.std(ddof=1) / np.sqrt(lls.size)
    assert abs(ratio.mean() - 1.0) < 4.0 * se, (ratio.mean(), se)
    cloud = got[0][1].reshape(world, -1)
    for a in range(world):
        for b in range(a):
            assert not torch.equal(cloud[a], cloud[b])
    un = mt.particle_filter(99, ssm, None, ys, 256, device="cpu",
                            return_particles=True).particles[0]
    assert not torch.equal(un, got[0][1])
    one, = run_in_threads(1, lambda m: mt.particle_filter(
        99, ssm, None, ys, 256, mesh=m, return_particles=True).particles[0])
    assert torch.equal(one, un)


def _layout3():
    return WalkerLayout(3, 0, CPU)


def _lp(t):
    return -0.5 * torch.sum(t * t, -1)


_SSM = noise_free_ssm()
_YS = np.zeros(5, np.float32)

UNEVEN = {
    "neutra": lambda m: mt.NeuTra(_lp, 2, batched=True, mesh=m).fit(
        2, batch=16),
    "advi": lambda m: mt.ADVI(_lp, 2, n_mc=16, batched=True, mesh=m),
    "svgd": lambda m: mt.SVGD(_lp, 16, 2, batched=True, mesh=m),
    "pathfinder": lambda m: mt.multi_pathfinder(_lp, 16, np.zeros(2),
                                                batched=True, mesh=m),
    "particle_filter": lambda m: mt.particle_filter(0, _SSM, None, _YS, 16,
                                                    mesh=m),
    "particle_smoother": lambda m: mt.particle_smoother(
        0, _SSM, None, _YS, 16, 4, mesh=m),
    "particle_forecast": lambda m: mt.particle_forecast(
        0, _SSM, None, torch.zeros((16, 1)), torch.zeros(16), 5, 2, mesh=m),
    "pmmh": lambda m: mt.PMMHSampler(_SSM, _YS, _lp, 1, n_chains=16, mesh=m),
    "rbpf": lambda m: mt.rao_blackwell_filter(0, noise_free_switching(),
                                               _YS, 16, mesh=m),
    "if2": lambda m: mt.if2(0, _SSM, _YS, 16, np.zeros(1), 0.1, mesh=m),
    "ibis": lambda m: mt.IBISSampler(_lp, lambda t, r: t[:, :1] * r, None,
                                     16, 1, batched=True, mesh=m),
    "smc2": lambda m: mt.SMC2Sampler(_SSM, _lp, None, 16, 1, mesh=m),
    "enkf": lambda m: mt.ensemble_kalman_filter(
        0, mt.EnKFModel(None, None, None, torch.eye(1)), _YS, 16, mesh=m),
    "eki": lambda m: mt.ensemble_kalman_inversion(
        0, None, np.zeros(2), np.ones(2), np.zeros(2), np.eye(2), 16,
        mesh=m),
    "eks": lambda m: mt.ensemble_kalman_sampler(
        0, None, np.zeros(2), np.ones(2), np.zeros(2), np.eye(2), 16,
        mesh=m),
}


@pytest.mark.parametrize("name", list(UNEVEN))
def test_uneven_split_raises(name):
    """An axis that does not split over the layout's ranks raises, in the
    JAX package's words, before any process group is asked (NeuTra at
    ``fit``, whose batch it splits)."""
    lay = (ThreadWalkerLayout(3, 0, CPU) if name == "neutra"
           else _layout3())
    with pytest.raises(ValueError, match="not divisible by mesh size 3"):
        UNEVEN[name](lay)


# (JAX callable, port callable) of each engine with ``mesh=``
MESH_SIGNATURES = [
    ("neutra", "NeuTra.__init__"), ("vi", "ADVI.__init__"),
    ("svgd", "SVGD.__init__"), ("pathfinder", "multi_pathfinder"),
    ("particle", "particle_filter"), ("particle", "particle_smoother"),
    ("particle", "particle_forecast"), ("particle", "PMMHSampler.__init__"),
    ("rbpf", "rao_blackwell_filter"), ("rbpf", "rbpf_forecast"),
    ("if2", "if2"), ("ibis", "IBISSampler.__init__"),
    ("smc2", "SMC2Sampler.__init__"), ("enkf", "ensemble_kalman_filter"),
    ("eks", "ensemble_kalman_inversion"), ("eks", "ensemble_kalman_sampler"),
]


def _callable(package, module, path):
    obj = importlib.import_module(f"{package}.{module}")
    for part in path.split("."):
        obj = getattr(obj, part)
    return inspect.signature(obj).parameters


@pytest.mark.parametrize("module,path", MESH_SIGNATURES)
def test_engines_take_mesh_with_the_jax_signature(module, path):
    """``mesh=`` (default None) follows the JAX signature's parameters
    before it, in their order (the port's generator ``gen`` in place of
    JAX's ``key``)."""
    j = _callable("mcmcpp_tpu", module, path)
    t = _callable("mcmcpp_tpu_torch", module, path)
    assert j["mesh"].default is None and t["mesh"].default is None
    rename = {"key": "gen"}
    before = [rename.get(p, p) for p in list(j)[:list(j).index("mesh")]]
    assert [p for p in list(t)[:list(t).index("mesh")] if p in before] \
        == before


# -- JAX's runs on its 8-device mesh, replayed over 8 thread ranks ----------


def _t(x):
    return torch.from_numpy(np.array(x))


def test_ibis_replays_jax_on_the_walker_mesh():
    """``test_ibis.py::test_mesh_sharded_runs``'s sampler on
    ``make_walker_mesh()`` (64 particles here, 8 a rank): one resampling
    stage from JAX's state with JAX's draws in float64; the ranks' rows
    put together are JAX's, and the evidence increment is JAX's on every
    rank."""
    tau = 2.0
    ys = (0.8 + np.random.default_rng(3).standard_normal(12)).astype(
        np.float64)
    n = 64
    with jax.enable_x64(True):
        js = JIBIS(
            log_prior_fn=lambda t: -0.5 * t[0] ** 2 / tau ** 2,
            loglike_point_fn=lambda t, y: -0.5 * (y - t[0]) ** 2,
            prior_sample_fn=lambda k, m: tau * jax.random.normal(k, (m, 1)),
            n_particles=n, n_params=1, batch_size=4, n_mcmc=3,
            target_ess=0.999, dtype=jnp.float64, max_chunk_steps=None,
            mesh=j_walker_mesh())
        js.update(ys[:8])
        state0 = js.state
        padded, _ = pad_to_capacity(jnp.asarray(ys), 12)
        key = jax.random.key(11)
        new_j, logz_j, resampled, _ = js._stage_impl(
            key, state0, padded, jnp.int32(8), jnp.int32(4))
        assert int(resampled) == 1
        k_res, k = jax.random.split(key)
        u0 = float(jax.random.uniform(k_res, (), jnp.float64))
        moves = []
        for _ in range(3):
            k, k_prop, k_acc = jax.random.split(k, 3)
            moves.append((_t(jax.random.normal(k_prop, (n, 1), jnp.float64)),
                          _t(jax.random.uniform(k_acc, (n,)))))
    ti = importlib.import_module("mcmcpp_tpu_torch.ibis")
    start = ti.IBISState(*(_t(a) for a in state0))

    def rank_stage(layout):
        ts = mt.IBISSampler(lambda t: -0.5 * t[0] ** 2 / tau ** 2,
                            lambda t, y: -0.5 * (y - t[0]) ** 2, None, n, 1,
                            batch_size=4, n_mcmc=3, target_ess=0.999,
                            dtype=torch.float64, mesh=layout)
        rows = ts._rows
        mine = start._replace(**{f: getattr(start, f)[rows] for f in (
            "particles", "log_prior", "loglik_cum", "log_w")})
        return ts.stage(mine, _t(ys), 8, 4,
                        noise=ti.StageNoise(_t(u0), moves))

    got = run_in_threads(8, rank_stage)
    for new_t, logz_t, moved in got:
        assert moved
        assert abs(float(logz_t) - float(logz_j)) < REPLAY_TOL
    for f in ("particles", "log_prior", "loglik_cum", "log_w"):
        np.testing.assert_allclose(
            torch.cat([getattr(g[0], f) for g in got]).numpy(),
            np.asarray(getattr(new_j, f)), rtol=0, atol=REPLAY_TOL,
            err_msg=f)


def test_eks_replays_jax_on_the_walker_mesh():
    """``test_eks.py::test_mesh_sharded_executes_and_agrees``'s sampler on
    ``make_walker_mesh()`` (and EKI on the same mesh) in float64, J = 16 (2
    members a rank), 6 iterations from JAX's draws: every rank's result is
    JAX's."""
    from mcmcpp_tpu import eks as jk
    from tests.test_torch_enkf_ukf_eks import P_DIM, _linear_problem

    a, y, gamma, c0, _, _ = _linear_problem()
    a, y, gamma, c0 = (x.astype(np.float64) for x in (a, y, gamma, c0))
    j_n, iters = 16, 6
    key = jax.random.key(3)
    with jax.enable_x64(True):
        fwd = lambda th: th @ jnp.asarray(a).T  # noqa: E731
        eki = jk.ensemble_kalman_inversion(key, fwd, y, gamma,
                                           np.zeros(P_DIM), c0, j_n, iters,
                                           mesh=j_walker_mesh())
        eks = jk.ensemble_kalman_sampler(key, fwd, y, gamma, np.zeros(P_DIM),
                                         c0, j_n, iters, mesh=j_walker_mesh())
        z_eki = np.asarray(jax.random.normal(key, (j_n, P_DIM), jnp.float64))
        k_init, k = jax.random.split(key)
        z0 = np.asarray(jax.random.normal(k_init, (j_n, P_DIM), jnp.float64))
        xis = []
        for _ in range(iters):
            k, k_noise = jax.random.split(k)
            xis.append(np.asarray(jax.random.normal(k_noise, (j_n, j_n),
                                                    jnp.float64)))
    tfwd = lambda th: th @ _t(a).mT  # noqa: E731

    def rank_runs(layout):
        return (mt.ensemble_kalman_inversion(
            0, tfwd, y, gamma, np.zeros(P_DIM), c0, j_n, iters,
            mesh=layout, noise=_t(z_eki)),
            mt.ensemble_kalman_sampler(
                0, tfwd, y, gamma, np.zeros(P_DIM), c0, j_n, iters,
                mesh=layout, noise=(_t(z0), lambda i: _t(xis[i]))))

    for got_eki, got_eks in run_in_threads(8, rank_runs):
        for want, got in ((eki, got_eki), (eks, got_eks)):
            for p, q in zip(got, want):
                np.testing.assert_allclose(p.numpy(), np.asarray(q), rtol=0,
                                           atol=REPLAY_TOL)


def test_svgd_replays_jax_on_the_walker_mesh():
    """``test_svgd.py::test_mesh_sharded_parity``'s SVGD (64 particles in
    2-D, the correlated Gaussian) on ``make_walker_mesh()`` in float64: ten
    steps from the same cloud, 8 particles a rank; the ranks' rows put
    together are JAX's cloud, and the |φ| trace is JAX's on every rank."""
    from mcmcpp_tpu import svgd as jsvgd
    from tests.test_svgd import PREC

    prec64 = np.asarray(PREC, np.float64)
    x0 = np.random.default_rng(5).normal(size=(64, 2)) * 2.0
    with jax.enable_x64(True):
        j = jsvgd.SVGD(lambda t: -0.5 * t @ jnp.asarray(prec64) @ t, 64, 2,
                       seed=0, dtype=jnp.float64, mesh=j_walker_mesh())
        j.init(x0)
        want = j.fit(10)
        want = (np.asarray(want.particles), np.asarray(
            want.grad_norm_history))

    def rank_fit(layout):
        t = mt.SVGD(lambda x: -0.5 * torch.sum((x @ _t(prec64)) * x, -1),
                    64, 2, dtype=torch.float64, batched=True, mesh=layout)
        t.init(x0)
        r = t.fit(10)
        return r.particles, r.grad_norm_history

    got = run_in_threads(8, rank_fit)
    np.testing.assert_allclose(torch.cat([g[0] for g in got]).numpy(),
                               want[0], rtol=REPLAY_TOL, atol=REPLAY_TOL)
    for g in got:
        np.testing.assert_allclose(g[1].numpy(), want[1], rtol=REPLAY_TOL,
                                   atol=REPLAY_TOL)


def test_pathfinder_replays_jax_on_the_walker_mesh():
    """``test_pathfinder.py::test_mesh_sharded_paths``'s multi-path run on
    ``make_walker_mesh()`` (8 paths, 1 a rank) in float64 from explicit
    starts on the banana, with JAX's per-path draws: each rank's path is
    JAX's path, and the Hill tail index of the gathered weights is JAX's
    on every rank."""
    from tests.test_torch_pathfinder_laplace import FIELDS, jax_banana, \
        jpf, torch_banana

    m, kw = 8, dict(maxiter=10, history=3, n_elbo_draws=6, seed=1)
    starts = np.random.default_rng(4).normal(size=(m, 2)) * 2.0
    with jax.enable_x64(True):
        key = jax.random.key(1)
        z, zf = [], []
        for i in range(m):
            k = jax.random.fold_in(key, i)
            z.append(jax.random.normal(jax.random.fold_in(k, 1), (6, 2),
                                       jnp.float64))
            zf.append(jax.random.normal(jax.random.fold_in(k, 2), (10, 2),
                                        jnp.float64))
        want = jpf.multi_pathfinder(jax_banana, m, starts, n_draws=50,
                                    draws_per_path=10, dtype=jnp.float64,
                                    mesh=j_walker_mesh(), **kw)
        paths = [np.asarray(x) for x in want.paths]
    noise = (torch.from_numpy(np.stack(z)), torch.from_numpy(np.stack(zf)))

    def rank_paths(layout):
        return mt.multi_pathfinder(
            torch_banana, m, starts, n_draws=50, draws_per_path=10,
            dtype=torch.float64, batched=True, mesh=layout, noise=noise,
            **kw)

    got = run_in_threads(8, rank_paths)
    for name, i in zip(FIELDS, range(len(FIELDS))):
        np.testing.assert_allclose(
            torch.cat([g.paths[i] for g in got]).numpy(), paths[i],
            rtol=REPLAY_TOL, atol=REPLAY_TOL, err_msg=name)
    for g in got:
        assert g.pareto_k == pytest.approx(want.pareto_k, rel=REPLAY_TOL)
        np.testing.assert_array_equal(g.draws, got[0].draws)


# -- two gloo ranks -----------------------------------------------------------

WORKER = textwrap.dedent("""
    import sys
    rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from mcmcpp_tpu_torch.parallel import distributed
    distributed.initialize(f"localhost:{{port}}", 2, rank, device="cpu")
    import mcmcpp_tpu_torch as mt
    from mcmcpp_tpu_torch.io.checkpoint import load_checkpoint, \\
        save_checkpoint
    from tests.torch_sharded_vi_ts_cases import ENGINES, YS, _pmmh_prior, \\
        _target, noise_free_ssm

    res = {{}}
    mesh = mt.make_walker_mesh()
    for name, case in ENGINES.items():
        for key, value in case(mesh).items():
            res[f"{{name}}/{{key}}"] = np.asarray(value)

    def refused(fn):
        try:
            fn()
            return "no error"
        except (ValueError, RuntimeError, NotImplementedError) as e:
            return type(e).__name__ + ": " + str(e)

    ssm = noise_free_ssm()
    samplers = {{
        "pmmh": mt.PMMHSampler(ssm, YS, _pmmh_prior, 1, n_particles=16,
                               n_chains=16, mesh=mesh).init(np.zeros(1)),
        "ibis": mt.IBISSampler(lambda t: -t[:, 0] ** 2,
                               lambda t, r: -(r[None] - t[:, :1]) ** 2,
                               lambda g, n: torch.randn((n, 1), generator=g),
                               16, 1, batched=True, mesh=mesh).init(),
        "smc2": mt.SMC2Sampler(ssm, _pmmh_prior, lambda g, n: torch.randn(
            (n, 1), generator=g), 16, 1, n_particles=8, mesh=mesh).init(),
        "advi": mt.ADVI(_target, 3, n_mc=16, batched=True, mesh=mesh),
        "neutra": mt.NeuTra(_target, 3, batched=True, mesh=mesh),
    }}
    for kind, s in samplers.items():
        res[f"ckpt/{{kind}}"] = refused(
            lambda: save_checkpoint(s, f"{{out}}/{{kind}}{{rank}}"))
        res[f"ckpt_load/{{kind}}"] = refused(
            lambda: load_checkpoint(s, f"{{out}}/{{kind}}{{rank}}"))
    res["cuda_under_gloo"] = refused(
        lambda: mt.SVGD(_target, 16, 3, mesh=mesh, device="cuda"))
    res["uneven"] = refused(lambda: mt.SMC2Sampler(ssm, _pmmh_prior, None,
                                                   9, 1, mesh=mesh))
    np.savez(f"{{out}}/rank{{rank}}.npz", **res)
    print("WORKER DONE", rank)
""").format(repo=str(REPO))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results of one two-process gloo run of every case."""
    out = tmp_path_factory.mktemp("sharded_vi_ts")
    script = out / "worker.py"
    script.write_text(WORKER)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(port), str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO,
        env=env) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-4000:]
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]


def _of(res, prefix):
    return {k[len(prefix):]: v for k, v in res.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("name", list(ENGINES))
def test_two_gloo_ranks_equal_the_unsharded_engine(ranks, name):
    check(name, [_of(res, name + "/") for res in ranks], unsharded(name), 2)


def test_two_gloo_ranks_refuse_checkpoints_and_the_card(ranks):
    """A rank holds only its rows (or, for ADVI and NeuTra, a run whose
    steps need the other rank): saving and loading raise over two ranks
    (in a group of one they work). No fallback: an engine asking for the
    card under gloo raises; an uneven split raises on every rank."""
    for res in ranks:
        for kind in ("pmmh", "ibis", "smc2", "advi", "neutra"):
            for what in ("ckpt", "ckpt_load"):
                assert "over 2 ranks" in str(res[f"{what}/{kind}"]), (
                    what, kind, res[f"{what}/{kind}"])
        assert str(res["cuda_under_gloo"]) != "no error"
        assert "n_theta=9 not divisible by mesh size 2" in str(res["uneven"])


@pytest.mark.parametrize("kind", ["pmmh", "ibis", "smc2"])
def test_a_group_of_one_checkpoints_a_sharded_engine(tmp_path, kind):
    """In a group of one a sharded PMMH, IBIS or SMC² holds every row: it
    saves and resumes bit for bit, as the unsharded one does."""
    from mcmcpp_tpu_torch.io.checkpoint import load_checkpoint, \
        save_checkpoint
    from tests.torch_sharded_vi_ts_cases import IBIS_DATA, YS, _pmmh_prior

    ssm = _local_level()[0]

    def build(lay, seed):
        if kind == "pmmh":
            return mt.PMMHSampler(ssm, YS, _pmmh_prior, 1, n_particles=16,
                                  n_chains=8, seed=seed, mesh=lay)
        if kind == "ibis":
            return mt.IBISSampler(
                lambda t: -0.125 * t[:, 0] ** 2,
                lambda t, r: -0.5 * (r[None] - t[:, :1]) ** 2,
                lambda g, n: 2 * torch.randn((n, 1), generator=g), 32, 1,
                batch_size=4, seed=seed, batched=True, mesh=lay)
        return mt.SMC2Sampler(ssm, _pmmh_prior, lambda g, n: torch.randn(
            (n, 1), generator=g), 16, 1, n_particles=8, seed=seed, mesh=lay)

    def advance(s, half):
        if kind == "pmmh":
            s.run(3)
            return s.get_samples()
        if kind == "ibis":
            s.update(IBIS_DATA[half * 8:(half + 1) * 8])
            return s.state.particles
        s.update(YS[half * 4:(half + 1) * 4])
        return s.state.theta

    def resume(lay):
        a = build(lay, 2)
        if kind == "pmmh":
            a.init(np.zeros(1))
        advance(a, 0)
        save_checkpoint(a, tmp_path / "a")
        want = advance(a, 1)
        b = load_checkpoint(build(lay, 9), tmp_path / "a")
        return want, advance(b, 1)

    (a, b), = run_in_threads(1, resume)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_the_engine_modules_import_no_jax():
    """The eleven modules of this layer and the parallel layer import
    neither JAX, the JAX package nor triton, and start no process
    group."""
    mods = ("neutra", "vi", "svgd", "pathfinder", "particle", "rbpf", "if2",
            "ibis", "smc2", "enkf", "eks", "parallel.mesh")
    code = ("import sys, torch\n"
            + "".join(f"import mcmcpp_tpu_torch.{m}\n" for m in mods)
            + "assert not torch.distributed.is_initialized()\n"
            "bad = [m for m in ('jax', 'triton', 'mcmcpp_tpu') "
            "if m in sys.modules]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
