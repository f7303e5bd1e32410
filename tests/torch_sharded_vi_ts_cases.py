"""Cases shared by ``tests/test_torch_sharded_vi_ts.py`` and its two-process
workers: the variational and time-series engines that take ``mesh=``, at
small sizes (16 to 64 particles, members, paths or chains, every axis
divisible by 4), on layouts whose ranks are threads of one process
(``tests/torch_sharded_engine_cases.py``). Imports neither JAX nor the JAX
package.

A case is ``fn(mesh) -> {key: value}``: ``mesh`` None runs the engine
unsharded on the CPU. A key's prefix says how the ranks' values make the
unsharded one: ``same:`` equal on every rank and to the unsharded value,
``rows0:``/``rows1:`` the ranks' values concatenated on axis 0/1, and
``close:`` equal on every rank (``close_rows1:`` concatenated on axis 1),
the unsharded value's bits in a group of one and within ``CLOSE_TOL`` of it
over more ranks (ADVI's and NeuTra's gradient sums round otherwise).

The hooks that draw noise in a user's model (rule (b) of
``mcmcpp_tpu_torch/parallel/mesh.py``) are noise-free here: the initial
cloud is a fixed table of which each rank's hook returns its rows, the
transitions are deterministic; so every case equals the unsharded run bit
for bit on any number of ranks, and the cases show that the collective
sites are exact. Some cases hand the engine's own draws over (a replay);
those whose names end in ``_drawn``, the smoother and ``if2`` let the
engine draw them from the caller's generator, which the hooks' fork must
not move.
"""

import importlib

import numpy as np
import torch

import mcmcpp_tpu_torch as mt
from mcmcpp_tpu_torch.particle import PMMHState, filter_shard

# the modules (the package exports a function named like the first)
tif2 = importlib.import_module("mcmcpp_tpu_torch.if2")
ts2 = importlib.import_module("mcmcpp_tpu_torch.smc2")

# gradient sums over R > 1 ranks: JAX's tolerance for its sharded ADVI and
# NeuTra (tests/test_smc_vi.py:86, tests/test_neutra.py:363)
CLOSE_TOL = 2e-3

T_N = 12
N = 32
_rng = np.random.default_rng(7)
YS = np.sin(np.arange(T_N) / 2.0).astype(np.float32)
X0 = torch.from_numpy(_rng.normal(size=(64, 1)).astype(np.float32))
U_RS = torch.from_numpy(_rng.uniform(size=T_N - 1).astype(np.float32))
SIG_Q, SIG_R = 0.35, 0.6


def _kw(mesh):
    return {"device": "cpu"} if mesh is None else {"mesh": mesh}


def _rank(mesh):
    return 0 if mesh is None else mesh.rank


def _mean(x, t):
    return 0.9 * x + 0.3 * torch.sin(x + t)


def noise_free_ssm(rank=0, guided=False):
    """A 1-D state-space model whose hooks draw nothing: the initial cloud
    is rank ``rank``'s rows of the table ``X0`` (the hook is handed the
    rank's count), the transition and (``guided``) the proposal are
    deterministic; ``theta``, when given, is the log observation sd."""

    def init_sample(gen, n, theta):
        return X0[rank * n:(rank + 1) * n].clone()

    def trans_sample(gen, x, t, theta):
        return _mean(x, t)

    def obs_logpdf(y, x, t, theta):
        if theta is None:
            z = (y[0] - x[..., 0]) / SIG_R
            return -0.5 * z * z
        z = (y[0] - x[..., 0]) / torch.exp(theta[..., 0])
        return -0.5 * z * z - theta[..., 0]

    def trans_logpdf(x_next, x, t, theta):
        z = (x_next[..., 0] - _mean(x, t)[..., 0]) / SIG_Q
        return -0.5 * z * z

    def prop_sample(gen, x, y, t, theta):
        return 0.5 * (_mean(x, t) + y[0])

    def prop_logpdf(x_next, x, y, t, theta):
        z = (x_next[..., 0] - 0.5 * (_mean(x, t)[..., 0] + y[0])) / 0.3
        return -0.5 * z * z

    return mt.StateSpaceModel(
        init_sample, trans_sample, obs_logpdf, trans_logpdf=trans_logpdf,
        trans_mean=lambda x, t, theta: _mean(x, t),
        prop_sample=prop_sample if guided else None,
        prop_logpdf=prop_logpdf if guided else None)


def _filter(auxiliary=False, guided=False):
    def case(mesh):
        r = mt.particle_filter(torch.Generator().manual_seed(3),
                               noise_free_ssm(_rank(mesh), guided), None,
                               YS, N, ess_frac=0.7, auxiliary=auxiliary,
                               return_particles=True, resample_u=U_RS,
                               **_kw(mesh))
        return {"same:loglik": r.loglik, "same:means": r.filter_means,
                "same:ess": r.ess, "same:particles": r.particles,
                "same:log_weights": r.log_weights}

    return case


def pf_drawn(mesh):
    """The filter and the forecast with their own resampling uniforms."""
    ssm = noise_free_ssm(_rank(mesh))
    gen = torch.Generator().manual_seed(3)
    r = mt.particle_filter(gen, ssm, None, YS, N, ess_frac=0.7,
                           return_particles=True, **_kw(mesh))
    xs, _ = mt.particle_forecast(gen, ssm, None, r.particles[-1],
                                 r.log_weights[-1], T_N, 4, **_kw(mesh))
    return {"same:loglik": r.loglik, "same:means": r.filter_means,
            "same:ess": r.ess, "same:particles": r.particles,
            "rows1:paths": xs}


def smoother(mesh):
    """The smoother with its own resampling uniforms and Gumbel noise."""
    r = mt.particle_smoother(torch.Generator().manual_seed(4),
                             noise_free_ssm(_rank(mesh)), None, YS, N, 8,
                             **_kw(mesh))
    return {"same:traj": r.trajectories, "same:means": r.smoothed_means,
            "same:loglik": r.loglik}


def forecast(mesh):
    ssm = noise_free_ssm(_rank(mesh))
    r = mt.particle_filter(torch.Generator().manual_seed(3), ssm, None, YS,
                           N, return_particles=True, resample_u=U_RS,
                           **_kw(mesh))
    xs, _ = mt.particle_forecast(
        torch.Generator().manual_seed(5), ssm, None, r.particles[-1],
        r.log_weights[-1], T_N, 4, resample_u=torch.tensor(0.3),
        **_kw(mesh))
    return {"rows1:paths": xs}


# -- PMMH -------------------------------------------------------------------

C = 16


def _pmmh_prior(th):
    return -0.5 * torch.sum(th * th, -1)


def pmmh_exact(mesh):
    """PMMH on a deterministic likelihood (the proposal normals and accept
    uniforms are the engine's own draws, drawn whole and cut)."""
    pm = mt.PMMHSampler(None, None, _pmmh_prior, 2, n_chains=C, seed=2,
                        proposal_scale=0.5, batched=True,
                        loglik_fn=lambda g, th: -0.5 * torch.sum(
                            (th - 1.0) ** 2, -1) / 0.3, **_kw(mesh))
    pm.init(np.zeros(2))
    pm.tune(20, window=5)
    pm.run(6)
    return {"rows1:samples": pm.get_samples(),
            "rows1:logps": pm.get_log_probs(),
            "same:accept": pm.acceptance_fraction}


def _pmmh_filter(ess_frac):
    def case(mesh):
        """PMMH over noise-free filters (their resampling uniforms drawn
        for every chain and cut)."""
        pm = mt.PMMHSampler(noise_free_ssm(), YS, _pmmh_prior, 1,
                            n_particles=16, n_chains=C, seed=1,
                            ess_frac=ess_frac, **_kw(mesh))
        pm.init(np.zeros(1))
        pm.run(4)
        return {"rows1:samples": pm.get_samples(),
                "rows1:logps": pm.get_log_probs(),
                "rows0:loglik": pm.state.loglik,
                "same:accept": pm.acceptance_fraction}

    return case


def pmmh_replay(mesh):
    """Three PMMH steps with every chain's proposal normals, accept
    uniforms and resampling uniforms handed over."""
    pm = mt.PMMHSampler(noise_free_ssm(), YS, _pmmh_prior, 1,
                        n_particles=16, n_chains=C, seed=1, **_kw(mesh))
    g = torch.Generator().manual_seed(8)
    pos = 0.1 * torch.randn((C, 1), generator=g)
    state = PMMHState(pos[pm._rows], torch.zeros(pm._n_local),
                      torch.zeros(pm._n_local),
                      torch.zeros(pm._n_local, dtype=torch.int32))
    out = []
    for _ in range(3):
        state = pm.step(state, pm._prop_chol,
                        z=torch.randn((C, 1), generator=g),
                        u=torch.rand((C,), generator=g),
                        resample_u=torch.rand((T_N - 1, C), generator=g))
        out.append(state.position)
    return {"rows1:positions": torch.stack(out),
            "rows0:loglik": state.loglik, "rows0:accepted": state.accepted}


# -- RBPF ---------------------------------------------------------------------

K = 3
Z0 = torch.from_numpy(_rng.integers(0, K, size=64))


def noise_free_switching(rank=0):
    """A switching model whose regime hooks draw nothing: z_1 is rank
    ``rank``'s rows of ``Z0``, z_t = (z_{t−1} + t) mod K."""
    a = torch.tensor([[[0.9]], [[0.5]], [[-0.3]]])
    b = torch.tensor([[0.0], [1.0], [-1.0]])
    q = torch.tensor([[[0.1]], [[0.2]], [[0.05]]])
    h = torch.ones((K, 1, 1))
    c = torch.zeros((K, 1))
    r = torch.tensor([[[0.3]], [[0.3]], [[0.6]]])
    model = mt.switching_model(np.full((K, K), 1.0 / K), a, b, q, h, c, r,
                               np.zeros(1), np.eye(1), device="cpu")
    return model._replace(
        z_init_sample=lambda gen, n: Z0[rank * n:(rank + 1) * n].clone(),
        z_trans_sample=lambda gen, z, t: (z + t) % K)


def rbpf(mesh):
    r = mt.rao_blackwell_filter(torch.Generator().manual_seed(6),
                                noise_free_switching(_rank(mesh)), YS, N,
                                ess_frac=0.8, resample_u=U_RS, **_kw(mesh))
    out = {f"same:{k}": getattr(r, k) for k in (
        "loglik", "x_means", "z_stats", "ess", "final_z", "final_means",
        "final_covs", "final_log_weights")}
    ms, cs, zs = mt.rbpf_forecast(
        torch.Generator().manual_seed(7), noise_free_switching(_rank(mesh)),
        r.final_z, r.final_means, r.final_covs, r.final_log_weights, T_N, 3,
        resample_u=torch.tensor(0.6), **_kw(mesh))
    out.update({"same:fc_means": ms, "same:fc_covs": cs, "same:fc_z": zs})
    return out


def rbpf_drawn(mesh):
    """The RBPF and its forecast with their own resampling uniforms."""
    gen = torch.Generator().manual_seed(6)
    r = mt.rao_blackwell_filter(gen, noise_free_switching(_rank(mesh)), YS,
                                N, ess_frac=0.8, **_kw(mesh))
    ms, cs, zs = mt.rbpf_forecast(
        gen, noise_free_switching(_rank(mesh)), r.final_z, r.final_means,
        r.final_covs, r.final_log_weights, T_N, 3, **_kw(mesh))
    return {"same:loglik": r.loglik, "same:x_means": r.x_means,
            "same:final_z": r.final_z, "same:fc_means": ms,
            "same:fc_z": zs}


# -- IF2 ----------------------------------------------------------------------

def _if2_ssm(rank):
    """IF2's per-particle-θ hooks, noise-free: θ (N, 2) = (log obs sd,
    drift)."""

    def init_sample(gen, n, theta):
        return X0[rank * n:(rank + 1) * n].clone()

    def trans_sample(gen, x, t, theta):
        return _mean(x, t) + theta[:, 1:]

    def obs_logpdf(y, x, t, theta):
        z = (y[0] - x[:, 0]) / torch.exp(theta[:, 0])
        return -0.5 * z * z - theta[:, 0]

    return mt.StateSpaceModel(init_sample, trans_sample, obs_logpdf)


def if2_pass(mesh):
    """Two IF2 data passes with every draw handed over (the swarm's
    perturbations and the resampling offsets, drawn whole)."""
    g = torch.Generator().manual_seed(9)
    gen, shard = filter_shard(mesh, torch.Generator(), "cpu", N)
    swarm = torch.randn((N, 2), generator=g) * 0.2
    out = {}
    for i in range(2):
        noise = (torch.randn((N, 2), generator=g),
                 torch.rand((T_N - 1,), generator=g),
                 torch.randn((T_N - 1, N, 2), generator=g),
                 torch.rand((), generator=g))
        swarm, ll = tif2.one_pass(gen, _if2_ssm(_rank(mesh)),
                                  torch.from_numpy(YS)[:, None], swarm,
                                  torch.tensor([0.05, 0.02]), 0.8, noise,
                                  shard=shard)
        out[f"same:swarm{i}"], out[f"same:ll{i}"] = swarm, ll
    return out


def if2(mesh):
    """Three IF2 passes that draw their initial swarm, perturbations and
    resampling offsets themselves."""
    r = tif2.if2(torch.Generator().manual_seed(9), _if2_ssm(_rank(mesh)),
                 YS, N, np.array([0.0, 0.1], np.float32), 0.2, n_iters=3,
                 ess_frac=0.8, **_kw(mesh))
    return {"same:swarm": r.swarm, "same:theta_trace": r.theta_trace,
            "same:sd_trace": r.theta_sd_trace,
            "same:loglik_trace": r.loglik_trace}


# -- IBIS and SMC² ------------------------------------------------------------

IBIS_DATA = (0.8 + _rng.normal(size=40)).astype(np.float32)


def ibis(mesh):
    s = mt.IBISSampler(
        lambda t: -0.125 * t[:, 0] ** 2,
        lambda t, rows: -0.5 * (rows[None, :] - t[:, :1]) ** 2,
        lambda g, n: 2.0 * torch.randn((n, 1), generator=g), 64, 1,
        batch_size=4, n_mcmc=2, seed=3, max_chunk_steps=4, batched=True,
        **_kw(mesh))
    s.update(IBIS_DATA[:24])
    s.update(IBIS_DATA[24:])
    mean, cov = s.moments()
    return {"same:logz": s.log_evidence,
            "same:trace": np.asarray(s.log_evidence_trace),
            "same:resamples": s.n_resamples, "rows0:particles":
            s.state.particles, "rows0:loglik": s.state.loglik_cum,
            "same:mean": mean, "same:cov": cov,
            "same:posterior": s.posterior(16, seed=1)}


def _smc2(mesh, ess_frac_x):
    return ts2.SMC2Sampler(
        noise_free_ssm(), _pmmh_prior,
        lambda g, n: 0.5 * torch.randn((n, 1), generator=g) - 0.5, 16, 1,
        n_particles=8, n_mcmc=2, target_ess=0.7, ess_frac_x=ess_frac_x,
        seed=4, max_chunk_steps=3, **_kw(mesh))


def smc2(mesh):
    """A whole SMC² run with noise-free hooks."""
    s = _smc2(mesh, 0.5)
    s.update(YS[:7])
    s.update(YS[7:])
    mean, cov = s.moments()
    return {"same:logz": s.log_evidence,
            "same:trace": np.asarray(s.log_evidence_trace),
            "same:moved": s.n_resamples,
            "same:accept": s.last_rejuvenation_accept,
            "rows0:theta": s.state.theta, "rows0:xs": s.state.xs,
            "same:mean": mean, "same:cov": cov,
            "same:state": s.state_estimate()}


def smc2_stage(mesh):
    """Rejuvenating stages with the x-systems resampling every step, every
    draw handed over as a ``StageNoise``."""
    s = _smc2(mesh, 1.0).init()
    s._ys = torch.from_numpy(YS)[:, None]
    g = torch.Generator().manual_seed(10)
    state, out = s.state, {}
    for t in range(4):
        noise = ts2.StageNoise(
            torch.rand((16,), generator=g), torch.rand((), generator=g),
            [(torch.randn((16, 1), generator=g),
              torch.rand((t, 16), generator=g),
              torch.rand((16,), generator=g)) for _ in range(2)])
        state, logz, moved, acc = s.stage(state, s._ys, t, noise)
        out[f"same:logz{t}"] = logz
        out[f"same:moved{t}"] = moved
        out[f"same:acc{t}"] = acc
    out.update({"rows0:theta": state.theta, "rows0:xs": state.xs,
                "rows0:loglik": state.loglik_hat})
    return out


# -- EnKF, EKI, EKS -----------------------------------------------------------

def _enkf_model(rank):
    def init_sample(gen, n):
        return torch.cat([X0[rank * n:(rank + 1) * n],
                          X0[rank * n:(rank + 1) * n] ** 2 - 1.0], 1)

    def trans_sample(gen, x, t):
        return torch.stack([_mean(x[:, 0], t) + 0.1 * x[:, 1],
                            0.8 * x[:, 1]], 1)

    return mt.EnKFModel(init_sample, trans_sample, lambda x, t: x[:, :1],
                        torch.tensor([[0.36]]))


def _enkf(variant, drawn=False):
    def case(mesh):
        noise = (torch.randn((T_N, N, 1), generator=torch.Generator(
        ).manual_seed(11)) if variant == "stochastic" and not drawn
            else None)
        r = mt.ensemble_kalman_filter(
            torch.Generator().manual_seed(12), _enkf_model(_rank(mesh)), YS,
            N, inflation=1.05, variant=variant, obs_noise=noise,
            **_kw(mesh))
        return {"same:loglik": r.loglik, "same:means": r.means,
                "same:spread": r.spread, "same:ensemble": r.ensemble}

    return case


_A = torch.from_numpy(_rng.normal(size=(5, 3)).astype(np.float32))
_Y = (_A @ torch.tensor([0.5, -1.0, 2.0]) + 0.3).numpy()


def _forward(th):
    return th @ _A.mT + 0.1 * torch.sin(th[:, :1])


def eki(mesh):
    r = mt.ensemble_kalman_inversion(
        torch.Generator().manual_seed(13), _forward, _Y, 0.25 * np.ones(5),
        np.zeros(3), 4.0 * np.eye(3), N, 8, **_kw(mesh))
    return {"same:theta": r.theta, "same:ensemble": r.ensemble,
            "same:misfit": r.misfit_trace}


def eks(mesh):
    r = mt.ensemble_kalman_sampler(
        torch.Generator().manual_seed(14), _forward, _Y, 0.25 * np.ones(5),
        np.zeros(3), 4.0 * np.eye(3), N, 8, **_kw(mesh))
    return {"same:ensemble": r.ensemble, "same:mean": r.mean,
            "same:cov": r.cov, "same:misfit": r.misfit_trace}


# -- SVGD, Pathfinder, ADVI, NeuTra -------------------------------------------

def _target(t):
    return -0.5 * torch.sum((t - 1.0) ** 2, -1) + 0.1 * torch.sin(t[..., 0])


def _svgd(bandwidth):
    def case(mesh):
        s = mt.SVGD(_target, N, 3, bandwidth=bandwidth, batched=True,
                    **_kw(mesh))
        s.init(scale=2.0, seed=5)
        r = s.fit(15)
        return {"rows0:particles": r.particles,
                "same:grad_norms": r.grad_norm_history,
                "rows0:samples": s.get_samples()}

    return case


def pathfinder(mesh):
    r = mt.multi_pathfinder(_target, 8, np.zeros(3), n_draws=64, maxiter=8,
                            history=4, n_elbo_draws=6, draws_per_path=16,
                            batched=True, **_kw(mesh))
    return {"same:draws": r.draws, "same:pareto_k": r.pareto_k,
            "rows0:path_draws": r.paths.draws,
            "rows0:elbos": r.paths.elbo_history}


def _advi(full_rank):
    def case(mesh):
        a = mt.ADVI(_target, 3, full_rank=full_rank, n_mc=16,
                    learning_rate=0.05, seed=2, batched=True, **_kw(mesh))
        a.fit(30)
        return {"close:trace": np.asarray(a.elbo_trace),
                "close:mean": a.mean, "close:cov": a.cov}

    return case


def neutra(mesh):
    nt = mt.NeuTra(_target, 3, flow=mt.RealNVP(3, n_layers=2, hidden=8),
                   seed=3, batched=True, **_kw(mesh))
    nt.fit(20, batch=16, learning_rate=1e-2)
    draws = np.random.default_rng(1).normal(size=(64, 3)).astype(np.float32)
    nt.refit_forward_kl(draws, n_steps=5, batch=16)
    s = nt.make_sampler(mt.HMCSampler, 16, n_leapfrog=2)
    s.run(2)
    params = np.concatenate([p.detach().numpy().ravel() for p in nt.params])
    return {"close:elbo": nt.fit_result.elbo_history,
            "close:refit": nt.refit_result.elbo_history,
            "close:params": params, "close_rows1:chain": s.get_samples()}


ENGINES = {
    "pf_bootstrap": _filter(),
    "pf_auxiliary": _filter(auxiliary=True),
    "pf_guided": _filter(guided=True),
    "pf_drawn": pf_drawn,
    "smoother": smoother,
    "forecast": forecast,
    "pmmh_exact": pmmh_exact,
    "pmmh_filter": _pmmh_filter(0.5),
    "pmmh_filter_resampling": _pmmh_filter(1.0),
    "pmmh_replay": pmmh_replay,
    "rbpf": rbpf,
    "rbpf_drawn": rbpf_drawn,
    "if2_pass": if2_pass,
    "if2": if2,
    "ibis": ibis,
    "smc2": smc2,
    "smc2_stage": smc2_stage,
    "enkf_etkf": _enkf("etkf"),
    "enkf_stochastic": _enkf("stochastic"),
    "enkf_stochastic_drawn": _enkf("stochastic", drawn=True),
    "eki": eki,
    "eks": eks,
    "svgd": _svgd("median"),
    "svgd_fixed": _svgd(1.5),
    "pathfinder": pathfinder,
    "advi": _advi(False),
    "advi_full_rank": _advi(True),
    "neutra": neutra,
}


def assemble(key, parts):
    """The unsharded value of ``key`` from the ranks' ``parts``."""
    kind = key.split(":")[0]
    parts = [np.asarray(p) for p in parts]
    if kind in ("rows0", "rows1", "close_rows1"):
        return np.concatenate(parts, axis=int(kind[-1]))
    raise ValueError(key)


def check(name, results, want, world):
    """The ranks' ``results`` of case ``name`` against its unsharded run
    ``want``: ``same:`` bit for bit on every rank, ``rows`` put together
    bit for bit, ``close:`` equal on every rank and within ``CLOSE_TOL``
    (bit for bit in a group of one), ``close_rows1`` put together so."""
    assert set(results[0]) == set(want), name
    for key, value in want.items():
        if key.startswith("close_rows1:"):
            got = assemble(key, [res[key] for res in results])
            if world == 1:
                np.testing.assert_array_equal(got, np.asarray(value))
            else:
                np.testing.assert_allclose(got, np.asarray(value),
                                           rtol=CLOSE_TOL, atol=CLOSE_TOL,
                                           err_msg=f"{name} {key}")
            continue
        if key.split(":")[0] in ("same", "close"):
            for r, res in enumerate(results):
                got = np.asarray(res[key])
                np.testing.assert_array_equal(
                    got, np.asarray(results[0][key]),
                    err_msg=f"{name} {key} rank {r} != rank 0")
                if key.startswith("same:") or world == 1:
                    np.testing.assert_array_equal(
                        got, np.asarray(value), err_msg=f"{name} {key}")
                else:
                    np.testing.assert_allclose(
                        got, np.asarray(value), rtol=CLOSE_TOL,
                        atol=CLOSE_TOL, err_msg=f"{name} {key}")
            continue
        np.testing.assert_array_equal(
            assemble(key, [res[key] for res in results]), np.asarray(value),
            err_msg=f"{name} {key}")
