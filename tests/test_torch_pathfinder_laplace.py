"""The port's Pathfinder, BFGS and Laplace held against the JAX package.

- Pathfinder in float64 on a logistic regression: the L-BFGS path (logp
  along it), every iterate's ELBO on JAX's base draws, the chosen iterate,
  its mean, the draws and their importance log-weights agree to 1e-9; M
  paths from explicit starts, as one batch, agree path by path with the JAX
  package's vmapped paths; the Hill tail index of the pooled weights is
  JAX's.
- BFGS (``find_map``) in float64 from several starts, on the logistic
  regression and on the Rosenbrock banana (whose line searches zoom): each
  start's optimum to 1e-8, the best start, ``converged``, and the
  iteration and evaluation counts of ``jax.scipy.optimize.minimize``.
- ``laplace``: mean, covariance and log evidence against JAX in float64
  (1e-8), and exact on a Gaussian.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmcpp_tpu_torch as mt

# the modules (both packages export functions named like them)
jml = importlib.import_module("mcmcpp_tpu.map_laplace")
jpf = importlib.import_module("mcmcpp_tpu.pathfinder")
tml = importlib.import_module("mcmcpp_tpu_torch.map_laplace")
tpf = importlib.import_module("mcmcpp_tpu_torch.pathfinder")

torch.set_num_threads(1)

TOL = 1e-9
N, P = 40, 3
_rng = np.random.default_rng(0)
X = _rng.normal(size=(N, P))
Y = (_rng.uniform(size=N) < 1 / (1 + np.exp(-X @ np.array([1.0, -0.5, 0.3]))
                                   )).astype(np.float64)


def jax_logreg(w):
    z = jnp.asarray(X) @ w
    return (jnp.sum(jnp.asarray(Y) * z - jnp.logaddexp(0.0, z))
            - 0.5 * jnp.sum(w * w) / 4.0)


def torch_logreg(w):
    z = w @ torch.from_numpy(X).T
    return (torch.sum(torch.from_numpy(Y) * z - torch.logaddexp(
        torch.zeros_like(z), z), -1) - 0.5 * torch.sum(w * w, -1) / 4.0)


def jax_banana(t):
    return -(0.05 * (1.0 - t[0]) ** 2 + (t[1] - t[0] ** 2) ** 2)


def torch_banana(t):
    return -(0.05 * (1.0 - t[..., 0]) ** 2 + (t[..., 1] - t[..., 0] ** 2) ** 2)


def _close(a, b, tol=TOL, name=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol, err_msg=name)


FIELDS = ("draws", "logw", "elbo_history", "best_iter", "mean", "path_logp")


def test_single_path_replays_jax_float64():
    kw = dict(maxiter=12, history=4, n_elbo_draws=8, n_draws=16, seed=2)
    init = np.array([2.0, 2.0, -2.0])
    with jax.enable_x64(True):
        key = jax.random.key(2)
        z = np.asarray(jax.random.normal(jax.random.fold_in(key, 1), (8, P),
                                         jnp.float64))
        zf = np.asarray(jax.random.normal(jax.random.fold_in(key, 2),
                                          (16, P), jnp.float64))
        want = jax.jit(lambda x: jpf.pathfinder(
            jax_logreg, x, dtype=jnp.float64, **kw))(jnp.asarray(init))
        want = [np.asarray(x) for x in want]
    got = tpf.pathfinder(torch_logreg, init, dtype=torch.float64,
                         batched=True, device="cpu",
                         noise=(torch.from_numpy(z), torch.from_numpy(zf)),
                         **kw)
    for name, a, b in zip(FIELDS, want, got):
        _close(b.numpy(), a, name=name)
    assert np.isfinite(want[2]).sum() > 1  # several valid iterates


def test_multi_path_replays_jax_float64():
    """The paths of ``jpf.multi_pathfinder`` from explicit starts: its
    vmap of ``pathfinder`` over (start, fold), here under jit."""
    m, kw = 4, dict(maxiter=10, history=3, n_elbo_draws=6, seed=1)
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
        paths = jax.jit(jax.vmap(lambda st, i: jpf.pathfinder(
            jax_banana, st, n_draws=10, dtype=jnp.float64, fold=i, **kw)))(
                jnp.asarray(starts), jnp.arange(m, dtype=jnp.int32))
        paths = [np.asarray(x) for x in paths]
    got = tpf.multi_pathfinder(
        torch_banana, m, starts, n_draws=50, draws_per_path=10,
        dtype=torch.float64, batched=True, device="cpu",
        noise=(torch.from_numpy(np.stack(z)), torch.from_numpy(np.stack(zf))),
        **kw)
    for name, a, b in zip(FIELDS, paths, got.paths):
        _close(b.numpy(), a, name=name)
    assert got.pareto_k == pytest.approx(
        jpf._hill_khat(paths[1].reshape(-1)), rel=1e-9)
    pooled = got.paths.draws.reshape(-1, 2).numpy()
    assert got.draws.shape == (50, 2)
    assert all(np.any(np.all(pooled == d, axis=1)) for d in got.draws)
    lw = np.random.default_rng(0).normal(size=100)
    assert tpf._hill_khat(lw) == jpf._hill_khat(lw)


@pytest.mark.parametrize("target", ["logreg", "banana"])
def test_find_map_replays_jax_bfgs_float64(target):
    jlogp, tlogp, p = {"logreg": (jax_logreg, torch_logreg, P),
                       "banana": (jax_banana, torch_banana, 2)}[target]
    starts = np.random.default_rng(5).normal(size=(5, p)) * 1.5
    with jax.enable_x64(True):
        # what jml.find_map runs (a vmapped jax.scipy BFGS), with the counts
        def solve(x):
            r = jax.scipy.optimize.minimize(lambda t: -jlogp(t), x,
                                            method="BFGS",
                                            options={"maxiter": 200})
            return r.x, -r.fun, r.success, r.nit, r.nfev, r.status

        xs, lps, succ, nit, nfev, status = (
            np.asarray(a) for a in jax.jit(jax.vmap(solve))(
                jnp.asarray(starts)))
    best = int(np.argmax(np.where(np.isnan(lps), -np.inf, lps)))
    want = (xs[best], lps[best], succ[best], xs, lps)
    got = tml.find_map(tlogp, starts, maxiter=200, dtype=torch.float64,
                       batched=True, device="cpu")
    for name, a, b in zip(tml.MapResult._fields, want, got):
        _close(b.numpy(), a, tol=1e-8, name=name)
    res = tml.bfgs(tlogp, torch.from_numpy(starts), maxiter=200)
    np.testing.assert_array_equal(res.success.numpy(), succ)
    np.testing.assert_array_equal(res.nit.numpy(), nit)
    np.testing.assert_array_equal(res.nfev.numpy(), nfev)
    np.testing.assert_array_equal(res.status.numpy(), status)
    assert res.success.any() and res.host_syncs > int(nit.max())


def test_laplace_replays_jax_float64():
    """Both packages' Laplace step at the port's mode (the BFGS that finds
    it is held against JAX's above)."""
    mode = tml.find_map(torch_logreg, np.zeros((2, P)), dtype=torch.float64,
                        batched=True, device="cpu")
    with jax.enable_x64(True):
        lap = jml.laplace(jax_logreg, map_result=jml.MapResult(
            *(jnp.asarray(x.numpy()) for x in mode)))
        want = [np.asarray(x) for x in lap]
        j_summary = jml.laplace_summary(lap)
    got = tml.laplace(torch_logreg, map_result=mode, batched=True,
                      device="cpu")
    for name, a, b in zip(tml.LaplaceResult._fields, want, got):
        _close(b.numpy(), a, tol=1e-8, name=name)
    summary = tml.laplace_summary(got)
    for k in ("mean", "sd"):
        _close(summary[k], j_summary[k], tol=1e-8)
    assert summary["log_evidence"] == pytest.approx(
        j_summary["log_evidence"], rel=1e-10)
    draws = tml.laplace_sample(torch.Generator().manual_seed(0), got, 4000)
    _close(draws.mean(0).numpy(), want[0], tol=0.1)


def test_laplace_is_exact_on_a_gaussian():
    cov = np.array([[2.0, 0.5, 0.0], [0.5, 1.0, 0.3], [0.0, 0.3, 0.5]])
    prec = torch.from_numpy(np.linalg.inv(cov))
    mu = torch.tensor([1.0, -1.0, 0.5], dtype=torch.float64)

    def logp(x):
        d = x - mu
        return -0.5 * torch.sum((d @ prec) * d, -1)

    lap = mt.laplace(logp, np.zeros(3), dtype=torch.float64, batched=True,
                     device="cpu")
    _close(lap.mean.numpy(), mu.numpy(), tol=1e-6)
    _close(lap.covariance.numpy(), cov, tol=1e-10)
    log_ev = 0.5 * 3 * np.log(2 * np.pi) + 0.5 * np.linalg.slogdet(cov)[1]
    assert float(lap.log_evidence) == pytest.approx(log_ev, rel=1e-10)
    with pytest.raises(ValueError, match="x0 or map_result"):
        mt.laplace(logp, device="cpu")
    with pytest.raises(ValueError, match="positive definite"):
        mt.laplace(lambda x: torch.sum(x * x, -1), np.zeros(2),
                   dtype=torch.float64, batched=True, device="cpu",
                   maxiter=1)
