"""Blocked Gibbs in the port against the JAX package, on the CPU.

Each of the eight conditional kernels replays JAX's: the JAX kernel's
``step`` vmapped over 32 chains with one key each, against the port's
``apply`` on the whole batch with the draws JAX made, re-derived from each
chain's key as the JAX kernel splits it (the categorical block gets JAX's
Gumbel noise, the elliptical slice loop every iteration's uniform, HMC each
chain's leapfrog count). Tolerance: 1e-5 (float32, sums and products in
another order, torch's sin and cos against XLA's), 1e-4 for HMC's eight
leapfrog steps and the interweaving kernels' three chained updates; accept
decisions equal. One whole sweep of a two-block sampler replays JAX's
``_sweep`` with ``fold_in(key, block)`` keys. The rest mirrors
``tests/test_gibbs.py`` at small sizes (C ≤ 64) with its bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmcpp_tpu import gibbs as jg
import mcmcpp_tpu_torch as mt
from mcmcpp_tpu_torch import gibbs as tg

torch.set_num_threads(1)

C = 32
F32 = jnp.float32
TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _keys(seed, c=C):
    return jax.random.split(jax.random.key(seed), c)


def _stack(per_chain):
    """A list over chains of noise tuples -> one tuple of stacked tensors."""
    return tuple(_t(np.stack([np.asarray(n[i]) for n in per_chain]))
                 for i in range(len(per_chain[0])))


# -- JAX's per-chain draws, in the port's layout ----------------------------


def rwm_noise(keys, size):
    out = []
    for k in keys:
        kp, ka = jax.random.split(k)
        out.append((jax.random.normal(kp, (size,), F32),
                    -jax.random.exponential(ka, (), F32)))
    return _stack(out)


mala_noise = rwm_noise


def hmc_noise(keys, size, n_leapfrog):
    out = []
    for k in keys:
        kp, kl, ka = jax.random.split(k, 3)
        out.append((jax.random.normal(kp, (size,), F32),
                    jax.random.randint(kl, (), 1, n_leapfrog + 1),
                    -jax.random.exponential(ka, (), F32)))
    p0, n, log_u = _stack(out)
    return p0, n.to(torch.int64), log_u


def ess_noise(keys, size, max_shrink=64):
    z, u, th, planes = [], [], [], []
    for k in keys:
        k_nu, k_u, k_theta, k_shrink = jax.random.split(k, 4)
        z.append(jax.random.normal(k_nu, (size,), F32))
        u.append(jax.random.uniform(k_u, (), F32, minval=1e-37))
        th.append(jax.random.uniform(k_theta, (), F32, 0.0, 2.0 * jnp.pi))
        row, kk = [], k_shrink
        for _ in range(max_shrink):
            kk, sub = jax.random.split(kk)
            row.append(jax.random.uniform(sub, (), F32))
        planes.append(row)
    planes = _t(np.asarray(planes).T)  # (max_shrink, C)
    return (_t(np.stack(z)), _t(np.stack(u)), _t(np.stack(th)),
            lambda j: planes[j])


def gumbel_noise(keys):
    def gumbel(shape):
        return _t(np.stack([jax.random.gumbel(k, tuple(shape[1:]), F32)
                            for k in keys]))

    return gumbel


def _jstep(kernel, keys, x, others=None):
    others = {} if others is None else others
    return jax.vmap(kernel.step)(keys, x, others)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


# -- conditionals shared by the replays ---------------------------------------

N = 3
Y = np.array([0.7, -1.2, 0.4], np.float32)


def j_cond(x, o):
    return -0.5 * jnp.sum((x - 0.3 * o["m"]) ** 2 * jnp.asarray(
        [1.0, 2.0, 0.5])) + jnp.sum(jnp.sin(x))


def t_cond(x, o):
    return -0.5 * torch.sum((x - 0.3 * o["m"]) ** 2 * torch.tensor(
        [1.0, 2.0, 0.5])) + torch.sum(torch.sin(x))


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(C, N)) * 0.8).astype(np.float32)
    m = rng.normal(size=(C, N)).astype(np.float32)
    return x, m


@pytest.mark.parametrize("name", ["rwm", "mala", "hmc"])
def test_metropolis_kernels_replay_jax(name):
    x, m = _inputs(1)
    keys = _keys(2)
    if name == "rwm":
        jk, tk = jg.RWMKernel(j_cond, 0.9), tg.RWMKernel(t_cond, 0.9)
        noise, tol = rwm_noise(keys, N), TOL
    elif name == "mala":
        jk, tk = jg.MALAKernel(j_cond, 0.8), tg.MALAKernel(t_cond, 0.8)
        noise, tol = mala_noise(keys, N), TOL
    else:
        jk = jg.HMCKernel(j_cond, 0.3, n_leapfrog=8)
        tk = tg.HMCKernel(t_cond, 0.3, n_leapfrog=8)
        noise, tol = hmc_noise(keys, N, 8), 1e-4
        assert len(set(noise[1].tolist())) > 4  # counts vary by chain
    want = _jstep(jk, keys, jnp.asarray(x), {"m": jnp.asarray(m)})
    got = tk.apply(noise, _t(x), {"m": _t(m)})
    moved_j = np.any(np.asarray(want) != x, axis=1)
    moved_t = np.any(got.numpy() != x, axis=1)
    np.testing.assert_array_equal(moved_t, moved_j)
    assert 0 < moved_j.sum() < C
    _close(got, want, tol)


@pytest.mark.parametrize("prior", ["chol", "scale", "chol_fn"])
def test_elliptical_slice_kernel_replays_jax(prior):
    x, m = _inputs(3)
    keys = _keys(4)
    a = np.random.default_rng(5).normal(size=(N, N))
    chol = np.linalg.cholesky(a @ a.T / N + np.eye(N)).astype(np.float32)
    spec = {"chol": dict(prior_chol=chol),
            "scale": dict(prior_scale=np.array([0.5, 1.0, 2.0], np.float32)),
            "chol_fn": None}[prior]
    if spec is None:
        jspec = dict(prior_chol=lambda o: jnp.asarray(chol) * (
            1.0 + 0.1 * jnp.tanh(o["m"][0])), prior_mean=lambda o: 0.2 * o["m"])
        tspec = dict(prior_chol=lambda o: torch.from_numpy(chol) * (
            1.0 + 0.1 * torch.tanh(o["m"][0])), prior_mean=lambda o: 0.2 * o["m"])
    else:
        jspec = tspec = spec

    def j_like(v, o):
        return -0.5 * jnp.sum((jnp.asarray(Y) - v) ** 2) / 0.3

    def t_like(v, o):
        return -0.5 * torch.sum((torch.from_numpy(Y) - v) ** 2) / 0.3

    jk = jg.EllipticalSliceKernel(j_like, **jspec)
    tk = tg.EllipticalSliceKernel(t_like, **tspec)
    want = _jstep(jk, keys, jnp.asarray(x), {"m": jnp.asarray(m)})
    got = tk.apply(ess_noise(keys, N), _t(x), {"m": _t(m)})
    _close(got, want)
    assert tk.counters["iterations"] >= 4 and tk.counters["syncs"] >= 1


def test_categorical_kernel_replays_jax():
    """argmax(logits + Gumbel) on JAX's Gumbel draws equals
    ``jax.random.categorical``'s choice, site by site."""
    s, v = 6, 4
    rng = np.random.default_rng(6)
    table = rng.normal(size=(s, v)).astype(np.float32)
    x, m = _inputs(7)

    def j_logits(o):
        return jnp.asarray(table) + o["m"][0]

    def t_logits(o):
        return torch.from_numpy(table) + o["m"][0]

    keys = _keys(8)
    want = _jstep(jg.CategoricalGibbsKernel(j_logits), keys,
                  jnp.zeros((C, s)), {"m": jnp.asarray(m)})
    got = tg.CategoricalGibbsKernel(t_logits).apply(
        gumbel_noise(keys), torch.zeros((C, s)), {"m": _t(m)})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.float32 and len(np.unique(got.numpy())) == v


def test_exact_gibbs_kernel_replays_jax():
    """A conjugate draw: JAX's ``sample_fn(key, others)`` and the port's
    ``sample_fn(gen, others)`` on the same normals (handed over through a
    batched sampler function)."""
    keys = _keys(9)
    x, m = _inputs(9)

    def j_sample(key, o):
        return 0.5 * o["m"][:2] + 0.3 * jax.random.normal(key, (2,))

    z = _t(np.stack([jax.random.normal(k, (2,)) for k in keys]))

    def t_sample(gen, o):  # batched: others (C, 3) -> (C, 2)
        return 0.5 * o["m"][:, :2] + 0.3 * z

    want = _jstep(jg.ExactGibbsKernel(j_sample), keys, jnp.zeros((C, 2)),
                  {"m": jnp.asarray(m)})
    k = tg.ExactGibbsKernel(t_sample, batched=True)
    got = k.apply(k.draw_noise(None, torch.zeros((C, 2)), {}),
                  torch.zeros((C, 2)), {"m": _t(m)})
    _close(got, want)


def _gaussian_interweave_pair():
    def make(np_mod, solve):
        def loglike(f):
            return -0.5 * np_mod.sum((np_mod.asarray(Y) if np_mod is jnp
                                      else torch.from_numpy(Y)) - f) ** 2 \
                / 0.09

        def chol(h):
            eye = np_mod.eye(N) if np_mod is jnp else torch.eye(N)
            return np_mod.exp(h[0]) * eye + 0.1 * np_mod.tril(
                np_mod.ones((N, N)) if np_mod is jnp else torch.ones((N, N)),
                -1)

        def prior(h):
            return -0.5 * np_mod.sum(h * h)

        return loglike, chol, prior

    jl, jc, jp = make(jnp, None)
    tl, tc, tp = make(torch, None)
    return ((jl, jc, jp), (tl, tc, tp))


def test_gaussian_interweave_kernel_replays_jax():
    (jl, jc, jp), (tl, tc, tp) = _gaussian_interweave_pair()
    jk = jg.GaussianInterweaveKernel(jl, jc, jp,
                                     lambda lp: jg.RWMKernel(lp, 0.4))
    tk = tg.GaussianInterweaveKernel(tl, tc, tp,
                                     lambda lp: tg.RWMKernel(lp, 0.4))
    rng = np.random.default_rng(10)
    h = (rng.normal(size=(C, 1)) * 0.3).astype(np.float32)
    e = rng.normal(size=(C, N)).astype(np.float32)
    keys = _keys(11)
    want = jax.vmap(jk.step)(keys, (jnp.asarray(h), jnp.asarray(e)), {})
    k012 = [jax.random.split(k, 3) for k in keys]
    noise = (ess_noise([k[0] for k in k012], N),
             rwm_noise([k[1] for k in k012], 1),
             rwm_noise([k[2] for k in k012], 1))
    got = tk.apply(noise, (_t(h), _t(e)), {})
    _close(got[0], want[0], 1e-4)
    _close(got[1], want[1], 1e-4)
    assert not np.array_equal(got[0].numpy(), h)


def _sinh_pair(np_mod):
    def forward(h, e):
        return np_mod.exp(h[0]) * np_mod.sinh(e)

    def inverse(h, f):
        return np_mod.arcsinh(f * np_mod.exp(-h[0])) if np_mod is jnp else \
            torch.asinh(f * torch.exp(-h[0]))

    def log_det_inverse(h, f):
        c2 = (f * np_mod.exp(-h[0])) ** 2
        return np_mod.sum(-h[0] - 0.5 * np_mod.log1p(c2))

    return forward, inverse, log_det_inverse


YI = np.array([0.4, -1.2, 0.9], np.float32)


def _interweave(mod, pkg, ldet):
    fwd, inv, ld = _sinh_pair(mod)
    yy = jnp.asarray(YI) if mod is jnp else torch.from_numpy(YI)
    return pkg.InterweaveKernel(
        fwd, inv, anc_logpdf=lambda e: -0.5 * mod.sum(e * e),
        loglike=lambda f: -0.5 * mod.sum((yy - f) ** 2),
        hyper_logprior=lambda h: -0.5 * mod.sum(h * h),
        make_hyper_kernel=lambda lp: pkg.RWMKernel(lp, 0.3),
        log_det_inverse=ld if ldet else None)


@pytest.mark.parametrize("ldet", [True, False], ids=["analytic", "jacfwd"])
def test_interweave_kernel_replays_jax(ldet):
    """The general ASIS kernel with the analytic log-Jacobian and with the
    fallback (``jax.jacfwd`` + ``slogdet`` there, ``torch.func.jacfwd`` +
    ``torch.linalg.slogdet`` here)."""
    jk, tk = _interweave(jnp, jg, ldet), _interweave(torch, tg, ldet)
    rng = np.random.default_rng(12)
    h = (rng.normal(size=(C, 1)) * 0.3).astype(np.float32)
    e = rng.normal(size=(C, N)).astype(np.float32)
    keys = _keys(13)
    want = jax.vmap(jk.step)(keys, (jnp.asarray(h), jnp.asarray(e)), {})
    k012 = [jax.random.split(k, 3) for k in keys]
    noise = tuple(rwm_noise([k[i] for k in k012], 1 if i else N)
                  for i in range(3))
    got = tk.apply(noise, (_t(h), _t(e)), {})
    _close(got[0], want[0], 1e-4)
    _close(got[1], want[1], 1e-4)


def test_interweave_jacfwd_fallback_equals_the_analytic_jacobian():
    """Mirror of ``test_gibbs.py::test_interweave_autodiff_jacobian_fallback``
    on the port: the same draws through both kernels agree (rtol 1e-5)."""
    ka, kb = _interweave(torch, tg, True), _interweave(torch, tg, False)
    va = (torch.full((4, 1), 0.2), torch.tensor([[0.1, -0.3, 0.5]] * 4))
    gen = torch.Generator().manual_seed(7)
    for _ in range(5):
        noise = ka.draw_noise(gen, va, {})
        a, b = ka.apply(noise, va, {}), kb.apply(noise, va, {})
        for x, y in zip(a, b):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5,
                                       atol=1e-6)
        va = a
    with pytest.raises(ValueError, match="per-chain"):
        tg.InterweaveKernel(*_sinh_pair(torch)[:2], anc_logpdf=None,
                            loglike=None, hyper_logprior=None,
                            make_hyper_kernel=None, batched=True)


def test_sweep_replays_jax():
    """One sweep of a (MALA, elliptical slice) sampler: JAX's ``_sweep``
    per chain with ``fold_in(key, block)`` keys against the port's sweep on
    the same draws."""
    def j_x(x, o):
        return -0.5 * jnp.sum(x * x) - 0.1 * jnp.sum(o["z"]) * x[0]

    def t_x(x, o):
        return -0.5 * torch.sum(x * x) - 0.1 * torch.sum(o["z"]) * x[0]

    def j_z(z, o):
        return -0.5 * jnp.sum((z - o["x"].sum()) ** 2)

    def t_z(z, o):
        return -0.5 * torch.sum((z - o["x"].sum()) ** 2)

    j = jg.BlockedGibbsSampler(
        [("x", 2, jg.MALAKernel(j_x, 0.5)),
         ("z", 3, jg.EllipticalSliceKernel(j_z, prior_scale=jnp.ones(3)))],
        n_chains=C, seed=5)
    t = mt.BlockedGibbsSampler(
        [("x", 2, tg.MALAKernel(t_x, 0.5)),
         ("z", 3, tg.EllipticalSliceKernel(t_z, prior_scale=np.ones(3)))],
        n_chains=C, device="cpu")
    rng = np.random.default_rng(14)
    init = {"x": rng.normal(size=(C, 2)).astype(np.float32),
            "z": rng.normal(size=(C, 3)).astype(np.float32)}
    j.init(init)
    t.init(init)
    keys = _keys(15)
    want = jax.vmap(j._sweep)(keys, j.state)
    noises = [mala_noise([jax.random.fold_in(k, 0) for k in keys], 2),
              ess_noise([jax.random.fold_in(k, 1) for k in keys], 3)]
    got = t.sweep(t.state, noises)
    for name in ("x", "z"):
        _close(got[name], want[name])
    assert set(got) == {"x", "z"}


# -- mirrors of tests/test_gibbs.py -------------------------------------------


def _std_normal(x, others):
    return -0.5 * torch.sum(x * x)


@pytest.mark.parametrize("kernel", [
    tg.MALAKernel(_std_normal, step_size=0.9),
    tg.HMCKernel(_std_normal, step_size=0.4, n_leapfrog=8),
    tg.RWMKernel(_std_normal, scale=1.2),
    tg.EllipticalSliceKernel(lambda x, o: torch.zeros(()),
                             prior_scale=np.ones(3)),
], ids=["mala", "hmc", "rwm", "ess"])
def test_single_block_recovers_standard_normal(kernel):
    """Mirror of ``test_gibbs.py::test_single_block_recovers_standard_normal``
    (64 chains, 200 burn + 1500 sweeps at thin 3; the JAX test's bounds)."""
    s = mt.BlockedGibbsSampler([("x", 3, kernel)], n_chains=64, seed=0,
                               logp_fn=lambda v: -0.5 * torch.sum(v["x"] ** 2),
                               device="cpu")
    s.init({"x": np.zeros(3)})
    s.run(200, thin=200)
    s.chain.clear()
    s.run(1500, thin=3)
    x = s.get_samples(flat=True)
    np.testing.assert_allclose(x.mean(0), 0.0, atol=0.11)
    np.testing.assert_allclose(x.var(0), 1.0, atol=0.12)
    np.testing.assert_allclose(s.get_samples()[-1].sum(-1) * 0 + 1, 1.0)
    np.testing.assert_allclose(
        s.chain.get_logp()[-1], -0.5 * (s.get_samples()[-1] ** 2).sum(-1),
        rtol=1e-5, atol=1e-5)


def test_hierarchical_conjugate_oracle():
    """Mirror of ``test_gibbs.py::test_hierarchical_conjugate_oracle``: mu
    (MALA) and the latent e (elliptical slice) in a two-block sweep; mu's
    conjugate Gaussian posterior, the latent's shrunk reconstruction."""
    tau, sig = 2.0, 0.5
    rng = np.random.default_rng(0)
    n = 12
    y = torch.from_numpy((1.2 + rng.normal(0, np.sqrt(1 + sig ** 2), n))
                         .astype(np.float32))

    def mu_logp(mu, o):
        return (-0.5 * mu[0] ** 2 / tau ** 2
                - 0.5 * torch.sum((y - mu[0] - o["e"]) ** 2) / sig ** 2)

    def e_loglike(e, o):
        return -0.5 * torch.sum((y - o["mu"][0] - e) ** 2) / sig ** 2

    s = mt.BlockedGibbsSampler(
        [("mu", 1, tg.MALAKernel(mu_logp, step_size=0.15)),
         ("e", n, tg.EllipticalSliceKernel(e_loglike,
                                           prior_scale=np.ones(n)))],
        n_chains=64, seed=1, device="cpu")
    s.init({"mu": np.zeros(1), "e": np.zeros(n)})
    s.run(150, thin=150)
    s.chain.clear()
    s.run(1200, thin=4)
    mu = s.get_block("mu", flat=True)[:, 0]
    prec = 1.0 / tau ** 2 + n / (1.0 + sig ** 2)
    mean_true = float(y.sum()) / (1.0 + sig ** 2) / prec
    sd_true = prec ** -0.5
    assert mu.mean() == pytest.approx(mean_true, abs=4 * sd_true / 30)
    assert mu.std() == pytest.approx(sd_true, rel=0.12)
    z = mu[:, None] + s.get_block("e", flat=True)
    expected = (y.numpy() / sig ** 2 + mean_true) / (1 / sig ** 2 + 1)
    np.testing.assert_allclose(z.mean(0), expected, atol=0.15)


def test_validation_and_block_slicing():
    k = tg.RWMKernel(_std_normal, scale=1.0)
    with pytest.raises(ValueError, match="duplicate"):
        mt.BlockedGibbsSampler([("a", 1, k), ("a", 2, k)], n_chains=4,
                               device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        mt.BlockedGibbsSampler([], n_chains=4, device="cpu")
    s = mt.BlockedGibbsSampler([("a", 2, k), ("b", 3, k)], n_chains=4,
                               device="cpu")
    with pytest.raises(ValueError, match="missing init"):
        s.init({"a": np.zeros(2)})
    with pytest.raises(RuntimeError, match="init"):
        s.run(2)
    s.init({"a": np.zeros(2), "b": np.ones(3)})
    s.run(4)
    assert s.get_samples().shape == (4, 4, 5)
    assert s.get_block("b").shape == (4, 4, 3)
    np.testing.assert_array_equal(s.chain.get_logp(), np.zeros((4, 4)))
    with pytest.raises(KeyError):
        s.get_block("nope")
    with pytest.raises(ValueError, match="exactly one"):
        tg.EllipticalSliceKernel(_std_normal)


def test_joint_block_validation_and_layout():
    k = tg.RWMKernel(_std_normal, scale=1.0)
    gk = tg.GaussianInterweaveKernel(
        lambda f: -0.5 * torch.sum(f * f),
        lambda h: torch.exp(h[0]) * torch.eye(3),
        lambda h: -0.5 * torch.sum(h * h),
        lambda logp: tg.RWMKernel(logp, 0.3))
    with pytest.raises(ValueError, match="matching tuple"):
        mt.BlockedGibbsSampler([(("h", "e"), 5, gk)], n_chains=4,
                               device="cpu")
    with pytest.raises(ValueError, match="duplicate"):
        mt.BlockedGibbsSampler([(("h", "e"), (1, 3), gk), ("h", 1, k)],
                               n_chains=4, device="cpu")
    s = mt.BlockedGibbsSampler([(("h", "e"), (1, 3), gk), ("x", 2, k)],
                               n_chains=4, seed=0, device="cpu")
    s.init({"h": np.zeros(1), "e": np.zeros(3), "x": np.zeros(2)})
    s.run(6, thin=2)
    assert s.get_samples().shape == (3, 4, 6)
    assert s.get_block("e").shape == (3, 4, 3)
    assert s.get_block("x").shape == (3, 4, 2)


def test_interweave_matches_exact_marginal():
    """Mirror of ``test_gibbs.py::test_interweave_matches_exact_marginal``:
    h ~ N(0, 1), e ~ N(0, I_2), y = exp(h)·e + noise; the quadrature
    posterior of h (the JAX test's bounds)."""
    sig = 0.3
    y = torch.tensor([1.1, -0.7])
    gk = tg.GaussianInterweaveKernel(
        lambda f: -0.5 * torch.sum((y - f) ** 2) / sig ** 2,
        lambda h: torch.exp(h[0]) * torch.eye(2),
        lambda h: -0.5 * torch.sum(h * h),
        lambda logp: tg.RWMKernel(logp, 0.4))
    s = mt.BlockedGibbsSampler([(("h", "e"), (1, 2), gk)], n_chains=64,
                               seed=0, device="cpu")
    s.init({"h": np.zeros(1), "e": np.zeros(2)})
    s.run(150, thin=150)
    s.chain.clear()
    s.run(800, thin=4)
    h = s.get_block("h", flat=True)[:, 0]
    g = np.linspace(-4, 4, 20001)
    v = np.exp(2 * g) + sig ** 2
    lp = -0.5 * g ** 2 - float((y ** 2).sum()) / (2 * v) - np.log(v)
    w = np.exp(lp - lp.max())
    w /= w.sum()
    m = float((w * g).sum())
    sd = float(np.sqrt((w * (g - m) ** 2).sum()))
    assert h.mean() == pytest.approx(m, abs=0.4 * sd)
    assert h.std() == pytest.approx(sd, rel=0.25)


def test_general_interweave_nonlinear_coupling():
    """Mirror of ``test_gibbs.py::test_general_interweave_nonlinear_coupling``:
    ``InterweaveKernel`` on h ~ N(0, 1), e ~ N(0, I_2), f = exp(h)·sinh(e),
    y = f + noise, against the 2-D quadrature of h's marginal (the JAX
    test's bounds)."""
    sig = 0.3
    y = torch.tensor([1.1, -0.7])
    fwd, inv, ldet = _sinh_pair(torch)
    ik = tg.InterweaveKernel(
        fwd, inv, anc_logpdf=lambda e: -0.5 * torch.sum(e * e),
        loglike=lambda f: -0.5 * torch.sum((y - f) ** 2) / sig ** 2,
        hyper_logprior=lambda h: -0.5 * torch.sum(h * h),
        make_hyper_kernel=lambda logp: tg.RWMKernel(logp, 0.4),
        log_det_inverse=ldet)
    s = mt.BlockedGibbsSampler([(("h", "e"), (1, 2), ik)], n_chains=64,
                               seed=0, device="cpu")
    s.init({"h": np.zeros(1), "e": np.zeros(2)})
    s.run(150, thin=150)
    s.chain.clear()
    s.run(1000, thin=4)
    h = s.get_block("h", flat=True)[:, 0]
    hg = np.linspace(-4.0, 4.0, 1601)
    eg = np.linspace(-7.0, 7.0, 2801)
    de = eg[1] - eg[0]
    phi_e = np.exp(-0.5 * eg ** 2) / np.sqrt(2 * np.pi)
    lp = -0.5 * hg ** 2
    for yi in y.numpy():
        fz = np.exp(hg)[:, None] * np.sinh(eg)[None, :]
        like = np.exp(-0.5 * (yi - fz) ** 2 / sig ** 2)
        lp += np.log((like * phi_e[None, :]).sum(axis=1) * de + 1e-300)
    w = np.exp(lp - lp.max())
    w /= w.sum()
    m = float((w * hg).sum())
    sd = float(np.sqrt((w * (hg - m) ** 2).sum()))
    assert h.mean() == pytest.approx(m, abs=0.4 * sd)
    assert h.std() == pytest.approx(sd, rel=0.25)


def test_exact_gibbs_kernel_conjugate_block():
    """Mirror of ``test_gibbs.py::test_exact_gibbs_kernel_conjugate_block``:
    a per-chain ``sample_fn(gen, others)``, vmapped with independent draws
    per chain, is the posterior from step one."""
    tau, sig = 2.0, 0.8
    y = np.array([1.3, 0.9, 1.7, 1.1], np.float32)
    prec = 1.0 / tau ** 2 + y.size / sig ** 2
    mean_post = float(y.sum()) / sig ** 2 / prec

    def sample_mu(gen, others):
        return mean_post + prec ** -0.5 * torch.randn((1,), generator=gen)

    s = mt.BlockedGibbsSampler([("mu", 1, tg.ExactGibbsKernel(sample_mu))],
                               n_chains=64, seed=0, device="cpu")
    s.init({"mu": np.zeros(1)})
    s.run(200, thin=2)
    mu = s.get_block("mu", flat=True)[:, 0]
    assert len(np.unique(s.get_samples()[-1])) == 64  # chains independent
    assert mu.mean() == pytest.approx(mean_post, abs=0.02)
    assert mu.std() == pytest.approx(prec ** -0.5, rel=0.05)


def test_mixture_assignments_data_augmentation():
    """Mirror of ``test_gibbs.py::test_mixture_assignments_data_augmentation``:
    a categorical assignment block and an exact conjugate mean block on a
    two-component mixture (the JAX test's bounds)."""
    rng = np.random.default_rng(0)
    sig, tau = 0.7, 5.0
    n0, n1 = 35, 45
    y = np.concatenate([rng.normal(-2.0, sig, n0),
                        rng.normal(2.0, sig, n1)]).astype(np.float32)
    n = y.size
    yt = torch.from_numpy(y)

    def z_logits(o):
        return -0.5 * ((yt[:, None] - o["mu"][None, :]) / sig) ** 2

    def sample_mu(gen, o):
        onehot = torch.stack([1.0 - o["z"], o["z"]], dim=1)
        n_k = onehot.sum(0)
        s_k = (onehot * yt[:, None]).sum(0)
        prec = 1.0 / tau ** 2 + n_k / sig ** 2
        return (s_k / sig ** 2) / prec + prec ** -0.5 * torch.randn(
            (2,), generator=gen)

    s = mt.BlockedGibbsSampler(
        [("z", n, tg.CategoricalGibbsKernel(z_logits)),
         ("mu", 2, tg.ExactGibbsKernel(sample_mu))],
        n_chains=32, seed=1, device="cpu")
    s.init({"z": np.zeros(n), "mu": np.array([-1.0, 1.0])})
    s.run(100, thin=100)
    s.chain.clear()
    s.run(400, thin=2)
    mu = s.get_block("mu", flat=True)
    truth = np.array([y[:n0].mean(), y[n0:].mean()])
    np.testing.assert_allclose(mu.mean(0), truth, atol=3 * sig / 5.0)
    z_mean = s.get_block("z", flat=True).mean(0)
    accuracy = np.mean((z_mean > 0.5) == (np.arange(n) >= n0))
    assert accuracy > 0.95
    assert mu[:, 0].std() == pytest.approx(sig / np.sqrt(n0), rel=0.35)
    assert mu[:, 1].std() == pytest.approx(sig / np.sqrt(n1), rel=0.35)


def test_batched_kernels_match_per_chain():
    """``batched=True`` kernels take (C, …) conditionals: the same draws
    give the same bits as the vmapped per-chain ones."""
    def per_chain(x, o):
        return -0.5 * torch.sum(x * x)

    def batched(x, o):
        return -0.5 * torch.sum(x * x, dim=-1)

    x = torch.from_numpy(np.random.default_rng(3).normal(size=(8, 3))
                         .astype(np.float32))
    for make in (lambda f, b: tg.RWMKernel(f, 0.8, batched=b),
                 lambda f, b: tg.MALAKernel(f, 0.5, batched=b),
                 lambda f, b: tg.HMCKernel(f, 0.3, 4, batched=b)):
        a, b = make(per_chain, False), make(batched, True)
        noise = a.draw_noise(torch.Generator().manual_seed(1), x, {})
        assert torch.equal(a.apply(noise, x, {}), b.apply(noise, x, {}))


def test_kernel_constants_leave_the_host_once():
    """A kernel's constants reach the device without a host copy per step
    (a copy from pageable memory waits for the device): a number is filled
    in where the batch lies, an array is copied once and kept, and the
    kept tensor is the one later updates use."""
    held = {}
    x = torch.zeros((4, 3), dtype=torch.float32)
    scale = np.array([0.5, 1.0, 2.0])
    a = tg.constant(held, scale, x)
    assert tg.constant(held, scale, x) is a and len(held) == 1
    assert a.dtype == torch.float32 and torch.equal(
        a, torch.tensor([0.5, 1.0, 2.0]))
    half = tg.constant(held, 0.15, x)
    assert len(held) == 1 and half.dtype == torch.float32
    assert torch.equal(half, torch.tensor(0.15, dtype=torch.float32))
    # an elliptical kernel with array prior constants keeps one copy each
    k = tg.EllipticalSliceKernel(lambda v, o: -0.5 * torch.sum(v * v),
                                 prior_mean=np.zeros(3), prior_scale=scale)
    gen = torch.Generator().manual_seed(2)
    for _ in range(3):
        x = k.apply(k.draw_noise(gen, x, {}), x, {})
    assert len(k._held) == 2 and torch.isfinite(x).all()
    rwm = tg.RWMKernel(lambda v, o: -0.5 * torch.sum(v * v), scale)
    for _ in range(3):
        x = rwm.apply(rwm.draw_noise(gen, x, {}), x, {})
    assert len(rwm._held) == 1
