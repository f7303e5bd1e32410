"""The port's NeuTra flows, Adam and fits held against the JAX package.

- Flows: RealNVP, IAF and SplineCoupling with the JAX package's parameters
  (perturbed away from the identity and carried over by
  ``convert.flow_params_from_numpy``): forward, inverse and log-det agree to
  rtol 1e-5 (atol 1e-5 near zero) in float32 (the same formulas, products
  summed in another order). At init each flow is the identity in both. A
  spline point exactly on a bin edge goes to the bin that starts there in
  both packages, and maps identically.
- ``optim.py`` against ``optax.adam``: 50 steps over a flow's parameters on
  the same gradients, float64, to 1e-12.
- ``NeuTra.fit`` replayed for 20 steps in float64 on the JAX package's base
  draws (and ``refit_forward_kl`` on its row indices): the ELBO trace and
  the parameters agree to 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mcmcpp_tpu import neutra as jn
import mcmcpp_tpu_torch as mt
from mcmcpp_tpu_torch import neutra as tn
from mcmcpp_tpu_torch.convert import flow_params_from_numpy
from mcmcpp_tpu_torch.optim import adam_init, adam_leaves, adam_step

torch.set_num_threads(1)

P = 4
FLOW_RTOL, FLOW_ATOL = 1e-5, 1e-5
REPLAY_TOL = 1e-9

FAMILIES = {
    "realnvp": (lambda m, dt: m.RealNVP(P, n_layers=3, hidden=8, dtype=dt)),
    "iaf": (lambda m, dt: m.IAF(P, n_layers=2, hidden=8, dtype=dt)),
    "spline": (lambda m, dt: m.SplineCoupling(P, n_layers=2, hidden=8,
                                              n_bins=4, bound=3.0,
                                              dtype=dt)),
}


def _pair(name, scale=0.3, seed=0, f64=False):
    """(JAX flow, its params perturbed by N(0, scale²), the port's flow with
    the same parameters)."""
    jdt, tdt = (jnp.float64, torch.float64) if f64 else (jnp.float32,
                                                         torch.float32)
    jflow = FAMILIES[name](jn, jdt)
    params = jflow.init(jax.random.key(seed))
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    leaves = [np.asarray(x) + scale * rng.normal(size=np.shape(x)).astype(
        np.asarray(x).dtype) for x in leaves]
    params = jax.tree_util.tree_unflatten(tree, [jnp.asarray(x)
                                                 for x in leaves])
    tflow = flow_params_from_numpy(FAMILIES[name](tn, tdt), leaves)
    return jflow, params, tflow


def _z(n=64, seed=1, scale=1.5):
    return (scale * np.random.default_rng(seed).normal(size=(n, P))).astype(
        np.float32)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_flow_forward_inverse_logdet_match_jax(name):
    jflow, params, tflow = _pair(name)
    z = _z()
    # the spline op by op, as the JAX package's own tests call the flows
    # (under jit XLA's fusion reorders its float32 arithmetic, whose
    # quadratic inversion then moves by more than 1e-5); the others jitted
    run = (lambda f: f) if name == "spline" else jax.jit
    jx, jld = run(jax.vmap(lambda zi: jflow.forward(params, zi)))(
        jnp.asarray(z))
    with torch.no_grad():
        tx, tld = tflow(torch.from_numpy(z))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=FLOW_RTOL,
                               atol=FLOW_ATOL)
    np.testing.assert_allclose(tld.numpy(), np.asarray(jld), rtol=FLOW_RTOL,
                               atol=FLOW_ATOL)
    x = np.array(jx)
    jz, jild = run(jax.vmap(lambda xi: jflow.inverse(params, xi)))(
        jnp.asarray(x))
    with torch.no_grad():
        tz, tild = tflow.inverse(torch.from_numpy(x))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=FLOW_RTOL,
                               atol=FLOW_ATOL)
    np.testing.assert_allclose(tild.numpy(), np.asarray(jild),
                               rtol=FLOW_RTOL, atol=FLOW_ATOL)
    # and the port's own round trip
    np.testing.assert_allclose(tz.numpy(), z, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose((tld + tild).numpy(), 0.0, atol=1e-4)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_flow_is_identity_at_init(name):
    jflow, params, tflow = _pair(name, scale=0.0)
    z = _z()
    jx, jld = jax.vmap(lambda zi: jflow.forward(params, zi))(jnp.asarray(z))
    with torch.no_grad():
        tx, tld = tflow(torch.from_numpy(z))
        own = FAMILIES[name](tn, torch.float32)
        own.init(torch.Generator().manual_seed(3))
        ox, old = own(torch.from_numpy(z))
    for x, ld in ((np.asarray(jx), np.asarray(jld)), (tx.numpy(),
                                                      tld.numpy()),
                  (ox.numpy(), old.numpy())):
        np.testing.assert_allclose(x, z, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(ld, 0.0, atol=1e-6)


def test_spline_point_on_a_bin_edge_matches_jax():
    """Knots at exact binary fractions: a point on knot k lies in bin k (the
    bin that starts there) in both packages, in both directions."""
    widths = np.array([[1.0, 2.0, 0.5, 2.5]] * 2, np.float32)  # 2B = 6
    heights = np.array([[2.0, 1.0, 1.5, 1.5]] * 2, np.float32)
    derivs = np.array([[1.0, 0.5, 2.0, 1.5, 1.0]] * 2, np.float32)
    knots_x = np.cumsum(np.concatenate([[0.0], widths[0]])) - 3.0
    knots_y = np.cumsum(np.concatenate([[0.0], heights[0]])) - 3.0
    for inverse, knots in ((False, knots_x), (True, knots_y)):
        # (2 rows, D = 2): three knots and a point inside a bin
        x = np.array([[knots[1], knots[2]], [knots[3], knots[2] + 0.25]],
                     np.float32)
        wb = np.broadcast_to(widths, (2, 2, 4))
        hb = np.broadcast_to(heights, (2, 2, 4))
        db = np.broadcast_to(derivs, (2, 2, 5))
        jy, jld = jn._rq_spline(jnp.asarray(x), jnp.asarray(wb),
                                jnp.asarray(hb), jnp.asarray(db),
                                inverse=inverse)
        ty, tld = tn._rq_spline(torch.from_numpy(x), torch.from_numpy(
            wb.copy()), torch.from_numpy(hb.copy()), torch.from_numpy(
                db.copy()), inverse=inverse)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(tld.numpy(), np.asarray(jld), rtol=1e-6,
                                   atol=1e-6)
        # a knot maps to its knot: the bin that starts there, at xi = 0
        other = knots_y if not inverse else knots_x
        np.testing.assert_allclose(ty.numpy()[0], [other[1], other[2]],
                                   atol=1e-6)
        np.testing.assert_allclose(ty.numpy()[1, 0], other[3], atol=1e-6)
        # the slope there is the knot's derivative
        np.testing.assert_allclose(
            tld.numpy()[0], (-1 if inverse else 1) * np.log(derivs[0, 1:3]),
            rtol=1e-5, atol=1e-6)


def test_adam_matches_optax_float64():
    with jax.enable_x64(True):
        jflow, params, tflow = _pair("realnvp", f64=True)
        leaves, tree = jax.tree_util.tree_flatten(params)
        opt = optax.adam(3e-2)
        jstate = opt.init(params)
        tparams = tflow.param_list()
        tstate = adam_init(tparams)
        rng = np.random.default_rng(7)
        step = jax.jit(lambda g, st, p: (lambda u, st: (
            optax.apply_updates(p, u), st))(*opt.update(g, st)))
        for _ in range(50):
            grads = [rng.normal(size=np.shape(x)) for x in leaves]
            params, jstate = step(jax.tree_util.tree_unflatten(
                tree, [jnp.asarray(g) for g in grads]), jstate, params)
            tstate = adam_step(tparams, [torch.from_numpy(g) for g in grads],
                               tstate, 3e-2)
        for a, b in zip(jax.tree_util.tree_leaves(params), tparams):
            np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                       rtol=1e-12, atol=1e-12)
        jleaves = jax.tree_util.tree_leaves(jstate)
        tl = adam_leaves(tstate)
        assert len(jleaves) == len(tl) == 2 * len(leaves) + 1
        assert int(jleaves[0]) == int(tl[0]) == 50
        for a, b in zip(jleaves[1:], tl[1:]):
            np.testing.assert_allclose(b, np.asarray(a), rtol=1e-12,
                                       atol=1e-14)


def _funnel_logp(lib):
    def logp(x):
        v = x[..., 0]
        rest = x[..., 1:]
        return (-0.5 * v * v / 9.0
                - 0.5 * lib.sum(rest * rest, -1) * lib.exp(-v)
                - 0.5 * (P - 1) * v)
    return logp


def test_neutra_fit_replays_jax_float64():
    """The spline flow, whose gradient has the most to it (RealNVP's is
    replayed through SMC's flow mutation in ``test_torch_smc.py``)."""
    n_steps, batch, lr = 20, 16, 5e-3
    with jax.enable_x64(True):
        jflow, params, tflow = _pair("spline", scale=0.1, f64=True)
        j = jn.NeuTra(_funnel_logp(jnp), P, flow=jflow, seed=2,
                      dtype=jnp.float64)
        j.params = params
        _, fit_key = jax.random.split(j._key)
        keys = jax.random.split(fit_key, n_steps)
        z = np.stack([np.asarray(jax.random.normal(k, (batch, P),
                                                   jnp.float64))
                      for k in keys])
        j.fit(n_steps, batch=batch, learning_rate=lr)
        j_hist = j.fit_result.elbo_history
        j_leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(
            j.params)]
        j_opt = [np.asarray(x) for x in jax.tree_util.tree_leaves(
            j._opt_state)]
    t = mt.NeuTra(_funnel_logp(torch), P, flow=tflow, dtype=torch.float64,
                  batched=True, device="cpu")
    flow_params_from_numpy(t.flow, [np.asarray(x) for x in
                                    jax.tree_util.tree_leaves(params)])
    t.fit(n_steps, batch=batch, learning_rate=lr,
          noise=torch.from_numpy(z))
    np.testing.assert_allclose(t.fit_result.elbo_history, j_hist,
                               rtol=REPLAY_TOL, atol=REPLAY_TOL)
    for a, b in zip(j_leaves, t.params):
        np.testing.assert_allclose(b.detach().numpy(), a, rtol=REPLAY_TOL,
                                   atol=REPLAY_TOL)
    assert t.fit_result.final_elbo == pytest.approx(j.fit_result.final_elbo,
                                                    rel=1e-9)
    from mcmcpp_tpu_torch.optim import adam_leaves as leaves_of

    for a, b in zip(j_opt, leaves_of(t._opt_state)):
        np.testing.assert_allclose(b, a, rtol=REPLAY_TOL, atol=1e-12)


def test_refit_forward_kl_replays_jax_float64():
    """The forward-KL refit runs the flow's inverse (IAF: the sequential
    direction) under Adam, from JAX's row indices."""
    n_steps, batch, lr = 10, 12, 1e-2
    samples = np.random.default_rng(5).normal(size=(40, P))
    with jax.enable_x64(True):
        jflow, params, tflow = _pair("iaf", scale=0.1, f64=True)
        j = jn.NeuTra(_funnel_logp(jnp), P, flow=jflow, seed=4,
                      dtype=jnp.float64)
        j.params = params
        _, fit_key = jax.random.split(j._key)
        idx = np.stack([np.asarray(jax.random.randint(k, (batch,), 0, 40))
                        for k in jax.random.split(fit_key, n_steps)])
        j.refit_forward_kl(samples, n_steps=n_steps, batch=batch,
                           learning_rate=lr)
    t = mt.NeuTra(_funnel_logp(torch), P, flow=tflow, dtype=torch.float64,
                  batched=True, device="cpu")
    flow_params_from_numpy(t.flow, [np.asarray(x) for x in
                                    jax.tree_util.tree_leaves(params)])
    t.refit_forward_kl(samples, n_steps=n_steps, batch=batch,
                       learning_rate=lr, noise=torch.from_numpy(idx))
    np.testing.assert_allclose(t.refit_result.elbo_history,
                               j.refit_result.elbo_history, rtol=REPLAY_TOL,
                               atol=REPLAY_TOL)
    for a, b in zip(jax.tree_util.tree_leaves(j.params), t.params):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   rtol=REPLAY_TOL, atol=REPLAY_TOL)


def test_warped_logp_transform_and_sampler():
    """The warped target equals the JAX package's on the same parameters
    (float32), is frozen against later fits, and the sampler built on it
    is the port's gradient sampler, its draws pushed through the flow."""
    jflow, params, tflow = _pair("realnvp", scale=0.2)
    j = jn.NeuTra(_funnel_logp(jnp), P, flow=jflow)
    j.params = params
    t = mt.NeuTra(_funnel_logp(torch), P, flow=tflow, batched=True,
                  device="cpu")
    flow_params_from_numpy(t.flow, [np.asarray(x) for x in
                                    jax.tree_util.tree_leaves(params)])
    z = _z(seed=9, scale=1.0)
    warped = t.warped_logp()
    got = warped(torch.from_numpy(z))
    want = jax.jit(jax.vmap(j.warped_logp()))(jnp.asarray(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(t.transform(z), j.transform(z), rtol=1e-5,
                               atol=1e-5)
    t.fit(3, batch=8)
    torch.testing.assert_close(warped(torch.from_numpy(z)), got)
    s = t.make_sampler(mt.HMCSampler, 8, n_leapfrog=2)
    assert isinstance(s, mt.HMCSampler) and s.state.position.shape == (8, P)
    s.run(4)
    x = t.transform(s.get_samples(flat=True))
    assert x.shape == (32, P) and np.isfinite(x).all()
    assert t.sample_approximate(None, 5).shape == (5, P)
