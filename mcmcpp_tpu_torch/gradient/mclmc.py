"""Microcanonical Langevin Monte Carlo (MCLMC) and its adjusted sibling MAMS.

PyTorch counterpart of ``mcmcpp_tpu/gradient/mclmc.py`` (Robnik, De Luca,
Silverstein & Seljak 2023; Robnik & Seljak 2024). The momentum lives on the
unit sphere and the isokinetic dynamics conserve |u| = 1; the marginal of x is
the target. One step, one gradient (d = n_params):

  u  <- esh(u, g(x), eps/2)        # momentum half-step toward ∇logp
  x  <- x + eps · u                # position full step
  u  <- esh(u, g(x'), eps/2)       # second half-step
  u  <- normalize(u + nu · z)      # Langevin partial refresh,
                                   #   nu² = (e^{2 eps/L} − 1)/d

with the exact isokinetic map ``esh`` in its overflow-free ``exp(−δ)`` form.
MCLMC has no Metropolis step (the energy-error variance, which ``tune``
drives to a target, controls the bias); :class:`MAMSSampler` integrates a
jittered number of such steps from a fresh momentum and accepts the whole
trajectory with ``log(uniform) < −ΔE``.

The jittered length of a MAMS trajectory comes from the sampler's CPU
generator, so the loop runs ``n_live`` steps, a host int; JAX runs ``n_max``
steps and masks the ones past ``n_live`` (the results are the same).

Sharded (``mesh=``), every rank draws every chain's noise and keeps its
rows; a tuning round gathers its energy errors (MCLMC) or accepts (MAMS) and
its positions once, so ε, L and the metric are the same on every rank, and
sampling has no collective.
"""

from typing import NamedTuple

import numpy as np
import torch

from mcmcpp_tpu_torch.chain import (
    Chain,
    default_chunk_steps,
    row_dtype,
    run_pipelined,
)
from mcmcpp_tpu_torch.gradient.hmc import (
    as_positions,
    ball,
    logp_and_grad,
    scalar,
)
from mcmcpp_tpu_torch.ops.random import (
    AUX_STREAM,
    HOST_STREAM,
    STEP_STREAM,
    make_generator,
    normal,
    uniform,
)
from mcmcpp_tpu_torch.parallel.mesh import _engine_rows


class MCLMCState(NamedTuple):
    position: torch.Tensor  # (C, P)
    momentum: torch.Tensor  # (C, P) unit rows
    logp: torch.Tensor  # (C,)
    grad: torch.Tensor  # (C, P)


def _normalize(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def _esh(u, g, dt, d):
    """Exact isokinetic momentum update; returns (u', ΔK per chain).

    In exp(−δ) factors, never raw sinh/cosh (δ = dt·|g|/(d−1) overflows
    float32 cosh at δ ≳ 89): multiplying numerator and denominator by
    2e^{−δ} gives
        u' ∝ 2ζu + e(1−ζ)(1+ζ+u·e(1−ζ)),   ζ = e^{−δ},
        ΔK = (d−1)[δ − log2 + log((1+u·e) + (1−u·e)ζ²)],
    and normalizing u' to the sphere replaces the division.
    """
    g_norm = torch.clamp_min(
        torch.linalg.vector_norm(g, dim=-1, keepdim=True), 1e-30)
    e = g / g_norm
    ue = torch.sum(u * e, dim=-1, keepdim=True)
    delta = dt * g_norm / (d - 1.0)
    zeta = torch.exp(-delta)
    uu = e * (1.0 - zeta) * (1.0 + zeta + ue * (1.0 - zeta)) + 2.0 * zeta * u
    u_new = uu / torch.clamp_min(
        torch.linalg.vector_norm(uu, dim=-1, keepdim=True), 1e-30)
    dk = (d - 1.0) * (
        delta[..., 0] - float(np.log(2.0))
        + torch.log(torch.clamp_min(
            (1.0 + ue[..., 0]) + (1.0 - ue[..., 0]) * zeta[..., 0] ** 2,
            1e-30)))
    return u_new, dk


class MCLMCSampler:
    """Microcanonical Langevin MC over C chains.

    ``logp_fn`` maps (C, P) -> (C,). ``step_size`` (eps) and
    ``decoherence_length`` (L) are the two hyperparameters; leave them and
    call :meth:`tune`, or set them. ``inv_mass`` is an optional diagonal
    preconditioner (the dynamics run in whitened coordinates). ``d >= 2``
    (the isokinetic map divides by d−1). ``device`` defaults to "cuda";
    ``mesh`` (a ``WalkerLayout``) splits the chains over the ranks of a
    process group, on the layout's device.
    """

    def __init__(self, logp_fn, n_chains, n_params, seed=0,
                 dtype=torch.float32, step_size=None,
                 decoherence_length=None, inv_mass=None,
                 max_chain_bytes=2 << 30, mesh=None, chain=None,
                 device=None):
        if int(n_params) < 2:
            raise ValueError("MCLMC needs n_params >= 2 (isokinetic map "
                             "divides by d-1)")
        self.mesh = mesh
        self.device, self._row0, self._n_local = _engine_rows(
            mesh, device, int(n_chains), "n_chains")
        self.n_chains = int(n_chains)
        self.n_params = int(n_params)
        self.dtype = dtype
        self.logp_fn = logp_fn
        # Gaussian-calibrated defaults: eps ~ 0.3·sqrt(d), then tuned
        self.step_size = (float(step_size) if step_size is not None
                          else 0.3 * float(np.sqrt(self.n_params)))
        self.decoherence_length = (
            float(decoherence_length) if decoherence_length is not None
            else 1.6 * float(np.sqrt(self.n_params)))
        self._step_gen = make_generator(seed, STEP_STREAM, self.device)
        self._aux_gen = make_generator(seed, AUX_STREAM, self.device)
        self._host_gen = make_generator(seed, HOST_STREAM, "cpu")
        self.state = None
        self.energy_var = float("nan")  # Var[ΔE]/d from the last tune leg
        self.inv_mass = inv_mass
        if chain is not None:
            if (chain.n_walkers, chain.n_params) != (
                    self._n_local, self.n_params):
                raise ValueError("injected chain store geometry mismatch")
            self.chain = chain
        else:
            self.chain = Chain(n_walkers=self._n_local,
                               n_params=self.n_params,
                               max_bytes=max_chain_bytes,
                               dtype=row_dtype(dtype))

    @property
    def inv_mass(self):
        """Diagonal inverse mass (whitening scales²), or None."""
        return self._inv_mass

    @inv_mass.setter
    def inv_mass(self, value):
        if value is not None:
            value = torch.as_tensor(value, dtype=self.dtype,
                                    device=self.device)
            if tuple(value.shape) != (self.n_params,):
                raise ValueError(
                    f"inv_mass must be ({self.n_params},) diagonal")
        self._inv_mass = value

    def _require_state(self):
        if self.state is None:
            raise RuntimeError("call init/init_ball first")

    def _whole_steps(self, xs):
        """A tuning round's (steps, C_local, …) tensor over every chain
        (itself when unsharded)."""
        return xs if self.mesh is None else self.mesh.gather(xs, dim=1)

    # -- kernel --------------------------------------------------------------

    def _scale(self):
        """Whitening scale s = sqrt(inv_mass) as a (1, P) row, or None."""
        return (None if self.inv_mass is None
                else torch.sqrt(self.inv_mass)[None, :])

    def _isokinetic(self, x, u, grad, eps):
        """The isokinetic leapfrog step: (x, u, logp, grad, ΔK₁, ΔK₂)."""
        d = float(self.n_params)
        s = self._scale()
        u, dk1 = _esh(u, grad if s is None else grad * s, eps / 2.0, d)
        x = x + eps * (u if s is None else u * s)
        logp, grad = logp_and_grad(self.logp_fn, x)
        u, dk2 = _esh(u, grad if s is None else grad * s, eps / 2.0, d)
        return x, u, logp, grad, dk1, dk2

    def draw_noise(self, gen, state, host_gen=None):
        """One MCLMC step's noise: the refresh normals (C, P), of every
        chain (cut to the rank's rows when sharded)."""
        q = state.position
        z = normal(gen, (self.n_chains, self.n_params), q.dtype, q.device)
        return z[self._row0:self._row0 + self._n_local]

    def apply(self, z, state, eps, length):
        """One MCLMC transition (≙ ``mclmc.py:202-219``) at host floats eps
        and L; returns (state, ΔE (C,))."""
        eps = float(scalar(eps, self.dtype))
        x, u, logp, grad, dk1, dk2 = self._isokinetic(
            state.position, state.momentum, state.grad, eps)
        # Langevin partial refresh (O-step)
        nu = float(torch.sqrt(torch.expm1(2.0 * scalar(eps, self.dtype) / length)
                              / float(self.n_params)))
        u = _normalize(u + nu * z)
        return MCLMCState(x, u, logp, grad), dk1 + dk2 - (logp - state.logp)

    def _step(self, state, eps, length):
        return self.apply(self.draw_noise(self._step_gen, state), state, eps,
                          length)

    # -- init ----------------------------------------------------------------

    def init(self, positions):
        positions = as_positions(positions, self.n_chains, self.n_params,
                                 self.dtype, self.device)
        rows = slice(self._row0, self._row0 + self._n_local)
        u = _normalize(normal(self._aux_gen, positions.shape, self.dtype,
                              self.device))[rows]
        positions = positions[rows]
        self.state = MCLMCState(positions, u,
                                *logp_and_grad(self.logp_fn, positions))
        return self

    def init_ball(self, center, scale=1.0, seed=None):
        return self.init(ball(self, center, scale, seed))

    # -- tuning --------------------------------------------------------------

    def _tune_eps_rounds(self, leg, rounds, target_energy_var):
        """Multiplicative eps search against the energy-error target (one
        host sync a round). Returns the last leg's positions (leg, C, P)."""
        eps = self.step_size
        xs = None
        for _ in range(int(rounds)):
            des, xs = [], []
            for _ in range(leg):
                self.state, de = self._step(self.state, eps,
                                            self.decoherence_length)
                des.append(de)
                xs.append(self.state.position)
            var_e = float(torch.var(self._whole_steps(torch.stack(des)),
                                    correction=0)) / self.n_params
            self.energy_var = var_e
            ratio = (target_energy_var / max(var_e, 1e-12)) ** 0.25
            eps *= float(np.clip(ratio, 0.5, 2.0))
        self.step_size = float(eps)
        return self._whole_steps(torch.stack(xs))

    def _whitened_spread(self, xs):
        """1.6·sqrt(Σ Var[z_i]) of the whitened draws: the new L."""
        flat = xs.cpu().numpy().astype(np.float64).reshape(-1, self.n_params)
        scale2 = (np.ones(self.n_params) if self.inv_mass is None
                  else self.inv_mass.cpu().numpy().astype(np.float64))
        return float(1.6 * np.sqrt((flat.var(axis=0) / scale2).sum()))

    def _learn_metric(self, xs):
        """inv_mass = Var[x_i] of the adaptation draws; L reset to the
        whitened space's ~unit scale."""
        flat = xs.cpu().numpy().astype(np.float64).reshape(-1, self.n_params)
        self.inv_mass = np.maximum(flat.var(axis=0), 1e-12)
        self.decoherence_length = 1.6 * float(np.sqrt(self.n_params))

    def tune(self, n_steps=600, target_energy_var=5e-4, rounds=6,
             precondition=False):
        """Step size against ``Var[ΔE]/d = target_energy_var`` by a
        fixed-round multiplicative search (``eps *= (target/measured)^¼``,
        clipped to [½, 2]); with ``precondition=True`` the diagonal metric
        from the first half of the rounds; then ``L = 1.6·sqrt(Σ Var[z_i])``
        from the last round's whitened draws. Leaves the chain untouched."""
        self._require_state()
        leg = max(int(n_steps) // int(rounds), 10)
        if precondition:
            rounds_a = max(int(rounds) // 2, 1)
            self._learn_metric(
                self._tune_eps_rounds(leg, rounds_a, target_energy_var))
            xs = self._tune_eps_rounds(
                leg, max(int(rounds) - rounds_a, 2), target_energy_var)
        else:
            xs = self._tune_eps_rounds(leg, int(rounds), target_energy_var)
        self.decoherence_length = self._whitened_spread(xs)
        return self

    # -- run -----------------------------------------------------------------

    def _transition(self, state):
        """One stored-chain transition."""
        return self._step(state, self.step_size, self.decoherence_length)[0]

    def _run_chunk(self, take, thin):
        pos = torch.empty((take, self._n_local, self.n_params),
                          dtype=self.dtype, device=self.device)
        lps = torch.empty((take, self._n_local), dtype=self.dtype,
                          device=self.device)
        for s in range(take):
            for _ in range(thin):
                self.state = self._transition(self.state)
            pos[s] = self.state.position
            lps[s] = self.state.logp
        return pos, lps

    def _chunk_steps(self):
        return default_chunk_steps(self.n_chains, self.n_params,
                                   row_dtype(self.dtype))

    def run(self, n_steps, thin=1):
        """Advance ``n_steps``, storing every thin-th (position, logp); False
        on the chain's byte cap."""
        self._require_state()
        thin = int(thin)
        return run_pipelined(int(n_steps) // thin, self._chunk_steps(),
                             lambda take: self._run_chunk(take, thin),
                             lambda chunk: self.chain.append(*chunk))

    def get_samples(self, burn_in=0, thin=1, flat=False):
        return self.chain.get(burn_in=burn_in, thin=thin, flat=flat)

    def get_log_probs(self, burn_in=0, thin=1, flat=False):
        return self.chain.get_logp(burn_in=burn_in, thin=thin, flat=flat)


class MAMSSampler(MCLMCSampler):
    """Metropolis-ADJUSTED microcanonical sampler (Robnik & Seljak 2024): a
    fresh uniform-sphere momentum each transition, a jittered number of
    isokinetic steps (uniform in [1, n_max], n_max ≈ 2L/eps), the whole
    trajectory accepted with ``min(1, exp(−ΔE))``; rejection keeps the point.
    ``tune()`` targets acceptance ``target_accept`` instead of an energy
    variance, then sets L from the cloud spread."""

    def __init__(self, *args, target_accept=0.9, **kw):
        self.target_accept = float(target_accept)
        super().__init__(*args, **kw)
        self.last_mean_accept = float("nan")

    def _n_max(self, eps):
        return max(int(np.ceil(2.0 * self.decoherence_length / eps)), 2)

    def draw_noise(self, gen, state, host_gen=None, n_max=2):
        """One trajectory's noise: ``n_live`` (a host int uniform on
        [1, n_max], from ``host_gen``), the momentum's normals (C, P) and the
        accept uniforms (C,)."""
        q = state.position
        n_live = int(torch.randint(1, n_max + 1, (), generator=host_gen))
        rows = slice(self._row0, self._row0 + self._n_local)
        return (n_live,
                normal(gen, (self.n_chains, self.n_params), q.dtype,
                       q.device)[rows],
                uniform(gen, self.n_chains, q.dtype, q.device)[rows])

    def apply(self, noise, state, eps):
        """A jittered-length isokinetic trajectory + MH accept (≙
        ``mclmc.py:426-471``); returns (state, accepted (C,))."""
        n_live, z, unif = noise
        eps = float(scalar(eps, self.dtype))
        x, u, logp, grad = state.position, _normalize(z), state.logp, state.grad
        de = torch.zeros_like(logp)
        for _ in range(n_live):
            x, u, logp2, grad, dk1, dk2 = self._isokinetic(x, u, grad, eps)
            de = de + dk1 + dk2 - (logp2 - logp)
            logp = logp2
        accept = torch.log(unif) < -de
        a = accept[:, None]
        return MCLMCState(torch.where(a, x, state.position), u,
                          torch.where(accept, logp, state.logp),
                          torch.where(a, grad, state.grad)), accept

    def _trajectory(self, state, eps):
        noise = self.draw_noise(self._step_gen, state, self._host_gen,
                                self._n_max(eps))
        return self.apply(noise, state, eps)

    def _transition(self, state):
        return self._trajectory(state, self.step_size)[0]

    def tune(self, n_steps=600, target_energy_var=None, rounds=6,
             precondition=False):
        """Acceptance-targeted step-size search (one host sync a round) and
        the cloud-spread L (``target_energy_var`` is ignored).
        ``precondition=True`` inserts the mid-tune diagonal metric."""
        self._require_state()
        leg = max(int(n_steps) // int(rounds), 5)
        eps = self.step_size
        xs = None
        switch_at = max(int(rounds) // 2, 1) if precondition else None
        for r in range(int(rounds)):
            if r == switch_at and xs is not None:
                self._learn_metric(xs)
            accs, positions = [], []
            for _ in range(leg):
                self.state, acc = self._trajectory(self.state, eps)
                accs.append(acc)
                positions.append(self.state.position)
            xs = self._whole_steps(torch.stack(positions))
            acc = float(self._whole_steps(torch.stack(accs)).float().mean())
            self.last_mean_accept = acc
            eps *= float(np.clip(np.exp(acc - self.target_accept), 0.5, 2.0))
        self.step_size = float(eps)
        self.decoherence_length = self._whitened_spread(xs)
        return self
