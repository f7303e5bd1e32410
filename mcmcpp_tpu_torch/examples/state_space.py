"""State-space workflows: the three latent-dynamics regimes side by side.

The port of ``examples/state_space.py``:

1. LINEAR-GAUSSIAN (local level, unknown observation variance): the exact
   FFBS trajectory block (``models.lgss.LGSSKernel``) + a conjugate
   inverse-gamma variance block in one blocked-Gibbs loop;
2. NON-LINEAR (stochastic volatility): particle marginal MH over the mean
   log-volatility with the bootstrap filter's unbiased likelihood
   (``PMMHSampler``);
3. DISCRETE REGIMES (a sticky 2-state HMM): the exact discrete FFBS state
   block (``models.hmm.HMMKernel``) + conjugate Dirichlet transition rows;
4. a structural (BSTS-style) decomposition and forecast.

Each section checks its result against the truth it simulated (the
reference's bounds); the program returns non-zero outside them.

Usage:
    python -m mcmcpp_tpu_torch.examples.state_space [--quick] \
        [--device cuda|cpu] [--chains 8]
"""

import argparse
import sys

import numpy as np
import torch

from mcmcpp_tpu_torch import (
    BlockedGibbsSampler,
    ExactGibbsKernel,
    PMMHSampler,
    StateSpaceModel,
)
from mcmcpp_tpu_torch.models.hmm import HMMKernel, gaussian_emission_logpdf
from mcmcpp_tpu_torch.models.lgss import (
    LGSSKernel,
    forecast,
    lgss_params,
    local_level as level_component,
    rts_smoother,
    seasonal as seasonal_component,
    structural,
)


def local_level_data(t_n=80, seed=11, sig_q=0.25, sig_r=0.7):
    """The local-level series: (latent truth, float32 observations)."""
    rng = np.random.default_rng(seed)
    x_true = np.cumsum(rng.normal(0, sig_q, t_n)) + 1.0
    return x_true, (x_true + rng.normal(0, sig_r, t_n)).astype(np.float32)


def local_level_sampler(ys, n_chains, device, sig_q=0.25, seed=0):
    """The FFBS + inverse-gamma blocked-Gibbs sampler of section 1."""
    t_n = len(ys)
    a0, b0 = 2.0, 1.0
    ys_t = torch.as_tensor(ys, device=device)

    def params_fn(others):
        return lgss_params(A=1.0, b=0.0, Q=sig_q ** 2, H=1.0, c=0.0,
                           R=others["s2r"][0], m0=1.0, P0=4.0, device=device)

    def sample_s2r(gen, others):
        b_n = b0 + 0.5 * torch.sum((ys_t - others["x"]) ** 2, -1,
                                   keepdim=True)
        return b_n / torch._standard_gamma(
            torch.full_like(b_n, a0 + 0.5 * t_n), generator=gen)

    gb = BlockedGibbsSampler(
        [("x", t_n, LGSSKernel(ys, params_fn)),
         ("s2r", 1, ExactGibbsKernel(sample_s2r, batched=True))],
        n_chains=n_chains, seed=seed, device=device)
    gb.init({"x": np.zeros(t_n, np.float32), "s2r": np.ones(1, np.float32)})
    return gb


def local_level(quick, device="cuda", n_chains=8):
    print("== 1. local level (exact FFBS + conjugate variance) ==")
    sig_r = 0.7
    x_true, ys = local_level_data()
    gb = local_level_sampler(ys, n_chains, device)
    gb.run(100 if quick else 500)
    burn = 25 if quick else 125
    s2r = gb.get_block("s2r")[burn:].reshape(-1)
    xs = gb.get_block("x")[burn:]
    rmse = float(np.sqrt(((xs.mean((0, 1)) - x_true) ** 2).mean()))
    print(f"  sigma_r^2 posterior mean {s2r.mean():.3f} "
          f"(truth {sig_r ** 2:.3f}); trajectory RMSE {rmse:.3f} "
          f"(< obs noise {sig_r})")
    return {"s2r_mean": float(s2r.mean()), "rmse": rmse,
            "ok": rmse < sig_r}


def sv_data(t_n, seed=5, mu=-1.0, phi=0.95, sig=0.3):
    """Stochastic-volatility returns: (latent log-variance, returns)."""
    rng = np.random.default_rng(seed)
    x = np.empty(t_n)
    x[0] = mu
    for t in range(1, t_n):
        x[t] = mu + phi * (x[t - 1] - mu) + sig * rng.standard_normal()
    return x, (np.exp(x / 2) * rng.standard_normal(t_n)).astype(np.float32)


def sv_model(phi=0.95, sig=0.3):
    """The SV model with its mean log-volatility θ[0] as the parameter. The
    hooks broadcast over leading axes, so they serve one filter (θ (1,),
    particles (n, 1)) and, with ``batched=True``, C filters at once (θ
    (C, 1), particles (C, n, 1)) with no ``vmap``."""
    sd0 = sig / np.sqrt(1 - phi ** 2)

    def init_sample(gen, n, th):
        mu = th[..., None, :1]
        return mu + sd0 * torch.randn(mu.shape[:-2] + (n, 1), generator=gen,
                                      device=gen.device)

    def trans_sample(gen, xp, t, th):
        mu = th[..., None, :1]
        return mu + phi * (xp - mu) + sig * torch.randn(
            xp.shape, generator=gen, device=gen.device)

    def obs_logpdf(y, xp, t, th):
        return -0.5 * (xp[..., 0] + y[0] ** 2 * torch.exp(-xp[..., 0])
                       + np.log(2 * np.pi))

    return StateSpaceModel(init_sample, trans_sample, obs_logpdf)


def stochastic_volatility(quick, device="cuda", n_chains=8):
    print("== 2. stochastic volatility (PMMH) ==")
    mu = -1.0
    _, ys = sv_data(100 if quick else 250)
    s = PMMHSampler(sv_model(), ys,
                    log_prior=lambda th: -0.5 * th[..., 0] ** 2, n_params=1,
                    n_particles=128 if quick else 512, proposal_scale=0.3,
                    n_chains=n_chains, seed=0, batched=True, device=device)
    s.init(np.zeros((n_chains, 1), np.float32))
    s.run(150 if quick else 400)
    draws = s.get_samples(burn_in=50 if quick else 150, flat=True)[:, 0]
    acc = float(s.acceptance_fraction.mean())
    print(f"  mu posterior {draws.mean():.3f} +- {draws.std():.3f} "
          f"(truth {mu}); acceptance {acc:.2f}")
    return {"mu_mean": float(draws.mean()), "acceptance": acc,
            "ok": abs(draws.mean() - mu) < 0.8}


def hmm_data(t_n, seed=7):
    """The sticky 2-state series: (the generator after the draws, true
    states, observations)."""
    rng = np.random.default_rng(seed)
    gamma_true = np.array([[0.95, 0.05], [0.10, 0.90]])
    z = np.zeros(t_n, int)
    for t in range(1, t_n):
        z[t] = rng.choice(2, p=gamma_true[z[t - 1]])
    ys = (np.array([-1.5, 1.5])[z] + 0.7 * rng.standard_normal(t_n)).astype(
        np.float32)
    return rng, z, ys


def dirichlet_rows(gen, others):
    """The conjugate draw of both chains' transition rows, batched: log of
    Dirichlet(1 + transition counts) rows, flattened."""
    z = others["z"].long()
    idx = z[:, :-1] * 2 + z[:, 1:]
    counts = torch.zeros((z.shape[0], 4), dtype=others["z"].dtype,
                         device=z.device)
    counts.scatter_add_(1, idx, torch.ones_like(idx, dtype=counts.dtype))
    g = torch._standard_gamma(counts.reshape(-1, 2, 2) + 1.0, generator=gen)
    return torch.log(g / torch.sum(g, -1, keepdim=True)).reshape(-1, 4)


def hmm_sampler(ys, n_chains, device, rng, method="sequential", seed=0):
    """The discrete-FFBS + Dirichlet blocked-Gibbs sampler of section 3."""
    t_n = len(ys)
    log_obs = gaussian_emission_logpdf(torch.as_tensor(ys, device=device),
                                       [-1.5, 1.5], [0.7, 0.7])
    log_pi = np.log(np.array([0.5, 0.5], np.float32))
    gb = BlockedGibbsSampler(
        [("z", t_n, HMMKernel(log_obs, log_pi,
                              lambda o: o["lgam"].reshape(2, 2), method)),
         ("lgam", 4, ExactGibbsKernel(dirichlet_rows, batched=True))],
        n_chains=n_chains, seed=seed, device=device)
    gb.init({"z": rng.integers(0, 2, t_n).astype(np.float32),
             "lgam": np.log(np.full(4, 0.5, np.float32))})
    return gb


def regime_switching(quick, device="cuda", n_chains=8):
    print("== 3. sticky 2-state HMM (discrete FFBS + Dirichlet rows) ==")
    rng, z, ys = hmm_data(150 if quick else 300)
    gb = hmm_sampler(ys, n_chains, device, rng)
    gb.run(100 if quick else 300)
    burn = 25 if quick else 75
    zs = gb.get_block("z")[burn:]
    lgs = gb.get_block("lgam")[burn:].reshape(-1, 2, 2)
    acc = float(((zs.mean((0, 1)) > 0.5).astype(int) == z).mean())
    diag = np.exp(lgs)[:, [0, 1], [0, 1]].mean(0)
    print(f"  state accuracy {acc:.3f}; sticky diagonal "
          f"[{diag[0]:.2f}, {diag[1]:.2f}] (truth [0.95, 0.90])")
    return {"accuracy": acc, "diag": diag.tolist(), "ok": acc > 0.85}


def structural_decomposition(quick, device="cuda"):
    print("== 4. structural decomposition + forecast (BSTS-style) ==")
    rng = np.random.default_rng(13)
    s_n, t_n, h = 4, 72 if quick else 144, 8
    season_true = np.array([1.2, -0.4, -1.0, 0.2])
    level_true = np.cumsum(rng.normal(0, 0.15, t_n + h)) + 2.0
    y_full = (level_true + season_true[np.arange(t_n + h) % s_n]
              + rng.normal(0, 0.3, t_n + h))
    ys = y_full[:t_n].astype(np.float32)
    p = structural([level_component(0.15, device=device),
                    seasonal_component(s_n, 0.01, device=device)],
                   sigma_obs=0.3, p0_scale=25.0)
    means = rts_smoother(p, ys)[0].cpu().numpy()
    corr = float(np.corrcoef(means[8:, 1],
                             season_true[np.arange(8, t_n) % s_n])[0, 1])
    _, _, om, o_cov = forecast(p, ys, horizon=h)
    om = om.cpu().numpy()[:, 0]
    sd = np.sqrt(o_cov.cpu().numpy()[:, 0, 0])
    cover = float((np.abs(om - y_full[t_n:]) < 3 * sd).mean())
    print(f"  smoothed seasonal corr with truth {corr:.3f}; "
          f"{h}-step holdout 3-sigma coverage {cover:.2f}")
    return {"corr": corr, "coverage": cover,
            "ok": corr > 0.85 and cover >= 0.75}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--chains", type=int, default=8)
    args = ap.parse_args(argv)
    results = [local_level(args.quick, args.device, args.chains),
               stochastic_volatility(args.quick, args.device, args.chains),
               regime_switching(args.quick, args.device, args.chains),
               structural_decomposition(args.quick, args.device)]
    if all(r["ok"] for r in results):
        print("OK")
        return 0
    print("FAILED: a section is outside its bound")
    return 1


if __name__ == "__main__":
    sys.exit(main())
