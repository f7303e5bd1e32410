"""Data assimilation on Lorenz-96: ensemble Kalman filtering of a chaotic
40-dimensional system from partial, noisy observations.

The port of ``examples/data_assimilation.py``. The dynamics
dx_i/dt = (x_{i+1} − x_{i−2}) x_{i−1} − x_i + F (F = 8) are integrated by
RK4 with Δt = 0.05; every other grid point is observed in N(0, 1) noise;
the stochastic EnKF keeps the analysis RMSE near the observation noise.
Returns non-zero outside the reference's bounds (RMSE below 0.6 of the
climatological spread; at full size below 1.2).

Usage:
    python -m mcmcpp_tpu_torch.examples.data_assimilation [--quick] \
        [--device cuda|cpu] [--variant stochastic|etkf]
"""

import argparse
import sys

import numpy as np
import torch

from mcmcpp_tpu_torch import EnKFModel, ensemble_kalman_filter

D, F, DT = 40, 8.0, 0.05
OBS_EVERY = 2           # observe x_0, x_2, x_4, ...
SIG_OBS = 1.0
SIG_MODEL = 0.03        # small additive model error keeps spread alive


def l96_tendency(x):
    return (torch.roll(x, -1, -1) - torch.roll(x, 2, -1)) * torch.roll(
        x, 1, -1) - x + F


def rk4(x, dt=DT):
    k1 = l96_tendency(x)
    k2 = l96_tendency(x + 0.5 * dt * k1)
    k3 = l96_tendency(x + 0.5 * dt * k2)
    k4 = l96_tendency(x + dt * k3)
    return x + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)


def simulate_truth(t_n, seed=0):
    """(truth (T, D), observations (T, D/2), observed indices), in float64
    on the host."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(F + rng.standard_normal(D), dtype=torch.float64)
    for _ in range(200):                     # spin onto the attractor
        x = rk4(x)
    xs = []
    for _ in range(t_n):
        x = rk4(x)
        xs.append(x.numpy().copy())
    truth = np.stack(xs)
    h_idx = np.arange(0, D, OBS_EVERY)
    ys = truth[:, h_idx] + SIG_OBS * rng.standard_normal((t_n, h_idx.size))
    return truth, ys.astype(np.float32), h_idx


def build_model(x0, h_idx, device):
    x0 = torch.as_tensor(x0, dtype=torch.float32, device=device)
    idx = torch.as_tensor(h_idx, device=device)
    return EnKFModel(
        init_sample=lambda g, n: x0 + 2.0 * torch.randn(
            (n, D), generator=g, device=g.device),
        trans_sample=lambda g, x, t: rk4(x) + SIG_MODEL * torch.randn(
            x.shape, generator=g, device=g.device),
        obs_fn=lambda x, t: x[:, idx],
        obs_cov=SIG_OBS ** 2 * torch.eye(len(h_idx), device=device))


def assimilate(t_n, n_members, device, variant="stochastic", seed=0):
    """(analysis RMSE after a quarter of warm-up, climatological spread,
    the filter's result)."""
    truth, ys, h_idx = simulate_truth(t_n, seed=1)
    res = ensemble_kalman_filter(seed, build_model(truth[0], h_idx, device),
                                 ys, n_members, inflation=1.05,
                                 variant=variant, device=device)
    warm = t_n // 4
    rmse = float(np.sqrt(np.mean((res.means.cpu().numpy()[warm:]
                                  - truth[warm:]) ** 2)))
    return rmse, float(truth.std()), res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--variant", default="stochastic")
    args = ap.parse_args(argv)
    t_n = 60 if args.quick else 400
    n_members = 32 if args.quick else 64
    rmse, clim, res = assimilate(t_n, n_members, args.device, args.variant)
    print(f"Lorenz-96 D={D}, obs every {OBS_EVERY} pts @ sigma={SIG_OBS}, "
          f"N={n_members}, T={t_n}")
    print(f"analysis RMSE {rmse:.2f}  (obs noise {SIG_OBS}, "
          f"climatology {clim:.2f})")
    print(f"predictive loglik {float(res.loglik):.1f}")
    ok = rmse < clim * 0.6 and (args.quick or rmse < 1.2)
    print("OK" if ok else "FAILED: outside the bounds")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
