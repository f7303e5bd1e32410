"""The Stan-style diagnose-and-fix workflow, end to end on Neal's funnel.

The port of ``examples/bayesian_workflow.py``:

1. NUTS on the CENTERED funnel: divergences concentrate at the neck
   (``sample_stats.diverging``, the geometry signal ArviZ plots);
2. fix 1, the non-centered reparametrization: divergences vanish;
3. fix 2, NeuTra flow preconditioning of the original geometry;
4. MEADS on the reparametrized model, a tuning-free ensemble alternative;

and the ArviZ export of the non-centered run. Beyond the reference, whose
Calculator contract is gradient-free
(``MCMCpp/Utility/UserOjbectsTest.h:144-151``).

The JAX program prints its checks; this one returns non-zero unless they
hold: the non-centered NUTS run has fewer than 1% divergent transitions and
samples std(v) within 0.75 of the truth, 3; MEADS does the same with a mean
acceptance inside (0.2, 1]; NeuTra's draws are finite; the export carries
the posterior and the divergence and energy sample stats.

Usage:
    python -m mcmcpp_tpu_torch.examples.bayesian_workflow [--dim 10] \
        [--quick] [--device cuda|cpu]
"""

import argparse
import sys

import numpy as np
import torch

from mcmcpp_tpu_torch import MEADSSampler, NeuTra, NUTSSampler
from mcmcpp_tpu_torch.export import to_inference_dict
from mcmcpp_tpu_torch.sampler import resolve_device

V_SD = 3.0
STD_TOL = 0.75


def centered(d):
    """Neal's funnel, v ~ N(0, 3²), x_i | v ~ N(0, e^v): per θ."""
    def logp(t):
        v, x = t[0], t[1:]
        return (-0.5 * (v / V_SD) ** 2
                - 0.5 * torch.sum(x * x) * torch.exp(-v) - 0.5 * v * (d - 1))

    return logp


def noncentered(t):
    """The same posterior in (v, z) with x = e^{v/2} z: per θ."""
    v, z = t[0], t[1:]
    return -0.5 * (v / V_SD) ** 2 - 0.5 * torch.sum(z * z)


def run(d=10, warm=500, steps=1000, fit=1500, device="cuda"):
    """The four stages at ``d`` dimensions with ``warm`` warmup and ``steps``
    sampling steps a NUTS or MEADS run and ``fit`` NeuTra steps; prints
    their checks and returns the names of the failed ones."""
    dev = device
    failed = []

    print(f"== 1. centered funnel (dim={d}), NUTS ==")
    s = NUTSSampler(torch.func.vmap(centered(d)), n_chains=32, n_params=d,
                    seed=0, max_depth=8, device=dev)
    s.init_ball(np.zeros(d), scale=1.0, seed=1)
    s.warmup(warm)
    s.run(steps)
    div = s.get_sample_stats()["diverging"]
    v = s.get_samples()[:, :, 0]
    print(f"divergent transitions: {int(div.sum())} "
          f"({100 * div.mean():.2f}% of draws)")
    if div.sum():
        print(f"  mean v at divergences {v[div].mean():+.2f} vs overall "
              f"{v.mean():+.2f}  -> the neck, reparametrize!")
    print(f"sampled std(v) = {v.std():.2f} (truth 3.00 — the centered "
          "chain undercovers the neck)")

    print("\n== 2. non-centered reparam: v, z with x = e^{v/2} z ==")
    s2 = NUTSSampler(torch.func.vmap(noncentered), n_chains=32, n_params=d,
                     seed=0, max_depth=8, device=dev)
    s2.init_ball(np.zeros(d), scale=1.0, seed=2)
    s2.warmup(warm)
    s2.run(steps)
    st2 = s2.get_sample_stats()
    v2 = s2.get_samples()[:, :, 0]
    en = st2["energy"]
    bfmi = float(np.square(np.diff(en, axis=0)).mean() / en.var())
    div2 = float(st2["diverging"].mean())
    print(f"divergent transitions: {int(st2['diverging'].sum())}; "
          f"E-BFMI {bfmi:.2f}")
    print(f"sampled std(v) = {v2.std():.2f} (truth 3.00)")
    if not (div2 < 0.01 and abs(v2.std() - V_SD) < STD_TOL):
        failed.append("non-centered NUTS")

    print("\n== 3. NeuTra: learn the geometry instead of deriving it ==")
    nt = NeuTra(centered(d), d, seed=3, device=dev)
    nt.fit(fit)
    s3 = nt.make_sampler(NUTSSampler, n_chains=32, max_depth=8)
    s3.warmup(warm)
    s3.run(steps)
    v3 = nt.transform(s3.get_samples(flat=True))[:, 0]
    print(f"divergent transitions: "
          f"{int(s3.get_sample_stats()['diverging'].sum())}")
    print(f"sampled std(v) = {v3.std():.2f} (truth 3.00)")
    if not np.isfinite(v3).all():
        failed.append("NeuTra")

    print("\n== 4. MEADS on the reparametrized model (tuning-free) ==")
    s4 = MEADSSampler(torch.func.vmap(noncentered), n_chains=64, n_params=d,
                      seed=4, device=dev)
    s4.init_ball(np.zeros(d), scale=1.0, seed=5)
    s4.warmup(warm)
    s4.run(steps)
    v4 = s4.get_samples(burn_in=steps // 5)[:, :, 0]
    print(f"accept {s4.last_mean_accept:.2f}, "
          f"sampled std(v) = {v4.std():.2f} (truth 3.00)")
    if not (0.2 < s4.last_mean_accept <= 1.0
            and abs(v4.std() - V_SD) < STD_TOL):
        failed.append("MEADS")

    d_out = to_inference_dict(s2)
    print("\nArviZ export groups:", sorted(d_out),
          "| sample_stats:", sorted(d_out["sample_stats"]))
    if not ({"posterior", "sample_stats"} <= set(d_out) and {
            "diverging", "energy"} <= set(d_out["sample_stats"])):
        failed.append("export")
    return failed


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=10)
    ap.add_argument("--quick", action="store_true",
                    help="tiny budgets for smoke tests")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)  # no CPU fallback
    budgets = (60, 100, 80) if args.quick else (500, 1000, 1500)
    failed = run(args.dim, *budgets, device=args.device)
    print("OK" if not failed else "FAILED: " + ", ".join(failed))
    return 0 if not failed else 1


if __name__ == "__main__":
    sys.exit(main())
