"""Cases shared by ``tests/test_torch_sharded_engines.py`` and its
two-process workers: every engine that takes ``mesh=``, at the sizes of
``tests/test_multihost.py::test_two_process_engines_hmc_pt_smc`` (16 chains,
walkers or particles in 3-D), and layouts whose ranks are threads of one
process. Imports neither JAX nor the JAX package, so that a worker starts
fast.

A case is ``fn(mesh) -> {key: value}``: ``mesh`` None runs the engine
unsharded on the CPU. A key's prefix says how the ranks' values make the
unsharded one: ``rows:`` concatenated on the chain axis (axis 1 of stored
rows, axis 0 of a per-chain vector), ``halves:`` a cold chain's columns
``[red, black]`` of each rank, ``particles:`` SMC's ``[red, black]`` rows of
each rank (``blocks4:`` block by block, the four blocks of waste-free
K = 3), ``same:`` equal on every rank and to the unsharded value.
"""

import threading
from dataclasses import dataclass

import numpy as np
import torch

import mcmcpp_tpu_torch as mt
from mcmcpp_tpu_torch.parallel.mesh import LadderLayout, WalkerLayout


def logp(x):
    return -0.5 * torch.sum(x * x, dim=-1)


def _kw(mesh):
    return {"device": "cpu"} if mesh is None else {"mesh": mesh}


def _gradient(cls, warm, steps, **kw):
    def case(mesh):
        s = cls(logp, 16, 3, seed=0, **kw, **_kw(mesh))
        s.init_ball(np.zeros(3), scale=0.5, seed=1)
        s.warmup(warm)
        s.run(steps)
        out = {"rows:samples": s.get_samples(),
               "rows:logps": s.get_log_probs(),
               "rows:diverging": s.get_sample_stats()["diverging"],
               "same:acc": s.last_mean_accept}
        if isinstance(s.step_size, torch.Tensor):
            out["rows:step"] = s.step_size.numpy()
        else:
            out["same:step"] = s.step_size
        if cls is not mt.MEADSSampler:
            out["same:mass"] = s.inv_mass.numpy()
        if cls is mt.CheesHMCSampler:
            out["same:traj"] = s.traj_length
        return out

    return case


def _mclmc(cls, tune):
    def case(mesh):
        s = cls(logp, 16, 3, seed=0, **_kw(mesh))
        s.init_ball(np.zeros(3), scale=0.5, seed=1)
        s.tune(tune, rounds=2, precondition=True)
        s.run(5)
        return {"rows:samples": s.get_samples(),
                "rows:logps": s.get_log_probs(),
                "same:eps": s.step_size, "same:L": s.decoherence_length,
                "same:mass": s.inv_mass.numpy()}

    return case


_SG_DATA = np.random.default_rng(0).standard_normal((64, 3)).astype(
    np.float32)


def _sg(cls):
    def case(mesh):
        s = cls(logp, lambda t, b: -0.5 * torch.sum(
            (b[None] - t[:, None]) ** 2, (-1, -2)), _SG_DATA, n_chains=16,
            n_params=3, batch_size=8, step_size=1e-4, seed=0, **_kw(mesh))
        s.init_ball(np.zeros(3), scale=0.1, seed=4)
        s.run(10)
        pos = s.state.position
        pos = pos if mesh is None else mesh.gather(pos)
        return {"rows:samples": s.get_samples(),
                "rows:logps": s.get_log_probs(),
                "same:mean": float(torch.mean(pos))}

    return case


def pt_case(mesh, power=False, mover=None, steps=10):
    """``test_two_process_engines_hmc_pt_smc``'s PT (and, with ``power``,
    its power-posterior PT), swapping every other step."""
    if power:
        s = mt.ParallelTemperingSampler(
            loglike_fn=logp, logprior_fn=lambda t: logp(t) / 4.0,
            n_walkers=16, n_params=3, betas=mt.power_ladder(4), seed=0,
            batched=True, swap_every=2, **_kw(mesh))
    else:
        s = mt.ParallelTemperingSampler(logp, 16, 3, n_temps=4, seed=0,
                                        batched=True, swap_every=2,
                                        mover=mover, **_kw(mesh))
    s.init_ball(np.zeros(3), scale=0.5, seed=2)
    s.run_mcmc(steps)
    out = {"halves:samples": s.get_samples(),
           "halves:logps": s.get_log_probs(),
           "same:swaps": s.swap_acceptance}
    if power:
        out["same:ss"] = s.log_evidence("stepping_stone")
        out["same:ti"] = s.log_evidence("ti")
    return out


def _gibbs(more):
    """The JAX worker's blocked Gibbs sampler (MALA and an elliptical slice
    block; with ``more``, a categorical and an exact block too): its rows,
    the stored logp column and the mean of z over every chain
    (gathered)."""

    def case(mesh):
        blocks = [
            ("x", 2, mt.MALAKernel(lambda x, o: -0.5 * torch.sum(x * x),
                                   0.5)),
            ("z", 3, mt.EllipticalSliceKernel(
                lambda z, o: -0.5 * torch.sum((z - torch.sum(o["x"])) ** 2),
                prior_scale=np.ones(3)))]
        init = {"x": np.zeros(2), "z": np.zeros(3)}
        if more:
            blocks += [
                ("c", 2, mt.CategoricalGibbsKernel(
                    lambda o: torch.stack([o["x"], -o["x"]], -1))),
                ("e", 1, mt.ExactGibbsKernel(
                    lambda g, o: torch.randn((1,), generator=g)
                    + o["x"][:1]))]
            init.update(c=np.zeros(2), e=np.zeros(1))
        gb = mt.BlockedGibbsSampler(
            blocks, n_chains=16, seed=0,
            logp_fn=lambda v: -0.5 * torch.sum(v["z"] ** 2), **_kw(mesh))
        gb.init(init)
        gb.run(10)
        z = gb.state["z"] if mesh is None else mesh.gather(gb.state["z"])
        return {"rows:samples": gb.get_samples(),
                "rows:logps": gb.chain.get_logp(),
                "same:mean": float(torch.mean(z))}

    return case


def _gaussian_prior(cls, steps):
    def case(mesh):
        s = cls(lambda f: -0.5 * torch.sum((f - 1.0) ** 2, -1) / 0.3,
                np.zeros(4), prior_scale=np.ones(4), n_chains=16, seed=0,
                batched=True, **_kw(mesh))
        s.init_prior(seed=3)
        out = {}
        if cls is mt.PCNSampler:
            s.tune(40, window=10)
            out["same:beta"] = s.beta
        s.run(steps)
        out.update({"rows:samples": s.get_samples(),
                    "rows:lls": s.get_log_likes()})
        if cls is mt.PCNSampler:
            out["same:accept"] = s.acceptance_fraction
        return out

    return case


def _smc(**kw):
    def case(mesh):
        e = dict(n_particles=16, n_mcmc=1)
        e.update(kw)
        smc = mt.SMCSampler(
            logp, lambda t: -0.5 * torch.sum((t - 1.0) ** 2, -1) / 0.5,
            lambda g, n: torch.randn((n, 3), generator=g), n_params=3,
            seed=0, batched=True, **e, **_kw(mesh))
        smc.run(max_stages=20)
        key = "blocks4" if "waste_free_k" in kw else "particles"
        return {key + ":particles": smc.particles,
                "same:logz": smc.log_evidence,
                "same:betas": np.asarray(smc.beta_ladder)}

    return case


def _nested(kernel):
    def case(mesh):
        ns = mt.NestedSampler(
            lambda t: torch.where(torch.all(torch.abs(t) < 5, -1), 0.0,
                                  -torch.inf),
            logp, lambda g, n: 10 * torch.rand((n, 2), generator=g) - 5, 2,
            n_live=64, batch=16, n_mcmc=3, seed=3, kernel=kernel,
            batched=True, **_kw(mesh))
        r = ns.run(dlogz=0.1, max_iters=8)
        return {"same:logz": r.logz, "same:samples": r.samples,
                "same:iters": r.n_iters, "same:calls": r.n_calls}

    return case


ENGINES = {
    "hmc": _gradient(mt.HMCSampler, 5, 20, n_leapfrog=3),
    "mala": _gradient(mt.MALASampler, 3, 5),
    "barker": _gradient(mt.BarkerSampler, 3, 5),
    "nuts": _gradient(mt.NUTSSampler, 2, 3, max_depth=4),
    "chees": _gradient(mt.CheesHMCSampler, 4, 4),
    "meads": _gradient(mt.MEADSSampler, 3, 10, n_folds=2),
    "sgld": _sg(mt.SGLDSampler),
    "sghmc": _sg(mt.SGHMCSampler),
    "mclmc": _mclmc(mt.MCLMCSampler, 20),
    "mams": _mclmc(mt.MAMSSampler, 10),
    "pt": pt_case,
    "pt_power": lambda mesh: pt_case(mesh, power=True),
    "pt_slice": lambda mesh: pt_case(mesh, mover=mt.EnsembleSliceMove(),
                                     steps=2),
    "gibbs": _gibbs(False),
    "gibbs_more": _gibbs(True),
    "pcn": _gaussian_prior(mt.PCNSampler, 10),
    "elliptical": _gaussian_prior(mt.EllipticalSliceSampler, 10),
    "smc": _smc(),
    "smc_fused": _smc(mover=mt.FusedStretchMove()),
    "smc_mala": _smc(mutation="mala"),
    "smc_waste_free": _smc(waste_free_k=3, n_particles=32),
    "nested": _nested("stretch"),
    "nested_slice": _nested("slice"),
}
# cases that also run under a LadderLayout (its ranks split the 4 rungs)
LADDER = {"pt": pt_case,
          "pt_power": ENGINES["pt_power"]}


def assemble(key, parts):
    """The unsharded value of ``key`` from the ranks' ``parts``."""
    kind = key.split(":")[0]
    parts = [np.asarray(p) for p in parts]
    if kind == "rows":
        return np.concatenate(parts, axis=1 if parts[0].ndim > 1 else 0)
    if kind == "halves":
        halves = [np.split(p, 2, axis=1) for p in parts]
        return np.concatenate([h[0] for h in halves] + [h[1] for h in halves],
                              axis=1)
    if kind in ("particles", "blocks4"):
        blocks = 4 if kind == "blocks4" else 1
        split = [p.reshape(blocks, 2, -1, p.shape[-1]) for p in parts]
        return np.concatenate(split, axis=2).reshape(-1, parts[0].shape[-1])
    raise ValueError(key)


# -- layouts whose ranks are threads of this process --------------------------

# seconds a thread rank waits for the others at a collective, and a run for
# its threads
TIMEOUT_S = 120


class _Exchange:
    """What the threads of one layout pass each other: every rank's value,
    in rank order, once all have arrived."""

    def __init__(self, world):
        # a rank that never arrives (a loop another rank left) breaks the
        # barrier for all instead of hanging the test
        self.barrier = threading.Barrier(world, timeout=TIMEOUT_S)
        self.slots = [None] * world

    def __call__(self, rank, value):
        self.slots[rank] = value
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()
        return out


class _Threaded:
    """A layout's collectives among threads: no process group."""

    def bind(self, device=None):
        return self.device

    def stack(self, x):
        return torch.stack(self.exchange(self.rank, x.clone()))

    def any(self, flag):
        return any(self.exchange(self.rank, bool(torch.any(flag))))

    def sum(self, x):
        if self.world_size == 1:
            return x
        return torch.stack(self.exchange(self.rank, x.clone())).sum(0)


@dataclass(frozen=True)
class ThreadWalkerLayout(_Threaded, WalkerLayout):
    exchange: object = None


@dataclass(frozen=True)
class ThreadLadderLayout(_Threaded, LadderLayout):
    exchange: object = None


def run_in_threads(world, fn, n_ladder_shards=None):
    """``fn(layout)`` on ``world`` thread ranks of a walker layout (or of a
    ladder layout of ``n_ladder_shards``): their results in rank order."""
    exchange = _Exchange(world)
    out, errors = [None] * world, []

    def rank_main(rank):
        cpu = torch.device("cpu")
        try:
            layout = (ThreadWalkerLayout(world, rank, cpu, exchange=exchange)
                      if n_ladder_shards is None else
                      ThreadLadderLayout(n_ladder_shards, world, rank, cpu,
                                         exchange=exchange))
            out[rank] = fn(layout)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
            exchange.barrier.abort()

    threads = [threading.Thread(target=rank_main, args=(r,))
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT_S)
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise TimeoutError(f"a thread rank still runs after {TIMEOUT_S} s")
    return out
