"""The program under test, ``mcmcpp_tpu_torch``, through its normal entry
point: an ``EnsembleSampler`` over a ``GaussianTarget`` with the mover the
configuration names. This is the one module of the harness that imports
the port; it is imported only once a card was found (or by a CPU test)."""

import contextlib
import time

import torch

MOVERS = {
    "fused_stretch": lambda spec: _movers().FusedStretchMove(
        a=float(spec["a"])),
}


def _movers():
    import mcmcpp_tpu_torch.movers as movers

    return movers


def build_sampler(config, traffic, prec_chol, start, seed, device):
    """The sampler of a cell, its walkers set to ``start`` (W, P) float32.
    Its own generators are seeded with ``seed``."""
    from mcmcpp_tpu_torch.models.targets import GaussianTarget
    from mcmcpp_tpu_torch.sampler import EnsembleSampler

    if config["dtype"] != "float32":
        raise ValueError(f"no program path for dtype {config['dtype']!r}")
    mover_spec = config["mover"]
    if mover_spec.get("partner_mode", "roll") != "roll":
        raise ValueError("the fused stretch move pairs by a roll only")
    target = GaussianTarget(prec_chol, device=device)
    store_dtype = traffic.get("store_dtype")
    sampler = EnsembleSampler(
        target, start.shape[0], start.shape[1],
        mover=MOVERS[mover_spec["kind"]](mover_spec), seed=seed,
        batched=True, device=device, dtype=torch.float32,
        store_dtype=None if store_dtype is None else getattr(
            torch, store_dtype))
    sampler.set_initial_walker_pos(start)
    return sampler


def run_call(sampler, traffic, steps=None):
    """One call of the cell's shape (``steps`` overrides its length);
    returns what ``run_mcmc`` returns."""
    steps = traffic["steps_per_call"] if steps is None else steps
    if traffic["store"]:
        return sampler.run_mcmc(steps, thin=traffic["thin"])
    return sampler.run_mcmc(steps, store=False)


def state(sampler):
    """(red, black, logp_red, logp_black), cloned."""
    s = sampler.state
    return tuple(t.clone() for t in (s.red, s.black, s.logp_red,
                                     s.logp_black))


def accepted(sampler):
    """Per-walker accepted counts, [red…, black…], as a host int64 tensor."""
    return torch.from_numpy(sampler.per_walker_accepted.copy())


def last_stored_row(sampler):
    """The chain's newest stored row as held: (positions (W, P), logp (W,))
    raw-bit tensors."""
    return (torch.from_numpy(sampler.chain.get(held=True)[-1].copy()),
            torch.from_numpy(sampler.chain.get_logp(held=True)[-1].copy()))


def launch_counts():
    """The program's own counter of kernel launches, by kernel."""
    from mcmcpp_tpu_torch.ops.fused_stretch import LAUNCHES

    return dict(LAUNCHES)


@contextlib.contextmanager
def timed_appends(record):
    """While open, every append of stored rows (``append_device_chunk`` as
    the sampler calls it) is timed by the host clock into ``record`` as
    (seconds, rows), inside a profiler span ``portbench.append``."""
    import mcmcpp_tpu_torch.sampler as sampler_mod

    inner = getattr(sampler_mod, "append_device_chunk", None)
    if inner is None:
        yield
        return

    def timed(chain, pos, logp):
        with torch.profiler.record_function("portbench.append"):
            t0 = time.perf_counter()
            out = inner(chain, pos, logp)
            record.append((time.perf_counter() - t0, int(pos.shape[0])))
        return out

    sampler_mod.append_device_chunk = timed
    try:
        yield
    finally:
        sampler_mod.append_device_chunk = inner
