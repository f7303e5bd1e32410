"""Observability: throughput counters + profiler hooks.

The reference has no tracing/profiling at all (SURVEY.md §5 — commented-out
couts). Here: walker-updates/s and ESS/s counters for runs, and a thin
wrapper over ``torch.profiler`` for device traces.
"""

import contextlib
import time
from pathlib import Path

import numpy as np


class ThroughputMonitor:
    """Accumulates wall-time and update counts; reports updates/s & ESS/s.

    Usage::

        mon = ThroughputMonitor(n_walkers=W)
        with mon.measure(steps=1000):
            sampler.run_mcmc(1000)
        print(mon.updates_per_s)
        print(mon.ess_per_s(sampler.get_samples()))
    """

    def __init__(self, n_walkers):
        self.n_walkers = int(n_walkers)
        self.seconds = 0.0
        self.steps = 0

    @contextlib.contextmanager
    def measure(self, steps):
        t0 = time.perf_counter()
        yield self
        self.seconds += time.perf_counter() - t0
        self.steps += int(steps)

    @property
    def updates(self):
        return self.steps * self.n_walkers

    @property
    def updates_per_s(self):
        return self.updates / self.seconds if self.seconds else 0.0

    def ess_per_s(self, samples, **kw):
        """ESS/s per parameter over the measured window (NaN if τ never
        converged — see analysis.ess); ``kw`` goes to
        ``effective_sample_size`` (numpy runs on its ``device``, default
        "cuda")."""
        from mcmcpp_tpu_torch.analysis import effective_sample_size

        ess = np.asarray(effective_sample_size(samples, **kw), np.float64)
        return ess / self.seconds if self.seconds else ess * 0.0


@contextlib.contextmanager
def trace_profile(log_dir):
    """Capture a ``torch.profiler`` trace of the block (host activity, and
    the card's when CUDA is available) and write it as a Chrome trace,
    ``trace.json`` under ``log_dir`` (open in Perfetto or chrome://tracing).
    Yields the profiler, so ``prof.key_averages()`` is there after the block.

    ≙ the tracing subsystem the reference lacks (SURVEY.md §5).
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))
