"""Observability: throughput counters, the program's spans, profiler hooks.

The reference has no tracing/profiling at all (SURVEY.md §5 — commented-out
couts). Here: walker-updates/s and ESS/s counters for runs, named spans at
the sampler's and the chain's layer boundaries, and a thin wrapper over
``torch.profiler`` for device traces.

The spans (:func:`span`) are recorded only while a ``torch.profiler`` is
recording in the process, as ``user_annotation`` events of its trace, on the
clock of the kernels they enqueue; otherwise they cost a check and a shared
null context. Those the ensemble sampler opens, each nested in the one
above it on the calling thread:

- ``mcmcpp.run_mcmc``: one ``EnsembleSampler.run_mcmc`` call;
- ``mcmcpp.steps``: the loop that enqueues one device run of steps (one
  span per stored chunk on the storing path);
- ``mcmcpp.harvest``: folding the device's per-walker accept counters into
  the host's int64 totals, with ``mcmcpp.harvest.fetch`` (the blocking copy
  of the counters, which waits for the queued steps) and
  ``mcmcpp.harvest.fold`` (the int64 conversion and add on the host);
- ``mcmcpp.chain.append``: one ``Chain.append``, with
  ``mcmcpp.chain.fetch`` (each plane cast on its device and copied to the
  host).
"""

import contextlib
import time
from pathlib import Path

import numpy as np
import torch

_NO_SPAN = contextlib.nullcontext()


def span(name):
    """A context manager that marks its block as ``name`` in the trace of a
    running ``torch.profiler`` (``record_function``), and does nothing when
    no profiler is recording."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def _fence():
    """Wait for the card's queued work, where CUDA is in use."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


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
        """Time the block by the host clock, each reading taken after the
        card's queued work has finished (where CUDA is in use), so that the
        time is the work's and not its enqueue's."""
        _fence()
        t0 = time.perf_counter()
        yield self
        _fence()
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
    The trace holds the program's spans (:func:`span`).

    ≙ the tracing subsystem the reference lacks (SURVEY.md §5).
    """
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))
