"""Host microseconds a step of the driver (``sampler.py::EnsembleSampler.
run_mcmc``, ``_run_nostore``): the main thread's time inside the calls of
the traced window, less the runtime calls that wait for the card
(``trace.Trace.host_seconds_outside_waits``), over the steps taken. Under
the profiler, which adds its own cost to every recorded call."""

MOVES = "walker_updates_per_s"
UNIT = "us"
LAYER = "driver"


def read(ctx):
    if ctx.trace is None or not ctx.steps:
        return None
    seconds = ctx.trace.host_seconds_outside_waits()
    return None if seconds is None else seconds * 1e6 / ctx.steps
