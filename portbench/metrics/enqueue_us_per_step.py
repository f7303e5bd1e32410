"""Host microseconds a step in the loops that enqueue the steps
(``sampler.py::run_nostore`` and ``run_scan``, the program's
``mcmcpp.steps`` spans): the main thread's time inside those spans, less
the runtime calls that wait for the card (``trace.Trace.
host_seconds_outside_waits``), over the window's steps. None where the
program records no ``mcmcpp.run_mcmc`` span; 0 where its calls record no
``mcmcpp.steps``."""

MOVES = "walker_updates_per_s"
UNIT = "us"
LAYER = "step and mover"
RUN = "mcmcpp.run_mcmc"
STEPS = "mcmcpp.steps"


def read(ctx):
    if ctx.trace is None or not ctx.steps or not ctx.trace.spans(RUN):
        return None
    seconds = ctx.trace.host_seconds_outside_waits(span=STEPS)
    return 0.0 if seconds is None else seconds * 1e6 / ctx.steps
