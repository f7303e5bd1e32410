"""Host milliseconds a ``run_mcmc`` call spends folding the accept counters
of the driver (``sampler.py::EnsembleSampler._harvest_counters`` and
``_accum_accept``): the main thread's time inside the program's
``mcmcpp.harvest`` spans, less the runtime calls that wait for the card
(``trace.Trace.host_seconds_outside_waits``), over the window's
``mcmcpp.run_mcmc`` spans. None where the program records no
``mcmcpp.run_mcmc`` span; 0 where its calls record no harvest."""

MOVES = "walker_updates_per_s"
UNIT = "ms"
LAYER = "driver"
RUN = "mcmcpp.run_mcmc"
HARVEST = "mcmcpp.harvest"


def read(ctx):
    if ctx.trace is None:
        return None
    calls = ctx.trace.spans(RUN)
    if not calls:
        return None
    seconds = ctx.trace.host_seconds_outside_waits(span=HARVEST)
    return 0.0 if seconds is None else seconds * 1e3 / len(calls)
