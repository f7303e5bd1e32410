"""Share (%) of the traced window in which nothing runs on the card while
the host is inside the program's ``mcmcpp.harvest`` spans (the accept
counters' fold, ``sampler.py::EnsembleSampler._harvest_counters``): the
most of the window that a cheaper harvest could give back to the card.
None where the program records no ``mcmcpp.run_mcmc`` span; 0 where its
calls record no harvest."""

from portbench.harness.trace import _union

MOVES = "walker_updates_per_s"
UNIT = "%"
LAYER = "driver"
RUN = "mcmcpp.run_mcmc"
HARVEST = "mcmcpp.harvest"


def _overlap(a, b):
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(ctx):
    trace = ctx.trace
    if trace is None or not trace.spans(RUN):
        return None
    harvest = _union((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                     for e in trace.spans(HARVEST))
    inside = sum(e - s for s, e in harvest)
    idle_us = inside - _overlap(harvest, trace.busy_intervals())
    return 100.0 * idle_us * 1e-6 / trace.window_s
