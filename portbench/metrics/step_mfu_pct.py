"""The whole step's share (%) of the card's peak: the least time of the
algorithm's work a step (two half-steps of the configuration's
``half_step_roofline``, its operations and bytes summed, against the peaks
of ``harness/peaks.py``) over the measured time a step of the traced window.
The work counted is the algorithm's, whatever kernels do it."""

from portbench.harness import catalog, peaks

MOVES = "walker_updates_per_s"
UNIT = "%"
LAYER = "step"


def read(ctx):
    if ctx.trace is None or not ctx.steps or not ctx.trace.device:
        return None
    roof = catalog.roofline(ctx.config["half_step_roofline"])
    least = peaks.least_seconds(2 * roof.flop(ctx.n, ctx.p),
                                   2 * roof.nbytes(ctx.n, ctx.p))
    return 100.0 * least / (ctx.trace.window_s / ctx.steps)
