"""Shared arithmetic of the per-layer metric readers (``metrics/*.py``).

A reader takes a :class:`Context` of the traced run and returns a number,
or None where it finds nothing to read; it never returns 0 for a share of a
roofline or of a peak."""

from portbench.harness import catalog, peaks


class Context:
    """What a reader may read: ``trace`` (a :class:`~portbench.harness.
    trace.Trace`, or None), ``steps`` in the traced window, ``n`` (walkers a
    half) and ``p`` (dimension), ``config``, ``appends`` ((seconds, rows) of
    each timed append of stored rows)."""

    def __init__(self, trace, steps, n, p, config, appends=()):
        self.trace = trace
        self.steps = steps
        self.n = n
        self.p = p
        self.config = config
        self.appends = list(appends)


def kernel_roofline(ctx, kernel):
    """The share (%) of ``roofline/<kernel>.py``'s least time in the mean
    device time of one launch of that kernel in the traced window."""
    if ctx.trace is None:
        return None
    roof = catalog.roofline(kernel)
    events = ctx.trace.kernels(roof.KERNELS)
    launches = [e for e in events if any(k in e["name"] for k in roof.MAIN)]
    if not launches:
        return None
    mean_s = sum(float(e["dur"]) for e in events) * 1e-6 / len(launches)
    least = peaks.least_seconds(roof.flop(ctx.n, ctx.p),
                                   roof.nbytes(ctx.n, ctx.p))
    return 100.0 * least / mean_s if mean_s > 0 else None


def device_idle_pct(ctx):
    """The share (%) of the traced window with nothing running on the
    card."""
    if ctx.trace is None or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
