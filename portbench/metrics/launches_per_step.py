"""Device kernels a step (``sampler.py::make_step_fn`` and the mover,
``movers/fused.py``): the kernels of the traced window over its steps."""

MOVES = "walker_updates_per_s"
UNIT = "launches"
LAYER = "step and mover"


def read(ctx):
    if ctx.trace is None or not ctx.steps:
        return None
    kernels = ctx.trace.kernels()
    return len(kernels) / ctx.steps if kernels else None
