"""Milliseconds a stored row spends in the append of the chain layer
(``chain.py::append_device_chunk`` → ``Chain.append``, with the fetch of the
row to the host), by the host clock around each append the sampler makes in
the traced window."""

MOVES = "stored_walker_updates_per_s"
UNIT = "ms"
LAYER = "chain"


def read(ctx):
    rows = sum(r for _, r in ctx.appends)
    if not rows:
        return None
    return 1e3 * sum(s for s, _ in ctx.appends) / rows
