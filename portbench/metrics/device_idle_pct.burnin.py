"""Share (%) of the traced window in which no kernel or copy ran on the
card, in a cell that reports ``walker_updates_per_s``."""

from portbench.harness.readers import device_idle_pct

MOVES = "walker_updates_per_s"
UNIT = "%"
LAYER = "device"


def read(ctx):
    return device_idle_pct(ctx)
