"""Share (%) of the fused_stretch_wide kernel's roofline: its least time for one launch
at the cell's (n, P) (``roofline/fused_stretch_wide.py``) over its mean device time a
launch in the traced window (``ops/fused_stretch.py`` → ``csrc/fused_stretch_wide.cu``)."""

from portbench.harness.readers import kernel_roofline

MOVES = "walker_updates_per_s"
UNIT = "%"
LAYER = "kernels"


def read(ctx):
    return kernel_roofline(ctx, "fused_stretch_wide")
