"""The fused stretch half-step for a GaussianTarget of P <= 16
(``csrc/fused_stretch.cu``): operations and bytes of one launch over n
walkers of dimension p.

Bytes: X, the partner rows and the output rows (n·p floats each), lp_old,
out_lp and out_acc (n 4-byte words each), each read or written once; the
uniforms are drawn in registers and move no byte. Operations: the P×P
product (2p² a walker), the proposal and squares (5p) and some 120 for
Philox's ten rounds, the logs and the square root.
"""

#: substrings of the launch's device kernels in a trace
KERNELS = ("fused_stretch_half_kernel",)
#: the kernels counted as launches (one a half-step)
MAIN = KERNELS


def flop(n, p):
    return n * (2 * p * p + 5 * p + 120)


def nbytes(n, p):
    return n * 4 * (3 * p + 3)
