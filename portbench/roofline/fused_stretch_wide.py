"""The wide stretch half-step for a GaussianTarget of P > 16
(``csrc/fused_stretch_wide.cu``, every route): operations and bytes of one
launch over n walkers of dimension p.

Bytes as the fused kernel's: X, the partner rows and the output rows, lp_old,
out_lp and out_acc, each once (L and the scratch stay in L2 and shared
memory: n·p dominates). Operations: the algorithm's P×P product, 2p² a
walker, whatever scheme computes it (3xTF32 on the tensor cores today), and
the proposal terms, 5p + 120.
"""

#: substrings of the launch's device kernels in a trace: the routes' kernels
#: and the prologue that splits L on the streamed routes
KERNELS = ("wide_ws_kernel", "wide_cluster_kernel", "wide_stream_kernel",
           "wide_ksplit_kernel", "wide_yl_kernel",
           "fused_stretch_wide_kernel", "split_l_stages")
#: the kernels counted as launches (one a half-step; the prologue is not one)
MAIN = KERNELS[:-1]


def flop(n, p):
    return n * (2 * p * p + 5 * p + 120)


def nbytes(n, p):
    return n * 4 * (3 * p + 3)
