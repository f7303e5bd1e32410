"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
at the full 700 W power limit), the yardstick of every roofline share."""

#: HBM3 bandwidth, bytes/s
PEAK_BYTES_PER_S = 3.35e12
#: the dense TF32 rate of the tensor cores, FLOP/s
PEAK_TF32_FLOP_PER_S = 495e12
#: float32's accuracy on the tensor cores takes three TF32 products
#: (3xTF32), so a float32 product's FLOP run at most at a third of the TF32
#: rate; the FLOP counted are the algorithm's, not the scheme's
PEAK_F32_PRODUCT_FLOP_PER_S = PEAK_TF32_FLOP_PER_S / 3


def least_seconds(flop, nbytes):
    """The least time the card could take for ``flop`` operations and
    ``nbytes`` moved: the larger of the two at their peaks."""
    return max(nbytes / PEAK_BYTES_PER_S, flop / PEAK_F32_PRODUCT_FLOP_PER_S)
