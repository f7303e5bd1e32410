"""Corner-plot histograms: all 1-D and P(P−1)/2 2-D marginals.

Rebuild of ``MCMCpp/Analysis/CornerHistograms.h``: two passes — auto-binning
from observed extremes with degeneracy guards (:316-371), then filling
(:296-313) — plus CSV writers (:231-294). Binning uses true min/max
(the reference's all-negative-data bound bug at :411, min() vs lowest(),
is not replicated).
"""

import os

import numpy as np


def padded_range(lo, hi):
    """Widen a degenerate [lo, hi] observation range (≙ the reference's
    degeneracy guards, CornerHistograms.h:316-371)."""
    if hi <= lo:
        pad = 0.5 if lo == 0.0 else abs(lo) * 0.05
        return lo - pad, hi + pad
    return lo, hi


class CornerHistograms:
    """Compute & hold the full corner set for (S, W, P) or (N, P) samples."""

    def __init__(self, n_bins=100):
        self.n_bins = int(n_bins)
        self.hist1d = None  # list of (counts, edges)
        self.hist2d = None  # dict (i, j) -> (counts, xedges, yedges)
        self.n_params = None

    def calculate(self, samples):
        arr = np.asarray(samples)
        if arr.ndim == 3:
            arr = arr.reshape(-1, arr.shape[-1])
        n, p = arr.shape
        self.n_params = p
        edges = []
        for i in range(p):
            lo, hi = padded_range(
                float(arr[:, i].min()), float(arr[:, i].max())
            )
            edges.append(np.linspace(lo, hi, self.n_bins + 1))
        self.hist1d = [
            (np.histogram(arr[:, i], bins=edges[i])[0], edges[i]) for i in range(p)
        ]
        self.hist2d = {}
        for i in range(p):
            for j in range(i + 1, p):
                counts, xe, ye = np.histogram2d(
                    arr[:, i], arr[:, j], bins=[edges[i], edges[j]]
                )
                self.hist2d[(i, j)] = (counts, xe, ye)
        return self

    def save_csv(self, directory, prefix="corner"):
        """CSV dump (≙ saveHistsCsvFormat, CornerHistograms.h:231-294)."""
        os.makedirs(directory, exist_ok=True)
        for i, (counts, edges) in enumerate(self.hist1d):
            path = os.path.join(directory, f"{prefix}_1d_p{i}.csv")
            centers = 0.5 * (edges[:-1] + edges[1:])
            np.savetxt(
                path,
                np.column_stack([centers, counts]),
                delimiter=",",
                header="bin_center,count",
                comments="",
            )
        for (i, j), (counts, xe, ye) in self.hist2d.items():
            path = os.path.join(directory, f"{prefix}_2d_p{i}_p{j}.csv")
            np.savetxt(path, counts, delimiter=",")
            # axes are unrecoverable from bare counts: save the edges too
            np.savetxt(
                os.path.join(directory, f"{prefix}_2d_p{i}_p{j}_edges.csv"),
                np.column_stack([xe, ye]),
                delimiter=",",
                header="xedges,yedges",
                comments="",
            )
        return directory
