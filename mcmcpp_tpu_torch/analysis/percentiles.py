"""Percentile / mode estimation from high-resolution 1-D histograms.

Rebuild of ``MCMCpp/Analysis/PercentileAndMaximumFinder.h``: high-res
histograms + cumulative sums (:424-433), value→percentile by linear
interpolation (:258-288), percentile→value by search + interpolation
(:291-346), mode = fullest-bin center (:349-367), CSV writers (:370-421).
(The reference's min()-vs-lowest() upper-bound bug at :542 is not
replicated.)
"""

import os

import numpy as np

from mcmcpp_tpu_torch.analysis.histograms import padded_range


class PercentileAndMaximumFinder:
    def __init__(self, n_bins=4096):
        self.n_bins = int(n_bins)
        self.counts = None  # (P, n_bins)
        self.edges = None  # (P, n_bins+1)
        self.cum = None  # (P, n_bins) cumulative fraction at bin right edge
        self.n_params = None
        self.n_samples = None

    def process_chain_data(self, samples):
        """≙ processChainData (:229)."""
        arr = np.asarray(samples)
        if arr.ndim == 3:
            arr = arr.reshape(-1, arr.shape[-1])
        n, p = arr.shape
        self.n_params, self.n_samples = p, n
        self.counts = np.empty((p, self.n_bins))
        self.edges = np.empty((p, self.n_bins + 1))
        self.cum = np.empty((p, self.n_bins))
        for i in range(p):
            lo, hi = padded_range(
                float(arr[:, i].min()), float(arr[:, i].max())
            )
            c, e = np.histogram(arr[:, i], bins=self.n_bins, range=(lo, hi))
            self.counts[i] = c
            self.edges[i] = e
            self.cum[i] = np.cumsum(c) / n
        return self

    def _require(self):
        if self.cum is None:
            raise RuntimeError("call process_chain_data first")

    def get_percentile_from_value(self, param, value):
        """P(X <= value)·100, linear interpolation within the containing bin
        (≙ :258-288)."""
        self._require()
        e = self.edges[param]
        if value <= e[0]:
            return 0.0
        if value >= e[-1]:
            return 100.0
        b = int(np.searchsorted(e, value, side="right")) - 1
        b = min(b, self.n_bins - 1)
        left_cum = self.cum[param][b - 1] if b > 0 else 0.0
        frac = (value - e[b]) / (e[b + 1] - e[b])
        inside = self.counts[param][b] / self.n_samples
        return 100.0 * (left_cum + frac * inside)

    def get_value_from_percentile(self, param, percentile):
        """Inverse CDF by bin search + interpolation (≙ :291-346)."""
        self._require()
        target = percentile / 100.0
        cum = self.cum[param]
        e = self.edges[param]
        b = int(np.searchsorted(cum, target, side="left"))
        b = min(b, self.n_bins - 1)
        left_cum = cum[b - 1] if b > 0 else 0.0
        inside = self.counts[param][b] / self.n_samples
        frac = 0.0 if inside == 0 else (target - left_cum) / inside
        frac = min(max(frac, 0.0), 1.0)
        return float(e[b] + frac * (e[b + 1] - e[b]))

    def get_peak_location(self, param):
        """Mode estimate = center of the fullest bin (≙ :349-367)."""
        self._require()
        b = int(np.argmax(self.counts[param]))
        e = self.edges[param]
        return float(0.5 * (e[b] + e[b + 1]))

    def save_csv(self, directory, prefix="pctl"):
        """≙ CSV writers at :370-421."""
        self._require()
        os.makedirs(directory, exist_ok=True)
        for i in range(self.n_params):
            centers = 0.5 * (self.edges[i][:-1] + self.edges[i][1:])
            np.savetxt(
                os.path.join(directory, f"{prefix}_p{i}.csv"),
                np.column_stack([centers, self.counts[i], self.cum[i]]),
                delimiter=",",
                header="bin_center,count,cumulative_fraction",
                comments="",
            )
        return directory
