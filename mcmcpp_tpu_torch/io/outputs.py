"""Output adapters: framework objects → named arrays for an engine.

Realizes the reference's empty ``IO/OutputBases/*.h`` placeholders
(SURVEY.md §2 #31). Each output has ``emit() -> iterable of (name, array,
meta)``; :class:`~mcmcpp_tpu_torch.io.writer.DataWriter` streams these into any
engine.
"""

import numpy as np


class Output:
    def emit(self):
        raise NotImplementedError


class ScalarOutput(Output):
    """A named scalar (≙ the planned OutputBases/Scalar.h)."""

    def __init__(self, name, value, meta=None):
        self.name, self.value, self.meta = name, value, meta

    def emit(self):
        yield self.name, np.asarray(self.value), self.meta


class MatrixOutput(Output):
    """A named 2-D array (covariance/correlation matrices etc.)."""

    def __init__(self, name, matrix, meta=None):
        self.name, self.matrix, self.meta = name, np.asarray(matrix), meta

    def emit(self):
        yield self.name, self.matrix, self.meta


class Hist1dOutput(Output):
    """counts + bin edges for one 1-D histogram."""

    def __init__(self, name, counts, edges, meta=None):
        self.name = name
        self.counts, self.edges = np.asarray(counts), np.asarray(edges)
        self.meta = meta

    def emit(self):
        yield f"{self.name}_counts", self.counts, self.meta
        yield f"{self.name}_edges", self.edges, self.meta


class Hist2dOutput(Output):
    """counts + both edge vectors for one 2-D histogram."""

    def __init__(self, name, counts, xedges, yedges, meta=None):
        self.name = name
        self.counts = np.asarray(counts)
        self.xedges, self.yedges = np.asarray(xedges), np.asarray(yedges)
        self.meta = meta

    def emit(self):
        yield f"{self.name}_counts", self.counts, self.meta
        yield f"{self.name}_xedges", self.xedges, self.meta
        yield f"{self.name}_yedges", self.yedges, self.meta


class HistMultiOutput(Output):
    """A whole CornerHistograms set (all 1-D + 2-D marginals)."""

    def __init__(self, name, corner_histograms, meta=None):
        self.name, self.ch, self.meta = name, corner_histograms, meta

    def emit(self):
        for i, (counts, edges) in enumerate(self.ch.hist1d):
            yield from Hist1dOutput(
                f"{self.name}_1d_p{i}", counts, edges, self.meta
            ).emit()
        for (i, j), (counts, xe, ye) in self.ch.hist2d.items():
            yield from Hist2dOutput(
                f"{self.name}_2d_p{i}_p{j}", counts, xe, ye, self.meta
            ).emit()


class ChainOutput(Output):
    """A sampler chain: positions (S, W, P) + log-probs (S, W)."""

    def __init__(self, name, chain, burn_in=0, thin=1, meta=None):
        self.name, self.chain = name, chain
        self.burn_in, self.thin, self.meta = burn_in, thin, meta

    def emit(self):
        meta = dict(self.meta or {})
        meta.update(burn_in=self.burn_in, thin=self.thin)
        yield (
            f"{self.name}_samples",
            self.chain.get(burn_in=self.burn_in, thin=self.thin),
            meta,
        )
        logp = self.chain.get_logp(burn_in=self.burn_in, thin=self.thin)
        if logp is not None:
            yield f"{self.name}_logp", logp, meta
