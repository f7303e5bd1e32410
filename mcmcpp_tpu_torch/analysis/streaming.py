"""Streaming (step-chunked) integrated autocorrelation time.

The FFT path in ``autocorr.py`` needs the whole (S, W, P) chain in memory
at once. For chains longer than one FFT window — or to estimate ACT
ONLINE while sampling, in O(max_lag) memory per series — this module
accumulates the lagged pair-sums chunk-by-chunk and reconstructs exactly
the same per-walker centered, lag-0-normalized, walker-averaged
autocovariance the batch path computes (truncated at ``max_lag``), then
applies the same windowed Sokal sum (``MCMCpp/Analysis/AutoCorrCalc.h:
185-206`` semantics: window at ``t >= c*tau(t)``, negative result when
the window never closes).

Identity used (per series, with per-series mean mu over all n steps):

    c(k) = sum_t (x_t - mu)(x_{t+k} - mu)
         = R_k - mu*(Shead_k + Stail_k) + (n - k)*mu^2

where ``R_k = sum_t x_t x_{t+k}`` accumulates streamingly (per chunk, two
truncated raw autocovariance FFTs: pairs inside [tail ++ chunk] minus
pairs inside tail), and ``Shead_k / Stail_k`` come from the total sum and
the stored first/last ``max_lag`` steps. Samples are shifted by the first
chunk's mean before accumulation so the raw products don't cancel
catastrophically (c(k) is shift-invariant).

Usage while sampling (O(1) memory in chain length):

    act = StreamingACT(max_lag=512)
    sampler.run_mcmc(n, chunk_action=act.consume_chain)
    tau = act.autocorr_time()
"""

import numpy as np


class StreamingACT:
    """Online per-parameter ACT over (steps, walkers, params) chunks."""

    def __init__(self, max_lag, window_scaling=4.0):
        self.max_lag = int(max_lag)
        if self.max_lag < 1:
            raise ValueError("max_lag must be >= 1")
        self.window_scaling = float(window_scaling)
        self._L = self.max_lag + 1
        self._n = 0
        self._consumed = 0  # consume_chain watermark
        # allocated on first chunk (shapes depend on W, P)
        self._shift = None  # (W, P) first-chunk mean, removed pre-accum
        self._R = None  # (L, W, P) raw lagged pair-sums
        self._S = None  # (W, P) total sum (shifted)
        self._head = None  # (<=L-1, W, P) first steps (shifted)
        self._tail = None  # (<=L-1, W, P) last steps (shifted)

    @staticmethod
    def _raw_acov(y, n_lags):
        """sum_t y_t y_{t+k} for k < n_lags over all pairs inside y.

        y: (T, W, P) float64. FFT-based; zero-padded past T + n_lags so
        the truncated lags are linear, not circular.
        """
        t = y.shape[0]
        if t == 0:
            return 0.0
        npad = 1 << int(t + n_lags - 1).bit_length()
        f = np.fft.rfft(y, n=npad, axis=0)
        acov = np.fft.irfft(f * np.conj(f), n=npad, axis=0)
        return acov[: min(n_lags, t)]

    def update(self, chunk):
        """Fold a (C, W, P) or (C, W) block of consecutive steps in."""
        x = np.asarray(chunk, np.float64)
        if x.ndim == 2:
            x = x[:, :, None]
        if x.ndim != 3:
            raise ValueError("chunk must be (C, W[, P])")
        if x.shape[0] == 0:
            return self
        if self._R is None:
            w, p = x.shape[1], x.shape[2]
            self._shift = x.mean(axis=0)
            self._R = np.zeros((self._L, w, p))
            self._S = np.zeros((w, p))
            self._head = np.empty((0, w, p))
            self._tail = np.empty((0, w, p))
        elif x.shape[1:] != self._S.shape:
            raise ValueError(
                f"chunk walkers/params {x.shape[1:]} != {self._S.shape}"
            )
        x = x - self._shift[None]
        y = np.concatenate([self._tail, x], axis=0)
        # pairs (t, t+k) with t+k inside the NEW region = pairs in y minus
        # pairs entirely inside the previous tail
        self._R[: min(self._L, y.shape[0])] += self._raw_acov(y, self._L)
        if self._tail.shape[0]:
            self._R[: min(self._L, self._tail.shape[0])] -= self._raw_acov(
                self._tail, self._L
            )
        self._S += x.sum(axis=0)
        self._n += x.shape[0]
        if self._head.shape[0] < self._L - 1:
            need = self._L - 1 - self._head.shape[0]
            self._head = np.concatenate([self._head, x[:need]], axis=0)
        self._tail = y[-(self._L - 1):] if self._L > 1 else y[:0]
        return self

    def consume_chain(self, chain):
        """``chunk_action``-compatible: fold in only the chain rows appended
        since the last call (``run_mcmc(chunk_action=act.consume_chain)``).

        Reads via ``get(burn_in=consumed)`` so only the NEW rows
        materialize — with a DiskChain spool this stays O(new rows), not
        O(history), per call.
        """
        n = chain.n_steps
        if n > self._consumed:
            self.update(chain.get(burn_in=self._consumed))
            self._consumed = n
        return self

    def normalized_autocov(self):
        """Walker-averaged ρ(k), shape (P, n_lags) with ρ(:, 0) = 1."""
        if self._R is None or self._n < 2:
            raise RuntimeError("need at least 2 steps")
        n = self._n
        lags = min(self._L, n)
        mu = self._S / n  # per-series mean (shifted space)
        k = np.arange(lags)
        head_cum = np.concatenate(
            [np.zeros((1,) + self._S.shape), np.cumsum(self._head, axis=0)]
        )[:lags]
        tail_cum = np.concatenate(
            [np.zeros((1,) + self._S.shape), np.cumsum(self._tail[::-1], axis=0)]
        )[:lags]
        s_head = self._S[None] - tail_cum  # sum of x_0 .. x_{n-1-k}
        s_tail = self._S[None] - head_cum  # sum of x_k .. x_{n-1}
        shape = (-1,) + (1,) * self._S.ndim
        c = (
            self._R[:lags]
            - mu[None] * (s_head + s_tail)
            + (n - k).reshape(shape) * mu[None] ** 2
        )
        rho = c / c[:1]
        # average over walkers -> (P, lags)
        return np.moveaxis(rho.mean(axis=1), 0, -1)

    def autocorr_time(self):
        """Per-parameter τ, same semantics as ``autocorr_time`` (negative =
        window never closed within ``min(max_lag, n-1)`` lags)."""
        from mcmcpp_tpu_torch.analysis.autocorr import _sokal_window_tau

        rho = self.normalized_autocov()
        return np.array(
            [_sokal_window_tau(rho[i], self.window_scaling)
             for i in range(rho.shape[0])]
        )


def autocorr_time_streaming(chunks, max_lag, window_scaling=4.0):
    """One-shot helper: ACT from an iterable of (C, W[, P]) step chunks."""
    acc = StreamingACT(max_lag, window_scaling)
    for chunk in chunks:
        acc.update(chunk)
    return acc.autocorr_time()
