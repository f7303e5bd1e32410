"""Host-side chain store for sampled ensembles.

Counterpart of ``mcmcpp_tpu/chain.py`` with its NumPy backend only (the
native C++ arena is not ported yet). The chain is write-once history, so it
lives in host memory, not on the card: stored steps stream host-ward in
chunks and land in a block list here. Byte-capped like the reference
(default 2 GiB, ``EnsembleSampler.h:67``); appends past capacity return False
(≙ ``IncrementStatus::EndOfChain``, ``MCMCpp/Chain/Chain.h:230-234``).

``get()`` returns (S, W, P) (≙ ChainStepIterator) and ``get(flat=True)``
(S·W, P) (≙ ChainPsetIterator); ``compact`` is the in-place burn+thin of
``resetChainForSubSampling`` (``Chain.h:269-305``).
"""

import numpy as np


def append_device_chunk(chain, pos, logp):
    """Copy (S, W, P)/(S, W) device chunks to the host and append them.

    Returns False when the byte cap was hit (EndOfChain).
    """
    return chain.append(pos.cpu().numpy(), logp.cpu().numpy())


def default_chunk_steps(n_rows, n_params, dtype, budget_bytes=64 << 20):
    """Steps per device->host chunk bounding a chunk to ~budget_bytes.

    One stored step costs n_rows·(n_params+1)·itemsize (positions + logp).
    """
    row = int(n_rows) * (int(n_params) + 1) * np.dtype(dtype).itemsize
    return max(1, int(budget_bytes) // max(row, 1))


def run_pipelined(n_store, chunk, launch, fetch, on_drop=None):
    """Launch/fetch store loop of chunked sampling runs.

    ``launch(take) -> handle`` enqueues the next device chunk; ``fetch(handle)
    -> bool`` lands one chunk (False = byte cap hit). Chunk k is enqueued
    before chunk k−1 is fetched. ``on_drop(handle)`` runs on the launched
    but unstorable chunk when the cap hits (its transitions still advanced
    the sampler state). Returns ok.
    """
    done, ok, pending = 0, True, None
    while done < n_store or pending is not None:
        if done < n_store:
            take = min(chunk, n_store - done)
            launched = launch(take)
            done += take
        else:
            launched = None
        if pending is not None and not fetch(pending):
            ok = False
            if launched is not None and on_drop is not None:
                on_drop(launched)
            break
        pending = launched
    return ok


class Chain:
    """Append-only (step, walker, param) store with byte capacity.

    Blocks are whatever chunk sizes the producer appends; :meth:`get` joins
    them into one array on demand and caches it until the chain changes.
    """

    def __init__(self, n_walkers, n_params, max_bytes=2 << 30,
                 dtype=np.float32):
        self.n_walkers = int(n_walkers)
        self.n_params = int(n_params)
        self.max_bytes = int(max_bytes)
        self.dtype = np.dtype(dtype)
        self.clear()

    def _row_bytes(self):
        return self.n_walkers * (self.n_params + 1) * self.dtype.itemsize

    def append(self, positions, logps=None):
        """Append (S, W, P) positions (+ optional (S, W) logp). Returns False
        (and appends nothing beyond capacity) once the byte cap is reached."""
        positions = np.asarray(positions, self.dtype)
        if positions.ndim != 3 or positions.shape[1:] != (
            self.n_walkers, self.n_params,
        ):
            raise ValueError(
                f"expected (S, {self.n_walkers}, {self.n_params}), "
                f"got {positions.shape}"
            )
        if logps is None:
            logps = np.zeros(positions.shape[:2], self.dtype)
        else:
            logps = np.asarray(logps, self.dtype)
            if logps.shape != positions.shape[:2]:
                raise ValueError("logps shape must be (S, W)")
        room = (self.max_bytes - self._bytes) // self._row_bytes()
        take = min(positions.shape[0], max(room, 0))
        if take > 0:
            self._blocks.append(positions[:take])
            self._logp_blocks.append(logps[:take])
            self._bytes += take * self._row_bytes()
            self._cache = None
            self._logp_cache = None
        return take == positions.shape[0]

    def clear(self):
        """Drop all stored steps (≙ Chain reset via sampler.reset)."""
        self._blocks = []  # list of (S_i, W, P)
        self._logp_blocks = []  # list of (S_i, W)
        self._bytes = 0
        self._cache = None
        self._logp_cache = None

    @property
    def n_steps(self):
        return sum(b.shape[0] for b in self._blocks)

    @property
    def nbytes(self):
        return self._bytes

    def _materialize(self):
        if self._cache is None:
            self._cache = (
                np.concatenate(self._blocks, axis=0) if self._blocks
                else np.zeros((0, self.n_walkers, self.n_params), self.dtype)
            )
        return self._cache

    def _materialize_logp(self):
        if self._logp_cache is None:
            self._logp_cache = (
                np.concatenate(self._logp_blocks, axis=0) if self._logp_blocks
                else np.zeros((0, self.n_walkers), self.dtype)
            )
        return self._logp_cache

    def get(self, burn_in=0, thin=1, flat=False):
        """Samples as (S, W, P); ``flat`` flattens steps×walkers to rows
        (pset-iterator order: step-major, walker-minor)."""
        arr = self._materialize()[burn_in::thin]
        return arr.reshape(-1, self.n_params) if flat else arr

    def get_logp(self, burn_in=0, thin=1, flat=False):
        arr = self._materialize_logp()[burn_in::thin]
        return arr.reshape(-1) if flat else arr

    def iter_steps(self, burn_in=0, thin=1):
        """Yield one (W, P) array per stored step (≙ ChainStepIterator)."""
        yield from self.get(burn_in=burn_in, thin=thin)

    def iter_psets(self, burn_in=0, thin=1):
        """Yield one (P,) parameter set per walker per step, step-major
        (≙ ChainPsetIterator)."""
        yield from self.get(burn_in=burn_in, thin=thin, flat=True)

    def compact(self, burn_in=0, thin=1):
        """In-place burn+thin (≙ resetChainForSubSampling, Chain.h:269-305).

        Negative ``burn_in`` keeps the last ``|burn_in|`` steps.
        """
        thin = int(thin)
        if thin < 1:
            raise ValueError("thin must be >= 1")
        burn_in = int(burn_in)
        if burn_in < 0:
            burn_in = max(0, self.n_steps + burn_in)
        kept = self._materialize()[burn_in::thin].copy()
        kept_logp = self._materialize_logp()[burn_in::thin].copy()
        self.clear()
        if kept.shape[0]:
            self._blocks = [kept]
            self._logp_blocks = [kept_logp]
            self._bytes = kept.shape[0] * self._row_bytes()
            self._cache = kept
            self._logp_cache = kept_logp
