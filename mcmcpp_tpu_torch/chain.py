"""Host-side chain store for sampled ensembles.

Counterpart of ``mcmcpp_tpu/chain.py``, with both of its backends: numpy
blocks and the native C++ arena (``native/``, built with ``g++`` at first
use). The chain is write-once history, so it
lives in host memory, not on the card: stored steps stream host-ward in
chunks and land in a block list here. Byte-capped like the reference
(default 2 GiB, ``EnsembleSampler.h:67``); appends past capacity return False
(≙ ``IncrementStatus::EndOfChain``, ``MCMCpp/Chain/Chain.h:230-234``).

``get()`` returns (S, W, P) (≙ ChainStepIterator) and ``get(flat=True)``
(S·W, P) (≙ ChainPsetIterator); ``compact`` is the in-place burn+thin of
``resetChainForSubSampling`` (``Chain.h:269-305``).

Reduced-precision rows. numpy has ``float16`` but neither ``bfloat16`` nor an
8-bit float, and ``Tensor.numpy()`` refuses both. Rows of such a dtype are
held on the host as their raw bits (an ``int16`` or ``uint8`` array) beside
the torch dtype they stand for, a :class:`BitsDtype`; every cast goes through
torch. Its casts give the JAX package's bits (round to nearest even,
subnormals, infinities and NaN included) for bfloat16, float16,
``float8_e5m2`` and ``float8_e4m3fn``. e4m3fn has no infinity: beyond ±464,
the halfway point past its largest value 448, and at ±inf the JAX package
stores NaN. torch's own cast does so in 2.11 but saturates to ±448 in 2.13,
where a diverged walker would read back as a finite, plausible coordinate;
so every cast to e4m3fn (:func:`to_held`, and the sampler's chunk writes)
first maps |x| > 464 to NaN (:func:`e4m3_ready`), which gives JAX's bits
under either torch.
"""

import numpy as np
import torch

from mcmcpp_tpu_torch.utils.metrics import span

_BITS = {
    "bfloat16": (torch.bfloat16, torch.int16),
    "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8),
    "float8_e5m2": (torch.float8_e5m2, torch.uint8),
}


class BitsDtype:
    """A row dtype that numpy lacks: ``name`` ("bfloat16", "float8_e4m3fn",
    "float8_e5m2"), ``itemsize``, the torch dtype ``torch`` it stands for
    and the integer numpy dtype ``bits`` its rows are held as on the host.
    Equal to another of the same name, to the name and to the torch dtype."""

    def __init__(self, name):
        self.name = name
        self.torch, self._int = _BITS[name]
        self.bits = np.dtype(str(self._int).split(".")[1])
        self.itemsize = self.bits.itemsize

    def __eq__(self, other):
        if isinstance(other, BitsDtype):
            return self.name == other.name
        return other == self.name or other is self.torch

    def __hash__(self):
        return hash(self.name)

    def __repr__(self):
        return f"BitsDtype({self.name!r})"

    def __str__(self):
        return self.name


def row_dtype(dtype):
    """The dtype a chain holds rows at, from a numpy dtype, a torch dtype, a
    name or a :class:`BitsDtype`: ``np.dtype`` where numpy has the type, a
    :class:`BitsDtype` for bfloat16 and the 8-bit floats."""
    if isinstance(dtype, BitsDtype):
        return dtype
    if isinstance(dtype, torch.dtype):
        dtype = str(dtype).split(".")[1]
    if isinstance(dtype, str) and dtype in _BITS:
        return BitsDtype(dtype)
    return np.dtype(dtype)


def torch_dtype(dtype):
    """The torch dtype of a :func:`row_dtype`."""
    dtype = row_dtype(dtype)
    return dtype.torch if isinstance(dtype, BitsDtype) else getattr(
        torch, dtype.name)


#: |x| beyond this rounds past e4m3fn's largest value, 448: JAX stores NaN
E4M3_LIMIT = 464.0


def e4m3_ready(x, dtype):
    """``x`` ready for a cast to ``dtype``: for ``torch.float8_e4m3fn``,
    every |x| > 464 (±inf included) is NaN of x's sign, as the JAX package's
    cast gives it, whatever the installed torch's cast does there; any other
    dtype takes ``x`` as it is. A few elementwise ops, on the 8-bit tier
    only."""
    if dtype is not torch.float8_e4m3fn or x.dtype is dtype:
        return x
    # NaN with x's sign: JAX's bits are 0x7F above +464, 0xFF below -464
    return torch.where(x.abs() > E4M3_LIMIT,
                       torch.copysign(torch.full_like(x, torch.nan), x), x)


def to_held(x, dtype):
    """``x`` (a tensor on any device, or an array) cast to ``dtype`` and
    brought to the host in the form a chain holds: a numpy array of
    ``dtype``, or of its raw bits for a :class:`BitsDtype`. The cast runs on
    the device ``x`` lies on, so reduced rows cross to the host reduced."""
    dtype = row_dtype(dtype)
    if not isinstance(x, torch.Tensor):
        if not isinstance(dtype, BitsDtype):
            return np.asarray(x, dtype)
        x = torch.from_numpy(np.array(x))
    target = torch_dtype(dtype)
    x = e4m3_ready(x.detach(), target).to(target)
    if isinstance(dtype, BitsDtype):
        x = x.view(dtype._int)
    return x.cpu().numpy()


def from_held(held, dtype):
    """The tensor (on the CPU, at ``dtype``'s torch dtype) that a held
    array stands for: the inverse of :func:`to_held`."""
    dtype = row_dtype(dtype)
    t = torch.from_numpy(np.array(held, dtype.bits if isinstance(
        dtype, BitsDtype) else dtype))
    return t.view(dtype.torch) if isinstance(dtype, BitsDtype) else t


def cast_up(held, dtype, read_dtype):
    """A held array as a numpy array of ``read_dtype`` (None: as held,
    float32 for a :class:`BitsDtype`, which numpy cannot show)."""
    if isinstance(dtype, BitsDtype):
        read = np.dtype(np.float32 if read_dtype is None else read_dtype)
        return from_held(held, dtype).to(torch_dtype(read)).numpy()
    if read_dtype is not None and held.dtype != read_dtype:
        return held.astype(read_dtype)
    return held


def fetch_addressable(x, walker_axis=1):
    """The host copy (numpy) of a sampler's chunk or state (≙ the JAX
    package's ``chain.fetch_addressable``). A port tensor holds only its
    rank's rows: under a group of more than one rank a sharded sampler's
    chunk is already the rank's own walkers, in global order
    (``[red_local, black_local]``, ``parallel/sharded.py``), and nothing is
    gathered; alone it is the whole ensemble. ``walker_axis`` is kept for
    the JAX signature: no shard is reassembled here."""
    del walker_axis
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def append_device_chunk(chain, pos, logp):
    """Append (S, W_local, P)/(S, W_local) device chunks to ``chain``;
    returns ``(chain, ok)`` (ok False: the byte cap was hit, ≙
    IncrementStatus::EndOfChain). An empty :class:`Chain` of another walker
    width is rebuilt at the chunk's (local) width, as the JAX package
    rebuilds its chain on a multi-host run's first append; a width change
    after rows were stored raises."""
    width = pos.shape[1]
    if width != chain.n_walkers:
        if chain.n_steps or type(chain) is not Chain:
            raise RuntimeError(
                f"chain walker width {chain.n_walkers} != the chunk's "
                f"{width} (sharding changed mid-run, or an injected store "
                "of the wrong width)")
        chain = Chain(n_walkers=width, n_params=chain.n_params,
                      max_bytes=chain.max_bytes, dtype=chain.dtype,
                      backend=chain.backend, read_dtype=chain.read_dtype,
                      logp_dtype=chain.logp_dtype)
    return chain, chain.append(pos, logp)


def default_chunk_steps(n_rows, n_params, dtype, budget_bytes=64 << 20):
    """Steps per device->host chunk bounding a chunk to ~budget_bytes.

    One stored step costs n_rows·(n_params+1)·itemsize (positions + logp).
    """
    row = int(n_rows) * (int(n_params) + 1) * row_dtype(dtype).itemsize
    return max(1, int(budget_bytes) // max(row, 1))


def run_pipelined(n_store, chunk, launch, fetch, on_drop=None,
                  checkpoint_save=None, checkpoint_every=1):
    """Launch/fetch store loop of chunked sampling runs.

    ``launch(take) -> handle`` enqueues the next device chunk; ``fetch(handle)
    -> bool`` lands one chunk (False = byte cap hit). Chunk k is enqueued
    before chunk k−1 is fetched. ``on_drop(handle)`` runs on the launched
    but unstorable chunk when the cap hits (its transitions still advanced
    the sampler state). ``checkpoint_save()`` is called every
    ``checkpoint_every`` fetched chunks with the in-flight chunk fetched
    first, so a snapshot is consistent (state == chain == counters).
    Returns ok.
    """
    done, fetched, ok, pending = 0, 0, True, None
    ckpt_every = max(1, int(checkpoint_every))
    while done < n_store or pending is not None:
        if done < n_store:
            take = min(chunk, n_store - done)
            launched = launch(take)
            done += take
        else:
            launched = None
        if pending is not None:
            if not fetch(pending):
                ok = False
                if launched is not None and on_drop is not None:
                    on_drop(launched)
                break
            fetched += 1
            if checkpoint_save is not None and fetched % ckpt_every == 0:
                if launched is not None:  # drain the in-flight chunk
                    if not fetch(launched):
                        ok = False
                        break
                    fetched += 1
                    launched = None
                checkpoint_save()
        pending = launched
    return ok


class Chain:
    """Append-only (step, walker, param) store with byte capacity.

    Blocks are whatever chunk sizes the producer appends; :meth:`get` joins
    them into one array on demand and caches it until the chain changes.

    Rows are held at ``dtype`` and handed out cast up to ``read_dtype``
    (numpy's FFT and covariance paths take no reduced types); the logp plane
    may be held wider, at ``logp_dtype`` (the 8-bit tiers keep it at
    bfloat16 for its range). ``dtype`` and ``logp_dtype`` report
    :func:`row_dtype`: an ``np.dtype`` as in the JAX package where numpy has
    the type, and a :class:`BitsDtype` for bfloat16 and the 8-bit floats,
    where the JAX package reports an ``ml_dtypes`` ``np.dtype``; both have
    ``name`` and ``itemsize``. A :class:`BitsDtype` chain with no
    ``read_dtype`` reads as float32, where the JAX package hands out the
    reduced array itself.

    ``backend``: "numpy" (a list of numpy blocks), "native" (the C++ arena
    of ``native/``, built at first use; a missing ``g++`` or a failed build
    raises) or "auto" (the arena when its library is already built and
    loads, numpy otherwise: the JAX package's rule). The arena holds both
    planes at one item size, so a wider logp plane stays on numpy (and
    "native" refuses it). The arena stores bytes: the reduced tiers' raw
    bits are held there bit for bit as on numpy. The ``backend`` property
    reports what runs.
    """

    def __init__(self, n_walkers, n_params, max_bytes=2 << 30,
                 dtype=np.float32, backend="auto", read_dtype=None,
                 logp_dtype=None):
        self.n_walkers = int(n_walkers)
        self.n_params = int(n_params)
        self.max_bytes = int(max_bytes)
        self.dtype = row_dtype(dtype)
        self.read_dtype = None if read_dtype is None else np.dtype(read_dtype)
        self.logp_dtype = (self.dtype if logp_dtype is None
                           else row_dtype(logp_dtype))
        if backend not in ("auto", "native", "numpy"):
            raise ValueError(f"unknown chain backend {backend!r}")
        if self.logp_dtype != self.dtype and backend == "native":
            raise ValueError(
                "the native store holds both planes at one dtype; "
                "mixed sample/logp dtypes need backend='numpy'"
            )
        if backend == "auto" and self.logp_dtype != self.dtype:
            backend = "numpy"  # mixed-plane layout: numpy blocks only
        self._native = None
        if backend in ("auto", "native"):
            from mcmcpp_tpu_torch import native

            if backend == "native" or native.available():
                self._native = native.NativeChainStore(
                    self.n_walkers, self.n_params, self.max_bytes, self.dtype)
        self.clear()

    @property
    def backend(self):
        return "native" if self._native is not None else "numpy"

    def _row_bytes(self):
        return self.n_walkers * (
            self.n_params * self.dtype.itemsize + self.logp_dtype.itemsize
        )

    def append(self, positions, logps=None):
        """Append (S, W, P) positions (+ optional (S, W) logp), tensors on
        any device or arrays. Returns False (and appends nothing beyond
        capacity) once the byte cap is reached."""
        if positions.ndim != 3 or tuple(positions.shape[1:]) != (
            self.n_walkers, self.n_params,
        ):
            raise ValueError(
                f"expected (S, {self.n_walkers}, {self.n_params}), "
                f"got {tuple(positions.shape)}"
            )
        if logps is not None and (
                tuple(logps.shape) != tuple(positions.shape[:2])):
            raise ValueError("logps shape must be (S, W)")
        with span("mcmcpp.chain.append"):
            with span("mcmcpp.chain.fetch"):
                positions = to_held(positions, self.dtype)
                if logps is not None:
                    logps = to_held(logps, self.logp_dtype)
            if logps is None:
                logps = np.zeros(positions.shape[:2], getattr(
                    self.logp_dtype, "bits", self.logp_dtype))
            if self._native is not None:
                self._cache = None
                self._logp_cache = None
                return self._native.append(positions, logps)
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
        if self._native is not None:
            self._native.clear()
        self._blocks = []  # list of (S_i, W, P)
        self._logp_blocks = []  # list of (S_i, W)
        self._bytes = 0
        self._cache = None
        self._logp_cache = None

    @property
    def n_steps(self):
        if self._native is not None:
            return self._native.n_steps
        return sum(b.shape[0] for b in self._blocks)

    @property
    def nbytes(self):
        if self._native is not None:
            return self._native.nbytes
        return self._bytes

    def _materialize(self):
        if self._cache is None and self._native is not None:
            self._cache, self._logp_cache = self._native.read()
        if self._cache is None:
            self._cache = (
                np.concatenate(self._blocks, axis=0) if self._blocks
                else np.zeros((0, self.n_walkers, self.n_params),
                              getattr(self.dtype, "bits", self.dtype))
            )
        return self._cache

    def _materialize_logp(self):
        if self._logp_cache is None and self._native is not None:
            self._cache, self._logp_cache = self._native.read()
        if self._logp_cache is None:
            self._logp_cache = (
                np.concatenate(self._logp_blocks, axis=0) if self._logp_blocks
                else np.zeros((0, self.n_walkers),
                              getattr(self.logp_dtype, "bits",
                                      self.logp_dtype))
            )
        return self._logp_cache

    def get(self, burn_in=0, thin=1, flat=False, held=False):
        """Samples as (S, W, P), cast up to ``read_dtype``; ``flat``
        flattens steps×walkers to rows (pset-iterator order: step-major,
        walker-minor). ``held=True`` gives the rows as they are held (the
        raw bits of a :class:`BitsDtype`; :func:`from_held` reads them)."""
        arr = self._materialize()[burn_in::thin]
        if not held:
            arr = cast_up(arr, self.dtype, self.read_dtype)
        return arr.reshape(-1, self.n_params) if flat else arr

    def get_logp(self, burn_in=0, thin=1, flat=False, held=False):
        arr = self._materialize_logp()[burn_in::thin]
        if not held:
            arr = cast_up(arr, self.logp_dtype, self.read_dtype)
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
        if self._native is not None:
            self._native.compact(burn_in, thin)
            self._cache = None
            self._logp_cache = None
            return
        kept = self._materialize()[burn_in::thin].copy()
        kept_logp = self._materialize_logp()[burn_in::thin].copy()
        self.clear()
        if kept.shape[0]:
            self._blocks = [kept]
            self._logp_blocks = [kept_logp]
            self._bytes = kept.shape[0] * self._row_bytes()
            self._cache = kept
            self._logp_cache = kept_logp
