"""Ensemble sampler: red/black half-ensemble stepping on one device.

PyTorch counterpart of ``mcmcpp_tpu/sampler.py`` (the reference's
``MCMCpp/EnsembleSampler.h``):

- The ensemble is two device tensors ``(W/2, P)`` (red/black halves) plus
  log-posterior vectors and int32 per-walker accept counters.
- One step updates red against black, then black against the *new* red
  (``EnsembleSampler.h:342-359``).
- ``lax.scan`` becomes a Python loop that enqueues the steps on the card and
  writes every ``thin``-th ensemble, ``[red…, black…]``, into a preallocated
  device chunk; chunks are copied to the host :class:`Chain`. Nothing in the
  step loop waits on the device.
- Randomness comes from two ``torch.Generator``s on the device, one for the
  steps and one for auxiliary draws (``init_ball``), and one on the CPU for
  the draws that pick host-side control flow (the mixture mover's branch),
  all seeded from ``seed``.
- ``step_action(pos, logp)`` runs on the device once per stored step and its
  outputs are stacked per chunk (≙ the reference's PostStepAction,
  ``EnsembleSampler.h:356-359``); ``chunk_action(chain)`` runs on the host
  after each chunk lands.
"""

from typing import NamedTuple

import numpy as np
import torch

from mcmcpp_tpu_torch.chain import (
    Chain,
    append_device_chunk,
    default_chunk_steps,
    e4m3_ready,
    row_dtype,
    run_pipelined,
    torch_dtype,
)
from mcmcpp_tpu_torch.movers.base import Mover
from mcmcpp_tpu_torch.movers.stretch import StretchMove
from mcmcpp_tpu_torch.ops.random import (
    AUX_STREAM,
    HOST_STREAM,
    STEP_STREAM,
    make_generator,
)
from mcmcpp_tpu_torch.utils.metrics import span

# per-walker accept counters are int32 on the device and gain at most one
# per step, so a device run between two harvests stays below 2^30 steps
_MAX_STEPS_PER_HARVEST = 1 << 30


class EnsembleState(NamedTuple):
    """``red``/``black``: (W/2, P); ``logp_*``: (W/2,); ``accepted_*``:
    (W/2,) int32 per-walker accept counters (≙ ``MCMCpp/Walker/Walker.h:
    111-122``), harvested to a host int64 array per chunk; ``step``: steps
    taken, a host int (no key is folded from it)."""

    red: torch.Tensor
    black: torch.Tensor
    logp_red: torch.Tensor
    logp_black: torch.Tensor
    accepted_red: torch.Tensor
    accepted_black: torch.Tensor
    step: int


def resolve_device(device):
    """``torch.device`` for ``device``; raises if CUDA is asked for and
    absent (the port never falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions on the CPU"
        )
    return device


def init_state(positions, batched_logp):
    """:class:`EnsembleState` from initial positions (W, P): the first W/2
    walkers are red, the rest black (≙ ``setInitialWalkerPos``,
    ``EnsembleSampler.h:221-243``)."""
    w = positions.shape[0]
    if w % 2 != 0:
        raise ValueError("number of walkers must be even (red/black halves)")
    half = w // 2
    red, black = positions[:half].contiguous(), positions[half:].contiguous()
    zeros = torch.zeros((half,), dtype=torch.int32, device=positions.device)
    return EnsembleState(
        red=red,
        black=black,
        logp_red=batched_logp(red),
        logp_black=batched_logp(black),
        accepted_red=zeros,
        accepted_black=zeros.clone(),
        step=0,
    )


def make_step_fn(batched_logp, mover: Mover, mover_state, gen,
                 host_gen=None):
    """Return ``step(state) -> state`` performing one full red+black update.

    ``gen`` draws on the ensemble's device; ``host_gen`` is the CPU
    generator handed to ``draw_noise`` for host-side choices.
    """

    def step(state: EnsembleState) -> EnsembleState:
        (n_r, p), n_b = state.red.shape, state.black.shape[0]
        device, dtype = state.red.device, state.red.dtype
        noise = mover.draw_noise(gen, n_r, n_b, p, device, dtype=dtype,
                                 host_gen=host_gen)
        red, logp_red, acc_r = mover.apply(
            state.red, state.logp_red, state.black, batched_logp, mover_state,
            noise,
        )
        # black proposes against the *updated* red half (EnsembleSampler.h:350-354)
        noise = mover.draw_noise(gen, n_b, n_r, p, device, dtype=dtype,
                                 host_gen=host_gen)
        black, logp_black, acc_b = mover.apply(
            state.black, state.logp_black, red, batched_logp, mover_state,
            noise,
        )
        return EnsembleState(
            red, black, logp_red, logp_black,
            state.accepted_red + acc_r.to(torch.int32),
            state.accepted_black + acc_b.to(torch.int32),
            state.step + 1,
        )

    return step


def _tree_map(fn, tree):
    """``fn`` over the tensors of a tensor, or a tuple, list or dict of
    them (nested)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_stack(trees, stack):
    """Stack a list of equally shaped trees leaf by leaf with ``stack``."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_stack([t[k] for t in trees], stack) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_tree_stack([t[i] for t in trees], stack)
                           for i in range(len(first)))
    return stack(trees)


def run_scan(state: EnsembleState, step_fn, n_store: int, thin: int,
             step_action=None, store_dtype=None):
    """Run ``n_store·thin`` steps, keeping every ``thin``-th ensemble.

    Returns (final_state, positions (n_store, W, P), logps (n_store, W),
    metrics, accepted): ``accepted`` is the chunk's per-walker accept
    counters, which are zeroed in the returned state. Thinning at source (≙
    ``EnsembleSampler.h:296-308``): skipped steps are never stored.

    ``step_action(positions (W, P), logps (W,))`` runs on the device after
    every stored step; ``metrics`` stacks its outputs (a tensor, or a tuple
    or dict of them) along a new leading axis, or is None without one.

    ``store_dtype`` (for example ``torch.bfloat16``) is the dtype of the
    emitted chunk: it is allocated at that dtype and the row copies convert,
    so the steps stay full precision and no full-precision chunk is held
    (``step_action`` still sees full precision). An 8-bit tier keeps the
    logp plane at bfloat16: e4m3's ±448 range overflows on routine |logp|,
    and the plane is 1/(P+1) of the payload. Rows cast to e4m3fn take
    JAX's NaN beyond ±464 (:func:`~mcmcpp_tpu_torch.chain.e4m3_ready`).
    """
    half = state.red.shape[0]
    w = half + state.black.shape[0]
    p = state.red.shape[1]
    dev = state.red.device
    if store_dtype is None:
        pos_dtype, logp_dtype = state.red.dtype, state.logp_red.dtype
    else:
        pos_dtype = store_dtype
        logp_dtype = (torch.bfloat16 if store_dtype.itemsize < 2
                      else store_dtype)
    positions = torch.empty((n_store, w, p), dtype=pos_dtype, device=dev)
    logps = torch.empty((n_store, w), dtype=logp_dtype, device=dev)
    metrics = []
    for s in range(n_store):
        for _ in range(thin):
            state = step_fn(state)
        positions[s, :half] = e4m3_ready(state.red, pos_dtype)
        positions[s, half:] = e4m3_ready(state.black, pos_dtype)
        logps[s, :half] = state.logp_red
        logps[s, half:] = state.logp_black
        if step_action is None:
            continue
        if store_dtype is None:
            metrics.append(step_action(positions[s], logps[s]))
        else:
            metrics.append(step_action(
                torch.cat([state.red, state.black]),
                torch.cat([state.logp_red, state.logp_black])))
    accepted = (state.accepted_red, state.accepted_black)
    state = state._replace(
        accepted_red=torch.zeros_like(state.accepted_red),
        accepted_black=torch.zeros_like(state.accepted_black),
    )
    stacked = _tree_stack(metrics, torch.stack) if metrics else None
    return state, positions, logps, stacked, accepted


def run_nostore(state: EnsembleState, step_fn, n_steps: int):
    """Advance ``n_steps`` without storing (burn-in path)."""
    for _ in range(n_steps):
        state = step_fn(state)
    return state


def sample_ball(gen, center, scale, n_walkers, dtype=torch.float32,
                device="cuda"):
    """Gaussian ball initializer for walker positions (emcee-style):
    center + scale·z, computed in place in z's buffer (the same two roundings
    as out of place), so that a (W, P) ensemble needs no more than its own
    memory on the device."""
    center = torch.as_tensor(center, dtype=dtype, device=device)
    scale = torch.broadcast_to(
        torch.as_tensor(scale, dtype=dtype, device=device), center.shape
    )
    z = torch.randn((n_walkers, center.shape[0]), generator=gen, dtype=dtype,
                    device=device)
    return z.mul_(scale[None, :]).add_(center[None, :])


class EnsembleSampler:
    """User-facing sampler (public surface ≙ ``EnsembleSampler.h:89-176``).

    Parameters
    ----------
    logp_fn : callable(theta (P,)) -> scalar log-posterior, or, with
        ``batched=True``, (n, P) -> (n,) (for example a
        :class:`~mcmcpp_tpu_torch.models.targets.GaussianTarget`, which
        :class:`~mcmcpp_tpu_torch.movers.fused.FusedStretchMove` needs).
    n_walkers, n_params : ensemble dimensions (W even, at least 4).
    mover : a :class:`~mcmcpp_tpu_torch.movers.base.Mover` (default
        StretchMove).
    seed : seeds the step and auxiliary generators.
    max_chain_bytes : host chain capacity (default 2 GiB, ≙
        ``EnsembleSampler.h:67``).
    batched : True if ``logp_fn`` already maps (n, P) -> (n,); otherwise it
        is wrapped with ``torch.func.vmap``.
    store_chunk_steps : stored steps per device chunk (default: ~64 MiB).
    device : where the ensemble lives (default "cuda"). CUDA without a GPU
        raises.
    chain : an injected store in place of the in-memory :class:`Chain` (for
        example :class:`~mcmcpp_tpu_torch.chain_disk.DiskChain`); it must
        match the ensemble's geometry.
    store_dtype : optional reduced dtype of the STORED rows only (for
        example ``torch.bfloat16``): the steps stay ``dtype``, chunks are
        written at ``store_dtype`` on the device and cross to the host so.
        ``get_samples``/``get_log_probs`` cast back up to float32.
    """

    def __init__(
        self,
        logp_fn,
        n_walkers,
        n_params,
        mover=None,
        seed=0,
        dtype=torch.float32,
        max_chain_bytes=2 << 30,
        batched=False,
        store_chunk_steps=None,
        device="cuda",
        chain=None,
        store_dtype=None,
    ):
        if n_walkers % 2 != 0:
            raise ValueError("n_walkers must be even")
        if n_walkers < 4:
            raise ValueError("need at least 4 walkers")
        self.device = resolve_device(device)
        self.n_walkers = int(n_walkers)
        self.n_params = int(n_params)
        self.dtype = dtype
        self.mover = mover if mover is not None else StretchMove()
        self._batched_logp = logp_fn if batched else torch.func.vmap(logp_fn)
        self._validate_logp()
        self._mover_state = self.mover.init_state(
            self.n_params, dtype, self.device
        )
        # domain-separated streams: steps draw from _step_gen, init_ball
        # from _aux_gen, so no auxiliary draw shifts the step stream;
        # _host_gen (CPU) draws the host-side choices of a step
        self._step_gen = make_generator(seed, STEP_STREAM, self.device)
        self._aux_gen = make_generator(seed, AUX_STREAM, self.device)
        self._host_gen = make_generator(seed, HOST_STREAM, "cpu")
        self._store_dtype = (None if store_dtype is None
                             else torch_dtype(store_dtype))
        # the walkers this process stores: all of them here, a rank's own
        # under ShardedEnsembleSampler
        stored_walkers = self._local_walkers()
        if chain is not None:
            if (chain.n_walkers, chain.n_params) != (
                stored_walkers, self.n_params,
            ):
                raise ValueError(
                    f"chain store geometry ({chain.n_walkers}, "
                    f"{chain.n_params}) != ({stored_walkers}, "
                    f"{self.n_params})"
                )
            chain_logp_dtype = getattr(chain, "logp_dtype", chain.dtype)
            if (
                self._store_dtype is not None
                and self._store_dtype.itemsize < 2
                and chain_logp_dtype.itemsize < 2
            ):
                # run_scan emits the logp plane as bf16 under 8-bit sample
                # tiers (e4m3 range); an injected store that would squash
                # it back to 8 bits loses every |logp| > 448
                raise ValueError(
                    "an 8-bit store_dtype needs an injected chain whose "
                    "logp plane is at least 16-bit (e.g. Chain(..., "
                    "dtype=torch.float8_e4m3fn, logp_dtype=torch.bfloat16)); "
                    f"this chain holds logp at {chain_logp_dtype}"
                )
            self.chain = chain
        else:
            held = row_dtype(dtype if store_dtype is None else store_dtype)
            self.chain = Chain(
                n_walkers=stored_walkers,
                n_params=self.n_params,
                max_bytes=max_chain_bytes,
                dtype=held,
                # reduced rows are cast up on read: numpy's FFT and
                # covariance paths take no reduced types
                read_dtype=(np.float32 if held.itemsize < 4 else None),
                # 8-bit tiers keep the logp plane at bf16 (run_scan's rule)
                logp_dtype=("bfloat16" if held.itemsize < 2 else None),
            )
        self.state = None
        # host-side PER-WALKER int64 accept counts in chain column order
        # [red..., black...]; the int32 device counters are folded in after
        # every device run
        self._accepted_walkers_host = None
        self._reset_step_base = 0
        self._default_thin = 1
        # steps per device run between two counter harvests (int32-safe)
        self._max_steps_per_harvest = _MAX_STEPS_PER_HARVEST
        #: ``step_action`` outputs of the last ``run_mcmc``, as numpy
        self.step_metrics = None
        self._step_fn = make_step_fn(
            self._batched_logp, self.mover, self._mover_state, self._step_gen,
            self._host_gen,
        )
        if store_chunk_steps is None:
            # sized at the STORED row dtype: a reduced store fits more steps
            store_chunk_steps = default_chunk_steps(
                stored_walkers, self.n_params, self.chain.dtype
            )
        self._chunk = int(store_chunk_steps)

    # -- setup -----------------------------------------------------------

    def _local_walkers(self):
        """Walkers this process holds and stores (all of them)."""
        return self.n_walkers

    def _validate_logp(self):
        """Shape-check the user's logp on a zero batch (replaces SFINAE)."""
        half = self.n_walkers // 2
        x = torch.zeros((half, self.n_params), dtype=self.dtype,
                        device=self.device)
        try:
            out = self._batched_logp(x)
        except Exception as e:  # noqa: BLE001 - user code; re-raise with context
            raise TypeError(
                "logp_fn failed on a (n, P) batch; it must map a (P,) "
                "parameter vector to a scalar log-posterior (or set "
                "batched=True for a (n, P)->(n,) function)"
            ) from e
        if tuple(out.shape) != (half,):
            raise TypeError(
                f"batched logp returned shape {tuple(out.shape)}, expected "
                f"({half},); logp_fn must return a scalar"
            )

    def set_initial_walker_pos(self, positions):
        """≙ setInitialWalkerPos (EnsembleSampler.h:221). (W, P) array."""
        positions = torch.as_tensor(positions, dtype=self.dtype,
                                    device=self.device)
        if tuple(positions.shape) != (self.n_walkers, self.n_params):
            raise ValueError(
                f"positions shape {tuple(positions.shape)} != "
                f"({self.n_walkers}, {self.n_params})"
            )
        self.state = init_state(positions, self._batched_logp)
        return self

    def init_ball(self, center, scale=1e-2, seed=None):
        """Initialize walkers in a Gaussian ball around ``center``; draws
        from the auxiliary generator, or from one seeded by ``seed``."""
        gen = (self._aux_gen if seed is None
               else make_generator(seed, AUX_STREAM, self.device))
        pos = sample_ball(gen, center, scale, self.n_walkers, self.dtype,
                          self.device)
        return self.set_initial_walker_pos(pos)

    # -- running ---------------------------------------------------------

    def _require_state(self):
        if self.state is None:
            raise RuntimeError(
                "walkers not initialized; call set_initial_walker_pos/init_ball"
            )

    def _accum_accept(self, acc_red, acc_black):
        """Fold per-walker device accept counters into the host int64
        vector (one device->host copy)."""
        with span("mcmcpp.harvest"):
            self._fold_accept(acc_red, acc_black)

    def _fold_accept(self, acc_red, acc_black):
        """:meth:`_accum_accept`'s work, inside the caller's harvest span."""
        with span("mcmcpp.harvest.fetch"):
            counts = torch.cat([acc_red, acc_black]).cpu()
        with span("mcmcpp.harvest.fold"):
            vec = counts.numpy().astype(np.int64)
            if self._accepted_walkers_host is None:
                self._accepted_walkers_host = vec
            else:
                self._accepted_walkers_host += vec

    def _harvest_counters(self):
        """Move device accept counters into the host accumulator."""
        with span("mcmcpp.harvest"):
            self._fold_accept(self.state.accepted_red,
                              self.state.accepted_black)
            self.state = self.state._replace(
                accepted_red=torch.zeros_like(self.state.accepted_red),
                accepted_black=torch.zeros_like(self.state.accepted_black),
            )

    def _current_ensemble(self):
        pos = torch.cat([self.state.red, self.state.black])
        logp = torch.cat([self.state.logp_red, self.state.logp_black])
        return pos, logp

    def store_current_walker_positions(self):
        """≙ storeCurrentWalkerPositions (EnsembleSampler.h:249): push the
        current ensemble into the chain as one stored step."""
        self._require_state()
        pos, logp = self._current_ensemble()
        self.chain, ok = append_device_chunk(self.chain, pos[None], logp[None])
        return ok

    def set_sampling_mode(self, thin):
        """Default thinning interval of later ``run_mcmc`` calls that pass
        no ``thin``."""
        self._default_thin = int(thin)
        return self

    def set_slicing_mode(self, use_slicing=False, slicing_interval=1):
        """≙ setSlicingMode (EnsembleSampler.h:137,325-329): toggle
        sub-sampling and set its interval in one call."""
        self._default_thin = int(slicing_interval) if use_slicing else 1
        return self

    def _run_nostore(self, n_steps):
        """Advance ``n_steps`` without storing, harvesting the counters at
        least every ``_max_steps_per_harvest`` steps."""
        remaining = int(n_steps)
        while remaining > 0:
            take = min(remaining, self._max_steps_per_harvest)
            with span("mcmcpp.steps"):
                self.state = run_nostore(self.state, self._step_fn, take)
            self._harvest_counters()
            remaining -= take

    def run_mcmc(self, n_steps, thin=None, store=True, step_action=None,
                 chunk_action=None, checkpoint_path=None, checkpoint_every=1):
        """Run ``n_steps`` total steps; if ``store``, save every ``thin``-th
        (``thin=None`` takes the default of :meth:`set_sampling_mode`).

        Returns False if the chain hit its byte capacity before finishing
        (≙ IncrementStatus::EndOfChain, Chain/Chain.h:230-234), else True.

        ``step_action(positions (W, P), logps (W,))`` runs on the device
        once per stored step; its outputs (a tensor, or a tuple or dict of
        tensors) are stacked over the stored steps into ``self.step_metrics``
        as numpy. ``chunk_action(chain)`` runs on the host after each chunk
        of stored steps lands in the chain.

        ``checkpoint_path``: if set, a resumable checkpoint
        (:mod:`mcmcpp_tpu_torch.io.checkpoint`) is written after every
        ``checkpoint_every`` chunks, and once more when the run ends. The
        in-flight chunk is landed before each save, so a snapshot is
        consistent (state == chain == counters); saves are atomic.
        """
        with span("mcmcpp.run_mcmc"):
            self._require_state()
            n_steps = int(n_steps)
            thin = self._default_thin if thin is None else int(thin)
            if thin < 1:
                raise ValueError("thin must be >= 1")
            self.step_metrics = None
            if not store:
                self._run_nostore(n_steps)
                return True
            n_store = n_steps // thin
            leftover = n_steps - n_store * thin
            metric_chunks = []

            def land(pos, logp, metrics):
                self.chain, ok = append_device_chunk(self.chain, pos, logp)
                if metrics is not None:
                    metric_chunks.append(
                        _tree_map(lambda t: t.cpu().numpy(), metrics))
                if chunk_action is not None:
                    chunk_action(self.chain)
                return ok

            if thin > self._max_steps_per_harvest:
                ok = self._run_micro_chunks(n_store, thin, step_action, land)
            else:
                ok = self._run_chunks(n_store, thin, step_action, land,
                                      checkpoint_path, checkpoint_every)
            if metric_chunks:
                self.step_metrics = _tree_stack(
                    metric_chunks, lambda xs: np.concatenate(xs, axis=0))
            if not ok:
                return False
            if leftover:
                self._run_nostore(leftover)
            if checkpoint_path is not None:
                from mcmcpp_tpu_torch.io.checkpoint import save_checkpoint

                save_checkpoint(self, checkpoint_path)  # final snapshot
            return True

    def _run_chunks(self, n_store, thin, step_action, land,
                    checkpoint_path=None, checkpoint_every=1):
        """The pipelined store loop: chunk k is enqueued before chunk k−1
        lands."""
        chunk = min(self._chunk, self._max_steps_per_harvest // thin)

        def launch(take):
            with span("mcmcpp.steps"):
                self.state, pos, logp, metrics, acc = run_scan(
                    self.state, self._step_fn, take, thin, step_action,
                    store_dtype=self._store_dtype,
                )
            return pos, logp, metrics, acc

        def fetch(chunk_data):
            pos, logp, metrics, acc = chunk_data
            self._accum_accept(*acc)
            return land(pos, logp, metrics)

        def on_drop(chunk_data):
            # the unstorable chunk still advanced the state: count its accepts
            self._accum_accept(*chunk_data[3])

        ckpt_save = None
        if checkpoint_path is not None:
            from mcmcpp_tpu_torch.io.checkpoint import save_checkpoint

            def ckpt_save():
                save_checkpoint(self, checkpoint_path)

        return run_pipelined(
            n_store, chunk, launch, fetch, on_drop=on_drop,
            checkpoint_save=ckpt_save, checkpoint_every=checkpoint_every,
        )

    def _run_micro_chunks(self, n_store, thin, step_action, land):
        """Store path for a ``thin`` above the harvest cap: advance each
        stored step in harvested runs, then store the ensemble on its own."""
        for _ in range(n_store):
            self._run_nostore(thin)
            pos, logp = self._current_ensemble()
            metrics = (None if step_action is None else
                       _tree_map(lambda t: t[None], step_action(pos, logp)))
            if not land(pos[None], logp[None], metrics):
                return False
        return True

    def reset(self):
        """≙ reset (EnsembleSampler.h:97): clear chain + counters, keep the
        current walker positions so sampling can restart from here."""
        self._require_state()
        self.chain.clear()
        self._accepted_walkers_host = None
        self._reset_step_base = self.state.step
        self.state = self.state._replace(
            accepted_red=torch.zeros_like(self.state.accepted_red),
            accepted_black=torch.zeros_like(self.state.accepted_black),
        )
        return self

    # -- statistics & access ----------------------------------------------

    @property
    def total_steps(self):
        """Walker-updates since the last reset (W per step), ≙ getTotalSteps."""
        self._require_state()
        return (self.state.step - self._reset_step_base) * self.n_walkers

    @property
    def per_walker_accepted(self):
        """(W,) int64 accepted-move counts per walker since the last reset,
        in chain column order [red..., black...] (≙ ``Walker.h:111-122``)."""
        self._require_state()
        dev = torch.cat([self.state.accepted_red, self.state.accepted_black])
        counts = dev.cpu().numpy().astype(np.int64)
        if self._accepted_walkers_host is not None:
            counts = counts + self._accepted_walkers_host
        return counts

    @property
    def per_walker_acceptance(self):
        """(W,) per-walker acceptance fractions since the last reset."""
        self._require_state()
        steps = self.state.step - self._reset_step_base
        counts = self.per_walker_accepted
        if steps == 0:
            return np.zeros_like(counts, dtype=np.float64)
        return counts / steps

    @property
    def accepted_steps(self):
        """≙ getAcceptedSteps."""
        return int(self.per_walker_accepted.sum())

    @property
    def acceptance_fraction(self):
        """≙ getAcceptanceFraction (EnsembleSampler.h:245-282)."""
        t = self.total_steps
        return self.accepted_steps / t if t else 0.0

    @property
    def stored_steps(self):
        """≙ getStoredSteps."""
        return self.chain.n_steps

    def get_samples(self, burn_in=0, thin=1, flat=False):
        """Chain samples (S, W, P) (or flattened (S·W, P)), numpy."""
        return self.chain.get(burn_in=burn_in, thin=thin, flat=flat)

    def get_log_probs(self, burn_in=0, thin=1, flat=False):
        return self.chain.get_logp(burn_in=burn_in, thin=thin, flat=flat)

    def slice_and_burn_chain(self, thin, burn_in):
        """≙ sliceAndBurnChain (EnsembleSampler.h:333): in-place chain
        compaction to every ``thin``-th step after ``burn_in``."""
        self.chain.compact(burn_in=burn_in, thin=thin)
        return self

    @property
    def current_positions(self):
        """(W, P) device tensor, [red..., black...]."""
        self._require_state()
        return self._current_ensemble()[0]
