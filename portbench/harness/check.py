"""The comparison that decides ``correct``.

The sampler's trajectory is chaotic: a decision that float32 and float64
round to opposite sides of the accept threshold (some per million walkers a
half-step) changes a walker, which changes its partners' proposals, and
within some tens of half-steps every walker differs. So the plain reference
cannot replay a window of thousands of steps; it follows the program half-step
by half-step from the program's own state. After the window the same
sampler, through the same entry at the same batch, takes ``follow_steps``
more steps one call each, and every one of their half-steps is worked out
again in float64 from the program's state before it: the partner shift and
the Philox key drawn again from the seed after every half-step the run took
(so a driver that skipped, repeated or reordered a half-step, or drew in
another order, fails), the proposal, its log-density, the decision. What
that skips is checked by itself: the program's start (its log-density of the
walkers it was given) and its state at the window's end (the log-density it
holds for the walkers it holds), and for a storing cell the rows its chain
holds for the window's last stored step and for each followed step, bit for
bit.

The numbers compared, each the worst over what it covers:

- ``logp_gap``: |lp − logp64(x)| / (1 + s(x)) of every walker's held
  log-density against float64 of its held position (start, window's end,
  every followed half-step's output), where s(x) is the rounding scale of
  −½‖x L‖² (``reference/gaussian.rounding_scale``: Σ_k |(xL)_k|·(|x||L|)_k,
  the size of the terms the evaluation sums), so that the number reads the
  same unit roundoff on a well- and an ill-conditioned target;
- ``pos_gap``: |x' − x'_ref| / (|proposal| + |x| + |partner|) elementwise,
  where x'_ref is the reference's proposal where the program reports the
  walker accepted and the walker's old row where it reports it rejected
  (a rejected row must come back bit for bit);
- ``decision_gap``: the widest margin |log ratio − log ue| / (1 + s(y) +
  s(x)) of the reference at a walker where the program's reported decision
  contradicts the reference's (0 where none does);
- ``row_mismatch``: stored elements (positions and log-densities) whose bits
  are not the held state rounded to the stored dtype.

The control puts the reference in the program's place, computed in the
precision below the configuration's (bfloat16 for float32; float8 e4m3 for a
bfloat16 store), on the same inputs: ``readings(..., control=True)``.
"""

import math

import torch

from portbench.reference import gaussian, noise, store, stretch

#: the precision below each stated one, for the control
CONTROL_DTYPE = {"float32": torch.bfloat16}
CONTROL_STORE = {"bfloat16": torch.float8_e4m3fn}
STORE_DTYPES = {"bfloat16": torch.bfloat16}
_TINY = 1e-30


def _worst(values):
    """max of a tensor as a float, NaN read as +inf."""
    if values.numel() == 0:
        return 0.0
    return float(torch.nan_to_num(values.double(), nan=math.inf).max())


def logp_gap(lp, x, prec_chol):
    """Worst |lp − logp64(x)| / (1 + s(x)) over the rows, s the rounding
    scale."""
    ref = gaussian.logp(x, prec_chol)
    scale = gaussian.rounding_scale(x, prec_chol)
    return _worst((lp.double() - ref).abs() / (1.0 + scale))


def control_logp_gap(x, prec_chol, dtype):
    """``logp_gap`` of the reference's own log-density in ``dtype``."""
    return logp_gap(gaussian.logp(x, prec_chol, dtype), x, prec_chol)


def half_step_gaps(rows, lp, acc, active, other, shift, key, prec_chol, a):
    """(pos_gap, logp_gap, decision_gap) of one half-step's outputs (rows,
    lp, acc as the program reports them) against the float64 reference on
    the same inputs."""
    ref = stretch.half_step(active, other, shift, key, prec_chol, a)
    accepted = acc.to(torch.bool)
    x = active.double()
    want = torch.where(accepted[:, None], ref["proposal"], x)
    m = other.shape[0]
    idx = (torch.arange(x.shape[0], device=x.device) + int(shift)) % m
    scale = ref["proposal"].abs() + x.abs() + other[idx].double().abs()
    pos = _worst((rows.double() - want).abs() / (scale + _TINY))
    del want, scale
    lpg = logp_gap(lp, rows, prec_chol)
    wrong = accepted != ref["accept"]
    margin = ((ref["log_ratio"] - ref["log_ue"]).abs()
              / (1.0 + ref["scale"]))[wrong]
    return pos, lpg, _worst(margin)


class Capture:
    """What the program produced that the check reads, and the run's
    counts: ``states`` (window's end, then after each followed step: (red,
    black, logp_red, logp_black)), ``accepts`` (per followed step, the
    per-walker accepted counts it added, [red…, black…]), ``rows`` (stored
    rows as raw bits with the index of the state they hold),
    ``steps_before`` (steps the run took before the first followed step),
    ``start`` (the start's readings, taken in set-up)."""

    def __init__(self):
        self.states = []
        self.accepts = []
        self.rows = []
        self.steps_before = 0
        self.start = {}


def readings(capture, prec_chol, a, seed, store_dtype=None, control=None):
    """{number: worst reading} of the program, or, with ``control`` a dtype,
    of the reference put in the program's place in that precision (and its
    stored rows in ``CONTROL_STORE``'s)."""
    out = {"logp_gap": capture.start["control" if control else "program"]}

    def worst(name, value):
        out[name] = max(out.get(name, 0.0), value)

    end = capture.states[0]
    for x, lp in ((end[0], end[2]), (end[1], end[3])):
        worst("logp_gap", control_logp_gap(x, prec_chol, control) if control
              else logp_gap(lp, x, prec_chol))
    n = end[0].shape[0]
    replay = noise.Replay(seed, n, end[0].device)
    replay.skip(2 * capture.steps_before)
    out.setdefault("pos_gap", 0.0)
    out.setdefault("decision_gap", 0.0)
    for t, acc in enumerate(capture.accepts):
        before, after = capture.states[t], capture.states[t + 1]
        halves = ((before[0], before[1], after[0], after[2], acc[:n]),
                  (before[1], after[0], after[1], after[3], acc[n:]))
        for active, other, rows, lp, got in halves:
            shift, key = replay.next()
            if control:
                ref = stretch.half_step(active, other, shift, key, prec_chol,
                                        a, dtype=control)
                rows, lp, got = stretch.outputs(ref, active)
                del ref
            pos, lpg, dec = half_step_gaps(rows, lp, got.to(active.device),
                                           active, other, shift, key,
                                           prec_chol, a)
            worst("pos_gap", pos)
            worst("logp_gap", lpg)
            worst("decision_gap", dec)
    if store_dtype is not None:
        held = STORE_DTYPES[store_dtype]
        out["row_mismatch"] = 0.0
        for pos_bits, lp_bits, k in capture.rows:
            red, black, lp_red, lp_black = capture.states[k]
            x = torch.cat([red, black])
            lp = torch.cat([lp_red, lp_black])
            if control:
                low = CONTROL_STORE[store_dtype]
                pos_bits = store.held_bits(x.to(low).to(held), held)
                lp_bits = store.held_bits(lp.to(low).to(held), held)
            count = (store.mismatches(pos_bits, x, held)
                     + store.mismatches(lp_bits, lp, held))
            worst("row_mismatch", float(count))
    return out
