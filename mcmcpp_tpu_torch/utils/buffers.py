"""The online engines' stage loop (IBIS, SMC²).

Counterpart of ``mcmcpp_tpu/utils/buffers.py``. Its ``chunked_stage_scan``
fuses stages into one ``lax.scan`` while replaying the per-stage loop's
key splits, so that a chunked run and a per-stage run are bitwise equal. The
port draws from one generator in a fixed order, so the same semantics is a
plain loop that calls the per-stage function with that generator: the
stages of a chunk draw exactly what the per-stage loop draws, and the
chunk only groups the host's reads of the stages' outputs.

``pad_to_capacity`` is not ported. It pads the absorbed stream to a
power-of-two capacity so that XLA traces one program per capacity, and the
padded rows are masked out of every reduction. The port traces nothing: IBIS
scores the rows ``[start, start + take)`` and the prefix ``[0, start +
take)`` as slices of the stream, and SMC²'s rejuvenation filter runs over
the absorbed rows only, so no mask needs a padded row.
"""

import torch

__all__ = ["chunked_stage_scan"]


def chunked_stage_scan(stage_fn, gen, state, n_stages):
    """``n_stages`` stages in a row: ``stage_fn(gen, state, r) -> (state,
    aux)`` for r = 0…n_stages−1, each drawing from ``gen`` as the per-stage
    loop would. ``aux`` is a tuple of tensors (or numbers), stacked over
    the stages. Returns (gen, final state, stacked aux)."""
    auxes = []
    for r in range(int(n_stages)):
        state, aux = stage_fn(gen, state, r)
        auxes.append(aux)
    if not auxes:
        return gen, state, ()
    stacked = tuple(torch.stack([torch.as_tensor(a[i]) for a in auxes])
                    for i in range(len(auxes[0])))
    return gen, state, stacked
