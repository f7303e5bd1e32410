"""The port's associative scan held against ``jax.lax.associative_scan`` and
a sequential fold, forward and reverse, on an odd and a power-of-two
length, with a non-commutative combine (affine maps) over a tuple of
tensors and with a single-tensor combine (matrix products); float64 to
1e-12."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmcpp_tpu_torch.ops.scan import associative_scan

torch.set_num_threads(1)


def _affine_jax(a, b):
    # b ∘ a: x -> Fb (Fa x + ua) + ub
    return (jnp.einsum("tij,tjk->tik", b[0], a[0]),
            jnp.einsum("tij,tj->ti", b[0], a[1]) + b[1])


def _affine_torch(a, b):
    return b[0] @ a[0], (b[0] @ a[1][..., None])[..., 0] + b[1]


def _fold(elems, combine, reverse):
    """The inclusive scan by a plain loop, one element at a time."""
    t_n = elems[0].shape[0]
    order = range(t_n - 1, -1, -1) if reverse else range(t_n)
    out, acc = [None] * t_n, None
    for i in order:
        e = tuple(x[i:i + 1] for x in elems)
        acc = e if acc is None else combine(acc, e)
        out[i] = acc
    return tuple(torch.cat([o[k] for o in out]) for k in range(len(elems)))


@pytest.mark.parametrize("t_n", [1, 2, 13, 16])
@pytest.mark.parametrize("reverse", [False, True])
def test_affine_scan_matches_jax_and_a_fold(t_n, reverse):
    rng = np.random.default_rng(t_n)
    f = rng.normal(size=(t_n, 3, 3)) * 0.7
    u = rng.normal(size=(t_n, 3))
    with jax.enable_x64(True):
        want = jax.lax.associative_scan(_affine_jax, (jnp.asarray(f),
                                                      jnp.asarray(u)),
                                        reverse=reverse)
    elems = (torch.tensor(f), torch.tensor(u))
    got = associative_scan(_affine_torch, elems, reverse=reverse)
    fold = _fold(elems, _affine_torch, reverse)
    for g, w, s in zip(got, want, fold):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(g.numpy(), s.numpy(), rtol=0, atol=1e-12)


def test_single_tensor_and_list_structure():
    rng = np.random.default_rng(0)
    mats = rng.normal(size=(11, 2, 2))
    with jax.enable_x64(True):
        want = jax.lax.associative_scan(jnp.matmul, jnp.asarray(mats))
    got = associative_scan(torch.matmul, torch.tensor(mats))
    assert isinstance(got, torch.Tensor)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)
    out = associative_scan(lambda a, b: [a[0] + b[0]],
                           [torch.arange(5.0)])
    assert isinstance(out, list)
    assert out[0].tolist() == [0.0, 1.0, 3.0, 6.0, 10.0]
    with pytest.raises(ValueError, match="leading axes"):
        associative_scan(lambda a, b: a, (torch.zeros(3), torch.zeros(4)))
