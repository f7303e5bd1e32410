"""The fused stretch half-step of the port against the JAX Pallas kernel.

The JAX kernel runs in CPU interpret mode, where its hardware generator
yields zero bits, so its uniforms are exactly u = ue = 2^-25; its shift is
``randint(split(key)[1], (), 0, n)``. The port's plain version gets those
same numbers. The CUDA kernel itself is compared with the plain version in
the test marked ``cuda`` (skipped without a card) and in ``chip_smoke.py``.

JAX is imported inside the helpers only, so the ``cuda`` test runs on a
machine that has no JAX.
"""

import numpy as np
import pytest
import torch

from mcmcpp_tpu_torch.models.targets import GaussianTarget
from mcmcpp_tpu_torch.ops import fused_stretch as fs

torch.set_num_threads(1)

FLOOR = 2.0 ** -25
# float32 ULP-level agreement: the same formula, one matmul summed in
# another order
RTOL = ATOL = 1e-6


def _prec_chol(p, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(p, p))
    cov = a @ a.T / p + np.eye(p)
    return np.linalg.cholesky(np.linalg.inv(cov)).astype(np.float32)


def _inputs(n, p, seed):
    """Active rows near the mode, partners with every fourth row scaled x10:
    with z ≈ 1/2 the far partners give rejections, the near ones accepts."""
    rng = np.random.default_rng(seed)
    act = (0.3 * rng.normal(size=(n, p))).astype(np.float32)
    oth = rng.normal(size=(n, p)).astype(np.float32)
    oth[::4] *= 10.0
    return act, oth


def _jax_half(act, oth, lp, L, seed, tile):
    import jax
    import jax.numpy as jnp
    from mcmcpp_tpu.ops.pallas_stretch import fused_stretch_half

    Lj = jnp.asarray(L)

    def logp(x):
        y = x @ Lj
        return -0.5 * jnp.sum(y * y, axis=-1)

    key = jax.random.key(seed)
    n = act.shape[0]
    shift = int(jax.random.randint(jax.random.split(key)[1], (), 0, n,
                                   dtype=jnp.int32))
    out = fused_stretch_half(key, jnp.asarray(act), jnp.asarray(lp),
                             jnp.asarray(oth), logp_fn=logp, tile=tile,
                             interpret=True)
    return shift, [np.asarray(o) for o in out]


def _port_half(act, oth, lp, L, shift, target=None):
    n = act.shape[0]
    target = target or GaussianTarget(L, device="cpu")
    floor = torch.full((n,), FLOOR)
    out = fs.fused_stretch_half(
        torch.from_numpy(act), torch.from_numpy(lp), torch.from_numpy(oth),
        torch.tensor([shift], dtype=torch.int32), floor, floor.clone(),
        logp_fn=target,
    )
    return [o.numpy() for o in out]


def _logp_np(x, L):
    y = x.astype(np.float64) @ L.astype(np.float64)
    return (-0.5 * np.sum(y * y, axis=-1)).astype(np.float32)


@pytest.mark.parametrize("p", [2, 10])
def test_reference_matches_pallas_interpret(p):
    n, tile = 64, 32
    L = _prec_chol(p, seed=p)
    act, oth = _inputs(n, p, seed=100 + p)
    lp = _logp_np(act, L)
    shift, (j_act, j_lp, j_acc) = _jax_half(act, oth, lp, L, seed=7,
                                            tile=tile)
    t_act, t_lp, t_acc = _port_half(act, oth, lp, L, shift)
    np.testing.assert_array_equal(t_acc, j_acc)
    assert 0 < t_acc.sum() < n, "inputs must give accepts and rejects"
    np.testing.assert_allclose(t_act, j_act, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_lp, j_lp, rtol=RTOL, atol=ATOL)


def test_neg_inf_old_logp_accepts():
    """lp_old = -inf with a finite proposal must accept (both packages)."""
    n, p = 64, 3
    L = _prec_chol(p, seed=3)
    act, oth = _inputs(n, p, seed=5)
    lp = _logp_np(act, L)
    lp[1::3] = -np.inf
    shift, (j_act, j_lp, j_acc) = _jax_half(act, oth, lp, L, seed=11,
                                            tile=32)
    t_act, t_lp, t_acc = _port_half(act, oth, lp, L, shift)
    assert np.all(t_acc[1::3] == 1)
    np.testing.assert_array_equal(t_acc, j_acc)
    np.testing.assert_allclose(t_act, j_act, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_lp, j_lp, rtol=RTOL, atol=ATOL)
    assert np.all(np.isfinite(t_lp))


def test_unequal_halves_rejected():
    L = _prec_chol(2, seed=0)
    act = torch.zeros((8, 2))
    floor = torch.full((8,), FLOOR)
    with pytest.raises(ValueError, match="equal halves"):
        fs.fused_stretch_half(
            act, torch.zeros(8), torch.zeros((6, 2)),
            torch.zeros(1, dtype=torch.int32), floor, floor,
            logp_fn=GaussianTarget(L, device="cpu"),
        )


def test_reference_takes_any_callable_on_cpu():
    """On the CPU the plain version runs any batched logp; stored logp is
    the logp of the stored row, accepted or not."""
    n, p = 32, 3
    rng = np.random.default_rng(0)
    act = torch.from_numpy(rng.normal(size=(n, p)).astype(np.float32))
    oth = torch.from_numpy(rng.normal(size=(n, p)).astype(np.float32))

    def logp(x):
        return -torch.sum(torch.abs(x), dim=-1)

    u = torch.from_numpy(rng.uniform(FLOOR, 1, n).astype(np.float32))
    ue = torch.from_numpy(rng.uniform(FLOOR, 1, n).astype(np.float32))
    new, new_lp, acc = fs.fused_stretch_half(
        act, logp(act), oth, torch.tensor([5], dtype=torch.int32), u, ue,
        logp_fn=logp,
    )
    torch.testing.assert_close(new_lp, logp(new), rtol=1e-6, atol=1e-6)
    moved = torch.any(new != act, dim=1)
    assert int(moved.sum()) == int(acc.sum())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,p", [(1 << 16, 10), (1000, 3), (4096, 2),
                                 (2048, 64)])
def test_kernel_matches_reference_on_card(cuda_device, n, p):
    """Kernel vs plain version on one card: rtol = atol = 1e-5 (logf/sqrtf
    vs torch's ops and the product's summation order); accept masks equal
    except within 1e-4·max(1, |log_ratio|) of the threshold."""
    L = _prec_chol(p, seed=p)
    act, oth = _inputs(n, p, seed=p)
    lp = _logp_np(act, L)
    lp[7::97] = -np.inf
    g = torch.Generator(device=cuda_device).manual_seed(p)
    u = torch.rand(n, generator=g, device=cuda_device).clamp_(min=FLOOR)
    ue = torch.rand(n, generator=g, device=cuda_device).clamp_(min=FLOOR)
    target = GaussianTarget(L, device=cuda_device)
    args = (torch.from_numpy(act).to(cuda_device),
            torch.from_numpy(lp).to(cuda_device),
            torch.from_numpy(oth).to(cuda_device),
            torch.tensor([n // 3], dtype=torch.int32, device=cuda_device),
            u, ue)
    before = fs.LAUNCHES
    k_act, k_lp, k_acc = fs.fused_stretch_half(*args, logp_fn=target)
    torch.cuda.synchronize()
    assert fs.LAUNCHES == before + 1
    r_act, r_lp, r_acc = fs.fused_stretch_half_reference(*args,
                                                         logp_fn=target)
    assert 0 < int(r_acc.sum()) < n
    # the threshold margin of each row, from the plain computation
    _, _, log_ratio = fs.stretch_proposal(*args[:5], logp_fn=target)
    margin = (log_ratio - torch.log(ue)).abs()
    near = margin < 1e-4 * torch.clamp(log_ratio.abs(), min=1.0)
    agree = (k_acc == r_acc) | near
    assert bool(agree.all())
    same = k_acc == r_acc
    torch.testing.assert_close(k_act[same], r_act[same], rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(k_lp[same], r_lp[same], rtol=1e-5, atol=1e-5)


def test_device_dispatch_without_card():
    """Off the CPU the wrapper takes the kernel or raises, never the plain
    version: a non-Gaussian logp raises NotImplementedError before any
    launch, and a device other than CUDA raises (meta tensors stand in for
    a device here)."""
    x = torch.empty((4, 2), device="meta")
    lp = torch.empty((4,), device="meta")
    with pytest.raises(NotImplementedError, match="split path"):
        fs.fused_stretch_half(x, lp, x, lp, lp, lp, logp_fn=lambda t: t)
    target = GaussianTarget(np.eye(2, dtype=np.float32), device="meta")
    with pytest.raises(RuntimeError, match="no fused stretch path"):
        fs.fused_stretch_half(x, lp, x, lp, lp, lp, logp_fn=target)
