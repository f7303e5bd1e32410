"""The fused stretch half-step of the port against the JAX Pallas kernel.

The JAX kernel runs in CPU interpret mode, where its hardware generator
yields zero bits, so its uniforms are exactly u = ue = 2^-25; its shift is
``randint(split(key)[1], (), 0, n)``. The port's plain versions get those
same numbers: the fused one for a Gaussian logp, and the split path's two
twins (propose, accept) for the non-Gaussian targets the Pallas kernel also
traces into its body. The CUDA kernels themselves, which draw u and ue from a
Philox key, are compared with their plain versions on that key's planes
(``philox_unit_uniforms``) in the tests marked ``cuda`` (skipped without a
card) and in ``chip_smoke.py``.

JAX is imported inside the helpers only, so the ``cuda`` test runs on a
machine that has no JAX.
"""

import itertools

import numpy as np
import pytest
import torch

from mcmcpp_tpu_torch.models.targets import GaussianTarget
from mcmcpp_tpu_torch.ops import fused_stretch as fs
from mcmcpp_tpu_torch.ops.random import philox_unit_uniforms

torch.set_num_threads(1)

FLOOR = 2.0 ** -25
# float32 ULP-level agreement: the same formula, one matmul summed in
# another order
RTOL = ATOL = 1e-6

#: a panel's wgmma N on the K-split route (``MCMCPP_KSPLIT_WIDTHS``)
KSPLIT_WIDTHS = (80, 72, 64, 56, 48)
#: the widest P whose K-split plan fits an H100's block (a cluster of 8,
#: stages of two k-steps, N = 48)
KSPLIT_WIDEST = 2944
#: route 6's block (``plan_yl``): a cluster of row groups × column groups,
#: a panel's wgmma N, k-steps of 8 a stage, and the bytes of a Y stage (128
#: rows × 32 k-rows) and of an L stage (two halves of 32 k-rows × N)
YL_GROUPS, YL_N, YL_KC = (4, 2), 128, 4
YL_SLOT = 4 * 128 * 32 + 2 * 4 * 32 * 128


def _prec_chol(p, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(p, p))
    cov = a @ a.T / p + np.eye(p)
    return np.linalg.cholesky(np.linalg.inv(cov)).astype(np.float32)


def _inputs(n, p, seed, act_scale=0.3):
    """Active rows near the mode, partners with every fourth row scaled x10:
    with z ≈ 1/2 the far partners give rejections, the near ones accepts.
    Past P = 64 the factor (P−1)·log z ≈ −0.69·(P−1) of z ≈ 1/2 rejects
    every move from near the mode, so the wide cases pass ``act_scale`` = 3:
    active rows further out, which the near partners improve on."""
    rng = np.random.default_rng(seed)
    act = (act_scale * rng.normal(size=(n, p))).astype(np.float32)
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


@pytest.mark.parametrize("p", [2, 10, 65, 100, 320])
def test_reference_matches_pallas_interpret(p):
    """The plain half-step, which the CUDA kernels are held to (the fused
    kernel's for P <= 16, the wide kernel's beyond: at P = 320 its
    L-streamed route), against the Pallas kernel on the same numbers."""
    n, tile = 64, 32
    L = _prec_chol(p, seed=p)
    act, oth = _inputs(n, p, seed=100 + p,
                       act_scale=0.3 if p <= fs.MAX_P else 3.0)
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


def _card_shift(n, shift):
    """Named shifts of the trouble cases: the partner run of a 256-row tile
    wraps at n in the middle of a tile for "mid"."""
    return {"third": n // 3, "last": n - 1, "mid": n - 100 if n > 100
            else n // 2, "negative": -7, "beyond": 3 * n + 5}.get(shift, shift)


@pytest.mark.cuda
@pytest.mark.parametrize("n,p,shift", [
    (1 << 16, 10, "third"), (1000, 3, "third"), (4096, 2, "third"),
    (2048, 16, "third"), (1 << 16, 10, 0), (1 << 16, 10, 1),
    (1 << 16, 10, "last"), (1 << 16, 10, "mid"), (50, 10, "mid"),
    (160, 2, 1), (128, 10, "last"), (1000, 7, "mid"), (1000, 13, 1),
    (1000, 10, "negative"), (1000, 10, "beyond"), (300, 16, "mid"),
])
def test_kernel_matches_reference_on_card(cuda_device, n, p, shift):
    """Kernel vs plain version on one card: rtol = atol = 1e-5 (logf/sqrtf
    vs torch's ops and the product's summation order); accept masks equal
    except within 1e-4·max(1, |log_ratio|) of the threshold. The kernel
    draws u and ue from the key; the plain version gets the key's planes."""
    L = _prec_chol(p, seed=p)
    act, oth = _inputs(n, p, seed=p)
    lp = _logp_np(act, L)
    lp[7::97] = -np.inf
    key = 0x9E3779B97F4A7C15 ^ (n * 1000003 + p)
    u, ue = philox_unit_uniforms(key, n, cuda_device)
    target = GaussianTarget(L, device=cuda_device)
    args = (torch.from_numpy(act).to(cuda_device),
            torch.from_numpy(lp).to(cuda_device),
            torch.from_numpy(oth).to(cuda_device),
            torch.tensor([_card_shift(n, shift)], dtype=torch.int32,
                         device=cuda_device))
    before = dict(fs.LAUNCHES)
    k_act, k_lp, k_acc = fs.fused_stretch_half(*args, key=key,
                                               logp_fn=target)
    torch.cuda.synchronize()
    assert fs.LAUNCHES == {**before, "fused_stretch_half":
                           before["fused_stretch_half"] + 1}
    r_act, r_lp, r_acc = fs.fused_stretch_half_reference(*args, u, ue,
                                                         logp_fn=target)
    assert 0 < int(r_acc.sum()) < n
    assert bool((k_acc[7::97] == 1).all())
    # the threshold margin of each row, from the plain computation
    _, _, log_ratio = fs.stretch_proposal(*args, u, logp_fn=target)
    margin = (log_ratio - torch.log(ue)).abs()
    near = margin < 1e-4 * torch.clamp(log_ratio.abs(), min=1.0)
    agree = (k_acc == r_acc) | near
    assert bool(agree.all())
    same = k_acc == r_acc
    torch.testing.assert_close(k_act[same], r_act[same], rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(k_lp[same], r_lp[same], rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_kernels_refuse_planes_on_card(cuda_device):
    """On a CUDA tensor the wrapper takes a key; planes raise. (A
    GaussianTarget wider than ``fs.MAX_P`` does not raise: it runs the wide
    kernel, ``test_wide_gaussian_launches_one_wide_kernel_on_card``.)"""
    n, p = 64, 2
    x = torch.zeros((n, p), device=cuda_device)
    lp = torch.zeros(n, device=cuda_device)
    shift = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    target = GaussianTarget(np.eye(p, dtype=np.float32), device=cuda_device)
    with pytest.raises(TypeError, match="key"):
        fs.fused_stretch_half(x, lp, x, shift, lp, lp, logp_fn=target)
    with pytest.raises(TypeError, match="key"):
        fs.fused_stretch_half(x, lp, x, shift, logp_fn=target)
    with pytest.raises(ValueError, match="64-bit"):
        fs.fused_stretch_half(x, lp, x, shift, key=-1, logp_fn=target)


def _wide_case(device, n, p, shift, seed):
    """Inputs of a wide half-step on the card: act rows further out (see
    ``_inputs``) and lp_old = −inf on every 61st row."""
    L = _prec_chol(p, seed=p)
    act, oth = _inputs(n, p, seed=seed, act_scale=3.0)
    lp = _logp_np(act, L)
    lp[5::61] = -np.inf
    key = 0xC0FFEE ^ (n * 7919 + p)
    target = GaussianTarget(L, device=device)
    args = (torch.from_numpy(act).to(device), torch.from_numpy(lp).to(device),
            torch.from_numpy(oth).to(device),
            torch.tensor([_card_shift(n, shift)], dtype=torch.int32,
                         device=device))
    return target, args, key


def _assert_near_reference(target, args, key, k_out, skip=None):
    """A kernel half-step against its plain version on the key's planes:
    rtol = atol = 1e-5 (3xTF32 sums in the kernel's order against
    cuBLAS's float32), accept masks equal except within
    1e-4·max(1, |log_ratio|) of the threshold, lp_old = −inf rows accepted.
    Rows in the mask ``skip`` (NaN rows, checked by the caller) are left
    out of the comparison."""
    n = args[0].shape[0]
    u, ue = philox_unit_uniforms(key, n, args[0].device)
    k_act, k_lp, k_acc = k_out
    r_act, r_lp, r_acc = fs.fused_stretch_half_reference(*args, u, ue,
                                                         logp_fn=target)
    assert 0 < int(r_acc.sum()) < n
    assert bool((k_acc[5::61] == 1).all())
    _, _, log_ratio = fs.stretch_proposal(*args, u, logp_fn=target)
    near = ((log_ratio - torch.log(ue)).abs()
            < 1e-4 * torch.clamp(log_ratio.abs(), min=1.0))
    same = k_acc == r_acc
    if skip is not None:
        near, same = near | skip, same & ~skip
    assert bool((same | near).all())
    torch.testing.assert_close(k_act[same], r_act[same], rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(k_lp[same], r_lp[same], rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shift", ["mid", "last"])
@pytest.mark.parametrize("p", [33, 64, 65, 66, 67, 100, 112, 113, 117, 118,
                               128, 200, 257, 296, 297, 298, 299, 300, 384,
                               512, 577, 704, 784, 785, 786, 787, 788, 1000,
                               1024, 1025, 1536, KSPLIT_WIDEST,
                               KSPLIT_WIDEST + 1, KSPLIT_WIDEST + 2,
                               KSPLIT_WIDEST + 3, KSPLIT_WIDEST + 4, 3000,
                               4096])
def test_wide_gaussian_launches_one_wide_kernel_on_card(cuda_device, p,
                                                        shift):
    """A GaussianTarget with P > ``fs.MAX_P`` (16, the fused kernel's own
    limit) launches the wide kernel once a half-step, and no split kernel;
    the half-step holds to its plain version (``_assert_near_reference``).
    The widths take each of the kernel's routes on an H100 (warp-specialised
    to P = 117, thread-block clusters of 2, 4 and 8 blocks from 118 to 296,
    L streamed from 297 to 784 (N = 80, 64, 80, 72, 56; stages of four
    k-steps, of two at P = 577–784), K split over clusters of 4 blocks from
    785 to 1024 and of 8 to ``KSPLIT_WIDEST``, route 6 (Y and L streamed)
    past that) and every P mod 4 at the routes' edges, so that the runs
    start at every offset from a 16-B boundary."""
    target, args, key = _wide_case(cuda_device, 3000, p, shift, seed=p)
    before = dict(fs.LAUNCHES)
    k_out = fs.fused_stretch_half(*args, key=key, logp_fn=target)
    torch.cuda.synchronize()
    assert fs.LAUNCHES == {**before, "fused_stretch_wide":
                           before["fused_stretch_wide"] + 1}
    _assert_near_reference(target, args, key, k_out)


@pytest.mark.cuda
@pytest.mark.parametrize("shift", ["mid", "last"])
def test_wide_kernel_streams_y_past_its_tile_on_card(cuda_device, shift):
    """At P = 1000 the Y tile of 64 walkers no longer fits beside the
    L-streamed route's ring (it stops at P = 784 on an H100) nor in the
    mma.sync kernel's block, which streams Y through the output rows (the
    dispatch reaches it at no width on an H100: ``fs.wide_forced_mma``
    launches it); each block of a K-split cluster keeps a k-slice of a
    128-row Y tile instead, and past ``KSPLIT_WIDEST`` route 6 streams Y
    from a buffer it forms once. One launch a half-step through the
    dispatch, held to the plain version."""
    p = 1000
    assert fs.WIDE_ROUTES[fs.wide_layout(p, cuda_device)["route"]] == (
        "wgmma, K split over a cluster")
    target, args, key = _wide_case(cuda_device, 1000, p, shift, seed=p)
    before = dict(fs.LAUNCHES)
    k_out = fs.fused_stretch_half(*args, key=key, logp_fn=target)
    torch.cuda.synchronize()
    assert fs.LAUNCHES == {**before, "fused_stretch_wide":
                           before["fused_stretch_wide"] + 1}
    _assert_near_reference(target, args, key, k_out)


def _tf32(x):
    """float32 -> TF32 on the int32 view as the wide kernel rounds its big
    parts: the top 10 mantissa bits, to nearest with ties away from zero
    (adding half a TF32 ULP to the magnitude's bits carries into the
    exponent where it must), the low 13 bits cleared."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _truncate_tf32(x):
    """float32 -> TF32 as the tensor cores read a float32: the low 13 bits
    ignored."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    """The kernel's x = big + small: big rounded, small the remainder as
    the tensor cores truncate it."""
    big = _tf32(x)
    return big, _truncate_tf32(x - big)


def _sum_truncated(acc, part):
    """float32 acc + part (float64) as a tensor core writes its sum: exact,
    then truncated toward zero to float32."""
    exact = acc.astype(np.float64) + part
    out = exact.astype(np.float32)
    over = np.abs(out.astype(np.float64)) > np.abs(exact)
    out[over] = np.nextafter(out[over], np.float32(0))
    return out


#: the shared memory an H100's block may opt into
H100_SMEM = 232448
#: the wgmma N (a block's columns of S) the cluster kernel is built for
#: (``MCMCPP_CLUSTER_WIDTHS`` in ``csrc/fused_stretch_wide.cu``)
CLUSTER_WIDTHS = (32, 40, 48, 56, 64, 72, 80, 88)


def _ws_plan(p, optin=H100_SMEM):
    """``plan_for`` of ``csrc/fused_stretch_wide.cu`` at width p: the
    warp-specialised block's wgmma N where L's halves, two Y tiles and two
    rings of three or more stages of 32, 16 or 8 rows fit (P <= 117 on an
    H100), else None."""
    if p > 128:
        return None
    kp = -(-p // 8) * 8
    ys = kp if kp % 16 else kp + 8
    nsub = 32 if p <= 32 else -(-p // 16) * 16
    off = -(-(8 * kp * nsub) // 128) * 128 + 8 * 64 * ys + 8 * 4 * 64 + 256
    off = -(-off // 128) * 128
    for sr in (32, 16, 8):
        slot = 2 * 4 * (-(-(sr * p + 10) // 4) * 4)
        if min(8, (optin - off) // (2 * slot)) >= 3:
            return nsub
    return None


def _cluster_plan(p, optin=H100_SMEM):
    """``plan_cluster`` of ``csrc/fused_stretch_wide.cu`` at width p, for a
    P that the warp-specialised block does not take (p > 117 on an H100):
    (blocks a cluster c, a block's columns N), the smallest c of 2, 4, 8
    whose block holds its slice of L's halves, the Y tile (as two halves of
    k-steps), two staging buffers of its own 64/c rows and a ring of two or
    more stages of them; None where none fits (the mma.sync kernel's
    widths)."""
    kp = -(-p // 8) * 8
    ks = kp // 8
    for c in (2, 4, 8):
        nsub = -(-(-(-p // c)) // 8) * 8
        if nsub not in CLUSTER_WIDTHS:
            continue
        own = 64 // c
        # the Y tile's two halves of k-steps, each a whole number of groups
        kg = 4 if nsub <= 80 else 2
        ks0 = min(ks, max(1, (ks + kg) // (2 * kg)) * kg)
        row = sum(k if k % 16 else k + 8 for k in (8 * ks0, 8 * (ks - ks0)))
        off = sum(-(-x // 128) * 128
                  for x in (8 * kp * nsub, 4 * 64 * row, 8 * own * row))
        off = -(-(off + 5 * 256 + 2 * 256 + 8 * (2 * 8 + 10)) // 128) * 128
        for sr in (16, 8):
            slot = 2 * 4 * (-(-(sr * p + 10) // 4) * 4)
            if sr <= own and min(8, (optin - off) // slot) >= 2:
                return c, nsub
    return None


#: a consumer's wgmma N on the L-streamed route (``MCMCPP_STREAM_WIDTHS``)
STREAM_WIDTHS = (80, 72, 64, 56, 48)


def _stream_plan(p, optin=H100_SMEM):
    """``plan_stream`` of ``csrc/fused_stretch_wide.cu`` at width p, for a P
    that neither the warp-specialised block nor the cluster route takes
    (p > 296 on an H100): (a consumer's N, k-steps of 8 an L stage, slots of
    the ring, rows a walker stage). N is the built width whose panels of
    2·N columns cover P with the fewest columns (the wider of a tie); beside
    the 64-row Y tile (its rows' scalars in its padding) one ring of two or
    more slots, each an L stage of four k-steps where such a ring fits, else
    of two (8·k-steps rows × 2·N columns × two halves), a walker stage as
    many rows (at most 64) as their X and partner runs fit a slot; None
    where none fits."""
    nsub = min(STREAM_WIDTHS, key=lambda n: (2 * n * -(-p // (2 * n)), -n))
    for kc in (4, 2):
        kp = -(-p // (8 * kc)) * 8 * kc
        lstage = 2 * 4 * 8 * kc * 2 * nsub
        off = -(-(4 * 64 * (kp + 8) + 8 * 2 * 8) // 128) * 128
        slots = min(8, (optin - off) // lstage)
        sr = min(64, (lstage // 8 - 13) // p)
        if slots >= 2 and sr >= 1:
            return nsub, kc, slots, sr
    return None


def _ksplit_plan(p, optin=H100_SMEM):
    """``plan_ksplit`` of ``csrc/fused_stretch_wide.cu`` at width p, for a P
    that the routes before it do not take (p > 784 on an H100): (blocks a
    cluster c, a panel's N, k-steps of 8 an L stage, slots of the ring, rows
    a walker stage), the first fit of L stages of four k-steps then two, N
    of at least 64 then narrower, clusters of 4 then 8, and those N in the
    order of the columns its panels pad P to (the fewest first, the wider
    of a tie), whose block holds the
    widest k-slice of the 128-row Y tile (⌈chunks / c⌉ chunks of 8·kc
    k-rows, row stride + 8), one panel's partials of its own rows (128·N
    floats) and a ring of L stages, three or more for clusters of 4, two or
    more for clusters of 8; a walker stage as many rows (at most 16) as
    their X and partner runs (each at its offset from 16 B) fit a slot;
    None where none fits."""
    widths = sorted(KSPLIT_WIDTHS, key=lambda n: n * -(-p // n))
    for kc, narrow, (c, need) in itertools.product(
            (4, 2), (False, True), ((4, 3), (8, 2))):
        chunks = -(-p // (8 * kc))
        if chunks >= c:
            wpad = -(-chunks // c) * 8 * kc
            for nsub in (n for n in widths if (n < 64) == narrow):
                lstage = 64 * kc * nsub
                off = 4 * 128 * (wpad + 8) + 4 * 128 * nsub + 8 * 19
                slots = min(8, (optin - -(-off // 128) * 128) // lstage)
                area = -(-min(wpad, p) // 4) * 4 + 4
                sr = min(16, lstage // (8 * area))
                if slots >= need and sr >= 1:
                    return c, nsub, kc, slots, sr
    return None


def _ksplit_slices(p):
    """The k-rows [k0, k1) of each block of the K-split route's cluster at
    width p: chunks of 8·kc k-rows, chunks // c a block and one more for
    each of the first chunks % c blocks, cut at P."""
    c, _, kc = _ksplit_plan(p)[:3]
    chunks = -(-p // (8 * kc))
    q, rem = divmod(chunks, c)
    starts = [8 * kc * (r * q + min(r, rem)) for r in range(c + 1)]
    return [(k0, min(k1, p)) for k0, k1 in zip(starts[:-1], starts[1:])]


def _yl_plan(p, optin=H100_SMEM):
    """``plan_yl`` of ``csrc/fused_stretch_wide.cu`` (route 6) at width p,
    for a P that the routes before it do not take (p > ``KSPLIT_WIDEST`` on
    an H100): (row groups, column groups, a panel's N, k-steps of 8 a
    stage, slots of the ring), the same block at every P: beside the owned
    rows' offsets and scalars and the exchange of the row sums (3200 bytes
    with the barriers) a ring of two or more slots (at most 8), each a Y
    stage beside an L stage; None where two slots do not fit."""
    off = 8 * 2 * 64 + 4 * 4 * 64 + 4 * 2 * 128 + 8 * 2 * 8
    slots = min(8, (optin - -(-off // 128) * 128) // YL_SLOT)
    return (*YL_GROUPS, YL_N, YL_KC, slots) if p >= 1 and slots >= 2 else None


def _wide_route(p, optin=H100_SMEM):
    """The wide kernel's route at width p, as ``route`` in
    ``csrc/fused_stretch_wide.cu`` picks it: "ws" (the warp-specialised
    block), "cluster", "stream" (L streamed), "ksplit" (K split over a
    cluster), "yl" (route 6: Y and L streamed) or "mma" (the mma.sync
    kernel, where no wgmma plan fits the device's block)."""
    if _ws_plan(p, optin):
        return "ws"
    if _cluster_plan(p, optin):
        return "cluster"
    if _stream_plan(p, optin):
        return "stream"
    if _ksplit_plan(p, optin):
        return "ksplit"
    return "yl" if _yl_plan(p, optin) else "mma"


def _wide_width(p):
    """Columns of S that one product of the wide kernel takes at width p:
    the warp-specialised kernel's wgmma N (``nsub_for`` in
    ``csrc/fused_stretch_wide.cu``: P rounded up to 16, at least 32) where
    ``plan_for`` takes P (P <= 117 with an H100's 232,448 B a block), a
    cluster block's slice where ``plan_cluster`` does (to P = 296), a
    consumer's half of a panel on the L-streamed route (to P = 784), a
    panel on the K-split route (to ``KSPLIT_WIDEST``) and on route 6 (past
    it), else the mma.sync kernel's panels of 64."""
    route = _wide_route(p)
    if route == "ws":
        return _ws_plan(p)
    if route == "cluster":
        return _cluster_plan(p)[1]
    if route == "ksplit":
        return _ksplit_plan(p)[1]
    if route == "yl":
        return YL_N
    return _stream_plan(p)[0] if route == "stream" else 64


def _wide_group(p):
    """k-steps whose products share a partial in the wide kernel at width
    p (``Product::KG``): on the warp-specialised and cluster routes four
    where the wgmma is at most 80 wide, two to 112, one past (as the A
    fragments of the group fit beside the accumulators); on the L-streamed
    and K-split routes an L stage's (four, or two where only those fit);
    on route 6 a stage's four; one in the mma.sync kernel."""
    route = _wide_route(p)
    if route == "ksplit":
        return _ksplit_plan(p)[2]
    if route == "yl":
        return YL_KC
    if route in ("stream", "mma"):
        return _stream_plan(p)[1] if route == "stream" else 1
    n = _wide_width(p)
    return 4 if n <= 80 else 2 if n <= 112 else 1


def _wide_slices(p):
    """Blocks whose partial row sums the wide kernel adds at width p: a
    cluster's c on the cluster route, else 1."""
    return _cluster_plan(p)[0] if _wide_route(p) == "cluster" else 1


def _wide_kslices(p):
    """The k-rows whose products the wide kernel sums apart at width p
    before adding them in rank order: each block's k-slice on the K-split
    route (``_ksplit_slices``), else all of K."""
    return _ksplit_slices(p) if _wide_route(p) == "ksplit" else [(0, p)]


def _wide_colgroups(p):
    """Column groups whose row sums the wide kernel adds in rank order at
    width p: on route 6 each block of a row group squares the panels
    g, g + G, … (its column group g of G) and the owner adds the G sums;
    else 1."""
    return YL_GROUPS[1] if _wide_route(p) == "yl" else 1


def _wide_consumers(p):
    """Consumer warpgroups whose row sums the wide kernel adds at width p:
    two on the L-streamed route (each over its half of every panel), else
    one."""
    return 2 if _wide_route(p) == "stream" else 1


def _row_squares(acc, width):
    """The rows' Σ S² as the wide kernel sums them: thread t of a row's
    quad folds fmaf(c, c, q) over columns 8j + 2t and 8j + 2t + 1 of each
    block of ``width`` columns in turn (a product's N, zeros past P), then
    the quad adds (q0 + q1) + (q2 + q3)."""
    n, p = acc.shape
    tiles = -(-p // width)
    cols = np.zeros((n, tiles * width), np.float32)
    cols[:, :p] = acc
    q = np.zeros((4, n), np.float32)
    for j0 in range(0, tiles * width, 8):
        for t in range(4):
            for c in (j0 + 2 * t, j0 + 2 * t + 1):
                v = cols[:, c].astype(np.float64)
                q[t] = (v * v + q[t]).astype(np.float32)
    return (q[0] + q[1]) + (q[2] + q[3])


def _quad_3xtf32(y, L, partials=True, width=None, group=None, slices=None,
                 consumers=None, kslices=None, colgroups=None):
    """The wide kernel's lp = −½‖y·L‖² as its tensor cores compute it: per
    k-step of 8, the three TF32 products small·big, big·small and big·big,
    each summed exactly (float64 holds a TF32 product and a sum of eight)
    and added by the wgmma (or mma.sync) with its sum truncated to float32,
    into a partial that the first product of a group of ``group`` k-steps
    (``_wide_group(P)`` by default) zeroes and a float32 add (round to
    nearest) puts into S; with ``partials`` False, into S itself. A
    column's value does not depend on the N tile that takes it; the
    squares are summed in the kernel's order over N tiles of ``width``
    columns (``_wide_width(P)`` by default). With ``slices`` c > 1
    (``_wide_slices(P)`` by default: the cluster route), block r of the
    cluster sums the squares of its slice, columns r·width …, into a
    partial, and the c partials are added in rank order. With
    ``consumers`` 2 (``_wide_consumers(P)`` by default: the L-streamed
    route), consumer c sums the squares of columns c·width … of each panel
    of 2·width columns, panel by panel, and the row's sum is consumer 0's
    plus consumer 1's. With ``kslices`` (``_wide_kslices(P)`` by default:
    each block's k-rows on the K-split route, else all of K), the groups of
    each k-slice are summed into that slice's S from zero, and the slices'
    S are added in rank order, ((S_0 + S_1) + S_2) + …, before the
    squares. With ``colgroups`` G > 1 (``_wide_colgroups(P)`` by default:
    route 6), column group g sums the squares of panels g, g + G, … of
    ``width`` columns in that order, and the G sums are added in rank
    order."""
    yb, ys = _split(y)
    lb, ls = _split(L)
    p = L.shape[0]
    group = group or _wide_group(p)
    acc = None
    for k_lo, k_hi in kslices or _wide_kslices(p):
        s_r = np.zeros((y.shape[0], p), np.float32)
        for g0 in range(k_lo, k_hi, 8 * group):
            part = np.zeros_like(s_r) if partials else s_r
            for k0 in range(g0, min(k_hi, g0 + 8 * group), 8):
                k = slice(k0, k0 + 8)
                for a, b in ((ys, lb), (yb, ls), (yb, lb)):
                    part = _sum_truncated(
                        part,
                        a[:, k].astype(np.float64) @ b[k].astype(np.float64))
            s_r = (s_r + part).astype(np.float32) if partials else part
        acc = s_r if acc is None else (acc + s_r).astype(np.float32)
    width = width or _wide_width(p)
    slices = slices or _wide_slices(p)
    consumers = consumers or _wide_consumers(p)
    colgroups = colgroups or _wide_colgroups(p)
    if colgroups > 1:
        panels = -(-p // width)
        cols = np.zeros((acc.shape[0], width * panels), np.float32)
        cols[:, :p] = acc
        total = None
        for g in range(colgroups):
            mine = [cols[:, pn * width:(pn + 1) * width]
                    for pn in range(g, panels, colgroups)]
            q = (_row_squares(np.concatenate(mine, axis=1), width) if mine
                 else np.zeros(acc.shape[0], np.float32))
            total = q if total is None else (total + q).astype(np.float32)
        return np.float32(-0.5) * total
    if consumers == 2:
        panels = -(-p // (2 * width))
        cols = np.zeros((acc.shape[0], 2 * width * panels), np.float32)
        cols[:, :p] = acc
        q = [_row_squares(np.concatenate(
            [cols[:, (2 * pn + c) * width:(2 * pn + c + 1) * width]
             for pn in range(panels)], axis=1), width) for c in range(2)]
        return np.float32(-0.5) * (q[0] + q[1]).astype(np.float32)
    if slices == 1:
        return np.float32(-0.5) * _row_squares(acc, width)
    total = None
    for r in range(slices):
        cols = np.zeros((acc.shape[0], width), np.float32)
        part = acc[:, r * width:(r + 1) * width]
        cols[:, :part.shape[1]] = part
        q = _row_squares(cols, width)
        total = q if total is None else (total + q).astype(np.float32)
    return np.float32(-0.5) * total


@pytest.mark.parametrize("p", [65, 100, 112, 113, 118, 128, 200, 257])
def test_3xtf32_quadratic_form_keeps_float32_accuracy(p):
    """The wide kernel's product (3xTF32, a zeroed partial for each group of
    k-steps, the squares in its order over its wgmma's N tiles, on the
    cluster route over each block's slice and then in rank order) against
    float64 and against the plain float32 ``GaussianTarget.forward`` on the
    CPU, on proposals from the near and the far partners (|lp| from ~10 to
    ~10^4): within rtol = 1e-5, the card tests' tolerance, in the kernel's
    grouping at P and in groups of four k-steps at every P. Plain TF32
    (big·big alone) misses it by orders of magnitude, which is why the
    kernel splits."""
    L = _prec_chol(p, seed=p)
    # an L with an upper triangle too: the kernel takes the whole matrix
    L_full = L + np.triu(_prec_chol(p, seed=p + 1), 1) * 0.1
    for mat in (L, L_full.astype(np.float32)):
        _, y = _inputs(256, p, seed=p)
        want = _logp_np(y, mat).astype(np.float64)
        plain = GaussianTarget(mat, device="cpu")(torch.from_numpy(y))
        for group in sorted({_wide_group(p), 4}):
            got = _quad_3xtf32(y, mat, group=group)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
            np.testing.assert_allclose(got, plain.numpy(), rtol=1e-5,
                                       atol=0)
        yb, lb = _tf32(y), _tf32(mat)
        tf32_only = -0.5 * np.sum((yb.astype(np.float64) @ lb) ** 2, -1)
        assert np.max(np.abs(tf32_only / want - 1)) > 1e-4


@pytest.mark.parametrize("p,plan", [(117, "ws"), (118, (2, 64)),
                                    (128, (2, 64)), (144, (2, 72)),
                                    (200, (4, 56)), (257, (8, 40)),
                                    (296, (8, 40)), (297, None)])
def test_cluster_plan_on_an_h100(p, plan):
    """The wide kernel's plan with an H100's shared memory, as the
    emulation above slices the product: the warp-specialised block to
    P = 117, then two blocks of 64 columns a cluster at P = 118 and 128,
    eight blocks of 40 columns at P = 257 (the eighth slice past P), none
    past P = 296 (``test_wide_layout_matches_the_emulated_plan_on_card``
    holds the library's own plan to it)."""
    if plan == "ws":
        assert _ws_plan(p) == 128 and _wide_slices(p) == 1
        assert _wide_group(p) == 1
        return
    assert _ws_plan(p) is None and _cluster_plan(p) == plan
    if plan:
        c, nsub = plan
        assert nsub % 8 == 0 and c * nsub >= p
        assert _wide_width(p) == nsub and _wide_slices(p) == c


@pytest.mark.parametrize("slices", [2, 4, 8])
def test_3xtf32_cluster_slices_keep_float32_accuracy(slices):
    """At P = 257 the row sums taken over the column slices of a cluster of
    2, 4 or 8 blocks (each block's squares over its slice, then the partials
    in rank order) hold rtol = 1e-5 against float64 and the plain float32
    forward, with the kernel's grouping of k-steps and with one k-step a
    partial."""
    p = 257
    L = _prec_chol(p, seed=p)
    _, y = _inputs(256, p, seed=p + slices)
    want = _logp_np(y, L).astype(np.float64)
    plain = GaussianTarget(L, device="cpu")(torch.from_numpy(y)).numpy()
    width = -(-(-(-p // slices)) // 8) * 8
    for group in (1, 4):
        got = _quad_3xtf32(y, L, width=width, group=group, slices=slices)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
        np.testing.assert_allclose(got, plain, rtol=1e-5, atol=0)


def test_3xtf32_partials_keep_float32_accuracy_at_large_k():
    """At P = 1000 (the K-split route: four k-slices of 256 k-rows) the
    kernel's product still holds rtol = 1e-5 against float64 and the plain
    float32 forward, because each group of k-steps' products goes into a
    zeroed partial; accumulated into S itself in one pass over K, each
    mma's truncated sum is a bias toward zero that grows with K and misses
    it."""
    p = 1000
    L = _prec_chol(p, seed=p)
    _, y = _inputs(256, p, seed=p)
    want = _logp_np(y, L).astype(np.float64)
    plain = GaussianTarget(L, device="cpu")(torch.from_numpy(y)).numpy()
    for group in (1, 4):
        # the Y-streamed kernel's partial a k-step, and the grouping of four
        # k-steps the warp-specialised kernel uses at P <= 128, held here at
        # the largest K
        got = _quad_3xtf32(y, L, group=group)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
        np.testing.assert_allclose(got, plain, rtol=1e-5, atol=0)
    in_s = _quad_3xtf32(y, L, partials=False, kslices=[(0, p)])
    assert np.max(np.abs(in_s / want - 1)) > 1e-5


@pytest.mark.parametrize("p", [297, 384, 512, 577, 784])
def test_3xtf32_streamed_route_keeps_float32_accuracy(p):
    """On the L-streamed route (P = 297–784 on an H100) the product's
    partials of an L stage's k-steps (four; two at P = 577 and 784), each
    consumer's squares over its half of every panel and their sum hold
    rtol = 1e-5 against float64 and the plain float32 forward, with a full
    L (its upper triangle too), as do partials of one k-step; TF32 alone
    misses it."""
    assert _wide_route(p) == "stream" and _wide_group(p) == (
        4 if p <= 512 else 2)
    L = _prec_chol(p, seed=p)
    L = (L + np.triu(_prec_chol(p, seed=p + 1), 1) * 0.1).astype(np.float32)
    _, y = _inputs(64, p, seed=p)
    want = _logp_np(y, L).astype(np.float64)
    plain = GaussianTarget(L, device="cpu")(torch.from_numpy(y)).numpy()
    for group in (1, 2, 4):
        got = _quad_3xtf32(y, L, group=group)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
        np.testing.assert_allclose(got, plain, rtol=1e-5, atol=0)
    yb, lb = _tf32(y), _tf32(L)
    tf32_only = -0.5 * np.sum((yb.astype(np.float64) @ lb) ** 2, -1)
    assert np.max(np.abs(tf32_only / want - 1)) > 1e-5


@pytest.mark.parametrize("p,plan", [(296, None), (297, (80, 4, 3, 17)),
                                    (300, (80, 4, 3, 17)),
                                    (384, (64, 4, 4, 10)),
                                    (512, (64, 4, 3, 7)),
                                    (576, (72, 4, 2, 7)),
                                    (577, (80, 2, 3, 4)),
                                    (704, (72, 2, 2, 3)),
                                    (784, (56, 2, 2, 2)), (785, None)])
def test_stream_plan_on_an_h100(p, plan):
    """The L-streamed route's plan with an H100's shared memory: it takes
    P = 297 (the cluster route's end) to 784 (the widest whose 64-row Y
    tile fits beside two slots of its ring), with N = 80 at P = 297 (two
    panels of 160 columns), 64 at 384 and 512 (panels of 128, no padding),
    72 at 704, 56 at 784; four slots of L stages of four k-steps at P = 384,
    three at 297 and 512, stages of two k-steps at 577 (a slot of four does
    not fit twice beside the Y tile); walker stages of 17 rows at 297, 7 at
    512, 2 at 784; the K-split route takes P = 785."""
    route = {296: "cluster", 785: "ksplit"}.get(p, "stream")
    assert _wide_route(p) == route
    if plan is not None:
        assert _stream_plan(p) == plan
        assert _wide_width(p) == plan[0] and _wide_consumers(p) == 2
    elif p > 296:
        assert _stream_plan(p) is None


def _stream_stages(L, nsub, kc, cols=None):
    """The L-streamed route's scratch as its prologue (``split_l_stages``)
    writes it for stages of kc k-steps: for each panel of ``cols`` columns
    (2·nsub by default; the K-split route's panels are nsub) and each chunk
    of 8·kc k-rows, the big half (L rounded to TF32) then the small half
    (the exact float32 remainder), each n-block of 8 columns holding its
    k-rows at (k / 4)·32 + (n % 8)·4 + k % 4, the rows of each k-step in
    the A fragment's order (row 2t at position t, 2t + 1 at t + 4), zeros
    past P."""
    p, rows = L.shape[0], 8 * kc
    cols = cols or 2 * nsub
    kp = -(-p // rows) * rows
    panels = -(-p // cols)
    full = np.zeros((kp, panels * cols), np.float32)
    full[:p, :p] = L
    big = _tf32(full)
    small = full - big
    w = np.arange(8 * rows)
    kl, r = (w >> 5) * 4 + (w & 3), (w >> 2) & 7
    j = kl & 7
    k = (kl & ~7) + np.where(j < 4, 2 * j, 2 * (j - 4) + 1)
    return np.concatenate([
        half[ch * rows + k, pn * cols + nb * 8 + r]
        for pn in range(panels) for ch in range(kp // rows)
        for half in (big, small) for nb in range(cols // 8)])


@pytest.mark.parametrize("p", [297, 300, 577, 784])
def test_stream_stages_feed_the_product_in_wgmma_order(p):
    """L's split stages read as the L-streamed kernel's wgmma read them
    (stages of kc k-steps: consumer c's B at byte c·(N/8)·256·kc of a
    stage's half, k-step i at 256·i, core matrices 128 B apart in K and
    256·kc B apart in N, a core matrix's row n and column k at
    16·(n % 8) + 4·(k % 4)), each k-step's A the Y tile's columns in the
    fragment's order, big + small summed exactly: every panel's columns of
    Y·L, zeros past P."""
    nsub, kc = _stream_plan(p)[:2]
    rows, sbo = 8 * kc, 256 * kc
    L = _prec_chol(p, seed=p)
    L = (L + np.triu(_prec_chol(p, seed=p + 1), 1) * 0.1).astype(np.float32)
    stages = _stream_stages(L, nsub, kc)
    kp, panels = -(-p // rows) * rows, -(-p // (2 * nsub))
    y = np.random.default_rng(p).normal(size=(8, kp))
    y[:, p:] = 0.0
    half = rows * 2 * nsub
    kk, n = np.arange(8)[:, None], np.arange(nsub)[None, :]
    a_cols = np.where(kk[:, 0] < 4, 2 * kk[:, 0], 2 * (kk[:, 0] - 4) + 1)
    s = np.zeros((8, panels * 2 * nsub))
    for pn in range(panels):
        for ch in range(kp // rows):
            st = stages[(pn * (kp // rows) + ch) * 2 * half:][:2 * half]
            for c in range(2):
                for i in range(kc):
                    at = (c * (nsub // 8) * sbo + 256 * i + (n // 8) * sbo
                          + (kk // 4) * 128 + (n % 8) * 16
                          + (kk % 4) * 4) // 4
                    b = st[at].astype(np.float64) + st[half + at]
                    cols = pn * 2 * nsub + c * nsub + np.arange(nsub)
                    s[:, cols] += y[:, rows * ch + 8 * i + a_cols] @ b
    want = y[:, :p] @ L.astype(np.float64)
    np.testing.assert_allclose(s[:, :p], want, rtol=1e-12, atol=1e-12)
    assert not s[:, p:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("p", [297, 512, 577, 784])
def test_stream_prologue_matches_its_emulation_on_card(cuda_device, p):
    """The L-streamed route's prologue (``fs.wide_split_l``, the kernel
    ``split_l_stages`` alone) writes L's split stages bit for bit as
    ``_stream_stages`` lays them out, with the layout's N and scratch
    bytes."""
    layout = fs.wide_layout(p, cuda_device)
    assert fs.WIDE_ROUTES[layout["route"]] == "wgmma, L streamed"
    L = _prec_chol(p, seed=p)
    L = (L + np.triu(_prec_chol(p, seed=p + 1), 1) * 0.1).astype(np.float32)
    got = fs.wide_split_l(torch.from_numpy(L).to(cuda_device))
    torch.cuda.synchronize()
    want = _stream_stages(L, layout["wgmma_n"], layout["l_ksteps"])
    assert got.numel() * 4 == layout["scratch_bytes"] == want.size * 4
    assert np.array_equal(got.cpu().numpy().view(np.uint32),
                          want.view(np.uint32))

def _full_l(p):
    """A precision factor with an upper triangle too (the kernel takes the
    whole matrix): the lower factor plus a tenth of its transpose above the
    diagonal."""
    L = _prec_chol(p, seed=p)
    return (L + 0.1 * np.triu(L.T, 1)).astype(np.float32)


@pytest.mark.parametrize("p", [785, 800, 1000, 1536, KSPLIT_WIDEST])
def test_3xtf32_ksplit_route_keeps_float32_accuracy(p):
    """On the K-split route (P = 785 to ``KSPLIT_WIDEST`` on an H100) each
    block's product over its k-slice (a partial for each L stage's k-steps,
    four or two), the slices' sums added in rank order and the squares
    over panels of N columns hold rtol = 1e-5 against float64 and the plain
    float32 forward, with a full L, as do partials of one k-step; TF32
    alone misses it."""
    assert _wide_route(p) == "ksplit" and _wide_consumers(p) == 1
    assert len(_wide_kslices(p)) == _ksplit_plan(p)[0]
    L = _full_l(p)
    _, y = _inputs(32, p, seed=p)
    want = _logp_np(y, L).astype(np.float64)
    plain = GaussianTarget(L, device="cpu")(torch.from_numpy(y)).numpy()
    for group in sorted({1, _wide_group(p)}):
        got = _quad_3xtf32(y, L, group=group)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
        np.testing.assert_allclose(got, plain, rtol=1e-5, atol=0)
    yb, lb = _tf32(y), _tf32(L)
    tf32_only = -0.5 * np.sum((yb.astype(np.float64) @ lb) ** 2, -1)
    assert np.max(np.abs(tf32_only / want - 1)) > 1e-5


@pytest.mark.parametrize("p,plan", [(784, "stream"),
                                    (785, (4, 72, 4, 4, 10)),
                                    (1000, (4, 72, 4, 3, 8)),
                                    (1024, (4, 64, 4, 3, 7)),
                                    (1025, (8, 80, 4, 5, 15)),
                                    (1280, (8, 80, 4, 5, 15)),
                                    (1536, (8, 64, 4, 5, 10)),
                                    (KSPLIT_WIDEST, (8, 48, 2, 2, 2)),
                                    (KSPLIT_WIDEST + 1, None)])
def test_ksplit_plan_on_an_h100(p, plan):
    """The K-split route's plan with an H100's shared memory: it takes every
    P from 785 (where the L-streamed route's Y tile no longer fits) to
    ``KSPLIT_WIDEST``: clusters of 4 blocks to P = 1024 (N = 72 at 785 and
    1000, four and three slots of L stages of four k-steps; a Y slice of
    7 chunks of 32 k-rows at 785, split 7/6/6/6), where three slots fit
    with N >= 64; clusters of 8 from 1025 (N = 80 to 1280); stages of two
    k-steps and N = 48 only near the widest P; route 6 (Y and L streamed)
    past it."""
    if plan == "stream":
        assert _wide_route(p) == "stream" and _ksplit_plan(p) is not None
        return
    assert _wide_route(p) == ("ksplit" if plan else "yl")
    assert _ksplit_plan(p) == plan
    if plan is None:
        assert all(_ksplit_plan(q) for q in range(785, p))
        return
    c, nsub, kc = plan[:3]
    assert _wide_width(p) == nsub and _wide_group(p) == kc
    assert _wide_slices(p) == 1 and _wide_consumers(p) == 1
    bounds = _ksplit_slices(p)
    assert len(bounds) == c and bounds[0][0] == 0 and bounds[-1][1] == p
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    chunks = [-(-(k1 - k0) // (8 * kc)) for k0, k1 in bounds]
    assert max(chunks) - min(chunks) <= 1 and chunks == sorted(chunks)[::-1]
    if p == 785:
        assert bounds == [(0, 224), (224, 416), (416, 608), (608, 785)]


@pytest.mark.parametrize("p", [785, 1000, 1025, 1536])
def test_ksplit_stages_feed_each_block_in_wgmma_order(p):
    """L's split stages in panels of N columns (``_stream_stages`` with
    ``cols`` = N) read as block r of the K-split route's cluster reads them:
    stage pn·chunks + c0(r) + ch for its chunks ch of each panel pn in
    turn, both consumers' B at byte 0 of a stage's half, k-step i at
    256·i, core matrices 128 B apart in K and 256·kc B apart in N, a core
    matrix's row n and column k at 16·(n % 8) + 4·(k % 4), each k-step's A
    the Y slice's columns in the fragment's order, big + small summed
    exactly: the blocks' products summed over the cluster are every
    panel's columns of Y·L, zeros past P."""
    _, nsub, kc = _ksplit_plan(p)[:3]
    rows, sbo = 8 * kc, 256 * kc
    L = _full_l(p)
    stages = _stream_stages(L, nsub, kc, cols=nsub)
    chunks, panels = -(-p // rows), -(-p // nsub)
    y = np.random.default_rng(p).normal(size=(8, chunks * rows))
    y[:, p:] = 0.0
    half = rows * nsub
    kk, n = np.arange(8)[:, None], np.arange(nsub)[None, :]
    a_cols = np.where(kk[:, 0] < 4, 2 * kk[:, 0], 2 * (kk[:, 0] - 4) + 1)
    s = np.zeros((8, panels * nsub))
    for k0, k1 in _ksplit_slices(p):
        for pn in range(panels):
            for ch in range(-(-(k1 - k0) // rows)):
                st = stages[(pn * chunks + k0 // rows + ch) * 2 * half:]
                for i in range(kc):
                    at = (256 * i + (n // 8) * sbo + (kk // 4) * 128
                          + (n % 8) * 16 + (kk % 4) * 4) // 4
                    b = st[at].astype(np.float64) + st[half + at]
                    s[:, pn * nsub + np.arange(nsub)] += (
                        y[:, k0 + rows * ch + 8 * i + a_cols] @ b)
    want = y[:, :p] @ L.astype(np.float64)
    np.testing.assert_allclose(s[:, :p], want, rtol=1e-12, atol=1e-12)
    assert not s[:, p:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("p", [785, 1000, 1025, 1536, KSPLIT_WIDEST])
def test_ksplit_prologue_matches_its_emulation_on_card(cuda_device, p):
    """The K-split route's prologue (``fs.wide_split_l``: ``split_l_stages``
    with panels of N columns) writes L's split stages bit for bit as
    ``_stream_stages`` lays them out, with the layout's N and scratch
    bytes."""
    layout = fs.wide_layout(p, cuda_device)
    assert fs.WIDE_ROUTES[layout["route"]] == "wgmma, K split over a cluster"
    L = _full_l(p)
    got = fs.wide_split_l(torch.from_numpy(L).to(cuda_device))
    torch.cuda.synchronize()
    want = _stream_stages(L, layout["wgmma_n"], layout["l_ksteps"],
                          cols=layout["wgmma_n"])
    assert got.numel() * 4 == layout["scratch_bytes"] == want.size * 4
    assert np.array_equal(got.cpu().numpy().view(np.uint32),
                          want.view(np.uint32))


@pytest.mark.parametrize("p,route,plan", [
    (KSPLIT_WIDEST, "ksplit", None),
    (KSPLIT_WIDEST + 1, "yl", H100_SMEM),
    (3000, "yl", H100_SMEM),
    (4096, "yl", H100_SMEM),
    (8192, "yl", H100_SMEM),
    (16384, "yl", H100_SMEM),
    (3000, "yl", 120 * 1024),
    (3000, "mma", 96 * 1024)])
def test_yl_plan_on_an_h100(p, route, plan):
    """Route 6's plan: past ``KSPLIT_WIDEST`` with an H100's shared memory
    every P takes it, with no cap (the same block at every P: clusters of
    4 × 2 blocks, panels of 128 columns, stages of four k-steps, four slots
    of a Y stage beside an L stage); with 120 KB a block it still fits two
    slots; only a block that cannot hold two slots (96 KB) leaves the
    mma.sync kernel."""
    optin = plan or H100_SMEM
    assert _wide_route(p, optin) == route
    if route == "ksplit":
        assert _ksplit_plan(p) is not None and _yl_plan(p) is not None
        return
    if route == "mma":
        assert _yl_plan(p, optin) is None
        return
    assert _yl_plan(p, optin) == (
        *YL_GROUPS, YL_N, YL_KC, 4 if optin == H100_SMEM else 2)
    if optin == H100_SMEM:
        assert _wide_width(p) == YL_N and _wide_group(p) == YL_KC
        assert _wide_colgroups(p) == 2 and _wide_kslices(p) == [(0, p)]
        assert _wide_slices(p) == 1 and _wide_consumers(p) == 1


@pytest.mark.parametrize("p", [3000])
def test_3xtf32_yl_route_keeps_float32_accuracy(p):
    """On route 6 (past ``KSPLIT_WIDEST`` on an H100) the product over all
    of K (a partial for each stage's four k-steps), the squares of panels
    of 128 columns taken by two column groups (panels g, g + 2, …) and the
    groups' sums added in rank order hold rtol = 1e-5 against float64 and
    the plain float32 forward, with a full L, as do partials of one k-step
    and one column group; TF32 alone misses it."""
    assert _wide_route(p) == "yl" and _wide_colgroups(p) == 2
    L = _full_l(p)
    _, y = _inputs(6, p, seed=p)
    want = _logp_np(y, L).astype(np.float64)
    plain = GaussianTarget(L, device="cpu")(torch.from_numpy(y)).numpy()
    for group, colgroups in ((YL_KC, None), (1, 1)):
        got = _quad_3xtf32(y, L, group=group, colgroups=colgroups)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
        np.testing.assert_allclose(got, plain, rtol=1e-5, atol=0)
    yb, lb = _tf32(y), _tf32(L)
    tf32_only = -0.5 * np.sum((yb.astype(np.float64) @ lb) ** 2, -1)
    assert np.max(np.abs(tf32_only / want - 1)) > 1e-5


def _yl_buffer(y, kc=YL_KC):
    """Route 6's Y buffer of a 128-row tile as its formation writes it
    (``yl_at``): stage by stage of 8·kc k-rows, a row's 8·kc floats
    contiguous, its k-steps of 8 swizzled by 8·(row % 4), zeros past P."""
    rows, p = y.shape
    krows = 8 * kc
    kp = -(-p // krows) * krows
    buf = np.zeros(kp // krows * rows * krows)
    r = np.arange(rows)[:, None]
    k = np.arange(p)[None, :]
    buf[(k // krows) * rows * krows + r * krows
        + ((k % krows) ^ ((r & 3) << 3))] = y
    return buf


@pytest.mark.parametrize("p", [KSPLIT_WIDEST + 1, 3003])
def test_yl_stages_feed_the_product_in_wgmma_order(p):
    """Route 6's stages read as its consumers read them: the Y stage of
    chunk ch (``_yl_buffer``) with thread t of row r's quad taking the
    float2 at (8·i ^ 8·(r % 4)) + 2t of the row's 32 floats for k-step i
    (the A fragment's positions t and t + 4), the L stage of panel pn and
    chunk ch (``_stream_stages`` with ``cols`` = 128: both consumers' B at
    byte 0 of a stage's half, k-step i at 256·i, core matrices 128 B apart
    in K and 1024 B apart in N), big + small summed exactly; column group g
    of the two takes panels g, g + 2, …: the panels' products are every
    column of Y·L, zeros past P."""
    kc, rows, sbo = YL_KC, 8 * YL_KC, 256 * YL_KC
    # any full matrix: the layout does not care what L holds
    L = np.random.default_rng(p + 1).normal(size=(p, p)).astype(np.float32)
    chunks, panels = -(-p // rows), -(-p // YL_N)
    half = rows * YL_N
    stages = _stream_stages(L, YL_N, kc, cols=YL_N).reshape(
        panels, chunks, 2, half)
    y = np.random.default_rng(p).normal(size=(128, p))
    ys = _yl_buffer(y).reshape(chunks, 128, rows)
    # A in the fragments' order (chunk, k-step i, position): position t
    # holds k-row 2t of the k-step, t + 4 k-row 2t + 1
    r = np.arange(128)[:, None, None]
    i, t = np.arange(kc)[None, :, None], np.arange(4)[None, None, :]
    at = ((8 * i) ^ ((r & 3) << 3)) + 2 * t
    a = np.concatenate([ys[:, r, at], ys[:, r, at + 1]], axis=-1)
    a = a.transpose(1, 0, 2, 3).reshape(128, chunks * rows)
    kk, n = np.arange(8)[:, None], np.arange(YL_N)[None, :]
    b_at = (256 * np.arange(kc)[:, None, None] + ((n // 8) * sbo
            + (kk // 4) * 128 + (n % 8) * 16 + (kk % 4) * 4)[None]) // 4
    s = np.zeros((128, panels * YL_N))
    for g in range(YL_GROUPS[1]):
        for pn in range(g, panels, YL_GROUPS[1]):
            st = stages[pn]
            b = (st[:, 0, b_at].astype(np.float64) + st[:, 1, b_at])
            s[:, pn * YL_N:(pn + 1) * YL_N] = a @ b.reshape(chunks * rows,
                                                            YL_N)
    want = y @ L.astype(np.float64)
    np.testing.assert_allclose(s[:, :p], want, rtol=1e-9, atol=1e-9)
    assert not s[:, p:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("p", [KSPLIT_WIDEST + 1, 3000, 4096])
def test_yl_prologue_matches_its_emulation_on_card(cuda_device, p):
    """Route 6's prologue (``fs.wide_split_l``: ``split_l_stages`` with
    panels of 128 columns, padded to an even count) writes L's split stages
    bit for bit as ``_stream_stages`` lays them out, and zeros in the padded
    panel."""
    layout = fs.wide_layout(p, cuda_device)
    assert fs.WIDE_ROUTES[layout["route"]] == "wgmma, Y and L streamed"
    L = _full_l(p)
    got = fs.wide_split_l(torch.from_numpy(L).to(cuda_device))
    torch.cuda.synchronize()
    want = _stream_stages(L, YL_N, YL_KC, cols=YL_N)
    panels = -(-(-(-p // YL_N)) // 2) * 2
    chunks = -(-p // (8 * YL_KC))
    assert got.numel() * 4 == panels * chunks * (YL_SLOT - 4 * 128 * 32)
    assert layout["scratch_bytes"] > got.numel() * 4
    got = got.cpu().numpy()
    assert np.array_equal(got[:want.size].view(np.uint32),
                          want.view(np.uint32))
    assert not got[want.size:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("p,n", [(1000, 1000), (KSPLIT_WIDEST + 1, 1000),
                                 (3000, 4096)])
def test_forced_mma_kernel_matches_reference_on_card(cuda_device, p, n):
    """The mma.sync kernel, which the dispatch no longer reaches on an H100,
    launched through ``fs.wide_forced_mma`` (route 2, Y streamed, at these
    widths): held to the plain version, counting no launch."""
    target, args, key = _wide_case(cuda_device, n, p, "mid", seed=p + 11)
    before = dict(fs.LAUNCHES)
    k_out = fs.wide_forced_mma(*args, key, target.prec_chol)
    torch.cuda.synchronize()
    assert fs.LAUNCHES == before
    _assert_near_reference(target, args, key, k_out)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [65, 66, 67, 100, 117, 118, 128, 200, 257,
                               296, 297, 298, 299, 300, 384, 512, 577, 784,
                               785, 786, 787, 788, 1000, 1025, 1536,
                               KSPLIT_WIDEST, KSPLIT_WIDEST + 1, 3000])
def test_wide_kernel_unaligned_row_shards_on_card(cuda_device, p):
    """Row shards that start at rows which are not multiples of 4 (so at
    P = 65–67 the runs of X start off a 16-B boundary, their heads and
    tails taken by 4-B copies) and whose partner runs wrap within a tile
    equal one launch under ``torch.equal``; the launch holds to its plain
    version."""
    n = 4003
    target, args, key = _wide_case(cuda_device, n, p, "mid", seed=p + 3)
    act, lp, oth, shift = args
    whole = fs.fused_stretch_half(*args, key=key, logp_fn=target)
    bounds = [0, 1001, 2002, 3005, n]
    parts = [fs.fused_stretch_half(act[r0:r1], lp[r0:r1], oth, shift,
                                   key=key, logp_fn=target, row0=r0)
             for r0, r1 in zip(bounds[:-1], bounds[1:])]
    torch.cuda.synchronize()
    for k in range(3):
        assert torch.equal(torch.cat([q[k] for q in parts]), whole[k])
    _assert_near_reference(target, args, key, whole)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [65, 100, 117, 118, 128, 200, 257, 296, 297,
                               298, 384, 512, 577, 784, 785, 786, 1000, 1025,
                               1536, KSPLIT_WIDEST, KSPLIT_WIDEST + 1, 3000])
def test_wide_kernel_ragged_tiles_and_nan_rows_on_card(cuda_device, p):
    """A launch whose blocks (or clusters) walk several tiles each and whose
    last tile is ragged (n = 64·301 + 17 rows over one block an SM; on the
    L-streamed route some blocks of a cluster have no last tile and still
    take part in its stages of L; on the K-split route a cluster's last
    tile of 128 rows holds 81, and on route 6 too, whose last cluster has
    a row group with no tile that still takes part in its stages), with
    lp_old = −inf rows (which accept) and NaN rows of X (whose proposals are
    NaN: they reject and keep their row): held to the plain version."""
    n = 64 * 301 + 17
    target, args, key = _wide_case(cuda_device, n, p, "last", seed=p + 5)
    act, lp, oth, shift = args
    nan_rows = torch.zeros(n, dtype=torch.bool, device=cuda_device)
    nan_rows[3::53] = True
    nan_rows[5::61] = False
    act[nan_rows, p // 2] = torch.nan
    k_out = fs.fused_stretch_half(*args, key=key, logp_fn=target)
    torch.cuda.synchronize()
    assert bool((k_out[2][nan_rows] == 0).all())
    assert torch.equal(k_out[0][nan_rows].isnan(), act[nan_rows].isnan())
    assert torch.equal(k_out[1][nan_rows], lp[nan_rows])
    _assert_near_reference(target, args, key, k_out, skip=nan_rows)


@pytest.mark.cuda
def test_wide_layout_matches_the_emulated_plan_on_card(cuda_device):
    """The library's route at every P from 100 to 4096 on this card is the
    one ``_ws_plan``, ``_cluster_plan``, ``_stream_plan``, ``_ksplit_plan``
    and ``_yl_plan`` emulate (with the card's own shared memory): the
    warp-specialised block with its wgmma N where it fits, else the cluster
    route with its blocks a cluster and its columns a block where the
    emulation finds a plan, else the L-streamed route with its N, ring and
    scratch, else the K-split route with its cluster, N, ring and scratch,
    else route 6 with its cluster, N, ring and scratch (L's stages and a
    Y buffer for each row group of each cluster the device holds), the
    mma.sync kernel nowhere; and the device holds at least one cluster of
    each."""
    optin = torch.cuda.get_device_properties(
        cuda_device).shared_memory_per_block_optin
    for p in range(100, 4097):
        layout = fs.wide_layout(p, cuda_device)
        if _ws_plan(p, optin):
            assert fs.WIDE_ROUTES[layout["route"]] == (
                "wgmma, warp-specialised"), p
            assert layout["wgmma_n"] == _ws_plan(p, optin), p
            continue
        plan = _cluster_plan(p, optin)
        stream = _stream_plan(p, optin)
        if plan is None and stream is not None:
            assert fs.WIDE_ROUTES[layout["route"]] == "wgmma, L streamed", p
            nsub, kc = stream[:2]
            assert (layout["wgmma_n"], layout["l_ksteps"], layout["stages"],
                    layout["stage_rows"], layout["block_walkers"]) == (
                        *stream, 64), p
            # panels × chunks × a stage's 2·4·8kc·2N bytes
            assert layout["scratch_bytes"] == (
                -(-p // (2 * nsub)) * -(-p // (8 * kc)) * 128 * kc * nsub), p
            assert layout["cluster"] in (1, 2, 4)
            assert layout["active_clusters"] >= 1
            continue
        ksplit = _ksplit_plan(p, optin)
        if plan is None and ksplit is not None:
            assert fs.WIDE_ROUTES[layout["route"]] == (
                "wgmma, K split over a cluster"), p
            c, nsub, kc = ksplit[:3]
            assert (layout["cluster"], layout["wgmma_n"], layout["l_ksteps"],
                    layout["stages"], layout["stage_rows"],
                    layout["block_walkers"]) == (*ksplit, 128), p
            # panels × chunks × a stage's 2·4·8kc·N bytes
            assert layout["scratch_bytes"] == (
                -(-p // nsub) * -(-p // (8 * kc)) * 64 * kc * nsub), p
            assert layout["active_clusters"] >= 1
            continue
        yl = _yl_plan(p, optin)
        if plan is None and yl is not None:
            assert fs.WIDE_ROUTES[layout["route"]] == (
                "wgmma, Y and L streamed"), p
            rg, cg, nsub, kc, slots = yl
            assert (layout["cluster"], layout["wgmma_n"], layout["l_ksteps"],
                    layout["stages"], layout["stage_rows"],
                    layout["block_walkers"]) == (
                        rg * cg, nsub, kc, slots, 128, 128), p
            chunks = -(-p // (8 * kc))
            # panels (an even count) × chunks × a stage's 2·4·8kc·N bytes,
            # then the Y buffers: clusters × row groups × chunks × 128 rows
            # × 8kc k-rows × 4 bytes
            assert layout["scratch_bytes"] == (
                -(-(-(-p // nsub)) // cg) * cg * chunks * 64 * kc * nsub
                + layout["active_clusters"] * rg * chunks * 128 * 32 * kc), p
            assert layout["active_clusters"] >= 1
            continue
        if plan is None:
            assert fs.WIDE_ROUTES[layout["route"]].startswith("mma.sync"), p
            assert layout["cluster"] == 1 and layout["scratch_bytes"] == 0
            continue
        assert fs.WIDE_ROUTES[layout["route"]] == (
            "wgmma, thread-block cluster"), p
        assert (layout["cluster"], layout["wgmma_n"],
                layout["block_walkers"]) == (*plan, 64), p
        assert layout["active_clusters"] >= 1


def _fake_cuda_half(monkeypatch, target, p):
    """``fs.fused_stretch_half`` on CUDA tensors that hold no memory (a
    FakeTensorMode): which launchers the dispatch reaches, in order, and
    what it raises when the launch cannot happen."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    called = []

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            called.append(name)
            return fn(*args, **kwargs)
        monkeypatch.setattr(fs, name, wrapped)

    for name in ("_launch_fused", "_launch_wide", "stretch_propose",
                 "stretch_accept"):
        spy(name, getattr(fs, name))
    with FakeTensorMode():
        if isinstance(target, GaussianTarget):
            target.prec_chol = torch.empty((p, p), device="cuda")
        x = torch.empty((256, p), device="cuda")
        lp = torch.empty((256,), device="cuda")
        shift = torch.zeros((1,), dtype=torch.int32, device="cuda")
        with pytest.raises(RuntimeError) as err:
            fs.fused_stretch_half(x, lp, x, shift, key=5, logp_fn=target)
    return called, err


@pytest.mark.parametrize("p,route", [(16, "_launch_fused"),
                                     (17, "_launch_wide"),
                                     (64, "_launch_wide"),
                                     (65, "_launch_wide"),
                                     (100, "_launch_wide"),
                                     (118, "_launch_wide"),
                                     (128, "_launch_wide"),
                                     (257, "_launch_wide"),
                                     (296, "_launch_wide"),
                                     (297, "_launch_wide"),
                                     (384, "_launch_wide"),
                                     (512, "_launch_wide"),
                                     (800, "_launch_wide"),
                                     (1000, "_launch_wide"),
                                     (1536, "_launch_wide"),
                                     (3000, "_launch_wide"),
                                     (4096, "_launch_wide"),
                                     (100, "stretch_propose")])
def test_cuda_dispatch_routes_without_card(monkeypatch, p, route):
    """On a CUDA tensor a GaussianTarget of P <= MAX_P (16) goes to the fused
    kernel, a wider one to the wide kernel (whose library picks the route:
    on an H100 the warp-specialised block to P = 117, the cluster route,
    index 3 of ``fs.WIDE_ROUTES``, to 296, the L-streamed route, index 4,
    to 784, the K-split route, index 5, to ``KSPLIT_WIDEST``, route 6, Y
    and L streamed, past it; the mma.sync kernel, indices 1 and 2, only on
    a device whose blocks no wgmma plan fits), any other logp to the split
    pair;
    without a card the launch raises (here the kernels cannot be built) and
    no other route is tried: a wide GaussianTarget never reaches the split
    kernels, and nothing counts a launch."""
    if torch.cuda.is_available():
        pytest.skip("checks the dispatch where no kernel can launch")
    L = np.eye(p, dtype=np.float32)
    target = (GaussianTarget(L, device="cpu") if route != "stretch_propose"
              else (lambda x: -0.5 * torch.sum(x * x, -1)))
    assert fs.WIDE_ROUTES[3] == "wgmma, thread-block cluster"
    assert fs.WIDE_ROUTES[4] == "wgmma, L streamed"
    assert fs.WIDE_ROUTES[5] == "wgmma, K split over a cluster"
    assert fs.WIDE_ROUTES[6] == "wgmma, Y and L streamed"
    before = dict(fs.LAUNCHES)
    called, err = _fake_cuda_half(monkeypatch, target, p)
    assert called == [route]
    assert "nvcc" in str(err.value) or "CUDA" in str(err.value)
    assert fs.LAUNCHES == before


def test_device_dispatch_without_card():
    """Off the CPU the wrapper takes a kernel or raises, never the plain
    version: on a device other than CUDA (meta tensors stand in for one
    here) both a non-Gaussian logp and a GaussianTarget raise before any
    launch."""
    x = torch.empty((4, 2), device="meta")
    lp = torch.empty((4,), device="meta")
    before = dict(fs.LAUNCHES)
    with pytest.raises(RuntimeError, match="no fused stretch path"):
        fs.fused_stretch_half(x, lp, x, lp, lp, lp, logp_fn=lambda t: t)
    target = GaussianTarget(np.eye(2, dtype=np.float32), device="meta")
    with pytest.raises(RuntimeError, match="no fused stretch path"):
        fs.fused_stretch_half(x, lp, x, lp, lp, lp, logp_fn=target)
    assert fs.LAUNCHES == before


def _jax_split_half(act, oth, lp, jax_logp, seed):
    """JAX's Pallas kernel in interpret mode on any logp (traced into the
    kernel's body); returns its shift and outputs."""
    import jax
    import jax.numpy as jnp
    from mcmcpp_tpu.ops.pallas_stretch import fused_stretch_half

    key = jax.random.key(seed)
    n = act.shape[0]
    shift = int(jax.random.randint(jax.random.split(key)[1], (), 0, n,
                                   dtype=jnp.int32))
    out = fused_stretch_half(key, jnp.asarray(act), jnp.asarray(lp),
                             jnp.asarray(oth), logp_fn=jax.vmap(jax_logp),
                             tile=32, interpret=True)
    return shift, [np.asarray(o) for o in out]


@pytest.mark.parametrize("name", ["rosenbrock", "logistic_regression",
                                  "neal_funnel"])
def test_split_references_match_pallas_interpret(name):
    """The split path's plain twins (propose, the torch logp, accept)
    against the Pallas kernel with the same target traced into it; the
    logistic target's data reach the kernel as hoisted closure constants."""
    from mcmcpp_tpu import models as jm
    from mcmcpp_tpu_torch.models import targets as tm

    jt = {"rosenbrock": lambda: jm.rosenbrock(),
          "logistic_regression": lambda: jm.logistic_regression(dim=4),
          "neal_funnel": lambda: jm.neal_funnel(5)}[name]()
    tt = {"rosenbrock": lambda: tm.rosenbrock(),
          "logistic_regression": lambda: tm.logistic_regression(
              dim=4, device="cpu"),
          "neal_funnel": lambda: tm.neal_funnel(5)}[name]()
    n, p = 64, tt.dim
    act, oth = _inputs(n, p, seed=3 + p)
    lp = tt(torch.from_numpy(act)).numpy()
    shift, (j_act, j_lp, j_acc) = _jax_split_half(act, oth, lp, jt.logp,
                                                  seed=p)
    floor = torch.full((n,), FLOOR)
    args = (torch.from_numpy(act), torch.from_numpy(oth),
            torch.tensor([shift], dtype=torch.int32))
    proposal, log_factor = fs.stretch_propose_reference(*args, floor)
    t_act, t_lp, t_acc = fs.stretch_accept_reference(
        args[0], proposal, torch.from_numpy(lp), tt(proposal), log_factor,
        floor.clone())
    np.testing.assert_array_equal(t_acc.numpy(), j_acc)
    assert 0 < int(t_acc.sum()) < n, "inputs must give accepts and rejects"
    np.testing.assert_allclose(t_act.numpy(), j_act, rtol=RTOL, atol=ATOL)
    # float32 logps of two libraries' sums (a 300-row dot product for the
    # logistic target): 1e-5 relative
    np.testing.assert_allclose(t_lp.numpy(), j_lp, rtol=1e-5, atol=1e-5)
    # and the dispatching wrapper on the CPU is the same two twins
    w_act, w_lp, w_acc = fs.fused_stretch_half(
        args[0], torch.from_numpy(lp), args[1], args[2], floor,
        floor.clone(), logp_fn=tt)
    assert torch.equal(w_act, t_act) and torch.equal(w_acc, t_acc)


def test_accept_reference_edge_rules():
    """log(ue) < factor + lp_new − lp_old, as JAX evaluates it: lp_old =
    −inf with a finite lp_new accepts, a NaN lp_new rejects, an lp_new of
    +inf accepts, and equality rejects (strict <)."""
    act = torch.zeros((5, 2))
    prop = torch.ones((5, 2))
    lp_old = torch.tensor([-torch.inf, 0.0, 0.0, 0.0, -1.0])
    lp_new = torch.tensor([-5.0, torch.nan, torch.inf, -3.0, -1.0])
    factor = torch.zeros(5)
    ue = torch.tensor([0.5, 0.5, 0.5, 0.99, 1.0])
    new, new_lp, acc = fs.stretch_accept_reference(act, prop, lp_old, lp_new,
                                                   factor, ue)
    assert acc.tolist() == [1, 0, 1, 0, 0]
    assert torch.equal(new[0], prop[0]) and torch.equal(new[1], act[1])
    assert new_lp[0] == -5.0 and new_lp[1] == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("name,n,shift", [
    ("neal_funnel", 1 << 16, "third"), ("rosenbrock", 160, "third"),
    ("logistic_regression", 1000, "third"), ("neal_funnel", 1 << 16, 0),
    ("neal_funnel", 1 << 16, 1), ("neal_funnel", 1 << 16, "last"),
    ("neal_funnel", 1 << 16, "mid"), ("neal_funnel", 50, "mid"),
    ("neal_funnel", 1000, "negative"), ("neal_funnel", 1000, "beyond"),
    ("funnel3", 1000, "mid"), ("funnel7", 1000, 1), ("funnel33", 1000, "mid"),
    ("funnel64", 300, "last"), ("funnel300", 77, "mid"),
])
def test_split_kernels_match_reference_on_card(cuda_device, name, n, shift):
    """The propose and accept kernels of the split path against their plain
    twins on one card, on a logp that is NaN on some rows (which must
    reject) and with lp_old = −inf on others (which must accept). Both are
    elementwise with per-operation rounding, so each kernel alone equals
    its twin bit for bit; the half-step goes through the logp, so its rows
    are held to rtol = atol = 1e-5 with masks equal except within
    1e-4·max(1, |ratio|) of the threshold. The GaussianTarget kernel is not
    launched."""
    from mcmcpp_tpu_torch.models import targets as tm

    if name.startswith("funnel"):
        target = tm.neal_funnel(int(name[6:]))
    else:
        target = {"neal_funnel": lambda: tm.neal_funnel(10),
                  "rosenbrock": lambda: tm.rosenbrock(),
                  "logistic_regression": lambda: tm.logistic_regression(
                      dim=4, device=cuda_device)}[name]()
    p = target.dim
    act, oth = _inputs(n, p, seed=p)
    rows = torch.arange(n, device=cuda_device)
    neg = rows % 97 == 7
    nan_rows = (rows % 89 == 3) & ~neg

    def logp(x):
        out = target(x)
        return torch.where(nan_rows, torch.nan, out)

    lp = target(torch.from_numpy(act).to(cuda_device))
    lp[neg] = -torch.inf
    key = 0xD1B54A32D192ED03 ^ (n * 1000003 + p)
    u, ue = philox_unit_uniforms(key, n, cuda_device)
    args = (torch.from_numpy(act).to(cuda_device), lp,
            torch.from_numpy(oth).to(cuda_device),
            torch.tensor([_card_shift(n, shift)], dtype=torch.int32,
                         device=cuda_device))
    before = dict(fs.LAUNCHES)
    k_act, k_lp, k_acc = fs.fused_stretch_half(*args, key=key, logp_fn=logp)
    torch.cuda.synchronize()
    assert fs.LAUNCHES == {
        **before, "stretch_propose": before["stretch_propose"] + 1,
        "stretch_accept": before["stretch_accept"] + 1}
    r_act, r_lp, r_acc = fs.fused_stretch_half_reference(*args, u, ue,
                                                         logp_fn=logp)
    assert 0 < int(r_acc.sum()) < n
    assert bool((k_acc[nan_rows] == 0).all())
    assert bool((k_acc[neg] == 1).all())
    r_prop, lp_new, log_ratio = fs.stretch_proposal(*args, u, logp_fn=logp)
    near = ((log_ratio - torch.log(ue)).abs()
            < 1e-4 * torch.clamp(log_ratio.abs(), min=1.0))
    assert bool(((k_acc == r_acc) | near).all())
    same = k_acc == r_acc
    torch.testing.assert_close(k_act[same], r_act[same], rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(k_lp[same], r_lp[same], rtol=1e-5, atol=1e-5,
                               equal_nan=True)
    # each kernel alone, on the plain path's intermediates: bit for bit
    act_t, _, oth_t, shift_t = args
    k_prop, k_fac = fs.stretch_propose(act_t, oth_t, shift_t, key)
    r_prop2, r_fac = fs.stretch_propose_reference(act_t, oth_t, shift_t, u)
    assert torch.equal(k_prop, r_prop2) and torch.equal(k_fac, r_fac)
    k_out = fs.stretch_accept(act_t, r_prop, lp, lp_new, r_fac, key)
    r_out = fs.stretch_accept_reference(act_t, r_prop, lp, lp_new, r_fac, ue)
    for k_t, r_t in zip(k_out, r_out):
        assert torch.equal(torch.nan_to_num(k_t.float(), nan=7.0),
                           torch.nan_to_num(r_t.float(), nan=7.0))


@pytest.mark.cuda
@pytest.mark.parametrize("name,n,p,shift", [
    ("gaussian", 1 << 16, 10, "third"), ("gaussian", 1000, 7, "mid"),
    ("gaussian", 4096, 64, "last"), ("gaussian", 1 << 12, 10, "negative"),
    ("funnel", 1 << 16, 10, "third"), ("funnel", 1000, 3, "mid"),
    ("funnel", 4096, 33, "beyond"), ("gaussian", 4000, 100, "mid"),
    ("gaussian", 4096, 257, "last"),
])
def test_kernels_over_row_shards_equal_one_launch_on_card(cuda_device, name,
                                                          n, p, shift):
    """The four kernels launched over R = 4 row shards of a half (each on
    rows row0… against the whole other half, ``row0``) give one unsharded
    launch's outputs under ``torch.equal``; each sharded launch of the split
    kernels equals its plain version on its rows' planes bit for bit."""
    from mcmcpp_tpu_torch.models import targets as tm

    act, oth = (torch.from_numpy(a).to(cuda_device)
                for a in _inputs(n, p, seed=p + 1,
                                 act_scale=0.3 if p <= fs.MAX_P else 3.0))
    target = (GaussianTarget(_prec_chol(p, seed=p), device=cuda_device)
              if name == "gaussian" else tm.neal_funnel(p))
    lp = target(act)
    shift_t = torch.tensor([_card_shift(n, shift)], dtype=torch.int32,
                           device=cuda_device)
    key = 0xA0761D6478BD642F ^ (n * 1000003 + p)
    whole = fs.fused_stretch_half(act, lp, oth, shift_t, key=key,
                                  logp_fn=target)
    m = n // 4
    parts = [fs.fused_stretch_half(act[r0:r0 + m], lp[r0:r0 + m], oth,
                                   shift_t, key=key, logp_fn=target, row0=r0)
             for r0 in range(0, n, m)]
    torch.cuda.synchronize()
    for k in range(3):
        assert torch.equal(torch.cat([q[k] for q in parts]), whole[k])
    if name == "funnel":
        for r0 in range(0, n, m):
            rows = slice(r0, r0 + m)
            u, ue = philox_unit_uniforms(key, m, cuda_device, row0=r0)
            prop, fac = fs.stretch_propose(act[rows], oth, shift_t, key,
                                           row0=r0)
            r_prop, r_fac = fs.stretch_propose_reference(act[rows], oth,
                                                         shift_t, u, row0=r0)
            assert torch.equal(prop, r_prop) and torch.equal(fac, r_fac)
            lp_new = target(prop)
            got = fs.stretch_accept(act[rows], prop, lp[rows], lp_new, fac,
                                    key, row0=r0)
            want = fs.stretch_accept_reference(act[rows], prop, lp[rows],
                                               lp_new, fac, ue)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
