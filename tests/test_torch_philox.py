"""The Philox twin of the stretch kernels' in-kernel uniforms.

The CUDA kernels compute each walker's u and ue as words 0 and 1 of
Philox4x32-10 on counter (i_lo, i_hi, 0, 0) with the half-step's 64-bit key
(``csrc/stretch_common.cuh``). ``ops/random.py`` holds the same function in
torch int64 ops; it is what the CPU path draws with and what the kernels are
compared with on the card. Here the twin is held against the Random123
known answers and an independent numpy ``uint64`` implementation, its
uniforms against their grid, range and moments, and the fused mover's
``draw_noise`` against what a sampler needs of it: determinism in the seed,
and a fresh key for every half-step.

Nothing here imports JAX, so the ``cuda`` test runs on a machine without it.
"""

import numpy as np
import pytest
import torch

from mcmcpp_tpu_torch import EnsembleSampler, FusedStretchMove, skewed_gaussian
from mcmcpp_tpu_torch.ops import fused_stretch as fs
from mcmcpp_tpu_torch.ops.random import (
    HOST_STREAM,
    STEP_STREAM,
    UNIT_FLOOR,
    bits_to_unit,
    draw_key,
    make_generator,
    philox4x32,
    philox_unit_uniforms,
)

torch.set_num_threads(1)

# covariance of the 2-D skewed Gaussian at eps = 0.13 (tests/targets.py)
SKEWED_COV = np.array([[1.13, 0.435], [0.435, 0.2825]])

# (counter words, key words, output words): the known-answer tests of
# Random123's philox4x32_10 (kat_vectors)
KNOWN_ANSWERS = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


def _numpy_philox(counter, key):
    """Philox4x32-10 on (m, 4) uint64 counters and (m, 2) uint64 keys of
    32-bit words, written independently of the twin (unsigned arithmetic,
    the key schedule kept apart from the rounds)."""
    mask = np.uint64(0xFFFFFFFF)
    s32 = np.uint64(32)
    m0, m1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
    keys = [key.copy()]
    for _ in range(9):
        nxt = keys[-1].copy()
        nxt[:, 0] = (nxt[:, 0] + np.uint64(0x9E3779B9)) & mask
        nxt[:, 1] = (nxt[:, 1] + np.uint64(0xBB67AE85)) & mask
        keys.append(nxt)
    c = counter.copy()
    for k in keys:
        prod0 = m0 * c[:, 0]
        prod1 = m1 * c[:, 2]
        c = np.stack([
            (prod1 >> s32) ^ c[:, 1] ^ k[:, 0],
            prod1 & mask,
            (prod0 >> s32) ^ c[:, 3] ^ k[:, 1],
            prod0 & mask,
        ], axis=1)
    return c


def _twin_words(counter, key):
    cols = tuple(torch.tensor([int(w)], dtype=torch.int64) for w in counter)
    return tuple(int(w) for w in philox4x32(cols, tuple(int(k)
                                                        for k in key)))


@pytest.mark.parametrize("case", range(len(KNOWN_ANSWERS)))
def test_known_answers(case):
    counter, key, want = KNOWN_ANSWERS[case]
    assert _twin_words(counter, key) == want
    got = _numpy_philox(np.array([counter], dtype=np.uint64),
                        np.array([key], dtype=np.uint64))[0]
    assert tuple(int(w) for w in got) == want


@pytest.mark.parametrize("seed", range(6))
def test_twin_matches_numpy_on_random_counters_and_keys(seed):
    """Full 128-bit counters, a fresh 64-bit key per case: every word of
    the twin equals the numpy implementation's."""
    rng = np.random.default_rng(seed)
    m = 257
    counter = rng.integers(0, 1 << 32, size=(m, 4), dtype=np.uint64)
    key = rng.integers(0, 1 << 32, size=2, dtype=np.uint64)
    want = _numpy_philox(counter, np.broadcast_to(key, (m, 2)).copy())
    cols = tuple(torch.from_numpy(counter[:, j].astype(np.int64))
                 for j in range(4))
    got = philox4x32(cols, (int(key[0]), int(key[1])))
    for j in range(4):
        np.testing.assert_array_equal(got[j].numpy().astype(np.uint64),
                                      want[:, j])


@pytest.mark.parametrize("key", [0, 1, 0xDEADBEEF, (1 << 64) - 1,
                                 0x0123456789ABCDEF])
def test_unit_uniforms_are_the_counter_words(key):
    """u and ue of walker i are words 0 and 1 on counter (i, 0, 0, 0) with
    the key's low and high words, through ``bits_to_unit``."""
    n = 300
    u, ue = philox_unit_uniforms(key, n, "cpu")
    assert u.dtype == ue.dtype == torch.float32 and u.shape == ue.shape == (n,)
    counter = np.zeros((n, 4), dtype=np.uint64)
    counter[:, 0] = np.arange(n)
    k = np.array([[key & 0xFFFFFFFF, key >> 32]] * n, dtype=np.uint64)
    words = _numpy_philox(counter, k)
    for plane, w in ((u, words[:, 0]), (ue, words[:, 1])):
        want = np.maximum((w >> np.uint64(8)).astype(np.float32)
                          * np.float32(2.0 ** -24), np.float32(2.0 ** -25))
        np.testing.assert_array_equal(plane.numpy(), want)


def test_counter_high_word():
    """A walker index past 2^32 puts its high word in counter word 1."""
    i = (1 << 32) + 5
    cols = (torch.tensor([i & 0xFFFFFFFF]), torch.tensor([i >> 32]),
            torch.tensor([0]), torch.tensor([0]))
    want = _numpy_philox(np.array([[5, 1, 0, 0]], dtype=np.uint64),
                         np.array([[7, 9]], dtype=np.uint64))[0]
    got = philox4x32(cols, (7, 9))
    assert [int(w) for w in got] == [int(w) for w in want]


def test_bits_to_unit_grid_and_floor():
    """[2^-25, 1), on the 2^-24 grid; the floor is hit by bits < 2^8 only."""
    bits = torch.tensor([0, 1, 255, 256, 257, 1 << 31, (1 << 32) - 1,
                         (1 << 32) - 256, 0x12345678], dtype=torch.int64)
    unit = bits_to_unit(bits)
    assert unit.dtype == torch.float32
    assert unit[:3].tolist() == [UNIT_FLOOR] * 3
    assert unit[3].item() == 2.0 ** -24 and unit[4].item() == 2.0 ** -24
    assert unit[5].item() == 0.5
    assert unit[6].item() == unit[7].item() == 1.0 - 2.0 ** -24
    assert unit[8].item() == (0x12345678 >> 8) * 2.0 ** -24
    assert float(unit.max()) < 1.0 and float(unit.min()) == UNIT_FLOOR


def test_unit_uniforms_range_grid_and_moments():
    """2^16 draws: in [2^-25, 1), multiples of 2^-24 above the floor, mean
    1/2 and variance 1/12 within 5 standard errors (0.0056 and 0.0015),
    |corr(u, ue)| and the lag-1 correlation of u below 5/sqrt(n) = 0.0195."""
    n = 1 << 16
    u, ue = philox_unit_uniforms(0x5EED5EED5EED, n, "cpu")
    for plane in (u, ue):
        x = plane.double().numpy()
        assert x.min() >= UNIT_FLOOR and x.max() < 1.0
        scaled = x[x > UNIT_FLOOR] * 2.0 ** 24
        assert np.array_equal(scaled, np.round(scaled))
        # the floor needs bits < 2^8: about n / 2^24 draws, so almost none
        assert (x == UNIT_FLOOR).sum() <= 2
        assert abs(x.mean() - 0.5) < 5 * np.sqrt(1 / 12 / n)
        assert abs(x.var() - 1 / 12) < 5 * np.sqrt(1 / 180 / n)
    bound = 5 / np.sqrt(n)
    a, b = u.double().numpy(), ue.double().numpy()
    assert abs(np.corrcoef(a, b)[0, 1]) < bound
    assert abs(np.corrcoef(a[:-1], a[1:])[0, 1]) < bound
    # another key gives another, uncorrelated plane
    u2, _ = philox_unit_uniforms(0x5EED5EED5EEE, n, "cpu")
    assert abs(np.corrcoef(a, u2.double().numpy())[0, 1]) < bound


def test_bad_key_rejected():
    with pytest.raises(ValueError, match="64-bit"):
        philox_unit_uniforms(1 << 64, 4, "cpu")
    with pytest.raises(ValueError, match="64-bit"):
        philox_unit_uniforms(-1, 4, "cpu")


def _gens(seed):
    return (make_generator(seed, STEP_STREAM, "cpu"),
            make_generator(seed, HOST_STREAM, "cpu"))


def test_draw_noise_is_deterministic_in_the_seed():
    mover = FusedStretchMove()
    runs = []
    for seed in (11, 11, 12):
        gen, host_gen = _gens(seed)
        runs.append([mover.draw_noise(gen, 32, 32, 3, "cpu",
                                      host_gen=host_gen) for _ in range(4)])
    for a, b in zip(runs[0], runs[1]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(a[1], b[1])
                   for a, b in zip(runs[0], runs[2]))


def test_draw_noise_planes_are_the_keys_planes():
    """On the CPU ``draw_noise`` hands out the planes of the key it drew
    from ``host_gen``, and a (1,) int32 shift in [0, m)."""
    gen, host_gen = _gens(3)
    _, key_gen = _gens(3)
    mover = FusedStretchMove()
    for _ in range(3):
        shift, u, ue = mover.draw_noise(gen, 48, 48, 2, "cpu",
                                        host_gen=host_gen)
        want_u, want_ue = philox_unit_uniforms(draw_key(key_gen), 48, "cpu")
        assert torch.equal(u, want_u) and torch.equal(ue, want_ue)
        assert shift.dtype == torch.int32 and shift.shape == (1,)
        assert 0 <= int(shift) < 48


def test_no_key_repeats_over_many_half_steps():
    """Red, black and consecutive steps need distinct keys: a repeated key
    repeats u and ue walker by walker and correlates the chain."""
    _, host_gen = _gens(0)
    keys = [draw_key(host_gen) for _ in range(10_000)]
    assert len(set(keys)) == len(keys)
    assert all(0 <= k < 1 << 64 for k in keys)
    # both words vary (a key cut to 32 bits would leave the high word 0)
    assert len({k >> 32 for k in keys}) > 9_900
    assert len({k & 0xFFFFFFFF for k in keys}) > 9_900


def test_sampler_half_steps_draw_distinct_planes():
    """Through the sampler's own step: the u planes of red and black of one
    step, and of consecutive steps, all differ."""
    planes = []

    class Recording(FusedStretchMove):
        def draw_noise(self, *args, **kwargs):
            noise = super().draw_noise(*args, **kwargs)
            planes.append(noise[1])
            return noise

    s = EnsembleSampler(skewed_gaussian(device="cpu"), 16, 2,
                        mover=Recording(), seed=1, batched=True, device="cpu")
    s.init_ball(np.zeros(2), scale=0.5)
    s.run_mcmc(25, store=False)
    assert len(planes) == 50
    assert len({tuple(p.tolist()) for p in planes}) == 50


def test_draw_noise_needs_a_host_generator():
    class FakeGen:
        device = torch.device("cuda")

    with pytest.raises(ValueError, match="host"):
        FusedStretchMove().draw_noise(FakeGen(), 8, 8, 2, "cpu")
    with pytest.raises(ValueError, match="equal halves"):
        FusedStretchMove().draw_noise(_gens(0)[0], 8, 6, 2, "cpu")


def test_wrapper_takes_planes_only_on_the_cpu():
    """On CPU tensors ``fused_stretch_half`` is the plain version on the
    planes it is given (here a key's, from the twin); a key is refused, and
    so are missing planes: one format per device."""
    n, p = 50, 3
    rng = np.random.default_rng(5)
    act = torch.from_numpy(rng.normal(size=(n, p)).astype(np.float32))
    oth = torch.from_numpy(rng.normal(size=(n, p)).astype(np.float32))
    shift = torch.tensor([n - 1], dtype=torch.int32)

    def logp(x):
        return -0.5 * torch.sum(x * x, dim=-1)

    key = 0xABCDEF0123456789
    u, ue = philox_unit_uniforms(key, n, "cpu")
    got = fs.fused_stretch_half(act, logp(act), oth, shift, u, ue,
                                logp_fn=logp)
    want = fs.fused_stretch_half_reference(act, logp(act), oth, shift, u, ue,
                                           logp_fn=logp)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert 0 < int(got[2].sum()) < n
    for args, kwargs in [((), {"key": key}), ((u, ue), {"key": key}), ((), {}),
                         ((u,), {})]:
        with pytest.raises(TypeError, match="planes u and ue"):
            fs.fused_stretch_half(act, logp(act), oth, shift, *args,
                                  logp_fn=logp, **kwargs)


@pytest.mark.parametrize("key", [None, 1.5, True, -1, 1 << 64])
def test_kernel_wrappers_refuse_a_bad_key(key):
    """The key check runs before any build or launch."""
    x = torch.zeros((4, 2))
    before = dict(fs.LAUNCHES)
    with pytest.raises((TypeError, ValueError), match="key"):
        fs.stretch_propose(x, x, torch.zeros(1, dtype=torch.int32), key)
    with pytest.raises((TypeError, ValueError), match="key"):
        fs.stretch_accept(x, x, x[:, 0], x[:, 0], x[:, 0], key)
    assert fs.LAUNCHES == before


def test_kernel_uniforms_need_a_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        fs.kernel_unit_uniforms(1, 8, "cpu")


def test_fused_moments_through_the_twin():
    """The skewed Gaussian's moments with the fused mover on the CPU, every
    uniform drawn through the Philox twin (another seed and width than
    ``test_torch_sampler.py::test_moments``, the same tolerance)."""
    s = EnsembleSampler(skewed_gaussian(device="cpu"), 64, 2,
                        mover=FusedStretchMove(), seed=17, batched=True,
                        device="cpu")
    s.init_ball(np.zeros(2), scale=0.5)
    s.run_mcmc(500, store=False)
    assert s.run_mcmc(5000)
    flat = s.get_samples(flat=True)
    cov = np.cov(flat.T)
    assert np.allclose(cov, SKEWED_COV, atol=0.12), cov
    assert np.allclose(flat.mean(axis=0), 0.0, atol=0.15)
    assert 0.6 < s.acceptance_fraction < 0.8


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("key,n", [(0, 1000), (0xDEADBEEFCAFEF00D, 1 << 16),
                                   ((1 << 64) - 1, 50)])
def test_kernel_uniforms_equal_the_twin_on_card(cuda_device, key, n):
    """The kernels' device function against the twin, bit for bit."""
    k_u, k_ue = fs.kernel_unit_uniforms(key, n, cuda_device)
    torch.cuda.synchronize()
    t_u, t_ue = philox_unit_uniforms(key, n, cuda_device)
    c_u, c_ue = philox_unit_uniforms(key, n, "cpu")
    assert torch.equal(k_u, t_u) and torch.equal(k_ue, t_ue)
    assert torch.equal(k_u.cpu(), c_u) and torch.equal(k_ue.cpu(), c_ue)
