"""The port's reduced-precision store tiers and chain stores against the JAX
package.

The same float32 arrays, made from a numpy seed, are cast by JAX
(``astype(bfloat16 / float16 / float8_e4m3fn)``) and by the port's store path
(torch's conversion on the way into a :class:`Chain`): the bits must be equal,
at ±448, on ties, subnormals, infinities and NaN; beyond e4m3's range the rule
is the installed torch's, which is documented and held here. A port chain read back
equals the JAX ``Chain`` read back exactly. The rest mirrors the non-slow
tests of ``tests/test_store_dtype.py`` and ``tests/test_chain_disk.py`` on the
port, with the sampler on the CPU (tolerances as stated there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmcpp_tpu as jref
from mcmcpp_tpu.chain import Chain as JChain
from mcmcpp_tpu_torch import Chain, EnsembleSampler, analysis, skewed_gaussian
from mcmcpp_tpu_torch.chain import (
    BitsDtype,
    default_chunk_steps,
    from_held,
    row_dtype,
    run_pipelined,
    to_held,
)
from mcmcpp_tpu_torch.chain_disk import DiskChain
from mcmcpp_tpu_torch.sampler import run_scan

torch.set_num_threads(1)

TIERS = [
    ("bfloat16", jnp.bfloat16, torch.bfloat16, np.uint16),
    ("float16", jnp.float16, torch.float16, np.uint16),
    ("float8_e4m3fn", jnp.float8_e4m3fn, torch.float8_e4m3fn, np.uint8),
    ("float8_e5m2", jnp.float8_e5m2, torch.float8_e5m2, np.uint8),
]


def _edge_values():
    """Seeded float32 values over every binade the tiers have, plus the
    edges: ±448 (e4m3's largest), the halfway points beyond it, float16's
    65504, subnormals of each tier, signed zeros, infinities, NaN."""
    rng = np.random.default_rng(0)
    body = (rng.standard_normal(4096)
            * 10.0 ** rng.uniform(-12, 6, 4096)).astype(np.float32)
    near = np.array([447.0, 448.0, 449.0, 463.9, 464.0, 464.1, 479.9, 480.0,
                     512.0, 1e4, 65504.0, 65519.9, 65520.0, 7e4, 3.3e38,
                     2.0 ** -6, 2.0 ** -7, 2.0 ** -9, 2.0 ** -10, 1.5e-3,
                     2.0 ** -14, 2.0 ** -24, 2.0 ** -25, 6e-8, 1e-40, 0.0],
                    np.float32)
    special = np.array([np.inf, -np.inf, np.nan], np.float32)
    ties = np.array([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, 1.0 + 2.0 ** -4,
                     1.0 + 3 * 2.0 ** -4, 1.0 + 2.0 ** -11,
                     1.0 + 3 * 2.0 ** -11], np.float32)
    return np.concatenate([body, near, -near, special, ties, -ties])


@pytest.mark.parametrize("name,jdt,tdt,bits", TIERS, ids=[t[0] for t in TIERS])
def test_store_cast_gives_jax_bits(name, jdt, tdt, bits):
    x = _edge_values()
    jax_cast = np.asarray(jnp.asarray(x).astype(jdt))
    held = to_held(torch.from_numpy(x), tdt)
    assert held.dtype.itemsize == np.dtype(bits).itemsize
    # e4m3fn beyond its range is the one place where the two may differ
    # (the installed torch's rule, below)
    beyond = (np.abs(x) > 464.0) if name == "float8_e4m3fn" else np.zeros(
        x.shape, bool)
    nan = np.isnan(x)
    same = ~beyond & ~nan
    assert same.sum() > 3000
    # equal bits: every binade, ties, subnormals, signed zeros, infinities
    assert np.array_equal(jax_cast.view(bits)[same], held.view(bits)[same])
    up = from_held(held, name).to(torch.float32).numpy()
    np.testing.assert_array_equal(up[same],
                                  jax_cast.astype(np.float32)[same])
    # NaN stays NaN in both (payload and sign are not compared)
    assert np.isnan(up[nan]).all()
    assert np.isnan(jax_cast.astype(np.float32)[nan]).all()
    # a numpy array takes the same path as a tensor
    assert np.array_equal(to_held(x, name).view(bits)[~nan],
                          held.view(bits)[~nan])


def test_e4m3_beyond_range_is_the_installed_torchs_rule_and_documented():
    """Up to ±464 (the halfway point past 448) both round to ±448. Beyond,
    and at ±inf, JAX stores NaN (e4m3fn has no infinity); torch 2.11 does
    too, torch 2.13 saturates to ±448. The port keeps the installed torch's
    rule and emulates neither (``mcmcpp_tpu_torch/chain.py``'s docstring says
    so): each value beyond the range is NaN or ±448 with its sign."""
    x = np.array([448.0, 463.9, 464.0, -464.0, 464.1, -1e6, np.inf],
                 np.float32)
    port = from_held(to_held(torch.from_numpy(x), torch.float8_e4m3fn),
                     "float8_e4m3fn").to(torch.float32).numpy()
    ref = np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn)
                     ).astype(np.float32)
    np.testing.assert_array_equal(port[:4], ref[:4])
    np.testing.assert_array_equal(port[:4], [448.0, 448.0, 448.0, -448.0])
    assert np.isnan(ref[4:]).all()
    direct = torch.from_numpy(x).to(torch.float8_e4m3fn).float().numpy()
    np.testing.assert_array_equal(port, direct)  # torch's rule, unaltered
    for got, sat in zip(port[4:], [448.0, -448.0, 448.0]):
        assert np.isnan(got) or got == sat
    import mcmcpp_tpu_torch.chain as chain_mod

    assert "saturates" in chain_mod.__doc__


@pytest.mark.parametrize("name,jdt,tdt,bits", TIERS, ids=[t[0] for t in TIERS])
def test_chain_read_back_equals_jax_chain(name, jdt, tdt, bits):
    rng = np.random.default_rng(1)
    pos = (rng.standard_normal((9, 8, 3)) * 30).astype(np.float32)
    lp = (rng.standard_normal((9, 8)) * 500).astype(np.float32)
    eight = np.dtype(bits).itemsize < 2
    jc = JChain(8, 3, dtype=np.dtype(jdt), backend="numpy",
                read_dtype=np.float32,
                logp_dtype=np.dtype(jnp.bfloat16) if eight else None)
    pc = Chain(8, 3, dtype=tdt, read_dtype=np.float32,
               logp_dtype=torch.bfloat16 if eight else None)
    for a, b in [(0, 4), (4, 9)]:
        # JAX's sampler hands its chain rows already cast on the device
        jpos = np.asarray(jnp.asarray(pos[a:b]).astype(jdt))
        jlp = np.asarray(jnp.asarray(lp[a:b]).astype(
            jnp.bfloat16 if eight else jdt))
        assert jc.append(jpos, jlp)
        assert pc.append(torch.from_numpy(pos[a:b]),
                         torch.from_numpy(lp[a:b]))
    assert pc.n_steps == jc.n_steps == 9 and pc.nbytes == jc.nbytes
    assert pc.dtype.name == jc.dtype.name
    assert pc.logp_dtype.name == jc.logp_dtype.name
    for kw in ({}, {"burn_in": 2, "thin": 3}, {"flat": True}):
        got, want = pc.get(**kw), jc.get(**kw)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(pc.get_logp(**kw), jc.get_logp(**kw))
    pc.compact(burn_in=1, thin=2)
    jc.compact(burn_in=1, thin=2)
    np.testing.assert_array_equal(pc.get(), jc.get())
    assert pc.nbytes == jc.nbytes


def test_row_dtype_names_and_bits():
    assert row_dtype(torch.float32) == np.float32
    assert row_dtype("float16") == np.float16
    bf = row_dtype(torch.bfloat16)
    assert isinstance(bf, BitsDtype) and bf.name == "bfloat16"
    assert bf.itemsize == 2 and bf.bits == np.int16 and bf == torch.bfloat16
    assert bf == "bfloat16" and bf == row_dtype("bfloat16") and bf != "float16"
    f8 = row_dtype("float8_e4m3fn")
    assert f8.itemsize == 1 and f8.torch is torch.float8_e4m3fn
    assert default_chunk_steps(64, 3, bf) == 2 * default_chunk_steps(
        64, 3, np.float32)


def test_native_backend_raises_and_unknown_backend():
    with pytest.raises(RuntimeError, match="native chain store not built"):
        Chain(8, 2, backend="native")
    with pytest.raises(ValueError, match="unknown chain backend"):
        Chain(8, 2, backend="arena")
    with pytest.raises(ValueError, match="mixed sample/logp"):
        Chain(8, 2, dtype="float8_e4m3fn", logp_dtype="bfloat16",
              backend="native")
    assert Chain(8, 2, backend="numpy").backend == "numpy"


def test_run_pipelined_drains_before_every_save():
    """The port's loop and the JAX package's make the same calls in the same
    order, and a save never sees a launched chunk that is not fetched."""
    from mcmcpp_tpu.chain import run_pipelined as jax_run_pipelined

    def trace(loop, **kw):
        log, in_flight = [], []

        def launch(take):
            in_flight.append(take)
            log.append(("launch", take))
            return take

        def fetch(h):
            in_flight.remove(h)
            log.append(("fetch", h))
            return True

        def save():
            assert not in_flight
            log.append(("save",))

        assert loop(11, 3, launch, fetch, checkpoint_save=save, **kw)
        return log

    for every in (1, 2, 3):
        got = trace(run_pipelined, checkpoint_every=every)
        assert got == trace(jax_run_pipelined, checkpoint_every=every)
        assert ("save",) in got


# -- mirrors of tests/test_store_dtype.py ------------------------------------

def _run(store_dtype, n_steps=2000, seed=3, **kw):
    s = EnsembleSampler(skewed_gaussian(device="cpu"), n_walkers=64,
                        n_params=2, seed=seed, store_dtype=store_dtype,
                        batched=True, device="cpu", **kw)
    s.init_ball(np.zeros(2), scale=0.3, seed=4)
    s.run_mcmc(200, store=False)
    s.run_mcmc(n_steps, thin=2)
    return s


def test_bf16_halves_stored_bytes():
    a = _run(None, n_steps=200)
    b = _run(torch.bfloat16, n_steps=200)
    assert a.chain.n_steps == b.chain.n_steps
    assert b.chain.nbytes * 2 == a.chain.nbytes
    assert b._chunk == 2 * a._chunk  # sized at the stored dtype


def test_reads_cast_up_to_float32():
    s = _run(torch.bfloat16, n_steps=100)
    assert s.get_samples().dtype == np.float32
    assert s.get_log_probs().dtype == np.float32
    assert s.get_samples(flat=True).dtype == np.float32
    assert s.chain.get(held=True).dtype == np.int16


def test_trajectory_unchanged_rows_one_rounding_away():
    a, b = _run(None), _run(torch.bfloat16)
    xa, xb = a.get_samples(), b.get_samples()
    assert xa.shape == xb.shape
    scale = np.maximum(np.abs(xa), 1e-3)
    assert np.max(np.abs(xa - xb) / scale) <= 2.0 ** -8
    # the stored rows ARE the float32 rows cast once, as JAX casts them
    want = np.asarray(jnp.asarray(xa).astype(jnp.bfloat16)).astype(np.float32)
    np.testing.assert_array_equal(xb, want)
    lp = np.asarray(jnp.asarray(a.get_log_probs()).astype(jnp.bfloat16))
    np.testing.assert_array_equal(b.get_log_probs(), lp.astype(np.float32))
    assert a.accepted_steps == b.accepted_steps


def test_analysis_tolerance_moments_and_act():
    a, b = _run(None), _run(torch.bfloat16)
    ca = np.cov(a.get_samples(flat=True).T)
    cb = np.cov(b.get_samples(flat=True).T)
    np.testing.assert_allclose(cb, ca, rtol=5e-3, atol=5e-4)
    ta = analysis.autocorr_time(a.get_samples())
    tb = analysis.autocorr_time(b.get_samples())
    np.testing.assert_allclose(tb, ta, rtol=0.02)


def test_f16_path():
    s = _run(torch.float16, n_steps=100)
    assert s.chain.dtype == np.float16
    x = s.get_samples()
    assert x.dtype == np.float32 and np.isfinite(x).all()


def test_f8_tier_layout_and_bytes():
    a = _run(None, n_steps=200)
    b = _run(torch.float8_e4m3fn, n_steps=200)
    assert b.chain.dtype == torch.float8_e4m3fn
    assert b.chain.logp_dtype == torch.bfloat16
    assert b.chain.backend == "numpy"
    assert a.chain.n_steps == b.chain.n_steps
    w, p = 64, 2
    assert a.chain.nbytes == a.chain.n_steps * w * (p + 1) * 4
    assert b.chain.nbytes == b.chain.n_steps * w * (p * 1 + 2)


def test_f8_large_logp_survives():
    def hot_logp(x):
        return -0.5 * ((x - 3.0) ** 2).sum(dim=1) * 500.0  # |logp| >> 448

    s = EnsembleSampler(hot_logp, n_walkers=64, n_params=2, seed=0,
                        store_dtype=torch.float8_e4m3fn, batched=True,
                        device="cpu")
    s.init_ball(np.full(2, 3.0), scale=0.05, seed=1)
    s.run_mcmc(100)
    assert np.isfinite(s.get_log_probs()).all()


def test_f8_analysis_tolerance():
    a, b = _run(None), _run(torch.float8_e4m3fn)
    ca = np.cov(a.get_samples(flat=True).T)
    cb = np.cov(b.get_samples(flat=True).T)
    np.testing.assert_allclose(cb, ca, rtol=2e-2, atol=2e-3)
    ta = analysis.autocorr_time(a.get_samples())
    tb = analysis.autocorr_time(b.get_samples())
    np.testing.assert_allclose(tb, ta, rtol=0.05)
    assert a.accepted_steps == b.accepted_steps


def test_f8_injected_narrow_logp_chain_rejected(tmp_path):
    target = skewed_gaussian(device="cpu")
    for narrow in (Chain(64, 2, dtype=torch.float8_e4m3fn),
                   DiskChain(tmp_path / "f8", 64, 2, dtype="float8_e4m3fn")):
        with pytest.raises(ValueError, match="logp plane"):
            EnsembleSampler(target, 64, 2, batched=True, device="cpu",
                            store_dtype=torch.float8_e4m3fn, chain=narrow)
    wide = Chain(64, 2, dtype=torch.float8_e4m3fn, logp_dtype=torch.bfloat16,
                 read_dtype=np.float32)
    s = EnsembleSampler(target, 64, 2, batched=True, device="cpu",
                        store_dtype=torch.float8_e4m3fn, chain=wide)
    s.init_ball(np.zeros(2), scale=0.3, seed=1)
    s.run_mcmc(20)
    assert np.isfinite(s.get_log_probs()).all()


def test_empty_chain_logp_dtype_consistent():
    c = Chain(8, 2, dtype=torch.float8_e4m3fn, logp_dtype=torch.bfloat16)
    empty_dtype = c.get_logp().dtype
    assert c.get().shape == (0, 8, 2) and c.get(held=True).dtype == np.uint8
    c.append(np.zeros((3, 8, 2)), np.zeros((3, 8)))
    assert c.get_logp().dtype == empty_dtype


def test_step_action_sees_full_precision_under_store_dtype():
    s = _run(None, n_steps=0)
    seen = []

    def action(pos, lp):
        seen.append((pos.dtype, lp.dtype))
        return pos.sum()

    state, pos, lp, metrics, _ = run_scan(
        s.state, s._step_fn, 3, 2, action, store_dtype=torch.bfloat16)
    assert pos.dtype == lp.dtype == torch.bfloat16 and metrics.shape == (3,)
    assert seen == [(torch.float32, torch.float32)] * 3
    _, pos8, lp8, _, _ = run_scan(state, s._step_fn, 2, 1,
                                  store_dtype=torch.float8_e4m3fn)
    assert pos8.dtype == torch.float8_e4m3fn and lp8.dtype == torch.bfloat16


# -- mirrors of tests/test_chain_disk.py -------------------------------------

def _fill(chain, rng, blocks=(7, 11, 5)):
    for s in blocks:
        pos = rng.normal(size=(s, chain.n_walkers, chain.n_params))
        lp = rng.normal(size=(s, chain.n_walkers))
        assert chain.append(pos, lp)
    return chain


VIEWS = ({}, {"burn_in": 4}, {"thin": 3}, {"burn_in": 5, "thin": 4},
         {"flat": True}, {"burn_in": 2, "thin": 2, "flat": True})


def test_disk_matches_ram_chain_and_jax_disk_chain(tmp_path):
    rngs = [np.random.default_rng(0) for _ in range(3)]
    ram = _fill(Chain(8, 3), rngs[0])
    disk = _fill(DiskChain(tmp_path / "c", 8, 3), rngs[1])
    jdisk = _fill(jref.DiskChain(tmp_path / "j", 8, 3), rngs[2])
    for kw in VIEWS:
        np.testing.assert_array_equal(ram.get(**kw), disk.get(**kw))
        np.testing.assert_array_equal(ram.get_logp(**kw), disk.get_logp(**kw))
        np.testing.assert_array_equal(jdisk.get(**kw), disk.get(**kw))
    assert disk.n_steps == ram.n_steps == jdisk.n_steps == 23
    assert disk.nbytes == jdisk.nbytes and disk.backend == "disk"
    # the spools are the same files: either package opens the other's
    np.testing.assert_array_equal(
        jref.DiskChain.open(tmp_path / "c").get(), disk.get())
    np.testing.assert_array_equal(
        DiskChain.open(tmp_path / "j").get_logp(), jdisk.get_logp())


def test_disk_bf16_rows_go_through_the_manifest_by_name(tmp_path):
    rng = np.random.default_rng(3)
    d = _fill(DiskChain(tmp_path / "c", 4, 2, dtype=torch.bfloat16), rng)
    ram = _fill(Chain(4, 2, dtype="bfloat16"), np.random.default_rng(3))
    d2 = DiskChain.open(tmp_path / "c")
    assert d2.dtype == "bfloat16" and d2.nbytes == 23 * 4 * 3 * 2
    for kw in VIEWS:
        np.testing.assert_array_equal(d2.get(**kw), ram.get(**kw))
        np.testing.assert_array_equal(d2.get_logp(**kw), ram.get_logp(**kw))
    assert d2.get().dtype == np.float32 and d2.get(held=True).dtype == np.int16
    expect = d2.get(burn_in=3, thin=4)
    d2.compact(burn_in=3, thin=4)
    np.testing.assert_array_equal(d2.get(), expect)


def test_disk_reopen_and_resume(tmp_path):
    d = _fill(DiskChain(tmp_path / "c", 4, 2), np.random.default_rng(1))
    before = d.get()
    d2 = DiskChain.open(tmp_path / "c")
    np.testing.assert_array_equal(d2.get(), before)
    d2.append(np.ones((2, 4, 2)), np.ones((2, 4)))
    assert d2.n_steps == before.shape[0] + 2


def test_disk_compact_streams(tmp_path):
    d = _fill(DiskChain(tmp_path / "c", 4, 2), np.random.default_rng(2),
              blocks=(10, 10, 10))
    expect = d.get(burn_in=7, thin=3)
    d.compact(burn_in=7, thin=3)
    np.testing.assert_array_equal(d.get(), expect)
    assert d.n_steps == expect.shape[0]
    assert d.get_logp().shape == (expect.shape[0], 4)


def test_disk_byte_cap_and_reopen_restores_it(tmp_path):
    cap = 5 * 4 * 3 * 4  # 5 rows
    d = DiskChain(tmp_path / "c", 4, 2, max_bytes=cap)
    assert not d.append(np.zeros((8, 4, 2)))  # partial append, EndOfChain
    assert d.n_steps == 5
    d2 = DiskChain.open(tmp_path / "c")
    assert d2.max_bytes == cap and not d2.append(np.zeros((1, 4, 2)))
    assert DiskChain(tmp_path / "c", 4, 2, max_bytes=10 * cap
                     ).max_bytes == 10 * cap


def test_disk_geometry_mismatch_rejected(tmp_path):
    DiskChain(tmp_path / "c", 4, 2).append(np.zeros((1, 4, 2)))
    with pytest.raises(ValueError, match="holds a"):
        DiskChain(tmp_path / "c", 8, 2)


def test_sampler_injection_end_to_end(tmp_path):
    target = skewed_gaussian(device="cpu")

    def run(chain):
        s = EnsembleSampler(target, 64, 2, seed=0, batched=True,
                            device="cpu", chain=chain)
        s.init_ball(np.zeros(2), scale=0.3)
        s.run_mcmc(200, store=False)
        assert s.run_mcmc(400)
        return s

    s = run(DiskChain(tmp_path / "ens", 64, 2))
    assert s.chain.backend == "disk"
    flat = s.get_samples(burn_in=100, flat=True)
    assert abs(float(np.cov(flat.T)[0, 0]) - 1.13) < 0.3
    # the same seed into the in-memory chain: the same rows
    np.testing.assert_array_equal(s.get_samples(), run(None).get_samples())
    with pytest.raises(ValueError, match="geometry"):
        EnsembleSampler(target, 64, 2, batched=True, device="cpu",
                        chain=DiskChain(tmp_path / "bad", 32, 2))


def test_streaming_act_consume_disk_chain(tmp_path):
    rng = np.random.default_rng(0)
    phi, S, W = 0.8, 4000, 8
    x = np.zeros((S, W, 1))
    for t in range(1, S):
        x[t] = phi * x[t - 1] + np.sqrt(1 - phi**2) * rng.normal(size=(W, 1))
    d = DiskChain(tmp_path / "c", W, 1)
    act = analysis.StreamingACT(max_lag=256)
    for i in range(0, S, 700):
        d.append(x[i: i + 700])
        act.consume_chain(d)
    tau_online = act.autocorr_time()
    tau_batch = analysis.autocorr_time(d.get())
    np.testing.assert_allclose(tau_online[0], tau_batch, rtol=0.02)
