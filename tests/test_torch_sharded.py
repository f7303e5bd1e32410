"""The port's multi-device layer on the CPU: row-sharded half-steps, the
rank layout, and ``ShardedEnsembleSampler`` in a two-process gloo group.

Mirrors ``tests/test_sharded.py`` (the layout's shape, bitwise equality, the
rows actually split, the moments, the uneven split rejected, the slice move
bitwise), ``tests/test_multihost.py`` (per-rank chains, acceptance the same
on both ranks, global statistics equal to the whole ensemble's, one gate
decision) and ``tests/test_reference_defects.py::
test_parallel_subsample_resume``.

In-process, every mover and partner mode runs a half-step as R ∈ {2, 4}
row shards (``noise_rows`` + ``apply(row0=...)``) against the whole gathered
other half, and the concatenation must equal the unsharded ``apply`` bit for
bit. The test logps are elementwise torch ops, whose bits do not depend on
the batch size; the MH and DRAM proposals' (n, P) @ (P, P) products are
taken row by row here as well (checked bit for bit below), so no tolerance
is needed anywhere. The port's sharded half-steps also replay the JAX
``ShardedEnsembleSampler`` on the tests' 8-device CPU mesh, through the
replay helpers of ``tests/test_torch_sampler.py`` (atol 1e-5, their
cross-library tolerance: the flagship logp's product is summed in another
order).

The two-process runs happen once, in a module-scoped fixture: two worker
processes join a gloo group, run every scenario and save their results; the
test functions hold them against the unsharded port sampler, run here.
"""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import mcmcpp_tpu as jref
from mcmcpp_tpu import analysis as jan
import mcmcpp_tpu_torch as mt
from mcmcpp_tpu_torch import analysis as pan
from mcmcpp_tpu_torch.convergence import run_until_converged
from mcmcpp_tpu_torch.ops import fused_stretch as fs
from mcmcpp_tpu_torch.ops.random import make_generator, philox_unit_uniforms
from mcmcpp_tpu_torch.parallel import distributed
from mcmcpp_tpu_torch.parallel.mesh import (
    LADDER_AXES,
    WALKER_AXES,
    LadderLayout,
    WalkerLayout,
)
from tests.test_torch_sampler import (
    N_STEPS,
    REPLAY_ATOL,
    THIN,
    W,
    _flagship_chol,
    _fused_noise,
    _jax_logp,
    _start,
    _stretch_noise,
)
from tests.targets import skewed_gaussian_cov
from tests.torch_sharded_cases import (
    HALF,
    MOVERS,
    logp3,
    sharded_case,
    std_normal,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _fixed_planes(noise, n):
    """The slice move draws a shrink plane per loop iteration from the
    generator; in one process the shards would each draw their own, so the
    planes are drawn once here and handed out by index."""
    if not noise or not callable(noise[-1]):
        return noise
    planes = [noise[-1](j) for j in range(64)]
    return (*noise[:-1], lambda j: planes[j])


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("name", list(MOVERS))
def test_row_shards_equal_the_unsharded_half_step(name, shards):
    mover = MOVERS[name]()
    rng = np.random.default_rng(len(name) + shards)
    active = torch.from_numpy(rng.normal(size=(HALF, 3)).astype(np.float32))
    other = torch.from_numpy(
        (1.3 * rng.normal(size=(HALF, 3))).astype(np.float32))
    lp = logp3(active)
    state = mover.init_state(3, torch.float32, CPU)
    noise = _fixed_planes(mover.draw_noise(
        make_generator(1, 0, CPU), HALF, HALF, 3, CPU,
        host_gen=make_generator(1, 2, CPU)), HALF)
    whole = mover.apply(active, lp, other, logp3, state, noise)
    n = HALF // shards
    parts = [mover.apply(active[r0:r0 + n], lp[r0:r0 + n], other, logp3,
                         state, mover.noise_rows(noise, r0, n), row0=r0)
             for r0 in range(0, HALF, n)]
    for k, w in enumerate(whole):
        got = torch.cat([p[k] for p in parts])
        assert torch.equal(got, w), (name, k)
    assert int(whole[2].sum()) > 0


def test_proposal_products_are_taken_row_by_row():
    """The MH and DRAM proposals multiply (n, P) normals by a (P, P)
    factor; on this CPU the rows of a product do not depend on how many
    rows it has (what the bitwise cases above rely on)."""
    x = torch.from_numpy(
        np.random.default_rng(0).normal(size=(HALF, 3)).astype(np.float32))
    l = torch.linalg.cholesky(torch.tensor(
        [[1.0, 0.3, 0.0], [0.3, 0.5, 0.1], [0.0, 0.1, 0.8]]))
    whole = x @ l.T
    assert all(torch.equal(x[r:r + 128] @ l.T, whole[r:r + 128])
               for r in range(0, HALF, 128))


def test_block_fallback_rows_keep_their_draws():
    """Block mode's per-walker fallback (n % 128 != 0) indexes its
    per-group draws by global row: a shard boundary inside a group changes
    no row's partner."""
    from mcmcpp_tpu_torch.ops.partner import (
        draw_partner_noise,
        partner_rows,
        select_partners,
    )

    n = 200
    other = torch.arange(float(n * 2)).reshape(n, 2)
    noise = draw_partner_noise(make_generator(3, 0, CPU), n, n, 2, "block",
                               CPU)
    assert len(noise) == 1
    whole = select_partners(other, n, noise, "block")
    for r0, m in [(0, 50), (50, 100), (150, 50)]:
        got = select_partners(other, m, partner_rows(noise, "block", r0, m),
                              "block", row0=r0)
        assert torch.equal(got, whole[:, r0:r0 + m])


def test_philox_twin_draws_the_counters_of_the_rows():
    key = 0xDEADBEEFCAFEF00D
    u, ue = philox_unit_uniforms(key, 1000, CPU)
    su, sue = philox_unit_uniforms(key, 250, CPU, row0=500)
    assert torch.equal(su, u[500:750]) and torch.equal(sue, ue[500:750])


@pytest.mark.parametrize("target", ["gaussian", "funnel"])
def test_kernel_plain_versions_take_the_row_offset(target):
    """The three kernels' plain versions over R = 4 row shards (each on
    its rows' planes, ``row0``) equal one unsharded call bit for bit, for
    every shift class (the wrap at m inside a shard included)."""
    n, p = 1024, 5
    rng = np.random.default_rng(7)
    logp = (mt.GaussianTarget.from_numpy(
        np.linalg.cholesky(np.eye(p) * 2.0).astype(np.float32), "cpu")
        if target == "gaussian" else mt.neal_funnel(p))
    act = torch.from_numpy(rng.normal(size=(n, p)).astype(np.float32))
    oth = torch.from_numpy(rng.normal(size=(n, p)).astype(np.float32))
    lp = logp(act)
    key = 12345
    u, ue = philox_unit_uniforms(key, n, CPU)
    for s in (0, 1, n - 1, n - 100, -7, 3 * n + 5):
        shift = torch.tensor([s], dtype=torch.int32)
        whole = fs.fused_stretch_half(act, lp, oth, shift, u, ue,
                                      logp_fn=logp)
        parts = []
        for r0 in range(0, n, n // 4):
            rows = slice(r0, r0 + n // 4)
            su, sue = philox_unit_uniforms(key, n // 4, CPU, row0=r0)
            parts.append(fs.fused_stretch_half(
                act[rows], lp[rows], oth, shift, su, sue, logp_fn=logp,
                row0=r0))
        for k in range(3):
            assert torch.equal(torch.cat([q[k] for q in parts]), whole[k])


def test_row_offset_outside_the_half_is_refused():
    act, oth = torch.zeros((8, 2)), torch.zeros((16, 2))
    shift = torch.zeros(1, dtype=torch.int32)
    u = torch.full((8,), 0.5)
    with pytest.raises(ValueError, match="equal halves"):
        fs.stretch_propose_reference(act, oth, shift, u, row0=9)
    from mcmcpp_tpu_torch.ops.partner import select_partners

    with pytest.raises(ValueError, match="do not lie"):
        select_partners(oth, 8, shift, "roll", row0=12)


def _run_port_sharded(mover, noises, shards):
    """The port's sharded half-steps on replayed noise: each half-step as
    ``shards`` row shards against the whole other half, N_STEPS steps at
    THIN, as ShardedEnsembleSampler's ranks run them."""
    target = mt.GaussianTarget.from_numpy(_flagship_chol(), "cpu")
    x = torch.from_numpy(_start())
    half, n = W // 2, W // 2 // shards
    red, black = x[:half], x[half:]
    lp_red, lp_black = target(red), target(black)
    acc = torch.zeros(W, dtype=torch.int64)
    noises, rows = iter(noises), []
    for step in range(N_STEPS):
        for colour in (0, 1):
            active, lp = (red, lp_red) if colour == 0 else (black, lp_black)
            other = black if colour == 0 else red
            noise = next(noises)
            parts = [mover.apply(active[r0:r0 + n], lp[r0:r0 + n], other,
                                 target, (), mover.noise_rows(noise, r0, n),
                                 row0=r0)
                     for r0 in range(0, half, n)]
            new, new_lp, a = (torch.cat([p[k] for p in parts])
                              for k in range(3))
            acc[colour * half:(colour + 1) * half] += a.to(torch.int64)
            if colour == 0:
                red, lp_red = new, new_lp
            else:
                black, lp_black = new, new_lp
        if (step + 1) % THIN == 0:
            rows.append(torch.cat([red, black]).numpy())
    return np.stack(rows), acc.numpy()


def _run_jax(cls, mover, seed):
    from mcmcpp_tpu.ops.random import split_for_step

    s = cls(_jax_logp(_flagship_chol()), W, 10, mover=mover, seed=seed,
            batched=True)
    s.set_initial_walker_pos(_start())
    assert s.run_mcmc(N_STEPS, thin=THIN)
    keys = [k for step in range(N_STEPS)
            for k in split_for_step(s._effective_step_key(), step)]
    return s, keys


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("name", ["stretch", "fused"])
def test_sharded_half_steps_replay_jax_sharded_sampler(name, shards):
    """The stretch move against JAX's ShardedEnsembleSampler over the 8
    CPU devices; the fused kernel against JAX's EnsembleSampler, which its
    sharded sampler equals bit for bit but which alone runs the Pallas
    kernel in interpret mode (GSPMD cannot partition interpret mode's host
    callback)."""
    from mcmcpp_tpu.movers.fused import FusedStretchMove as JFused

    if name == "stretch":
        j, keys = _run_jax(jref.ShardedEnsembleSampler, jref.StretchMove(),
                           seed=5)
        assert j.mesh.size == len(jax.devices()) == 8
        noises = [_stretch_noise(k, W // 2) for k in keys]
        mover = mt.StretchMove()
    else:
        j, keys = _run_jax(jref.EnsembleSampler,
                           JFused(tile=32, interpret=True), seed=9)
        noises = [_fused_noise(k, W // 2) for k in keys]
        mover = mt.FusedStretchMove()
    rows, acc = _run_port_sharded(mover, noises, shards)
    np.testing.assert_allclose(rows, j.get_samples(), rtol=0,
                               atol=REPLAY_ATOL)
    np.testing.assert_array_equal(acc, j.per_walker_accepted)


def test_layout_rows_and_uneven_split():
    lay = WalkerLayout(world_size=4, rank=2, device=CPU)
    assert lay.rows(64) == (32, 16)
    assert lay.size == 4 and lay.axis_names == WALKER_AXES
    assert lay.shape == {"hosts": 4, "devices": 1}
    with pytest.raises(ValueError, match="divisible"):
        lay.rows(6)
    ladder = LadderLayout(2, world_size=4, rank=3, device=CPU)
    assert ladder.axis_names == LADDER_AXES
    assert ladder.shape == {"ladder": 2, "walkers": 2}
    assert (ladder.ladder_index, ladder.walker_index) == (1, 1)
    with pytest.raises(ValueError, match="ladder"):
        LadderLayout(3, world_size=4, rank=0, device=CPU)


def test_layouts_need_a_process_group():
    if torch.distributed.is_initialized():
        pytest.skip("this process is in a process group")
    with pytest.raises(RuntimeError, match="initialize"):
        mt.make_walker_mesh()
    with pytest.raises(RuntimeError, match="initialize"):
        mt.ShardedEnsembleSampler(logp3, 8, 3, batched=True, device="cpu")
    assert distributed.world_size() == 1 and not distributed.is_multihost()
    assert distributed.process_allgather(torch.arange(3)).shape == (1, 3)


# -- two gloo ranks -----------------------------------------------------------

WORKER = textwrap.dedent("""
    import sys
    rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from mcmcpp_tpu_torch.parallel import distributed
    assert distributed.initialize(f"localhost:{{port}}", 2, rank,
                                  device="cpu") == (rank, 2)
    assert distributed.initialize() == (rank, 2)  # idempotent
    import mcmcpp_tpu_torch as mt
    from mcmcpp_tpu_torch import analysis as an
    from mcmcpp_tpu_torch.chain import fetch_addressable
    from mcmcpp_tpu_torch.convergence import run_until_converged
    from tests.torch_sharded_cases import (
        MOVERS, sharded_case, skewed, std_normal)

    res = {{}}
    mesh = mt.make_walker_mesh()
    res["mesh"] = [mesh.size, mesh.rank, mesh.shape["hosts"],
                   mesh.shape["devices"], int(mesh.device.type == "cpu")]
    res["ladder"] = list(mt.make_ladder_mesh(2).shape.values())
    res["multihost"] = distributed.is_multihost()
    res["gathered"] = distributed.process_allgather(torch.tensor([rank, 7]))

    for name in MOVERS:
        s = sharded_case(mt.ShardedEnsembleSampler, name)
        res[name + "/samples"] = s.get_samples()
        res[name + "/logps"] = s.get_log_probs()
        res[name + "/pos"] = s.current_positions.numpy()
        res[name + "/acc"] = s.accepted_steps
        res[name + "/frac"] = s.acceptance_fraction
        res[name + "/pwa"] = s.per_walker_accepted
    res["fetched"] = np.array_equal(
        fetch_addressable(s.state.red), s.current_positions[:256].numpy())

    s = mt.ShardedEnsembleSampler(std_normal, 64, 2, seed=0, batched=True)
    s.init_ball(np.zeros(2), scale=0.5, seed=1)
    s.run_mcmc(50)
    res["spmd/shape"] = s.get_samples().shape
    res["spmd/frac"] = s.acceptance_fraction

    s = mt.ShardedEnsembleSampler(std_normal, 64, 2, seed=0, batched=True)
    s.init_ball(np.zeros(2), scale=0.5, seed=1)
    s.run_mcmc(200)
    local = s.get_samples().astype(np.float64)
    res["gstat/local"] = local
    nk = local.shape[0] * local.shape[1]
    kw = dict(device="cpu")
    res["gstat/tau"] = an.global_autocorr_time(local, **kw)
    res["gstat/ess"] = an.global_effective_sample_size(local, **kw)
    res["gstat/cov"] = an.global_covariance_matrix(local, **kw)
    res["gstat/corr"] = an.global_correlation_matrix(local, **kw)
    res["gstat/rhat"] = an.global_split_rhat(local, **kw)
    res["gstat/bm"] = an.global_batch_means_ess(local, **kw)
    res["gstat/mess"] = an.global_multivariate_ess(local, **kw)
    res["gstat/bulk"] = an.global_ess_bulk(local, max_knots=nk, **kw)
    res["gstat/tail"] = an.global_ess_tail(local, max_knots=nk, **kw)
    res["gstat/rr"] = an.global_rank_normalized_rhat(local, max_knots=nk,
                                                     **kw)
    res["gstat/mcse"] = an.global_mcse_mean(local, **kw)
    for k, v in an.global_summary(local, max_knots=nk, **kw).items():
        res["gsum/" + k] = v

    for label, extra in [("gate", dict(rhat_threshold=2.0, mess_rule=True)),
                         ("nested", dict(nested_superchains=4))]:
        s = mt.ShardedEnsembleSampler(std_normal, 64, 2, seed=7,
                                      batched=True)
        s.init_ball(np.zeros(2), scale=0.5, seed=8)
        rep = run_until_converged(s, max_steps=100, check_every=50, **extra)
        res[label + "/conv"] = rep.converged
        res[label + "/reason"] = rep.reason
        res[label + "/checks"] = rep.checks
        for f in ("tau", "rhat", "mess", "nested"):
            v = getattr(rep, f)
            res[f"{{label}}/{{f}}"] = np.nan if v is None else v

    s = mt.ShardedEnsembleSampler(std_normal, 32, 2, seed=5, batched=True)
    s.init_ball(np.zeros(2), scale=0.3, seed=6)
    s.run_mcmc(60, thin=5)
    res["thin/stored"] = s.stored_steps
    res["thin/samples"] = s.get_samples()

    s = mt.ShardedEnsembleSampler(skewed, 256, 2, seed=11, batched=True)
    s.init_ball(np.zeros(2), scale=0.5, seed=5)
    s.run_mcmc(500, store=False)
    s.run_mcmc(2000)
    res["moments/cov"] = an.global_covariance_matrix(s.get_samples(), **kw)

    for label, make in [
            ("uneven", lambda: mt.ShardedEnsembleSampler(std_normal, 6, 2,
                                                        batched=True)),
            ("cuda_under_gloo", lambda: mt.ShardedEnsembleSampler(
                std_normal, 8, 2, batched=True, device="cuda"))]:
        try:
            make()
            res[label] = "no error"
        except (ValueError, RuntimeError) as e:
            res[label] = type(e).__name__ + ": " + str(e)

    import contextlib, io
    from mcmcpp_tpu_torch.examples import actime, inner_benchmark
    for label, main, argv in [
            ("actime", actime.main, ["--steps", "8192", "--rtol", "0.3",
                                     "--walkers", "102"]),
            ("inner", inner_benchmark.main, ["--steps", "300", "--walkers",
                                             "242"])]:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res[f"ex/{{label}}/rc"] = main(["--device", "cpu", "--sharded",
                                           *argv])
        res[f"ex/{{label}}/out"] = buf.getvalue()
    res["still_grouped"] = distributed.is_multihost()
    from mcmcpp_tpu_torch.io.checkpoint import save_checkpoint
    try:
        save_checkpoint(s, f"{{out}}/ckpt{{rank}}")
        res["checkpoint"] = "saved"
    except NotImplementedError as e:
        res["checkpoint"] = str(e)

    np.savez(f"{{out}}/rank{{rank}}.npz",
             **{{k: np.asarray(v) for k, v in res.items()}})
    print("WORKER DONE", rank)
""").format(repo=str(REPO))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results of one two-process gloo run."""
    out = tmp_path_factory.mktemp("sharded")
    script = out / "worker.py"
    script.write_text(WORKER)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(port), str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO,
        env=env) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-4000:]
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]


def _assemble(parts):
    """The whole chain (S, W, ...) from the ranks' (S, 2·n_local, ...)
    shards, whose columns are [red_local, black_local]."""
    halves = [np.split(p, 2, axis=1) for p in parts]
    return np.concatenate([h[0] for h in halves] + [h[1] for h in halves],
                          axis=1)


def test_mesh_shapes(ranks):
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["mesh"], [2, r, 2, 1, 1])
        np.testing.assert_array_equal(res["ladder"], [2, 1])
        assert bool(res["multihost"])
        np.testing.assert_array_equal(res["gathered"], [[0, 7], [1, 7]])


@pytest.mark.parametrize("name", list(MOVERS))
def test_sharded_bitwise_matches_single_device(ranks, name):
    """Two ranks == the unsharded sampler, bit for bit: the stored rows,
    their logps, the final positions and the accept counts; the summed
    acceptance is the same on both ranks."""
    seq = sharded_case(mt.EnsembleSampler, name)
    np.testing.assert_array_equal(
        _assemble([res[name + "/samples"] for res in ranks]),
        seq.get_samples())
    np.testing.assert_array_equal(
        _assemble([res[name + "/logps"] for res in ranks]),
        seq.get_log_probs())
    np.testing.assert_array_equal(
        _assemble([res[name + "/pos"][None] for res in ranks])[0],
        seq.current_positions.numpy())
    np.testing.assert_array_equal(
        _assemble([res[name + "/pwa"][None] for res in ranks])[0],
        seq.per_walker_accepted)
    for res in ranks:
        assert int(res[name + "/acc"]) == seq.accepted_steps
        assert float(res[name + "/frac"]) == seq.acceptance_fraction


def test_sharded_state_is_actually_sharded(ranks):
    a, b = (res["stretch_roll/pos"] for res in ranks)
    assert a.shape == b.shape == (HALF, 3)  # 2 × 256 rows of 1024 walkers
    assert ranks[0]["stretch_roll/samples"].shape == (10, HALF, 3)
    assert not np.array_equal(a, b)
    assert all(bool(res["fetched"]) for res in ranks)


def test_sharded_moments(ranks):
    covs = [res["moments/cov"] for res in ranks]
    np.testing.assert_array_equal(covs[0], covs[1])
    np.testing.assert_allclose(covs[0], skewed_gaussian_cov(), atol=0.12)


def test_uneven_shard_rejected(ranks):
    for res in ranks:
        assert str(res["uneven"]).startswith("ValueError"), res["uneven"]


def test_cuda_sampler_under_gloo_raises(ranks):
    """No fallback: a sampler asking for the card under a gloo group (or on
    a box without one) raises."""
    for res in ranks:
        assert str(res["cuda_under_gloo"]) != "no error"


def test_sharded_slice_move_bitwise(ranks):
    """The slice move's loop tests are all-reduced: both ranks run the
    unsharded loop's iterations (the roll and gather cases of
    test_sharded_bitwise_matches_single_device), so their shrink draws stay
    in step; here the stored rows move and differ between ranks."""
    for name in ("slice_roll", "slice_gather"):
        a, b = (res[name + "/samples"] for res in ranks)
        assert a.shape == b.shape == (5, HALF, 3)
        assert not np.array_equal(a[0], a[-1]) and not np.array_equal(a, b)


def test_two_process_spmd(ranks):
    for res in ranks:
        assert tuple(res["spmd/shape"]) == (50, 32, 2)
    assert float(ranks[0]["spmd/frac"]) == float(ranks[1]["spmd/frac"])


def test_parallel_subsample_resume(ranks):
    """60 steps at thin 5 store 12 rows on each rank, and saving went on
    (the reference's threaded controllers stored only the first)."""
    for res in ranks:
        assert int(res["thin/stored"]) == 12
        x = res["thin/samples"]
        assert x.shape == (12, 16, 2) and not np.allclose(x[0], x[-1])


def _whole_chain(ranks):
    return _assemble([res["gstat/local"] for res in ranks])


# moments and sums in float64: the same sufficient statistics combined in
# another order
MOMENT_RTOL = 1e-10
# the autocovariance FFT runs in float32 in both packages (jnp.fft there,
# torch.fft here): the tolerance of tests/test_torch_analysis_rest.py
FFT_RTOL = 1e-5


def test_two_process_global_diagnostics(ranks):
    """Each global_* of the two shards, the same on both ranks, equals the
    port's whole-ensemble function on the assembled chain (1e-10) and the
    JAX package's (1e-10 for the moments, FFT_RTOL where a float32 FFT of
    each library is taken)."""
    full = _whole_chain(ranks)
    assert full.shape == (200, 64, 2)
    for key in ranks[0]:
        if key.startswith(("gstat/", "gsum/")) and key != "gstat/local":
            np.testing.assert_array_equal(ranks[0][key], ranks[1][key])
    g = ranks[0]
    nk = 200 * 32
    ours = {
        "tau": pan.autocorr_time(full, device="cpu"),
        "ess": pan.effective_sample_size(full, device="cpu"),
        "cov": pan.covariance_matrix(full, device="cpu"),
        "rhat": pan.potential_scale_reduction(full, rank_normalized=False),
        "bm": pan.batch_means_ess(full),
        "mess": pan.multivariate_ess(full),
        "bulk": pan.ess_bulk(full, device="cpu"),
        "tail": pan.ess_tail(full, device="cpu"),
        "rr": pan.potential_scale_reduction(full, rank_normalized=True),
        "mcse": pan.mcse_mean(full, device="cpu"),
    }
    jax_whole = {
        "tau": (jan.autocorr_time(full), FFT_RTOL),
        "ess": (jan.effective_sample_size(full), FFT_RTOL),
        "cov": (jan.global_covariance_matrix(full), MOMENT_RTOL),
        "rhat": (jan.potential_scale_reduction(full, rank_normalized=False),
                 MOMENT_RTOL),
        "bm": (jan.batch_means_ess(full), MOMENT_RTOL),
        "mess": (jan.multivariate_ess(full), MOMENT_RTOL),
        "bulk": (jan.ess_bulk(full), FFT_RTOL),
        "tail": (jan.ess_tail(full), FFT_RTOL),
        "rr": (jan.potential_scale_reduction(full, rank_normalized=True),
               1e-9),
        "mcse": (jan.mcse_mean(full), FFT_RTOL),
    }
    for key, want in ours.items():
        np.testing.assert_allclose(g["gstat/" + key], want,
                                   rtol=MOMENT_RTOL, err_msg=key)
        jwant, rtol = jax_whole[key]
        np.testing.assert_allclose(g["gstat/" + key], jwant, rtol=rtol,
                                   err_msg=key)
    np.testing.assert_allclose(g["gstat/corr"],
                               jan.global_correlation_matrix(full),
                               rtol=MOMENT_RTOL)
    local = pan.summary(full, prob=0.9, device="cpu")
    for key, want in local.items():
        rtol = MOMENT_RTOL if key in ("mean", "sd") else 1e-9
        np.testing.assert_allclose(g["gsum/" + key], want, rtol=rtol,
                                   atol=1e-12, err_msg=key)
    assert nk == ranks[0]["gstat/local"].shape[0] * 32


def test_two_process_gate_takes_one_decision(ranks):
    """run_until_converged under two ranks (multihost=None: on) takes one
    decision on both, the decision a single process takes on the same
    whole ensemble."""
    for label, extra in [("gate", dict(rhat_threshold=2.0, mess_rule=True)),
                         ("nested", dict(nested_superchains=4))]:
        a, b = ranks
        for f in ("conv", "reason", "checks", "tau", "rhat", "mess",
                  "nested"):
            np.testing.assert_array_equal(a[f"{label}/{f}"],
                                          b[f"{label}/{f}"])
        s = mt.EnsembleSampler(std_normal, 64, 2, seed=7, batched=True,
                               device="cpu")
        s.init_ball(np.zeros(2), scale=0.5, seed=8)
        rep = run_until_converged(s, max_steps=100, check_every=50,
                                  multihost=False, **extra)
        assert bool(a[label + "/conv"]) == rep.converged
        assert str(a[label + "/reason"]) == rep.reason
        assert int(a[label + "/checks"]) == rep.checks
        np.testing.assert_allclose(a[label + "/tau"], rep.tau, rtol=1e-10)
        if label == "nested":
            np.testing.assert_allclose(a["nested/nested"], rep.nested,
                                       rtol=1e-12)
        else:
            np.testing.assert_allclose(a["gate/mess"], rep.mess, rtol=1e-10)


def test_sharded_examples(ranks):
    """actime and inner_benchmark with --sharded in the two-rank group:
    the walkers padded so that each half divides by 2, inside their
    tolerances, and the group (not theirs) left as it was."""
    for res in ranks:
        assert int(res["ex/actime/rc"]) == 0 and int(res["ex/inner/rc"]) == 0
        assert "104 walkers on 2 rank(s)" in str(res["ex/actime/out"])
        out = str(res["ex/inner/out"])
        assert "walkers=244" in out and "oracle 0.390625" in out
        assert bool(res["still_grouped"])


def test_sharded_checkpoint_is_refused(ranks):
    """A rank holds only its walkers: saving one as an ensemble checkpoint
    raises (the JAX package has no sharded kind either)."""
    for res in ranks:
        assert "over 2 ranks" in str(res["checkpoint"])


def test_append_device_chunk_takes_the_local_width():
    """An empty chain of another walker width is rebuilt at the chunk's
    (a rank's) width; after rows were stored a width change raises; a
    tensor's host copy is its numpy."""
    from mcmcpp_tpu_torch.chain import (
        Chain,
        append_device_chunk,
        fetch_addressable,
    )

    chain = Chain(n_walkers=8, n_params=2, max_bytes=1 << 20)
    pos, logp = torch.randn((3, 4, 2)), torch.randn((3, 4))
    chain, ok = append_device_chunk(chain, pos, logp)
    assert ok and chain.n_walkers == 4 and chain.max_bytes == 1 << 20
    np.testing.assert_array_equal(chain.get(), pos.numpy())
    with pytest.raises(RuntimeError, match="width"):
        append_device_chunk(chain, torch.randn((1, 8, 2)), None)
    np.testing.assert_array_equal(fetch_addressable(pos, 1), pos.numpy())
