"""``mesh=`` of the MCMC and evidence engines on the CPU: the gradient
samplers (HMC, MALA, Barker, NUTS, ChEES, MEADS, SGLD, SGHMC, MCLMC, MAMS),
parallel tempering on a walker and a ladder layout (and in power mode),
blocked Gibbs, pCN, the elliptical slice, SMC and nested sampling.

Mirrors the JAX package's mesh tests: ``tests/test_sharded_gradient.py``,
``test_tempering.py:98-177``, ``test_gibbs.py:162``, ``test_pcn.py:106``,
``test_elliptical.py:124``, ``test_mclmc.py``, ``test_sgmcmc.py``,
``test_meads.py``, ``test_evidence.py``, ``test_nested.py:105-130`` and
``test_multihost.py::test_two_process_engines_hmc_pt_smc``.

- In one process, the ranks of a layout are threads (``tests/
  torch_sharded_engine_cases.py``): every engine sharded over R ∈ {2, 4}
  ranks equals the unsharded engine bit for bit (the rows of every rank put
  together, and every replicated statistic on every rank). The test
  targets are elementwise torch ops, whose bits do not depend on the batch
  size on this CPU; pCN's and the elliptical slice's (n, P) × (P, P) prior
  products, which could, are taken row by row here (checked bit for bit
  below).
- The three runs that JAX's tests make on its 8-device CPU mesh (PT on
  ``make_ladder_mesh(8)``, blocked Gibbs and nested sampling on
  ``make_walker_mesh()``, at those tests' sizes) are replayed over 8 thread
  ranks with JAX's draws, within the tolerances of the unsharded replays in
  ``tests/test_torch_{tempering,gibbs,nested}.py``.
- Two processes join a gloo group once, in a module fixture, and run every
  engine: each equals the unsharded engine here bit for bit, with the
  per-rank shapes and equal replicated statistics of
  ``test_two_process_engines_hmc_pt_smc``; checkpoints are refused.
- On the card: ``tests/test_torch_sharded_engines_card.py`` (no JAX).
"""

import functools
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmcpp_tpu as jref
from mcmcpp_tpu import gibbs as jg
from mcmcpp_tpu import nested as jnest
import mcmcpp_tpu_torch as mt
from mcmcpp_tpu_torch.parallel.mesh import WalkerLayout
from tests.test_torch_gibbs import ess_noise, mala_noise
from tests.test_torch_nested import jax_iteration_noise, jax_prior, model
from tests.test_torch_tempering import jax_step_noise, port_state
from tests.torch_sharded_engine_cases import (
    ENGINES,
    LADDER,
    ThreadLadderLayout,
    assemble,
    logp,
    run_in_threads,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
# the unsharded replays' tolerances (float32, the logps and proposals in
# another order than JAX's)
REPLAY_TOL = 1e-5
NESTED_TOL = 1e-6


@functools.lru_cache(maxsize=None)
def unsharded(name):
    return (ENGINES[name] if name in ENGINES else LADDER[name])(None)


def _check(name, results, ranks_of_a_copy=None):
    """The ranks' ``results`` against the unsharded run of ``name``; under
    a ladder layout of several walker shards, ``ranks_of_a_copy`` are the
    ranks whose cold-chain columns make one copy (ladder shard 0)."""
    want = unsharded(name)
    assert set(results[0]) == set(want)
    for key, value in want.items():
        if key.startswith("same:"):
            for r, res in enumerate(results):
                np.testing.assert_array_equal(np.asarray(res[key]),
                                              np.asarray(value),
                                              err_msg=f"{name} {key} rank {r}")
            continue
        parts = [results[r][key] for r in (ranks_of_a_copy
                                           or range(len(results)))]
        np.testing.assert_array_equal(assemble(key, parts), value,
                                      err_msg=f"{name} {key}")


# -- in one process: the ranks are threads ------------------------------------


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(ENGINES))
def test_engine_shards_equal_the_unsharded_engine(name, world):
    results = run_in_threads(world, ENGINES[name])
    _check(name, results)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(LADDER))
def test_ladder_layout_equals_the_unsharded_ladder(name, world):
    """Two ladder shards of the four rungs (one or two walker shards each):
    the half-steps on the rank's rungs, the exchange phases on the gathered
    grids; every rank of a walker shard stores the same cold columns."""
    results = run_in_threads(world, LADDER[name], n_ladder_shards=2)
    wd = world // 2
    _check(name, results, ranks_of_a_copy=range(wd))
    for r in range(wd, world):
        for key in results[0]:
            if key.startswith("halves:"):
                np.testing.assert_array_equal(results[r][key],
                                              results[r % wd][key])


def test_prior_products_are_taken_row_by_row():
    """pCN's and the elliptical slice's (n, P) × (P, P) prior product on
    this CPU: a rank's rows equal the same rows of the whole product (what
    the bitwise pCN and elliptical cases rely on; where a matmul blocks by
    the row count, a rank's rows can differ in their last bits)."""
    rng = np.random.default_rng(0)
    z = torch.from_numpy(rng.normal(size=(16, 4)).astype(np.float32))
    chol = torch.linalg.cholesky(torch.from_numpy(
        (np.eye(4) + 0.3).astype(np.float32)))
    whole = z @ chol.T
    for n in (8, 4):
        assert all(torch.equal(z[r:r + n] @ chol.T, whole[r:r + n])
                   for r in range(0, 16, n))


def test_logaddexp_bits_do_not_depend_on_the_length():
    """NUTS and Barker take log(e^a + e^b) of a rank's rows: the port's form
    gives each element the bits it gets in the whole batch (torch's CPU
    logaddexp does not) and agrees with torch's to a few ulp."""
    from mcmcpp_tpu_torch.gradient.hmc import _logaddexp

    rng = np.random.default_rng(1)
    a, b = (torch.from_numpy(3 * rng.normal(size=48).astype(np.float32))
            for _ in range(2))
    whole = _logaddexp(a, b)
    for n in (8, 12, 16, 24):
        assert all(torch.equal(_logaddexp(a[r:r + n], b[r:r + n]),
                               whole[r:r + n]) for r in range(0, 48 - n, n))
    np.testing.assert_allclose(whole, torch.logaddexp(a, b), rtol=1e-6)
    inf = torch.tensor([-torch.inf, torch.inf, -torch.inf])
    np.testing.assert_array_equal(
        _logaddexp(inf, torch.tensor([-torch.inf, torch.inf, 1.0])),
        [-np.inf, np.inf, 1.0])


UNEVEN = {
    "hmc": lambda m: mt.HMCSampler(logp, 16, 3, mesh=m),
    "nuts": lambda m: mt.NUTSSampler(logp, 16, 3, mesh=m),
    "meads": lambda m: mt.MEADSSampler(logp, 16, 3, n_folds=2, mesh=m),
    "sgld": lambda m: mt.SGLDSampler(logp, lambda t, b: logp(t), np.zeros(
        (8, 3)), 16, 3, batch_size=4, mesh=m),
    "mclmc": lambda m: mt.MCLMCSampler(logp, 16, 3, mesh=m),
    "pt": lambda m: mt.ParallelTemperingSampler(logp, 10, 2, n_temps=2,
                                                mesh=m),
    "gibbs": lambda m: mt.BlockedGibbsSampler(
        [("x", 2, mt.RWMKernel(lambda x, o: -x @ x, 0.5))], 16, mesh=m),
    "pcn": lambda m: mt.PCNSampler(logp, np.zeros(3), prior_scale=np.ones(
        3), n_chains=16, mesh=m),
    "elliptical": lambda m: mt.EllipticalSliceSampler(
        logp, np.zeros(3), prior_scale=np.ones(3), n_chains=16, mesh=m),
    "smc": lambda m: mt.SMCSampler(logp, logp, lambda g, n: torch.randn(
        (n, 3), generator=g), 16, 3, mesh=m),
    "nested": lambda m: mt.NestedSampler(logp, logp, lambda g, n: torch.randn(
        (n, 2), generator=g), 2, n_live=64, batch=16, mesh=m),
}


@pytest.mark.parametrize("name", list(UNEVEN))
def test_uneven_split_raises(name):
    """An axis that does not split evenly over the layout's ranks raises, in
    the JAX package's words (``n_chains=16 not divisible by mesh size 3``),
    before any process group is asked."""
    with pytest.raises(ValueError, match="not divisible"):
        UNEVEN[name](WalkerLayout(3, 0, CPU))


def test_ladder_split_raises():
    """``test_tempering.py:168-177``: a ladder of 6 rungs on 4 ladder
    shards, and a half of 5 walkers on 2 walker shards."""
    lay = ThreadLadderLayout(4, 4, 0, CPU)
    with pytest.raises(ValueError, match="ladder shards"):
        mt.ParallelTemperingSampler(logp, 16, 2, n_temps=6, batched=True,
                                    mesh=lay)
    with pytest.raises(ValueError, match="walker shards"):
        mt.ParallelTemperingSampler(logp, 10, 2, n_temps=4, batched=True,
                                    mesh=ThreadLadderLayout(2, 4, 0, CPU))
    with pytest.raises(NotImplementedError, match="WalkerLayout"):
        mt.ParallelTemperingSampler(logp, 16, 2, n_temps=4, batched=True,
                                    mover=mt.EnsembleSliceMove(), mesh=lay)


def test_walker_layout_rows_names_the_axis():
    lay = WalkerLayout(4, 1, CPU)
    assert lay.rows(16, "n_chains") == (4, 4)
    with pytest.raises(ValueError, match=r"^n_chains=10 not divisible by "
                                         r"mesh size 4$"):
        lay.rows(10, "n_chains")
    # the ensemble's own words stay as they were
    with pytest.raises(ValueError, match="n_walkers/2 = 10 must be"):
        lay.rows(10)


# -- JAX's runs on its 8-device mesh, replayed over 8 thread ranks ----------


def _t(x):
    return torch.from_numpy(np.array(x))


def t_bimodal(t):
    """``tests/test_tempering.py::bimodal_logp`` (SEP = 8)."""
    return torch.logaddexp(-0.5 * torch.sum((t - 4.0) ** 2),
                           -0.5 * torch.sum((t + 4.0) ** 2))


def test_ladder_pt_replays_jax_on_the_ladder_mesh():
    """``test_ladder_sharded_pt_bitwise_identical``'s sampler (16 walkers,
    16 rungs over ``make_ladder_mesh(8)``, swaps every other step): an
    exchange step of each parity (the step counter set to 1 and to 3) from
    JAX's state with JAX's draws, each of 8 ranks holding two rungs. Parity
    0 pairs rungs within a rank; parity 1 pairs (1, 2), (3, 4), …, every
    pair across two ranks."""
    from mcmcpp_tpu.parallel.mesh import make_ladder_mesh
    from tests.test_tempering import SEP, bimodal_logp

    j = jref.ParallelTemperingSampler(
        bimodal_logp, n_walkers=16, n_params=2, n_temps=16, seed=5,
        mesh=make_ladder_mesh(8), swap_every=2)
    j.init_ball(np.full(2, SEP / 2), scale=0.5, seed=6)
    jax_step = jax.jit(j._step)
    for step in (1, 3):
        state = j.state._replace(step=jnp.asarray(step, j.state.step.dtype))
        noise = jax_step_noise(j, state)
        want = jax_step(state)
        whole = port_state(state)

        def rank_step(layout):
            t = mt.ParallelTemperingSampler(t_bimodal, 16, 2, n_temps=16,
                                            swap_every=2, mesh=layout)
            block = whole._replace(**{
                f: t._own(getattr(whole, f))
                for f in ("red", "black", "logp_red", "logp_black")})
            return t.step(block, noise)

        got = run_in_threads(8, rank_step, n_ladder_shards=8)
        for f in ("red", "black", "logp_red", "logp_black"):
            np.testing.assert_allclose(
                torch.cat([getattr(g, f) for g in got]).numpy(),
                np.asarray(getattr(want, f)), rtol=REPLAY_TOL,
                atol=REPLAY_TOL, err_msg=f)
        for g in got:
            np.testing.assert_array_equal(g.swaps_accepted.numpy(),
                                          np.asarray(want.swaps_accepted))
            np.testing.assert_array_equal(g.swaps_proposed.numpy(),
                                          np.asarray(want.swaps_proposed))
        assert int(np.asarray(want.swaps_accepted).sum()) > 0


def test_gibbs_replays_jax_on_the_walker_mesh():
    """``test_gibbs.py::test_mesh_bitwise_identical``'s sampler (16 chains,
    MALA and an elliptical slice block, its shrink loop capped at 16
    iterations here) on ``make_walker_mesh()``: a sweep from JAX's state
    with JAX's per-chain draws, 2 chains a rank."""

    def j_x(x, o):
        return -0.5 * jnp.sum(x * x)

    def j_z(z, o):
        return -0.5 * jnp.sum((z - o["x"].sum()) ** 2)

    j = jg.BlockedGibbsSampler(
        [("x", 2, jg.MALAKernel(j_x, step_size=0.5)),
         ("z", 3, jg.EllipticalSliceKernel(j_z, prior_scale=jnp.ones(3),
                                           max_shrink=16))],
        n_chains=16, seed=5, mesh=jref.make_walker_mesh())
    rng = np.random.default_rng(3)
    j.init({"x": rng.normal(size=(16, 2)).astype(np.float32),
            "z": rng.normal(size=(16, 3)).astype(np.float32)})
    keys = jax.random.split(jax.random.key(15), 16)
    want = jax.jit(jax.vmap(j._sweep))(keys, j.state)
    noises = [mala_noise([jax.random.fold_in(k, 0) for k in keys], 2),
              ess_noise([jax.random.fold_in(k, 1) for k in keys], 3, 16)]
    start = {n: np.asarray(v) for n, v in j.state.items()}

    def rank_sweep(layout):
        t = mt.BlockedGibbsSampler(
            [("x", 2, mt.MALAKernel(
                lambda x, o: -0.5 * torch.sum(x * x), 0.5)),
             ("z", 3, mt.EllipticalSliceKernel(
                 lambda z, o: -0.5 * torch.sum((z - o["x"].sum()) ** 2),
                 prior_scale=np.ones(3), max_shrink=16))],
            n_chains=16, mesh=layout)
        t.init(start)
        return t.sweep(t.state, noises)

    got = run_in_threads(8, rank_sweep)
    for name in ("x", "z"):
        np.testing.assert_allclose(
            torch.cat([g[name] for g in got]).numpy(), np.asarray(want[name]),
            rtol=REPLAY_TOL, atol=REPLAY_TOL, err_msg=name)


def test_nested_replays_jax_on_the_walker_mesh():
    """``test_nested.py::test_mesh_sharded_matches_unsharded``'s sampler
    (64 live points, batches of 16, 10 stretch steps) on
    ``make_walker_mesh()``: three iterations of the ledger from JAX's live
    set with JAX's draws, 2 regrowth walkers a rank; every rank's result
    is JAX's."""
    jlp, jll = model(jnp)
    j = jnest.NestedSampler(jlp, jll, jax_prior, 2, n_live=64, batch=16,
                            n_mcmc=10, seed=3, mesh=jref.make_walker_mesh())
    key, k_init = jax.random.split(j._key)
    live0 = np.asarray(jax_prior(k_init, 64).astype(j.dtype))
    noises = []
    for _ in range(3):
        key, k_it = jax.random.split(key)
        noises.append(jax_iteration_noise(j, k_it))
    want = j.run(max_iters=3)

    def rank_run(layout):
        t = mt.NestedSampler(*model(torch), None, 2, n_live=64, batch=16,
                             n_mcmc=10, batched=True, mesh=layout)
        t._prior_sample = lambda gen, n: _t(live0)
        it = iter(noises)
        t.draw_noise = lambda: next(it)
        return t.run(max_iters=3)

    for got in run_in_threads(8, rank_run):
        assert got.n_iters == want.n_iters and got.n_calls == want.n_calls
        for name in ("logz", "logz_err", "h", "ess"):
            assert getattr(got, name) == pytest.approx(
                getattr(want, name), rel=NESTED_TOL, abs=NESTED_TOL), name
        for name in ("samples", "logl", "logw"):
            np.testing.assert_allclose(getattr(got, name),
                                       getattr(want, name), rtol=NESTED_TOL,
                                       atol=NESTED_TOL, err_msg=name)


# -- two gloo ranks -----------------------------------------------------------

WORKER = textwrap.dedent("""
    import sys
    rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from mcmcpp_tpu_torch.parallel import distributed
    distributed.initialize(f"localhost:{{port}}", 2, rank, device="cpu")
    import mcmcpp_tpu_torch as mt
    from mcmcpp_tpu_torch.io.checkpoint import load_checkpoint, \\
        save_checkpoint
    from tests.torch_sharded_engine_cases import ENGINES, LADDER, logp

    res = {{}}
    mesh = mt.make_walker_mesh()
    for name, case in ENGINES.items():
        for key, value in case(mesh).items():
            res[f"{{name}}/{{key}}"] = value
    ladder = mt.make_ladder_mesh(2)
    for name, case in LADDER.items():
        for key, value in case(ladder).items():
            res[f"ladder_{{name}}/{{key}}"] = value

    def refused(fn):
        try:
            fn()
            return "no error"
        except (ValueError, RuntimeError, NotImplementedError) as e:
            return type(e).__name__ + ": " + str(e)

    s = mt.HMCSampler(logp, 16, 3, mesh=mesh)
    s.init_ball(np.zeros(3), 0.5)
    res["ckpt/save"] = refused(lambda: save_checkpoint(s, f"{{out}}/c{{rank}}"))
    res["ckpt/load"] = refused(lambda: load_checkpoint(s, f"{{out}}/c{{rank}}"))
    pt = mt.ParallelTemperingSampler(logp, 16, 3, n_temps=2, batched=True,
                                     mesh=ladder)
    pt.init_ball(np.zeros(3), 0.5)
    res["ckpt/pt"] = refused(lambda: save_checkpoint(pt, f"{{out}}/p{{rank}}"))
    res["cuda_under_gloo"] = refused(
        lambda: mt.HMCSampler(logp, 16, 3, mesh=mesh, device="cuda"))
    res["uneven"] = refused(lambda: mt.NUTSSampler(logp, 9, 3, mesh=mesh))
    np.savez(f"{{out}}/rank{{rank}}.npz",
             **{{k: np.asarray(v) for k, v in res.items()}})
    print("WORKER DONE", rank)
""").format(repo=str(REPO))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results of one two-process gloo run of every engine."""
    out = tmp_path_factory.mktemp("sharded_engines")
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
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-4000:]
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]


def _of(res, prefix):
    return {k[len(prefix):]: v for k, v in res.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("name", list(ENGINES))
def test_two_gloo_ranks_equal_the_unsharded_engine(ranks, name):
    _check(name, [_of(res, name + "/") for res in ranks])


@pytest.mark.parametrize("name", list(LADDER))
def test_two_gloo_ranks_on_a_ladder_layout(ranks, name):
    """``make_ladder_mesh(2)`` of two ranks: a ladder shard a rank, each
    storing the whole cold chain."""
    results = [_of(res, f"ladder_{name}/") for res in ranks]
    _check(name, results, ranks_of_a_copy=[0])
    np.testing.assert_array_equal(results[0]["halves:samples"],
                                  results[1]["halves:samples"])


def test_two_gloo_ranks_shapes_and_statistics(ranks):
    """``test_two_process_engines_hmc_pt_smc``: each rank's chain holds its
    own rows, and acceptance, swap rates, log Z, the stepping-stone
    estimate, the Gibbs and SGLD means are the same on both ranks."""
    shapes = {"hmc/rows:samples": (20, 8, 3), "pt/halves:samples": (10, 8, 3),
              "smc/particles:particles": (8, 3),
              "pt_power/halves:samples": (10, 8, 3),
              "gibbs/rows:samples": (10, 8, 5),
              "meads/rows:samples": (10, 8, 3),
              "sgld/rows:samples": (10, 8, 3)}
    for key, shape in shapes.items():
        for res in ranks:
            assert res[key].shape == shape, key
    for key in ("hmc/same:acc", "pt/same:swaps", "smc/same:logz",
                "pt_power/same:ss", "gibbs/same:mean", "meads/same:acc",
                "sgld/same:mean"):
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key])
    a, b = (res["hmc/rows:samples"] for res in ranks)
    assert not np.array_equal(a, b)


def test_two_gloo_ranks_refuse_checkpoints_and_the_card(ranks):
    """A rank holds only its rows: saving and loading raise (in a group of
    one they work). No fallback: a sampler asking for the card under gloo
    raises; an uneven split raises on every rank."""
    for res in ranks:
        for key in ("ckpt/save", "ckpt/load", "ckpt/pt"):
            assert "over 2 ranks" in str(res[key]), res[key]
        assert str(res["cuda_under_gloo"]) != "no error"
        assert "n_chains=9 not divisible by mesh size 2" in str(
            res["uneven"])


def test_a_group_of_one_checkpoints_a_sharded_engine(tmp_path):
    """In a group of one a sharded engine holds every row: it saves and
    resumes as the unsharded one does."""
    from mcmcpp_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint

    def resume(lay):
        a = mt.HMCSampler(logp, 16, 3, seed=2, n_leapfrog=3, mesh=lay)
        a.init_ball(np.zeros(3), 0.5)
        a.run(4)
        save_checkpoint(a, tmp_path / "a")
        a.run(3)
        b = load_checkpoint(mt.HMCSampler(logp, 16, 3, seed=9, n_leapfrog=3,
                                          mesh=lay), tmp_path / "a")
        b.run(3)
        return a.get_samples(), b.get_samples()

    (a, b), = run_in_threads(1, resume)
    assert a.shape == (7, 16, 3)
    np.testing.assert_array_equal(a, b)
