"""CPU tests of the benchmark: discovery by name, the import rules, the
roofline counts against ``chip_smoke.py``'s, the reference against the
port's plain half-step, and the result line of a small dry run of each
cell on the CPU (the kernels' plain versions). One test runs a cell on the
card and skips without one."""

import ast
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
REPO = BENCH.parent
sys.path.insert(0, str(REPO))

from portbench.harness import catalog, guard, peaks, runner  # noqa: E402
from portbench.reference import noise, philox, stretch  # noqa: E402

CELLS = catalog.names("workloads", ".json")
SMALL = {"walkers_log2": 9, "steps_per_call": 6, "trace_calls": 2}


def _imports(path):
    """Top-level names of every module ``path`` imports (relative imports
    as the empty name)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("" if node.level else node.module.split(".", 1)[0])
    return names


def test_no_file_imports_the_jax_side():
    for path in BENCH.rglob("*.py"):
        found = _imports(path) & set(guard.FORBIDDEN)
        assert not found, (path, found)


def test_the_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "mcmcpp_tpu_torch" not in _imports(path), path


def test_the_guard_compares_whole_top_level_names():
    assert guard.forbidden_loaded({"mcmcpp_tpu_torch.sampler": 0}) == []
    assert guard.forbidden_loaded({"mcmcpp_tpu.sampler": 0,
                                   "jaxlib.xla": 0}) == ["jaxlib",
                                                         "mcmcpp_tpu"]


def test_benchmark_json_names_files_that_exist():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    assert spec["paths"] == ["portbench"]
    assert set(w["name"] for w in spec["workloads"]) <= set(CELLS)
    for w in spec["workloads"]:
        cell = catalog.workload(w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"], cell["why"]) \
            == (w["config"], w["traffic"], w["chips"], w["why"])
    for c in spec["configs"]:
        assert (REPO / c["file"]).is_file()
        catalog.module("targets", catalog.load_json(
            "configs", c["name"])["target"]["kind"])
    metrics = catalog.metric_modules()
    for m in spec["per_layer"]:
        mod = metrics[m["name"]]
        assert (mod.MOVES, mod.UNIT, mod.LAYER) == (m["moves"], m["unit"],
                                                    m["layer"])
    assert set(metrics) >= {m["name"] for m in spec["per_layer"]}
    for w in spec["workloads"]:
        reported = set(catalog.workload(w["name"])["end_to_end"])
        listed = {m["name"] for m in spec["end_to_end"]
                  if w["name"] in m.get("workloads", [w["name"]])}
        assert reported == listed, w["name"]


def test_discovery_finds_every_entry_by_its_file_name():
    assert CELLS == ["gauss10.burnin", "gauss10.store_bf16", "mvn250.burnin"]
    assert catalog.names("configs", ".json") == ["gauss10_equicorr",
                                                 "mvn250_wishart"]
    assert "device_idle_pct.burnin" in catalog.metric_modules()
    assert catalog.names("roofline", ".py") == ["fused_stretch",
                                                "fused_stretch_wide"]
    with pytest.raises(LookupError):
        catalog.workload("no_such_cell")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_bounds",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("p", [10, 250, 1000])
def test_roofline_counts_match_chip_smoke(p):
    cs = _chip_smoke()
    n = 1 << 20
    kernel = "fused_stretch" if p <= 16 else "fused_stretch_wide"
    roof = catalog.roofline(kernel)
    least_ms = peaks.least_seconds(roof.flop(n, p), roof.nbytes(n, p)) * 1e3
    if p <= 16:
        want_ms, bound = cs.kernel_bounds(n, p)["fused_stretch_half"]
        assert roof.nbytes(n, p) == n * 4 * (3 * p + 3)
        assert roof.flop(n, p) == n * (2 * p * p + 5 * p + 120)
        assert bound == "bytes"
        assert least_ms == pytest.approx(want_ms, rel=1e-12)
    else:
        by_bytes, by_product = cs.wide_bound_parts(n, p)
        assert roof.nbytes(n, p) / peaks.PEAK_BYTES_PER_S * 1e3 == \
            pytest.approx(by_bytes, rel=1e-12)
        # the same product at a third of the TF32 rate, plus the proposal
        ops_ms = roof.flop(n, p) / peaks.PEAK_F32_PRODUCT_FLOP_PER_S * 1e3
        assert by_product <= ops_ms <= 1.02 * by_product
        assert least_ms == pytest.approx(max(by_bytes, by_product), rel=0.02)


def test_the_reference_matches_the_ports_plain_half_step():
    from mcmcpp_tpu_torch.models.targets import GaussianTarget
    from mcmcpp_tpu_torch.ops.fused_stretch import (
        fused_stretch_half_reference)
    from mcmcpp_tpu_torch.ops.random import philox_unit_uniforms

    gen = torch.Generator().manual_seed(5)
    n, p = 512, 12
    chol = torch.linalg.cholesky(torch.eye(p) + 0.3 * torch.ones(p, p))
    act = torch.randn(n, p, generator=gen)
    other = torch.randn(n, p, generator=gen)
    target = GaussianTarget(chol, device="cpu")
    key, shift = (1 << 63) + 12345, 77
    u, ue = philox.uniforms(key, 0, n, "cpu")
    pu, pue = philox_unit_uniforms(key, n, "cpu")
    assert torch.equal(u, pu) and torch.equal(ue, pue)
    rows, lp, acc = fused_stretch_half_reference(
        act, target(act), other, torch.tensor([shift], dtype=torch.int32),
        u, ue, logp_fn=target)
    ref = stretch.half_step(act, other, shift, key, chol)
    want_rows, want_lp, want_acc = stretch.outputs(ref, act)
    agree = acc == want_acc
    assert agree.float().mean() > 0.999
    assert torch.allclose(rows[agree].double(), want_rows[agree],
                          rtol=1e-5, atol=1e-5)
    assert torch.allclose(lp[agree].double(), want_lp[agree], rtol=1e-5,
                          atol=1e-4)


def test_the_replayed_draws_are_the_samplers():
    from mcmcpp_tpu_torch.movers.fused import FusedStretchMove
    from mcmcpp_tpu_torch.ops.random import (HOST_STREAM, STEP_STREAM,
                                             make_generator)

    seed, m = 2 ** 31 + 99, 1000
    gen = make_generator(seed, STEP_STREAM, "cpu")
    host = make_generator(seed, HOST_STREAM, "cpu")
    replay = noise.Replay(seed, m, "cpu")
    mover = FusedStretchMove()
    for i in range(7):
        shift, u, _ = mover.draw_noise(gen, m, m, 3, "cpu", host_gen=host)
        if i < 4:
            replay.skip(1)
            continue
        want_shift, want_key = replay.next()
        assert int(shift) == want_shift
        assert torch.equal(u, philox.uniforms(want_key, 0, m, "cpu")[0])


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_small_cpu_run_prints_the_result_line(cell, trace):
    r = runner.run_cell(cell, 2 ** 31 + 17, 0.2, trace=trace, device="cpu",
                        overrides=SMALL)
    line = json.loads(json.dumps(r))
    assert list(line)[:3] == ["correct", "attempted", "failed"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    want = catalog.workload(cell)["end_to_end"]
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        movers = {n for n, m in catalog.metric_modules().items()
                  if m.MOVES in want}
        assert set(line["metrics"]) <= movers
    else:
        assert set(line["metrics"]) == set(want)
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


def test_the_cli_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "gauss10.burnin", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=120)
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA" in out.stderr


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "gauss10.burnin", "--seed", "2147483659", "--seconds", "2",
         "--trace", "0"],
        capture_output=True, text=True, cwd=REPO, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
