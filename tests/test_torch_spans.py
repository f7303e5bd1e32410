"""The port's own spans (``utils/metrics.py::span``) and its throughput
monitor's fence, on the CPU.

Under ``trace_profile`` a small ensemble run records the sampler's and the
chain's spans, each nested in its parent on the calling thread; with no
profiler recording, a run enters no ``record_function`` at all. The span
names that the benchmark's metric readers (``portbench/metrics/``) read
must be among those a run records."""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mcmcpp_tpu_torch import EnsembleSampler, FusedStretchMove, GaussianTarget
from mcmcpp_tpu_torch.utils import ThroughputMonitor, trace_profile
from mcmcpp_tpu_torch.utils.metrics import span

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
W, P = 32, 4

# each span the sampler and the chain record: the span it nests in
PARENT = {
    "mcmcpp.run_mcmc": None,
    "mcmcpp.steps": "mcmcpp.run_mcmc",
    "mcmcpp.harvest": "mcmcpp.run_mcmc",
    "mcmcpp.harvest.fetch": "mcmcpp.harvest",
    "mcmcpp.harvest.fold": "mcmcpp.harvest",
    "mcmcpp.chain.append": "mcmcpp.run_mcmc",
    "mcmcpp.chain.fetch": "mcmcpp.chain.append",
}


def _sampler():
    cov = 0.5 * np.ones((P, P)) + 0.5 * np.eye(P)
    chol = np.linalg.cholesky(np.linalg.inv(cov)).astype(np.float32)
    s = EnsembleSampler(GaussianTarget.from_numpy(chol, "cpu"), W, P,
                        mover=FusedStretchMove(), batched=True, device="cpu",
                        seed=3)
    s.set_initial_walker_pos(
        np.random.default_rng(0).standard_normal((W, P)).astype(np.float32))
    return s


def _run(s):
    assert s.run_mcmc(5, store=False)
    assert s.run_mcmc(6, thin=2)
    assert s.chain.n_steps == 3 and s.total_steps == 11 * W


@pytest.fixture(scope="module")
def spans(tmp_path_factory):
    """The program's spans of one burn-in and one storing call, traced."""
    out = tmp_path_factory.mktemp("spans")
    with trace_profile(out):
        _run(_sampler())
    events = json.loads((out / "trace.json").read_text())["traceEvents"]
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"
            and str(e.get("name")).startswith("mcmcpp.")]


def _contains(outer, inner):
    eps = 0.01  # the trace's microseconds are rounded to nanoseconds
    return (float(outer["ts"]) - eps <= float(inner["ts"])
            and float(inner["ts"]) + float(inner["dur"])
            <= float(outer["ts"]) + float(outer["dur"]) + eps)


def _parent(e, spans):
    """The innermost other span on ``e``'s thread that holds it."""
    holders = [o for o in spans if o is not e and o["tid"] == e["tid"]
               and _contains(o, e)]
    return min(holders, key=lambda o: float(o["dur"]), default=None)


def test_a_traced_run_records_every_span_nested_in_its_parent(spans):
    assert {e["name"] for e in spans} == set(PARENT)
    assert len({e["tid"] for e in spans}) == 1
    for e in spans:
        parent = _parent(e, spans)
        want = PARENT[e["name"]]
        assert (parent and parent["name"]) == want, e["name"]


def test_steps_and_harvests_lie_inside_their_call(spans):
    calls = [e for e in spans if e["name"] == "mcmcpp.run_mcmc"]
    assert len(calls) == 2
    for name in ("mcmcpp.steps", "mcmcpp.harvest"):
        inner = [e for e in spans if e["name"] == name]
        # one of each in the burn-in call; the storing call's one chunk
        assert len(inner) == 2, name
        for e in inner:
            assert sum(_contains(c, e) for c in calls) == 1
    # the storing call appends its one chunk, both planes fetched
    assert sum(e["name"] == "mcmcpp.chain.append" for e in spans) == 1
    assert sum(e["name"] == "mcmcpp.chain.fetch" for e in spans) == 1


def test_untraced_runs_enter_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered untraced")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    s = _sampler()
    _run(s)
    assert span("mcmcpp.run_mcmc") is span("mcmcpp.steps")
    # the same patch is met once a profiler records
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="entered untraced"):
            s.run_mcmc(1, store=False)


def test_every_span_a_benchmark_reader_reads_is_recorded(spans):
    read = set()
    for path in sorted((REPO / "portbench" / "metrics").glob("*.py")):
        read |= set(re.findall(r"[\"'](mcmcpp\.[\w.]+)[\"']",
                               path.read_text()))
    assert {"mcmcpp.run_mcmc", "mcmcpp.steps", "mcmcpp.harvest"} <= read
    assert read <= {e["name"] for e in spans}


def test_throughput_monitor_fences_only_where_cuda_is_in_use(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: calls.append(1))
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    mon = ThroughputMonitor(n_walkers=100)
    with mon.measure(steps=50):
        pass
    assert calls == []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with mon.measure(steps=50):
        # the clock starts after the queued work is done
        assert calls == [1]
    assert calls == [1, 1]


def test_throughput_monitor_counts_as_before_on_the_cpu():
    mon = ThroughputMonitor(n_walkers=8)
    assert mon.updates_per_s == 0.0
    with mon.measure(steps=10):
        _sampler().run_mcmc(10, store=False)
    with mon.measure(steps=5):
        pass
    assert mon.steps == 15 and mon.updates == 120
    assert mon.seconds > 0
    assert mon.updates_per_s == pytest.approx(120 / mon.seconds)
