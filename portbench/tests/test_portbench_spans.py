"""CPU tests of the readers of the program's own spans
(``metrics/harvest_host_ms_per_call.py``, ``harvest_idle_pct.py``,
``enqueue_us_per_step.py``) on hand-built traces whose spans, kernels and
runtime waits give each reading exactly."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(REPO))

from portbench.harness import catalog, trace  # noqa: E402
from portbench.harness.readers import Context  # noqa: E402

MAIN, STREAM = 1, 7
STEPS = 10
READERS = ("harvest_host_ms_per_call", "harvest_idle_pct",
           "enqueue_us_per_step")


def _host(name, ts, end, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts,
            "pid": 0, "tid": MAIN}


def _device(ts, end, cat="kernel", name="fused_stretch_half_kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts,
            "pid": 1, "tid": STREAM}


def _events(run=True, steps=True, harvest=True):
    """Two calls in a 1000 µs window. The card runs [20, 340] and the
    counters' copy [340, 360], then [520, 850]; each harvest waits 50 µs and
    40 µs in a blocking copy; one of the four launches waits 20 µs past the
    others' 5 µs."""
    ev = [_host("portbench.window", 0.0, 1000.0),
          _host("portbench.call", 5.0, 492.0),
          _host("portbench.call", 495.0, 995.0),
          _device(20.0, 340.0),
          _device(340.0, 360.0, "gpu_memcpy", "Memcpy DtoH"),
          _device(520.0, 850.0)]
    if run:
        ev += [_host("mcmcpp.run_mcmc", 10.0, 490.0),
               _host("mcmcpp.run_mcmc", 500.0, 990.0)]
    if steps:
        ev += [_host("mcmcpp.steps", 20.0, 300.0),
               _host("mcmcpp.steps", 510.0, 800.0)]
    ev += [_host("cudaLaunchKernel", 25.0, 30.0, "cuda_runtime"),
           _host("cudaLaunchKernel", 40.0, 45.0, "cuda_runtime"),
           _host("cudaLaunchKernel", 515.0, 520.0, "cuda_runtime"),
           _host("cudaLaunchKernel", 600.0, 625.0, "cuda_runtime")]
    if harvest:
        ev += [_host("mcmcpp.harvest", 300.0, 480.0),
               _host("mcmcpp.harvest.fetch", 305.0, 365.0),
               _host("cudaMemcpyAsync", 310.0, 360.0, "cuda_runtime"),
               _host("mcmcpp.harvest.fold", 365.0, 475.0),
               _host("mcmcpp.harvest", 800.0, 980.0),
               _host("mcmcpp.harvest.fetch", 805.0, 855.0),
               _host("cudaMemcpyAsync", 810.0, 850.0, "cuda_runtime"),
               _host("mcmcpp.harvest.fold", 855.0, 975.0)]
    return ev


def _read(name, events):
    ctx = Context(trace.Trace(events), steps=STEPS, n=16, p=10, config={})
    return catalog.module("metrics", name).read(ctx)


def test_each_reader_gives_its_exact_value():
    ev = _events()
    # (180 + 180 µs of harvest − 50 − 40 µs of copies) / 2 calls
    assert _read("harvest_host_ms_per_call", ev) == pytest.approx(0.135)
    # (280 + 290 µs of steps − 20 µs of a launch that waited) / 10 steps
    assert _read("enqueue_us_per_step", ev) == pytest.approx(55.0)
    # idle inside the harvests: [360, 480] and [850, 980] of 1000 µs
    assert _read("harvest_idle_pct", ev) == pytest.approx(25.0)


def test_idle_outside_a_harvest_is_not_counted():
    base = _read("harvest_idle_pct", _events())
    # a gap inside a call's steps, and one between the calls
    ev = [e for e in _events() if e.get("name") != "fused_stretch_half_kernel"]
    ev += [_device(20.0, 150.0), _device(200.0, 340.0),
           _device(700.0, 850.0)]
    assert _read("harvest_idle_pct", ev) == pytest.approx(base)
    # the card busy through the first harvest takes its 120 µs off
    ev = _events() + [_device(360.0, 480.0)]
    assert _read("harvest_idle_pct", ev) == pytest.approx(13.0)


@pytest.mark.parametrize("name,drop", [
    ("harvest_host_ms_per_call", "harvest"),
    ("harvest_idle_pct", "harvest"),
    ("enqueue_us_per_step", "steps"),
])
def test_calls_without_the_span_read_zero(name, drop):
    assert _read(name, _events(**{drop: False})) == 0.0


@pytest.mark.parametrize("name", READERS)
def test_no_program_spans_read_none(name):
    assert _read(name, _events(run=False)) is None
    assert _read(name, _events(run=False, steps=False, harvest=False)) is None
    ctx = Context(None, steps=STEPS, n=16, p=10, config={})
    assert catalog.module("metrics", name).read(ctx) is None


@pytest.mark.parametrize("name", READERS)
def test_each_reader_declares_its_benchmark_entry(name):
    mod = catalog.module("metrics", name)
    assert mod.MOVES == "walker_updates_per_s"
    assert (mod.UNIT, mod.LAYER) == {
        "harvest_host_ms_per_call": ("ms", "driver"),
        "harvest_idle_pct": ("%", "driver"),
        "enqueue_us_per_step": ("us", "step and mover"),
    }[name]
