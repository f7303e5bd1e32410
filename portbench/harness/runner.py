"""One run of one cell: set-up, warm-up, the measured (or traced) window,
the check, the result line.

Set-up makes the target and the walkers' start from the seed on the device,
builds the program's sampler on them and runs ``warmup_calls`` calls of the
cell's own shape, so that every kernel is built and loaded before the window
(the first run in a checkout compiles the port's library into its
``build/kernels/``). The window then repeats the cell's call back to back for
``--seconds`` (with ``--trace 1``: ``trace_calls`` calls under the
profiler), ends in ``torch.cuda.synchronize()`` and is timed by the host
clock. After it, the same sampler takes ``follow_steps`` steps one call
each for the check (``harness/check.py``), which runs once the program is
freed.
"""

import gc
import math
import subprocess
import sys
import time

import numpy as np
import torch

from portbench.harness import catalog, check, guard
from portbench.harness import trace as tracing
from portbench.harness.readers import Context
from portbench.reference import gaussian, noise

#: the seed's stream for the walkers' start, apart from the sampler's own
START_STREAM = 100
RATE_UNIT = "walker-updates/s"


def seed_word(seed):
    """The run's seed as the non-negative integer both sides are seeded
    with."""
    return int(seed) % (1 << 63)


def card_line():
    """The card's name and power limit from ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(0) + ", power limit not read"


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cell(name, seed, seconds, trace=False, device="cuda", overrides=None,
             control=False, started=None, log=sys.stderr):
    """Run cell ``name`` once; returns the result as a dict in the order of
    the result line (``checks`` last). ``overrides`` replaces entries of the
    cell's traffic (the CPU tests' small sizes); ``control`` adds the
    readings of the control (``check.py``) under ``"control"``."""
    started = time.perf_counter() if started is None else started
    cell = catalog.workload(name)
    cfg = cell["config_spec"]
    traffic = dict(cell["traffic_spec"], **(overrides or {}))
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0 if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
    # the reference's float32 products stay float32 (this is also torch's
    # default for the program's own products)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from portbench.harness import program

    import mcmcpp_tpu_torch.sampler  # noqa: F401  (the port's import time)

    marks = [("imports", time.perf_counter())]
    word = seed_word(seed)
    prec64 = catalog.module("targets", cfg["target"]["kind"]).prec_chol(
        cfg["target"], word)
    p = prec64.shape[0]
    walkers = 1 << int(traffic["walkers_log2"])
    n = walkers // 2
    prec = torch.tensor(prec64, dtype=torch.float32, device=dev)
    inv = torch.tensor(np.linalg.inv(prec64), dtype=torch.float32,
                       device=dev)
    start = gaussian.draws(noise.generator(word, START_STREAM, dev), walkers,
                           inv)
    del inv
    _sync(dev)
    marks.append(("inputs", time.perf_counter()))
    sampler = program.build_sampler(cfg, traffic, prec.clone(), start, word,
                                    dev)
    _sync(dev)
    marks.append(("sampler", time.perf_counter()))
    t_ref = marks[-1][1]
    lp0 = torch.cat([sampler.state.logp_red, sampler.state.logp_black])
    ctrl_dtype = check.CONTROL_DTYPE[cfg["dtype"]]
    capture = check.Capture()
    capture.start = {"program": check.logp_gap(lp0, start, prec)}
    if control:
        capture.start["control"] = check.control_logp_gap(start, prec,
                                                          ctrl_dtype)
    del lp0, start
    ref_s = time.perf_counter() - t_ref
    marks.append(("the start's reference check (not counted)",
                  time.perf_counter()))
    steps_per_call = int(traffic["steps_per_call"])
    store = bool(traffic["store"])
    clear = bool(traffic["clear_chain_each_call"])
    failed = 0
    steps_done = 0
    for _ in range(int(traffic["warmup_calls"])):
        failed += program.run_call(sampler, traffic) is not True
        steps_done += steps_per_call
        if clear:
            sampler.chain.clear()
    _sync(dev)
    marks.append(("warm-up", time.perf_counter()))
    setup_s = time.perf_counter() - started - ref_s
    last = started
    phases = []
    for what, t in marks:
        phases.append(f"{what} {t - last:.3f} s")
        last = t
    print(f"set-up: {', '.join(phases)}", file=log)
    setup_peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                  else 0)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    call_s = []

    def one_call():
        nonlocal failed, steps_done
        t_call = time.perf_counter()
        with torch.profiler.record_function(tracing.CALL):
            failed += program.run_call(sampler, traffic) is not True
        steps_done += steps_per_call
        call_s.append(time.perf_counter() - t_call)

    # a cell that hands each call's rows on clears the chain after every
    # call but the window's last, whose rows the check reads
    calls = 0
    appends = []
    trace_data = None
    if trace:
        calls = int(traffic["trace_calls"])
        before = program.launch_counts()

        def traced():
            for i in range(calls):
                one_call()
                if clear and i < calls - 1:
                    sampler.chain.clear()

        with program.timed_appends(appends):
            trace_data = tracing.profile(traced)
        launched = {k: v - before.get(k, 0)
                    for k, v in program.launch_counts().items()}
        window_s = trace_data.window_s
    else:
        t0 = time.perf_counter()
        while True:
            one_call()
            calls += 1
            if time.perf_counter() - t0 >= seconds:
                break
            if clear:
                sampler.chain.clear()
        _sync(dev)
        window_s = time.perf_counter() - t0
    window_peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                   else 0)
    spread = sorted(call_s)
    print(f"window: {calls} calls in {window_s:.4f} s; a call's host "
          f"seconds min {spread[0]:.4f}, median {spread[len(spread) // 2]:.4f},"
          f" max {spread[-1]:.4f}", file=log)
    attempted = calls

    # the check: follow the program from its state at the window's end
    capture.steps_before = steps_done
    capture.states.append(program.state(sampler))
    if store:
        if sampler.chain.n_steps:
            capture.rows.append((*program.last_stored_row(sampler), 0))
        sampler.chain.clear()
    for t in range(int(traffic["follow_steps"])):
        acc0 = program.accepted(sampler)
        if store:
            failed += sampler.run_mcmc(1, thin=1) is not True
        else:
            failed += sampler.run_mcmc(1, store=False) is not True
        capture.accepts.append((program.accepted(sampler) - acc0).to(dev))
        capture.states.append(program.state(sampler))
        if store:
            capture.rows.append((*program.last_stored_row(sampler), t + 1))
    del sampler
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    a = float(cfg["mover"]["a"])
    store_dtype = traffic.get("store_dtype")
    readings = check.readings(capture, prec, a, word, store_dtype)
    control_readings = (check.readings(capture, prec, a, word, store_dtype,
                                       control=ctrl_dtype)
                        if control else None)
    limits = cell.get("limits", {})
    checks = {k: {"value": v, "limit": limits.get(k)}
              for k, v in readings.items()}
    correct = failed == 0 and all(
        c["limit"] is not None and math.isfinite(c["value"])
        and c["value"] <= c["limit"] for c in checks.values())

    gpu = dev.type == "cuda"
    card = card_line() if gpu else "no card (CPU run)"
    print(f"card: {card}", file=log)
    device_info = {
        "platform": "gpu" if gpu else "cpu",
        "kind": torch.cuda.get_device_name(dev) if gpu else "cpu",
        "count": 1,
        "memory_peak_bytes": int(max(setup_peak, window_peak)),
    }
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": int(failed)}
    if trace:
        ctx = Context(trace_data, steps=calls * steps_per_call, n=n, p=p,
                      config=cfg, appends=appends)
        metrics = {}
        for mname, mod in catalog.metric_modules().items():
            if mod.MOVES not in cell["end_to_end"]:
                continue
            value = mod.read(ctx)
            if value is not None:
                metrics[mname] = {"value": float(value), "unit": mod.UNIT}
                print(f"{mname}: {value!r} {mod.UNIT} ({card})", file=log)
        print(f"launch counter over the window: {launched}", file=log)
        result["metrics"] = metrics
        device_info["busy_s"] = trace_data.busy_s
        device_info["window_s"] = trace_data.window_s
        result["device"] = device_info
        result["breakdown"] = {"device_ops": trace_data.device_ops(),
                               "idle_gaps": trace_data.idle_gaps()}
    else:
        rate = calls * steps_per_call * walkers / window_s
        rate_metric = ("stored_walker_updates_per_s" if store
                       else "walker_updates_per_s")
        result["metrics"] = {
            rate_metric: {"value": rate, "unit": RATE_UNIT},
            "peak_mem_gib": {"value": window_peak / 2 ** 30, "unit": "GiB"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
        result["device"] = device_info
    if control_readings is not None:
        result["control"] = control_readings
    found = guard.forbidden_loaded()
    if found:
        raise RuntimeError(f"modules of the JAX side are loaded: {found}")
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=log)
    return result
