"""The traced window: a ``torch.profiler`` trace of the card and the host,
read from its Chrome-trace export.

The harness marks its own spans with ``record_function``: ``portbench.window``
around the whole traced window, ``portbench.call`` around each call into the
program, ``portbench.append`` around each append of stored rows. Everything
else in the trace is the program's and the runtime's.
"""

import bisect
import json
import os
import tempfile
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
WINDOW = "portbench.window"
CALL = "portbench.call"
#: runtime calls that wait for the device for as long as they last
WAITS = ("Synchronize", "cudaMemcpy", "cuMemcpy")
#: runtime calls that enqueue a launch and wait only when the queue is full
LAUNCH_CALLS = ("LaunchKernel",)


def profile(run):
    """Run ``run()`` under the profiler inside the ``portbench.window`` span,
    synchronizing the card before the span closes; returns the
    :class:`Trace`. The export goes through a file in ``TMPDIR``, removed
    at once."""
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with torch_profile(activities=acts) as prof:
        with record_function(WINDOW):
            run()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return Trace(events)


def _end(e):
    return float(e["ts"]) + float(e["dur"])


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """Complete events of a trace, times in microseconds."""

    def __init__(self, events):
        self.events = [e for e in events
                       if e.get("ph") == "X" and "dur" in e and "ts" in e]
        wins = [e for e in self.events if e.get("cat") == "user_annotation"
                and e.get("name") == WINDOW]
        if not wins:
            raise RuntimeError("the trace holds no portbench.window span")
        w = max(wins, key=lambda e: e["dur"])
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.tid = w.get("tid")
        self.device = [e for e in self.events
                       if e.get("cat") in DEVICE_CATS and self._inside(e)]
        self.host = [e for e in self.events
                     if e.get("cat") in HOST_CATS and self._inside(e)
                     and e.get("tid") == self.tid]

    def _inside(self, e):
        return self.t0 <= float(e["ts"]) <= self.t1

    @property
    def window_s(self):
        return (self.t1 - self.t0) * 1e-6

    def kernels(self, patterns=None):
        """Device kernel events, those whose name holds one of ``patterns``
        where given."""
        ks = [e for e in self.device if e.get("cat") == "kernel"]
        if patterns is None:
            return ks
        return [e for e in ks if any(p in e["name"] for p in patterns)]

    def busy_intervals(self):
        return _union((max(float(e["ts"]), self.t0),
                       min(float(e["ts"]) + float(e["dur"]), self.t1))
                      for e in self.device)

    @property
    def busy_s(self):
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def spans(self, name):
        return [e for e in self.host if e.get("cat") == "user_annotation"
                and e.get("name") == name]

    def device_ops(self, top=10):
        """[[name, seconds], …]: the device operations that took most time."""
        total = defaultdict(float)
        for e in self.device:
            total[e["name"]] += float(e["dur"]) * 1e-6
        return [[k, v] for k, v in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top=10):
        """[[name, seconds], …]: the device's idle time in the window by
        what the host's main thread was doing at each gap's middle (its
        innermost span or call there), longest first."""
        busy = self.busy_intervals()
        gaps, t = [], self.t0
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < self.t1:
            gaps.append((t, self.t1))
        # the host's main thread nests its events, so a sweep over them in
        # time order with a stack of the open ones finds, at each gap's
        # middle, the innermost event there on the top of the stack
        host = sorted(self.host, key=lambda e: (float(e["ts"]),
                                                -float(e["dur"])))
        mids = sorted((0.5 * (s + e), e - s) for s, e in gaps)
        total = defaultdict(float)
        stack, i = [], 0
        for mid, length in mids:
            while i < len(host) and float(host[i]["ts"]) <= mid:
                ev = host[i]
                while stack and _end(stack[-1]) < float(ev["ts"]):
                    stack.pop()
                stack.append(ev)
                i += 1
            while stack and _end(stack[-1]) < mid:
                stack.pop()
            name = stack[-1]["name"] if stack else "host outside the window"
            total[name] += length * 1e-6
        return [[k, v] for k, v in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def host_seconds_outside_waits(self, span=CALL):
        """Seconds of the host's main thread inside ``span`` spans, less
        the runtime calls that wait for the device: synchronizations and
        blocking copies whole, and each launch call's time beyond the tenth
        percentile of that call's durations (a launch waits only when the
        launch queue is full). None without such spans."""
        calls = self.spans(span)
        if not calls:
            return None
        runtime = [e for e in self.host
                   if e.get("cat") in ("cuda_runtime", "cuda_driver")]
        by_name = defaultdict(list)
        for e in runtime:
            by_name[e["name"]].append(float(e["dur"]))
        p10 = {k: sorted(v)[len(v) // 10] for k, v in by_name.items()}
        bounds = sorted((float(c["ts"]), float(c["ts"]) + float(c["dur"]))
                        for c in calls)
        starts = [b[0] for b in bounds]
        waits = 0.0
        for e in runtime:
            ts = float(e["ts"])
            i = bisect.bisect_right(starts, ts) - 1
            if i < 0 or ts > bounds[i][1]:
                continue
            name, dur = e["name"], float(e["dur"])
            if any(w in name for w in WAITS):
                waits += dur
            elif any(w in name for w in LAUNCH_CALLS):
                waits += max(0.0, dur - p10[name])
        inside = sum(e - s for s, e in bounds)
        return (inside - waits) * 1e-6
