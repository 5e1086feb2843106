"""Reading the profiler's trace of the window.

The window runs under ``torch.profiler`` (CPU and CUDA activities) inside a
``record_function("gq.window")``; each batch is a ``record_function
("gq.batch")``. The trace is exported as Chrome JSON and read here: device
activity is every event of category ``kernel``, ``gpu_memcpy`` or
``gpu_memset``; host activity is every CPU-side event on the window's
thread. Each batch ends in a synchronise, so a device event that starts
inside a batch's span belongs to that batch."""
from __future__ import annotations

import bisect
import json
from collections import defaultdict
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")


@dataclass
class Trace:
    window: tuple  # (start, end) in µs on the trace's clock
    device: list  # (start, dur, cat, name), sorted, within the window
    host: list  # (start, dur, name) on the window's thread, sorted
    batches: list  # (start, end) of each gq.batch span, in order
    batch_device: list = field(default_factory=list)  # device events of each batch

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_intervals(self) -> list:
        """The union of the device events, clipped to the window."""
        out = []
        w0, w1 = self.window
        for s, d, _, _ in self.device:
            a, b = max(s, w0), min(s + d, w1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def device_ops(self, top: int = 10) -> list:
        acc: dict = defaultdict(float)
        for _, d, _, name in self.device:
            acc[name] += d / 1e6
        return sorted(([k, v] for k, v in acc.items()), key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle time between device events, summed by what the host was
        doing at each gap's middle (the innermost host event there)."""
        busy = self.busy_intervals()
        edges = [self.window[0]] + [x for ab in busy for x in ab] + [self.window[1]]
        starts = [h[0] for h in self.host]
        acc: dict = defaultdict(float)
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            acc[self._host_at(0.5 * (a + b), starts)] += (b - a) / 1e6
        return sorted(([k, v] for k, v in acc.items()), key=lambda kv: -kv[1])[:top]

    def _host_at(self, t: float, starts: list) -> str:
        i = bisect.bisect_right(starts, t)
        for j in range(i - 1, max(i - 4000, 0) - 1, -1):
            s, d, name = self.host[j]
            if s + d >= t:
                return name
        return "host: outside every traced event"


def read(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"]
    win = [e for e in spans if e.get("name") == "gq.window" and e.get("cat") == "user_annotation"]
    if len(win) != 1:
        raise RuntimeError(f"expected one gq.window span in the trace, found {len(win)}")
    w = win[0]
    w0, w1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    device = sorted(
        (float(e["ts"]), float(e.get("dur", 0.0)), e["cat"], e["name"])
        for e in spans if e.get("cat") in DEVICE_CATS
        and float(e["ts"]) < w1 and float(e["ts"]) + float(e.get("dur", 0.0)) > w0
    )
    host = sorted(
        (float(e["ts"]), float(e.get("dur", 0.0)), e["name"])
        for e in spans if e.get("cat") in HOST_CATS and e.get("tid") == w.get("tid")
        and e.get("pid") == w.get("pid") and e["name"] != "gq.window"
    )
    batches = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        for e in spans if e.get("name") == "gq.batch" and e.get("cat") == "user_annotation"
    )
    tr = Trace((w0, w1), device, host, batches)
    starts = [b[0] for b in batches]
    tr.batch_device = [[] for _ in batches]
    for ev in device:
        i = bisect.bisect_right(starts, ev[0]) - 1
        if i >= 0 and ev[0] <= batches[i][1]:
            tr.batch_device[i].append(ev)
    return tr
