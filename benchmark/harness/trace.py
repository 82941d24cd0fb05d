"""Host spans and the device trace of a run.

``Spans`` times the benchmark's own calls into the program's layers (host
clock, per name); while a trace is on, each span is also a
``record_function`` range, so the device's idle gaps can be named by what
the host was doing. ``Tracer`` holds ``torch.profiler`` (CPU and CUDA
activity) over a slice of the measured window that the serving loop opens and
closes at request boundaries, and reduces it to device intervals.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch

SPAN_PREFIX = "bench::"


class Spans:
    """Durations (seconds) per span name, counted only while `active`."""

    def __init__(self):
        self.active = False
        self.traced = False
        self.seconds: Dict[str, List[float]] = collections.defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.active:
            yield
            return
        t0 = time.perf_counter()
        if self.traced:
            with torch.profiler.record_function(SPAN_PREFIX + name):
                yield
        else:
            yield
        self.seconds[name].append(time.perf_counter() - t0)


def short_name(name: str) -> str:
    """A device op's name without its return type and argument list, cut to
    120 characters (C++ template names run to thousands)."""
    if name.startswith("void "):
        name = name[5:]
    name = name.replace("(anonymous namespace)", "{anon}")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch in "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0 and name[i - 1] != " ":
            cut = i
            break
    return name[:cut][:120]


class DeviceTrace:
    """What one traced slice holds: device intervals (kernels, copies, sets)
    with their names, the benchmark's host spans, and the slice's length."""

    def __init__(self, device_ops: List[Tuple[str, int, int]], host_spans: List[Tuple[str, int, int]],
                 t0_ns: int, t1_ns: int):
        self.device_ops = device_ops  # (name, start_ns, end_ns)
        self.host_spans = host_spans
        self.t0_ns, self.t1_ns = t0_ns, t1_ns

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) * 1e-9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        merged: List[Tuple[int, int]] = []
        for _, s, e in sorted(self.device_ops, key=lambda x: x[1]):
            s, e = max(s, self.t0_ns), min(e, self.t1_ns)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def kernel_seconds(self, match) -> Tuple[float, int]:
        """(seconds, count) of the device ops whose name `match` accepts."""
        hits = [(e - s) for n, s, e in self.device_ops if match(n)]
        return sum(hits) * 1e-9, len(hits)

    def top_ops(self, n: int = 10) -> List[List]:
        total: Dict[str, float] = collections.defaultdict(float)
        for name, s, e in self.device_ops:
            total[name] += (e - s) * 1e-9
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_by_host(self, n: int = 10) -> List[List]:
        """Idle device seconds of the slice, summed by the host span the
        gap's middle falls in ("other": none of the benchmark's spans)."""
        gaps, last = [], self.t0_ns
        for s, e in self.busy_intervals():
            if s > last:
                gaps.append((last, s))
            last = max(last, e)
        if self.t1_ns > last:
            gaps.append((last, self.t1_ns))
        spans = sorted(self.host_spans, key=lambda x: x[1])
        total: Dict[str, float] = collections.defaultdict(float)
        for s, e in gaps:
            mid = (s + e) // 2
            owner = "other"
            for name, hs, he in spans:
                if hs <= mid < he:
                    owner = name  # the innermost span wins: later starts come later
                elif hs > mid:
                    break
            total[f"idle in {owner}"] += (e - s) * 1e-9
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


class Tracer:
    """torch.profiler over one slice; ``start`` / ``stop`` at request
    boundaries (``stop`` synchronises first, so the slice's work is done)."""

    def __init__(self, enabled: bool, spans: Spans):
        self.enabled = enabled
        self.spans = spans
        self.prof = None
        self.result: Optional[DeviceTrace] = None
        self.done = False

    def start(self) -> None:
        if not self.enabled or self.done or self.prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.__enter__()
        self.spans.traced = True
        self.t0_ns = time.time_ns()

    def stop(self) -> None:
        if self.prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t1_ns = time.time_ns()
        self.prof.__exit__(None, None, None)
        self.spans.traced = False
        device_ops, host = [], []
        for ev in self.prof.profiler.kineto_results.events():
            name = ev.name()
            s = ev.start_ns()
            e = s + ev.duration_ns()
            annotation = name.startswith(SPAN_PREFIX) or getattr(ev, "is_user_annotation", lambda: False)()
            if ev.device_type() == torch.autograd.DeviceType.CUDA:
                if not annotation:  # the spans' ranges are mirrored on the device's timeline
                    device_ops.append((short_name(name), s, e))
            elif name.startswith(SPAN_PREFIX):
                host.append((name[len(SPAN_PREFIX):], s, e))
        self.result = DeviceTrace(device_ops, host, self.t0_ns, t1_ns)
        self.prof = None
        self.done = True
