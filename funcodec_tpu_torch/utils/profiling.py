"""Observability of the port: program spans and the trainers' trace capture
(port of funcodec_tpu/utils/profiling.py, which holds the second).

The reference's observability is thop MACs + host phase timers
(funcodec/tasks/gan_speech_codec.py:345-355, funcodec/train/reporter.py:263-280)
and ships no profiler traces.

**Spans.** ``span(name)`` marks a layer of the program where its work
happens: the codec serving path (``Speech2Token.dispatch`` / ``collect``,
the host-to-device copy, ``Encodec``'s encode, quantize and decode, the
on-device PCM16 and collect's wait for the device-to-host copies) and two once-a-process
set-up steps (``Speech2Token``'s construction, the kernel library's load).
An operator sees them in any ``torch.profiler`` session: each is a
``record_function`` range named ``funcodec::<name>`` in the session's trace
(``export_chrome_trace``, ``key_averages``), the trainers' ``--profile_dir``
``trace.json`` included. While a session is active, each span is also kept
in memory with its parent, request id, host times and, on a card, a pair of
CUDA events around its device work: ``spans()``, ``device_ms()`` and
``clear()`` read them; nothing is written to disk. The host times come from
``time.time_ns()``, the clock the profiler stamps its host and device events
with, so a span lines up with the trace's kernels. With no session active a
span records nothing and costs one check; the set-up spans
(``always=True``) are recorded either way. A span marked ``wait`` is one in
which the host waits for the device (collect's ``d2h``: the wait for a
batch's copies to the host).

**Trace capture.** ``StepTraceCapture`` captures a ``torch.profiler`` trace
(host ops and, on a card, its kernels) around a chosen window of steps and
writes two files into ``profile_dir``: ``trace.json`` (Chrome trace format:
chrome://tracing or Perfetto) and ``key_averages.txt`` (the table of ops
sorted by self device time on a card, self CPU time otherwise). The trainer
passes profile_dir + profile_start_step/profile_num_steps in TrainerOptions
and calls ``tick(step)`` once per iteration.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import threading
import time
from pathlib import Path
from typing import List, Optional, Tuple

import torch

SPAN_PREFIX = "funcodec::"
MAX_SPANS = 16_384  # the newest are kept: a few hundred batches of the serving path


@dataclasses.dataclass(eq=False)
class Span:
    """One closed span: times in ns on ``time.time_ns()``'s clock; `parent`
    is the enclosing span's name (None for a root); `request_id` is the
    root's, inherited by its children."""

    name: str
    parent: Optional[str]
    request_id: Optional[int]
    wait: bool
    t0_ns: int
    t1_ns: int = 0
    child_ns: int = 0  # host time covered by the direct children
    events: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]] = None

    @property
    def host_ns(self) -> int:
        return self.t1_ns - self.t0_ns

    @property
    def self_ns(self) -> int:
        """The span's host time less what its children cover."""
        return self.host_ns - self.child_ns

    def device_ms(self) -> Optional[float]:
        """Device milliseconds between the span's two CUDA events (None off
        a card); waits for the second event."""
        if self.events is None:
            return None
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end)


class _Open:
    """The context of one recorded span."""

    __slots__ = ("rec", "name", "wait", "device", "request_id", "range", "span")

    def __init__(self, rec: "SpanRecorder", name: str, wait: bool, device, request_id):
        self.rec, self.name, self.wait, self.request_id = rec, name, wait, request_id
        self.device = None if device is None else torch.device(device)

    def __enter__(self) -> Span:
        stack = self.rec._stack()
        parent = stack[-1] if stack else None
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(SPAN_PREFIX + self.name)
            self.range.__enter__()
        events = None
        if self.device is not None and self.device.type == "cuda":
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            events[0].record(torch.cuda.current_stream(self.device))
        rid = self.request_id if self.request_id is not None or parent is None else parent.request_id
        # stamped inside the record_function range, so the trace's event covers the span
        self.span = Span(self.name, parent and parent.name, rid, self.wait, time.time_ns(), events=events)
        stack.append(self.span)
        return self.span

    def __exit__(self, *exc) -> bool:
        s = self.span
        s.t1_ns = time.time_ns()
        if s.events is not None:
            s.events[1].record(torch.cuda.current_stream(self.device))
        stack = self.rec._stack()
        stack.pop()
        if stack:
            stack[-1].child_ns += s.host_ns
        if self.range is not None:
            self.range.__exit__(*exc)
        self.rec._done.append(s)
        return False


_OFF = contextlib.nullcontext()


class SpanRecorder:
    """Closed spans, the newest `maxlen` of them, and each thread's open ones."""

    def __init__(self, maxlen: int = MAX_SPANS):
        self._done: collections.deque = collections.deque(maxlen=maxlen)
        self._local = threading.local()

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, *, wait: bool = False, device=None, request_id: Optional[int] = None,
             always: bool = False):
        """A context manager around one layer's work. Recorded only while a
        ``torch.profiler`` session is active, or always with `always`.
        `device`: where the work runs (CUDA events around it on a card);
        `request_id`: a root's id (a child takes its parent's)."""
        if not (always or torch.autograd._profiler_enabled()):
            return _OFF
        return _Open(self, name, wait, device, request_id)

    def current(self) -> Optional[Span]:
        """The innermost open span of this thread."""
        stack = self._stack()
        return stack[-1] if stack else None

    def spans(self, name: Optional[str] = None, within: Optional[Tuple[int, int]] = None) -> List[Span]:
        """Closed spans in the order they closed (a child before its
        parent): of one `name`, and inside the (t0_ns, t1_ns) interval
        `within`."""
        out = list(self._done)
        if name is not None:
            out = [s for s in out if s.name == name]
        if within is not None:
            out = [s for s in out if within[0] <= s.t0_ns and s.t1_ns <= within[1]]
        return out

    def device_ms(self, name: str, within: Optional[Tuple[int, int]] = None) -> Optional[float]:
        """Device milliseconds summed over the spans `name` that carry CUDA
        events; None where none does."""
        times = [s.device_ms() for s in self.spans(name, within) if s.events is not None]
        return sum(times) if times else None

    def clear(self) -> None:
        self._done.clear()


RECORDER = SpanRecorder()
span = RECORDER.span
current = RECORDER.current
spans = RECORDER.spans
device_ms = RECORDER.device_ms
clear = RECORDER.clear


class StepTraceCapture:
    """Start/stop a torch.profiler trace across a window of host-loop steps.

    Starts before the first step in the window is dispatched and stops
    (after a device synchronisation) once the last one completes. Skips
    step 0 by default: the first step builds the kernels and fills the
    caches, which is not the loop's steady state. A no-op when
    ``profile_dir`` is None.
    """

    def __init__(
        self,
        profile_dir: Optional[str],
        start_step: int = 10,
        num_steps: int = 5,
    ):
        self.profile_dir = profile_dir
        self.start_step = max(1, start_step)
        self.num_steps = max(1, num_steps)
        self._active = False
        self._done = profile_dir is None
        self._prof = None

    def tick(self, global_step: int) -> None:
        """Call once per host-loop iteration BEFORE dispatching that step."""
        if self._done:
            return
        if not self._active and global_step >= self.start_step:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.start()
            self._active = True
            self._stop_at = global_step + self.num_steps
            logging.info(
                "profiler: tracing steps %d..%d -> %s",
                global_step, self._stop_at - 1, self.profile_dir,
            )
        elif self._active and global_step >= self._stop_at:
            self.stop()

    def stop(self) -> None:
        """Stop tracing if active (also call at epoch end for short epochs)."""
        if not self._active:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the trace holds the window's device work
        self._prof.stop()
        self._active = False
        self._done = True
        out = Path(self.profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        self._prof.export_chrome_trace(str(out / "trace.json"))
        sort_by = "self_device_time_total" if torch.cuda.is_available() else "self_cpu_time_total"
        table = self._prof.key_averages().table(sort_by=sort_by, row_limit=50)
        (out / "key_averages.txt").write_text(table)
        logging.info("profiler: trace written to %s", self.profile_dir)
