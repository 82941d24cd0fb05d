"""torch.profiler trace capture for the training loop (port of
funcodec_tpu/utils/profiling.py).

The reference's observability is thop MACs + host phase timers
(funcodec/tasks/gan_speech_codec.py:345-355, funcodec/train/reporter.py:263-280)
and ships no profiler traces. This module captures a ``torch.profiler``
trace (host ops and, on a card, its kernels) around a chosen window of
steps and writes two files into ``profile_dir``: ``trace.json`` (Chrome
trace format: chrome://tracing or Perfetto) and ``key_averages.txt`` (the
table of ops sorted by self device time on a card, self CPU time otherwise).

Usage (trainer): pass profile_dir + profile_start_step/profile_num_steps in
TrainerOptions; the trainer calls ``tick(step)`` once per iteration.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

import torch


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
