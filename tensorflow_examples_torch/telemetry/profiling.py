"""In-loop profiler windows: the port of
``tensorflow_examples_tpu/telemetry/profiling.py`` on ``torch.profiler``.

``TrainConfig.profile_start_step`` / ``profile_num_steps`` /
``profile_dir`` describe a window in run-relative steps; the legacy
``profile`` flag is steps 10-20. The window is one-shot, bracketed by a
``profile`` span in the host timeline, and traces the CPU and, on the
card, the CUDA activity (kernel names come from CUPTI; a CUDA graph
replay shows its kernels too). On stop the trace is written as
Chrome-trace JSON, ``<profile_dir>/trace_<pid>.json``, the window's
facts land in the gauges ``profile/steps`` and ``profile/wall_secs``,
and the run's final telemetry line links the window under ``"profile"``
(dir, start_step, num_steps, wall_secs). The reference's optional
device duty-cycle extraction from an xplane has no counterpart here.
"""

from __future__ import annotations

import logging
import os
import time

import torch

log = logging.getLogger(__name__)


class ProfilerWindow:
    """One-shot windowed trace driven by the training loop:
    ``maybe_start(rel_step)`` before a chunk (run-relative step),
    ``maybe_stop(rel_steps_done)`` after it, ``finish`` on any exit
    path."""

    def __init__(self, start_step: int, num_steps: int, out_dir: str, telemetry=None, *,
                 device: torch.device | None = None):
        self.start_step = max(int(start_step), 0)
        self.num_steps = max(int(num_steps), 1)
        self.out_dir = out_dir
        self._telemetry = telemetry
        self._device = device if device is not None else torch.device("cpu")
        self._state = "pending"  # pending -> active -> done
        self._prof = None
        self._span_cm = None
        self._t0 = 0.0
        self._first_rel = 0
        self._last_rel = 0
        self.info: dict | None = None
        self.trace_file: str | None = None

    @classmethod
    def from_config(cls, cfg, telemetry=None, *,
                    device: torch.device | None = None) -> "ProfilerWindow | None":
        """None when no window is configured; ``profile`` maps to steps
        10-20. ``profile_dir`` "" is ``<workdir>/profile`` (a temporary
        directory's ``profile`` without a workdir)."""
        num = int(cfg.profile_num_steps or 0)
        start = int(cfg.profile_start_step or 0)
        if num <= 0:
            if not cfg.profile:
                return None
            start, num = (start or 10), 10
        if cfg.profile_dir:
            out_dir = cfg.profile_dir
        elif cfg.workdir:
            out_dir = os.path.join(cfg.workdir, "profile")
        else:
            import tempfile

            out_dir = os.path.join(tempfile.gettempdir(), "torch_profile")
        return cls(start, num, out_dir, telemetry, device=device)

    @property
    def active(self) -> bool:
        return self._state == "active"

    def maybe_start(self, rel_step: int) -> None:
        if self._state != "pending" or rel_step < self.start_step:
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self._device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.start()
        self._state = "active"
        self._first_rel = self._last_rel = rel_step
        self._t0 = time.perf_counter()
        if self._telemetry is not None:
            self._span_cm = self._telemetry.span("profile", dir=self.out_dir)
            self._span_cm.__enter__()
        log.info("profiler window open: run-relative step %d, %d step(s) -> %s", rel_step,
                 self.num_steps, self.out_dir)

    def maybe_stop(self, rel_steps_done: int) -> None:
        if self._state != "active":
            return
        self._last_rel = rel_steps_done
        if rel_steps_done - self._first_rel >= self.num_steps:
            self._stop(rel_steps_done)

    def finish(self) -> None:
        """Close an in-flight window (preempt, abort, a loop that ended
        before the window filled), keeping the steps traced so far."""
        if self._state == "active":
            self._stop(self._last_rel)

    def _stop(self, rel_steps_done: int) -> None:
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)  # the traced steps retire inside the window
        wall = time.perf_counter() - self._t0
        self._prof.stop()
        self._state = "done"
        if self._span_cm is not None:
            self._span_cm.__exit__(None, None, None)
            self._span_cm = None
        os.makedirs(self.out_dir, exist_ok=True)
        self.trace_file = os.path.join(self.out_dir, f"trace_{os.getpid()}.json")
        self._prof.export_chrome_trace(self.trace_file)
        self._prof = None
        steps = max(rel_steps_done - self._first_rel, 0)
        self.info = {"dir": self.out_dir, "start_step": self._first_rel, "num_steps": steps,
                     "wall_secs": round(wall, 6)}
        if self._telemetry is not None:
            reg = self._telemetry.registry
            reg.gauge("profile/steps").set(steps)
            reg.gauge("profile/wall_secs").set(wall)
            self._telemetry.note_profile(self.info)
        log.info("profiler window closed: %d step(s) in %.3fs -> %s", steps, wall,
                 self.trace_file)
