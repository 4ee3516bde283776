"""Device-time attribution: the host/device wall-time split and a
profiler window.

Counterpart of `repro.serving.obs.device_time`.

``DeviceTimer``
    PyTorch returns from a CUDA call as soon as the work is enqueued;
    when enabled, the engine brackets each dispatch with
    `torch.cuda.synchronize`, so the time up to the return is host and
    the blocking remainder is device. The blocking serialises dispatch
    against execution, which is why it is a mode and not the default;
    outputs are identical either way.

``ProfilerWindow``
    Captures a `torch.profiler` trace (CPU activity, and CUDA activity
    when a card is present) of the first `n_iters` engine iterations of
    a run and writes it into ``profile_dir`` as Chrome trace JSON
    (Perfetto). A bounded window rather than a whole-run capture, with
    JAX's state machine over `tick()` and `close()`. A profiler that
    fails to start raises: the window is never skipped in silence.
"""
from __future__ import annotations

import os
import time
from typing import Optional

import torch


class DeviceTimer:
    """Blocks on the device when enabled; a no-op otherwise."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled

    def block(self, device: torch.device) -> None:
        """Wait for all work queued on `device` (CPU work is synchronous)."""
        if self.enabled and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)


class ProfilerWindow:
    """Capture a `torch.profiler` trace for the first `n_iters` calls to
    ``tick()`` (one per engine iteration). Idempotent and crash-safe:
    ``close()`` stops and writes a still-open capture. `trace_path` is
    the Chrome trace written (None until one is)."""

    def __init__(self, profile_dir: Optional[str], n_iters: int = 20):
        self.profile_dir = profile_dir
        self.n_iters = max(1, n_iters)
        self.trace_path: Optional[str] = None
        self._i = 0
        self._prof = None

    @property
    def enabled(self) -> bool:
        return self.profile_dir is not None

    @property
    def running(self) -> bool:
        return self._prof is not None

    def tick(self) -> None:
        if not self.enabled or self._i > self.n_iters:
            return
        if self._i == 0:
            self._start()
        elif self._i == self.n_iters and self.running:
            self._stop()
        self._i += 1

    def close(self) -> None:
        if self.running:
            self._stop()

    def _start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        self._prof = prof

    def _stop(self) -> None:
        prof, self._prof = self._prof, None
        prof.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        path = os.path.join(self.profile_dir,
                            f"engine_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        self.trace_path = path
