"""Host/device wall-time split per dispatch (``--device-timing``).

Counterpart of `repro.serving.obs.device_time.DeviceTimer`. PyTorch
returns from a CUDA call as soon as the work is enqueued; when enabled,
the engine brackets each dispatch with `torch.cuda.synchronize`, so the
time up to the return is host and the blocking remainder is device. The
blocking serialises dispatch against execution, which is why it is a
mode and not the default; outputs are identical either way. (The JAX
package's profiler window is not ported yet; see ROADMAP.md.)
"""
from __future__ import annotations

import torch


class DeviceTimer:
    """Blocks on the device when enabled; a no-op otherwise."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled

    def block(self, device: torch.device) -> None:
        """Wait for all work queued on `device` (CPU work is synchronous)."""
        if self.enabled and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
