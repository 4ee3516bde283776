"""Observability configuration + runtime facade for the port's engine.

Counterpart of `repro.serving.obs.config`: ``ObsConfig`` is the knob set
(CLI flags map 1:1 onto it); ``Observability`` owns the live objects — one
`MetricsRegistry` (always), plus the opt-in `Tracer` and `DeviceTimer`.
The /metrics HTTP endpoint and the profiler window are not ported yet
(see ROADMAP.md); their CLI flags are accepted by `add_obs_args` only so
that the serve CLI can reject them by name.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.serving.obs.device_time import DeviceTimer
from repro_torch.serving.obs.metrics import MetricsRegistry
from repro_torch.serving.obs.trace import Tracer

# flags of the JAX CLI the port does not serve yet (dest, flag)
UNPORTED_FLAGS = (("metrics_port", "--metrics-port"),
                  ("profile_dir", "--profile-dir"),
                  ("profile_iters", "--profile-iters"))


@dataclasses.dataclass
class ObsConfig:
    """Declarative observability switches (all off/None by default)."""
    trace_path: Optional[str] = None     # Chrome-trace JSON out (Perfetto)
    metrics_path: Optional[str] = None   # Prometheus text dump at finish
    device_timing: bool = False          # host/device split per dispatch
    audit_flush_every: int = 256         # JSONL flush cadence (events)
    max_events: Optional[int] = None     # telemetry retention (None = all,
                                         # 0 = none, N = ring of last N)

    @property
    def any_enabled(self) -> bool:
        return bool(self.trace_path or self.metrics_path
                    or self.device_timing)


def add_obs_args(ap) -> None:
    """Attach the observability CLI flags (the JAX serve CLI's set)."""
    g = ap.add_argument_group("observability")
    g.add_argument("--trace-out", default=None,
                   help="write a Chrome-trace-event JSON of the run")
    g.add_argument("--metrics-out", default=None,
                   help="dump the final Prometheus text scrape to this file")
    g.add_argument("--metrics-port", type=int, default=None,
                   help="not ported yet (see ROADMAP.md)")
    g.add_argument("--device-timing", action="store_true",
                   help="synchronize after each dispatch to split host vs "
                        "device wall time per phase (outputs unchanged)")
    g.add_argument("--profile-dir", default=None,
                   help="not ported yet (see ROADMAP.md)")
    g.add_argument("--profile-iters", type=int, default=20,
                   help="not ported yet (see ROADMAP.md)")
    g.add_argument("--audit-flush-every", type=int, default=256,
                   help="flush the JSONL audit log every N events")
    g.add_argument("--max-events", type=int, default=None,
                   help="in-memory telemetry event retention: unset = "
                        "keep all, 0 = keep none, N = ring of last N")


def obs_config_from_args(args) -> ObsConfig:
    """Build an `ObsConfig` from a parsed `add_obs_args` namespace."""
    return ObsConfig(trace_path=args.trace_out,
                     metrics_path=args.metrics_out,
                     device_timing=args.device_timing,
                     audit_flush_every=args.audit_flush_every,
                     max_events=args.max_events)


class Observability:
    """Live observability objects for one (or more) engine runs."""

    def __init__(self, cfg: Optional[ObsConfig] = None,
                 registry: Optional[MetricsRegistry] = None):
        self.cfg = cfg or ObsConfig()
        self.registry = registry or MetricsRegistry()
        self.tracer: Optional[Tracer] = (Tracer() if self.cfg.trace_path
                                         else None)
        self.device_timer = DeviceTimer(self.cfg.device_timing)

    def finish(self) -> None:
        """Export the trace / metrics dump when configured. Idempotent."""
        if self.tracer is not None and self.cfg.trace_path:
            self.tracer.export(self.cfg.trace_path)
        if self.cfg.metrics_path:
            self.registry.write(self.cfg.metrics_path)
