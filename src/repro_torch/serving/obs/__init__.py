"""Serving observability for the port: span tracing with Chrome-trace
export and its validator, the metrics registry with Prometheus text
export and the /metrics endpoint, the host/device time split and a
`torch.profiler` window."""
from repro_torch.serving.obs.config import (Observability, ObsConfig,
                                            add_obs_args,
                                            obs_config_from_args)
from repro_torch.serving.obs.device_time import DeviceTimer, ProfilerWindow
from repro_torch.serving.obs.httpd import MetricsServer
from repro_torch.serving.obs.metrics import MetricsRegistry
from repro_torch.serving.obs.trace import (Tracer, emit_request_spans,
                                           validate_chrome_trace)

__all__ = ["DeviceTimer", "MetricsRegistry", "MetricsServer", "ObsConfig",
           "Observability", "ProfilerWindow", "Tracer", "add_obs_args",
           "emit_request_spans", "obs_config_from_args",
           "validate_chrome_trace"]
