"""Serving observability for the port: span tracing, the metrics
registry with Prometheus text export, and the host/device time split."""
from repro_torch.serving.obs.config import (Observability, ObsConfig,
                                            add_obs_args,
                                            obs_config_from_args)
from repro_torch.serving.obs.device_time import DeviceTimer
from repro_torch.serving.obs.metrics import MetricsRegistry
from repro_torch.serving.obs.trace import Tracer, emit_request_spans

__all__ = ["DeviceTimer", "MetricsRegistry", "ObsConfig", "Observability",
           "Tracer", "add_obs_args", "emit_request_spans",
           "obs_config_from_args"]
