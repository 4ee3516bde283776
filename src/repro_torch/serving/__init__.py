"""Cascade serving for the port: static and continuous-batching engines,
slot and block-paged KV pools (with oversubscription, the pressure
policies and a host swap tier), admission overload control, the M_L
backends (sync, worker thread, serialized stub, and the distributed tier
of `remote`: socket server, client and replica pool), N-tier ladders with
online tau recalibration, telemetry and observability (`obs`)."""
from repro_torch.core.cascade_spec import (CascadeSpec, CascadeTier,
                                           DeferralEdge)
from repro_torch.core.recalibration import RecalibConfig
from repro_torch.serving.cache_pool import SlotCachePool
from repro_torch.serving.config import (EngineConfig, MLBackendConfig,
                                        PagedConfig, PressureConfig)
from repro_torch.serving.engine import (CascadeEngine,
                                        ContinuousCascadeEngine,
                                        ContinuousServeResult, ModelRunner,
                                        ServeResult)
from repro_torch.serving.large_backend import (BatchPolicy, LargeBackend,
                                               LargeResult,
                                               RemoteStubBackend,
                                               SyncLocalBackend,
                                               ThreadedBackend,
                                               make_large_backend)
from repro_torch.serving.obs import (MetricsRegistry, Observability,
                                     ObsConfig, Tracer, validate_chrome_trace)
from repro_torch.serving.paged_pool import BlockPressure, PagedCachePool
from repro_torch.serving.pressure import (DeferOnOomPolicy, PreemptPolicy,
                                          PressurePolicy, ShedPolicy,
                                          make_pressure_policy)
from repro_torch.serving.remote import MLServer, ReplicaPool, SocketBackend
from repro_torch.serving.request import (ArrivalQueue, Request,
                                         make_requests, poisson_arrivals)
from repro_torch.serving.scheduler import SlotScheduler
from repro_torch.serving.telemetry import ServingTelemetry

__all__ = ["ArrivalQueue", "BatchPolicy", "BlockPressure", "CascadeEngine",
           "CascadeSpec", "CascadeTier", "ContinuousCascadeEngine",
           "ContinuousServeResult", "DeferOnOomPolicy", "DeferralEdge",
           "EngineConfig", "LargeBackend", "LargeResult", "MLBackendConfig",
           "MLServer", "MetricsRegistry", "ModelRunner", "ObsConfig",
           "Observability", "PagedCachePool", "PagedConfig",
           "PreemptPolicy", "PressureConfig", "PressurePolicy",
           "RecalibConfig", "RemoteStubBackend", "ReplicaPool", "Request",
           "ServeResult", "ServingTelemetry", "ShedPolicy", "SlotCachePool",
           "SlotScheduler", "SocketBackend", "SyncLocalBackend",
           "ThreadedBackend", "Tracer", "make_large_backend",
           "make_pressure_policy", "make_requests", "poisson_arrivals",
           "validate_chrome_trace"]
