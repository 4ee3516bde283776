"""Cascade serving for the port: static and continuous-batching engines,
slot and block-paged KV pools (with oversubscription, the pressure
policies and a host swap tier), admission overload control, the sync M_L
backend and telemetry."""
from repro_torch.core.cascade_spec import (CascadeSpec, CascadeTier,
                                           DeferralEdge)
from repro_torch.serving.cache_pool import SlotCachePool
from repro_torch.serving.config import (EngineConfig, MLBackendConfig,
                                        PagedConfig, PressureConfig)
from repro_torch.serving.engine import (CascadeEngine,
                                        ContinuousCascadeEngine,
                                        ContinuousServeResult, ModelRunner,
                                        ServeResult)
from repro_torch.serving.paged_pool import BlockPressure, PagedCachePool
from repro_torch.serving.pressure import (DeferOnOomPolicy, PreemptPolicy,
                                          PressurePolicy, ShedPolicy,
                                          make_pressure_policy)
from repro_torch.serving.request import (ArrivalQueue, Request,
                                         make_requests, poisson_arrivals)
from repro_torch.serving.scheduler import SlotScheduler

__all__ = ["ArrivalQueue", "BlockPressure", "CascadeEngine", "CascadeSpec",
           "CascadeTier", "ContinuousCascadeEngine", "ContinuousServeResult",
           "DeferOnOomPolicy", "DeferralEdge", "EngineConfig",
           "MLBackendConfig", "ModelRunner", "PagedCachePool", "PagedConfig",
           "PreemptPolicy", "PressureConfig", "PressurePolicy", "Request",
           "ServeResult", "ShedPolicy", "SlotCachePool", "SlotScheduler",
           "make_pressure_policy", "make_requests", "poisson_arrivals"]
