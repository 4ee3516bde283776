"""Cascade serving for the port: static and continuous-batching engines,
slot and block-paged KV pools, the sync M_L backend and telemetry."""
from repro_torch.core.cascade_spec import (CascadeSpec, CascadeTier,
                                           DeferralEdge)
from repro_torch.serving.config import (EngineConfig, MLBackendConfig,
                                        PagedConfig)
from repro_torch.serving.engine import (CascadeEngine,
                                        ContinuousCascadeEngine,
                                        ContinuousServeResult, ModelRunner,
                                        ServeResult)
from repro_torch.serving.request import (Request, make_requests,
                                         poisson_arrivals)

__all__ = ["CascadeEngine", "CascadeSpec", "CascadeTier",
           "ContinuousCascadeEngine", "ContinuousServeResult",
           "DeferralEdge", "EngineConfig", "MLBackendConfig", "ModelRunner",
           "PagedConfig", "Request", "ServeResult", "make_requests",
           "poisson_arrivals"]
