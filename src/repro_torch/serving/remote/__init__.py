"""Distributed M_L tier for the port: socket RPC server, client backend,
replica pool (counterpart of `repro.serving.remote`).

`wire` pins the length-prefixed JSON protocol (schema-versioned, frames
byte-identical to the JAX package's); `MLServer` is the server (process
entrypoint: `repro_torch.launch.ml_server`); `SocketBackend` speaks the
`LargeBackend` protocol over one connection; `ReplicaPool` load-balances
N replicas with health checks, ejection and in-flight re-dispatch.
"""
from repro_torch.serving.remote import wire
from repro_torch.serving.remote.client import (RemoteBackendError,
                                               SocketBackend, parse_address)
from repro_torch.serving.remote.pool import ReplicaPool
from repro_torch.serving.remote.server import MLServer

SCHEMA_VERSION = wire.SCHEMA_VERSION

__all__ = [
    "MLServer",
    "ReplicaPool",
    "RemoteBackendError",
    "SCHEMA_VERSION",
    "SocketBackend",
    "parse_address",
    "wire",
]
