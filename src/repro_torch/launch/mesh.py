"""Production mesh layouts, the host mesh, and the card's constants.

Counterpart of `repro.launch.mesh`. The production meshes are layouts
(`sharding.MeshLayout`: axis names and sizes), so specs resolve against
them without 256 or 512 ranks; `make_host_mesh` is a real `DeviceMesh`
over an initialised world of one rank.
"""
from __future__ import annotations

from repro_torch.sharding import MeshLayout, ParallelContext, make_mesh


def make_production_mesh(*, multi_pod: bool = False) -> MeshLayout:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshLayout(shape, axes)


def make_context(mesh, rules=None) -> ParallelContext:
    pod = "pod" if "pod" in mesh.mesh_dim_names else None
    return ParallelContext(mesh=mesh, data_axis="data", model_axis="model",
                           pod_axis=pod, rules=rules)


def make_host_mesh(device_type: str = "cuda"):
    """A (1, 1) ("data", "model") DeviceMesh over a world of one rank,
    which the caller has initialised: every path through it is the
    single-device one."""
    return make_mesh((1, 1), ("data", "model"), device_type)


# NVIDIA H100 SXM5 80GB figures (NVIDIA's data sheet), per card, for the
# card this port runs on: NVIDIA H100 80GB HBM3, 700.00 W power limit.
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, dense bf16 on the tensor cores
HBM_BW = 3.35e12                # bytes/s
NVLINK_BW = 450e9               # bytes/s per direction per GPU (NVLink 4,
                                # 900 GB/s both directions)
HBM_BYTES = 85_017_493_504      # torch.cuda.get_device_properties(0)
                                # .total_memory on that card (79.18 GiB)
IB_BW = 50e9                    # bytes/s per GPU across nodes: one 400 Gb/s
                                # ConnectX-7 InfiniBand port per GPU in a
                                # DGX H100 (NVIDIA's DGX H100 data sheet)
NVLINK_DOMAIN = 8               # GPUs one NVLink domain joins (a DGX H100
                                # node: 8 GPUs over NVSwitch)
