"""PyTorch/CUDA port of the Gatekeeper cascade serving stack.

A second package beside the JAX reference (`repro`): the same module
layout, the same public functions, PyTorch on the inside, and hand-written
CUDA kernels for Hopper (sm_90a) where the JAX package has Pallas TPU
kernels. It imports neither `jax` nor `repro`.

Entry points take a `device` argument. Left out, they run on CUDA and
raise when no CUDA device is present — never a silent CPU fallback. The
CPU tests pass ``device="cpu"``.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Optional, Union

if TYPE_CHECKING:
    import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`device` as a torch.device; None means CUDA, which must exist.
    (torch is imported here, not with the package, so that the static
    analysis, `python -m repro_torch.analysis`, runs on the standard
    library alone.)"""
    import torch
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and found no CUDA "
                "device; pass device='cpu' to run the plain PyTorch path")
        return torch.device("cuda")
    return torch.device(device)
