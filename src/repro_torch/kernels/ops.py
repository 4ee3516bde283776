"""Public kernel entry points and the paged-kernel switch.

Counterpart of `repro.kernels.ops` for the kernels the port has.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from repro_torch.kernels.gatekeeper_loss import (gatekeeper_loss_fused,
                                                 gatekeeper_loss_tokens)
from repro_torch.kernels.paged_attention import (paged_flash_decode_gqa,
                                                 paged_flash_decode_mla,
                                                 paged_write_token)

__all__ = ["gatekeeper_loss_fused", "gatekeeper_loss_tokens",
           "paged_flash_decode_gqa", "paged_flash_decode_mla",
           "paged_kernel_enabled", "paged_write_token"]


def paged_kernel_enabled(override: Optional[bool] = None,
                         device: Optional[torch.device] = None) -> bool:
    """Should paged decode go through the paged kernels' wrappers?

    Resolution order, as in the JAX package: an explicit `override`
    (engine config / function argument) > the REPRO_PAGED_KERNEL env var >
    the default, which is on exactly when the tensors live on CUDA. On CPU
    tensors the wrappers run their plain versions, so forcing the switch
    on there exercises the kernel path's control flow without a card."""
    if override is not None:
        return bool(override)
    env = os.environ.get("REPRO_PAGED_KERNEL")
    if env is not None:
        return env not in ("0", "false", "False")
    return device is not None and torch.device(device).type == "cuda"
