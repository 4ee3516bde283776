"""Public kernel entry points and the kernel switch.

Counterpart of `repro.kernels.ops` for the kernels the port has. Each
entry point runs its CUDA kernel on CUDA tensors and its plain PyTorch
version on CPU tensors.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from repro_torch.kernels.deferral_entropy import deferral_entropy
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gatekeeper_loss import (gatekeeper_loss_fused,
                                                 gatekeeper_loss_tokens)
from repro_torch.kernels.paged_attention import (paged_flash_decode_gqa,
                                                 paged_flash_decode_mla,
                                                 paged_write_token,
                                                 paged_write_token_pair)
from repro_torch.kernels.wkv_scan import wkv_scan

__all__ = ["deferral_signal", "flash_attention", "gatekeeper_loss_fused",
           "gatekeeper_loss_tokens", "paged_flash_decode_gqa",
           "paged_flash_decode_mla", "paged_kernel_enabled",
           "paged_write_token", "paged_write_token_pair", "wkv"]


def paged_kernel_enabled(override: Optional[bool] = None,
                         device: Optional[torch.device] = None) -> bool:
    """Should the serving path go through the kernels' wrappers?

    The switch keeps its JAX name but covers every kernel of the serving
    path: the paged decode and write, the eq.-8 deferral signal
    (`deferral_signal`), prefill attention (`flash_attention`) and the
    RWKV6 and Mamba2 recurrence (`wkv_scan`).
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


def deferral_signal(logits: torch.Tensor):
    """(neg_entropy, max_prob, argmax) per row of logits [..., V] (eqs.
    7-8), each shaped like logits without its last axis: one
    `deferral_entropy` launch over the rows flattened to [T, V]."""
    lead = logits.shape[:-1]
    nent, mprob, amax = deferral_entropy(logits.reshape(-1, logits.shape[-1]))
    return nent.reshape(lead), mprob.reshape(lead), amax.reshape(lead)


def wkv(q, k, v, logw, u, state0, *, out=None):
    """The RWKV6 recurrence (`wkv_scan` in mode "rwkv"), as the JAX
    package's `ops.wkv`; Mamba2 calls `wkv_scan(mode="mamba")`."""
    return wkv_scan(q, k, v, logw, u, state0, mode="rwkv", out=out)
