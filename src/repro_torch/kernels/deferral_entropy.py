"""Fused deferral signal (eqs. 7-8): CUDA launch wrapper and plain version.

Counterpart of `repro.kernels.deferral_entropy.deferral_entropy` (Pallas,
TPU). The kernel is CUDA C++ for Hopper in `csrc/deferral_entropy.cu`;
its source note says what bounds it and what its design does about that.

  * `deferral_entropy` — per row of logits [T, V] (fp32 or bf16): the
    negative entropy sum p log p, the largest probability and the first
    index of the largest logit, in one streaming pass over the vocabulary
    and one launch (the last CTA of a row merges its vocabulary splits).
  * `deferral_entropy_plain` — the same function as
    `repro.kernels.ref.deferral_entropy_ref`: `log_softmax` in fp32,
    sum p * log p, `p.max`, first-index `argmax`.

The wrapper takes the plain version only for CPU tensors; for a CUDA
tensor it launches the kernel or raises. `deferral_entropy.launches`
counts kernel launches (never plain calls).
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build

_WAVES = 4          # CTAs per SM the vocabulary split aims for
_MIN_SPAN = 2048    # fewest vocabulary columns a CTA takes
_VEC = 8            # spans are a multiple of the widest vector (8 bf16)

Signal = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def deferral_entropy_plain(logits: torch.Tensor) -> Signal:
    """(neg_entropy f32 [T], max_prob f32 [T], argmax i32 [T]) from logits
    [T, V], as `repro.kernels.ref.deferral_entropy_ref` computes them."""
    x = logits.float()
    logp = torch.log_softmax(x, dim=-1)
    p = torch.exp(logp)
    neg_ent = (p * logp).sum(dim=-1)
    return neg_ent, p.amax(dim=-1), torch.argmax(x, dim=-1).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("deferral_entropy")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.deferral_entropy.argtypes = [vp] * 6 + [ci] * 5 + [vp]
    lib.deferral_entropy.restype = ci
    return lib


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def vocab_split(T: int, V: int, n_sms: int) -> Tuple[int, int]:
    """(span, splits): vocabulary columns per CTA, a multiple of `_VEC`,
    and the number of spans, so that T * splits CTAs give about `_WAVES`
    per SM without a span under `_MIN_SPAN` columns."""
    want = max(1, -(-_WAVES * n_sms // T))
    want = min(want, max(1, -(-V // _MIN_SPAN)))
    span = -(-V // want)
    span = -(-span // _VEC) * _VEC
    return span, -(-V // span)


# (device index, stream handle) -> the kernel's zeroed per-row ticket
# counters, grown to the most rows seen on that stream; each call leaves
# them zero, and calls on one stream run in order. Threads on distinct
# streams (M_L's workers) get distinct keys. Two threads on one stream
# share a key: the lock makes a grow atomic, and a thread that still
# holds the older, smaller tensor launches on the same stream, in order
# with the grow's zero fill, so each launch sees zeroed counters.
_counters: Dict[Tuple[int, int], torch.Tensor] = {}
_counters_lock = threading.Lock()


def _row_counters(dev: torch.device, stream: int, T: int) -> torch.Tensor:
    key = (dev.index, stream)
    with _counters_lock:
        counters = _counters.get(key)
        if counters is None or counters.numel() < T:
            counters = torch.zeros(T, dtype=torch.int32, device=dev)
            _counters[key] = counters
        return counters


def deferral_entropy(logits: torch.Tensor) -> Signal:
    """logits [T, V] (fp32 or bf16). Returns fp32 neg_entropy [T], fp32
    max_prob [T] and int32 argmax [T]."""
    if not logits.is_cuda:
        return deferral_entropy_plain(logits)
    _require(logits.dim() == 2, f"logits must be [T, V], got "
                                f"{tuple(logits.shape)}")
    T, V = logits.shape
    _require(T > 0 and V > 0, "empty logits")
    _require(logits.dtype in (torch.float32, torch.bfloat16),
             "logits must be fp32 or bf16")
    x = logits.contiguous()
    dev = x.device
    span, n_splits = vocab_split(T, V, _build.sm_count(dev.index))
    stream = torch.cuda.current_stream(dev).cuda_stream
    neg_ent = torch.empty(T, dtype=torch.float32, device=dev)
    max_prob = torch.empty(T, dtype=torch.float32, device=dev)
    argmax = torch.empty(T, dtype=torch.int32, device=dev)
    scratch = counters = None
    if n_splits > 1:
        scratch = torch.empty((4, n_splits, T), dtype=torch.float32,
                              device=dev)
        counters = _row_counters(dev, stream, T)
    err = _lib().deferral_entropy(
        x.data_ptr(), neg_ent.data_ptr(), max_prob.data_ptr(),
        argmax.data_ptr(), None if scratch is None else scratch.data_ptr(),
        None if counters is None else counters.data_ptr(), T, V, span,
        n_splits, int(x.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"deferral_entropy launch failed: CUDA error {err}")
    _build.count(deferral_entropy, launches=1)
    return neg_ent, max_prob, argmax


deferral_entropy.launches = 0
