"""Cascade serving engines (paper Fig. 1: M_S local, M_L behind a backend,
confidence gate g).

Counterpart of `repro.serving.engine` (see its docstring for the design).

`ModelRunner` — greedy prefill + decode for one model; `generate` keeps
the tokens and the eq.-8 confidence sum on the device and copies them to
the host once per batch; `sample` draws tokens as JAX's runner does
(`core.prng`, for the semantic-agreement signal).

`CascadeEngine` — the static reference path: M_S generates every request
in full, requests whose mean confidence falls below tau are regenerated
by M_L.

`ContinuousCascadeEngine` — an N-tier cascade (`CascadeSpec`) with
continuous batching of tier 0 over a slot or block-paged KV pool. Every
decode step decodes ALL slots at per-slot positions and accumulates
the confidence sum on the device; only small per-slot control vectors
cross to the host each sync. Once a request has decoded
`min_tokens` tokens, a running mean confidence below ``tau - margin``
evicts it in flight, and it is regenerated on M_L. On the paged backend
(`backend="paged"`), prompts prefill in chunks batched across same-offset
requests, prompt prefixes are shared copy-on-write, and decode goes
through the CUDA paged kernels when `paged_kernel` resolves on.

Memory pressure and overload (as in the JAX engine): with
`PagedConfig.pressure` the paged pool admits against an oversubscribed
virtual block budget, and physical exhaustion (`BlockPressure`) is
answered by the `PressurePolicy`, which evicts the youngest running
request: "preempt" snapshots its decode state and decode-written blocks
to pinned host memory, publishes its prompt blocks in the prefix registry
and requeues it age-first (on re-admission the prompt blocks come back
from the registry, the swap tier or a re-prefill, the snapshot is copied
back, and decoding resumes where it stopped), "defer" hands it to M_L
(`deferred_reason="oom"`), "shed" drops it (REJECTED). `max_queue` bounds
the ready queue (overflow shed newest-first as REJECTED) and `deadline_s`
expires requests still queued past their deadline (EXPIRED).

M_L regeneration goes through a pluggable backend
(`large_backend.make_large_backend`, from `EngineConfig.ml` or the tier's
own `backend`): "sync" runs each released batch inline on the decode loop
(the reference), "thread" on a worker thread under a CUDA stream of its
own on the card, "stub" the same behind a serialized pipe, and a callable
factory plugs in the socket and replica-pool backends of
`serving.remote`. Deferrals stream into the backend as their slots
retire; completed regenerations fold back in every engine iteration
(`poll_large`), and the drain at the end aborts a remote backend that
makes no progress for its `drain_stall_timeout`.

The same switch (`kernel_ops.paged_kernel_enabled`: the engine's
`paged_kernel`, then REPRO_PAGED_KERNEL, then on exactly for CUDA) picks
the kernel path for the rest of the serving path on either backend: every
M_S decode step and prefill seed takes its greedy token and eq.-8
confidence from one `deferral_signal` launch, GQA prefill (the hybrid's
shared block's too) runs the `flash_attention` kernel, and every RWKV6
or Mamba2 layer of a prefill or decode step runs the `wkv_scan` kernel
(such a model keeps a recurrent state, so it serves on the slot backend,
whose admission prefills each exact prompt length apart: no pad token
enters a state). The continuous engine
passes its `paged_kernel` to `ModelRunner.generate` for M_S calibration
and for M_L behind its backend. The plain path is
`deferral_entropy_plain`, `_attend` and `wkv_scan_plain`.

Ladders (as in the JAX engine): each edge e hands its deferrals to its
own backend running tier e+1, and an intermediate tier's results are
gated by the next edge, whose deferrals are arrival traffic for the next
backend; the final drain flushes backend e only once every backend
upstream of it is empty. A 2-tier spec is the two-model cascade. With
`EngineConfig.recalibration` an `EdgeRecalibrator` moves each edge's tau
toward `recalib_target` online from the confidences it gates on. The
legacy flat-kwargs constructor `ContinuousCascadeEngine(small, large,
tau=..., ...)` maps every old name onto the spec and config
(`config.LEGACY_KWARG_MAP`). An observability runtime the engine builds
itself (`obs` None or an `ObsConfig`) starts its /metrics endpoint with
the run; its profiler window ticks once per engine iteration.

Differences from the JAX engine: PyTorch runs eagerly (no jit; the decode
loop is a Python loop of device ops), and the KV caches are updated in
place. Greedy equivalences within the port match the JAX package's:
slot against paged, kernel against plain path, shared against unshared
prefix, preempted against unconstrained, and ``early_exit=False``
continuous against static.
"""
from __future__ import annotations

import dataclasses
import math
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.calibration import (calibrate_edges,
                                          expected_compute_cost,
                                          ladder_compute_cost)
from repro_torch.core import prng
from repro_torch.core.cascade_spec import CascadeSpec
from repro_torch.core.deferral import SignalObservation
from repro_torch.core.recalibration import EdgeRecalibrator
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.deferral_entropy import deferral_entropy_plain
from repro_torch.models import transformer as tfm
from repro_torch.serving.cache_pool import SlotCachePool, scatter_rows
from repro_torch.serving.config import (LEGACY_KWARG_MAP, MIGRATION_HINT,
                                        EngineConfig, MLBackendConfig,
                                        PagedConfig)
from repro_torch.serving.large_backend import make_large_backend
from repro_torch.serving.obs import Observability, emit_request_spans
from repro_torch.serving.paged_pool import (BlockPressure, PagedCachePool,
                                           next_pow2)
from repro_torch.serving.pressure import (DEFER, PREEMPT, SHED,
                                          make_pressure_policy)
from repro_torch.serving.request import (DEFERRED_PENDING, DONE, EXPIRED,
                                         REJECTED, ArrivalQueue, Request)
from repro_torch.serving.scheduler import SlotScheduler
from repro_torch.serving.telemetry import ServingTelemetry


# seconds each poll of the final M_L drain may wait for its first result
_DRAIN_POLL_S = 0.05


def _signal(logits: torch.Tensor, use_kernel: bool
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(greedy token int32 [k], eq.-8 negative entropy fp32 [k]) of
    logits [k, V]: one `deferral_signal` launch on the kernel path."""
    signal = (kernel_ops.deferral_signal if use_kernel
              else deferral_entropy_plain)
    neg_ent, _, tok = signal(logits)
    return tok, neg_ent


def _to_host(ints: torch.Tensor, floats: torch.Tensor
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Copy an int32 and a float32 tensor of the same leading shape to the
    host in ONE transfer (the floats travel bit-exact as int32)."""
    packed = torch.cat([ints.to(torch.int32).reshape(ints.shape[0], -1),
                        floats.float().view(torch.int32).reshape(
                            floats.shape[0], -1)], dim=1).cpu().numpy()
    n = packed.shape[1] - (floats.numel() // floats.shape[0])
    return packed[:, :n], packed[:, n:].view(np.float32)


@dataclasses.dataclass
class ServeResult:
    """Static-engine output batch (rid order == input row order)."""
    tokens: np.ndarray            # [B, max_new] final (post-cascade) tokens
    small_tokens: np.ndarray
    confidence: np.ndarray        # [B] mean per-step neg entropy (eq. 8)
    deferred: np.ndarray          # [B] bool
    deferral_ratio: float
    compute_cost: float
    steps: int


class ModelRunner:
    """Greedy prefill + decode for one model on its parameters' device.
    Refuses an encoder-decoder or VLM config (token prompts only)."""

    def __init__(self, cfg, params: Any):
        tfm.check_ported(cfg, engine=True)
        self.cfg = cfg
        self.params = params
        self.device = tfm.param_device(params)

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, prompt_len: int,
                 max_new: int, paged_kernel: Optional[bool] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Greedy generation. prompts [B, prompt_len]. Returns (tokens
        [B, max_new], mean_neg_entropy [B]) in one device->host copy.
        `paged_kernel` is the kernel switch's override (None: resolved
        from REPRO_PAGED_KERNEL, then the device)."""
        cfg, params = self.cfg, self.params
        use_kernel = kernel_ops.paged_kernel_enabled(paged_kernel,
                                                     self.device)
        toks = torch.from_numpy(np.ascontiguousarray(prompts, np.int64)
                                ).to(self.device)
        B = toks.shape[0]
        cache = tfm.init_cache(cfg, B, prompt_len + max_new,
                               device=self.device)
        logits, cache = tfm.prefill(params, cfg, toks, cache, last_only=True,
                                    paged_kernel=use_kernel)
        tok, conf_sum = _signal(logits[:, -1, :], use_kernel)
        buf = torch.zeros((B, max_new), dtype=torch.int32, device=self.device)
        buf[:, 0] = tok
        for i in range(max_new - 1):
            step_logits, cache = tfm.decode_step(params, cfg, tok,
                                                 prompt_len + i, cache,
                                                 paged_kernel=use_kernel)
            tok, neg_ent = _signal(step_logits, use_kernel)
            conf_sum = conf_sum + neg_ent
            buf[:, i + 1] = tok
        tokens, conf = _to_host(buf, conf_sum / max_new)
        return tokens, conf[:, 0]

    @torch.inference_mode()
    def sample(self, prompts: np.ndarray, prompt_len: int, max_new: int,
               seed: int = 0, temperature: float = 1.0,
               paged_kernel: Optional[bool] = None) -> np.ndarray:
        """Temperature sampling for agreement-style deferral signals:
        `generate`'s prefill and decode steps, each step's tokens drawn as
        JAX's runner draws them, `jax.random.categorical(fold_in(PRNGKey(
        seed), i), logits * (1 / temperature))`, by `core.prng` on the
        logits' device. The same (prompts, seed) always gives the same
        samples; rows draw independent noise. Returns [B, max_new] int32
        tokens in one device->host copy."""
        if temperature <= 0:
            raise ValueError(f"temperature must be > 0, got {temperature}")
        cfg, params = self.cfg, self.params
        use_kernel = kernel_ops.paged_kernel_enabled(paged_kernel,
                                                     self.device)
        key = prng.prng_key(int(seed) & prng.MASK32)
        inv_t = 1.0 / float(temperature)
        toks = torch.from_numpy(np.ascontiguousarray(prompts, np.int64)
                                ).to(self.device)
        B = toks.shape[0]
        cache = tfm.init_cache(cfg, B, prompt_len + max_new,
                               device=self.device)
        logits, cache = tfm.prefill(params, cfg, toks, cache, last_only=True,
                                    paged_kernel=use_kernel)
        tok = prng.categorical(prng.fold_in(key, 0),
                               logits[:, -1, :].float() * inv_t)
        buf = torch.zeros((B, max_new), dtype=torch.int32, device=self.device)
        buf[:, 0] = tok
        for i in range(max_new - 1):
            step_logits, cache = tfm.decode_step(params, cfg, tok,
                                                 prompt_len + i, cache,
                                                 paged_kernel=use_kernel)
            tok = prng.categorical(prng.fold_in(key, i + 1),
                                   step_logits.float() * inv_t)
            buf[:, i + 1] = tok
        return buf.cpu().numpy()


class CascadeEngine:
    """Two-ModelRunner cascade with a calibrated threshold (static,
    lock-step uniform batches — the reference path)."""

    def __init__(self, small: ModelRunner, large: ModelRunner,
                 tau: float = -1.0, cost_small: float = 0.2,
                 cost_large: float = 1.0):
        self.small = small
        self.large = large
        self.tau = tau
        self.cost_small = cost_small
        self.cost_large = cost_large

    def calibrate(self, val_prompts: np.ndarray, prompt_len: int,
                  max_new: int, deferral_ratio: float) -> float:
        """Pick tau so `deferral_ratio` of the validation prompts fall
        below it (`core.calibration.calibrate_edges`)."""
        spec = CascadeSpec.two_tier(self.small, self.large, tau=self.tau,
                                    cost_small=self.cost_small,
                                    cost_large=self.cost_large)
        self.tau = calibrate_edges(spec, val_prompts, max_new=max_new,
                                   deferral_ratio=deferral_ratio,
                                   prompt_len=prompt_len)[0]
        return self.tau

    def serve(self, prompts: np.ndarray, prompt_len: int,
              max_new: int) -> ServeResult:
        """Full M_S decode, then batched M_L regeneration of the
        below-tau rows."""
        s_tokens, conf = self.small.generate(prompts, prompt_len, max_new)
        deferred = conf < self.tau
        tokens = s_tokens.copy()
        if deferred.any():
            idx = np.nonzero(deferred)[0]
            l_tokens, _ = self.large.generate(prompts[idx], prompt_len,
                                              max_new)
            tokens[idx] = l_tokens
        ratio = float(deferred.mean())
        return ServeResult(
            tokens=tokens, small_tokens=s_tokens, confidence=conf,
            deferred=deferred, deferral_ratio=ratio,
            compute_cost=expected_compute_cost(ratio, self.cost_small,
                                               self.cost_large),
            steps=max_new)


# ---------------------------------------------------------------------------
# Continuous batching
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ContinuousServeResult:
    """Continuous-engine output (requests sorted by rid)."""
    requests: List[Request]
    tokens: np.ndarray            # [N, max_new] final tokens, rid order
    confidence: np.ndarray        # [N] mean neg entropy at retirement
    deferred: np.ndarray          # [N] bool
    early_exited: np.ndarray      # [N] bool (in-flight deferrals)
    deferral_ratio: float
    saved_steps: int              # M_S decode steps skipped via early exit
    steps: int                    # engine decode steps executed
    stats: Dict[str, Any]         # telemetry summary


class ContinuousCascadeEngine:
    """Continuous-batching N-tier cascade over a slot or block-paged KV
    pool, built from a `CascadeSpec` (tiers + one deferral edge per
    adjacent pair) and an `EngineConfig` (slots, KV backend, the upper
    tiers' batching, online recalibration). Tier 0 decodes in the slots;
    tier e+1 runs behind edge e's backend.

    Per-slot device state (all [n_slots] unless noted): last_tok, pos,
    n_gen (prefill token counts as 1), budget (the request's max_new; a
    slot self-deactivates on device when n_gen reaches it), conf_sum (the
    running eq.-8 sum, ON DEVICE), active, and tokens [n_slots, max_new]
    (copied to the host at retirement).

    `pool` is the KV pool of the latest `run` (None before one), kept so
    that a caller can inspect it afterwards (`check_invariants`, the swap
    store)."""

    pool = None

    def __init__(self, spec, config: Optional[EngineConfig] = None,
                 **legacy):
        if isinstance(spec, CascadeSpec):
            if legacy:
                raise TypeError(
                    f"ContinuousCascadeEngine(spec, config) takes no extra "
                    f"kwargs, got {sorted(legacy)} — per-edge knobs live on "
                    f"the spec's DeferralEdges, execution knobs on "
                    f"EngineConfig")
            if config is not None and not isinstance(config, EngineConfig):
                raise TypeError(f"config must be an EngineConfig, got "
                                f"{type(config).__name__}")
            self.spec = spec
            self.config = config if config is not None else EngineConfig()
        else:
            # legacy flat-kwargs shim: (small, large, n_slots=..., tau=...,
            # ...) — every old name maps onto a spec/config field
            # (config.LEGACY_KWARG_MAP is the table) so old call sites run
            # through the exact same code path as a hand-built 2-tier spec
            small, large = spec, legacy.pop("large", config)
            if not (hasattr(small, "generate") and hasattr(large, "generate")):
                raise TypeError(
                    "ContinuousCascadeEngine needs a CascadeSpec (plus an "
                    "optional EngineConfig) or the legacy "
                    "(small, large) ModelRunner pair")
            unknown = set(legacy) - set(LEGACY_KWARG_MAP)
            if unknown:
                raise TypeError(f"unknown ContinuousCascadeEngine kwargs "
                                f"{sorted(unknown)}")
            warnings.warn(MIGRATION_HINT, DeprecationWarning, stacklevel=2)
            self.spec = CascadeSpec.two_tier(
                small, large,
                tau=legacy.get("tau", -1.0),
                margin=legacy.get("margin", 0.0),
                min_tokens=legacy.get("min_tokens", 2),
                cost_small=legacy.get("cost_small", 0.2),
                cost_large=legacy.get("cost_large", 1.0))
            self.config = EngineConfig(
                n_slots=legacy.get("n_slots", 8),
                early_exit=legacy.get("early_exit", True),
                steps_per_sync=legacy.get("steps_per_sync", 1),
                backend=legacy.get("backend", "slot"),
                paged=PagedConfig(
                    block_size=legacy.get("block_size", 16),
                    n_blocks=legacy.get("n_blocks"),
                    prefill_chunk=legacy.get("prefill_chunk"),
                    paged_kernel=legacy.get("paged_kernel"),
                    batch_prefill=legacy.get("batch_prefill", True),
                    prefix_sharing=legacy.get("prefix_sharing", True)),
                ml=MLBackendConfig(
                    kind=legacy.get("large_backend", "sync"),
                    large_batch=legacy.get("large_batch"),
                    max_wait=legacy.get("large_max_wait"),
                    stub_latency=legacy.get("stub_latency", 0.0)))

    # -- back-compat attribute surface (the legacy flat-kwarg names read —
    # and where old code mutated them, write — through to spec/config) ----
    @property
    def small(self) -> ModelRunner:
        return self.spec.tiers[0].runner

    @property
    def large(self):
        return self.spec.tiers[1].runner

    @property
    def tau(self) -> float:
        return self.spec.edges[0].tau

    @tau.setter
    def tau(self, v: float) -> None:
        self.spec.edges[0].tau = float(v)

    @property
    def margin(self) -> float:
        return self.spec.edges[0].margin

    @margin.setter
    def margin(self, v: float) -> None:
        self.spec.edges[0].margin = float(v)

    @property
    def min_tokens(self) -> int:
        return self.spec.edges[0].min_tokens

    @min_tokens.setter
    def min_tokens(self, v: int) -> None:
        self.spec.edges[0].min_tokens = max(1, int(v))

    @property
    def early_exit(self) -> bool:
        return self.config.early_exit

    @early_exit.setter
    def early_exit(self, v: bool) -> None:
        self.config.early_exit = bool(v)

    @property
    def n_slots(self) -> int:
        return self.config.n_slots

    @property
    def steps_per_sync(self) -> int:
        return self.config.steps_per_sync

    @property
    def backend(self) -> str:
        return self.config.backend

    @property
    def large_batch(self) -> Optional[int]:
        return self.config.ml.large_batch

    @property
    def large_backend(self):
        return self.config.ml.kind

    @property
    def large_max_wait(self) -> Optional[float]:
        return self.config.ml.max_wait

    @property
    def stub_latency(self) -> float:
        return self.config.ml.stub_latency

    @property
    def block_size(self) -> int:
        return self.config.paged.block_size

    @property
    def n_blocks(self) -> Optional[int]:
        return self.config.paged.n_blocks

    @property
    def prefill_chunk(self) -> Optional[int]:
        return self.config.paged.prefill_chunk

    @property
    def paged_kernel(self) -> Optional[bool]:
        return self.config.paged.paged_kernel

    @property
    def batch_prefill(self) -> bool:
        return self.config.paged.batch_prefill

    @property
    def prefix_sharing(self) -> bool:
        return self.config.paged.prefix_sharing

    @property
    def cost_small(self) -> float:
        return self.spec.tiers[0].cost

    @property
    def cost_large(self) -> float:
        return self.spec.tiers[1].cost

    def calibrate(self, val_prompts: np.ndarray, prompt_len: int,
                  max_new: int, deferral_ratio=0.2):
        """Calibrate every edge's tau on a uniform validation batch
        (`core.calibration.calibrate_edges`: edge i calibrates on the
        prompts the edges before it would defer that far). Returns the
        single tau for a 2-tier spec, the per-edge list for a deeper
        ladder; `deferral_ratio` may be per edge."""
        taus = calibrate_edges(self.spec, val_prompts, max_new=max_new,
                               deferral_ratio=deferral_ratio,
                               prompt_len=prompt_len,
                               paged_kernel=self.config.paged.paged_kernel)
        return taus[0] if len(taus) == 1 else taus

    # -- device programs -----------------------------------------------------
    def _decode_body(self, cache, state, pages, max_new: int,
                     paged_kernel: bool = False) -> dict:
        """One decode step over ALL slots at per-slot positions. Inactive
        slots compute but their state is untouched; in paged mode their
        page-table rows are masked to the trash block, so a stale `pos`
        can never write into a block that now belongs to someone else.
        `paged_kernel` is the engine's resolved kernel switch."""
        small = self.small
        if pages is not None:
            pages = torch.where(state["active"][:, None], pages, 0)
        logits, _ = tfm.decode_step(small.params, small.cfg,
                                    state["last_tok"], state["pos"], cache,
                                    pages=pages, paged_kernel=paged_kernel)
        tok, neg_ent = _signal(logits, paged_kernel)
        act = state["active"]
        inc = act.to(torch.int32)
        rows = torch.arange(act.shape[0], device=act.device)
        col = torch.clamp(state["n_gen"], 0, max_new - 1).long()
        tokens = state["tokens"]
        tokens[rows, col] = torch.where(act, tok, tokens[rows, col])
        n_gen = state["n_gen"] + inc
        return {
            "last_tok": torch.where(act, tok, state["last_tok"]),
            "pos": state["pos"] + inc,
            "n_gen": n_gen,
            "budget": state["budget"],
            "conf_sum": state["conf_sum"] + torch.where(act, neg_ent, 0.0),
            "active": act & (n_gen < state["budget"]),
            "tokens": tokens,
        }

    @staticmethod
    def _seed_slots(state, slots, tok0, neg_ent0, budgets, prompt_lens,
                    max_new: int) -> None:
        """Start decode in `slots` (in place) from the signal of their
        last prompt token: first token tok0 [k], confidence seed neg_ent0
        [k], position."""
        dev = tok0.device
        row0 = torch.zeros((len(slots), max_new), dtype=torch.int32,
                           device=dev)
        row0[:, 0] = tok0
        budgets = budgets.to(dev)
        state["last_tok"][slots] = tok0
        state["pos"][slots] = prompt_lens.to(dev)
        state["n_gen"][slots] = 1
        state["budget"][slots] = budgets
        state["conf_sum"][slots] = neg_ent0
        state["active"][slots] = budgets > 1
        state["tokens"][slots] = row0

    @staticmethod
    def _resume_slot(state, slot: int, rs: dict, budget: int) -> None:
        """Restore a preempted request's decode state in `slot` (in
        place) verbatim from its snapshot `rs` — the counterpart of
        `_seed_slots` for re-admission. Decoding on from it over the
        restored and recomputed blocks is bit-exact with never having
        been preempted."""
        dev = state["tokens"].device
        state["last_tok"][slot] = rs["last_tok"]
        state["pos"][slot] = rs["pos"]
        state["n_gen"][slot] = rs["n_gen"]
        state["budget"][slot] = budget
        state["conf_sum"][slot] = rs["conf_sum"]
        state["active"][slot] = rs["n_gen"] < budget
        state["tokens"][slot] = torch.from_numpy(rs["tokens"]).to(dev)

    @staticmethod
    def _slot_to_host(state, slot: int) -> Tuple[int, int, int, float,
                                                 np.ndarray]:
        """(last_tok, pos, n_gen, conf_sum, tokens row) of one slot in one
        device -> host copy."""
        ints = torch.cat([state["last_tok"][slot:slot + 1],
                          state["pos"][slot:slot + 1],
                          state["n_gen"][slot:slot + 1],
                          state["tokens"][slot]])
        ints, floats = _to_host(ints[None], state["conf_sum"][None,
                                                               slot:slot + 1])
        return (int(ints[0, 0]), int(ints[0, 1]), int(ints[0, 2]),
                float(floats[0, 0]), ints[0, 3:].copy())

    # -- host-side control loop -------------------------------------------
    @torch.inference_mode()
    def run(self, requests: List[Request], max_new: Optional[int] = None,
            audit_path: Optional[str] = None, *,
            obs=None) -> ContinuousServeResult:
        """Serve `requests` (each with its own prompt and budget).

        `max_new` is the run-wide token-buffer width and budget cap
        (default: the largest request budget). `obs` is None, an
        `ObsConfig` (the engine builds and finishes the runtime) or a
        caller-owned `Observability`."""
        if not requests:
            raise ValueError("run() needs at least one request")
        small, ecfg = self.small, self.config
        cfg, dev = small.cfg, small.device
        if max_new is None:
            max_new = max(r.max_new for r in requests)
        for r in requests:
            r.max_new = min(r.max_new, max_new)
        max_len = max(r.prompt_len + r.max_new for r in requests)
        paged = ecfg.backend == "paged"
        pc = ecfg.paged
        use_kernel = kernel_ops.paged_kernel_enabled(pc.paged_kernel, dev)
        pressure = pc.pressure if paged else None
        policy = (make_pressure_policy(pressure.policy,
                                       pressure.max_preemptions)
                  if pressure is not None else None)
        if paged:
            bs = pc.block_size
            n_blocks = (pc.n_blocks if pc.n_blocks is not None
                        else ecfg.n_slots * math.ceil(max_len / bs))
            biggest = max(math.ceil((r.prompt_len + r.max_new - 1) / bs)
                          for r in requests)
            if n_blocks < biggest:
                # each request must fit the PHYSICAL budget on its own:
                # oversubscription stretches the admission (virtual)
                # budget, never physical capacity
                raise ValueError(
                    f"n_blocks={n_blocks} cannot hold the largest request "
                    f"({biggest} blocks of {bs}); raise n_blocks")
            pool = PagedCachePool(
                cfg, ecfg.n_slots, n_blocks, bs, max_len, dev,
                oversubscribe=(pressure.oversubscribe
                               if pressure is not None else 1.0),
                swap_blocks=(pressure.swap_blocks
                             if pressure is not None else 0))
        else:
            pool = SlotCachePool(cfg, ecfg.n_slots, max_len, dev)

        self.pool = pool
        sched = SlotScheduler(pool)
        queue = ArrivalQueue(requests, max_queue=ecfg.max_queue)
        # engine-level deadline default; an explicit per-request deadline
        # (make_requests(deadline_s=...)) wins
        if ecfg.deadline_s is not None:
            for r in requests:
                if r.deadline is None:
                    r.deadline = r.arrival_time + ecfg.deadline_s
        overload_on = (queue.max_queue is not None
                       or any(r.deadline is not None for r in requests))
        spec = self.spec
        n_edges = len(spec.edges)
        last_tier = spec.n_tiers - 1
        edge0 = spec.edges[0]
        sig0 = edge0.signal
        # online tau recalibration: one controller per edge, seeded from
        # the configured (offline) taus; None keeps the taus fixed
        recal = None
        if ecfg.recalibration is not None:
            recal = EdgeRecalibrator(list(spec.taus), ecfg.recalib_target,
                                     ecfg.recalibration)
        # a passed-in Observability is caller-owned; anything else (None
        # or an ObsConfig) the engine builds, starts and finishes itself
        own_obs = not isinstance(obs, Observability)
        obs_rt = obs if isinstance(obs, Observability) else Observability(obs)
        if own_obs:
            obs_rt.start_server()
        tr = obs_rt.tracer
        dev_timer = obs_rt.device_timer
        profiler = obs_rt.profiler
        tel = ServingTelemetry(audit_path, obs=obs_rt)

        def edge_tau(e: int) -> float:
            return recal.tau(e) if recal is not None else spec.edges[e].tau

        def observe_tau(e: int, conf: float) -> None:
            """Feed edge e's decision back to its controller (right after
            deciding, as `TauController.observe` asks), with an audit event
            carrying the unrounded confidence, so that the log replays
            the controller exactly."""
            tau = recal.observe(e, conf)
            tel.event("recalibrate", edge=e, confidence=conf, tau=tau)

        backends: List[Any] = []
        try:
            S = ecfg.n_slots
            zi = dict(dtype=torch.int32, device=dev)
            state = {
                "last_tok": torch.zeros((S,), **zi),
                "pos": torch.zeros((S,), **zi),
                "n_gen": torch.zeros((S,), **zi),
                "budget": torch.full((S,), max_new, **zi),
                "conf_sum": torch.zeros((S,), dtype=torch.float32, device=dev),
                "active": torch.zeros((S,), dtype=torch.bool, device=dev),
                "tokens": torch.zeros((S, max_new), **zi),
            }
            # paged: admitted requests still prefilling, FIFO of
            # [request, slot, next chunk offset]
            prefilling: List[List] = []
            n_steps = 0
            n_prefill_chunks = 0
            n_prefill_dispatches = 0
            n_seed_dispatches = 0
            n_prefill_tokens = 0
            n_shared_tokens = 0
            peak_active = 0
            n_relief = 0        # pressure-policy evictions (paged only)
            # one execution backend per edge: backends[e] runs tier e+1.
            # A tier's own `backend` wins, else config.ml.kind; only edge
            # 0's backend registers metrics (the registry's names are
            # unique per run). The engine's kernel switch reaches a local
            # runner's generate (a remote server keeps its own); each
            # worker backend runs on a CUDA stream of its own
            for e in range(n_edges):
                tier = spec.tiers[e + 1]
                kind = (tier.backend if tier.backend is not None
                        else ecfg.ml.kind)
                backends.append(make_large_backend(
                    kind, tier.runner, max_new, ecfg.ml.large_batch,
                    ecfg.ml.max_wait, ecfg.ml.stub_latency,
                    registry=tel.registry if e == 0 else None,
                    paged_kernel=use_kernel))
            ml = backends[0]
            by_rid = {r.rid: r for r in requests}
            ml_depths: List[int] = []
            reg = tel.registry
            reg.gauge("serving_active_slots",
                      "requests resident in M_S decode slots",
                      fn=lambda: sched.n_active)
            reg.gauge("serving_queue_ready",
                      "arrived requests awaiting slot admission",
                      fn=lambda: queue.n_ready)
            reg.gauge("serving_requests_admitted",
                      "requests admitted into slots (lifetime)",
                      fn=lambda: sched.n_admitted)
            reg.gauge("serving_requests_retired",
                      "requests retired from slots (lifetime)",
                      fn=lambda: sched.n_retired)
            reg.gauge("serving_preemptions",
                      "requests preempted under block pressure (lifetime)",
                      fn=lambda: sched.n_preempted)
            if paged:
                pool.register_metrics(reg)
            # host mirrors of the confidence accumulators (tracing only)
            conf_prev = np.zeros(S, np.float64)
            ngen_prev = np.zeros(S, np.int64)
            tel.reset_clock()

            edge_deferrals = [0] * n_edges

            def submit_large(req: Request, edge: int):
                """Stream one deferral across `edge` into tier edge+1's
                backend the moment the tier below lets go of it."""
                edge_deferrals[edge] += 1
                req.tier = edge + 1
                req.state = DEFERRED_PENDING
                req.t_submit_large = tel.now
                backends[edge].submit([req])
                tel.event("large_submit", rid=req.rid, edge=edge,
                          depth=backends[edge].n_pending)

            def total_pending() -> int:
                return sum(b.n_pending for b in backends)

            def poll_large(timeout: Optional[float] = None):
                """Fold completed regenerations back into the run (a
                worker or remote backend's results arrive while M_S
                decodes). A result from backends[e] is tier e+1's output:
                final at the last tier; at an intermediate tier gated by
                edge e+1, below tau it becomes arrival traffic for the
                next backend. `timeout` waits that long for the first
                result of the first backend with work pending (in the
                drain, the one flushed last)."""
                first = next((e for e, be in enumerate(backends)
                              if be.n_pending), None)
                for e, be in enumerate(backends):
                    wait = timeout if e == first else None
                    for res in be.poll(timeout=wait):
                        req = by_rid[res.rid]
                        tier = e + 1
                        now = tel.now
                        if tier < last_tier:
                            edge = spec.edges[tier]
                            sig = edge.signal
                            if sig.supports_running:
                                conf = float(res.confidence)
                            else:
                                conf = float(sig.finalize(SignalObservation(
                                    prompt=req.prompt,
                                    mean_confidence=float(res.confidence),
                                    tokens=np.asarray(res.tokens, np.int32),
                                    runner=spec.tiers[tier].runner,
                                    max_new=max_new, rid=req.rid,
                                    paged_kernel=use_kernel)))
                            tau_e = edge_tau(tier)
                            defer = conf < tau_e
                            if recal is not None:
                                observe_tau(tier, conf)
                            tel.event("tier_gate", rid=req.rid, tier=tier,
                                      edge=tier, confidence=round(conf, 6),
                                      tau=round(tau_e, 6), deferred=defer)
                            if defer:
                                submit_large(req, tier)
                                continue
                        # accepted at this tier: final tokens, trimmed to
                        # the request's own budget
                        req.tier = tier
                        req.tokens = np.asarray(
                            res.tokens, np.int32)[:req.max_new].copy()
                        req.state = DONE
                        req.t_done = now
                        tel.m_tokens.labels(model="large").inc(
                            len(req.tokens))
                        tel.event("large_complete", rid=req.rid, tier=tier,
                                  batch_id=res.batch_id, n_real=res.n_real,
                                  pad_to=res.pad_to, reason=res.reason,
                                  wait_ms=round(
                                      (now - req.t_submit_large) * 1e3, 3))

            def sync_retire():
                """Pull the small control vectors, retire finished and
                in-flight-deferred slots, and deactivate them on device.
                Slots still prefilling are skipped."""
                mid_prefill = {s for _, s, _ in prefilling}
                n_gen, conf_sum = _to_host(state["n_gen"], state["conf_sum"])
                n_gen, conf_sum = n_gen[:, 0], conf_sum[:, 0]
                toks = None
                retired: List[int] = []
                now = tel.now
                for slot in sched.active_slots:
                    if slot in mid_prefill:
                        continue
                    req = sched.running[slot]
                    n = int(n_gen[slot])
                    mean = float(conf_sum[slot]) / max(n, 1)
                    finished = n >= req.max_new
                    tau0 = edge_tau(0)
                    # in-flight deferral needs a running form of the
                    # signal; one without (k-sample agreement) gates only
                    # at full retirement
                    evict = (not finished and ecfg.early_exit
                             and sig0.supports_running
                             and n >= edge0.min_tokens
                             and sig0.running(mean, n) < tau0 - edge0.margin)
                    if not (finished or evict):
                        continue
                    if toks is None:
                        toks = state["tokens"].cpu().numpy()
                    req.n_small_steps = n
                    req.small_tokens = toks[slot, :n].copy()
                    if evict:
                        conf_r, defer = mean, True
                    else:
                        conf_r = (mean if sig0.supports_running
                                  else float(sig0.finalize(SignalObservation(
                                      prompt=req.prompt, mean_confidence=mean,
                                      tokens=req.small_tokens, runner=small,
                                      max_new=req.max_new, rid=req.rid,
                                      paged_kernel=use_kernel))))
                        defer = conf_r < tau0
                    req.confidence = conf_r
                    if recal is not None:
                        observe_tau(0, conf_r)
                    sched.retire(slot, now, deferred=defer, early=evict)
                    if defer:
                        submit_large(req, 0)
                    else:
                        req.tokens = toks[slot, :req.max_new].copy()
                    reason = ("defer_early" if evict else
                              "defer_final" if defer else "finish")
                    tel.event("retire", rid=req.rid, slot=slot,
                              reason=reason, n_gen=n,
                              confidence=round(mean, 6))
                    tel.m_requests.labels(outcome=reason).inc()
                    if not defer:
                        tel.m_tokens.labels(model="small").inc(
                            len(req.tokens))
                    retired.append(slot)
                if retired:
                    state["active"][retired] = False

            def seed_conf_trace(pairs):
                """Start each new request's per-token confidence record
                from its prefill seed (tracing only)."""
                ng, cs = _to_host(state["n_gen"], state["conf_sum"])
                for slot, req in pairs:
                    conf_prev[slot] = float(cs[slot, 0])
                    ngen_prev[slot] = int(ng[slot, 0])
                    req.conf_trace = [round(conf_prev[slot], 6)]

            def record_conf_trace(decoding):
                """Extend the per-token confidence records from per-sync
                deltas of conf_sum (tracing only)."""
                ng, cs = _to_host(state["n_gen"], state["conf_sum"])
                for slot in decoding:
                    req = sched.running[slot]
                    dn = int(ng[slot, 0]) - int(ngen_prev[slot])
                    if req.conf_trace is not None and dn > 0:
                        req.conf_trace.append(round(
                            (float(cs[slot, 0]) - conf_prev[slot]) / dn, 6))
                    conf_prev[slot] = float(cs[slot, 0])
                    ngen_prev[slot] = int(ng[slot, 0])

            def admit_slot_groups(admitted):
                """Slot backend: batched prefill per distinct prompt
                length, each group's rows scattered into its slots and
                seeded from one signal launch (a seeding dispatch)."""
                nonlocal n_seed_dispatches
                by_len: Dict[int, List[Tuple[int, Request]]] = {}
                for s, r in admitted:
                    by_len.setdefault(r.prompt_len, []).append((s, r))
                for P, group in sorted(by_len.items()):
                    slots = [s for s, _ in group]
                    prompts = torch.from_numpy(np.stack(
                        [r.prompt for _, r in group]).astype(np.int64)).to(dev)
                    fresh = tfm.init_cache(cfg, len(group), pool.max_len,
                                           device=dev)
                    logits, fresh = tfm.prefill(small.params, cfg, prompts,
                                                fresh, last_only=True,
                                                paged_kernel=use_kernel)
                    scatter_rows(pool.cache, fresh,
                                 torch.tensor(slots, device=dev))
                    self._seed_slots(
                        state, slots, *_signal(logits[:, -1, :], use_kernel),
                        torch.tensor([r.max_new for _, r in group],
                                     dtype=torch.int32),
                        torch.full((len(group),), P, dtype=torch.int32),
                        max_new)
                    n_seed_dispatches += 1
                now = tel.now
                for _, r in admitted:
                    r.t_prefill_done = now
                if tr is not None:
                    seed_conf_trace(admitted)

            def run_prefill_chunk():
                """Paged backend: one prefill dispatch for the oldest
                mid-prefill request's next chunk — plus, with
                `batch_prefill`, the same-offset chunks of every other
                mid-prefill request. Under oversubscription the chunk's
                CoW clones can hit BlockPressure before the dispatch; after
                a policy eviction (which may remove mid-prefill entries)
                the chunk restarts against the survivors."""
                while prefilling:
                    try:
                        return _prefill_chunk_once()
                    except BlockPressure:
                        if policy is None or not relieve_pressure():
                            raise

            def _prefill_chunk_once():
                """One prefill dispatch. Every row's chunk span is made
                write-private first (CoW) and the rows' writable blocks
                are checked pairwise disjoint. A resumed request's chunks
                stop at `prefill_end` (its decode-written tail comes back
                from the preemption snapshot) and seed no signal."""
                nonlocal n_prefill_chunks, n_prefill_dispatches, \
                    n_prefill_tokens, n_seed_dispatches
                head_req, _, off0 = prefilling[0]
                C = pc.prefill_chunk or (prefill_end(head_req) - off0)
                if pc.batch_prefill:
                    group = [e for e in prefilling if e[2] == off0
                             and (pc.prefill_chunk
                                  or prefill_end(e[0]) - e[2]) == C]
                else:
                    group = [prefilling[0]]
                k = len(group)
                for _, slot, off in group:
                    pool.ensure_writable(slot, off, off + C)
                pool.check_write_disjoint(
                    (slot, off, off + C) for _, slot, off in group)
                # bucket the width to a power of two: pad rows write to
                # the trash block and their logits are ignored
                Bc = next_pow2(k)
                chunks = np.zeros((Bc, C), np.int64)
                tbl = np.zeros((Bc, pool.max_blocks), np.int32)
                last_idx = np.zeros((Bc,), np.int64)
                for i, (req, slot, off) in enumerate(group):
                    piece = req.prompt[off:off + C]
                    chunks[i, :piece.shape[0]] = piece
                    tbl[i] = pool.tables[slot]
                    last_idx[i] = min(prefill_end(req) - 1 - off, C - 1)
                    n_prefill_tokens += int(piece.shape[0])
                logits, _ = tfm.prefill(
                    small.params, cfg, torch.from_numpy(chunks).to(dev),
                    pool.cache, cache_offset=off0,
                    pages=torch.from_numpy(tbl).to(dev),
                    last_index=torch.from_numpy(last_idx).to(dev),
                    paged_kernel=use_kernel)
                if dev_timer.enabled:
                    t_dev = tel.now
                    dev_timer.block(dev)
                    tel.phase_add("prefill", 0.0, tel.now - t_dev)
                n_prefill_dispatches += 1
                n_prefill_chunks += k
                # one signal over the fresh rows whose prompt this chunk
                # finishes (a resumed row carries its in-flight token)
                final = [i for i, (req, _, off) in enumerate(group)
                         if off + C >= prefill_end(req)
                         and req.resume is None]
                if final:
                    n_seed_dispatches += 1
                    tok0, nent0 = _signal(
                        logits[torch.tensor(final, device=dev), 0, :],
                        use_kernel)
                seeded: List[Tuple[int, Request]] = []
                for i, entry in enumerate(group):
                    req, slot, off = entry
                    if off + C >= prefill_end(req):          # final chunk
                        prefilling.remove(entry)
                        if req.resume is not None:
                            # prompt blocks re-established: restore the
                            # decode tail and the device rows
                            apply_resume(slot, req)
                            if pc.prefix_sharing:
                                pool.register_prefix(slot, req.prompt)
                            continue
                        j = final.index(i)
                        self._seed_slots(
                            state, [slot], tok0[j:j + 1], nent0[j:j + 1],
                            torch.tensor([req.max_new], dtype=torch.int32),
                            torch.tensor([req.prompt_len], dtype=torch.int32),
                            max_new)
                        if pc.prefix_sharing:
                            pool.register_prefix(slot, req.prompt)
                        req.t_prefill_done = tel.now
                        tel.event("prefill_done", rid=req.rid, slot=slot,
                                  chunks=math.ceil(
                                      max(req.prompt_len
                                          - req.shared_prefix_tokens, 1)
                                      / C),
                                  shared=req.shared_prefix_tokens)
                        seeded.append((slot, req))
                    else:
                        entry[2] = off + C
                if seeded:
                    if tr is not None:
                        seed_conf_trace(seeded)
                    sync_retire()        # max_new == 1: already finished

            def decoding_slots() -> List[int]:
                mid_prefill = {s for _, s, _ in prefilling}
                return [s for s in sched.active_slots if s not in mid_prefill]

            # -- pressure machinery (oversubscribed paged pool only) ----
            def prefill_end(req: Request) -> int:
                """Last token (exclusive) to PREFILL for this admission:
                the whole prompt for a fresh request; for a resumed one
                only up to its first decode-written block, whose content
                and everything after it come back verbatim from the
                snapshot (decode-written K/V is not bit-identical under a
                prefill recompute)."""
                return (req.prompt_len if req.resume is None
                        else req.resume["mb0"] * pc.block_size)

            def apply_resume(slot: int, req: Request) -> None:
                """Re-establish a preempted request in its new slot: copy
                the snapshot's decode-written blocks over the freshly
                mapped tail, then restore its device rows. From here it
                decodes as if it had never been evicted."""
                rs = req.resume
                pool.restore_block_span(slot, rs["mb0"] * pc.block_size,
                                        rs["ctx_len"], rs["blocks"])
                self._resume_slot(state, slot, rs, req.max_new)
                conf_prev[slot] = rs["conf_sum"]
                ngen_prev[slot] = rs["n_gen"]
                req.resume = None
                tel.event("resume", rid=req.rid, slot=slot,
                          n_gen=rs["n_gen"],
                          restored_blocks=len(rs["blocks"]))

            def preempt_slot(slot: int) -> None:
                """Evict the request in `slot` under block pressure with
                bit-exact resume state: snapshot its device rows (one host
                copy) and the blocks holding decode-written K/V, publish
                its prompt blocks in the prefix registry, release the
                slot, and requeue the request at its ORIGINAL arrival
                position (age priority)."""
                req = sched.running[slot]
                entry = next((e for e in prefilling if e[1] == slot), None)
                if entry is not None:
                    # mid-prefill victim: no decode state yet — keep the
                    # chunks already written via the registry and requeue
                    # as a plain re-admission
                    prefilling.remove(entry)
                    pool.register_prefix(slot, req.prompt[:entry[2]])
                    req.resume = None
                else:
                    lt, ps, g, cs, toks = self._slot_to_host(state, slot)
                    ctx_len = req.prompt_len + g - 1
                    assert ps == ctx_len, (slot, ps, ctx_len)
                    mb0 = req.prompt_len // pc.block_size
                    req.resume = {
                        "last_tok": lt, "pos": ps, "n_gen": g,
                        "conf_sum": cs, "tokens": toks,
                        "ctx_len": ctx_len, "mb0": mb0,
                        "blocks": pool.save_block_span(
                            slot, mb0 * pc.block_size, ctx_len),
                    }
                    pool.register_prefix(slot, req.prompt)
                    state["active"][slot] = False
                sched.preempt(slot, tel.now)
                queue.requeue(req)
                tel.event("preempt", rid=req.rid, slot=slot,
                          n_preempted=req.n_preempted,
                          mid_prefill=entry is not None)

            def defer_oom(slot: int) -> None:
                """Defer the victim straight to M_L — the cascade's escape
                hatch under memory pressure: its blocks free at once and
                the request still completes, on M_L."""
                req = sched.running[slot]
                entry = next((e for e in prefilling if e[1] == slot), None)
                if entry is not None:
                    prefilling.remove(entry)
                    req.n_small_steps = 0
                    req.small_tokens = np.zeros(0, np.int32)
                else:
                    _, _, n, cs, toks = self._slot_to_host(state, slot)
                    req.n_small_steps = n
                    req.small_tokens = toks[:n].copy()
                    req.confidence = cs / max(n, 1)
                    state["active"][slot] = False
                req.deferred_reason = "oom"
                sched.retire(slot, tel.now, deferred=True, early=True)
                tel.event("defer_oom", rid=req.rid, slot=slot,
                          n_gen=req.n_small_steps)
                tel.m_requests.labels(outcome="defer_oom").inc()
                submit_large(req, 0)

            def finalize_shed(req: Request, terminal: str,
                              reason: str) -> None:
                """Terminal bookkeeping for a shed request: empty token
                vector, REJECTED/EXPIRED state, audit event and outcome
                counter — exactly once per request."""
                req.state = terminal
                req.tokens = np.zeros(0, np.int32)
                req.t_done = tel.now
                tel.event("shed", rid=req.rid, reason=reason,
                          outcome=terminal)
                tel.m_requests.labels(outcome=terminal).inc()

            def shed_slot(slot: int) -> None:
                """Drop an in-flight victim (shed pressure policy)."""
                req = sched.running[slot]
                entry = next((e for e in prefilling if e[1] == slot), None)
                if entry is not None:
                    prefilling.remove(entry)
                else:
                    state["active"][slot] = False
                sched.drop(slot, tel.now)
                finalize_shed(req, REJECTED, "shed_pressure")

            def relieve_pressure(exclude=()) -> bool:
                """Free physical blocks by evicting one deterministic
                victim (the youngest admission) per the pressure policy.
                False when there is no victim: the caller raises."""
                nonlocal n_relief
                sel = policy.select(sched.running, exclude)
                if sel is None:
                    return False
                slot, action = sel
                if action == PREEMPT:
                    preempt_slot(slot)
                elif action == DEFER:
                    defer_oom(slot)
                else:
                    assert action == SHED, action
                    shed_slot(slot)
                n_relief += 1
                return True

            def with_relief(fn, needy=()):
                """Run `fn`, relieving `BlockPressure` by policy eviction
                and retrying (the pool's mapping calls are idempotent).
                `needy` slots are exempt from victim selection: evicting
                the slot being mapped would livelock its own retry."""
                while True:
                    try:
                        return fn()
                    except BlockPressure:
                        if policy is None or not relieve_pressure(needy):
                            raise

            try:
                while len(queue) or sched.n_active:
                    t_it = tel.now
                    if profiler.enabled:
                        profiler.tick()
                    if overload_on:
                        # admission overload control BEFORE admitting:
                        # release arrivals, shed deadline-expired entries,
                        # then bound the queue (newest-first overflow).
                        # Admitted requests are never expired.
                        queue.release(t_it)
                        for r in queue.expire(t_it):
                            finalize_shed(r, EXPIRED, "deadline")
                        for r in queue.shed_overflow():
                            finalize_shed(r, REJECTED, "queue_full")
                    if paged:
                        # admit one at a time: each admission reserves its
                        # blocks, so the next FIFO head's capacity check
                        # sees the updated reservation
                        admitted = []
                        relief0 = n_relief
                        while True:
                            got = sched.admit_ready(
                                queue, tel.now, limit=1,
                                can_admit=lambda r: pool.can_reserve(
                                    r.prompt_len + r.max_new - 1))
                            if not got:
                                break
                            slot, req = got[0]
                            pool.reserve(slot,
                                         req.prompt_len + req.max_new - 1)
                            rs = req.resume
                            end = prefill_end(req)
                            start = 0
                            if pc.prefix_sharing or rs is not None:
                                # map resident (or cached, or swapped)
                                # prefix blocks by refcount; prefill
                                # resumes at the first unshared token. A
                                # fully shared prompt still recomputes its
                                # final token for the seed logits. A
                                # resumed request walks the chain its
                                # eviction registered.
                                shared = pool.share_prefix(slot, req.prompt)
                                if rs is None:
                                    start = min(shared, req.prompt_len - 1)
                                    req.shared_prefix_tokens = start
                                    n_shared_tokens += start
                                else:
                                    start = min(shared, end)
                            n_map = req.prompt_len if rs is None \
                                else rs["ctx_len"]
                            with_relief(lambda s=slot, n=n_map:
                                        pool.ensure_mapped(s, n),
                                        needy=(slot,))
                            if rs is not None and start >= end:
                                # every prompt block came back from the
                                # registry: restore the tail, resume now
                                apply_resume(slot, req)
                            else:
                                prefilling.append([req, slot, start])
                            admitted.append((slot, req))
                            if n_relief != relief0:
                                # pressure fired while admitting: admitting
                                # more now would thrash straight back
                                break
                        if admitted:
                            tel.event("admit",
                                      rids=[r.rid for _, r in admitted],
                                      slots=[s for s, _ in admitted],
                                      shared=[r.shared_prefix_tokens
                                              for _, r in admitted])
                        t_sched = tel.now
                        did_prefill = bool(prefilling)
                        if did_prefill:
                            run_prefill_chunk()
                    else:
                        admitted = sched.admit_ready(queue, tel.now)
                        t_sched = tel.now
                        did_prefill = bool(admitted)
                        if admitted:
                            admit_slot_groups(admitted)
                            tel.event("admit",
                                      rids=[r.rid for _, r in admitted],
                                      slots=[s for s, _ in admitted])
                            sync_retire()   # min_tokens=1 / max_new=1 edges
                    t_prefill = tel.now
                    tel.phase_add("schedule", t_sched - t_it)
                    if did_prefill:
                        tel.phase_add("prefill", t_prefill - t_sched)
                    peak_active = max(peak_active, sched.n_active)
                    decoding = decoding_slots()
                    tables = None
                    while paged and decoding:
                        # map (and make write-private) each decoding row's
                        # span [pos, pos + steps_per_sync). Under
                        # oversubscription this can hit BlockPressure:
                        # relieve (the victim may be a decoding slot) and
                        # redo against the survivors — the mapping calls
                        # are idempotent
                        try:
                            pos_host = state["pos"].cpu().numpy()
                            need = 1
                            covers = {}
                            for slot in decoding:
                                req = sched.running[slot]
                                total = req.prompt_len + req.max_new - 1
                                cover = min(int(pos_host[slot])
                                            + ecfg.steps_per_sync, total)
                                pool.ensure_mapped(slot, cover)
                                pool.ensure_writable(
                                    slot, int(pos_host[slot]), cover)
                                covers[slot] = cover
                                need = max(need, cover)
                            pool.check_write_disjoint(
                                (s, int(pos_host[s]), c)
                                for s, c in covers.items())
                            # active-prefix tightening: walk only the
                            # bucketed block prefix the masks can reach
                            tables = pool.tables_device(
                                pool.active_prefix_blocks(need))
                            break
                        except BlockPressure:
                            if policy is None or not relieve_pressure():
                                raise
                            decoding = decoding_slots()
                    t_dec = tel.now
                    if decoding:
                        for _ in range(ecfg.steps_per_sync):
                            state = self._decode_body(
                                pool.cache, state, tables, max_new,
                                paged_kernel=use_kernel)
                        dec_dev = 0.0
                        if dev_timer.enabled:
                            t_dev = tel.now
                            dev_timer.block(dev)
                            dec_dev = tel.now - t_dev
                        n_steps += ecfg.steps_per_sync
                        tel.event("step", slots=decoding,
                                  n=ecfg.steps_per_sync,
                                  ml_pending=ml.n_pending)
                        if tr is not None:
                            record_conf_trace(decoding)
                        sync_retire()
                        t_dec_end = tel.now
                        tel.phase_add("decode", t_dec_end - t_dec, dec_dev)
                        tel.m_decode_step.observe(
                            (t_dec_end - t_dec) / ecfg.steps_per_sync)
                    elif not sched.n_active and len(queue):
                        nxt = queue.next_arrival
                        if nxt is not None:
                            time.sleep(min(max(nxt - tel.now, 0.0), 1e-3)
                                       + 1e-5)
                        t_dec_end = tel.now
                    else:
                        t_dec_end = t_dec
                    t_poll = tel.now
                    ml_depths.append(ml.n_pending)
                    poll_large()
                    t_end = tel.now
                    tel.phase_add("ml_wait", t_end - t_poll)
                    if tr is not None:
                        if admitted:
                            tr.complete("schedule", "engine", t_it,
                                        t_sched - t_it, 0)
                        if did_prefill:
                            tr.complete("prefill", "engine", t_sched,
                                        t_prefill - t_sched, 0)
                        if decoding:
                            tr.complete("decode", "engine", t_dec,
                                        t_dec_end - t_dec, 0)
                        tr.complete("ml_poll", "engine", t_poll,
                                    t_end - t_poll, 0)
                        tr.complete("iteration", "engine", t_it,
                                    t_end - t_it, 0,
                                    args={"n_active": sched.n_active,
                                          "ml_pending": ml.n_pending})

                # all M_S work is done: drain the ladder edge by edge.
                # Backend e is flushed only once every backend upstream of
                # it is empty (edge e-1's deferrals are edge e's arrivals,
                # so an earlier flush would cut partial batches that a
                # sequential run batches together). Each poll waits for
                # the next result of the first backend with work (a
                # worker's queue, a server's long poll) rather than waking
                # on a timer that takes the GIL from an M_L worker. Remote
                # backends advertise drain_stall_timeout: when a replica
                # dies mid-drain and nothing can make progress, abort with
                # the pending counts instead of spinning forever
                t_drain = tel.now
                stall_s = min((s for s in (
                    getattr(b, "drain_stall_timeout", None)
                    for b in backends) if s is not None), default=None)
                last_pending = total_pending()
                t_progress = time.perf_counter()
                while True:
                    for e, be in enumerate(backends):
                        if all(backends[u].n_pending == 0
                               for u in range(e)):
                            be.flush()
                    poll_large(timeout=_DRAIN_POLL_S)
                    pending = total_pending()
                    if not pending:
                        break
                    if pending != last_pending:
                        last_pending = pending
                        t_progress = time.perf_counter()
                    elif (stall_s is not None
                          and time.perf_counter() - t_progress > stall_s):
                        names = [f"{getattr(b, 'name', '?')}:"
                                 f"{b.n_pending}" for b in backends]
                        raise RuntimeError(
                            f"M_L drain stalled: {pending} deferral(s) "
                            f"still pending ({', '.join(names)}) with no "
                            f"progress for {stall_s}s")
                makespan = tel.now
                tel.phase_add("drain", makespan - t_drain)
                if tr is not None:
                    tr.complete("drain", "engine", t_drain,
                                makespan - t_drain, 0)
            finally:
                for be in backends:
                    be.close()
        finally:
            # an open profiler window is stopped even when the run raises
            profiler.close()
            tel.close()

        reqs = sorted(requests, key=lambda r: r.rid)
        if tr is not None:
            emit_request_spans(tr, reqs)
        stats = tel.summary(reqs, makespan, self.cost_small, self.cost_large)
        stats["backend"] = ecfg.backend
        stats["cache_bytes"] = pool.footprint_bytes()
        stats["peak_active"] = peak_active
        stats["ml_backend"] = getattr(ml, "name", str(self.large_backend))
        stats["ml_batches"] = len(ml.batch_log)
        stats["ml_batch_occupancy"] = (
            float(np.mean([b["n_real"] / max(b["pad_to"], 1)
                           for b in ml.batch_log]))
            if ml.batch_log else float("nan"))
        stats["ml_queue_depth_peak"] = int(max(ml_depths, default=0))
        stats["ml_queue_depth_mean"] = (float(np.mean(ml_depths))
                                        if ml_depths else 0.0)
        # ladder accounting: reach[i] is the share of traffic that paid
        # tier i (tier 0 always 1.0); compute_cost generalizes
        # cost_small + r * cost_large, bitwise identical for 2 tiers
        n_req = len(reqs)
        reach = [1.0] + [edge_deferrals[e] / n_req for e in range(n_edges)]
        stats["n_tiers"] = spec.n_tiers
        stats["tier_names"] = [t.name for t in spec.tiers]
        stats["tier_served"] = [sum(1 for r in reqs if r.tier == i)
                                for i in range(spec.n_tiers)]
        stats["edge_deferrals"] = list(edge_deferrals)
        stats["edge_tau"] = [edge_tau(e) for e in range(n_edges)]
        stats["edge_signal"] = [ed.signal.name for ed in spec.edges]
        stats["tier_reach"] = reach
        stats["compute_cost"] = ladder_compute_cost(reach, spec.costs)
        if n_edges > 1:
            stats["ml_backends"] = [getattr(b, "name", "?")
                                    for b in backends]
            stats["ml_batches_per_edge"] = [len(b.batch_log)
                                            for b in backends]
        if recal is not None:
            stats["recalibration"] = recal.summary()
        stats["prefill_seed_dispatches"] = n_seed_dispatches
        if paged:
            stats.update(block_size=pc.block_size,
                         n_blocks=pool.n_blocks,
                         peak_blocks=pool.peak_mapped,
                         prefill_chunks=n_prefill_chunks,
                         prefill_dispatches=n_prefill_dispatches,
                         prefill_tokens=n_prefill_tokens,
                         prefix_sharing=pc.prefix_sharing,
                         shared_tokens=n_shared_tokens,
                         shared_blocks=pool.shared_blocks_total,
                         cow_clones=pool.cow_clones,
                         paged_kernel=use_kernel)
            if pressure is not None:
                stats.update(oversubscribe=pressure.oversubscribe,
                             virtual_blocks=pool.virtual_blocks,
                             pressure_policy=pressure.policy,
                             pressure_reliefs=n_relief,
                             swap_blocks=pressure.swap_blocks,
                             swap_outs=pool.swap_outs,
                             swap_ins=pool.swap_ins,
                             swapped_blocks=pool.n_swapped_blocks)
        if own_obs:
            obs_rt.finish()
        tokens = np.zeros((len(reqs), max_new), np.int32)
        for i, r in enumerate(reqs):
            tokens[i, :len(r.tokens)] = r.tokens
        return ContinuousServeResult(
            requests=reqs,
            tokens=tokens,
            confidence=np.array([r.confidence for r in reqs]),
            deferred=np.array([r.deferred for r in reqs]),
            early_exited=np.array([r.early_exited for r in reqs]),
            deferral_ratio=float(np.mean([r.deferred for r in reqs])),
            saved_steps=sum(r.saved_steps for r in reqs),
            steps=n_steps,
            stats=stats,
        )
