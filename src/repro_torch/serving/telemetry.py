"""Copy of `repro.serving.telemetry` for the port.

Serving telemetry: throughput, latency percentiles, deferral accounting,
early-exit savings, phase-time attribution, and an optional JSONL audit
log — reimplemented on top of the observability layer
(`repro_torch.serving.obs`): every run owns a bounded `MetricsRegistry`, and
the event stream / span tracer / device-timing splits all hang off one
`Observability` object.

The engine calls `event(...)` at every lifecycle transition (arrival
release, admit, step, retire, defer, large-batch, done) and
`phase_add(...)` around each control-loop section. `summary()` reduces
the per-request records into the numbers the benchmarks report:

  * throughput_tok_s   — final output tokens / makespan
  * small_tok_s        — M_S decode tokens / makespan (scheduler efficiency)
  * latency p50/p90/p95/p99 — end-to-end seconds (arrival -> final tokens)
  * queueing p50/p95   — seconds from arrival to admission
  * deferral_ratio      — fraction of requests regenerated by M_L
  * early_exit_ratio    — fraction evicted in-flight
  * saved_steps         — M_S decode steps skipped by in-flight deferral
  * compute_cost        — cost_small + r * cost_large (paper's budget)
  * n_completed / n_rejected / n_expired / shed_ratio — admission
    overload-control accounting (REJECTED = queue overflow or shed
    policy, EXPIRED = deadline passed while queued); latency
    percentiles cover SERVED requests only, so load shedding cannot
    masquerade as a latency improvement
  * n_preemptions / oom_deferrals — memory-pressure accounting
  * deferral_wait p50/p95 ms — M_S retirement -> final M_L tokens
  * ml_submit_complete p50/p95 ms — M_L backend submit -> completion
  * phase_<name>_s      — host wall seconds per engine phase (schedule /
    prefill / decode / ml_wait / drain); with device timing on, the
    phase_<name>_device_s splits (and ``device_timing: True``) appear
    alongside.

The engine additionally samples the M_L backend queue depth into every
``step`` event (``ml_pending``) and attaches backend facts to the
summary (`ml_backend`, `ml_batches`, `ml_batch_occupancy`,
`ml_queue_depth_peak`/`_mean`).

Retention: by default every event is kept in ``self.events`` (tests and
post-hoc analysis read it). For long runs pass ``max_events=N`` to keep
only a ring of the last N (``0`` keeps none) — the JSONL audit log still
receives every event, streamed and flushed every ``flush_every`` events
so a crashed run leaves a usable trail.
"""
from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.core.calibration import expected_compute_cost
from repro_torch.serving.obs import Observability
from repro_torch.serving.request import Request

# engine control-loop phases (phase_add / summary key order)
PHASES = ("schedule", "prefill", "decode", "ml_wait", "drain")


class ServingTelemetry:
    """Lifecycle event stream + metrics + summary reducer for one run.

    The engine also attaches backend facts to the summary after the run
    (`backend`, `cache_bytes`, `peak_active`; paged runs add
    `block_size`/`n_blocks`/`peak_blocks`/`prefill_chunks`) so benchmark
    rows can report memory footprint next to throughput."""

    def __init__(self, audit_path: Optional[str] = None,
                 obs: Optional[Observability] = None,
                 max_events: Optional[int] = None,
                 flush_every: Optional[int] = None):
        self.obs = obs if obs is not None else Observability()
        self.registry = self.obs.registry
        self.tracer = self.obs.tracer
        cfg = self.obs.cfg
        if max_events is None:
            max_events = cfg.max_events
        self.max_events = max_events
        self.flush_every = max(1, flush_every if flush_every is not None
                               else cfg.audit_flush_every)
        # retention: list (all), ring deque (last N), or drop (0) — the
        # audit log streams every event regardless
        if max_events is None:
            self.events: Any = []
        elif max_events > 0:
            self.events = deque(maxlen=max_events)
        else:
            self.events = deque(maxlen=1)   # keeps type; nothing stored
        self.n_events = 0
        self._since_flush = 0
        self.audit_path = audit_path
        self._t0 = time.perf_counter()
        if audit_path:
            parent = os.path.dirname(audit_path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            self._fh = open(audit_path, "w")
        else:
            self._fh = None

        # hot-path metric handles (bounded label sets; see obs.metrics)
        reg = self.registry
        self._m_events = reg.counter(
            "serving_events_total", "lifecycle events by kind", ("kind",))
        self._m_phase = reg.counter(
            "serving_phase_seconds_total",
            "host wall seconds per engine phase", ("phase",))
        self._m_phase_dev = reg.counter(
            "serving_phase_device_seconds_total",
            "device-execution seconds per engine phase "
            "(--device-timing mode)", ("phase",))
        self.m_decode_step = reg.histogram(
            "serving_decode_step_seconds",
            "per-decode-step dispatch latency (seconds)")
        self.m_tokens = reg.counter(
            "serving_tokens_total", "final tokens delivered by model",
            ("model",))
        self.m_requests = reg.counter(
            "serving_requests_total", "requests retired by outcome",
            ("outcome",))
        # host-side phase accumulators mirrored into the registry
        # (plain dicts: summary() must not depend on scrape state)
        self.phase_s: Dict[str, float] = {}
        self.phase_device_s: Dict[str, float] = {}

    # -- clock -------------------------------------------------------------
    def reset_clock(self) -> None:
        self._t0 = time.perf_counter()

    @property
    def now(self) -> float:
        return time.perf_counter() - self._t0

    # -- event stream --------------------------------------------------------
    def event(self, kind: str, **fields: Any) -> None:
        """Record one lifecycle event (admit / prefill_done / retire /
        large_batch / ...) with a run-relative timestamp; mirrored to the
        JSONL audit log when one is open (flushed every `flush_every`
        events so a killed run still leaves a usable trail)."""
        rec = {"t": round(self.now, 6), "event": kind, **fields}
        if self.max_events != 0:
            self.events.append(rec)
        self.n_events += 1
        self._m_events.labels(kind=kind).inc()
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
            self._since_flush += 1
            if self._since_flush >= self.flush_every:
                self._fh.flush()
                self._since_flush = 0

    def close(self) -> None:
        if self._fh is not None:
            self._fh.flush()
            self._fh.close()
            self._fh = None

    # -- phase attribution ---------------------------------------------------
    def phase_add(self, phase: str, host_s: float,
                  device_s: float = 0.0) -> None:
        """Accumulate one control-loop section's wall time. `host_s` is
        the section's host wall clock; `device_s` is the blocking
        remainder measured by the device timer (0 unless
        --device-timing)."""
        self.phase_s[phase] = self.phase_s.get(phase, 0.0) + host_s
        self._m_phase.labels(phase=phase).inc(host_s)
        if device_s:
            self.phase_device_s[phase] = (
                self.phase_device_s.get(phase, 0.0) + device_s)
            self._m_phase_dev.labels(phase=phase).inc(device_s)

    # -- context manager -----------------------------------------------------
    def __enter__(self) -> "ServingTelemetry":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        """Always release the audit-log handle, even when the engine run
        raises mid-flight; buffered events are flushed by close()."""
        self.close()

    # -- reductions ----------------------------------------------------------
    def summary(self, requests: List[Request], makespan: float,
                cost_small: float = 0.2, cost_large: float = 1.0
                ) -> Dict[str, Any]:
        n = len(requests)
        if n == 0:
            return {"n_requests": 0}
        # count the tokens actually delivered, not the per-request
        # budgets: a request whose final token vector is shorter than
        # its max_new (or that never produced one) must not inflate
        # throughput_tok_s on clamped / heterogeneous-budget runs
        out_tokens = sum(len(r.tokens) if r.tokens is not None
                         else 0 for r in requests)
        small_tokens = sum(int(r.n_small_steps) for r in requests)
        # latency percentiles are over SERVED requests only: shed
        # requests (REJECTED/EXPIRED under overload control) end with an
        # empty token vector and a shed timestamp, and folding their
        # fast-fail "latency" into the percentiles would make load
        # shedding look like a latency win. Queueing is over requests
        # that actually reached a slot (t_admit is nan for shed-in-queue
        # requests and would poison every percentile with nan).
        served = [r for r in requests if not r.shed]
        latency = np.array([r.t_done - r.arrival_time for r in served
                            if np.isfinite(r.t_done)])
        queueing = np.array([r.t_admit - r.arrival_time for r in requests
                             if np.isfinite(r.t_admit)])
        if latency.size == 0:
            latency = np.array([float("nan")])
        if queueing.size == 0:
            queueing = np.array([float("nan")])
        deferred = np.array([r.deferred for r in requests])
        early = np.array([r.early_exited for r in requests])
        saved = sum(r.saved_steps for r in requests)
        ratio = float(deferred.mean())
        makespan = max(makespan, 1e-9)
        n_rejected = sum(1 for r in requests if r.state == "rejected")
        n_expired = sum(1 for r in requests if r.state == "expired")
        wait_ms = np.array([r.deferral_wait_ms for r in requests
                            if r.deferred])
        submit_ms = np.array([(r.t_done - r.t_submit_large) * 1e3
                              for r in requests
                              if r.deferred
                              and np.isfinite(r.t_submit_large)])
        out = {
            "n_requests": n,
            "makespan_s": makespan,
            "throughput_tok_s": out_tokens / makespan,
            "small_tok_s": small_tokens / makespan,
            "latency_p50_s": float(np.percentile(latency, 50)),
            "latency_p90_s": float(np.percentile(latency, 90)),
            "latency_p95_s": float(np.percentile(latency, 95)),
            "latency_p99_s": float(np.percentile(latency, 99)),
            "queueing_p50_s": float(np.percentile(queueing, 50)),
            "queueing_p95_s": float(np.percentile(queueing, 95)),
            "deferral_ratio": ratio,
            "early_exit_ratio": float(early.mean()),
            "saved_steps": int(saved),
            "saved_step_fraction": saved / max(out_tokens, 1),
            "compute_cost": expected_compute_cost(ratio, cost_small,
                                                  cost_large),
            # overload-control accounting (all zero outside shed runs)
            "n_completed": sum(1 for r in requests if r.state == "done"),
            "n_rejected": n_rejected,
            "n_expired": n_expired,
            "shed_ratio": (n_rejected + n_expired) / n,
            "n_preemptions": sum(r.n_preempted for r in requests),
            "oom_deferrals": sum(1 for r in requests
                                 if r.deferred_reason == "oom"),
        }
        if wait_ms.size:
            out["deferral_wait_p50_ms"] = float(np.percentile(wait_ms, 50))
            out["deferral_wait_p95_ms"] = float(np.percentile(wait_ms, 95))
        if submit_ms.size:
            out["ml_submit_complete_p50_ms"] = float(
                np.percentile(submit_ms, 50))
            out["ml_submit_complete_p95_ms"] = float(
                np.percentile(submit_ms, 95))
        # phase-time breakdown (host wall; device splits when the
        # --device-timing mode blocked on each dispatch)
        for p in PHASES:
            if p in self.phase_s:
                out[f"phase_{p}_s"] = round(self.phase_s[p], 6)
        if self.obs.device_timer.enabled:
            out["device_timing"] = True
            for p in PHASES:
                if p in self.phase_device_s:
                    out[f"phase_{p}_device_s"] = round(
                        self.phase_device_s[p], 6)
        return out
