"""JAX-free copy of `repro.core.recalibration`, the same arithmetic in
the same order.

Online tau recalibration: hold a target deferral ratio under drift.

Offline calibration (`calibrate_edges`) picks each edge's tau as a
quantile of a *validation* confidence distribution. Live traffic drifts:
topics shift, prompts get harder, the quantile moves, and a fixed tau
quietly over- or under-defers — the deployment failure the ROADMAP's
"adaptive routing at scale" item names.

`TauController` closes the loop per edge from streaming confidence
telemetry, with two cooperating pieces:

* **EWMA quantile tracker** — stochastic (Robbins–Monro) quantile
  tracking: for each observed confidence c, step
  ``tau += step_scale * (target - 1[c < tau])``. The indicator's
  expectation is the current deferral probability, so tau converges to
  the target quantile of whatever the *current* traffic distribution
  is. The step is scaled by an EWMA of |c - tau| so the controller is
  invariant to the signal's units (neg-entropy nats vs agreement
  fractions).
* **Hysteresis gate** — the tracker only *moves* while the EWMA of the
  realized deferral indicator sits outside a deadband around the
  target, and keeps correcting until it re-enters a tighter re-arm
  band. On stationary traffic the gate stays closed and tau genuinely
  stays put (no random-walk wander); under drift the deadband breach
  opens it. This is the confidence-tuner / drift-detector split: the
  EWMA ratio is the drift detector, the quantile tracker the tuner.

The controller is model-free and signal-agnostic: it sees only the
scalar confidences the engine already computes at each edge's decision
point, so it costs nothing on the device hot path. `observe()` must be
called with the SAME tau the engine used for the decision — call it
right after deciding, before reading `tau` for the next request.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class RecalibConfig:
    """Knobs for one edge's tau controller.

    target_ratio  — deferral ratio to hold (None: use the edge's
                    offline-calibration target, set by the engine).
    step          — quantile-tracker step as a fraction of the tracked
                    confidence spread per observation.
    ewma_alpha    — smoothing of the deferral-indicator EWMA (the drift
                    detector) and the spread EWMA.
    deadband      — |ewma - target| must exceed this to OPEN the gate
                    (start moving tau).
    rearm         — gate CLOSES once |ewma - target| falls back inside
                    this (must be < deadband: that gap is the
                    hysteresis).
    warmup        — observations before the gate may open (the EWMA
                    needs to mean something first).
    tau_min/max   — hard clamps on tau (optional).
    """
    target_ratio: Optional[float] = None
    step: float = 0.08
    ewma_alpha: float = 0.01
    deadband: float = 0.1
    rearm: float = 0.02
    warmup: int = 32
    tau_min: float = -math.inf
    tau_max: float = math.inf

    def __post_init__(self):
        if not (0.0 <= self.rearm < self.deadband):
            raise ValueError(f"need 0 <= rearm < deadband, got "
                             f"rearm={self.rearm} deadband={self.deadband}")
        if self.target_ratio is not None \
                and not (0.0 <= self.target_ratio <= 1.0):
            raise ValueError(f"target_ratio must be in [0, 1], "
                             f"got {self.target_ratio}")


class TauController:
    """One edge's online tau tracker (see module docstring).

    `observe(conf)` ingests the confidence the edge just gated on and
    returns the (possibly nudged) tau to use for the NEXT decision.
    `trace` records (n_observed, tau) at every actual movement — the
    bench logs it so tau drift is a visible artifact, not a mystery."""

    def __init__(self, tau0: float, target_ratio: float,
                 cfg: Optional[RecalibConfig] = None):
        self.cfg = cfg or RecalibConfig()
        if not (0.0 <= target_ratio <= 1.0):
            raise ValueError(f"target_ratio must be in [0, 1], "
                             f"got {target_ratio}")
        self.target = target_ratio
        self.tau = float(tau0)
        self.n_observed = 0
        self.n_updates = 0
        self.correcting = False
        # start the ratio EWMA AT the target: a fresh controller has no
        # evidence of drift, so the gate must not open on boot noise
        self._ewma_ratio = target_ratio
        self._spread: Optional[float] = None
        self.trace: List[Tuple[int, float]] = [(0, self.tau)]

    def observe(self, conf: float) -> float:
        cfg = self.cfg
        d = 1.0 if conf < self.tau else 0.0
        a = cfg.ewma_alpha
        self._ewma_ratio += a * (d - self._ewma_ratio)
        dev = abs(float(conf) - self.tau)
        self._spread = dev if self._spread is None \
            else self._spread + a * (dev - self._spread)
        self.n_observed += 1
        if self.n_observed < cfg.warmup:
            return self.tau
        err = self._ewma_ratio - self.target
        if not self.correcting:
            if abs(err) > cfg.deadband:
                self.correcting = True
        elif abs(err) <= cfg.rearm:
            self.correcting = False
        if self.correcting:
            step = cfg.step * max(self._spread or 0.0, 1e-9)
            # move tau toward the target quantile of the live stream:
            # deferring too rarely (d=0 on average) raises tau, too
            # often lowers it
            new_tau = self.tau + step * (self.target - d)
            new_tau = min(max(new_tau, cfg.tau_min), cfg.tau_max)
            if new_tau != self.tau:
                self.tau = new_tau
                self.n_updates += 1
                self.trace.append((self.n_observed, self.tau))
        return self.tau

    @property
    def ewma_ratio(self) -> float:
        """Current EWMA of the realized deferral indicator (the drift
        detector's view of the live deferral ratio)."""
        return self._ewma_ratio


class EdgeRecalibrator:
    """Per-edge `TauController` bundle for a cascade ladder.

    Built by the engine when recalibration is on: one controller per
    edge, seeded from the edge's offline tau and the run's target
    deferral ratio(s). `tau(e)` is the live threshold for edge e;
    `observe(e, conf)` feeds the decision stream back."""

    def __init__(self, taus: List[float], target_ratio,
                 cfg: Optional[RecalibConfig] = None):
        cfg = cfg or RecalibConfig()
        targets = (list(target_ratio) if hasattr(target_ratio, "__len__")
                   else [float(target_ratio)] * len(taus))
        if len(targets) != len(taus):
            raise ValueError(f"{len(taus)} edges but {len(targets)} "
                             f"target ratios")
        self.controllers = [TauController(t, r, cfg)
                            for t, r in zip(taus, targets)]

    def tau(self, edge: int) -> float:
        return self.controllers[edge].tau

    def observe(self, edge: int, conf: float) -> float:
        return self.controllers[edge].observe(conf)

    def summary(self) -> Dict[str, object]:
        """Bench/stats payload: final taus, movement counts, and the
        (downsampled) per-edge tau traces."""
        out: Dict[str, object] = {
            "tau_final": [c.tau for c in self.controllers],
            "tau_updates": [c.n_updates for c in self.controllers],
            "ewma_ratio": [round(c.ewma_ratio, 4)
                           for c in self.controllers],
        }
        traces = []
        for c in self.controllers:
            tr = c.trace
            if len(tr) > 64:            # keep artifacts bounded
                stride = max(1, len(tr) // 64)
                tr = tr[::stride] + [tr[-1]]
            traces.append([(n, round(t, 6)) for n, t in tr])
        out["tau_trace"] = traces
        return out
