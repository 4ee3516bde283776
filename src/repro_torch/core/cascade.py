"""Cascade orchestration: (M_S, M_L, g) of eq. (6) as a framework object.

Counterpart of `repro.core.cascade`. A `Cascade` wraps two predict
functions (params + apply returning logits) and a deferral signal. It runs
the small model on every input, gates on the confidence, and evaluates the
large model on the deferred subset only (`predict_sparse`, the deployment
path) or on everything (`predict_dense`, for evaluation sweeps that need
M_L's outputs for metrics anyway). This is the paper's offline
evaluation entry point; `core.metrics.summarize_deferral` scores its
outputs.

On the logits of each model, the signals `max_softmax`, `neg_entropy` and
`seq_neg_entropy` and the model's predictions come from ONE
`kernels.ops.deferral_signal` pass (the CUDA `deferral_entropy` kernel on
CUDA logits): its (neg_entropy, max_prob, argmax) triple holds both. The
`margin` signal is plain PyTorch with `torch.argmax` beside it. Results
are numpy arrays, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import calibration
from repro_torch.core import deferral as deferral_lib
from repro_torch.kernels import ops as kernel_ops

PredictFn = Callable[[Any, torch.Tensor], torch.Tensor]  # (params, x) -> logits


@dataclasses.dataclass
class CascadeResult:
    predictions: np.ndarray        # joint predictions after gating
    confidence: np.ndarray         # g(x) per example
    deferred: np.ndarray           # bool per example
    small_predictions: np.ndarray
    large_predictions: Optional[np.ndarray]
    deferral_ratio: float
    compute_cost: float            # in units of M_L cost (paper Fig. 1)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


@dataclasses.dataclass
class Cascade:
    """Two-model cascade with a confidence gate.

    Attributes:
      small_apply / large_apply: (params, inputs) -> logits [..., V].
      signal: name in `core.deferral.SIGNALS` (per the paper: max_softmax
        for classifiers, seq_neg_entropy for token models).
      tau: acceptance threshold (eq. 6); calibrate with `calibrate_tau`.
      cost_small: relative cost of M_S (paper example: 0.2).
    """

    small_apply: PredictFn
    large_apply: PredictFn
    small_params: Any
    large_params: Any
    signal: str = "max_softmax"
    tau: float = 0.5
    cost_small: float = 0.2
    cost_large: float = 1.0

    def _signal_and_argmax(self, logits: torch.Tensor,
                           valid_mask: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(confidence, argmax predictions) of one model's logits."""
        if self.signal == "margin":
            return (deferral_lib.margin_confidence(logits),
                    torch.argmax(logits, dim=-1).to(torch.int32))
        if self.signal not in deferral_lib.SIGNALS:
            raise KeyError(self.signal)
        nent, mprob, amax = kernel_ops.deferral_signal(logits)
        if self.signal == "max_softmax":
            conf = mprob
        elif self.signal == "neg_entropy":
            conf = nent
        else:
            conf = deferral_lib.masked_sequence_mean(nent, valid_mask)
        return conf, amax

    def confidence(self, logits: torch.Tensor,
                   valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self._signal_and_argmax(logits, valid_mask)[0]

    def _predictions(self, logits: torch.Tensor) -> np.ndarray:
        return _host(self._signal_and_argmax(logits)[1])

    # ------------------------------------------------------------------
    def predict_dense(self, inputs: torch.Tensor,
                      valid_mask: Optional[torch.Tensor] = None
                      ) -> CascadeResult:
        """Evaluate both models, gate, select (evaluation mode)."""
        s_logits = self.small_apply(self.small_params, inputs)
        conf, s_pred = self._signal_and_argmax(s_logits, valid_mask)
        del s_logits
        l_pred = self._signal_and_argmax(
            self.large_apply(self.large_params, inputs))[1]
        joint = deferral_lib.selective_predict(s_pred, l_pred, conf, self.tau)
        deferred = _host(deferral_lib.defer_mask(conf, self.tau))
        ratio = float(deferred.mean())
        return CascadeResult(
            predictions=_host(joint),
            confidence=_host(conf),
            deferred=deferred,
            small_predictions=_host(s_pred),
            large_predictions=_host(l_pred),
            deferral_ratio=ratio,
            compute_cost=calibration.expected_compute_cost(
                ratio, self.cost_small, self.cost_large),
        )

    # ------------------------------------------------------------------
    def predict_sparse(self, inputs: torch.Tensor,
                       valid_mask: Optional[torch.Tensor] = None
                       ) -> CascadeResult:
        """Deployment mode: M_L only sees the deferred subset."""
        s_logits = self.small_apply(self.small_params, inputs)
        conf_t, s_pred_t = self._signal_and_argmax(s_logits, valid_mask)
        del s_logits
        conf, s_pred = _host(conf_t), _host(s_pred_t)
        deferred = conf < self.tau
        joint = s_pred.copy()
        large_preds = None
        if deferred.any():
            idx = np.nonzero(deferred)[0]
            sub = inputs[torch.from_numpy(idx).to(inputs.device)]
            lp = self._predictions(self.large_apply(self.large_params, sub))
            joint[idx] = lp
            large_preds = lp
        ratio = float(deferred.mean())
        return CascadeResult(
            predictions=joint,
            confidence=conf,
            deferred=deferred,
            small_predictions=s_pred,
            large_predictions=large_preds,
            deferral_ratio=ratio,
            compute_cost=calibration.expected_compute_cost(
                ratio, self.cost_small, self.cost_large),
        )

    # ------------------------------------------------------------------
    def calibrate_tau(self, val_inputs: torch.Tensor, *,
                      deferral_ratio: Optional[float] = None,
                      target_accuracy: Optional[float] = None,
                      val_labels: Optional[np.ndarray] = None,
                      valid_mask: Optional[torch.Tensor] = None) -> float:
        """Set tau from a validation batch for a target ratio or accuracy.

        The ratio path goes through `calibration.calibrate_edges`, the
        calibration surface the serving engines share."""
        if deferral_ratio is not None:
            return calibration.calibrate_edges(
                self, val_inputs, deferral_ratio=deferral_ratio,
                valid_mask=valid_mask)[0]
        if target_accuracy is None:
            raise ValueError("specify deferral_ratio or target_accuracy")
        if val_labels is None:
            raise ValueError("target_accuracy needs val_labels")
        s_logits = self.small_apply(self.small_params, val_inputs)
        conf_t, s_pred_t = self._signal_and_argmax(s_logits, valid_mask)
        del s_logits
        conf, s_pred = _host(conf_t), _host(s_pred_t)
        l_pred = self._predictions(
            self.large_apply(self.large_params, val_inputs))
        labels = np.asarray(val_labels)
        sc = (s_pred == labels).astype(np.float64)
        lc = (l_pred == labels).astype(np.float64)
        if sc.ndim > 1:   # token models: sequence-level exact match
            sc = sc.all(axis=-1).astype(np.float64)
            lc = lc.all(axis=-1).astype(np.float64)
        tau = calibration.threshold_for_accuracy(conf, sc, lc,
                                                 target_accuracy)
        if tau is None:
            tau = float(conf.max() + 1.0)   # full deferral
        self.tau = tau
        return self.tau
