"""Deferral signals, calibration, the cascade and its evaluation metrics,
baselines, the Gatekeeper loss, the cascade spec, online tau
recalibration and JAX's sampling draw (JAX-free copies)."""
from repro_torch.core.recalibration import (EdgeRecalibrator,  # noqa: F401
                                            RecalibConfig, TauController)
