"""Deferral signals, calibration, the cascade and its evaluation metrics,
baselines, the Gatekeeper loss and the cascade spec (JAX-free copies)."""
