"""Deferral signals, calibration and the cascade spec (JAX-free copies)."""
