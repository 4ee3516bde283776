"""Static analysis of the port: machine-check the invariants the port
established by hand. Counterpart of `repro.analysis`, in PyTorch's idiom.

  * ``trace-safety``     — host syncs and tensor-valued branches inside
    regions torch captures (``torch.compile``, CUDA graphs,
    ``torch.func``, TorchScript, FX, ``torch.export``), and the audit of
    every explicit host sync in the eager ``serving/`` and ``models/``
    code (each site baselined with a justification, or suppressed).
  * ``lock-discipline``  — ``guarded_by`` attribute annotations, checked
    against actual ``with self._lock:`` scopes in the threaded modules.
  * ``determinism``      — ``time.time`` / ``random`` / builtin
    ``hash()`` / torch's global generator banned from code that decides
    dispatch order, victim selection, wire encoding or parameter init.
  * ``kernel-contracts`` — each ``ctypes`` ``argtypes`` / ``restype``
    held against the ``extern "C"`` signature of its CUDA source, every
    launch's argument count against its ``argtypes``, fp32 split-KV
    workspaces, and no ``extern "C"`` function left undeclared.

Run it the way CI does::

    PYTHONPATH=src python -m repro_torch.analysis --paths src/repro_torch chip_smoke.py

Findings are suppressed per line with a ``repro: ignore[rule-or-code]``
comment or grandfathered in ``analysis_baseline_torch.json``. Standard
library only (``ast``, ``tokenize``, ``re``, ``json``): it touches no
device, and neither torch nor the JAX package is imported.
"""
from repro_torch.analysis.core import (AnalysisReport, Baseline, Finding,
                                       SourceModule, collect_files,
                                       load_baseline, run_analysis)
from repro_torch.analysis.registry import ALL_RULES, get_rules

__all__ = [
    "ALL_RULES",
    "AnalysisReport",
    "Baseline",
    "Finding",
    "SourceModule",
    "collect_files",
    "get_rules",
    "load_baseline",
    "run_analysis",
]
