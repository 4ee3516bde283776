"""Rule registry: the four rule families, instantiable by name."""
from __future__ import annotations

from typing import Iterable, List, Optional

from repro_torch.analysis.determinism import DeterminismRule
from repro_torch.analysis.kernel_contracts import KernelContractsRule
from repro_torch.analysis.lock_discipline import LockDisciplineRule
from repro_torch.analysis.trace_safety import TraceSafetyRule

ALL_RULES = {
    TraceSafetyRule.name: TraceSafetyRule,
    LockDisciplineRule.name: LockDisciplineRule,
    DeterminismRule.name: DeterminismRule,
    KernelContractsRule.name: KernelContractsRule,
}


def get_rules(names: Optional[Iterable[str]] = None) -> List[object]:
    """Instantiate rules by family name (default: all four)."""
    if names is None:
        return [cls() for cls in ALL_RULES.values()]
    out = []
    for name in names:
        cls = ALL_RULES.get(name)
        if cls is None:
            raise KeyError(f"unknown rule {name!r}; "
                           f"known: {', '.join(sorted(ALL_RULES))}")
        out.append(cls())
    return out
