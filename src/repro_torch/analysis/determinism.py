"""determinism: ban ambient nondeterminism where ordering is a contract.

Counterpart of `repro.analysis.determinism`, scoped to the port's
mirrors of the same modules, plus the port's own sampling draw
(``core/prng.py``), and aware of torch's global generator.

Dispatch order, victim selection, wire encoding and parameter init must
be pure functions of request state and the seed: crc32 instead of the
process-salted ``hash()``, the youngest victim by (admit_seq, rid), one
seeded ``torch.Generator`` drawing every parameter in a fixed order.
Inside determinism-critical modules (the default scope below, plus any
file carrying the ``repro: deterministic-module`` pragma comment), flag

* DM001 — builtin ``hash()`` (process-salted for str/bytes; use
  ``zlib.crc32`` / ``hashlib``).
* DM002 — ambient RNG: ``random.*``, legacy global ``np.random.*``
  (seedless ``default_rng()`` included), ``os.urandom``, ``uuid.*``,
  ``secrets.*``; and torch's global generator: ``torch.rand`` /
  ``randn`` / ``randint`` / ``randperm`` / ``normal`` / ``bernoulli`` /
  ``multinomial`` and their ``*_like`` forms, and the in-place
  ``.uniform_`` / ``.normal_`` / ``.random_`` / ``.bernoulli_`` /
  ``.exponential_``, each unless it passes ``generator=``; and
  ``torch.manual_seed`` / ``torch.seed`` / ``torch.cuda.manual_seed*``,
  which reseed the process-wide generator under every other caller.
  Seeded ``np.random.default_rng(seed)``, a draw with ``generator=``
  and ``torch.Generator(...).manual_seed(s)`` are fine.
* DM003 — wall-clock reads: ``time.time`` / ``time.time_ns`` /
  ``datetime.*now`` / ``utcnow``. Use the caller-supplied timestamp or
  ``time.perf_counter`` (monotonic, never encoded on the wire).
"""
from __future__ import annotations

import ast
from typing import Iterator, Optional, Tuple

from repro_torch.analysis.core import (Finding, SourceModule, dotted_name,
                                       iter_scopes, qualname_of)

RULE = "determinism"

# path suffixes of modules that decide dispatch order, victim
# selection, wire encoding or parameter init: the determinism-critical
# set (the JAX rule's eight, mirrored, and the sampling draw)
DEFAULT_SCOPE: Tuple[str, ...] = (
    "src/repro_torch/serving/scheduler.py",
    "src/repro_torch/serving/pressure.py",
    "src/repro_torch/serving/paged_pool.py",
    "src/repro_torch/serving/cache_pool.py",
    "src/repro_torch/serving/remote/wire.py",
    "src/repro_torch/core/deferral.py",
    "src/repro_torch/core/cascade_spec.py",
    "src/repro_torch/models/common.py",
    "src/repro_torch/core/prng.py",
)

_WALLCLOCK = {"time.time", "time.time_ns", "time.monotonic_ns",
              "datetime.now", "datetime.datetime.now",
              "datetime.utcnow", "datetime.datetime.utcnow"}

_AMBIENT_RNG_PREFIXES = ("random.", "np.random.", "numpy.random.",
                         "uuid.", "secrets.")
_AMBIENT_RNG_EXACT = {"os.urandom"}

# draws from torch's default generator unless given `generator=`
_TORCH_DRAWS = {f"torch.{f}" for f in (
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial", "rand_like", "randn_like", "randint_like")}
_TORCH_INPLACE_DRAWS = {"uniform_", "normal_", "random_", "bernoulli_",
                        "exponential_"}
# reseed the process-wide generators
_TORCH_RESEEDS = {"torch.manual_seed", "torch.seed",
                  "torch.random.manual_seed", "torch.random.seed",
                  "torch.cuda.manual_seed", "torch.cuda.manual_seed_all"}


def _in_scope(module: SourceModule) -> bool:
    if module.deterministic_pragma:
        return True
    path = module.rel_path
    return any(path.endswith(suffix) for suffix in DEFAULT_SCOPE)


def _has_generator(node: ast.Call) -> bool:
    return any(k.arg == "generator" for k in node.keywords)


def _ambient_draw(name: Optional[str], node: ast.Call) -> Optional[str]:
    """The ambient-RNG callable `node` calls, as it reads, else None."""
    if name is not None:
        if name in _AMBIENT_RNG_EXACT or name in _TORCH_RESEEDS:
            return name
        if name.startswith(_AMBIENT_RNG_PREFIXES):
            # `np.random.default_rng(seed)` with an explicit seed is
            # fine; seedless `default_rng()` draws OS entropy
            seeded = (name.endswith(".default_rng")
                      and bool(node.args or node.keywords))
            return None if seeded else name
        if name in _TORCH_DRAWS and not _has_generator(node):
            return name
    if (isinstance(node.func, ast.Attribute)
            and node.func.attr in _TORCH_INPLACE_DRAWS
            and not _has_generator(node)):
        return name or f".{node.func.attr}"
    return None


class DeterminismRule:
    name = RULE

    def check(self, module: SourceModule) -> Iterator[Optional[Finding]]:
        if not _in_scope(module):
            return
        # context lookup: function spans -> qualname
        spans = []
        for node, stack in iter_scopes(module.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                spans.append((node.lineno,
                              getattr(node, "end_lineno", node.lineno),
                              qualname_of(stack)))

        def context_of(line: int) -> str:
            best = ""
            best_span = None
            for lo, hi, name in spans:
                if lo <= line <= hi and (best_span is None
                                         or hi - lo < best_span):
                    best, best_span = name, hi - lo
            return best

        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            ctx = context_of(node.lineno)
            draw = _ambient_draw(name, node)
            if name == "hash":
                yield module.finding(
                    RULE, "DM001", node, ctx,
                    "builtin hash() is salted per process — use "
                    "zlib.crc32/hashlib for cross-process-stable keys")
            elif draw is not None:
                yield module.finding(
                    RULE, "DM002", node, ctx,
                    f"ambient RNG `{draw}` in determinism-critical module "
                    f"— derive randomness from request state (crc32) or "
                    f"a seeded generator (`generator=`)")
            elif name in _WALLCLOCK:
                yield module.finding(
                    RULE, "DM003", node, ctx,
                    f"wall-clock `{name}` must not influence dispatch "
                    f"order or wire encoding — take the timestamp as an "
                    f"argument or use time.perf_counter")
