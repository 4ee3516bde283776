"""lock-discipline: ``# guarded_by:`` annotations, actually checked.

Counterpart of `repro.analysis.lock_discipline`, unchanged: the port's
threaded modules carry the same annotations as the JAX package's.

The threaded serving modules (``large_backend``, ``remote/client``,
``remote/pool``, ``remote/server``, ``obs/metrics``) share mutable
state between an engine thread and worker/handler/scrape threads. The
convention::

    self._inflight: Dict[int, np.ndarray] = {}   # guarded_by: self._lock

declares that every read or write of ``self._inflight`` (in any method
of the class, or a subclass in the same module) must happen lexically
inside ``with self._lock:``. Methods that are *documented* to be
called with the lock already held annotate the ``def`` line instead::

    def _absorb_outq(self) -> None:   # guarded_by: self._lock

``__init__`` is exempt (the object is not shared yet). Lock-held state
does NOT propagate into nested ``def``/``lambda`` bodies — they run
later, on whatever thread calls them (this is exactly how unguarded
metric-scrape callbacks sneak in).

Checks
------
* LD001 — guarded attribute accessed outside a ``with <lock>:`` scope.
* LD002 — malformed annotation: a ``guarded_by`` comment on a line
  with no ``self.<attr>`` assignment (typo -> silently unchecked).
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from repro_torch.analysis.core import Finding, SourceModule, unparse

RULE = "lock-discipline"

_FuncNode = (ast.FunctionDef, ast.AsyncFunctionDef)


def _self_attr_targets(node: ast.AST) -> List[str]:
    """Attribute names of `self.X` assignment targets in `node`."""
    out: List[str] = []
    targets: List[ast.AST] = []
    if isinstance(node, ast.Assign):
        targets = node.targets
    elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
        targets = [node.target]
    for t in targets:
        for sub in ast.walk(t):
            if (isinstance(sub, ast.Attribute)
                    and isinstance(sub.value, ast.Name)
                    and sub.value.id == "self"):
                out.append(sub.attr)
    return out


class _ClassInfo:
    def __init__(self, node: ast.ClassDef):
        self.node = node
        self.guarded: Dict[str, str] = {}     # attr -> lock expr
        self.bases: List[str] = [b.id for b in node.bases
                                 if isinstance(b, ast.Name)]


def _collect_classes(module: SourceModule
                     ) -> Tuple[Dict[str, _ClassInfo], List[int]]:
    """Per-class guarded-attr maps (inheritance merged within the
    module) + lines carrying a guarded_by comment that bound nothing."""
    classes: Dict[str, _ClassInfo] = {}
    bound_lines: Set[int] = set()
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        info = _ClassInfo(node)
        for sub in ast.walk(node):
            line = getattr(sub, "lineno", None)
            if line in module.guarded_by:
                attrs = _self_attr_targets(sub)
                if attrs:
                    bound_lines.add(line)
                    for a in attrs:
                        info.guarded[a] = module.guarded_by[line]
            if isinstance(sub, _FuncNode) and sub.lineno in module.guarded_by:
                bound_lines.add(sub.lineno)   # def-line annotation
        classes[node.name] = info
    # merge annotations down the (same-module) inheritance chain
    for _ in range(len(classes)):
        changed = False
        for info in classes.values():
            for base in info.bases:
                parent = classes.get(base)
                if parent is None:
                    continue
                for attr, lock in parent.guarded.items():
                    if attr not in info.guarded:
                        info.guarded[attr] = lock
                        changed = True
        if not changed:
            break
    orphans = [line for line in module.guarded_by
               if line not in bound_lines]
    return classes, orphans


class LockDisciplineRule:
    name = RULE

    def check(self, module: SourceModule) -> Iterator[Optional[Finding]]:
        if not module.guarded_by:
            return
        classes, orphans = _collect_classes(module)
        for line in sorted(orphans):
            node = ast.parse("x", mode="eval").body  # placeholder w/ lineno
            node.lineno = line
            yield module.finding(
                RULE, "LD002", node, "",
                "guarded_by comment binds no `self.<attr>` assignment or "
                "`def` on this line — annotation is silently unchecked")
        for info in classes.values():
            if not info.guarded:
                continue
            for item in info.node.body:
                if isinstance(item, _FuncNode):
                    yield from self._check_method(module, info, item)

    def _check_method(self, module: SourceModule, info: _ClassInfo,
                      fn: ast.FunctionDef) -> Iterator[Optional[Finding]]:
        if fn.name == "__init__":
            return
        context = f"{info.node.name}.{fn.name}"
        held: Set[str] = set()
        if fn.lineno in module.guarded_by:
            held.add(module.guarded_by[fn.lineno])
        yield from self._visit(module, info, fn.body, held, context,
                               deferred=False)

    def _visit(self, module: SourceModule, info: _ClassInfo,
               body: List[ast.stmt], held: Set[str], context: str,
               deferred: bool) -> Iterator[Optional[Finding]]:
        for stmt in body:
            yield from self._visit_node(module, info, stmt, held, context,
                                        deferred)

    def _visit_node(self, module: SourceModule, info: _ClassInfo,
                    node: ast.AST, held: Set[str], context: str,
                    deferred: bool) -> Iterator[Optional[Finding]]:
        if isinstance(node, ast.With):
            newly = set()
            for item in node.items:
                expr = unparse(item.context_expr)
                if expr in info.guarded.values():
                    newly.add(expr)
            inner = held | newly
            for item in node.items:
                yield from self._visit_node(module, info, item.context_expr,
                                            held, context, deferred)
            for stmt in node.body:
                yield from self._visit_node(module, info, stmt, inner,
                                            context, deferred)
            return
        if isinstance(node, _FuncNode + (ast.Lambda,)):
            # deferred execution: the lock is NOT held when this runs
            inner_held: Set[str] = set()
            if (isinstance(node, _FuncNode)
                    and node.lineno in module.guarded_by):
                inner_held.add(module.guarded_by[node.lineno])
            name = getattr(node, "name", "<lambda>")
            inner_body = (node.body if isinstance(node.body, list)
                          else [node.body])
            for stmt in inner_body:
                yield from self._visit_node(module, info, stmt, inner_held,
                                            f"{context}.{name}",
                                            deferred=True)
            return
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"
                and node.attr in info.guarded):
            lock = info.guarded[node.attr]
            if lock not in held:
                where = ("in deferred callback, "
                         if deferred else "")
                yield module.finding(
                    RULE, "LD001", node, context,
                    f"`self.{node.attr}` is guarded_by `{lock}` but "
                    f"accessed {where}outside a `with {lock}:` scope")
            return  # don't descend into self.<attr> again
        for child in ast.iter_child_nodes(node):
            yield from self._visit_node(module, info, child, held, context,
                                        deferred)
