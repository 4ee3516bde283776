"""trace-safety: host syncs inside captured regions, and the audit of
every deliberate host sync in the serving and model code.

Counterpart of `repro.analysis.trace_safety`, in torch's idiom. A region
that torch captures or transforms (``torch.compile``, a CUDA graph,
``torch.func``, TorchScript, FX, ``torch.export``) runs its Python body
once, or under a tracer: a host sync there either breaks the graph or
the capture, and a Python branch on a tensor bakes one branch into it,
just as ``jit`` does. The eager serving loop's speed rests on *where*
it syncs: one batched device-to-host copy per sync interval.

Mechanics
---------
1. Build a per-module *traced-region call graph*. Roots are functions
   passed to ``torch.compile``, ``torch.cuda.make_graphed_callables``,
   ``torch.func.{grad, grad_and_value, vmap, functional_call, jacrev,
   jacfwd}``, ``torch.jit.{trace, script}``, ``torch.fx.symbolic_trace``
   or ``torch.export.export``, or decorated with them; and the body of
   every ``with torch.cuda.graph(...):`` block, a captured region.
   Anything they call (bare names resolved lexically, ``self.method``
   within the class) or define inside is traced too. Resolution is
   within-module.
2. Inside traced code, run a small forward taint pass, seeded only
   where parameter provenance is known: functions passed directly to a
   root (and defs nested inside them) take traced positional arguments;
   a graph block sees its enclosing function's. Transitively-called
   helpers get no seeds (TS001 still applies inside them). Seeds
   exclude ``self``/``cls``, parameters with literal defaults, keyword-
   only parameters, and the repo's static-config names (``cfg``,
   ``config``, ``ctx``, ``mesh``). ``.shape`` / ``.dtype`` / ``.ndim``
   / ``.size()`` / ``.dim()`` / ``.numel()`` / ``.device`` projections
   and ``len()`` / ``isinstance()`` style queries are static at capture
   time and launder taint.

Checks
------
* TS001 — an explicit host sync inside a traced region:
  ``torch.cuda.synchronize``, ``<stream or event>.synchronize()``,
  ``.cpu()``, ``.numpy()`` or ``.to("cpu")``.
* TS002 — host coercion of a traced value: ``.item()`` / ``.tolist()``
  / ``float()`` / ``int()`` / ``bool()`` on a tainted expression.
* TS003 — ``np.*`` called on a traced value.
* TS004 — Python ``if`` / ``while`` on a traced value (``x is None``
  identity tests are static and exempt).
* TS005 — host-sync *audit*: every explicit host sync of TS001's list
  and ``.item()`` / ``.tolist()`` anywhere under
  ``src/repro_torch/serving/`` or ``src/repro_torch/models/`` (the
  models run eagerly, so the audit is the only guard they have), and
  every call to a function of the same module whose body host-syncs,
  transitively through bare names and ``self.`` / ``cls.`` methods,
  under the caller's context. New sites fail until baselined with a
  justification, suppressed, or removed. A receiver that is plainly on
  the host (``np.asarray(...).tolist()``) is left out; the builtin
  coercions are left to TS002, since the audit has no taint to tell a
  tensor from a host number. A suppressed sync line also stops the
  propagation to its function's callers.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.core import (Finding, SourceModule, dotted_name,
                                       positional_params, qualname_of,
                                       unparse)

RULE = "trace-safety"

_FUNC_TRANSFORMS = ("grad", "grad_and_value", "vmap", "functional_call",
                    "jacrev", "jacfwd")
# dotted callable -> index/indices of function-valued arguments (a bare
# `grad` is too common a name to trust; the other bare names are
# `from torch.func import ...` forms)
_TRACE_ENTRY_ARGS: Dict[str, Tuple[int, ...]] = {
    "torch.compile": (0,),
    "torch.cuda.make_graphed_callables": (0,),
    "make_graphed_callables": (0,),
    "torch.jit.trace": (0,), "torch.jit.script": (0,),
    "torch.fx.symbolic_trace": (0,), "symbolic_trace": (0,),
    "torch.export.export": (0,),
    "torch.vmap": (0,),
    **{f"torch.func.{f}": (0,) for f in _FUNC_TRANSFORMS},
    **{f: (0,) for f in _FUNC_TRANSFORMS if f != "grad"},
}

_GRAPH_CAPTURES = {"torch.cuda.graph"}

# methods that copy to the host, and so wait for the device
_SYNC_METHODS = {"cpu", "numpy", "synchronize"}
# host coercions: a sync on a device tensor (TS002 under a trace)
_HOST_COERCIONS = {"item", "tolist"}

# attribute projections of a tensor that are static under capture
_STATIC_ATTRS = {"shape", "dtype", "ndim", "size", "dim", "numel",
                 "device"}

# structure/introspection builtins whose results are static under trace
_STATIC_CALLS = {"len", "isinstance", "hasattr", "getattr", "type"}

# repo convention: config dataclasses are passed positionally under
# these names but are static, never traced values
_STATIC_PARAM_NAMES = {"cfg", "config", "ctx", "mesh"}

_FuncNode = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _unwrap_partial(node: ast.AST) -> Optional[ast.AST]:
    """functools.partial(F, ...) -> F (else None)."""
    if isinstance(node, ast.Call):
        name = dotted_name(node.func)
        if name in ("functools.partial", "partial") and node.args:
            return node.args[0]
    return None


class _ModuleIndex:
    """Lexical-scope name resolution for function definitions."""

    def __init__(self, tree: ast.Module):
        self.parent: Dict[ast.AST, Optional[ast.AST]] = {tree: None}
        self.stack_of: Dict[ast.AST, List[ast.AST]] = {}
        # scope node -> {name: FunctionDef} for its immediate child defs
        self.local_defs: Dict[ast.AST, Dict[str, ast.AST]] = {}
        # class node -> {method name: FunctionDef}
        self.methods: Dict[ast.AST, Dict[str, ast.AST]] = {}
        self.functions: List[ast.AST] = []
        self._walk(tree, [])

    def _walk(self, node: ast.AST, stack: List[ast.AST]) -> None:
        scope = stack[-1] if stack else None
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _FuncNode + (ast.ClassDef,)):
                self.parent[child] = scope
                sub = stack + [child]
                self.stack_of[child] = sub
                if not isinstance(child, ast.ClassDef):
                    self.functions.append(child)
                name = getattr(child, "name", None)
                if name is not None:
                    owner = scope
                    if isinstance(scope, ast.ClassDef):
                        self.methods.setdefault(scope, {})[name] = child
                        # class bodies are not lexical scopes: register
                        # the def one level further out too
                        owner = self.parent.get(scope)
                    self.local_defs.setdefault(owner, {})[name] = child
                self._walk(child, sub)
            else:
                self._walk(child, stack)

    def resolve(self, expr: ast.AST,
                stack: Sequence[ast.AST]) -> Optional[ast.AST]:
        """Resolve a callable expression to a FunctionDef/Lambda in this
        module, through functools.partial wrappers. Names that resolve
        to classes (constructor calls) yield None."""
        inner = _unwrap_partial(expr)
        if inner is not None:
            expr = inner
        if isinstance(expr, ast.Lambda):
            return expr
        fn = None
        if isinstance(expr, ast.Name):
            # innermost enclosing function scope outward, then module
            for scope in [s for s in reversed(list(stack))
                          if not isinstance(s, ast.ClassDef)] + [None]:
                fn = self.local_defs.get(scope, {}).get(expr.id)
                if fn is not None:
                    break
        elif (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id in ("self", "cls")):
            for scope in reversed(list(stack)):
                if isinstance(scope, ast.ClassDef):
                    fn = self.methods.get(scope, {}).get(expr.attr)
                    break
        return fn if isinstance(fn, _FuncNode) else None


def _entry_callees(call: ast.Call) -> List[ast.AST]:
    """Function-valued arguments of a trace-inducing call, else []."""
    idxs = _TRACE_ENTRY_ARGS.get(dotted_name(call.func) or "")
    if idxs is None:
        return []
    out: List[ast.AST] = []
    for i in idxs:
        if i < len(call.args):
            arg = call.args[i]
            if isinstance(arg, (ast.List, ast.Tuple)):
                out.extend(arg.elts)    # make_graphed_callables((f, g), ...)
            else:
                out.append(arg)
    return out


def _is_decorated_root(fn: ast.AST) -> bool:
    """`@torch.compile`, `@torch.compile(...)`, `@partial(torch.compile,
    ...)` and the like."""
    for dec in getattr(fn, "decorator_list", []):
        if dotted_name(dec) in _TRACE_ENTRY_ARGS:
            return True
        if isinstance(dec, ast.Call):
            dname = dotted_name(dec.func)
            if dname in _TRACE_ENTRY_ARGS:
                return True
            if (dname in ("functools.partial", "partial") and dec.args
                    and dotted_name(dec.args[0]) in _TRACE_ENTRY_ARGS):
                return True
    return False


def _graph_blocks(tree: ast.AST
                  ) -> Iterator[Tuple[ast.With, List[ast.AST]]]:
    """Every `with torch.cuda.graph(...):` statement, with its stack."""
    for node, stack in with_stacks(tree, (ast.With, ast.AsyncWith)):
        if any(isinstance(item.context_expr, ast.Call)
               and dotted_name(item.context_expr.func) in _GRAPH_CAPTURES
               for item in node.items):
            yield node, stack


def _walk_own(stmts: Sequence[ast.AST]) -> Iterator[ast.AST]:
    """Every node of `stmts`, not descending into nested defs/lambdas
    (which are traced, or not, in their own right)."""
    todo = list(stmts)
    while todo:
        node = todo.pop()
        yield node
        todo.extend(c for c in ast.iter_child_nodes(node)
                    if not isinstance(c, _FuncNode))


def _find_traced(index: _ModuleIndex, tree: ast.Module
                 ) -> Dict[ast.AST, bool]:
    """Every function node that executes under a trace in this module,
    mapped to whether its positional parameters seed taint.

    Taint is seeded only where argument provenance is certain: direct
    roots take traced positional args, and defs nested inside a seeded
    function (or a graph block) are closures over the same traced
    values. Transitive callees frequently take static shape ints, so
    they keep the TS001 sync check but get no seeds."""
    traced: Dict[ast.AST, bool] = {}
    pending: List[ast.AST] = []

    def add(fn: Optional[ast.AST], seeded: bool) -> None:
        if fn is None or not isinstance(fn, _FuncNode):
            return
        cur = traced.get(fn)
        if cur is None or (seeded and not cur):
            traced[fn] = seeded or bool(cur)
            pending.append(fn)      # (re-)walk to upgrade nested defs

    for fn in index.functions:
        if _is_decorated_root(fn):
            add(fn, True)
    for node, stack in with_stacks(tree, ast.Call):
        for callee in _entry_callees(node):
            add(index.resolve(callee, stack), True)
    for block, stack in _graph_blocks(tree):
        for node in _walk_own(block.body):
            if isinstance(node, ast.Call):
                add(index.resolve(node.func, stack), False)
        for stmt in block.body:
            for node in ast.walk(stmt):
                if isinstance(node, _FuncNode):
                    add(node, True)

    # propagate through calls and lexical nesting
    while pending:
        fn = pending.pop()
        seeded = traced[fn]
        stack = index.stack_of.get(fn, [])
        for node in ast.walk(fn):
            if node is not fn and isinstance(node, _FuncNode):
                add(node, seeded)   # closures trace too
            if isinstance(node, ast.Call):
                add(index.resolve(node.func, stack), False)
    return traced


def with_stacks(tree: ast.AST, kinds
                ) -> Iterator[Tuple[ast.AST, List[ast.AST]]]:
    """Every node of type `kinds` with the stack of its enclosing
    definitions, taken from the tree itself (a call that shares its line
    with a lambda belongs to the lambda only when it stands inside it)."""
    def walk(node: ast.AST, stack: List[ast.AST]):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, kinds):
                yield child, stack
            if isinstance(child, _FuncNode + (ast.ClassDef,)):
                yield from walk(child, stack + [child])
            else:
                yield from walk(child, stack)
    yield from walk(tree, [])


# --------------------------------------------------------------------------
# host syncs
# --------------------------------------------------------------------------

def _site_line(call: ast.Call) -> int:
    """The line a call is reported on: where a method's name stands (the
    end of its receiver), so that `a(\\n...).cpu()` is flagged, and
    suppressed, at `.cpu()`."""
    if isinstance(call.func, ast.Attribute):
        return getattr(call.func, "end_lineno", None) or call.lineno
    return call.lineno


class _Site:
    """A placeholder node carrying the reporting line of a call."""

    def __init__(self, line: int):
        self.lineno = line


def _is_cpu(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return (isinstance(node, ast.Call)
            and dotted_name(node.func) == "torch.device"
            and bool(node.args) and _is_cpu(node.args[0]))


def _sync_call(call: ast.Call) -> Optional[str]:
    """TS001's list: how `call` forces a host sync, else None."""
    func = call.func
    if not isinstance(func, ast.Attribute):
        return None
    if func.attr in _SYNC_METHODS:
        name = dotted_name(func)
        return f"`{name}`" if name == "torch.cuda.synchronize" \
            else f"`.{func.attr}()`"
    if func.attr == "to" and (
            any(_is_cpu(a) for a in call.args[:1])
            or any(k.arg == "device" and _is_cpu(k.value)
                   for k in call.keywords)):
        return '`.to("cpu")`'
    return None


def _host_receiver(call: ast.Call) -> bool:
    """`np.asarray(x).tolist()` and the like: the receiver is a NumPy
    call's result, already on the host."""
    recv = call.func.value if isinstance(call.func, ast.Attribute) else None
    return (isinstance(recv, ast.Call)
            and (dotted_name(recv.func) or "").split(".")[0]
            in ("np", "numpy"))


def _audit_sync(call: ast.Call) -> Optional[str]:
    """TS005's list: TS001's syncs and the `.item()` / `.tolist()`
    coercions, unless the receiver is plainly on the host."""
    if _host_receiver(call):
        return None
    what = _sync_call(call)
    if (what is None and isinstance(call.func, ast.Attribute)
            and call.func.attr in _HOST_COERCIONS):
        what = f"`.{call.func.attr}()`"
    return what


# --------------------------------------------------------------------------
# taint within one traced function
# --------------------------------------------------------------------------

def _literal_default(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) or (
        isinstance(node, ast.UnaryOp)
        and isinstance(node.operand, ast.Constant))


def _seed_taint(fn: ast.AST) -> Set[str]:
    """Positional params are traced values; `self`/`cls`, params with
    literal defaults, and the repo's static-config parameter names are
    not."""
    a = fn.args
    with_default = set()
    pos = list(getattr(a, "posonlyargs", [])) + list(a.args)
    for param, default in zip(reversed(pos), reversed(a.defaults)):
        if _literal_default(default):
            with_default.add(param.arg)
    return {n for n in positional_params(fn)
            if n not in ("self", "cls")
            and n not in with_default
            and n not in _STATIC_PARAM_NAMES}


def _names_in(expr: ast.AST) -> Set[str]:
    """Names referenced by `expr`, ignoring static `.shape`-style
    projections, static structure calls (`len`/`isinstance`/...), and
    nested function bodies."""
    out: Set[str] = set()

    def walk(node: ast.AST) -> None:
        if isinstance(node, ast.Attribute) and node.attr in _STATIC_ATTRS:
            return
        if (isinstance(node, ast.Call)
                and dotted_name(node.func) in _STATIC_CALLS):
            return
        if isinstance(node, _FuncNode):
            return
        if isinstance(node, ast.Name):
            out.add(node.id)
        for child in ast.iter_child_nodes(node):
            walk(child)

    walk(expr)
    return out


def _target_names(target: ast.AST) -> Set[str]:
    return {node.id for node in ast.walk(target)
            if isinstance(node, ast.Name)}


def _propagate_taint(body: List[ast.stmt], tainted: Set[str]) -> Set[str]:
    """Forward may-taint over simple assignments, to a fixpoint."""
    for _ in range(10):
        changed = False
        for node in ast.walk(ast.Module(body=body, type_ignores=[])):
            value = targets = None
            if isinstance(node, ast.Assign):
                value, targets = node.value, node.targets
            elif isinstance(node, ast.AugAssign):
                value, targets = node.value, [node.target]
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                value, targets = node.value, [node.target]
            elif isinstance(node, ast.NamedExpr):
                value, targets = node.value, [node.target]
            elif isinstance(node, ast.For):
                value, targets = node.iter, [node.target]
            if value is None:
                continue
            if _names_in(value) & tainted:
                for t in targets:
                    new = _target_names(t) - tainted
                    if new:
                        tainted |= new
                        changed = True
        if not changed:
            break
    return tainted


def _is_identity_test(test: ast.AST) -> bool:
    """`x is None` / `x is not None` (and `and`/`or` of those) are
    static structure checks, not traced branching."""
    if isinstance(test, ast.BoolOp):
        return all(_is_identity_test(v) for v in test.values)
    return (isinstance(test, ast.Compare)
            and all(isinstance(op, (ast.Is, ast.IsNot))
                    for op in test.ops))


def _body(fn: ast.AST) -> List[ast.stmt]:
    return fn.body if isinstance(fn.body, list) else [fn.body]


class TraceSafetyRule:
    name = RULE

    # TS005 scope: the eager serving and model code
    AUDIT_PREFIXES = ("src/repro_torch/serving/", "src/repro_torch/models/")

    def check(self, module: SourceModule) -> Iterator[Optional[Finding]]:
        index = _ModuleIndex(module.tree)
        sync_in_traced: Set[int] = set()
        for fn, seeded in _find_traced(index, module.tree).items():
            context = qualname_of(index.stack_of.get(fn, [fn]))
            body = _body(fn)
            tainted = _propagate_taint(
                body, _seed_taint(fn) if seeded else set())
            yield from self._check_region(module, body, context, tainted,
                                          sync_in_traced)
        for block, stack in _graph_blocks(module.tree):
            host = next((s for s in reversed(stack)
                         if isinstance(s, _FuncNode)), None)
            tainted = (_propagate_taint(_body(host), _seed_taint(host))
                       if host is not None else set())
            yield from self._check_region(module, block.body,
                                          qualname_of(stack), tainted,
                                          sync_in_traced)
        if module.rel_path.startswith(self.AUDIT_PREFIXES):
            yield from self._audit_host_syncs(module, index,
                                              sync_in_traced)

    def _check_region(self, module: SourceModule, body: List[ast.stmt],
                      context: str, tainted: Set[str],
                      sync_in_traced: Set[int]
                      ) -> Iterator[Optional[Finding]]:
        for node in _walk_own(body):
            if isinstance(node, ast.Call):
                name = dotted_name(node.func)
                sync = _sync_call(node)
                if sync is not None:
                    sync_in_traced.add(_site_line(node))
                    yield module.finding(
                        RULE, "TS001", _Site(_site_line(node)), context,
                        f"{sync} inside a captured/traced region forces a "
                        f"host sync (a graph break, or a failed capture)")
                elif (isinstance(node.func, ast.Attribute)
                      and node.func.attr in _HOST_COERCIONS
                      and _names_in(node.func.value) & tainted):
                    yield module.finding(
                        RULE, "TS002", _Site(_site_line(node)), context,
                        f"`.{node.func.attr}()` on traced value "
                        f"`{unparse(node.func.value)}` copies it to the "
                        f"host")
                elif (name in ("float", "int", "bool") and node.args
                      and _names_in(node.args[0]) & tainted):
                    yield module.finding(
                        RULE, "TS002", node, context,
                        f"`{name}()` coercion of traced value "
                        f"`{unparse(node.args[0])}` inside a traced "
                        f"region")
                elif (name is not None
                      and name.split(".")[0] in ("np", "numpy")
                      and any(_names_in(a) & tainted for a in node.args)):
                    yield module.finding(
                        RULE, "TS003", node, context,
                        f"`{name}` on a traced value runs NumPy on a "
                        f"device tensor (host round-trip or trace error)")
            elif isinstance(node, (ast.If, ast.While)):
                if (_names_in(node.test) & tainted
                        and not _is_identity_test(node.test)):
                    kw = "while" if isinstance(node, ast.While) else "if"
                    yield module.finding(
                        RULE, "TS004", node, context,
                        f"Python `{kw}` on traced value "
                        f"`{unparse(node.test)}` — the capture keeps one "
                        f"branch; use `torch.where` (or bind it static)")

    def _syncing(self, module: SourceModule, index: _ModuleIndex
                 ) -> Dict[ast.AST, str]:
        """Functions of this module whose own body host-syncs, directly
        or through another such function, each mapped to how."""
        syncing: Dict[ast.AST, str] = {}
        calls = {fn: [n for n in _walk_own(_body(fn))
                      if isinstance(n, ast.Call)]
                 for fn in index.functions}
        for fn, cs in calls.items():
            for call in cs:
                what = _audit_sync(call)
                if what is not None and not module.suppressed(
                        _site_line(call), RULE, "TS005"):
                    syncing[fn] = what
                    break
        changed = True
        while changed:
            changed = False
            for fn, cs in calls.items():
                if fn in syncing:
                    continue
                for call in cs:
                    callee = index.resolve(call.func, index.stack_of[fn])
                    if callee in syncing and not module.suppressed(
                            _site_line(call), RULE, "TS005"):
                        syncing[fn] = (f"`{unparse(call.func)}`, "
                                       f"{syncing[callee]}")
                        changed = True
                        break
        return syncing

    def _audit_host_syncs(self, module: SourceModule, index: _ModuleIndex,
                          sync_in_traced: Set[int]
                          ) -> Iterator[Optional[Finding]]:
        syncing = self._syncing(module, index)
        reported: Set[Tuple[int, str]] = set()
        for node, stack in with_stacks(module.tree, ast.Call):
            line = _site_line(node)
            if line in sync_in_traced:
                continue                    # already a TS001
            what = _audit_sync(node)
            if what is None:
                callee = index.resolve(node.func, stack)
                if callee not in syncing:
                    continue
                what = (f"`{unparse(node.func)}`, which host-syncs "
                        f"({syncing[callee]})")
            context = qualname_of(stack)
            if (line, context) in reported:
                continue                    # `.cpu().numpy()`: one site
            reported.add((line, context))
            yield module.finding(
                RULE, "TS005", _Site(line), context,
                f"deliberate host sync {what} in the eager serving/model "
                f"path — every site must be baselined with a "
                f"justification or suppressed")
