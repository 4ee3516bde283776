"""kernel-contracts: each ctypes launch held against its ``extern "C"``
CUDA source.

Counterpart of `repro.analysis.pallas_contracts`. The port reaches each
kernel through a ``ctypes`` ``argtypes`` list typed by hand, and that
list must match the ``extern "C"`` entry point of ``kernels/csrc/*.cu``
parameter for parameter. ctypes checks nothing against the library: a
call with more arguments than ``argtypes`` passes the extras through
unconverted, and a wrong kind is undefined behaviour. The CPU tests never
launch a kernel, so a mismatch would first show on the card, as garbage.

Pairing
-------
``<x>.<fn>.argtypes = <expr>`` goes with ``csrc/<name>.cu`` beside the
module when ``<x>`` is bound to ``_build.load("<name>")`` in the same
function. ``<expr>`` is evaluated statically: list literals, ``+``,
``* <int>``, names bound to lists or to ctypes types (module-level or
earlier in the function, tuple assignments too) and
``ctypes.POINTER(...)``. The C side is read from the source with its
comments stripped and function bodies skipped, in both the
``extern "C" int f(...) {`` and the ``extern "C" { ... }`` forms.

Kinds: a pointer is ``c_void_p`` / ``POINTER(...)`` / ``c_char_p``;
``int`` / ``int32_t`` is ``c_int`` / ``c_int32``; ``unsigned`` is
``c_uint``; ``int64_t`` / ``long long`` is ``c_int64`` /
``c_longlong``; ``float`` is ``c_float``; ``double`` is ``c_double``
(and the other fixed-width integers likewise).

Checks
------
* KC001 — ``argtypes`` arity differs from the C function's, or the
  ``argtypes`` expression cannot be evaluated statically (its arity
  then cannot be checked).
* KC002 — a position's kind differs.
* KC003 — ``restype`` differs from the C return type, or is missing
  (ctypes then reads an ``int``) where the C function does not return
  ``int``.
* KC004 — a call ``<loader>().<fn>(...)`` / ``<lib>.<fn>(...)`` passes
  another positional count than ``len(argtypes)``. A call with a
  starred argument is skipped, not guessed.
* KC005 — in ``kernels/paged_attention.py`` and
  ``kernels/flash_attention.py``, a ``torch.empty`` / ``torch.zeros``
  bound to a name starting with ``ws`` (the split-KV online-softmax
  state, merged across splits) without ``dtype=torch.float32``.
* KC006 — an ``extern "C"`` function that no ``argtypes`` covers (in
  the module that loads its source, or, for a source no module loads,
  reported at ``kernels/_build.py``), or an ``argtypes`` for a function
  that no source defines. A new kernel cannot slip past the rule.

No counterpart: PL002 (index-map arity) and PL003
(``input_output_aliases``) check what, in the port, lives inside the C++
launchers (grid and aliasing), out of reach of a Python-side rule.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

from repro_torch.analysis.core import (Finding, SourceModule, dotted_name,
                                       qualname_of, unparse)
from repro_torch.analysis.trace_safety import _ModuleIndex, with_stacks

RULE = "kernel-contracts"

# modules whose workspaces carry split-KV online-softmax state
_FP32_WS_MODULES = ("kernels/paged_attention.py",
                    "kernels/flash_attention.py")
_FP32_NAMES = {"torch.float32", "torch.float"}

# ctypes type -> kind
CTYPES_KINDS = {
    "c_void_p": "ptr", "c_char_p": "ptr", "c_wchar_p": "ptr",
    "c_int": "i32", "c_int32": "i32", "c_uint": "u32", "c_uint32": "u32",
    "c_int64": "i64", "c_longlong": "i64", "c_long": "i64",
    "c_ssize_t": "i64",
    "c_uint64": "u64", "c_ulonglong": "u64", "c_ulong": "u64",
    "c_size_t": "u64",
    "c_int16": "i16", "c_short": "i16", "c_uint16": "u16",
    "c_ushort": "u16", "c_int8": "i8", "c_byte": "i8", "c_char": "i8",
    "c_uint8": "u8", "c_ubyte": "u8",
    "c_float": "f32", "c_double": "f64", "c_bool": "bool",
}
# C base type (keywords joined by one space) -> kind
C_KINDS = {
    "int": "i32", "signed": "i32", "signed int": "i32", "int32_t": "i32",
    "unsigned": "u32", "unsigned int": "u32", "uint32_t": "u32",
    "long": "i64", "long int": "i64", "long long": "i64",
    "long long int": "i64", "signed long long": "i64", "int64_t": "i64",
    "ptrdiff_t": "i64", "ssize_t": "i64",
    "unsigned long": "u64", "unsigned long long": "u64",
    "unsigned long long int": "u64", "uint64_t": "u64", "size_t": "u64",
    "short": "i16", "int16_t": "i16", "unsigned short": "u16",
    "uint16_t": "u16", "char": "i8", "signed char": "i8", "int8_t": "i8",
    "unsigned char": "u8", "uint8_t": "u8",
    "float": "f32", "double": "f64", "bool": "bool", "_Bool": "bool",
    "void": "void",
    # the runtime's opaque handles are pointers
    "cudaStream_t": "ptr", "cudaEvent_t": "ptr",
}
_C_QUALIFIERS = {"const", "volatile", "restrict", "__restrict__",
                 "__restrict", "register", "struct", "enum", "extern",
                 "inline", "__inline__", "__host__", "__forceinline__"}
_C_WORDS = {w for t in C_KINDS for w in t.split()}

Kinds = List[str]


# --------------------------------------------------------------------------
# the C side
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CSignature:
    """One ``extern "C"`` function: its return and parameter kinds, and
    the parameter types as written (whitespace normalised)."""

    name: str
    ret: str
    params: Tuple[str, ...]
    types: Tuple[str, ...]
    line: int

    @property
    def abi(self) -> Tuple[str, Tuple[str, ...], Tuple[str, ...]]:
        """What must agree wherever the function is parsed."""
        return (self.ret, self.params, self.types)


def _mask(text: str) -> str:
    """`text` with comments blanked and the contents of string and char
    literals masked (but the ``"C"`` of ``extern "C"``), every newline
    kept: offsets and line numbers stay those of the source."""
    out = list(text)
    i, n = 0, len(text)

    def blank(lo: int, hi: int, fill: str = " ") -> None:
        for j in range(lo, hi):
            if out[j] != "\n":
                out[j] = fill

    while i < n:
        if text.startswith("//", i):
            j = text.find("\n", i)
            j = n if j < 0 else j
            blank(i, j)
            i = j
        elif text.startswith("/*", i):
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
            blank(i, j)
            i = j
        elif text[i] in "\"'":
            q, j = text[i], i + 1
            while j < n and text[j] != q and text[j] != "\n":
                j += 2 if text[j] == "\\" else 1
            if not (q == '"' and text[i + 1:j] == "C"):
                blank(i + 1, min(j, n), "_")
            i = j + 1
        else:
            i += 1
    # preprocessor lines (with their continuations) carry no declarations
    lines = "".join(out).split("\n")
    cont = False
    for k, line in enumerate(lines):
        if cont or line.lstrip().startswith("#"):
            cont = line.rstrip().endswith("\\")
            lines[k] = " " * len(line)
    return "\n".join(lines)


def _match(text: str, i: int, open_: str, close: str) -> int:
    """Index just past the bracket that closes the one at `i`."""
    depth = 0
    for j in range(i, len(text)):
        if text[j] == open_:
            depth += 1
        elif text[j] == close:
            depth -= 1
            if depth == 0:
                return j + 1
    return len(text)


def _split_params(params: str) -> List[str]:
    out, depth, cur = [], 0, []
    for ch in params:
        if ch in "([<":
            depth += 1
        elif ch in ")]>":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    out.append("".join(cur))
    out = [p.strip() for p in out]
    return [] if out in ([""], ["void"]) else out


def _c_type(decl: str, named: bool = True) -> Tuple[str, str]:
    """(kind, normalised type text) of a parameter or return type
    declaration: a pointer or array is "ptr" whatever it points to."""
    norm = re.sub(r"\s+", " ", re.sub(r"\s*([*&\[\]])\s*", r"\1", decl))
    norm = norm.strip()
    words = [w for w in re.findall(r"[A-Za-z_]\w*", norm)
             if w not in _C_QUALIFIERS]
    pointer = "*" in norm or "[" in norm
    if named and len(words) > 1 and words[-1] not in _C_WORDS:
        name = words.pop()
        norm = re.sub(rf"\b{name}\b(?=[^\w]*$)", "", norm).strip()
    base = " ".join(w for w in words if w in _C_WORDS) or " ".join(words)
    kind = "ptr" if pointer else C_KINDS.get(base, f"?{base}")
    return kind, norm


def _function(chunk: str, offset: int, text: str) -> Optional[CSignature]:
    """A function declaration or definition head, else None."""
    m = re.match(r"^(?P<ret>.*?)\b(?P<name>[A-Za-z_]\w*)\s*"
                 r"\((?P<params>.*)\)\s*$", chunk, re.S)
    if m is None or re.search(r"\bstatic\b", m.group("ret")):
        return None
    ret_kind, _ = _c_type(m.group("ret") or "int", named=False)
    kinds, types = [], []
    for p in _split_params(m.group("params")):
        k, t = _c_type(p)
        kinds.append(k)
        types.append(t)
    line = text.count("\n", 0, offset + m.start("name")) + 1
    return CSignature(m.group("name"), ret_kind, tuple(kinds), tuple(types),
                      line)


def _declarations(text: str, lo: int, hi: int, single: bool
                  ) -> Tuple[List[CSignature], int]:
    """Top-level declarations of text[lo:hi], bodies skipped, and the
    index past the last one read; `single` stops after the first."""
    out: List[CSignature] = []
    i = start = lo
    while i < hi:
        ch = text[i]
        if ch == "(":
            i = _match(text, i, "(", ")")
            continue
        if ch in ";{":
            head = text[start:i]
            sig = _function(head.strip(),
                            start + len(head) - len(head.lstrip()), text)
            if sig is not None:
                out.append(sig)
            i = _match(text, i, "{", "}") if ch == "{" else i + 1
            start = i
            if single:
                break
            continue
        i += 1
    return out, i


_EXTERN_C = re.compile(r'\bextern\s*"C"')


def c_signatures(source: str) -> List[CSignature]:
    """Every ``extern "C"`` function of a CUDA/C++ source, in order."""
    text = _mask(source)
    out: List[CSignature] = []
    pos = 0
    while True:
        m = _EXTERN_C.search(text, pos)
        if m is None:
            return out
        i = m.end()
        while i < len(text) and text[i].isspace():
            i += 1
        if i < len(text) and text[i] == "{":
            end = _match(text, i, "{", "}")
            out += _declarations(text, i + 1, end - 1, single=False)[0]
        else:
            sigs, end = _declarations(text, i, len(text), single=True)
            out += sigs
        pos = max(end, m.end())


_LINE_MARKER = re.compile(r'^#\s*(?:line\s+)?\d+\s+"([^"]*)"')


def own_text(preprocessed: str, source_path: str) -> str:
    """The lines of a preprocessor's output (``nvcc -E``) that come from
    `source_path` itself, by its line markers: macros expanded, headers
    left out."""
    want = os.path.basename(source_path)
    keep, out = False, []
    for line in preprocessed.splitlines():
        m = _LINE_MARKER.match(line)
        if m:
            keep = os.path.basename(m.group(1)) == want
            continue
        if keep:
            out.append(line)
    return "\n".join(out)


# --------------------------------------------------------------------------
# the Python side
# --------------------------------------------------------------------------

Value = Union[str, Kinds, None]


def _eval(node: ast.AST, env: Dict[str, Value]) -> Value:
    """A ctypes kind, a list of kinds, "void" (None), or None when the
    expression cannot be evaluated statically."""
    if isinstance(node, ast.Constant) and node.value is None:
        return "void"
    if isinstance(node, (ast.List, ast.Tuple)):
        items = [_eval(e, env) for e in node.elts]
        if all(isinstance(v, str) and v != "void" for v in items):
            return list(items)
        return None
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        a, b = _eval(node.left, env), _eval(node.right, env)
        return a + b if isinstance(a, list) and isinstance(b, list) else None
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        for seq, k in ((node.left, node.right), (node.right, node.left)):
            if isinstance(k, ast.Constant) and type(k.value) is int:
                v = _eval(seq, env)
                return v * k.value if isinstance(v, list) else None
        return None
    if isinstance(node, ast.Call):
        name = dotted_name(node.func) or ""
        return "ptr" if name.split(".")[-1] == "POINTER" else None
    name = dotted_name(node)
    if name is None:
        return None
    if name in env:
        return env[name]
    last = name.split(".")[-1]
    if name in (last, f"ctypes.{last}"):
        return CTYPES_KINDS.get(last)
    return None


def _bind(stmt: ast.AST, env: Dict[str, Value]) -> None:
    """Record `stmt`'s name bindings in `env` (None: unknown)."""
    if isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
        targets, value = [stmt.target], stmt.value
    elif isinstance(stmt, ast.Assign):
        targets, value = stmt.targets, stmt.value
    else:
        return
    for t in targets:
        if isinstance(t, ast.Name):
            env[t.id] = _eval(value, env)
        elif (isinstance(t, ast.Tuple) and isinstance(value, ast.Tuple)
              and len(t.elts) == len(value.elts)):
            vals = [_eval(v, env) for v in value.elts]
            for tt, v in zip(t.elts, vals):
                if isinstance(tt, ast.Name):
                    env[tt.id] = v


def _load_name(node: ast.AST) -> Optional[str]:
    """"<name>" of a `_build.load("<name>")` call, else None."""
    if (isinstance(node, ast.Call)
            and (dotted_name(node.func) or "").endswith("_build.load")
            and len(node.args) == 1
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)):
        return node.args[0].value
    return None


@dataclasses.dataclass
class Declaration:
    """One ``<x>.<fn>.argtypes`` of a module, with its ``restype``."""

    lib: str
    fn: str
    has_argtypes: bool
    argtypes: Optional[Kinds]      # None: not evaluable (or not set)
    restype: Optional[str]         # None: never assigned
    node: ast.AST                  # the argtypes (else restype) assignment
    context: str


@dataclasses.dataclass
class Launch:
    """One call of a declared function: `n_args` None when starred."""

    lib: str
    fn: str
    n_args: Optional[int]
    node: ast.Call
    context: str


def _own_statements(body: Sequence[ast.stmt]) -> List[ast.stmt]:
    """`body`'s statements in source order, nested blocks included and
    nested defs/classes left out."""
    out: List[ast.stmt] = []
    for stmt in body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        out.append(stmt)
        for field in ("body", "orelse", "finalbody"):
            sub = getattr(stmt, field, None)
            if isinstance(sub, list):
                out += _own_statements(sub)
        for handler in getattr(stmt, "handlers", []):
            out += _own_statements(handler.body)
    return out


class KernelModule:
    """The ctypes side of one module: its loads, declarations and
    launches."""

    def __init__(self, module: SourceModule):
        tree = module.tree
        self.index = _ModuleIndex(tree)
        self.declarations: Dict[Tuple[str, str], Declaration] = {}
        scopes = [(None, tree.body)] + [(fn, fn.body)
                                        for fn in self.index.functions
                                        if isinstance(fn.body, list)]
        # loader functions: `x = _build.load("name")` ... `return x`
        self.loaders: Dict[str, str] = {}
        for fn, body in scopes[1:]:
            libs: Dict[str, str] = {}
            for stmt in _own_statements(body):
                self._bind_lib(stmt, libs)
                if (isinstance(stmt, ast.Return)
                        and isinstance(stmt.value, ast.Name)
                        and stmt.value.id in libs):
                    self.loaders[fn.name] = libs[stmt.value.id]
        module_env: Dict[str, Value] = {}
        for stmt in _own_statements(tree.body):
            _bind(stmt, module_env)
        self._lib_vars: Dict[Optional[ast.AST], Dict[str, str]] = {}
        for fn, body in scopes:
            self._scan(fn, body, dict(module_env))
        self.loads = [(lib, node, qualname_of(stack))
                      for node, stack in with_stacks(tree, ast.Call)
                      for lib in [_load_name(node)] if lib is not None]
        self.launches = self._find_launches(tree)

    def _bind_lib(self, stmt: ast.stmt, libs: Dict[str, str]) -> None:
        if isinstance(stmt, ast.Assign):
            lib = self._lib_of(stmt.value, libs)
            for t in stmt.targets:
                if isinstance(t, ast.Name) and lib is not None:
                    libs[t.id] = lib

    def _lib_of(self, expr: ast.AST, libs: Dict[str, str]) -> Optional[str]:
        """The library `expr` evaluates to: `_build.load("x")`, a call of
        a loader function, or a name bound to either."""
        lib = _load_name(expr)
        if lib is not None:
            return lib
        if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name):
            return self.loaders.get(expr.func.id)
        if isinstance(expr, ast.Name):
            return libs.get(expr.id)
        return None

    def _scan(self, fn, body, env: Dict[str, Value]) -> None:
        context = qualname_of(self.index.stack_of[fn]) if fn else ""
        libs: Dict[str, str] = {}
        for stmt in _own_statements(body):
            if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Attribute)):
                self._declare(stmt, libs, env, context)
            self._bind_lib(stmt, libs)
            _bind(stmt, env)
        self._lib_vars[fn] = libs

    def _declare(self, stmt: ast.Assign, libs: Dict[str, str],
                 env: Dict[str, Value], context: str) -> None:
        target = stmt.targets[0]
        owner = target.value
        if not (target.attr in ("argtypes", "restype")
                and isinstance(owner, ast.Attribute)
                and isinstance(owner.value, ast.Name)
                and owner.value.id in libs):
            return
        key = (libs[owner.value.id], owner.attr)
        decl = self.declarations.setdefault(
            key, Declaration(*key, False, None, None, stmt, context))
        value = _eval(stmt.value, env)
        if target.attr == "argtypes":
            decl.has_argtypes, decl.node, decl.context = True, stmt, context
            decl.argtypes = value if isinstance(value, list) else None
        else:
            decl.restype = value if isinstance(value, str) else "?"

    def _find_launches(self, tree: ast.Module) -> List[Launch]:
        out: List[Launch] = []
        for node, stack in with_stacks(tree, ast.Call):
            if not isinstance(node.func, ast.Attribute):
                continue
            fn = next((s for s in reversed(stack)
                       if s in self._lib_vars), None)
            lib = self._lib_of(node.func.value, self._lib_vars[fn])
            decl = self.declarations.get((lib, node.func.attr))
            if decl is None or not decl.has_argtypes:
                continue
            starred = any(isinstance(a, ast.Starred) for a in node.args)
            out.append(Launch(lib, node.func.attr,
                              None if starred else len(node.args), node,
                              qualname_of(stack)))
        return out


def _kind_list(kinds: Sequence[str]) -> str:
    return ", ".join(kinds)


class KernelContractsRule:
    name = RULE

    def __init__(self):
        self._sources: Dict[Tuple[str, float], Dict[str, CSignature]] = {}

    def _source(self, path: str) -> Optional[Dict[str, CSignature]]:
        """{name: signature} of the source at `path`, None if missing."""
        try:
            key = (path, os.path.getmtime(path))
        except OSError:
            return None
        if key not in self._sources:
            with open(path, encoding="utf-8") as fh:
                self._sources[key] = {s.name: s
                                      for s in c_signatures(fh.read())}
        return self._sources[key]

    def check(self, module: SourceModule) -> Iterator[Optional[Finding]]:
        csrc = os.path.join(os.path.dirname(module.path), "csrc")
        if os.path.basename(module.path) == "_build.py":
            yield from self._check_unloaded(module, csrc)
        if module.rel_path.endswith(_FP32_WS_MODULES):
            yield from self._check_workspaces(module)
        if "argtypes" not in module.text and "_build" not in module.text:
            return
        km = KernelModule(module)
        for lib, call, context in km.loads:
            sigs = self._source(os.path.join(csrc, f"{lib}.cu")) or {}
            covered = {fn for (lb, fn), d in km.declarations.items()
                       if lb == lib and d.has_argtypes}
            for name in sorted(set(sigs) - covered):
                yield module.finding(
                    RULE, "KC006", call, context,
                    f'extern "C" `{name}` of csrc/{lib}.cu has no argtypes '
                    f'in the module that loads it')
        for decl in km.declarations.values():
            if decl.has_argtypes:
                sigs = self._source(os.path.join(csrc, f"{decl.lib}.cu"))
                yield from self._check_declaration(module, decl, sigs)
        for launch in km.launches:
            decl = km.declarations[(launch.lib, launch.fn)]
            if (launch.n_args is not None and decl.argtypes is not None
                    and launch.n_args != len(decl.argtypes)):
                yield module.finding(
                    RULE, "KC004", launch.node, launch.context,
                    f"`{launch.fn}` called with {launch.n_args} positional "
                    f"arguments, argtypes declares {len(decl.argtypes)}")

    def _check_declaration(self, module: SourceModule, decl: Declaration,
                           sigs: Optional[Dict[str, CSignature]]
                           ) -> Iterator[Optional[Finding]]:
        where = f"csrc/{decl.lib}.cu"
        sig = (sigs or {}).get(decl.fn)
        if sig is None:
            yield module.finding(
                RULE, "KC006", decl.node, decl.context,
                f'argtypes for `{decl.fn}`, which {where} does not define '
                f'as extern "C"' + ("" if sigs is not None
                                    else f" ({where} is missing)"))
            return
        if decl.argtypes is None:
            yield module.finding(
                RULE, "KC001", decl.node, decl.context,
                f"argtypes of `{decl.fn}` cannot be evaluated statically, "
                f"so its arity cannot be held against {where}")
        elif len(decl.argtypes) != len(sig.params):
            yield module.finding(
                RULE, "KC001", decl.node, decl.context,
                f"argtypes of `{decl.fn}` has {len(decl.argtypes)} entries, "
                f"{where}:{sig.line} takes {len(sig.params)} parameters")
        else:
            for i, (py, c) in enumerate(zip(decl.argtypes, sig.params)):
                if py != c:
                    yield module.finding(
                        RULE, "KC002", decl.node, decl.context,
                        f"argtypes of `{decl.fn}` position {i}: {py} where "
                        f"{where}:{sig.line} has `{sig.types[i]}` ({c})")
        restype = decl.restype or "i32"
        if restype != sig.ret:
            how = ("is not set (ctypes reads an int)" if decl.restype is None
                   else f"is {restype}")
            yield module.finding(
                RULE, "KC003", decl.node, decl.context,
                f"restype of `{decl.fn}` {how} where {where}:{sig.line} "
                f"returns {sig.ret}")

    def _check_workspaces(self, module: SourceModule
                          ) -> Iterator[Optional[Finding]]:
        for node, stack in with_stacks(module.tree,
                                       (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            names = [n.id for t in targets for n in ast.walk(t)
                     if isinstance(n, ast.Name)]
            if node.value is None or not any(n.startswith("ws")
                                              for n in names):
                continue
            for call in ast.walk(node.value):
                if not (isinstance(call, ast.Call) and dotted_name(call.func)
                        in ("torch.empty", "torch.zeros")):
                    continue
                dtype = next((k.value for k in call.keywords
                              if k.arg == "dtype"), None)
                if dtype is None or dotted_name(dtype) not in _FP32_NAMES:
                    got = "no dtype" if dtype is None else unparse(dtype)
                    yield module.finding(
                        RULE, "KC005", call, qualname_of(stack),
                        f"split-KV workspace `{names[0]}` must be "
                        f"dtype=torch.float32, got {got}: low-precision "
                        f"(m, l, acc) partials break the merge's parity "
                        f"with the dense oracle")

    def _check_unloaded(self, module: SourceModule, csrc: str
                        ) -> Iterator[Optional[Finding]]:
        """Sources beside `_build.py` that no sibling module loads."""
        if not os.path.isdir(csrc):
            return
        here = os.path.dirname(module.path)
        loaded = set()
        for fn in sorted(os.listdir(here)):
            if fn.endswith(".py"):
                with open(os.path.join(here, fn), encoding="utf-8") as fh:
                    loaded |= set(re.findall(
                        r"_build\.load\(\s*[\"']([\w.-]+)[\"']\s*\)",
                        fh.read()))
        anchor = next((n for n in module.tree.body
                       if isinstance(n, ast.Assign)
                       and any(isinstance(t, ast.Name) and t.id == "SOURCES"
                               for t in n.targets)), module.tree)
        for fn in sorted(os.listdir(csrc)):
            stem, ext = os.path.splitext(fn)
            if ext != ".cu" or stem in loaded:
                continue
            for name in sorted(self._source(os.path.join(csrc, fn)) or {}):
                yield module.finding(
                    RULE, "KC006", anchor, "",
                    f'extern "C" `{name}` of csrc/{fn}: no module loads '
                    f'the source, so no argtypes covers it')
