"""Rule engine: findings, suppressions, baseline, and the runner.

Counterpart of `repro.analysis.core`, with the same identity model,
comment syntax and baseline format, so that the two tools agree finding
for finding on the same files.

Identity model
--------------
A finding's *identity* deliberately excludes the line number:

    (rule, code, path, context, snippet)

``context`` is the dotted lexical scope (``Class.method`` or
``func.inner``) and ``snippet`` the stripped source line. A baseline
entry survives unrelated edits above it and "expires" only when the
flagged line itself (or its enclosing scope) changes, which is when a
human should re-justify it.

Suppression
-----------
A trailing ``# repro: ignore[...]`` comment on the flagged physical
line silences it::

    toks = state["tokens"].cpu()   # repro: ignore[trace-safety]
    h = hash(key)                  # repro: ignore[DM001]

The bracket token matches either the rule family name or the specific
finding code; a bare ``# repro: ignore`` silences every rule on the
line.

Baseline
--------
``analysis_baseline_torch.json`` holds grandfathered findings, so the
gate starts green and *ratchets*: new findings fail, removing code
removes its entries (stale entries are reported so they get pruned).
Every entry carries a one-line ``justification``: the baseline is the
registry of the port's deliberate host syncs.

Standard library only: the tool touches no device and imports neither
torch nor the JAX package, so CI and the card's machine both run it.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import json
import os
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

BASELINE_VERSION = 1
DEFAULT_BASELINE = "analysis_baseline_torch.json"

_SUPPRESS_RE = re.compile(r"#\s*repro:\s*ignore(?:\[([^\]]*)\])?")
_GUARDED_RE = re.compile(r"#\s*guarded_by:\s*([A-Za-z_][\w.]*)")
_PRAGMA_DETERMINISTIC_RE = re.compile(r"#\s*repro:\s*deterministic-module")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a concrete source location."""

    rule: str          # rule family, e.g. "kernel-contracts"
    code: str          # specific check id, e.g. "KC001"
    path: str          # repo-relative posix path
    line: int          # 1-based line number (display only)
    context: str       # dotted lexical scope of the flagged node
    message: str
    snippet: str       # stripped source text of the flagged line

    @property
    def key(self) -> Tuple[str, str, str, str, str]:
        """Line-number-free identity used for baseline matching."""
        return (self.rule, self.code, self.path, self.context, self.snippet)

    def to_json(self) -> Dict[str, object]:
        return {"rule": self.rule, "code": self.code, "path": self.path,
                "line": self.line, "context": self.context,
                "message": self.message, "snippet": self.snippet}

    def render(self) -> str:
        ctx = f" [{self.context}]" if self.context else ""
        return (f"{self.path}:{self.line}: {self.code} ({self.rule}) "
                f"{self.message}{ctx}")


def entry_key(e: Dict[str, object]) -> Tuple[str, ...]:
    """A baseline entry's identity, as `Finding.key`."""
    return tuple(str(e.get(k, "")) for k in
                 ("rule", "code", "path", "context", "snippet"))


class Baseline:
    """Grandfathered findings, keyed by line-number-free identity."""

    def __init__(self, entries: Optional[List[Dict[str, object]]] = None,
                 path: Optional[str] = None):
        self.path = path
        self.entries = list(entries or [])
        self._keys: Set[Tuple[str, ...]] = {entry_key(e)
                                            for e in self.entries}

    def matches(self, finding: Finding) -> bool:
        return finding.key in self._keys

    def stale_entries(self, findings: Sequence[Finding]) -> List[Dict]:
        """Entries matching nothing in this run: candidates to prune
        (the ratchet's downward direction)."""
        live = {f.key for f in findings}
        return [e for e in self.entries if entry_key(e) not in live]

    @staticmethod
    def from_findings(findings: Sequence[Finding],
                      justification: str = "TODO: justify") -> "Baseline":
        seen: Set[Tuple[str, ...]] = set()
        entries = []
        for f in sorted(findings, key=lambda f: (f.path, f.line, f.code)):
            if f.key in seen:
                continue
            seen.add(f.key)
            entries.append({"rule": f.rule, "code": f.code, "path": f.path,
                            "context": f.context, "snippet": f.snippet,
                            "justification": justification})
        return Baseline(entries)

    def dump(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump({"version": BASELINE_VERSION,
                       "entries": self.entries}, fh, indent=2)
            fh.write("\n")


def load_baseline(path: Optional[str]) -> Baseline:
    if path is None or not os.path.exists(path):
        return Baseline(path=path)
    with open(path) as fh:
        data = json.load(fh)
    version = data.get("version")
    if version != BASELINE_VERSION:
        raise ValueError(f"{path}: unsupported baseline version {version!r} "
                         f"(expected {BASELINE_VERSION})")
    return Baseline(data.get("entries", []), path=path)


class SourceModule:
    """One parsed source file plus the comment-derived side tables every
    rule needs (suppressions, ``guarded_by`` annotations, pragmas)."""

    def __init__(self, path: str, rel_path: str, text: str):
        self.path = path
        self.rel_path = rel_path.replace(os.sep, "/")
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=path)
        # line -> set of suppression tokens ("*" = suppress everything)
        self.suppressions: Dict[int, Set[str]] = {}
        # line -> lock expression string from a guarded-by annotation
        self.guarded_by: Dict[int, str] = {}
        self.deterministic_pragma = False
        for i, comment in self._comments(text):
            m = _SUPPRESS_RE.search(comment)
            if m:
                raw = m.group(1)
                if raw is None or not raw.strip():
                    self.suppressions[i] = {"*"}
                else:
                    self.suppressions[i] = {t.strip() for t in raw.split(",")
                                            if t.strip()}
            m = _GUARDED_RE.search(comment)
            if m:
                self.guarded_by[i] = m.group(1)
            if _PRAGMA_DETERMINISTIC_RE.search(comment):
                self.deterministic_pragma = True

    @staticmethod
    def _comments(text: str) -> List[Tuple[int, str]]:
        """(line, comment text) for real COMMENT tokens only: a
        ``# guarded_by:`` example inside a docstring is not an
        annotation."""
        out: List[Tuple[int, str]] = []
        try:
            for tok in tokenize.generate_tokens(io.StringIO(text).readline):
                if tok.type == tokenize.COMMENT:
                    out.append((tok.start[0], tok.string))
        except (tokenize.TokenError, IndentationError):
            pass
        return out

    def suppressed(self, line: int, rule: str, code: str) -> bool:
        tokens = self.suppressions.get(line)
        if not tokens:
            return False
        return "*" in tokens or rule in tokens or code in tokens

    def snippet(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    def finding(self, rule: str, code: str, node: ast.AST, context: str,
                message: str) -> Optional[Finding]:
        """Build a Finding for `node` unless its line is suppressed."""
        line = getattr(node, "lineno", 1)
        if self.suppressed(line, rule, code):
            return None
        return Finding(rule=rule, code=code, path=self.rel_path, line=line,
                       context=context, message=message,
                       snippet=self.snippet(line))


@dataclasses.dataclass
class AnalysisReport:
    """Everything one run produced, split against the baseline."""

    findings: List[Finding]            # every unsuppressed finding
    new: List[Finding]                 # not covered by the baseline
    baselined: List[Finding]           # covered by the baseline
    stale_baseline: List[Dict]         # baseline entries matching nothing
    errors: List[str]                  # unparseable files etc.
    n_files: int = 0

    @property
    def exit_code(self) -> int:
        return 1 if (self.new or self.errors) else 0

    def to_json(self) -> Dict[str, object]:
        return {
            "n_files": self.n_files,
            "n_findings": len(self.findings),
            "new": [f.to_json() for f in self.new],
            "baselined": [f.to_json() for f in self.baselined],
            "stale_baseline": self.stale_baseline,
            "errors": self.errors,
        }

    def render(self, verbose: bool = False) -> str:
        def by_place(fs):
            return sorted(fs, key=lambda f: (f.path, f.line, f.code))

        out = [f.render() for f in by_place(self.new)]
        out += [f"error: {e}" for e in self.errors]
        if verbose and self.baselined:
            out.append(f"-- {len(self.baselined)} baselined finding(s):")
            out += [f"   {f.render()}" for f in by_place(self.baselined)]
        if self.stale_baseline:
            n = len(self.stale_baseline)
            out.append(f"-- {n} stale baseline entr{'y' if n == 1 else 'ies'}"
                       f" (matched nothing — prune from the baseline):")
            out += [f"   {e.get('path')}: {e.get('code')} "
                    f"{e.get('snippet', '')!r}" for e in self.stale_baseline]
        status = "clean" if not self.new and not self.errors else "FAIL"
        out.append(f"repro_torch.analysis: {self.n_files} files, "
                   f"{len(self.findings)} finding(s) "
                   f"({len(self.new)} new, {len(self.baselined)} baselined)"
                   f" -> {status}")
        return "\n".join(out)


_SKIP_DIRS = {"__pycache__", ".git", ".ruff_cache", ".pytest_cache",
              "node_modules", ".venv", "venv"}


def collect_files(paths: Sequence[str], root: str = ".") -> List[str]:
    """Expand path arguments (files or directories) into a sorted list
    of .py files, repo-relative to `root`."""
    out: List[str] = []
    for p in paths:
        full = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.isfile(full):
            out.append(full)
            continue
        for dirpath, dirnames, filenames in os.walk(full):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in _SKIP_DIRS
                                 and not d.startswith("."))
            out += [os.path.join(dirpath, fn) for fn in sorted(filenames)
                    if fn.endswith(".py")]
    return sorted(set(out))


def run_analysis(paths: Sequence[str], *, root: str = ".",
                 baseline: Optional[Baseline] = None,
                 rules: Optional[Iterable] = None) -> AnalysisReport:
    """Run `rules` (default: all registered) over every .py file under
    `paths`, split findings against `baseline`."""
    from repro_torch.analysis.registry import get_rules
    rules = list(rules) if rules is not None else get_rules()
    baseline = baseline or Baseline()
    findings: List[Finding] = []
    errors: List[str] = []
    files = collect_files(paths, root=root)
    for full in files:
        rel = os.path.relpath(full, root)
        try:
            with open(full, encoding="utf-8") as fh:
                text = fh.read()
            module = SourceModule(full, rel, text)
        except (SyntaxError, UnicodeDecodeError, OSError) as e:
            errors.append(f"{rel}: {e}")
            continue
        for rule in rules:
            try:
                findings.extend(f for f in rule.check(module)
                                if f is not None)
            except Exception as e:  # a rule crash is an analyzer bug:
                # surface it as a failing finding, never a silent skip
                errors.append(f"{rel}: rule {rule.name!r} crashed: {e!r}")
    new = [f for f in findings if not baseline.matches(f)]
    baselined = [f for f in findings if baseline.matches(f)]
    return AnalysisReport(findings=findings, new=new, baselined=baselined,
                          stale_baseline=baseline.stale_entries(findings),
                          errors=errors, n_files=len(files))


# --------------------------------------------------------------------------
# shared AST helpers used by several rules
# --------------------------------------------------------------------------

def dotted_name(node: ast.AST) -> Optional[str]:
    """'torch.cuda.synchronize' for nested Attribute/Name chains, else
    None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def qualname_of(stack: Sequence[ast.AST]) -> str:
    """Dotted context from a stack of enclosing Class/Function nodes."""
    parts: List[str] = []
    for node in stack:
        if isinstance(node, (ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            parts.append(node.name)
        elif isinstance(node, ast.Lambda):
            parts.append("<lambda>")
    return ".".join(parts)


def iter_scopes(tree: ast.Module):
    """Yield (node, stack) for every function/class definition, where
    `stack` is the chain of enclosing definitions including `node`."""
    def walk(node: ast.AST, stack: List[ast.AST]):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef, ast.Lambda)):
                sub = stack + [child]
                yield child, sub
                yield from walk(child, sub)
            else:
                yield from walk(child, stack)
    yield from walk(tree, [])


def positional_params(fn) -> List[str]:
    """Positional parameter names of a FunctionDef/Lambda (excludes
    keyword-only params: static config is bound keyword-only)."""
    a = fn.args
    names = [p.arg for p in getattr(a, "posonlyargs", [])]
    names += [p.arg for p in a.args]
    return names


def unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:
        return "<unparseable>"
