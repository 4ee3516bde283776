"""repro_torch.analysis against repro.analysis on the CPU: the same core
machinery finding for finding (suppression, baseline ratchet, CLI), the
same lock-discipline and determinism findings on JAX's fixtures placed at
the port's paths, JAX's trace-safety fixtures translated to torch, the
helper-propagated host-sync audit under JAX's baselined contexts, a
seeded bad pair (a .py and a .cu) for each kernel-contracts code, and the
self-check: the port and chip_smoke.py are clean modulo
analysis_baseline_torch.json."""
import json
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.analysis.core import Baseline as JaxBaseline
from repro.analysis.core import run_analysis as jax_run
from repro.analysis import __main__ as jax_cli
from repro.analysis.determinism import DeterminismRule as JaxDeterminism
from repro.analysis.lock_discipline import LockDisciplineRule as JaxLock
from repro.analysis.trace_safety import TraceSafetyRule as JaxTrace
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import kernel_contracts as kc
from repro_torch.analysis.core import (DEFAULT_BASELINE, Baseline,
                                       SourceModule, load_baseline,
                                       run_analysis)
from repro_torch.analysis.determinism import DEFAULT_SCOPE, DeterminismRule
from repro_torch.analysis.kernel_contracts import KernelContractsRule
from repro_torch.analysis.lock_discipline import LockDisciplineRule
from repro_torch.analysis.registry import ALL_RULES
from repro_torch.analysis.trace_safety import TraceSafetyRule

REPO = Path(__file__).resolve().parents[1]


def run_on(tmp_path, src, rel="mod.py", rules=None, baseline=None,
           run=run_analysis):
    """Write `src` at tmp_path/rel and analyze it with `run` (the port's
    runner, or JAX's)."""
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(src))
    return run([str(path)], root=str(tmp_path), baseline=baseline,
               rules=rules)


def codes(report):
    return sorted(f.code for f in report.findings)


def triples(report):
    return sorted((f.code, f.context, f.snippet) for f in report.findings)


def test_rule_catalogue():
    assert list(ALL_RULES) == ["trace-safety", "lock-discipline",
                               "determinism", "kernel-contracts"]
    assert DEFAULT_BASELINE == "analysis_baseline_torch.json"


# ------------------------------------------------ core, finding for finding

HASHED = """
    # repro: deterministic-module


    def pick(key):
        return hash(key){suffix}
"""


@pytest.mark.parametrize("token,silenced", [
    ("determinism", True), ("DM001", True), ("", True),
    ("trace-safety", False)])
def test_suppression_matches_jax(tmp_path, token, silenced):
    comment = (f"  # repro: ignore[{token}]" if token
               else "  # repro: ignore")
    src = HASHED.format(suffix=comment)
    port = run_on(tmp_path / "port", src, rules=[DeterminismRule()])
    ref = run_on(tmp_path / "jax", src, rules=[JaxDeterminism()],
                 run=jax_run)
    assert [f.to_json() for f in port.findings] == [
        f.to_json() for f in ref.findings]
    assert codes(port) == ([] if silenced else ["DM001"])


def test_baseline_round_trip_matches_jax(tmp_path):
    src = HASHED.format(suffix="")
    dumped = {}
    for name, run, rule, base in (
            ("port", run_analysis, DeterminismRule, Baseline),
            ("jax", jax_run, JaxDeterminism, JaxBaseline)):
        rep = run_on(tmp_path, src, rules=[rule()], run=run)
        assert rep.exit_code == 1 and len(rep.new) == 1
        path = tmp_path / f"{name}.json"
        base.from_findings(rep.findings).dump(str(path))
        dumped[name] = path.read_text()
    assert dumped["port"] == dumped["jax"]
    rep = run_on(tmp_path, src, rules=[DeterminismRule()],
                 baseline=load_baseline(str(tmp_path / "jax.json")))
    assert rep.exit_code == 0 and rep.new == [] and len(rep.baselined) == 1
    assert rep.stale_baseline == []


@pytest.mark.parametrize("edit,exit_code,n_stale", [
    ("move", 0, 0), ("edit", 1, 1)])
def test_baseline_survives_line_moves_but_not_edits(tmp_path, edit,
                                                    exit_code, n_stale):
    src = textwrap.dedent(HASHED.format(suffix=""))
    changed = ("import os\n# a new comment shifting lines\n" + src
               if edit == "move" else src.replace("hash(key)",
                                                  "hash(key + 1)"))
    results = []
    for run, rule, base in ((run_analysis, DeterminismRule, Baseline),
                            (jax_run, JaxDeterminism, JaxBaseline)):
        baseline = base.from_findings(
            run_on(tmp_path, src, rules=[rule()], run=run).findings)
        rep = run_on(tmp_path, changed, rules=[rule()], baseline=baseline,
                     run=run)
        results.append((rep.exit_code, len(rep.stale_baseline),
                        [f.to_json() for f in rep.new]))
    assert results[0] == results[1]
    assert results[0][:2] == (exit_code, n_stale)


def test_stale_baseline_entries_reported(tmp_path):
    entry = {"rule": "determinism", "code": "DM001", "path": "gone.py",
             "context": "f", "snippet": "hash(x)",
             "justification": "file was deleted"}
    port = run_on(tmp_path, "x = 1\n", rules=[DeterminismRule()],
                  baseline=Baseline([entry]))
    ref = run_on(tmp_path, "x = 1\n", rules=[JaxDeterminism()],
                 baseline=JaxBaseline([entry]), run=jax_run)
    assert port.exit_code == ref.exit_code == 0
    assert port.stale_baseline == ref.stale_baseline == [entry]
    assert "prune" in port.render()


def test_cli_exit_codes_and_json_match_jax(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent(HASHED.format(suffix="")))
    argv = ["--paths", str(bad), "--root", str(tmp_path), "--baseline", "",
            "--json", "--rules", "determinism"]
    assert cli.main(argv) == 1
    port = json.loads(capsys.readouterr().out)
    assert jax_cli.main(argv) == 1
    ref = json.loads(capsys.readouterr().out)
    assert port == ref
    assert [f["code"] for f in port["new"]] == ["DM001"]

    good = tmp_path / "good.py"
    good.write_text("x = 1\n")
    assert cli.main(["--paths", str(good), "--root", str(tmp_path),
                     "--baseline", ""]) == 0
    capsys.readouterr()


@pytest.mark.parametrize("argv", [
    ["--rules", "no-such-rule"],
    ["--write-baseline", "--baseline", ""],
    ["--no-such-flag"]])
def test_cli_usage_errors_exit_2(tmp_path, capsys, argv):
    with pytest.raises(SystemExit) as exc:
        cli.main(["--paths", str(tmp_path), "--root", str(tmp_path)] + argv)
    assert exc.value.code == 2
    capsys.readouterr()


def test_cli_write_baseline_keeps_justifications(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent(HASHED.format(suffix="")))
    bl = tmp_path / "bl.json"
    argv = ["--paths", str(bad), "--root", str(tmp_path),
            "--baseline", str(bl)]
    assert cli.main(argv + ["--write-baseline"]) == 0
    data = json.loads(bl.read_text())
    assert data["entries"][0]["justification"] == "TODO: justify"
    data["entries"][0]["justification"] = "deliberate: fixture"
    bl.write_text(json.dumps(data))
    assert cli.main(argv + ["--write-baseline"]) == 0
    data2 = json.loads(bl.read_text())
    assert data2["entries"][0]["justification"] == "deliberate: fixture"
    assert cli.main(argv) == 0
    capsys.readouterr()


def test_cli_runs_on_the_standard_library_alone():
    """The tool as CI and the card run it: exit 0 on the port, with
    neither torch, numpy, jax nor the JAX package imported."""
    code = ("import sys\n"
            "from repro_torch.analysis.__main__ import main\n"
            "rc = main(['--paths', 'src/repro_torch', 'chip_smoke.py'])\n"
            "bad = sorted({k.split('.')[0] for k in sys.modules} & "
            "{'torch', 'numpy', 'jax', 'jaxlib', 'repro'})\n"
            "assert not bad, bad\n"
            "sys.exit(rc)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env={"PYTHONPATH": str(REPO / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "-> clean" in proc.stdout


# ------------------------------------------------------------ lock-discipline

LOCKED_CLASS = """
    import threading


    class Box:
        def __init__(self):
            self._lock = threading.Lock()
            self._items = []  # guarded_by: self._lock

        def add(self, x):
            with self._lock:
                self._items.append(x)

        def peek(self):
            return len(self._items)

        def _drain(self):  # guarded_by: self._lock
            out, self._items = self._items, []
            return out
"""
DEFERRED = """
    import threading


    class Box:
        def __init__(self):
            self._lock = threading.Lock()
            self._n = 0  # guarded_by: self._lock

        def register(self, registry):
            with self._lock:
                registry.gauge(fn=lambda: self._n)
"""
INHERITED = """
    import threading


    class Base:
        def __init__(self):
            self._lock = threading.Lock()
            self._n = 0  # guarded_by: self._lock


    class Child(Base):
        def bump(self):
            self._n += 1
"""
ORPHAN = """
    import threading


    class Box:
        def __init__(self):
            self._lock = threading.Lock()
            # guarded_by: self._lock
            self._items = []

        def use(self):
            return self._items
"""
DOCSTRING = '''
    class Doc:
        """Explains the convention: # guarded_by: self._lock ."""

        def use(self):
            return 1
'''


@pytest.mark.parametrize("src,want", [
    (LOCKED_CLASS, [("LD001", "Box.peek")]),
    (DEFERRED, [("LD001", "Box.register.<lambda>")]),
    (INHERITED, [("LD001", "Child.bump")]),
    (ORPHAN, [("LD002", "")]),
    (DOCSTRING, [])], ids=["unguarded", "deferred", "inherited", "orphan",
                           "docstring"])
def test_lock_discipline_matches_jax(tmp_path, src, want):
    port = run_on(tmp_path, src, rules=[LockDisciplineRule()])
    ref = run_on(tmp_path, src, rules=[JaxLock()], run=jax_run)
    assert triples(port) == triples(ref)
    assert [(c, ctx) for c, ctx, _ in triples(port)] == want


def test_lock_discipline_matches_jax_on_the_port():
    """Both tools read the port's 36 guarded_by annotations in its five
    threaded modules alike, and both find nothing."""
    port = run_analysis(["src/repro_torch"], root=str(REPO),
                        rules=[LockDisciplineRule()])
    ref = jax_run(["src/repro_torch"], root=str(REPO), rules=[JaxLock()])
    assert triples(port) == triples(ref) == []
    assert port.errors == ref.errors == []
    annotated = {}
    for path in sorted((REPO / "src" / "repro_torch").rglob("*.py")):
        m = SourceModule(str(path), str(path.relative_to(REPO)),
                         path.read_text())
        if m.guarded_by:
            annotated[path.name] = len(m.guarded_by)
    assert sum(annotated.values()) == 36
    assert set(annotated) == {"metrics.py", "large_backend.py", "pool.py",
                              "client.py", "server.py"}


# ---------------------------------------------------------------- determinism

PRAGMA = """
    # repro: deterministic-module
    import random
    import time


    def pick(items, key):
        h = hash(key)
        r = random.random()
        t = time.time()
        ok = time.perf_counter()
        return h, r, t, ok
"""
SEEDED = """
    # repro: deterministic-module
    import numpy as np


    def make(seed):
        return np.random.default_rng(seed)
"""


@pytest.mark.parametrize("src,want", [
    (PRAGMA, ["DM001", "DM002", "DM003"]), (SEEDED, [])],
    ids=["pragma", "seeded"])
def test_determinism_matches_jax_on_its_fixtures(tmp_path, src, want):
    port = run_on(tmp_path, src, rules=[DeterminismRule()])
    ref = run_on(tmp_path, src, rules=[JaxDeterminism()], run=jax_run)
    assert triples(port) == triples(ref)
    assert codes(port) == want


@pytest.mark.parametrize("rel", DEFAULT_SCOPE + ("src/repro_torch/obscure.py",))
def test_determinism_scoped_at_the_ports_paths(tmp_path, rel):
    """JAX's scope fixture at each port mirror flags as JAX's rule does at
    the JAX path; the sampling draw is in the port's scope only."""
    src = """
        def k(key):
            return hash(key)
    """
    port = run_on(tmp_path / "port", src, rel=rel,
                  rules=[DeterminismRule()])
    ref = run_on(tmp_path / "jax", src,
                 rel=rel.replace("src/repro_torch/", "src/repro/"),
                 rules=[JaxDeterminism()], run=jax_run)
    in_scope = not rel.endswith("obscure.py")
    assert codes(port) == (["DM001"] if in_scope else [])
    if not rel.endswith(("obscure.py", "core/prng.py")):
        assert triples(port) == triples(ref)
    assert (REPO / rel).exists() == in_scope


@pytest.mark.parametrize("call,flagged", [
    ("torch.rand(3)", True), ("torch.randn(3)", True),
    ("torch.randint(0, 5, (3,))", True), ("torch.randperm(4)", True),
    ("torch.normal(0.0, 1.0, (3,))", True), ("torch.bernoulli(p)", True),
    ("torch.multinomial(p, 1)", True), ("torch.rand_like(p)", True),
    ("torch.randn_like(p)", True), ("torch.randint_like(p, 5)", True),
    ("p.uniform_()", True), ("p.normal_()", True), ("p.random_()", True),
    ("p.bernoulli_()", True), ("p.exponential_()", True),
    ("torch.manual_seed(0)", True), ("torch.seed()", True),
    ("torch.cuda.manual_seed(0)", True),
    ("torch.cuda.manual_seed_all(0)", True),
    ("torch.rand(3, generator=g)", False),
    ("torch.randn(3, generator=torch.Generator().manual_seed(1))", False),
    ("p.uniform_(-1.0, 1.0, generator=g)", False),
    ("torch.Generator(device='cpu').manual_seed(0)", False),
    ("g.manual_seed(1)", False)])
def test_determinism_torch_global_generator(tmp_path, call, flagged):
    rep = run_on(tmp_path, f"""
        # repro: deterministic-module
        import torch


        def draw(p, g):
            return {call}
    """, rules=[DeterminismRule()])
    assert codes(rep) == (["DM002"] if flagged else [])
    if flagged:
        assert rep.findings[0].context == "draw"


def test_determinism_port_scope_is_clean():
    rep = run_analysis(["src/repro_torch"], root=str(REPO),
                       rules=[DeterminismRule()])
    assert rep.errors == [] and rep.findings == []


# --------------------------------------------------------------- trace-safety

# (JAX fixture, its torch translation, expected codes): jax.jit ->
# torch.compile, device_get -> .cpu(), a fori_loop body -> a
# torch.cuda.graph block, static_argnames -> a keyword-only parameter
TS_CASES = {
    "ts001_sync_inside_jit": ("""
        import jax

        @jax.jit
        def f(x):
            y = jax.device_get(x)
            return y
    """, """
        import torch

        @torch.compile
        def f(x):
            y = x.cpu()
            return y
    """, ["TS001"]),
    "ts001_reaches_transitive_callee": ("""
        import jax

        def helper(x):
            return jax.device_get(x)

        @jax.jit
        def f(x):
            return helper(x)
    """, """
        import torch

        def helper(x):
            return x.cpu()

        @torch.compile
        def f(x):
            return helper(x)
    """, ["TS001"]),
    "ts002_host_coercions": ("""
        import jax

        @jax.jit
        def f(x):
            a = x.item()
            b = float(x)
            return a + b
    """, """
        import torch

        @torch.compile
        def f(x):
            a = x.item()
            b = float(x)
            return a + b
    """, ["TS002", "TS002"]),
    "ts003_numpy_on_traced": ("""
        import jax
        import numpy as np

        @jax.jit
        def f(x):
            return np.sum(x)
    """, """
        import numpy as np
        import torch

        @torch.compile
        def f(x):
            return np.sum(x)
    """, ["TS003"]),
    "ts004_python_branch_on_traced": ("""
        import jax

        @jax.jit
        def f(x):
            if x > 0:
                return x
            while x < 3:
                x = x + 1
            return -x
    """, """
        import torch

        @torch.compile
        def f(x):
            if x > 0:
                return x
            while x < 3:
                x = x + 1
            return -x
    """, ["TS004", "TS004"]),
    "ts004_static_tests_pass": ("""
        import functools
        import jax

        @functools.partial(jax.jit, static_argnames=("mode",))
        def f(x, mode, flag=False):
            if mode == "fast":
                x = x * 2
            if flag:
                x = x + 1
            if x is None:
                return 0
            if isinstance(x, tuple):
                x = x[0]
            if x.shape[0] > 4:
                x = x[:4]
            if len(x) > 2:
                x = x * 2
            return x
    """, """
        import torch

        @torch.compile
        def f(x, *, mode, flag=False):
            if mode == "fast":
                x = x * 2
            if flag:
                x = x + 1
            if x is None:
                return 0
            if isinstance(x, tuple):
                x = x[0]
            if x.shape[0] > 4:
                x = x[:4]
            if len(x) > 2:
                x = x * 2
            return x
    """, []),
    "ts004_cfg_param_is_static_by_convention": ("""
        import jax

        def forward(params, cfg, x):
            if cfg.residual:
                x = x + params["w"] * x
            return x

        step = jax.jit(forward)
    """, """
        import torch

        def forward(params, cfg, x):
            if cfg.residual:
                x = x + params["w"] * x
            return x

        step = torch.compile(forward)
    """, []),
    "ts004_transitive_helper_not_seeded": ("""
        import jax

        def pad_to(n, multiple):
            if n % multiple:
                n = n + multiple - n % multiple
            return n

        @jax.jit
        def f(x):
            k = pad_to(x.shape[0], 8)
            return x, k
    """, """
        import torch

        def pad_to(n, multiple):
            if n % multiple:
                n = n + multiple - n % multiple
            return n

        @torch.compile
        def f(x):
            k = pad_to(x.shape[0], 8)
            return x, k
    """, []),
    "trace_entry_via_fori_loop_body": ("""
        import jax
        from jax import lax

        def run(x, n):
            def body(i, carry):
                return carry + float(carry)
            return lax.fori_loop(0, n, body, x)
    """, """
        import torch

        def run(x, n):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                y = x + float(x)
            return y
    """, ["TS002"]),
}


@pytest.mark.parametrize("name", sorted(TS_CASES))
def test_trace_safety_matches_jax_on_translated_fixtures(tmp_path, name):
    jax_src, torch_src, want = TS_CASES[name]
    port = run_on(tmp_path, torch_src, rules=[TraceSafetyRule()])
    ref = run_on(tmp_path, jax_src, rules=[JaxTrace()], run=jax_run)
    assert codes(port) == codes(ref) == want
    if name.startswith("ts001"):
        assert ([f.context for f in port.findings]
                == [f.context for f in ref.findings])


@pytest.mark.parametrize("port_rel,jax_rel,want", [
    ("src/repro_torch/serving/mod.py", "src/repro/serving/mod.py",
     ["TS005"]),
    ("src/repro_torch/launch/mod.py", "src/repro/launch/mod.py", [])])
def test_ts005_audit_matches_jax_in_and_out_of_scope(tmp_path, port_rel,
                                                     jax_rel, want):
    port = run_on(tmp_path, """
        def sync_stats(state):
            return state.cpu()
    """, rel=port_rel, rules=[TraceSafetyRule()])
    ref = run_on(tmp_path, """
        import jax

        def sync_stats(state):
            return jax.device_get(state)
    """, rel=jax_rel, rules=[JaxTrace()], run=jax_run)
    assert codes(port) == codes(ref) == want
    assert [f.context for f in port.findings] == [
        f.context for f in ref.findings]


def test_ts005_audits_the_eager_models(tmp_path):
    rep = run_on(tmp_path, """
        def route(counts):
            return counts.tolist()
    """, rel="src/repro_torch/models/mod.py", rules=[TraceSafetyRule()])
    assert triples(rep) == [("TS005", "route", "return counts.tolist()")]


@pytest.mark.parametrize("root", [
    "torch.compile(f)", "torch.vmap(f)", "torch.func.vmap(f)",
    "torch.func.grad(f)", "torch.func.grad_and_value(f)",
    "torch.func.jacrev(f)", "torch.func.jacfwd(f)",
    "torch.func.functional_call(f, {}, (1,))", "torch.jit.trace(f, (1,))",
    "torch.jit.script(f)", "torch.fx.symbolic_trace(f)",
    "torch.export.export(f, (1,))",
    "torch.cuda.make_graphed_callables((f,), ((1,),))",
    "@torch.compile", "@torch.compile(mode='max-autotune')",
    "@torch.jit.script", "@functools.partial(torch.compile, dynamic=False)"])
def test_ts_roots(tmp_path, root):
    deco = root if root.startswith("@") else ""
    call = "" if deco else f"g = {root}"
    rep = run_on(tmp_path, f"""
        import functools
        import torch

        {deco}
        def f(x):
            torch.cuda.synchronize()
            return x.item()

        {call}
    """, rules=[TraceSafetyRule()])
    assert codes(rep) == ["TS001", "TS002"]


@pytest.mark.parametrize("expr,flagged", [
    ("torch.cuda.synchronize()", True),
    ("torch.cuda.current_stream().synchronize()", True),
    ("done.synchronize()", True), ("x.cpu()", True), ("x.numpy()", True),
    ('x.to("cpu")', True), ('x.to(device="cpu")', True),
    ('x.to(torch.device("cpu"))', True),
    ('x.to("cuda")', False), ("x.to(torch.float32)", False)])
def test_ts001_sync_forms(tmp_path, expr, flagged):
    rep = run_on(tmp_path, f"""
        import torch

        @torch.compile
        def f(x, done):
            return {expr}
    """, rules=[TraceSafetyRule()])
    assert codes(rep) == (["TS001"] if flagged else [])


def test_graph_block_traces_its_calls_and_defs(tmp_path):
    rep = run_on(tmp_path, """
        import torch

        def helper(x):
            return x.numpy()

        def capture(x, static):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                y = helper(x)
                z = (lambda v: v.item())(x)
                if static is None:
                    y = y * 2
            return y, z
    """, rules=[TraceSafetyRule()])
    assert triples(rep) == [
        ("TS001", "helper", "return x.numpy()"),
        ("TS002", "capture.<lambda>", "z = (lambda v: v.item())(x)")]


HELPERS = """
    import numpy as np
    import torch


    def _to_host(x):
        return x.cpu().numpy(){suffix}


    class Engine:
        @staticmethod
        def _slot(state):
            return _to_host(state)

        def run(self, state):
            def inner():
                return self._slot(state)
            a = inner()
            b = np.asarray(a).tolist()
            return a, b
"""


def test_ts005_propagates_through_helpers(tmp_path):
    rep = run_on(tmp_path, HELPERS.format(suffix=""),
                 rel="src/repro_torch/serving/engine.py",
                 rules=[TraceSafetyRule()])
    assert [(c, ctx) for c, ctx, _ in triples(rep)] == [
        ("TS005", "Engine._slot"), ("TS005", "Engine.run"),
        ("TS005", "Engine.run.inner"), ("TS005", "_to_host")]
    # a suppressed sync is no sync: its callers are not sites either
    quiet = run_on(tmp_path, HELPERS.format(suffix="  # repro: ignore[TS005]"),
                   rel="src/repro_torch/serving/engine.py",
                   rules=[TraceSafetyRule()])
    assert quiet.findings == []


def test_ts005_on_the_port_names_jax_contexts():
    """The port's engine syncs through `_to_host` / `_slot_to_host`; the
    audit finds a site under each of the contexts JAX's baseline holds
    (`DeviceTimer.split` is the port's `DeviceTimer.block`)."""
    rep = run_analysis(["src/repro_torch/serving"], root=str(REPO),
                       rules=[TraceSafetyRule()])
    sites = {(f.path, f.context) for f in rep.findings}
    jax_entries = json.loads((REPO / "analysis_baseline.json").read_text())
    want = {(e["path"].replace("src/repro/", "src/repro_torch/"),
             e["context"].replace("DeviceTimer.split", "DeviceTimer.block"))
            for e in jax_entries["entries"]}
    assert len(want) == 6
    assert want <= sites, want - sites
    assert {f.code for f in rep.findings} == {"TS005"}


# ----------------------------------------------------------- kernel-contracts

CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// a comment naming extern "C" int fake(int x);
/* extern "C" { int also_fake(void); } */

namespace {
__global__ void kernel(const float* x, float* y, int n) {
  if (n > 0) { y[0] = x[0]; }
}
}  // namespace

#define N_ARGS(x) x

extern "C" int k_launch(const void* x, float* y, int64_t n,
                        float scale, unsigned* counters, void* stream) {
  const char* brace = "{ not a body }";
  kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), y, (int)n);
  return (int)cudaGetLastError();
}

extern "C" {

// the block form
double k_norm(const double* v, int n, long long stride) {
  return 0.0;
}

}  // extern "C"
"""

PY = """
import ctypes
import functools

from repro_torch.kernels import _build


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("k")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    head = [vp, ctypes.POINTER(ctypes.c_float)]
    lib.k_launch.argtypes = head + [ctypes.c_int64, ctypes.c_float] + [vp] * 2
    lib.k_launch.restype = ci
    lib.k_norm.argtypes = [vp, ci, ctypes.c_longlong]
    lib.k_norm.restype = ctypes.c_double
    return lib


def launch(x, y, n, stream):
    return _lib().k_launch(x, y, n, 1.0, None, stream)


def norm(v, n):
    lib = _lib()
    return lib.k_norm(v, n, 1)


def launch_all(*args):
    return _lib().k_launch(*args)
"""


def kernel_pair(tmp_path, py=PY, cu=CU, name="k.py"):
    kdir = tmp_path / "kernels"
    (kdir / "csrc").mkdir(parents=True, exist_ok=True)
    (kdir / "csrc" / "k.cu").write_text(cu)
    (kdir / name).write_text(py)
    return run_analysis([str(kdir)], root=str(tmp_path),
                        rules=[KernelContractsRule()])


def test_c_parser_reads_both_forms():
    sigs = kc.c_signatures(CU)
    assert [(s.name, s.ret, s.params) for s in sigs] == [
        ("k_launch", "i32", ("ptr", "ptr", "i64", "f32", "ptr", "ptr")),
        ("k_norm", "f64", ("ptr", "i32", "i64"))]
    assert sigs[0].types == ("const void*", "float*", "int64_t", "float",
                             "unsigned*", "void*")
    assert [s.line for s in sigs] == [
        CU.splitlines().index(line) + 1 for line in CU.splitlines()
        if line.startswith(("extern \"C\" int", "double k_norm"))]


def test_own_text_keeps_only_the_sources_lines():
    pre = "\n".join([
        '# 1 "/tmp/k.cu"', '# 1 "/usr/include/cuda_runtime.h" 1 3',
        'extern "C" { int cudaFoo(int); }', '# 3 "/tmp/k.cu" 2',
        'extern "C" int k_launch(const void* x, float* y, long n,',
        '  float scale, unsigned* c, void* s) { return 0; }'])
    own = kc.own_text(pre, "/repo/kernels/csrc/k.cu")
    assert [s.name for s in kc.c_signatures(own)] == ["k_launch"]


def test_kernel_contracts_clean_pair(tmp_path):
    rep = kernel_pair(tmp_path)
    assert rep.errors == [] and rep.findings == []


KC_CASES = {
    "KC001": dict(cu=CU.replace("long long stride)",
                                "long long stride, int extra)")),
    "KC001-unevaluable": dict(py=PY.replace(
        "lib.k_norm.argtypes = [vp, ci, ctypes.c_longlong]",
        "lib.k_norm.argtypes = make_argtypes()")),
    "KC002": dict(py=PY.replace("[vp, ci, ctypes.c_longlong]",
                                "[vp, ctypes.c_float, ctypes.c_longlong]")),
    "KC003": dict(py=PY.replace("lib.k_norm.restype = ctypes.c_double",
                                "lib.k_norm.restype = ci")),
    "KC003-missing": dict(py=PY.replace(
        "    lib.k_norm.restype = ctypes.c_double\n", "")),
    "KC004": dict(py=PY.replace("lib.k_norm(v, n, 1)", "lib.k_norm(v, n)")),
    "KC004-loader-call": dict(py=PY.replace("n, 1.0, None, stream)",
                                            "n, 1.0, stream)")),
    "KC006-uncovered": dict(cu=CU.replace(
        "}  // extern \"C\"", "int k_extra(int n) { return n; }\n}")),
    "KC006-undefined": dict(py=PY.replace(
        "    return lib\n", "    lib.k_gone.argtypes = [vp]\n    return lib\n",
        1)),
}


@pytest.mark.parametrize("case", sorted(KC_CASES))
def test_kernel_contracts_seeded_bad_pair(tmp_path, case):
    rep = kernel_pair(tmp_path, **KC_CASES[case])
    assert rep.errors == []
    assert codes(rep) == [case.split("-")[0]]
    assert rep.findings[0].path == "kernels/k.py"


@pytest.mark.parametrize("name,flagged", [
    ("flash_attention.py", True), ("paged_attention.py", True),
    ("other.py", False)])
def test_kc005_fp32_split_workspaces(tmp_path, name, flagged):
    rep = kernel_pair(tmp_path, name=name, py=PY + textwrap.dedent("""

        def workspaces(torch, n):
            ws = torch.empty(n, dtype=torch.bfloat16) if n > 1 else None
            ws_ml = torch.zeros(n, 2)
            ws_acc = torch.empty((n, 4), dtype=torch.float32)
            other = torch.empty(n, dtype=torch.bfloat16)
            return ws, ws_ml, ws_acc, other
    """))
    assert codes(rep) == (["KC005", "KC005"] if flagged else [])
    if flagged:
        assert {f.context for f in rep.findings} == {"workspaces"}


def test_kc006_a_source_no_module_loads(tmp_path):
    kdir = tmp_path / "kernels"
    kernel_pair(tmp_path)
    (kdir / "_build.py").write_text('SOURCES = ("k", "orphan")\n\n\n'
                                    'def load(name):\n    return name\n')
    (kdir / "csrc" / "orphan.cu").write_text(
        'extern "C" int orphan(int n) { return n; }\n')
    rep = run_analysis([str(kdir)], root=str(tmp_path),
                       rules=[KernelContractsRule()])
    assert triples(rep) == [("KC006", "", 'SOURCES = ("k", "orphan")')]
    assert "orphan.cu" in rep.findings[0].message


# the port's eight launch signatures: (source, function) -> C parameters
PORT_LAUNCHES = {
    ("deferral_entropy", "deferral_entropy"): 12,
    ("flash_attention", "flash_attention"): 20,
    ("gatekeeper_loss", "gatekeeper_loss_tokens"): 17,
    ("paged_attention", "paged_flash_decode_gqa"): 19,
    ("paged_attention", "paged_write_tokens"): 18,
    ("mla_attention", "paged_flash_decode_mla"): 25,
    ("wkv_scan", "wkv_scan"): 18,
    ("wkv_scan", "wkv_scan_path"): 19,
}


def test_kernel_contracts_hold_every_port_launch():
    """All eight argtypes lists evaluate, equal their extern "C"
    signatures in arity and kind, and every extern "C" function of the
    six sources is declared; four calls are counted, four starred ones
    skipped; the rule finds nothing."""
    kdir = REPO / "src" / "repro_torch" / "kernels"
    declared, launches = {}, []
    for path in sorted(kdir.glob("*.py")):
        km = kc.KernelModule(SourceModule(str(path), path.name,
                                          path.read_text()))
        declared.update(km.declarations)
        launches += [(path.name, l.fn, l.n_args) for l in km.launches]
    c_side = {(cu.stem, s.name): s for cu in sorted(kdir.glob("csrc/*.cu"))
              for s in kc.c_signatures(cu.read_text())}
    assert set(declared) == set(c_side) == set(PORT_LAUNCHES)
    for key, n in PORT_LAUNCHES.items():
        assert declared[key].argtypes == list(c_side[key].params), key
        assert len(c_side[key].params) == n
        assert declared[key].restype == c_side[key].ret == "i32"
    counted = sorted((f, n) for _, f, n in launches if n is not None)
    assert counted == sorted(
        (fn, PORT_LAUNCHES[(lib, fn)]) for lib, fn in PORT_LAUNCHES
        if fn in ("deferral_entropy", "flash_attention",
                  "paged_flash_decode_gqa", "paged_flash_decode_mla"))
    assert sorted(f for _, f, n in launches if n is None) == [
        "gatekeeper_loss_tokens", "paged_write_tokens", "wkv_scan",
        "wkv_scan_path"]
    rep = run_analysis(["src/repro_torch"], root=str(REPO),
                       rules=[KernelContractsRule()])
    assert rep.errors == [] and rep.findings == []


def test_a_dropped_argtypes_entry_fails_the_cli(tmp_path, capsys):
    """The card's seeded check (chip_smoke.py phase 20d) on the CPU: a copy
    of a kernel module with one argtypes entry dropped makes the CLI
    exit 1 with KC001."""
    kdir = tmp_path / "kernels"
    (kdir / "csrc").mkdir(parents=True)
    src = REPO / "src" / "repro_torch" / "kernels"
    text = (src / "deferral_entropy.py").read_text()
    assert text.count("[ci] * 5 + [vp]") == 1
    (kdir / "deferral_entropy.py").write_text(
        text.replace("[ci] * 5 + [vp]", "[ci] * 4 + [vp]"))
    shutil.copy(src / "csrc" / "deferral_entropy.cu", kdir / "csrc")
    rc = cli.main(["--paths", "kernels", "--root", str(tmp_path),
                   "--baseline", "", "--json"])
    new = json.loads(capsys.readouterr().out)["new"]
    assert rc == 1
    assert sorted(f["code"] for f in new) == ["KC001", "KC004"]


# ---------------------------------------------------------------- self-check

def test_port_is_clean_modulo_baseline():
    """The shipped port passes the gate: no errors, no findings beyond
    analysis_baseline_torch.json, no stale entry, every entry justified."""
    baseline = load_baseline(str(REPO / DEFAULT_BASELINE))
    rep = run_analysis(["src/repro_torch", "chip_smoke.py"], root=str(REPO),
                       baseline=baseline)
    assert rep.errors == []
    assert [f.render() for f in rep.new] == []
    assert rep.stale_baseline == []
    assert rep.exit_code == 0
    assert rep.baselined
    for e in baseline.entries:
        assert (e["rule"], e["code"]) == ("trace-safety", "TS005"), e
        assert e["justification"] and "TODO" not in e["justification"], e


def test_injected_violation_fails_the_gate(tmp_path):
    (tmp_path / "clean.py").write_text("x = 1\n")
    (tmp_path / "dirty.py").write_text(textwrap.dedent("""
        import torch

        @torch.compile
        def f(x):
            return x.cpu()
    """))
    rc = cli.main(["--paths", str(tmp_path), "--root", str(tmp_path),
                   "--baseline", ""])
    assert rc == 1
