"""The port's serving observability on the CPU, mirroring
tests/test_serving_obs.py: the /metrics endpoint (`MetricsServer`), the
Chrome-trace export validated by `validate_chrome_trace` (and JAX's
validator agreeing on the same objects), the validator's rejections, and
the profiler window's state machine over a stand-in `torch.profiler`;
then the engine's side: an engine-owned runtime starts and stops its
endpoint, a caller-owned one keeps it open and ticks its profiler window
once per iteration (a real CPU `torch.profiler` capture), and the
engine's own trace validates. The golden trace of
`test_trace_golden_and_obs_parity` is no parity target here (its
wall-clock arrivals make it unsteady; ROADMAP.md §3)."""
import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.data.synthetic import make_lm_stream
from repro.models import transformer as jtfm
from repro.serving.obs import validate_chrome_trace as j_validate
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import params_from_jax
from repro_torch.serving import (CascadeSpec, ContinuousCascadeEngine,
                                 EngineConfig, ModelRunner, make_requests)
from repro_torch.serving.obs import (MetricsRegistry, MetricsServer,
                                     ObsConfig, Observability,
                                     ProfilerWindow, Tracer,
                                     validate_chrome_trace)
from repro_torch.serving.obs import device_time

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runners():
    """tests/test_serving_obs.py's fixture on the port: JAX's weights for
    the small and large runner, JAX's 6 prompts of 10 tokens, and a tau
    that defers about half of them."""
    key = jax.random.PRNGKey(0)
    s_cfg = reduced(get_config("internlm2-1.8b"))
    l_cfg = s_cfg.replace(name="large", n_layers=3, d_ff=768)
    t_cfg = t_reduced(t_get_config("internlm2-1.8b"))
    small = ModelRunner(t_cfg, params_from_jax(
        jax.device_get(jtfm.init_params(s_cfg, key)), "cpu"))
    large = ModelRunner(t_cfg.replace(name="large", n_layers=3, d_ff=768),
                        params_from_jax(jax.device_get(jtfm.init_params(
                            l_cfg, jax.random.fold_in(key, 1))), "cpu"))
    prompts = np.asarray(make_lm_stream(jax.random.fold_in(key, 2), 6, 10,
                                        s_cfg.vocab_size))
    _, conf = small.generate(prompts, 10, 6)
    return small, large, prompts, float(np.median(conf))


def _get(url: str):
    with urllib.request.urlopen(url, timeout=5) as resp:
        return resp.status, resp.headers["Content-Type"], resp.read().decode()


# ---------------------------------------------------------------------------
# The /metrics endpoint
# ---------------------------------------------------------------------------

def test_metrics_http_endpoint():
    reg = MetricsRegistry()
    reg.counter("scraped_total", "scrapes").inc(3)
    srv = MetricsServer(reg, port=0).start()
    try:
        status, ctype, body = _get(srv.url)
        assert status == 200
        assert ctype.startswith("text/plain; version=0.0.4")
        assert "scraped_total 3.0" in body
        # live per scrape, not a snapshot
        reg.counter("scraped_total").inc()
        assert "scraped_total 4.0" in _get(srv.url)[2]
        bad = urllib.request.Request(f"http://{srv.host}:{srv.port}/nope")
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(bad, timeout=5)
    finally:
        srv.close()
    assert not srv._thread.is_alive()


# ---------------------------------------------------------------------------
# Tracer + validator
# ---------------------------------------------------------------------------

def test_tracer_export_schema(tmp_path):
    tr = Tracer()
    tr.name_process(1, "engine")
    tr.name_thread(1, 0, "loop")
    tr.complete("outer", "t", 0.0, 1.0, tid=0)
    tr.complete("inner", "t", 0.2, 0.3, tid=0)
    tr.instant("mark", "t", 0.5, tid=0)
    path = tmp_path / "t.json"
    tr.export(str(path))
    obj = json.loads(path.read_text())
    spans = validate_chrome_trace(obj)
    assert [s["name"] for s in spans] == ["outer", "inner"]
    assert spans == j_validate(obj)
    meta = [e for e in obj["traceEvents"] if e["ph"] == "M"]
    assert {m["name"] for m in meta} == {"process_name", "thread_name"}
    assert obj["displayTimeUnit"] == "ms"


def test_validator_rejects_partial_overlap():
    tr = Tracer()
    tr.complete("a", "t", 0.0, 1.0, tid=0)
    tr.complete("b", "t", 0.5, 1.0, tid=0)    # overlaps, not nested
    for validate in (validate_chrome_trace, j_validate):
        with pytest.raises(AssertionError, match="overlaps"):
            validate(tr.export_obj())
    tr2 = Tracer()
    tr2.complete("a", "t", 0.0, 1.0, tid=0)
    tr2.complete("b", "t", 0.5, 1.0, tid=1)
    assert len(validate_chrome_trace(tr2.export_obj())) == 2


@pytest.mark.parametrize("obj", [
    {"notTraceEvents": []},
    {"traceEvents": []},
    {"traceEvents": [{"name": "x", "ph": "X", "pid": 1, "tid": 0,
                      "ts": 1.0}]},
    {"traceEvents": [{"name": "x", "ph": "X", "pid": 1, "tid": 0,
                      "ts": -1.0, "dur": 1.0}]},
    {"traceEvents": [{"name": "x", "ph": "Q", "pid": 1, "tid": 0,
                      "ts": 1.0}]},
    {"traceEvents": [{"ph": "i", "pid": 1, "tid": 0, "ts": 1.0}]},
], ids=["no-events-key", "empty", "no-dur", "negative-ts", "unknown-ph",
        "no-name"])
def test_validator_rejects_malformed_events(obj):
    with pytest.raises(AssertionError):
        validate_chrome_trace(obj)
    with pytest.raises(AssertionError):
        j_validate(obj)


# ---------------------------------------------------------------------------
# The profiler window
# ---------------------------------------------------------------------------

class _FakeProfile:
    """Stands in for `torch.profiler.profile`, recording its calls."""
    calls: list = []

    def __init__(self, activities):
        self.calls.append(("init", tuple(a.name for a in activities)))

    def start(self):
        self.calls.append(("start",))

    def stop(self):
        self.calls.append(("stop",))

    def export_chrome_trace(self, path):
        self.calls.append(("export", path))
        with open(path, "w") as f:
            json.dump({"traceEvents": [{"name": "k", "ph": "X", "pid": 0,
                                        "tid": 0, "ts": 0, "dur": 1}]}, f)


def test_profiler_window_state_machine(monkeypatch, tmp_path):
    _FakeProfile.calls = []
    calls = _FakeProfile.calls
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    w = ProfilerWindow(str(tmp_path / "prof"), n_iters=3)
    for _ in range(6):
        w.tick()
    w.close()
    w.close()                               # idempotent
    assert [c[0] for c in calls] == ["init", "start", "stop", "export"]
    assert calls[0][1][0] == "CPU"
    assert calls[3][1] == w.trace_path
    assert w.trace_path.startswith(str(tmp_path / "prof"))
    validate_chrome_trace(json.loads(open(w.trace_path).read()))
    # close() stops a still-open capture
    calls.clear()
    w2 = ProfilerWindow(str(tmp_path / "prof2"), n_iters=10)
    w2.tick()
    w2.tick()
    assert w2.running
    w2.close()
    assert [c[0] for c in calls] == ["init", "start", "stop", "export"]
    assert not w2.running
    # a disabled window never touches the profiler
    calls.clear()
    w3 = ProfilerWindow(None)
    w3.tick()
    w3.close()
    assert calls == [] and not w3.enabled


def test_profiler_window_raises_when_the_profiler_fails(monkeypatch,
                                                        tmp_path):
    class Broken(_FakeProfile):
        def start(self):
            raise RuntimeError("profiler unavailable")
    monkeypatch.setattr(torch.profiler, "profile", Broken)
    w = ProfilerWindow(str(tmp_path), n_iters=2)
    with pytest.raises(RuntimeError, match="unavailable"):
        w.tick()
    assert not w.running


def test_profiler_window_asks_for_cuda_activity_with_a_card(monkeypatch,
                                                            tmp_path):
    _FakeProfile.calls = []
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    monkeypatch.setattr(device_time.torch.cuda, "is_available",
                        lambda: True)
    w = ProfilerWindow(str(tmp_path), n_iters=1)
    w.tick()
    w.close()
    assert _FakeProfile.calls[0] == ("init", ("CPU", "CUDA"))


# ---------------------------------------------------------------------------
# The engine with observability
# ---------------------------------------------------------------------------

def _engine(runners):
    small, large, _, tau = runners
    return ContinuousCascadeEngine(CascadeSpec.two_tier(small, large,
                                                        tau=tau),
                                   EngineConfig(n_slots=3,
                                                early_exit=False))


def test_engine_owned_observability_serves_metrics_and_stops(runners,
                                                             monkeypatch):
    """An `ObsConfig` with a port: the engine starts the endpoint with
    the run (scraped mid-run from the telemetry's hook) and stops it
    when the run finishes; outputs equal a run without observability."""
    small, large, prompts, _ = runners
    from repro_torch.serving import telemetry
    scraped = []
    real_event = telemetry.ServingTelemetry.event

    def event(self, kind, **fields):
        real_event(self, kind, **fields)
        if kind == "retire" and not scraped:
            srv = self.obs.server
            scraped.append(_get(srv.url)[2])
    monkeypatch.setattr(telemetry.ServingTelemetry, "event", event)
    res = _engine(runners).run(make_requests(prompts, 4), 4,
                               obs=ObsConfig(metrics_port=0))
    monkeypatch.undo()
    assert scraped and "serving_requests_admitted" in scraped[0]
    ref = _engine(runners).run(make_requests(prompts, 4), 4)
    np.testing.assert_array_equal(res.tokens, ref.tokens)
    np.testing.assert_array_equal(res.deferred, ref.deferred)


def test_caller_owned_observability_endpoint_profiler_and_trace(runners,
                                                                tmp_path):
    """A caller-owned runtime: the endpoint stays up after the run (the
    retired count scrapes at 6), the profiler window captures the first
    iterations with a real CPU `torch.profiler`, and the engine's trace,
    exported only at the caller's `finish`, validates."""
    _, _, prompts, _ = runners
    trace_path = tmp_path / "t.json"
    obs = Observability(ObsConfig(metrics_port=0,
                                  profile_dir=str(tmp_path / "prof"),
                                  profile_iters=2,
                                  trace_path=str(trace_path)))
    srv = obs.start_server()
    assert obs.start_server() is srv
    res = _engine(runners).run(make_requests(prompts, 4), 4, obs=obs)
    assert len(res.requests) == 6
    body = _get(srv.url)[2]
    assert "serving_requests_retired 6.0" in body
    assert not trace_path.exists()          # the engine did not finish it
    prof = obs.profiler.trace_path
    assert prof is not None and not obs.profiler.running
    events = json.loads(open(prof).read())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    obs.finish()
    obs.finish()                            # idempotent
    assert obs.server is None and not srv._thread.is_alive()
    spans = validate_chrome_trace(json.loads(trace_path.read_text()))
    assert {"iteration", "decode", "drain"} <= {s["name"] for s in spans}


def test_engine_closes_the_profiler_window_when_a_run_raises(runners,
                                                             monkeypatch,
                                                             tmp_path):
    _FakeProfile.calls = []
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    small, large, prompts, tau = runners
    eng = _engine(runners)

    def boom(*a, **k):
        raise RuntimeError("decode failed")
    monkeypatch.setattr(eng, "_decode_body", boom)
    obs = Observability(ObsConfig(profile_dir=str(tmp_path), profile_iters=50))
    with pytest.raises(RuntimeError, match="decode failed"):
        eng.run(make_requests(prompts, 4), 4, obs=obs)
    assert not obs.profiler.running
    assert [c[0] for c in _FakeProfile.calls] == ["init", "start", "stop",
                                                  "export"]
