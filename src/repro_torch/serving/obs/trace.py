"""Copy of `repro.serving.obs.trace` for the port.

Span tracing with Chrome trace-event JSON export (Perfetto-loadable).

The tracer records **complete** spans (``ph: "X"``) and **instant**
events (``ph: "i"``) on (pid, tid) tracks, with timestamps in seconds on
the telemetry run-relative clock (converted to microseconds at export).
Two process tracks are used by the serving engine:

  * ``pid=PID_ENGINE`` — the engine control loop. ``tid 0`` carries one
    span per engine iteration with nested phase spans (schedule /
    prefill / decode / ml_poll) and a final ``drain`` span.
  * ``pid=PID_REQUESTS`` — one tid per request (tid == rid) carrying the
    request's lifecycle spans: ``queued -> prefill -> decode ->
    ml_wait`` and a ``done`` instant. Decode spans carry the per-token
    confidence record (eq.-8 running negative entropy deltas) in
    ``args["conf"]``.

Export (:meth:`Tracer.export`) writes the standard JSON object format
``{"traceEvents": [...], "displayTimeUnit": "ms"}`` that
https://ui.perfetto.dev and ``chrome://tracing`` load directly.

:func:`validate_chrome_trace` is the schema/nesting checker the golden
test (and anything else consuming these traces) uses: required keys per
event, non-negative microsecond timestamps, and proper span nesting per
(pid, tid) track.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

PID_ENGINE = 1
PID_REQUESTS = 2


class Tracer:
    """Append-only span recorder. Timestamps are *seconds* on the
    caller's run-relative clock (`ServingTelemetry.now`); the Chrome
    format's microseconds appear only at export.

    Tracing retains one dict per span, so it is opt-in (``--trace-out``);
    the always-on path is the bounded `MetricsRegistry`."""

    def __init__(self):
        self.events: List[Dict[str, Any]] = []
        self._names: Dict[tuple, str] = {}

    # -- emission ----------------------------------------------------------
    def complete(self, name: str, cat: str, ts_s: float, dur_s: float,
                 tid: int, pid: int = PID_ENGINE,
                 args: Optional[Dict[str, Any]] = None) -> None:
        """One finished span: [ts_s, ts_s + dur_s) on track (pid, tid)."""
        ev = {"name": name, "cat": cat, "ph": "X",
              "ts": round(ts_s * 1e6, 3),
              "dur": round(max(dur_s, 0.0) * 1e6, 3),
              "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def instant(self, name: str, cat: str, ts_s: float, tid: int,
                pid: int = PID_ENGINE,
                args: Optional[Dict[str, Any]] = None) -> None:
        ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
              "ts": round(ts_s * 1e6, 3), "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def name_process(self, pid: int, name: str) -> None:
        self._names[(pid, None)] = name

    def name_thread(self, pid: int, tid: int, name: str) -> None:
        self._names[(pid, tid)] = name

    # -- export ------------------------------------------------------------
    def export_obj(self) -> Dict[str, Any]:
        """The Chrome trace JSON object (metadata events + recorded
        events, stably sorted by timestamp with wider spans first so
        nesting renders correctly)."""
        meta = []
        for (pid, tid), name in sorted(self._names.items(),
                                       key=lambda kv: (kv[0][0],
                                                       kv[0][1] or 0)):
            if tid is None:
                meta.append({"name": "process_name", "ph": "M", "pid": pid,
                             "args": {"name": name}})
            else:
                meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                             "tid": tid, "args": {"name": name}})
        events = sorted(self.events,
                        key=lambda e: (e["pid"], e["tid"], e["ts"],
                                       -e.get("dur", 0.0)))
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def export(self, path: str) -> None:
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.export_obj(), f)


def emit_request_spans(tracer: Tracer, requests) -> None:
    """Emit the lifecycle spans of finished `requests` (one tid per rid
    on the PID_REQUESTS track) from their recorded timestamps:
    ``queued -> prefill -> decode -> ml_wait`` + a ``done`` instant.
    Called once at end of run — per-request cost is paid only when
    tracing is on, and span edges equal the audit-log timestamps by
    construction (same clock, same fields)."""
    import math

    def fin(x):
        return x is not None and not math.isnan(x)

    tracer.name_process(PID_ENGINE, "engine")
    tracer.name_thread(PID_ENGINE, 0, "iterations")
    tracer.name_process(PID_REQUESTS, "requests")
    for r in requests:
        tid = r.rid
        tracer.name_thread(PID_REQUESTS, tid, f"req {r.rid}")
        if not fin(r.t_admit):
            continue
        tracer.complete("queued", "request", r.arrival_time,
                        r.t_admit - r.arrival_time, tid, PID_REQUESTS,
                        args={"rid": r.rid})
        pf_end = r.t_prefill_done if fin(r.t_prefill_done) else r.t_admit
        tracer.complete("prefill", "request", r.t_admit,
                        pf_end - r.t_admit, tid, PID_REQUESTS,
                        args={"prompt_len": r.prompt_len,
                              "shared_prefix_tokens":
                                  r.shared_prefix_tokens})
        if fin(r.t_retire):
            args: Dict[str, Any] = {"n_tokens": int(r.n_small_steps),
                                    "confidence": round(r.confidence, 6),
                                    "deferred": bool(r.deferred),
                                    "early_exited": bool(r.early_exited)}
            if r.conf_trace is not None:
                args["conf"] = r.conf_trace
            tracer.complete("decode", "request", pf_end,
                            r.t_retire - pf_end, tid, PID_REQUESTS,
                            args=args)
        if r.deferred and fin(r.t_submit_large) and fin(r.t_done):
            tracer.complete("ml_wait", "request", r.t_submit_large,
                            r.t_done - r.t_submit_large, tid, PID_REQUESTS)
        if fin(r.t_done):
            tracer.instant("done", "request", r.t_done, tid, PID_REQUESTS)


def validate_chrome_trace(obj: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Assert `obj` is schema-valid Chrome trace-event JSON and that
    spans nest properly per (pid, tid) track. Returns the "X" spans
    (ts-sorted) for further inspection. Raises AssertionError with a
    specific message on the first violation."""
    assert isinstance(obj, dict), "trace must be a JSON object"
    assert "traceEvents" in obj, "missing traceEvents"
    events = obj["traceEvents"]
    assert isinstance(events, list) and events, "traceEvents empty"
    spans = []
    for ev in events:
        assert isinstance(ev, dict), f"event not an object: {ev!r}"
        assert "ph" in ev and "pid" in ev and "name" in ev, \
            f"event missing required keys: {ev!r}"
        ph = ev["ph"]
        if ph == "M":
            continue
        assert "ts" in ev and "tid" in ev, f"event missing ts/tid: {ev!r}"
        assert isinstance(ev["ts"], (int, float)) and ev["ts"] >= 0, \
            f"bad ts: {ev!r}"
        if ph == "X":
            assert isinstance(ev.get("dur"), (int, float)) \
                and ev["dur"] >= 0, f"X event needs dur >= 0: {ev!r}"
            spans.append(ev)
        else:
            assert ph in ("i", "I", "B", "E", "C"), f"unknown ph: {ev!r}"
    # nesting: within one track, sorted by (ts, -dur), every span must
    # either start at/after the enclosing span's end (sibling) or end
    # within it (child) — partial overlap is a malformed trace
    by_track: Dict[tuple, List[Dict[str, Any]]] = {}
    for s in spans:
        by_track.setdefault((s["pid"], s["tid"]), []).append(s)
    eps = 0.5  # µs slack for the export rounding
    for track, tr_spans in by_track.items():
        tr_spans.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: List[Dict[str, Any]] = []
        for s in tr_spans:
            while stack and s["ts"] >= stack[-1]["ts"] + stack[-1]["dur"] \
                    - eps:
                stack.pop()
            if stack:
                parent_end = stack[-1]["ts"] + stack[-1]["dur"]
                assert s["ts"] + s["dur"] <= parent_end + eps, (
                    f"span {s['name']!r} [{s['ts']}, "
                    f"{s['ts'] + s['dur']}] overlaps parent "
                    f"{stack[-1]['name']!r} ending {parent_end} on track "
                    f"{track}")
            stack.append(s)
    return sorted(spans, key=lambda e: e["ts"])
