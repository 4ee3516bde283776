"""Copy of `repro.serving.obs.httpd` for the port.

Stdlib-only Prometheus scrape endpoint for a `MetricsRegistry`.

``MetricsServer`` runs a ``ThreadingHTTPServer`` on a daemon thread and
answers ``GET /metrics`` with the registry's current render (text
exposition format v0.0.4). Pull-mode gauges are evaluated per scrape, so
a scrape always sees live pool/queue state, not a snapshot.

Port 0 binds an ephemeral port (tests); `serve.py --metrics-port N`
binds a fixed one for a real scraper:

    scrape_configs:
      - job_name: repro-serving
        static_configs: [{targets: ["localhost:9100"]}]
"""
from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from repro_torch.serving.obs.metrics import MetricsRegistry

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsServer:
    """Background /metrics endpoint bound to one registry."""

    def __init__(self, registry: MetricsRegistry, port: int = 0,
                 host: str = "127.0.0.1"):
        self.registry = registry
        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):              # noqa: N802 (stdlib API)
                if self.path.rstrip("/") in ("", "/metrics"):
                    body = server.registry.render().encode()
                    self.send_response(200)
                    self.send_header("Content-Type", CONTENT_TYPE)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_error(404, "try /metrics")

            def log_message(self, *a):     # silence per-request stderr
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: threading.Thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="metrics-httpd")

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def start(self) -> "MetricsServer":
        self._thread.start()
        return self

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)
