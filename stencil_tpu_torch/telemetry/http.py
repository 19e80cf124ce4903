"""The ``/metrics`` endpoint, on the standard library alone.

PyTorch-port counterpart of ``stencil_tpu/telemetry/http.py``: a
:class:`MetricsServer` serves one ``telemetry.metrics.MetricsRegistry``
as a Prometheus scraper expects:

* ``GET /metrics``       — text exposition (format 0.0.4);
* ``GET /metrics.json``  — the JSON snapshot;
* ``GET /healthz``       — liveness (200 "ok").

It runs ``http.server.ThreadingHTTPServer`` in a daemon thread; bind
``port=0`` for an ephemeral port (the bound port is ``.port`` after
:meth:`start`). It listens on ``127.0.0.1`` unless told otherwise.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .metrics import MetricsRegistry

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsServer:
    """Serve one registry's metrics until :meth:`stop`."""

    def __init__(self, registry: MetricsRegistry, port: int = 0,
                 host: str = "127.0.0.1") -> None:
        self.registry = registry
        self.host = host
        self.port = int(port)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> int:
        """Bind and serve in a daemon thread; returns the bound port."""
        if self._httpd is not None:
            raise RuntimeError("metrics server already started")
        registry = self.registry

        class Handler(BaseHTTPRequestHandler):
            def _send(self, code: int, body: bytes,
                      ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self) -> None:  # noqa: N802 - stdlib contract
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    self._send(200,
                               registry.to_prometheus_text().encode(),
                               PROMETHEUS_CONTENT_TYPE)
                elif path == "/metrics.json":
                    body = json.dumps(registry.snapshot()).encode()
                    self._send(200, body, "application/json")
                elif path == "/healthz":
                    self._send(200, b"ok\n", "text/plain")
                else:
                    self._send(404, b"not found\n", "text/plain")

            def log_message(self, *args) -> None:
                pass  # scrapes are not stderr news

        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="stencil-metrics-http",
                                        daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def __enter__(self) -> "MetricsServer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
