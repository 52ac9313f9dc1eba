"""Stdlib HTTP observability endpoint: /metrics, /health, /workload.

One ``ThreadingHTTPServer`` (no dependencies) the serving loop starts
with ``--http-port``:

* ``GET /metrics`` — Prometheus text exposition (version 0.0.4)
  rendered from the structured ``describe_metrics(buckets=True)``:
  counters as ``counter``, gauges as ``gauge``, histograms as proper
  ``histogram`` families with cumulative ``_bucket{le="..."}`` lines
  from the registry's log2 bucket layout, plus ``_sum`` / ``_count``.
* ``GET /health`` — the :class:`repro_torch.obs.health.HealthMonitor`
  evaluation as JSON; HTTP 200 for ``ok``/``degraded`` (degraded is an
  alert, not an outage), 503 for ``critical`` so load balancers eject
  the replica exactly when the SLO says to.
* ``GET /workload`` — the live
  :class:`repro_torch.obs.analytics.WorkloadAnalyzer` profile as JSON (404
  with a hint when no analyzer is attached).

Metric names are mangled to the Prometheus grammar
(``query.probe_latency_ms`` → ``coconut_query_probe_latency_ms``); the
reverse map is trivial because ``.`` is the only character the
registry's naming convention uses outside ``[a-z0-9_]``.
"""
from __future__ import annotations

import json
import math
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .registry import MetricsRegistry, describe_metrics

__all__ = ["ObsHTTPServer", "render_prometheus", "prom_name"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
PREFIX = "coconut_"


def prom_name(name: str) -> str:
    """Registry name -> Prometheus metric name."""
    return PREFIX + _NAME_RE.sub("_", name)


def _fmt(v: float) -> str:
    if isinstance(v, float):
        if math.isnan(v):
            return "NaN"
        if math.isinf(v):
            return "+Inf" if v > 0 else "-Inf"
    return repr(float(v)) if isinstance(v, float) else str(v)


def render_prometheus(desc: dict) -> str:
    """Prometheus text exposition from the structured
    ``describe_metrics(buckets=True)`` document.

    Histograms emit cumulative ``_bucket`` lines for every bucket with
    observations plus the mandatory ``le="+Inf"`` terminal (sparse
    buckets are valid exposition: cumulative counts stay correct
    because skipped buckets are empty).
    """
    lines = []
    for name, v in sorted(desc.get("counters", {}).items()):
        p = prom_name(name)
        lines.append(f"# TYPE {p} counter")
        lines.append(f"{p} {_fmt(v)}")
    for name, v in sorted(desc.get("gauges", {}).items()):
        p = prom_name(name)
        lines.append(f"# TYPE {p} gauge")
        lines.append(f"{p} {_fmt(v)}")
    for name, h in sorted(desc.get("histograms", {}).items()):
        p = prom_name(name)
        lines.append(f"# TYPE {p} histogram")
        cum = 0
        for le, count in h.get("buckets", []):
            # the overflow bucket's own bound is +inf — folded into the
            # terminal +Inf line below instead of emitted twice
            if count and math.isfinite(le):
                cum += int(count)
                lines.append(f'{p}_bucket{{le="{_fmt(float(le))}"}} '
                             f"{cum}")
        lines.append(f'{p}_bucket{{le="+Inf"}} {int(h["count"])}')
        lines.append(f"{p}_sum {_fmt(float(h['sum']))}")
        lines.append(f"{p}_count {int(h['count'])}")
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    server_version = "CoconutObs/1.0"

    # the ObsHTTPServer instance wires itself in via server attributes
    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, code: int, doc: dict) -> None:
        self._send(code, (json.dumps(doc, indent=2) + "\n").encode(),
                   "application/json")

    def do_GET(self) -> None:  # noqa: N802 (stdlib naming)
        owner: "ObsHTTPServer" = self.server.owner  # type: ignore
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        try:
            if path == "/metrics":
                body = render_prometheus(describe_metrics(
                    owner.registry, buckets=True))
                self._send(200, body.encode(),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/health":
                if owner.health is None:
                    self._json(404, {"error": "no health monitor "
                                              "attached"})
                    return
                doc = owner.health.evaluate(sample_first=True)
                self._json(503 if doc["state"] == "critical" else 200,
                           doc)
            elif path == "/workload":
                if owner.analyzer is None:
                    self._json(404, {"error": "no workload analyzer "
                                              "attached (run with a "
                                              "query log enabled)"})
                    return
                self._json(200, owner.analyzer.profile())
            elif path == "/":
                self._json(200, {"endpoints": ["/metrics", "/health",
                                               "/workload"]})
            else:
                self._json(404, {"error": f"unknown path {path!r}"})
        except BrokenPipeError:
            pass
        except Exception as e:          # scrape failures must be visible,
            try:                        # not fatal to the serving process
                self._json(500, {"error": repr(e)})
            except Exception:
                pass

    def log_message(self, fmt, *args):  # silence per-request stderr spam
        pass


class ObsHTTPServer:
    """Threaded observability endpoint.

    ``port=0`` binds an ephemeral port (tests); :attr:`port` reports
    the actual one after :meth:`start`.  ``health`` / ``analyzer`` are
    optional — endpoints 404 with a hint when absent.
    """

    def __init__(self, port: int = 0, *, host: str = "127.0.0.1",
                 registry: Optional[MetricsRegistry] = None,
                 health=None, analyzer=None):
        self.host = host
        self.registry = registry
        self.health = health
        self.analyzer = analyzer
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.owner = self        # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "ObsHTTPServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, daemon=True,
                name="coconut-obs-httpd")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    def __enter__(self) -> "ObsHTTPServer":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False
