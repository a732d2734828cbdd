"""Zero-dependency ops HTTP server (counterpart of
``paddle_tpu/serving/opsserver.py``): the wire end of the telemetry.

Standard-library ``http.server`` only, threaded, bound to 127.0.0.1 (an
ephemeral port by default; no other address is accepted):

======================  ==================================================
``GET /metrics``        Prometheus text exposition v0.0.4
                        (``MetricsRegistry.to_prometheus``)
``GET /varz``           the JSON registry snapshot
``GET /statusz``        the human ops console (``metrics.statusz()``)
``GET /healthz``        200 when the target is fully healthy, 503 with a
                        JSON body naming the poisoned replicas otherwise
``GET /readyz``         200 while the target can accept work (>= 1
                        healthy replica, not closed)
``GET /tracez``         recent and tail-sampled request traces per
                        replica (``FlightRecorder.tail_traces``) and the
                        SLO report
``GET /timeline``       the merged chrome-trace document
                        (``profiler.timeline.unified_trace_doc``: host
                        spans, request lanes, the memory timeline)
======================  ==================================================

Attach it to a :class:`~.engine.GenerationEngine`, an
:class:`~.fleet.EngineFleet`, or nothing (process-level metrics only)::

    srv = OpsServer(target=fleet, slo=tracker).start()
    print(srv.url)          # http://127.0.0.1:<ephemeral>
    ...
    srv.close()

Routing is a table: the built-ins register through the same
``add_route(method, path, handler)`` that extensions use, so the front
door (:mod:`.frontdoor`) mounts ``POST /v1/completions`` beside
``/metrics`` on one port. Handlers never touch the device and never
block on the scheduler: they read scrape-time collectors, host rings and
host counters. A raising handler answers 500 and the server thread lives
on. Request logging is silenced.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

from ..framework import metrics as _metrics

__all__ = ["OpsServer"]

_LOOPBACK = ("127.0.0.1", "localhost")


class _OpsHandler(BaseHTTPRequestHandler):
    server_version = "paddle-torch-ops/1"

    def log_message(self, *args):                        # noqa: D102
        pass

    def _send(self, code: int, ctype: str, body) -> None:
        data = body if isinstance(body, bytes) else str(body).encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _send_json(self, code: int, doc: Any) -> None:
        self._send(code, "application/json",
                   json.dumps(doc, default=repr))

    def _dispatch(self, method: str) -> None:
        """Route one request through the server's handler table. An
        unknown (method, path) answers the canonical 404; a raising
        handler answers 500 — the serving thread lives on either way."""
        ops = self.server.ops                            # type: ignore
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        try:
            handler = ops.route(method, path)
            if handler is None:
                self._send_json(404, {"error": f"no such endpoint "
                                      f"{path!r}", "see": "/"})
                return
            handler(self)
        except Exception as e:                           # noqa: BLE001
            # a broken section answers 500; the serving thread lives on
            try:
                self._send_json(500, {"error": repr(e), "path": path})
            except Exception:                            # noqa: BLE001
                pass

    def do_GET(self) -> None:                            # noqa: N802
        self._dispatch("GET")

    def do_POST(self) -> None:                           # noqa: N802
        self._dispatch("POST")


class OpsServer:
    """One process, one ops surface: a threaded stdlib HTTP server over
    the metrics registry, optionally bound to an engine or fleet for
    health/traces.

    ``target`` may be a ``GenerationEngine``, an ``EngineFleet`` or
    ``None``; ``slo`` an :class:`~.slo.SLOTracker` whose report rides
    ``/tracez``. ``port=0`` binds an ephemeral port (read it back from
    ``srv.port`` / ``srv.url``). ``host`` must be the loopback address
    (``"127.0.0.1"`` or ``"localhost"``): the surface has no
    authentication of its own."""

    def __init__(self, target: Optional[Any] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 registry: Optional[_metrics.MetricsRegistry] = None,
                 slo: Optional[Any] = None):
        if host not in _LOOPBACK:
            raise ValueError(
                f"OpsServer binds the loopback address only "
                f"({' or '.join(_LOOPBACK)}), got host={host!r}")
        self._target = target
        self._slo = slo
        self._registry = registry if registry is not None \
            else _metrics.registry()
        self._host = "127.0.0.1"
        self._port = int(port)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        # the route table: (METHOD, path) -> handler(request_handler).
        # Built-ins register through the same seam extensions use
        # (add_route) — the inference front door mounts POST
        # /v1/completions here so /metrics and the completions API
        # share one process and one port.
        self._routes: Dict[Tuple[str, str], Any] = {}
        self._register_builtin_routes()

    # -- route table --------------------------------------------------------
    def add_route(self, method: str, path: str, handler) -> None:
        """Mount ``handler(request_handler)`` at (``method``, ``path``).

        The handler receives the live ``BaseHTTPRequestHandler`` and
        answers via ``_send``/``_send_json`` (POST bodies via
        ``request_handler.rfile`` + the Content-Length header). Route
        handlers inherit the ops-surface contract: never touch the
        device, never block on the scheduler loop — engine HANDLES (submit /
        stream) are the only legal way in. Registering an existing
        (method, path) replaces it; unknown paths keep answering the
        canonical 404."""
        path = path.split("?", 1)[0].rstrip("/") or "/"
        self._routes[(method.upper(), path)] = handler

    def route(self, method: str, path: str) -> Optional[Any]:
        """The handler mounted at (``method``, ``path``), or None."""
        return self._routes.get((method.upper(), path))

    def endpoints(self) -> list:
        """Sorted unique route paths (the ``/`` index body)."""
        return sorted({p for _, p in self._routes if p != "/"})

    def _register_builtin_routes(self) -> None:
        def _metrics_h(h):
            h._send(200, "text/plain; version=0.0.4; charset=utf-8",
                    self.registry.to_prometheus())

        def _varz(h):
            h._send_json(200, self.registry.snapshot())

        def _statusz(h):
            h._send(200, "text/plain; charset=utf-8",
                    self.registry.statusz())

        def _healthz(h):
            ok, doc = self.health()
            h._send_json(200 if ok else 503, doc)

        def _readyz(h):
            ok, doc = self.ready()
            h._send_json(200 if ok else 503, doc)

        def _tracez(h):
            h._send_json(200, self.tracez())

        def _timeline(h):
            from ..profiler.timeline import unified_trace_doc
            h._send_json(200, unified_trace_doc())

        def _index(h):
            h._send_json(200, {"endpoints": self.endpoints()})

        self.add_route("GET", "/metrics", _metrics_h)
        self.add_route("GET", "/varz", _varz)
        self.add_route("GET", "/statusz", _statusz)
        self.add_route("GET", "/healthz", _healthz)
        self.add_route("GET", "/readyz", _readyz)
        self.add_route("GET", "/tracez", _tracez)
        self.add_route("GET", "/timeline", _timeline)
        self.add_route("GET", "/", _index)

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "OpsServer":
        if self._httpd is not None:
            return self
        httpd = ThreadingHTTPServer((self._host, self._port),
                                    _OpsHandler)
        httpd.daemon_threads = True
        httpd.ops = self                                 # type: ignore
        self._httpd = httpd
        self._thread = threading.Thread(
            target=httpd.serve_forever, daemon=True,
            name=f"paddle-torch-ops-server:{httpd.server_address[1]}")
        self._thread.start()
        return self

    def close(self) -> None:
        httpd, self._httpd = self._httpd, None
        thread, self._thread = self._thread, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if thread is not None:
            thread.join(timeout=5)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
        return False

    # -- addresses ----------------------------------------------------------
    @property
    def port(self) -> Optional[int]:
        if self._httpd is None:
            return None
        return self._httpd.server_address[1]

    @property
    def url(self) -> Optional[str]:
        if self._httpd is None:
            return None
        return f"http://{self._host}:{self.port}"

    @property
    def registry(self) -> _metrics.MetricsRegistry:
        return self._registry

    # -- target introspection (host-only, fault-isolated) -------------------
    def _target_stats(self) -> Tuple[Optional[dict], Optional[str]]:
        t = self._target
        if t is None:
            return None, None
        try:
            return dict(t.stats()), None
        except Exception as e:                           # noqa: BLE001
            return None, repr(e)

    def health(self) -> Tuple[bool, Dict[str, Any]]:
        """Full health: every replica up, target not closed. A fleet
        with ANY poisoned replica answers 503 here (and 200 on
        ``/readyz`` while at least one replica still serves)."""
        t = self._target
        if t is None:
            return True, {"ok": True, "target": None}
        if getattr(t, "_closed", False):
            return False, {"ok": False, "reason": "target closed"}
        s, err = self._target_stats()
        if s is None:
            return False, {"ok": False, "reason": err}
        if "replicas_total" in s:
            unhealthy = [r["replica"] for r in s.get("replicas", ())
                         if not r.get("healthy")]
            ok = s["replicas_healthy"] == s["replicas_total"] \
                and not unhealthy
            return ok, {"ok": ok,
                        "replicas_healthy": s["replicas_healthy"],
                        "replicas_total": s["replicas_total"],
                        "unhealthy": unhealthy}
        return True, {"ok": True,
                      "queue_depth": s.get("queue_depth"),
                      "active_requests": s.get("active_requests")}

    def ready(self) -> Tuple[bool, Dict[str, Any]]:
        """Readiness: can the target still accept a submit? A degraded
        fleet (1 of 2 replicas poisoned) is NOT healthy but IS ready."""
        t = self._target
        if t is None:
            return True, {"ready": True, "target": None}
        if getattr(t, "_closed", False):
            return False, {"ready": False, "reason": "target closed"}
        s, err = self._target_stats()
        if s is None:
            return False, {"ready": False, "reason": err}
        if "replicas_total" in s:
            ok = s["replicas_healthy"] >= 1
            return ok, {"ready": ok,
                        "replicas_healthy": s["replicas_healthy"],
                        "replicas_total": s["replicas_total"]}
        return True, {"ready": True}

    def _recorders(self) -> Dict[str, Any]:
        """Replica-keyed flight recorders (fault-isolated)."""
        t = self._target
        if t is None:
            return {}
        if hasattr(t, "replicas"):
            out = {}
            for i, eng in enumerate(t.replicas):
                try:
                    out[str(i)] = eng.flight_recorder
                except Exception:                        # noqa: BLE001
                    continue
            return out
        rec = getattr(t, "flight_recorder", None)
        return {"0": rec} if rec is not None else {}

    def tracez(self) -> Dict[str, Any]:
        """The /tracez document: per-replica tail-sampled + recent
        traces, plus the SLO report when a tracker is attached."""
        engines: Dict[str, Any] = {}
        for key, rec in self._recorders().items():
            try:
                engines[key] = rec.tail_traces()
            except Exception as e:                       # noqa: BLE001
                engines[key] = {"error": repr(e)}
        doc: Dict[str, Any] = {"engines": engines}
        if self._slo is not None:
            try:
                doc["slo"] = self._slo.report()
            except Exception as e:                       # noqa: BLE001
                doc["slo"] = {"error": repr(e)}
        return doc

    def __repr__(self):
        return f"<OpsServer url={self.url} target={self._target!r}>"
