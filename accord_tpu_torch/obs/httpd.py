"""Prometheus-style metrics endpoint for the wall-clock hosts.

`ACCORD_METRICS_PORT=<base>` on a host process serves:

    GET /metrics        Prometheus text exposition
    GET /metrics.json   the NodeObs snapshot (metrics + summary), JSON
    GET /flight         the node's flight-recorder tail (?limit=N), JSON
    GET /flight?txn=ID  one trace id's flight events on this node, JSON
    GET /audit          live replica-state auditor view (divergences,
                        last digest round, lifecycle census), JSON
    GET /top            protocol-CPU top-verbs waterfall + event-loop
                        health gauges (obs/cpuprof.py), JSON

Multi-process clusters on one machine offset the base port by the node id
(node N binds base + N - 1); base 0 binds an ephemeral port (recorded on
the returned server as `.port`).  The server runs on a daemon thread and
only READS the registry — snapshots tolerate concurrent mutation.
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional


class _Handler(BaseHTTPRequestHandler):
    server_version = "accord-obs/1"

    def log_message(self, fmt, *args):  # noqa: A003 — silence per-request
        pass

    def do_GET(self):  # noqa: N802 — http.server API
        obs = self.server.obs_provider()
        if self.path.startswith("/metrics.json"):
            body = json.dumps(obs.snapshot()).encode()
            ctype = "application/json"
        elif self.path.startswith("/flight"):
            from urllib.parse import parse_qs, urlparse
            qs = parse_qs(urlparse(self.path).query)
            txn = qs.get("txn", [None])[0]
            try:
                limit = int(qs.get("limit", ["200"])[0])
            except ValueError:
                limit = 200
            flight = obs.flight
            events = (flight.for_trace(txn) if txn
                      else flight.tail(limit))
            body = json.dumps({"node": obs.node_id, "txn": txn,
                               "recorded_total": flight.recorded_total,
                               "events": [list(e) for e in events]}).encode()
            ctype = "application/json"
        elif self.path.startswith("/top"):
            # protocol-CPU waterfall + loop health (obs/cpuprof.py): the
            # per-verb top table is live when ACCORD_CPU_PROFILE=N is set;
            # the loop gauges are always-on
            body = json.dumps(obs.cpu_view()).encode()
            ctype = "application/json"
        elif self.path.startswith("/audit"):
            # live replica-state auditor view (divergences, last digest
            # round, census) — {} when no Auditor is attached to this node
            view = obs.audit_view() if obs.audit_view is not None else {}
            body = json.dumps(view).encode()
            ctype = "application/json"
        elif self.path.startswith("/metrics"):
            body = obs.registry.render_prometheus().encode()
            ctype = "text/plain; version=0.0.4"
        else:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def start_metrics_server(obs_provider: Callable, port: int,
                         host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """Serve `obs_provider()` (a NodeObs) on `port` (0 = ephemeral).  The
    realised port is on the returned server as `.port`."""
    server = ThreadingHTTPServer((host, port), _Handler)
    server.daemon_threads = True
    server.obs_provider = obs_provider
    server.port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def maybe_start_from_env(obs_provider: Callable, node_id: int = 1,
                         env: str = "ACCORD_METRICS_PORT"
                         ) -> Optional[ThreadingHTTPServer]:
    """Start the endpoint when the env var is set; None otherwise (or when
    the bind fails — metrics must never take a node down)."""
    raw = os.environ.get(env, "")
    if not raw:
        return None
    try:
        base = int(raw)
        port = 0 if base == 0 else base + max(0, node_id - 1)
        return start_metrics_server(obs_provider, port)
    except (ValueError, OSError):
        return None
