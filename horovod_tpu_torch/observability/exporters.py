"""Metric exporters: Prometheus text exposition, JSON snapshot, and the
opt-in rank-0 HTTP endpoint.

stdlib only (see the package docstring). The HTTP server is a plain
``http.server`` on a daemon thread — scraping a training job must never
require a new dependency — started by :func:`maybe_start_http_server` when
``HOROVOD_METRICS_PORT`` is set (``horovod_tpu_torch.init`` calls it on process
rank 0 only, mirroring the reference's coordinator-only Timeline).

Endpoints:

- ``/metrics`` — Prometheus text exposition format (scrape target)
- ``/metrics.json`` — the raw :func:`metrics.snapshot` as JSON
- ``/health`` — the resilience health-state-machine snapshot as JSON
  (HTTP 200 while HEALTHY/SUSPECT, 503 once DEGRADED or FATAL, so a plain
  liveness probe needs no JSON parsing)
"""

from __future__ import annotations

import json
import math
import re
import threading
from typing import Optional

from horovod_tpu_torch.observability import metrics as _metrics

__all__ = [
    "to_prometheus",
    "to_json",
    "emit_snapshot",
    "start_http_server",
    "stop_http_server",
    "maybe_start_http_server",
]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name: str) -> str:
    name = _NAME_RE.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _quote_label_value(v) -> str:
    """One label value escaped AND quoted per the exposition format:
    backslash, double quote, and newline (a raw newline inside a label
    value terminates the sample line mid-way and corrupts the whole scrape
    — every series after it is misparsed). The single escape point — the
    fleet exporter builds its ``stat=``/``rank=`` pairs through it too."""
    v = (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )
    return f'"{v}"'


def _prom_labels(key: str, extra: Optional[str] = None) -> str:
    """``"k=v,k2=v2"`` snapshot label key -> ``{k="v",k2="v2"}`` (empty
    string for no labels). ``extra`` is a pre-formatted ``le="..."`` pair."""
    pairs = []
    if key:
        for item in key.split(","):
            k, _, v = item.partition("=")
            pairs.append(
                f'{_LABEL_NAME_RE.sub("_", k)}={_quote_label_value(v)}'
            )
    if extra:
        pairs.append(extra)
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _fmt(v: float) -> str:
    f = float(v)
    if not math.isfinite(f):  # exposition spellings; int(inf) would raise
        return "NaN" if math.isnan(f) else ("+Inf" if f > 0 else "-Inf")
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def to_prometheus(snap: Optional[dict] = None) -> str:
    """Render a snapshot in Prometheus text exposition format (one
    ``# HELP``/``# TYPE`` header per family; histogram children expand to
    ``_bucket{le=...}``/``_sum``/``_count`` series)."""
    snap = _metrics.snapshot() if snap is None else snap
    lines = []
    for name in sorted(snap):
        fam = snap[name]
        pname = _prom_name(name)
        if fam.get("help"):
            esc = fam["help"].replace("\\", "\\\\").replace("\n", "\\n")
            lines.append(f"# HELP {pname} {esc}")
        lines.append(f"# TYPE {pname} {fam['type']}")
        for key in sorted(fam["samples"]):
            sample = fam["samples"][key]
            if fam["type"] == "histogram":
                for le, cum in sample["buckets"].items():
                    extra = 'le="' + le + '"'
                    lines.append(
                        f"{pname}_bucket{_prom_labels(key, extra)} {cum}"
                    )
                lines.append(
                    f"{pname}_sum{_prom_labels(key)} {_fmt(sample['sum'])}"
                )
                lines.append(
                    f"{pname}_count{_prom_labels(key)} {sample['count']}"
                )
            else:
                lines.append(f"{pname}{_prom_labels(key)} {_fmt(sample)}")
    return "\n".join(lines) + "\n" if lines else ""


def to_json(snap: Optional[dict] = None, *, indent: Optional[int] = None) -> str:
    """The snapshot as a JSON document (what ``MetricsCallback`` dumps and
    ``/metrics.json`` serves)."""
    return json.dumps(
        _metrics.snapshot() if snap is None else snap, indent=indent
    )


def emit_snapshot(dump_path: Optional[str], printer, header: str = "") -> None:
    """Shared emit step for the ``MetricsCallback`` twins: atomically write
    the JSON snapshot to ``dump_path`` when set, otherwise print the
    summary (prefixed with ``header``) through ``printer``."""
    import os

    if dump_path:
        tmp = dump_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(to_json(indent=1))
        os.replace(tmp, dump_path)
    else:
        printer(header + _metrics.summary())


_server = None
_server_lock = threading.Lock()


def start_http_server(port: int, host: str = ""):
    """Serve ``/metrics`` (Prometheus) and ``/metrics.json`` on a daemon
    thread; returns the ``HTTPServer`` (``.server_port`` holds the bound
    port — pass ``port=0`` for an ephemeral one). Idempotent per process:
    a second call returns the running server."""
    global _server
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    with _server_lock:
        if _server is not None:
            return _server

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                path = self.path.split("?", 1)[0]
                status = 200
                if path in ("/metrics", "/"):
                    body = to_prometheus().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif path == "/metrics.json":
                    body = to_json().encode()
                    ctype = "application/json"
                elif path in ("/fleet", "/fleet.json"):
                    # lazy import, same reason as /health below; 404 until
                    # a FleetAggregator registers (rank 0 of an aggregated
                    # job)
                    from horovod_tpu_torch.observability import aggregate as _agg

                    try:
                        text = (
                            _agg.fleet_json()
                            if path.endswith(".json")
                            else _agg.fleet_prometheus()
                        )
                    except Exception as e:
                        # the collect hits the rendezvous KV — during a KV
                        # restart the scrape must see a clean 503, not a
                        # dropped socket + handler traceback
                        self.send_error(
                            503, f"fleet aggregation failed: {e}")
                        return
                    if text is None:
                        self.send_error(404, "no fleet aggregator running")
                        return
                    body = text.encode()
                    ctype = (
                        "application/json"
                        if path.endswith(".json")
                        else "text/plain; version=0.0.4; charset=utf-8"
                    )
                elif path == "/health":
                    # lazy import: exporters must stay importable without
                    # dragging the resilience package in at module load
                    from horovod_tpu_torch.resilience import health as _health

                    snap = _health.snapshot()
                    body = json.dumps(snap, indent=1).encode()
                    ctype = "application/json"
                    if snap["value"] >= int(_health.HealthState.DEGRADED):
                        status = 503
                else:
                    self.send_error(404)
                    return
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # no per-scrape stderr spam
                pass

        _server = ThreadingHTTPServer((host, port), Handler)
        threading.Thread(
            target=_server.serve_forever,
            name="hvd-metrics-http",
            daemon=True,
        ).start()
        return _server


def stop_http_server() -> None:
    global _server
    with _server_lock:
        if _server is not None:
            _server.shutdown()
            _server.server_close()
            _server = None


def maybe_start_http_server():
    """Start the endpoint iff ``HOROVOD_METRICS_PORT`` is set to a valid
    port; returns the server or None. Never raises — observability must not
    take down init (a busy port logs and moves on)."""
    import logging
    import os

    port = os.environ.get("HOROVOD_METRICS_PORT")
    if not port:
        return None
    try:
        return start_http_server(int(port))
    except (ValueError, OSError) as e:
        logging.getLogger("horovod_tpu_torch.observability").warning(
            "could not start metrics endpoint on port %s: %s", port, e
        )
        return None
