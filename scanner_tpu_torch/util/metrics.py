"""Live cluster telemetry: a process-wide metrics registry.

The reference Scanner's observability is post-mortem only — per-thread
interval traces shipped to the master after a job finishes
(scanner/util/profiler.h; our util/profiler.py matches it).  This module
adds the live half: every process keeps one `MetricsRegistry` of
`Counter`/`Gauge`/`Histogram` series that hot paths update as they run,
and two consumers read it: `Client.metrics()`, and a stdlib-http
`MetricsServer` serving `/metrics` (Prometheus text exposition),
`/healthz`, `/readyz`, `/alertz` and `/statusz` (JSON) — off by
default, enabled per client by `Client(metrics_port=)`.  The cluster
master merges every node's snapshot (`merge_snapshots`, GetMetrics).

Design constraints, in order:

  1. Disabled-path cost ~zero.  Recording always happens (there is no
     global on/off — a gauge nobody scrapes is just a slot write), so
     the fast path must be cheap enough to sit on per-batch code:
     counter/histogram writes go to per-THREAD cells (no lock, no
     contention — the same append-only-per-thread trick as
     util/profiler.py) and are summed only at snapshot time.  Only
     child creation takes a lock.
  2. Names are contracts.  Every series name must match
     ``scanner_tpu_[a-z0-9_]+`` and carry a help string — dashboards
     break silently otherwise; tests/test_metrics.py lints the live
     registry.
  3. Snapshots are plain msgpack-able dicts so they travel over the
     existing RPC plane unchanged.
"""

from __future__ import annotations

import json
import re
import threading
import time
import weakref
from bisect import bisect_left
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

NAME_RE = re.compile(r"scanner_tpu_[a-z0-9_]+\Z")

# default histogram buckets: latency-shaped, 1ms..10s (upper bounds;
# the +Inf bucket is implicit)
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0)


class MetricsError(Exception):
    pass


# ---------------------------------------------------------------------------
# Metric children (one per label combination; hold the actual cells)
# ---------------------------------------------------------------------------

# once a child holds this many per-thread cells, cell registration (the
# slow path) folds dead-thread cells inline — an unscraped process that
# keeps spawning stage threads must not grow without bound just because
# nobody ever calls value()
_FOLD_THRESHOLD = 64


def _dead(owner) -> bool:
    t = owner() if owner is not None else None
    return owner is not None and (t is None or not t.is_alive())


class _CounterChild:
    """Monotonic float counter.  inc() writes a per-thread cell: the
    cell list is owned by one thread, so `cell[0] += n` never races —
    the lock-free fast path.  Cells of dead threads fold into a retained
    total at read time AND whenever a new cell registers past a size
    threshold, so neither scraped nor unscraped processes leak cells
    (owners are held by weakref — a dead cell must not pin its Thread)."""

    __slots__ = ("_local", "_cells", "_retained", "_lock")

    def __init__(self):
        self._local = threading.local()
        # (weakref-to-owning-thread, cell); owner=None is never folded
        self._cells: List[Tuple[Any, List[float]]] = []
        self._retained = 0.0
        self._lock = threading.Lock()

    def _fold_locked(self) -> None:
        live = []
        for owner, cell in self._cells:
            if _dead(owner):
                # the owner finished: its cell can never change again
                self._retained += cell[0]
            else:
                live.append((owner, cell))
        self._cells = live

    def inc(self, n: float = 1.0) -> None:
        try:
            self._local.cell[0] += n
        except AttributeError:
            cell = [0.0]
            with self._lock:
                if len(self._cells) >= _FOLD_THRESHOLD:
                    self._fold_locked()
                self._cells.append(
                    (weakref.ref(threading.current_thread()), cell))
            self._local.cell = cell
            cell[0] += n

    def value(self) -> float:
        with self._lock:
            self._fold_locked()
            return self._retained + sum(c[0] for _o, c in self._cells)


class _GaugeChild:
    """Point-in-time value.  set() is a single slot write; set_function
    defers to a callable sampled at snapshot time (live queue depths)."""

    __slots__ = ("_value", "_fn", "_lock")

    def __init__(self):
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        # single GIL-atomic slot store; only the read-modify-write
        # paths (inc/dec) need the lock
        self._value = float(v)  # scanner-check: disable=SC203

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    def set_function(self, fn: Optional[Callable[[], float]]) -> None:
        """Sample `fn()` at scrape time instead of a stored value; pass
        None to detach (the gauge reverts to its stored value).  Locked
        so clear_function's check-then-clear cannot race a new owner's
        install."""
        with self._lock:
            self._fn = fn

    def clear_function(self, expected: Callable[[], float]) -> bool:
        """Detach only if `expected` is still the installed sampler —
        a finished owner must not blind a newer one that re-bound the
        gauge (== so equal bound methods of one object match)."""
        with self._lock:
            if self._fn is not None and self._fn == expected:
                self._fn = None
                return True
            return False

    def value(self) -> float:
        fn = self._fn
        if fn is not None:
            try:
                return float(fn())
            except Exception:  # noqa: BLE001 — scrape must never raise
                return 0.0
        return self._value


class _HistCell:
    __slots__ = ("buckets", "sum", "count")

    def __init__(self, n_buckets: int):
        self.buckets = [0] * n_buckets
        self.sum = 0.0
        self.count = 0


class _HistogramChild:
    """Fixed-bucket histogram; per-thread cells (and dead-thread cell
    folding, both at read time and in the registration slow path) like
    _CounterChild."""

    __slots__ = ("_uppers", "_local", "_cells", "_retained", "_lock")

    def __init__(self, uppers: Sequence[float]):
        self._uppers = list(uppers)
        self._local = threading.local()
        self._cells: List[Tuple[Any, _HistCell]] = []
        self._retained = _HistCell(len(uppers) + 1)
        self._lock = threading.Lock()

    def _fold_locked(self) -> None:
        live = []
        for owner, cell in self._cells:
            if _dead(owner):
                self._add(self._retained, cell)
            else:
                live.append((owner, cell))
        self._cells = live

    def observe(self, v: float) -> None:
        try:
            cell = self._local.cell
        except AttributeError:
            cell = _HistCell(len(self._uppers) + 1)
            with self._lock:
                if len(self._cells) >= _FOLD_THRESHOLD:
                    self._fold_locked()
                self._cells.append(
                    (weakref.ref(threading.current_thread()), cell))
            self._local.cell = cell
        # Prometheus buckets are upper-INCLUSIVE: v <= le lands in the
        # bucket; bisect_left finds the first upper >= v, len(uppers)
        # means +Inf
        cell.buckets[bisect_left(self._uppers, v)] += 1
        cell.sum += v
        cell.count += 1

    @staticmethod
    def _add(dst: _HistCell, src: _HistCell) -> None:
        for i, b in enumerate(src.buckets):
            dst.buckets[i] += b
        dst.sum += src.sum
        dst.count += src.count

    def value(self) -> Dict[str, Any]:
        acc = _HistCell(len(self._uppers) + 1)
        with self._lock:
            self._fold_locked()
            self._add(acc, self._retained)
            for _owner, cell in self._cells:
                self._add(acc, cell)
        return {"buckets": acc.buckets, "sum": acc.sum, "count": acc.count}


_CHILD_CLS = {"counter": _CounterChild, "gauge": _GaugeChild}


class Metric:
    """One named series family; children per label combination.  An
    unlabeled metric delegates inc/set/observe to its single child."""

    def __init__(self, name: str, kind: str, help: str,
                 label_names: Sequence[str] = (),
                 buckets: Optional[Sequence[float]] = None):
        if not NAME_RE.fullmatch(name):
            raise MetricsError(
                f"metric name {name!r} must match {NAME_RE.pattern}")
        if not help or not help.strip():
            raise MetricsError(f"metric {name} needs a help string")
        self.name = name
        self.kind = kind
        self.help = help.strip()
        self.label_names = tuple(label_names)
        self.buckets = list(buckets if buckets is not None
                            else DEFAULT_BUCKETS) \
            if kind == "histogram" else None
        self._children: Dict[Tuple[str, ...], Any] = {}
        self._lock = threading.Lock()
        if not self.label_names:
            self._default = self._make_child()
            self._children[()] = self._default

    def _make_child(self):
        if self.kind == "histogram":
            return _HistogramChild(self.buckets)
        return _CHILD_CLS[self.kind]()

    def labels(self, **kv: str):
        if set(kv) != set(self.label_names):
            raise MetricsError(
                f"{self.name}: labels {sorted(kv)} != declared "
                f"{sorted(self.label_names)}")
        key = tuple(str(kv[k]) for k in self.label_names)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    child = self._make_child()
                    self._children[key] = child
        return child

    def remove_labels(self, **kv: str) -> None:
        """Drop one label combination's child (e.g. a departed worker's
        heartbeat-age gauge) so long-lived processes with churning label
        values don't grow the scrape output without bound."""
        if set(kv) != set(self.label_names):
            raise MetricsError(
                f"{self.name}: labels {sorted(kv)} != declared "
                f"{sorted(self.label_names)}")
        key = tuple(str(kv[k]) for k in self.label_names)
        with self._lock:
            self._children.pop(key, None)

    # unlabeled convenience delegates
    def inc(self, n: float = 1.0) -> None:
        self._default.inc(n)

    def set(self, v: float) -> None:
        self._default.set(v)

    def dec(self, n: float = 1.0) -> None:
        self._default.dec(n)

    def set_function(self, fn: Optional[Callable[[], float]]) -> None:
        self._default.set_function(fn)

    def clear_function(self, expected: Callable[[], float]) -> bool:
        return self._default.clear_function(expected)

    def observe(self, v: float) -> None:
        self._default.observe(v)

    def samples(self) -> List[dict]:
        with self._lock:
            items = list(self._children.items())
        out = []
        for key, child in items:
            labels = dict(zip(self.label_names, key))
            v = child.value()
            if self.kind == "histogram":
                out.append({"labels": labels, **v})
            else:
                out.append({"labels": labels, "value": v})
        return out


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

class MetricsRegistry:
    """Name -> Metric; registration is idempotent (module reloads and
    repeated constructors get the same series) but kind/labels must
    agree — silent redefinition is exactly the dashboard drift the
    name lint exists to prevent."""

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}
        self._lock = threading.Lock()

    def _register(self, name: str, kind: str, help: str,
                  labels: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if m.kind != kind or m.label_names != tuple(labels):
                    raise MetricsError(
                        f"metric {name} re-registered as {kind}"
                        f"{tuple(labels)} (was {m.kind}{m.label_names})")
                return m
            m = Metric(name, kind, help, labels, buckets)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str,
                labels: Sequence[str] = ()) -> Metric:
        return self._register(name, "counter", help, labels)

    def gauge(self, name: str, help: str,
              labels: Sequence[str] = ()) -> Metric:
        return self._register(name, "gauge", help, labels)

    def histogram(self, name: str, help: str, labels: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Metric:
        return self._register(name, "histogram", help, labels, buckets)

    def metrics(self) -> List[Metric]:
        with self._lock:
            return list(self._metrics.values())

    def snapshot(self) -> Dict[str, dict]:
        """All series as one plain (msgpack-able) dict:
        {name: {kind, help, [uppers], samples: [{labels, value|buckets+
        sum+count}]}}."""
        out: Dict[str, dict] = {}
        for m in self.metrics():
            entry: Dict[str, Any] = {"kind": m.kind, "help": m.help,
                                     "samples": m.samples()}
            if m.kind == "histogram":
                entry["uppers"] = list(m.buckets)
            out[m.name] = entry
        return out


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide registry (one per process, like the reference's
    per-process profiler)."""
    return _REGISTRY


def labeled_samples(snapshot: Dict[str, dict], series: str
                    ) -> Dict[str, float]:
    """Flatten one series of a snapshot to {sorted-label-json: value}.
    The stable keying the per-device utilization digests compare across
    runs and processes (bench.py `multichip`, tools/tpu_window.py, the
    tests/test_multichip.py equivalence suite): label order never leaks
    into the key, so `{"device": "tpu:3", "op": "Histogram"}` is the
    same sample wherever it was produced."""
    return {json.dumps(s["labels"], sort_keys=True): s["value"]
            for s in snapshot.get(series, {}).get("samples", [])}


# process start time: lets consumers turn since-start counter values
# into rates without a second poll (standard Prometheus practice)
_REGISTRY.gauge(
    "scanner_tpu_process_start_time_seconds",
    "Unix time this process's metrics registry was created.",
).set(time.time())


# ---------------------------------------------------------------------------
# Histogram quantile estimation (shared: SLO engine, bench, tools)
# ---------------------------------------------------------------------------

def histogram_quantile(uppers: Sequence[float],
                       buckets: Sequence[float],
                       q: float) -> Optional[float]:
    """Estimate the q-quantile from per-bucket counts (len(buckets) ==
    len(uppers) + 1; the extra final bucket is +Inf).  Linear
    interpolation inside the bucket containing the target rank — the
    same estimate PromQL's histogram_quantile makes.  Returns None for
    an empty histogram; observations landing in the +Inf bucket clamp
    to the highest finite upper bound (there is nothing to interpolate
    toward)."""
    total = float(sum(buckets))
    if total <= 0:
        return None
    target = q * total
    edges = [0.0] + list(uppers)
    acc = 0.0
    for i, c in enumerate(buckets):
        if acc + c >= target and c > 0:
            if i >= len(uppers):
                # +Inf bucket: clamp to the last finite bound
                return float(uppers[-1]) if uppers else None
            lo, hi = edges[i], uppers[i]
            return lo + (hi - lo) * (target - acc) / c
        acc += c
    return float(uppers[-1]) if uppers else None


def snapshot_histogram_quantiles(snapshot: Dict[str, dict], series: str,
                                 qs: Sequence[float] = (0.5, 0.9, 0.99)
                                 ) -> Dict[str, Any]:
    """Aggregate every sample of a histogram series in a (plain or
    merged) snapshot and estimate quantiles: {"count", "mean_s",
    "p50_s", ...}, or {} when the series is absent or empty.  The
    digest shape bench.py banks and tools consume."""
    e = snapshot.get(series)
    if not e or not e.get("samples"):
        return {}
    uppers = list(e.get("uppers") or [])
    buckets: Optional[List[float]] = None
    total, ssum = 0, 0.0
    for smp in e["samples"]:
        b = smp.get("buckets")
        if not b:
            continue
        if buckets is None:
            buckets = [0.0] * len(b)
        for i, v in enumerate(b):
            buckets[i] += v
        total += smp.get("count", 0)
        ssum += smp.get("sum", 0.0)
    if not buckets or not total:
        return {}
    out: Dict[str, Any] = {"count": int(total),
                           "mean_s": round(ssum / total, 4)}
    for q in qs:
        v = histogram_quantile(uppers, buckets, q)
        out[f"p{int(q * 100)}_s"] = round(v, 4) if v is not None else None
    return out


# ---------------------------------------------------------------------------
# Snapshot merging (master aggregates workers)
# ---------------------------------------------------------------------------

def merge_snapshots(by_node: Dict[str, Dict[str, dict]]) -> Dict[str, dict]:
    """Merge per-node snapshots into one cluster view: every sample gains
    a `node` label, so per-node series stay distinguishable (summing
    counters across nodes would hide exactly the per-worker skew live
    debugging is for)."""
    merged: Dict[str, dict] = {}
    for node, snap in by_node.items():
        for name, entry in snap.items():
            tgt = merged.get(name)
            if tgt is None:
                tgt = {k: v for k, v in entry.items() if k != "samples"}
                tgt["samples"] = []
                merged[name] = tgt
            for s in entry.get("samples", []):
                s2 = dict(s)
                s2["labels"] = {"node": str(node), **s.get("labels", {})}
                tgt["samples"].append(s2)
    return merged


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

def _esc_label(v: str) -> str:
    return str(v).replace("\\", r"\\").replace("\n", r"\n") \
        .replace('"', r'\"')


def _fmt_labels(labels: Dict[str, str], extra: str = "") -> str:
    parts = [f'{k}="{_esc_label(v)}"' for k, v in sorted(labels.items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_val(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def render_prometheus(snapshot: Dict[str, dict]) -> str:
    """Render a snapshot (plain or merged) as Prometheus text exposition
    version 0.0.4."""
    lines: List[str] = []
    for name in sorted(snapshot):
        entry = snapshot[name]
        kind = entry["kind"]
        lines.append(f"# HELP {name} "
                     + entry.get("help", "").replace("\n", " "))
        lines.append(f"# TYPE {name} {kind}")
        for s in entry.get("samples", []):
            labels = s.get("labels", {})
            if kind == "histogram":
                uppers = entry.get("uppers", [])
                cum = 0
                for upper, b in zip(list(uppers) + ["+Inf"],
                                    s.get("buckets", [])):
                    cum += b
                    le = "+Inf" if upper == "+Inf" else _fmt_val(upper)
                    le_label = 'le="' + le + '"'
                    lines.append(
                        f"{name}_bucket"
                        f"{_fmt_labels(labels, le_label)} {cum}")
                lines.append(f"{name}_sum{_fmt_labels(labels)} "
                             f"{_fmt_val(s.get('sum', 0.0))}")
                lines.append(f"{name}_count{_fmt_labels(labels)} "
                             f"{int(s.get('count', 0))}")
            else:
                lines.append(f"{name}{_fmt_labels(labels)} "
                             f"{_fmt_val(s.get('value', 0.0))}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# HTTP endpoint (stdlib only; one daemon thread per server)
# ---------------------------------------------------------------------------

class MetricsServer:
    """Serves /metrics (Prometheus text), /healthz, /readyz, /alertz
    and /statusz (JSON) on a daemon thread.  Off unless a process
    explicitly constructs one (`Client(metrics_port=)`); port=0 binds an
    ephemeral port (see `.port`).  Binds loopback by default — the
    endpoint is unauthenticated and /statusz names db paths.

    /healthz reflects the health engine's roll-up (util/health.py) in
    its BODY (`status`, reason codes; `ok` flips false on `unhealthy`)
    but always answers 200 while the process is alive — it is the
    liveness surface, and alert states are workload facts a restart
    cannot fix.  /readyz is the gate that goes 503 while the roll-up
    is `unhealthy` or `ready()` is false (a SIGTERM drain: not-ready,
    still-alive), so k8s stops routing instead of restarting.
    /alertz serves the firing alerts plus the full rule table."""

    def __init__(self, port: int = 0,
                 reg: Optional[MetricsRegistry] = None,
                 statusz: Optional[Callable[[], dict]] = None,
                 healthz: Optional[Callable[[], dict]] = None,
                 host: str = "127.0.0.1",
                 health: Optional[Callable[[], dict]] = None,
                 ready: Optional[Callable[[], bool]] = None,
                 alertz: Optional[Callable[[], dict]] = None):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        reg = reg or registry()
        outer = self
        self._statusz = statusz
        self._healthz = healthz
        self._health = health
        self._ready = ready
        self._alertz = alertz

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence per-request stderr spam
                pass

            def _send(self, code: int, ctype: str, body: bytes) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 (stdlib handler API)
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        body = render_prometheus(reg.snapshot()).encode()
                        self._send(200, "text/plain; version=0.0.4; "
                                        "charset=utf-8", body)
                    elif path == "/healthz":
                        extra = outer._healthz() if outer._healthz else {}
                        roll = outer._health_rollup()
                        # ALWAYS 200 while the process can answer:
                        # /healthz is the LIVENESS surface, and alert
                        # states (HBM pressure, latency burn) are
                        # workload facts a restart cannot fix — a 503
                        # here would restart-loop pods under legitimate
                        # sustained load.  The body still carries the
                        # roll-up (ok=false on `unhealthy`) for humans
                        # and scripts; /readyz is the surface that
                        # goes 503 so k8s stops ROUTING instead.
                        ok = roll.get("status", "ok") != "unhealthy"
                        self._send(200, "application/json",
                                   json.dumps({"ok": ok, **roll,
                                               **extra}).encode())
                    elif path == "/readyz":
                        roll = outer._health_rollup()
                        rdy = roll.get("status", "ok") != "unhealthy"
                        if rdy and outer._ready is not None:
                            rdy = bool(outer._ready())
                        self._send(200 if rdy else 503,
                                   "application/json",
                                   json.dumps({"ready": rdy, **roll})
                                   .encode())
                    elif path == "/alertz":
                        body = outer._alertz_body()
                        self._send(200, "application/json",
                                   json.dumps(body, default=str)
                                   .encode())
                    elif path == "/statusz":
                        st = outer._statusz() if outer._statusz else {}
                        self._send(200, "application/json",
                                   json.dumps(st, default=str).encode())
                    else:
                        self._send(404, "text/plain", b"not found\n")
                except Exception as e:  # noqa: BLE001 — a scrape bug
                    # must not kill the serving thread
                    try:
                        self._send(500, "text/plain",
                                   f"{type(e).__name__}: {e}\n".encode())
                    except Exception:  # noqa: BLE001
                        pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics-http",
            daemon=True)
        self._thread.start()

    def _health_rollup(self) -> dict:
        """status + reason codes for /healthz and /readyz: the injected
        callback, or the process-wide health engine's roll-up (lazy
        import — health builds on this module)."""
        try:
            if self._health is not None:
                return self._health()
            from . import health as _health
            return _health.rollup()
        except Exception:  # noqa: BLE001 — a health bug must not make
            # the liveness probe lie about the process being alive
            return {"status": "ok", "reasons": []}

    def _alertz_body(self) -> dict:
        try:
            if self._alertz is not None:
                return self._alertz()
            from . import health as _health
            return _health.alertz_dict()
        except Exception as e:  # noqa: BLE001
            return {"status": "ok", "error": f"{type(e).__name__}: {e}"}

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
