"""Client: the user entry point.

Capability parity: reference scannerpy/client.py (Client:58, run:1282,
ingest_videos:965, new_table:418, table:500, summarize:548) — here the
single-node path runs in-process on the client's device;
engine/service.py provides the master/worker cluster path behind the
same API (`Client(master="host:port")`), where the workers' devices run
the tasks.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Union

import torch

from ..common import CacheMode, PerfParams, ScannerException
from ..graph import ops as O
from ..graph.streams_dsl import IOGenerator, StreamsGenerator, TaskPartitioner
from ..storage import Database, make_storage
from ..storage import metadata as md
from ..storage.streams import NamedStream, NamedVideoStream
from ..util import health as _health
from ..util.profiler import Profile, Profiler
from . import controller as _controller
from .evaluate import default_pipeline_instances, resolve_device
from .executor import LocalExecutor


class Table:
    """Read handle on a stored table (reference table.py:11)."""

    def __init__(self, db: Database, name: str):
        self._db = db
        self._name = name

    def id(self) -> int:
        return self._db.table_descriptor(self._name).id

    def name(self) -> str:
        return self._name

    def num_rows(self) -> int:
        return self._db.table_descriptor(self._name).num_rows

    def column_names(self) -> List[str]:
        return self._db.table_descriptor(self._name).column_names()

    def column(self, name: str):
        desc = self._db.table_descriptor(self._name)
        if desc.column_type(name) == md.ColumnType.VIDEO:
            s = NamedVideoStream(self._db, self._name)
        else:
            s = NamedStream(self._db, self._name)
            if name != "output":
                # direct column access bypasses the default-column logic
                return _ColumnReader(self._db, self._name, name)
        return s

    def committed(self) -> bool:
        return self._db.table_is_committed(self._name)


class _ColumnReader:
    def __init__(self, db: Database, table: str, column: str):
        self._stream = NamedStream(db, table)
        self._column = column

    def load(self, rows: Optional[Sequence[int]] = None):
        yield from self._stream.load(rows=rows, column=self._column)


class Client:
    """Create one per database.

    sc = Client(db_path="/data/db")            # runs on the CUDA card
    frames = sc.io.Input([NamedVideoStream(sc, "movie", path="m.mp4")])
    hist = sc.ops.Histogram(frame=frames)
    sc.run(sc.io.Output(hist, [NamedStream(sc, "hists")]), PerfParams.estimate())

    `device` is where device ops run: "cuda" (the default), "cuda:N",
    "cpu", or a torch.device.  Asking for a card when none is present
    raises; the client never moves to the CPU on its own.  A cluster
    client (`master="host:port"`) runs no device op: each worker's own
    `device` decides, so a cluster client takes no `device`.
    `workers` is accepted for the reference's signature and unused (the
    workers dial the master).  `config_path` reads a TOML config
    (config.py, the JAX package's format).
    """

    def __init__(self, db_path: Optional[str] = None,
                 storage_type: Optional[str] = None,
                 device: Union[str, torch.device, None] = None,
                 master: Optional[str] = None,
                 workers: Optional[List[str]] = None,
                 num_load_workers: int = 2,
                 num_save_workers: int = 2,
                 # None = resolve at job launch: one instance per card on
                 # multi-card hosts.  An explicit value — including 1 —
                 # always wins.
                 pipeline_instances: Optional[int] = None,
                 decoder_threads: int = 1,
                 config_path: Optional[str] = None,
                 storage_options: Optional[Dict[str, Any]] = None,
                 metrics_port: Optional[int] = None,
                 **kw):
        """`metrics_port` serves /metrics, /healthz, /readyz, /alertz and
        /statusz on loopback (util/metrics.py MetricsServer; 0 binds an
        ephemeral port, see `self._metrics_server.port`); None serves
        nothing.  Extra keywords go to the cluster client
        (service.ClusterClient: enable_watchdog, poll_interval,
        master_down_timeout)."""
        if config_path is not None:
            from ..config import Config
            cfg = Config(config_path)
            db_path = db_path or cfg.db_path
            _apply_config(cfg)
            # explicit argument beats config beats default
            storage_type = storage_type or cfg.storage_type
            if master is None:
                master = cfg.master_address
            if metrics_port is None:
                metrics_port = cfg.metrics_port
        if master is not None and device is not None:
            raise ScannerException(
                "a cluster client runs no device op: pass device= to "
                "each Worker, not to Client(master=...)")
        self.device = None if master is not None \
            else resolve_device(device or "cuda")
        storage_type = storage_type or "posix"
        if db_path is None and storage_type == "posix":
            db_path = os.path.expanduser("~/.scanner_tpu/db")
        self._db = Database(make_storage(storage_type, db_path=db_path,
                                         **(storage_options or {})))
        self._db.load_megafile()
        self._profiler = Profiler(node="client")
        self._job_profiles: Dict[int, List[Profiler]] = {}
        # job id -> {"trace_id", "bulk_id"} for Client.trace()
        self._job_traces: Dict[int, Dict[str, Any]] = {}
        self._next_job_id = 0
        self._master_address = master
        self._cluster = None
        if master is not None:
            from .service import ClusterClient
            self._cluster = ClusterClient(master, db=self._db, **kw)
        self.ops = O.OpGenerator()
        self.streams = StreamsGenerator()
        self.io = IOGenerator(self)
        self.partitioner = TaskPartitioner()
        # None stays None here (the per-job resolution in run() reads
        # it); the long-lived executor itself just needs a concrete int
        self._pipeline_instances_arg = pipeline_instances
        self._executor = None if master is not None else LocalExecutor(
            self._db, self._profiler, self.device,
            num_load_workers=num_load_workers,
            num_save_workers=num_save_workers,
            pipeline_instances=pipeline_instances or 1,
            decoder_threads=decoder_threads)
        # live telemetry endpoint — strictly opt-in; port 0 binds an
        # ephemeral port
        self._metrics_server = None
        if metrics_port is not None:
            from ..util import coststats as _coststats
            from ..util import memstats as _memstats
            from ..util.metrics import MetricsServer
            from . import framecache as _framecache
            self._metrics_server = MetricsServer(
                port=metrics_port,
                statusz=lambda: {"role": "client",
                                 "master": self._master_address,
                                 "db": getattr(self._db.backend, "root",
                                               None),
                                 "device": str(self.device),
                                 "health": _health.status_dict(),
                                 "memory": _memstats.status_dict(),
                                 "framecache":
                                     _framecache.status_dict(),
                                 "efficiency":
                                     _coststats.status_dict(),
                                 "remediation":
                                     _controller.status_dict()},
                healthz=lambda: {"role": "client"})
        # health/SLO engine (util/health.py) and the remediation
        # controller (engine/controller.py): local runs get the same
        # judgment and the playbooks this process can act on; no-ops
        # under SCANNER_TPU_HEALTH=0 / SCANNER_TPU_REMEDIATION=0
        _health.ensure_started()
        _controller.ensure_started()

    # -- context manager ----------------------------------------------------

    def __enter__(self) -> "Client":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def stop(self) -> None:
        """Stop the telemetry server and the cluster channel, if any."""
        if self._cluster is not None:
            self._cluster.close()
        if self._metrics_server is not None:
            self._metrics_server.stop()
            self._metrics_server = None

    # -- live telemetry -----------------------------------------------------

    def job_status(self, bulk_id: Optional[int] = None) -> Dict[str, Any]:
        """Cluster job status (GetJobStatus): live progress of the given
        (default: active) bulk, plus `num_workers` even when no bulk is
        active — lets tooling wait for worker registration.  Cluster
        mode only."""
        if self._cluster is None:
            raise ScannerException(
                "job_status requires cluster mode (Client(master=...))")
        return self._cluster.job_status(bulk_id)

    def health(self) -> Dict[str, Any]:
        """Health roll-up (util/health.py), worst-of `ok|degraded|
        unhealthy` with reason codes and firing alerts.  Cluster mode:
        the master's GetHealth view across master + every live worker.
        Local mode: this process's engine under nodes["client"]."""
        if self._cluster is not None:
            return self._cluster.health()
        return _health.merge_status({"client": _health.status_dict()})

    def metrics(self) -> Dict[str, Any]:
        """Live metrics snapshot.  Cluster mode: the master's aggregated
        view (master + every live worker, each sample node-labeled).
        Local mode: this process's registry under node="client"
        (docs/observability.md has the series catalog)."""
        if self._cluster is not None:
            return self._cluster.metrics()
        from ..util.metrics import merge_snapshots, registry
        return merge_snapshots({"client": registry().snapshot()})

    def memory_report(self) -> Dict[str, Any]:
        """Memory forensics (util/memstats.py).  Cluster mode: the
        master's GetMemoryReport view, with every OOM report the
        workers shipped.  Local mode: this process's live device-memory
        and allocation-ledger view, and its last out-of-memory report,
        if any."""
        if self._cluster is not None:
            return self._cluster.memory_report()
        from ..util import memstats
        last = memstats.last_report()
        return {"memory": memstats.status_dict(),
                "reports": [last] if last else []}

    def compile_report(self) -> Dict[str, Any]:
        """Compute-efficiency report (util/coststats.py): this process's
        compile ledger (op, device, bucket, library builds and CUDA
        graph captures with their seconds), its summary, and the
        per-(op, device, bucket) roofline table, under
        nodes["client"]; cluster mode: the master's GetCompileLedger
        view, per node."""
        if self._cluster is not None:
            return self._cluster.compile_report()
        from ..util import coststats
        return {"nodes": {"client": coststats.compile_report()}}

    def shutdown_cluster(self, workers: bool = True) -> int:
        """Remotely stop the cluster this client is attached to: the
        master forwards Shutdown to every registered worker (unless
        workers=False), then stops itself — blocking start_master /
        start_worker processes exit 0.  Returns the number of workers
        that acknowledged.  Cluster mode only."""
        if self._cluster is None:
            raise ScannerException(
                "shutdown_cluster requires cluster mode "
                "(Client(master=...))")
        return self._cluster.shutdown_cluster(workers=workers)

    # -- data management ----------------------------------------------------

    def ingest_videos(self, named_paths: Sequence, inplace: bool = False,
                      force: bool = False):
        """Ingest videos as tables; returns (descriptors, failures) where
        failures is [(path, reason)] — a corrupt file is reported, not
        raised, so it cannot abort a corpus ingest (reference
        client.py:965 / ingest.cpp:872 failed_videos)."""
        from ..video import ingest_videos
        return ingest_videos(self._db, named_paths, inplace=inplace,
                             force=force)

    def ingest_images(self, name: str, paths: Sequence[str]):
        from ..video.ingest import ingest_images
        return ingest_images(self._db, name, paths)

    def load_op(self, module_path: str, name: Optional[str] = None):
        """Load a user op library: a Python module whose import registers
        ops via @register_op (the TPU-native analogue of the reference's
        dynamic .so op libraries, client.py:514 load_op)."""
        import hashlib
        import importlib.util
        import sys
        real = os.path.realpath(module_path)
        # unique module name per file path: never collides with stdlib or
        # a second op library of the same basename
        digest = hashlib.md5(real.encode()).hexdigest()[:8]
        base = os.path.splitext(os.path.basename(real))[0]
        mod_name = name or f"scanner_tpu_userops_{base}_{digest}"
        if mod_name in sys.modules:
            return sys.modules[mod_name]
        spec = importlib.util.spec_from_file_location(mod_name, module_path)
        if spec is None or spec.loader is None:
            raise ScannerException(f"cannot load op module: {module_path}")
        mod = importlib.util.module_from_spec(spec)
        # register before exec so pickled objects from the module resolve
        # in other processes (workers load_op the same path)
        sys.modules[mod_name] = mod
        try:
            spec.loader.exec_module(mod)
        except Exception:
            sys.modules.pop(mod_name, None)
            raise
        return mod

    def batch_load(self, streams: Sequence, rows=None, workers: int = 4):
        """Load several streams concurrently (reference Client.batch_load,
        client.py:1270 multiprocessing pool -> thread pool here: the
        decode path releases the GIL in C)."""
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=workers) as pool:
            return list(pool.map(
                lambda s: list(s.load(rows=rows)), streams))

    def new_table(self, name: str, columns: Sequence[str],
                  rows: Sequence[Sequence[Any]],
                  overwrite: bool = False,
                  codecs: Optional[Dict[str, str]] = None) -> Table:
        """Create and commit a table from in-memory rows (row-major).
        `codecs` maps a column to its row codec ("raw" by default;
        "pickle" columns hold pickled python objects, e.g. frames)."""
        self._db.new_table(name, columns, rows, overwrite=overwrite,
                           codecs=codecs)
        return Table(self._db, name)

    def table(self, name: str) -> Table:
        if not self._db.has_table(name):
            raise ScannerException(f"no such table: {name}")
        return Table(self._db, name)

    def has_table(self, name: str) -> bool:
        return self._db.has_table(name)

    def delete_table(self, name: str) -> None:
        self._db.delete_table(name)

    def summarize(self) -> str:
        lines = ["table                          rows  committed"]
        for name in self._db.list_tables():
            try:
                desc = self._db.table_descriptor(name)
                lines.append(f"{name:28} {desc.num_rows:6}  "
                             f"{self._db.table_is_committed(name)}")
            except Exception:
                lines.append(f"{name:28}      ?  ?")
        out = "\n".join(lines)
        print(out)
        return out

    # -- execution ----------------------------------------------------------

    def run(self, outputs: Union[O.OpNode, Sequence[O.OpNode]],
            perf_params: Optional[PerfParams] = None,
            cache_mode: CacheMode = CacheMode.Error,
            show_progress: bool = True,
            profiling: bool = True,
            task_timeout: float = 0.0,
            **kw) -> int:
        """Execute a job set — on this client's device, or on the
        cluster's workers in cluster mode; returns a job id usable with
        get_profile and trace."""
        if isinstance(outputs, O.OpNode):
            outputs = [outputs]
        perf = perf_params or PerfParams.estimate()
        if task_timeout:
            perf.task_timeout = task_timeout
        job_id = self._next_job_id
        self._next_job_id += 1
        if self._cluster is not None:
            # the job's root trace span: NewJob (and the status polls)
            # run under it, so the master admits the bulk with this
            # trace_id and every worker task span chains back here
            from ..util import tracing as _tr
            tracer = _tr.default_tracer()
            root = _tr.open_span(tracer, "job", mode="cluster")
            try:
                with _tr.use_span(tracer, root):
                    profs = self._cluster.run(outputs, perf, cache_mode,
                                              show_progress)
            finally:
                _tr.close_span(tracer, root)
                # contribute the root span so the master's assembled
                # trace is self-contained
                if root is not None \
                        and self._cluster.last_bulk_id is not None:
                    self._cluster.ship_spans(
                        self._cluster.last_bulk_id,
                        tracer.spans_for_trace(root.trace_id))
            self._job_profiles[job_id] = profs
            self._job_traces[job_id] = {
                "trace_id": root.trace_id if root else None,
                "bulk_id": self._cluster.last_bulk_id}
            return job_id
        prof = Profiler(node=f"job{job_id}")
        # gang mode needs a cluster to co-schedule across: a local
        # (in-process) run IS a single host, so gang_hosts degrades to
        # ordinary execution — the degenerate 1-host gang
        if int(getattr(perf, "gang_hosts", 0) or 0):
            import logging
            logging.getLogger("scanner_tpu_torch.engine").info(
                "gang_hosts=%d requested on a local run: executing as "
                "a single-host job (gang scheduling needs "
                "Client(master=...))", perf.gang_hosts)
        # instance-count resolution: explicit kwarg > PerfParams >
        # explicit Client(pipeline_instances=) — any of which wins as
        # given, including 1 — and only a fully-unset count resolves to
        # one instance per card on multi-card hosts
        ex = LocalExecutor(
            self._db, prof, self.device,
            num_load_workers=self._executor.num_load_workers,
            num_save_workers=self._executor.num_save_workers,
            decoder_threads=self._executor.decoder_threads,
            pipeline_instances=kw.get(
                "pipeline_instances",
                default_pipeline_instances(
                    perf.pipeline_instances_per_node
                    or self._pipeline_instances_arg, self.device)))
        ex.run(outputs, perf, cache_mode=cache_mode,
               show_progress=show_progress)
        self._job_profiles[job_id] = [prof]
        self._job_traces[job_id] = {"trace_id": ex.last_trace_id,
                                    "bulk_id": None}
        return job_id

    def load_frames(self, table: str, rows, column: str = "frame"):
        """Decode exact frames of a stored video stream (public accessor
        for the client-side read path, reference storage.py load)."""
        from ..video import load_frames
        return load_frames(self._db, table, rows, column)

    def get_profile(self, job_id: int) -> Profile:
        if job_id not in self._job_profiles:
            raise ScannerException(f"no profile for job {job_id}")
        return Profile(self._job_profiles[job_id])

    def trace(self, job_id: int, path: Optional[str] = None,
              raw_clocks: bool = False) -> str:
        """Write the finished job's span tree (job root → task → stage →
        op) as one Perfetto/Chrome trace, plus any device timeline
        captured at profiler_level >= 2 (util/torchprof.py; cluster
        profiles carry their device events inline); returns the path
        written.  In cluster mode the master assembles the tree across
        hosts, with remote spans rebased onto master time by the
        per-node clock offsets (util/clocksync.py) unless
        raw_clocks=True keeps each host's own stamps."""
        from ..util import tracing as _tr
        info = self._job_traces.get(job_id)
        if info is None or not info.get("trace_id"):
            raise ScannerException(
                f"no trace for job {job_id} (was tracing disabled? "
                "SCANNER_TPU_TRACING)")
        if self._cluster is not None and info.get("bulk_id") is not None:
            reply = self._cluster.get_trace(info["bulk_id"],
                                            raw_clocks=raw_clocks)
            # the run already shipped this process's root span; merge
            # the flight recorder anyway (dedup by span id) in case
            # that best-effort ship was lost
            by_id = {d["span_id"]: d for d in reply.get("spans") or []}
            for d in _tr.default_tracer().spans_for_trace(
                    info["trace_id"]):
                by_id.setdefault(d["span_id"], d)
            spans = list(by_id.values())
        else:
            spans = _tr.default_tracer().spans_for_trace(info["trace_id"])
            # local spans come from the bounded flight recorder: a big
            # job can evict its own early spans (incl. the root) — say
            # so instead of writing a silently partial trace
            if not any(d["name"] == "job" for d in spans):
                import logging
                logging.getLogger("scanner_tpu_torch.tracing").warning(
                    "trace for job %d is partial: the flight recorder "
                    "(SCANNER_TPU_TRACE_RING) evicted its earliest "
                    "spans, including the root", job_id)
        from ..util.torchprof import DEVICE_PID_BASE, load_device_events
        dev: List[Dict[str, Any]] = []
        base = DEVICE_PID_BASE
        for p in self._job_profiles.get(job_id, []):
            for rec in getattr(p, "device_traces", []):
                got = load_device_events(rec, pid_base=base)
                dev.extend(got)
                if got:
                    base += 1000
        path = path or f"scanner_trace_job{job_id}.json"
        return _tr.write_chrome_trace(spans, path, device_events=dev)

    def stragglers(self, job_id: int) -> Dict[str, Any]:
        """Straggler analytics for a job: per-stage span stats + the
        top-N slowest tasks with their trace ids.  Cluster mode reads
        the master's summary; local mode computes it from this process's
        flight recorder."""
        from ..util import tracing as _tr
        info = self._job_traces.get(job_id)
        if info is None or not info.get("trace_id"):
            raise ScannerException(f"no trace for job {job_id}")
        if self._cluster is not None and info.get("bulk_id") is not None:
            reply = self._cluster.get_trace(info["bulk_id"])
            return reply.get("stragglers") or {}
        return _tr.straggler_summary(
            _tr.default_tracer().spans_for_trace(info["trace_id"]))


def _apply_config(cfg) -> None:
    """Install a config's process-wide defaults (tracing, clock sync,
    memory accounting, frame cache, fusion, alerts, journal, gang,
    control shards, remediation, fault plan).  Each SCANNER_TPU_* env
    var, read at import, is the per-process override and wins."""
    env = os.environ.get
    from ..graph import fusion
    from ..util import clocksync, faults, memstats, tracing
    from . import framecache, gang, journal, shardmap
    if not env("SCANNER_TPU_TRACING"):
        tracing.set_enabled(cfg.tracing_enabled)
    if not env("SCANNER_TPU_CLOCKSYNC"):
        clocksync.set_enabled(cfg.clocksync_enabled)
    clocksync.set_rebase_enabled(cfg.rebase_clocks)
    if not env("SCANNER_TPU_MEMSTATS"):
        memstats.set_enabled(cfg.memstats_enabled)
    memstats.set_report_top_n(cfg.memstats_report_top_n)
    if not env("SCANNER_TPU_FRAME_CACHE"):
        framecache.set_enabled(cfg.frame_cache_enabled)
    framecache.set_capacity_mb(cfg.frame_cache_mb)
    framecache.set_page_frames(cfg.frame_cache_page_frames)
    if not env("SCANNER_TPU_FUSION"):
        fusion.set_enabled(cfg.fusion_enabled)
    fusion.set_min_chain(cfg.fusion_min_chain)
    if not env("SCANNER_TPU_HEALTH"):
        _health.set_enabled(cfg.alerts_enabled)
    if not env("SCANNER_TPU_JOURNAL"):
        journal.set_enabled(cfg.journal_enabled)
    if not env("SCANNER_TPU_JOURNAL_ROTATE"):
        journal.set_rotate_records(cfg.journal_rotate_records)
    if not env("SCANNER_TPU_GANG"):
        gang.set_enabled(cfg.gang_enabled)
    if not env("SCANNER_TPU_GANG_INIT_TIMEOUT"):
        gang.set_init_timeout_s(cfg.gang_init_timeout_s)
    if not env("SCANNER_TPU_GANG_FORM_TIMEOUT"):
        gang.set_form_timeout_s(cfg.gang_form_timeout_s)
    if not env("SCANNER_TPU_GANG_SHARDED"):
        gang.set_sharded(cfg.gang_sharded)
    if not env("SCANNER_TPU_GANG_HALO"):
        gang.set_halo(cfg.gang_halo_exchange)
    if not env("SCANNER_TPU_CONTROL_SHARDS"):
        shardmap.set_num_shards(cfg.control_shards)
    if not env("SCANNER_TPU_REMEDIATION"):
        _controller.set_enabled(cfg.remediation_enabled)
    _controller.set_dry_run(cfg.remediation_dry_run)
    _controller.set_autoscale_bounds(*cfg.remediation_autoscale_bounds)
    # applied in both directions: a config with rules="" CLEARS user
    # rules an earlier config installed
    _health.configure(cfg.alert_rules)
    if cfg.faults_plan and not env("SCANNER_TPU_FAULTS"):
        faults.install(cfg.faults_plan)
