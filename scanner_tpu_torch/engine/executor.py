"""Single-node pipelined job executor.

Capability parity: reference worker-side pipeline (worker.cpp:1467-1724
thread spawn; load_worker/evaluate_worker/save_worker stage loops) minus
the RPC shell, which engine/service.py adds for the distributed path.

Stages, connected by bounded queues (reference runtime.h:81-90):

    task list -> [loader xL] -> [evaluator xP] -> [saver xS] -> commit

Loaders read item bytes / decode exact frame sets (C++ releases the GIL, so
loader threads overlap evaluator Python/torch time).  Each evaluator thread is
one pipeline instance owning its kernel set.  Savers H.264-encode video
outputs and write column items.  Tasks are self-contained (warmup rows are
re-derived per task), so any instance may take any task.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common import (CacheMode, DeviceType, JobException, NullElement,
                      PerfParams, ScannerException)
from ..graph import analysis as A
from ..graph import ops as O
from ..storage import Database
from ..storage import items as IT
from ..storage import metadata as md
from ..storage.streams import NamedVideoStream, StoredStream
from ..util import faults as _faults
from ..util import health as _health
from ..util import metrics as _mx
from ..util import tracing as _tr
from ..util.log import get_logger
from ..util.profiler import Profiler
from ..util.torchprof import device_trace
from . import controller as _controller
from . import framecache as _fc
from .batch import ColumnBatch, concat_batches, pinned_empty
from .evaluate import (StateCarryMiss, TaskEvaluator, assigned_device,
                       device_label)

# live pipeline telemetry (docs/observability.md).  Queue depths answer
# the round-3 attribution question ("which stage starves?") in real
# time: a full evaluate queue + idle save queue = compute-bound, etc.
_M_QDEPTH = _mx.registry().gauge(
    "scanner_tpu_stage_queue_depth",
    "Tasks currently queued ahead of a pipeline stage (live; sampled "
    "at scrape time from the bounded inter-stage queues).",
    labels=["stage"])
_M_STAGE_SECONDS = _mx.registry().counter(
    "scanner_tpu_stage_seconds_total",
    "Wall seconds spent in each pipeline stage across all stage threads.",
    labels=["stage"])
_M_STAGE_TASKS = _mx.registry().counter(
    "scanner_tpu_stage_tasks_total",
    "Tasks completed per pipeline stage.",
    labels=["stage"])
_M_CHUNK_WAIT = _mx.registry().counter(
    "scanner_tpu_chunk_wait_seconds_total",
    "Evaluator seconds spent waiting on loader chunk production "
    "(work-packet streaming starvation; mirrors evaluate:chunk_wait "
    "trace intervals).")
_M_DECODED = _mx.registry().counter(
    "scanner_tpu_decoded_frames_total",
    "Video frames decoded and delivered to the pipeline, per loader "
    "thread.",
    labels=["loader"])
_M_DECODE_SECONDS = _mx.registry().counter(
    "scanner_tpu_decode_seconds_total",
    "Seconds spent decoding video frames, per loader thread.",
    labels=["loader"])
# per-chip utilization under evaluator affinity: every chip of a
# multi-device host should take tasks and accumulate busy seconds; a
# chip stuck at zero while siblings climb = an instance wedged or an
# assignment bug ("default" = affinity off / single device)
_M_DEV_TASKS = _mx.registry().counter(
    "scanner_tpu_device_tasks_total",
    "Tasks evaluated per assigned device (pipeline-instance affinity: "
    "instance i stages and runs on chip i mod n_devices).",
    labels=["device"])
_M_DEV_BUSY = _mx.registry().counter(
    "scanner_tpu_device_busy_seconds_total",
    "Evaluate-stage wall seconds per assigned device — the per-chip "
    "utilization series (busy/elapsed per chip ~ affinity efficiency).",
    labels=["device"])
# end-to-end per-task latency: enqueue (task runnable — local admission
# or master bulk admission) to sink-committed.  The seed for
# serving-mode p50/p99 (ROADMAP item 2): under a request-shaped
# workload each "task" is a request and this histogram IS the latency
# SLO series.  Observed by the committing side only — the local saver,
# or the master at FinishedWork — so cluster runs never double-count.
_M_TASK_LATENCY = _mx.registry().histogram(
    "scanner_tpu_task_latency_seconds",
    "End-to-end per-task latency from enqueue to sink-committed "
    "(local: admission to save completion; cluster: bulk admission to "
    "FinishedWork, observed on the master).",
    buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
             120.0, 300.0, 600.0))

_SENTINEL = object()     # pipeline queues: the stream has ended
_CHUNK_DONE = object()   # streaming producer: all chunks delivered
_CHUNK_ERR = object()    # streaming producer: (marker, exception)

_log = get_logger("engine")


@dataclass
class JobContext:
    job_idx: int
    jr: A.JobRows
    tasks: List[Tuple[int, int]]
    # per Input node: metadata for loading
    source_info: Dict[int, Dict[str, Any]]
    # per sink node id: (table descriptor, column name, codec, encode opts)
    sink_tables: Dict[int, Tuple[md.TableDescriptor, str, str, Dict]]
    fps: float = 30.0
    # sinks writing through a CustomStorage instead of the database
    custom_sinks: Dict[int, Any] = field(default_factory=dict)
    skipped: bool = False
    tasks_done: int = 0
    # sparse-read crossover for column loads (PerfParams
    # .load_sparsity_threshold -> items.read_item_rows_into)
    sparsity_threshold: int = 8
    # PerfParams.stream_work_packets: whether a task longer than one
    # work packet loads as a stream of chunks (_load_task)
    stream_work_packets: bool = True
    # per sink id: "video" | "pickle", fixed by the first task written so
    # mixed-dtype frame outputs fail loudly instead of corrupting the table
    sink_modes: Dict[int, str] = field(default_factory=dict)
    sink_mode_lock: threading.Lock = field(default_factory=threading.Lock)


@dataclass
class TaskItem:
    job: JobContext
    task_idx: int
    output_range: Tuple[int, int]
    plan: Optional[A.TaskPlan] = None
    elements: Optional[Dict[int, Any]] = None
    results: Optional[Dict[int, Any]] = None
    # distributed tracing (util/tracing.py): the parent context this
    # task's span attaches under (local: the job root span; cluster: the
    # master's assign span from the NextWork reply), and the open task
    # span itself — created by the loader, resumed by each stage thread,
    # closed after save/failure
    trace_ctx: Optional[Any] = None
    trace_span: Optional[Any] = None
    # master-assigned attempt id (cluster mode): distinguishes re-issues
    # of the same task after a timeout revocation
    attempt: int = 0
    # when this task became runnable; 0 = unknown (cluster workers leave
    # it unset: the master observes end-to-end latency there)
    enqueued_at: float = 0.0
    # device affinity: the pipeline instance this task was assigned to at
    # enqueue time and that instance's chip — recorded BEFORE loading so
    # the loader's device staging targets the chip that will actually
    # evaluate the task (a mismatch would silently copy cross-chip)
    instance: int = 0
    device: Optional[Any] = None
    # work-packet streaming, set by the load stage when the task's job
    # streams (JobContext.stream_work_packets): the task's per-chunk
    # plans, the loader->evaluator chunk queue, and the abort handshake
    # (evaluator failure must unblock a producing loader)
    chunk_plans: Optional[List[A.TaskPlan]] = None
    chunk_q: Optional["queue.Queue"] = None
    chunk_abort: Optional[threading.Event] = None
    # sharded gang members (engine/gang.py): per source node, the global
    # rows this member does NOT decode — its neighbors own them and the
    # post-load halo exchange delivers them over the gang's process
    # group; halo_fill is the hook that runs that exchange and splices
    # the received rows into the loaded elements before device staging
    halo_drop: Optional[Dict[int, Any]] = None
    halo_fill: Optional[Any] = None
    # rows the loader actually decoded/read for this task (set by
    # _load_task after any halo restriction) — the per-member decode
    # accounting the sharded-gang metrics report
    decode_rows: int = 0
    # frame-cache leases pinning the pages this task gathers from
    # (engine/framecache.py); released when evaluation finishes or the
    # task fails
    cache_leases: Optional[List[Any]] = None


class _StatefulChain:
    """Per-job planning chain for stateful task affinity
    (PerfParams.stateful_task_affinity; reference save_coordinator
    worker.cpp:373-415 packet pinning).

    Loaders plan a chained job's tasks in task order: `gate_plan` waits
    (briefly) until the preceding task was planned, then hands back the
    watermark map — the row each unbounded-state kernel's state will
    have advanced through — so analysis derives an incremental plan.
    The gate orders only the cheap PLAN step; decode still runs on all
    loader threads concurrently.  A timeout (a failed or reordered
    predecessor) degrades that one task to the self-contained plan;
    the chain then continues from its watermarks.  Correctness never
    depends on any of this: the evaluator re-verifies the premise
    against actual kernel state (StateCarryMiss -> self-contained
    re-run)."""

    GATE_TIMEOUT = 5.0

    def __init__(self):
        self.cond = threading.Condition()
        self.last_planned: Optional[int] = None
        # (unbounded node id, slice group) -> last row planned through
        self.water: Dict[Tuple[int, int], int] = {}

    def gate_plan(self, task_idx: int) -> Optional[Dict[Tuple[int, int],
                                                        int]]:
        """Block until `task_idx` is next in the chain (or timeout);
        returns the carry map, or None for a self-contained plan."""
        with self.cond:
            deadline = time.time() + self.GATE_TIMEOUT
            while self.last_planned is not None \
                    and task_idx > self.last_planned + 1:
                left = deadline - time.time()
                if left <= 0 or not self.cond.wait(timeout=left):
                    if deadline - time.time() <= 0:
                        break
            if self.last_planned is None \
                    or task_idx == self.last_planned + 1:
                return dict(self.water)
            return None

    def planned(self, task_idx: int,
                watermarks: Dict[Tuple[int, int], int]) -> None:
        with self.cond:
            if self.last_planned is None or task_idx > self.last_planned:
                self.last_planned = task_idx
            for k, m in watermarks.items():
                if m > self.water.get(k, -1):
                    self.water[k] = m
            self.cond.notify_all()


class LocalExecutor:
    def __init__(self, db: Database, profiler: Optional[Profiler] = None,
                 device: torch.device = torch.device("cpu"),
                 num_load_workers: int = 2, num_save_workers: int = 2,
                 pipeline_instances: int = 1, node_id: int = 0,
                 decoder_threads: int = 1, stage: Optional[bool] = None):
        """`device` is the resolved device of the client (see
        evaluate.resolve_device).  `stage` says whether device kernels'
        input columns are staged onto it as tensors (and video columns
        bound for them decode to the YUV420 wire format); it defaults
        to True exactly when the device is a CUDA card."""
        self.db = db
        self.device = device
        self.stage = (device.type == "cuda") if stage is None \
            else bool(stage)
        self.profiler = profiler or Profiler()
        self.num_load_workers = num_load_workers
        self.num_save_workers = num_save_workers
        self.pipeline_instances = pipeline_instances
        self.node_id = node_id
        # libav threads per decoder handle (frame threading); total decode
        # parallelism = num_load_workers x decoder_threads
        self.decoder_threads = decoder_threads
        # per-graph memo for _column_device_bound (keyed by GraphInfo
        # identity; cleared when a different graph runs).  Locked: loader
        # threads share it and a concurrent clear() mid-read would KeyError
        self._device_bound_cache: Dict[Any, Any] = {}
        self._device_bound_lock = threading.Lock()
        # job idx -> _StatefulChain when stateful task affinity is active
        self._chains: Dict[int, _StatefulChain] = {}
        # span sink for this executor's task/stage/op spans; a cluster
        # Worker swaps in its own export-enabled tracer so spans ship to
        # the master (ShipSpans)
        self.tracer = _tr.default_tracer()
        # trace_id of the last local run (Client.trace reads it)
        self.last_trace_id: Optional[str] = None
        # the frame cache's identity for this database (page keys)
        self._cache_db_key = _fc.db_cache_key(db.backend)

    # ------------------------------------------------------------------
    # Job-set preparation (reference master.cpp:1367 process_job admission)
    # ------------------------------------------------------------------

    def prepare(self, outputs: Sequence[O.OpNode], perf: PerfParams,
                cache_mode: CacheMode = CacheMode.Error
                ) -> Tuple[A.GraphInfo, List[JobContext]]:
        info = A.analyze(outputs)
        perf = self._estimate_perf(info, perf)
        jobs: List[JobContext] = []
        for j in range(info.num_jobs):
            jobs.append(self._prepare_job(info, j, perf, cache_mode))
        return info, jobs

    def prepare_readonly(self, outputs: Sequence[O.OpNode], perf: PerfParams
                         ) -> Tuple[A.GraphInfo, List[JobContext]]:
        """Worker-side preparation: identical analysis but output tables
        were already created by the master — look them up instead of
        creating (reference workers re-run DAG analysis, worker.cpp:1013)."""
        info = A.analyze(outputs)
        perf = self._estimate_perf(info, perf)
        jobs: List[JobContext] = []
        for j in range(info.num_jobs):
            jobs.append(self._prepare_job(info, j, perf,
                                          CacheMode.Overwrite,
                                          create_tables=False))
        return info, jobs

    def _bind_if_unbound(self, stream) -> None:
        """Re-bind a stream that traveled over RPC: __getstate__ nulls its
        client (streams.py), so `_sc is None` — distinct from a missing
        attribute (non-stream objects) — means 'needs this executor's
        db'."""
        if getattr(stream, "_sc", False) is None:
            stream.bind(self.db)

    def _estimate_perf(self, info: A.GraphInfo, perf: PerfParams
                       ) -> PerfParams:
        if not getattr(perf, "_estimate", False):
            if perf.io_packet_size % perf.work_packet_size != 0:
                raise ScannerException(
                    "io_packet_size must be a multiple of work_packet_size")
            return perf
        # geometry-aware sizing (the reference's PerfParams.estimate
        # analog, common.py:78-160): target ~64 MB of decoded frames per
        # io packet so tasks neither thrash tiny items nor blow host RAM
        frame_bytes = 0
        keyint = 0
        for n in info.sources:
            for s in n.extra["streams"]:
                self._bind_if_unbound(s)
                if getattr(s, "is_video", False) \
                        and hasattr(s, "estimate_geometry"):
                    # real errors (bad path, storage failure) propagate:
                    # silently mis-sizing a 4K stream as VGA would blow
                    # host RAM far from the actual cause
                    fb, ki = s.estimate_geometry()
                    frame_bytes = max(frame_bytes, fb)
                    keyint = max(keyint, ki)
                elif getattr(s, "is_video", False) \
                        and hasattr(s, "estimate_size"):
                    frame_bytes = max(frame_bytes, s.estimate_size())
        if frame_bytes > 0:
            target = 64 << 20
            io = max(16, min(512, target // frame_bytes))

            def best_work(n: int):
                """Best divisor of n in [4, 16] (compute batch floor:
                1-row work packets drown in scheduling overhead).
                Powers of two are preferred so steady-state work packets
                land exactly on a bucket of the shape-stable kernel
                dispatch (engine/evaluate.py bucket_ladder) — a full
                chunk then never pads."""
                for w in (16, 8, 4):
                    if n % w == 0:
                        return w
                for w in range(min(16, n), 3, -1):
                    if n % w == 0:
                        return w
                return None

            # snap io packets to a multiple of the keyframe interval so
            # task boundaries land on keyframes: a mid-GOP task start
            # re-decodes the GOP prefix (up to keyint-1 frames) for
            # nothing.  The snap is dropped rather than accepted when it
            # would cross the 16-frame floor (round up instead) or leave
            # no workable packet divisor.
            work = None
            if keyint > 1 and keyint <= 2 * io:
                snapped = (io // keyint) * keyint
                if snapped < 16:
                    snapped += keyint
                w = best_work(snapped)
                if w is not None:
                    io, work = snapped, w
            if work is None:
                # round down to a power of two: the work packet is the
                # kernel call shape, and a pow2 packet is its own bucket
                work = max(4, min(16, io // 4))
                work = 1 << (int(work).bit_length() - 1)
                io = (io // work) * work
            perf.io_packet_size = int(io)
            perf.work_packet_size = int(work)
        else:
            perf.io_packet_size = 512
            perf.work_packet_size = 128
        # resolution happens exactly once: cluster workers receive the
        # concrete sizes and must not re-estimate (estimate_size does I/O
        # and could diverge from the master's task partitioning)
        perf._estimate = False  # type: ignore[attr-defined]
        return perf

    def _prepare_job(self, info: A.GraphInfo, j: int, perf: PerfParams,
                     cache_mode: CacheMode,
                     create_tables: bool = True) -> JobContext:
        # resolve sources
        source_info: Dict[int, Dict[str, Any]] = {}
        source_rows: Dict[int, int] = {}
        fps = 30.0
        for n in info.sources:
            stream: StoredStream = n.extra["streams"][j]
            self._bind_if_unbound(stream)
            if getattr(stream, "is_custom", False):
                # pluggable source (reference Source::read extension point)
                source_info[n.id] = {"custom": stream, "is_video": False}
                source_rows[n.id] = stream.len()
                continue
            if isinstance(stream, NamedVideoStream):
                stream.ensure_ingested()
            if not stream.committed():
                raise JobException(
                    f"input stream {stream.name} does not exist or is "
                    f"not committed")
            desc = self.db.table_descriptor(stream.name)
            col = stream.column if stream.column in desc.column_names() \
                else next(c for c in desc.column_names() if c != "index")
            is_video = desc.column_type(col) == md.ColumnType.VIDEO
            vinfo = None
            if is_video:
                from ..video import load_video_meta
                vinfo = load_video_meta(self.db, stream.name, col)
                if vinfo.fps:
                    fps = vinfo.fps
            codec = next((c.codec for c in desc.columns if c.name == col),
                         "raw")
            source_info[n.id] = {
                "table": desc, "column": col, "is_video": is_video,
                "video_meta": vinfo, "codec": codec,
            }
            source_rows[n.id] = desc.num_rows

        jr = A.job_rows(info, j, source_rows)
        jr.work_packet_size = int(perf.work_packet_size)
        tasks = A.generate_tasks(jr, perf.io_packet_size)
        knobs = dict(sparsity_threshold=int(perf.load_sparsity_threshold),
                     stream_work_packets=bool(perf.stream_work_packets))

        # output tables (pre-created uncommitted, reference
        # master.cpp:1619-1663).  CacheMode.Ignore skips the job only when
        # EVERY sink output already exists committed (job-level resume,
        # reference client.py:1389-1430)
        sink_names = []
        table_sinks = []
        custom_sinks: Dict[int, Any] = {}
        for sink in info.sinks:
            out_stream = sink.extra["streams"][j]
            self._bind_if_unbound(out_stream)
            if getattr(out_stream, "is_custom", False):
                # CacheMode applies to custom sinks too: stale rows from a
                # previous (longer) run must not survive an Overwrite
                if create_tables and out_stream.storage.exists(out_stream):
                    if cache_mode == CacheMode.Error:
                        raise JobException(
                            f"custom output {out_stream.name} already "
                            f"exists (pass cache_mode=CacheMode.Overwrite)")
                    if cache_mode == CacheMode.Overwrite:
                        out_stream.storage.delete_stream(out_stream)
                custom_sinks[sink.id] = out_stream
                continue
            table_sinks.append(sink)
            sink_names.append(out_stream.name if hasattr(out_stream, "name")
                              else str(out_stream))
        if not create_tables:
            sink_tables = {}
            for sink, name in zip(table_sinks, sink_names):
                if not self.db.has_table(name):
                    continue  # job skipped by the master
                src_col = sink.input_columns()[0]
                codec = self._codec_for(src_col)
                desc = self.db.table_descriptor(name)
                enc = dict(sink.extra.get("encode_options") or {})
                sink_tables[sink.id] = (desc, desc.columns[0].name, codec,
                                        enc)
            return JobContext(job_idx=j, jr=jr, tasks=tasks, **knobs,
                              source_info=source_info,
                              sink_tables=sink_tables, fps=fps,
                              custom_sinks=custom_sinks,
                              skipped=not sink_tables and not custom_sinks)
        if table_sinks and not custom_sinks \
                and cache_mode == CacheMode.Ignore and all(
                self.db.table_is_committed(nm) for nm in sink_names):
            return JobContext(job_idx=j, jr=jr, tasks=tasks, **knobs,
                              source_info=source_info, sink_tables={},
                              fps=fps, skipped=True)
        sink_tables: Dict[int, Tuple] = {}
        for sink, name in zip(table_sinks, sink_names):
            src_col = sink.input_columns()[0]
            codec = self._codec_for(src_col)
            if self.db.has_table(name):
                if self.db.table_is_committed(name) \
                        and cache_mode == CacheMode.Error:
                    raise JobException(
                        f"output stream {name} already exists "
                        f"(pass cache_mode=CacheMode.Overwrite or Ignore)")
                self.db.delete_table(name)
            is_frame = codec == "frame"
            col = md.ColumnDescriptor(
                "frame" if is_frame else "output",
                md.ColumnType.VIDEO if is_frame else md.ColumnType.BYTES,
                codec="video" if is_frame else codec)
            desc = self.db.create_table(
                name, [col], end_rows=[e for _, e in tasks], job_id=-1)
            enc = dict(sink.extra.get("encode_options") or {})
            sink_tables[sink.id] = (desc, col.name, codec, enc)
        ctx = JobContext(job_idx=j, jr=jr, tasks=tasks, **knobs,
                         source_info=source_info, sink_tables=sink_tables,
                         fps=fps, custom_sinks=custom_sinks,
                         skipped=not sink_tables and not custom_sinks)
        return ctx

    @staticmethod
    def _codec_for(col: O.OpColumn) -> str:
        node = col.op
        if node.is_builtin:
            return "frame" if col.is_frame else "pickle"
        idx = [c for c, _ in node.spec.output_columns].index(col.column)
        return node.spec.output_codecs[idx]

    # ------------------------------------------------------------------
    # Execution
    # ------------------------------------------------------------------

    def setup_chains(self, info: A.GraphInfo, jobs: List[JobContext],
                     perf: PerfParams) -> None:
        """Arm stateful task affinity (one planning chain per multi-task
        job) when the graph has unbounded-state ops and the caller opted
        in.  NOTE: the whole run then executes with ONE loader and ONE
        pipeline instance on this node (kernel state lives in a single
        instance's kernels, and reordering would carry-miss) — an
        explicit trade the opt-in knob documents; cross-job parallelism
        in a cluster comes from per-job worker stickiness."""
        self._chains = {}
        if not getattr(perf, "stateful_task_affinity", False):
            return
        unbounded = [n.name for n in info.ops
                     if n.spec is not None
                     and getattr(n.spec, "unbounded_state", False)]
        if not unbounded:
            return
        for job in jobs:
            if not job.skipped and len(job.tasks) > 1:
                self._chains[job.job_idx] = _StatefulChain()
        if self._chains:
            _log.info(
                "stateful task affinity armed for %d job(s) (ops: %s): "
                "incremental plans, single evaluation instance",
                len(self._chains), ", ".join(sorted(set(unbounded))))

    # -- tracing glue (util/tracing.py) --------------------------------

    def _task_trace_begin(self, w: TaskItem, **attrs: Any) -> None:
        """Open the task's span (idempotent): child of its trace context
        — the job root span locally, the master's assign span in
        cluster mode — with `attrs` beside its ids.  No context = no
        span (tracing off or untraced caller); every stage then runs
        trace-free at one None check."""
        if w.trace_span is None and w.trace_ctx is not None:
            w.trace_span = _tr.open_span(
                self.tracer, "task", parent=w.trace_ctx,
                job=w.job.job_idx, task=w.task_idx, attempt=w.attempt,
                **attrs)

    def _task_scope(self, w: TaskItem):
        """Resume the task span on the calling stage thread, so the
        stage/op profiler spans inside nest under it."""
        return _tr.use_span(self.tracer, w.trace_span)

    def _task_trace_end(self, w: TaskItem,
                        status: Optional[str] = None) -> None:
        span, w.trace_span = w.trace_span, None
        _tr.close_span(self.tracer, span, status=status)
        if w.enqueued_at:
            # enqueue -> sink-committed (or terminal failure; errors are
            # latency too in a serving SLO)
            _M_TASK_LATENCY.observe(time.time() - w.enqueued_at)

    def run(self, outputs: Sequence[O.OpNode], perf: PerfParams,
            cache_mode: CacheMode = CacheMode.Error,
            show_progress: bool = False,
            started_at: Optional[float] = None) -> List[JobContext]:
        """Run a job set to its committed tables.  `started_at` is when
        the caller's set-up began (the local Client.run's entry), by
        default now; the job's root trace span starts then too.  The
        profiler records the phases `job.setup` (from `started_at` until
        the stage threads start), `pipeline.drain` (run_pipeline) and
        `job.commit` (the table commit, the sinks' `finished` and
        `write_megafile`)."""
        started_at = time.time() if started_at is None else started_at
        # the job's root trace span: every task span and phase of this
        # run chains up to it under one trace_id (Client.trace
        # assembles the tree)
        root = _tr.open_span(self.tracer, "job")
        if root is not None:
            root.start = started_at
        self.last_trace_id = root.trace_id if root is not None else None
        try:
            with _tr.use_span(self.tracer, root):
                return self._run(outputs, perf, cache_mode, show_progress,
                                 root, started_at)
        finally:
            _tr.close_span(self.tracer, root)

    def _run(self, outputs, perf, cache_mode, show_progress, root,
             started_at) -> List[JobContext]:
        info, jobs = self.prepare(outputs, perf, cache_mode)
        self.setup_chains(info, jobs, perf)
        self.profiler.level = int(getattr(perf, "profiler_level", 1))
        work = [TaskItem(job, t, rng)
                for job in jobs if not job.skipped
                for t, rng in enumerate(job.tasks)]
        _log.info("job set prepared: %d jobs (%d skipped), %d tasks",
                  len(jobs), sum(1 for j in jobs if j.skipped), len(work))
        now = time.time()
        if root is not None:
            root.attrs = {**(root.attrs or {}), "tasks": len(work),
                          "jobs": len(jobs)}
        for w in work:
            if root is not None:
                w.trace_ctx = root.context()
            w.enqueued_at = now
        if work:
            # level >= 2: capture the card's timeline around the job
            # (merged into Profile.write_trace output)
            with device_trace(self.profiler):
                self._run_pipeline(
                    info, work, show_progress,
                    queue_size=int(perf.queue_size_per_pipeline),
                    precompile=self.precompile_hint(jobs),
                    setup_from=started_at)
        else:
            self.profiler.add_phase("job.setup", started_at, time.time())
        # after the device capture's teardown (level >= 2), which is
        # no part of the commit
        ended = time.time()
        for job in jobs:
            if job.skipped:
                continue
            for desc, _c, _k, _e in job.sink_tables.values():
                self.db.commit_table(desc.id)
            for stream in job.custom_sinks.values():
                # durability barrier (reference Sink::finished)
                stream.storage.finished(stream, job.jr.output_rows)
        self.db.write_megafile()
        self.profiler.add_phase("job.commit", ended, time.time())
        return jobs

    @staticmethod
    def precompile_hint(jobs: List[JobContext]
                        ) -> Optional[Tuple[int, int, int]]:
        """(frame_h, frame_w, work_packet_size) for the evaluator's
        bucket-ladder warm-up (evaluate.py precompile), from the first
        non-skipped job with a video source — the geometry the device
        kernels will actually see.  None = nothing to warm."""
        for job in jobs:
            if getattr(job, "skipped", False):
                continue
            for si in job.source_info.values():
                vm = si.get("video_meta")
                if vm is not None and vm.height and vm.width:
                    wp = int(getattr(job.jr, "work_packet_size", 0) or 0)
                    return (int(vm.height), int(vm.width), wp)
        return None

    def _run_pipeline(self, info: A.GraphInfo, work: List[TaskItem],
                      show_progress: bool,
                      queue_size: Optional[int] = None,
                      precompile: Optional[Tuple[int, int, int]] = None,
                      setup_from: Optional[float] = None) -> None:
        pending = list(work)
        src_lock = threading.Lock()

        def source():
            with src_lock:
                return pending.pop(0) if pending else None

        done = self.run_pipeline(info, source, show_progress=show_progress,
                                 total=len(work), queue_size=queue_size,
                                 precompile=precompile,
                                 setup_from=setup_from)
        if done != len(work):
            raise JobException(
                f"pipeline finished {done}/{len(work)} tasks")

    def run_pipeline(self, info: A.GraphInfo, source,
                     on_start=None, on_done=None, on_eval_done=None,
                     on_task_error=None,
                     evaluator_factory=None, close_evaluators: bool = True,
                     queue_size: Optional[int] = None,
                     show_progress: bool = False, total: int = 0,
                     precompile: Optional[Tuple[int, int, int]] = None,
                     setup_from: Optional[float] = None) -> int:
        """Multi-stage streaming pipeline (reference worker.cpp:1467-1724
        load/evaluate/save stage loops): N loaders pull TaskItems from
        `source` and decode, P evaluator instances execute, S savers
        persist.  Shared by the local executor (source = task list) and the
        cluster worker (source = master NextWork pull), so a cluster worker
        keeps every stage of the node busy instead of running one task at a
        time.  `precompile` is the evaluators' ladder warm-up hint
        (precompile_hint).  With `setup_from` the profiler records the
        phase `job.setup` from then until the stage threads start; it
        always records `pipeline.drain`, from the last task's save
        until every stage thread has ended.

        source() -> TaskItem | "wait" (retry shortly) | None (exhausted);
        called concurrently from loader threads.
        on_start(w) -> bool | None: evaluation-begin hook (cluster:
        StartedWork RPC); returning False drops the task without
        evaluating (revoked attempt).  on_eval_done(w): evaluation-complete
        hook, fired when the task hands off to the save stage (cluster:
        EvalDone RPC so save-parked tasks stop counting against the
        NextWork window).  on_done(w): save-complete hook (cluster:
        FinishedWork RPC).
        on_task_error(w, exc) -> bool: True = task failure is reported and
        the pipeline continues (cluster); False/None = abort (local).
        evaluator_factory(idx, skip_fetch) -> TaskEvaluator: override to
        reuse evaluators across pipeline entries (cluster worker).
        Returns the number of tasks fully saved.

        SCANNER_TPU_NO_PIPELINING=1 (reference worker.cpp:140
        NO_PIPELINING) degrades to one loop on the calling thread that
        runs each task's stages through the same stage core
        (_evaluate_stage, save_results) — same semantics, clean stack
        traces for debugging."""
        # the health/SLO engine watches this pipeline's queue-depth and
        # stage-rate series: make sure it samples while stages run, even
        # when no Client started it (direct LocalExecutor embedding);
        # the remediation controller rides the same alerts with the
        # playbooks this process can act on (frame-cache shrink, ladder
        # re-warm)
        _health.ensure_started()
        _controller.ensure_started()

        def make_evaluator(idx: int, skip_fetch: bool,
                           instances: int = 1) -> TaskEvaluator:
            if evaluator_factory is not None:
                return evaluator_factory(idx, skip_fetch)
            return TaskEvaluator(info, self.profiler, self.device,
                                 stage=self.stage,
                                 skip_fetch_resources=skip_fetch,
                                 precompile=precompile,
                                 instance=idx, instances=instances)

        if os.environ.get("SCANNER_TPU_NO_PIPELINING", "0") not in \
                ("0", "", "false"):
            return self._run_serial(info, source, on_start, on_done,
                                    on_eval_done, on_task_error,
                                    make_evaluator, close_evaluators,
                                    show_progress, total, setup_from)
        qsize = queue_size or 4
        # stateful affinity: kernel state lives in ONE instance's kernels,
        # so a chained run serializes evaluation (the reference pins a
        # job's packets to one worker for the same reason).  One loader
        # too: with N loaders, a decode-time inversion hands the
        # evaluator task t+1 before t and every inversion costs a
        # StateCarryMiss reload+recompute — per-task decode parallelism
        # stays available via decoder_threads.
        # ANY stateful op serializes the same way, chained or not: a
        # bounded-state kernel's maybe_reset only fires on row
        # DISCONTINUITY, so an inverted first task (fresh instance,
        # _last_row still None) would run on virgin state with no reset
        # and no carry-miss to catch it — order is correctness here,
        # not a perf knob.
        stateful = any(n.spec is not None and n.spec.is_stateful
                       for n in info.ops)
        serialize = bool(self._chains) or stateful
        n_evals = 1 if serialize else self.pipeline_instances
        n_loaders = 1 if serialize else self.num_load_workers
        # Device-affine routing: when instances own distinct chips, each
        # gets its OWN queue and the loader assigns each task to the
        # least-loaded instance (round-robin tie-break) at enqueue time
        # — the assignment is recorded on the TaskItem before loading so
        # device staging targets the chip that will evaluate the task.
        # A chained run (n_evals=1) or a single-card host keeps one
        # shared queue (any instance takes any task).
        inst_devices = [assigned_device(self.device, i)
                        for i in range(n_evals)]
        if n_evals > 1 and len(set(inst_devices)) > 1:
            eval_qs: List["queue.Queue"] = [queue.Queue(maxsize=qsize)
                                            for _ in range(n_evals)]
        else:
            shared_q: "queue.Queue" = queue.Queue(maxsize=qsize)
            eval_qs = [shared_q] * n_evals
        uniq_qs = list({id(q): q for q in eval_qs}.values())
        save_q: "queue.Queue" = queue.Queue(maxsize=qsize)
        # live depth gauges sample the queues at scrape time; the last
        # pipeline to start owns the gauge (concurrent pipelines in one
        # process share the process registry)
        depth_fns = {
            "evaluate": lambda: sum(q.qsize() for q in uniq_qs),
            "save": save_q.qsize,
        }
        for stage, fn in depth_fns.items():
            _M_QDEPTH.labels(stage=stage).set_function(fn)
        errors: List[BaseException] = []
        err_lock = threading.Lock()
        stop = threading.Event()

        def record_err(e: BaseException):
            with err_lock:
                errors.append(e)
            stop.set()

        def task_failed(w: TaskItem, e: BaseException) -> None:
            """Route one task's failure; abort unless the error handler
            accepts it (cluster mode reports FailedWork and moves on)."""
            self._fail_task(w, e)
            if on_task_error is not None and on_task_error(w, e):
                return
            _log.exception("task (%d,%d) failed; aborting pipeline",
                           w.job.job_idx, w.task_idx, exc_info=e)
            record_err(e)

        # The end of the stream travels down the queues: the last loader
        # to end puts one _SENTINEL per evaluator on the evaluators'
        # queues (n_evals on a shared queue, one on each instance's),
        # the last evaluator one per saver on save_q.  FIFO order hands
        # every task put before a marker over first.
        live = {"load": n_loaders, "evaluate": n_evals}
        live_lock = threading.Lock()

        def end_stream(stage: str, downstream: List["queue.Queue"]) -> None:
            with live_lock:
                live[stage] -= 1
                if live[stage]:
                    return
            for q in downstream:
                self._put_until(q, _SENTINEL, stop)

        def take(q: "queue.Queue", upstream: List[threading.Thread]):
            """The next task on `q`, or None when the stream has ended (a
            marker taken) or `stop` is set.  The timed get only notices
            `stop`; a consumer whose producers have all ended and whose
            queue is empty lost its marker, and leaves counted as a
            `pipeline.poll_exits`."""
            while not stop.is_set():
                try:
                    w = q.get(timeout=0.25)
                except queue.Empty:
                    # a producer puts its markers before it ends, unless
                    # `stop` was set first: test its liveness, then the
                    # queue, then `stop`
                    if not any(t.is_alive() for t in upstream) \
                            and q.empty() and not stop.is_set():
                        self.profiler.count("pipeline.poll_exits")
                        return None
                    continue
                return None if w is _SENTINEL else w
            return None

        # loader cache: (thread, job, node) -> DecoderAutomata
        tls = threading.local()

        # Enqueue-time instance assignment: fixes which evaluator — and
        # therefore which chip — a task runs on, BEFORE the loader
        # stages its columns.  Least-loaded queue wins so one slow task
        # can't head-of-line-block the whole pipeline (strict
        # round-robin would keep feeding the slow instance until its
        # queue filled and the loader stalled while other chips
        # drained); a rotating start index breaks qsize ties fairly, so
        # an idle pipeline still spreads tasks across every chip.
        assign_lock = threading.Lock()
        assign_counter = [0]

        def assign_instance(w: TaskItem) -> None:
            with assign_lock:
                start = assign_counter[0] % n_evals
                assign_counter[0] += 1
            best = min(
                range(n_evals),
                key=lambda k: (eval_qs[(start + k) % n_evals].qsize(), k))
            idx = (start + best) % n_evals
            w.instance = idx
            w.device = inst_devices[idx]

        def loader():
            try:
                try:
                    while not stop.is_set():
                        w = source()
                        if w is None:
                            break
                        if w == "wait":
                            time.sleep(0.2)
                            continue
                        assign_instance(w)
                        self._task_trace_begin(w)
                        try:
                            with self._task_scope(w):
                                self.load_task(info, w, tls)
                        except Exception as e:  # noqa: BLE001
                            task_failed(w, e)
                            continue
                        if self._put_until(eval_qs[w.instance], w, stop) \
                                and w.chunk_plans is not None:
                            # streaming task: decode chunks into its
                            # bounded queue while the evaluator consumes
                            with self._task_scope(w):
                                self._produce_chunks(info, w, tls,
                                                     stop=stop)
                finally:
                    # release decoder handles held by this loader thread
                    self._close_decoders(tls)
            except BaseException as e:  # noqa: BLE001
                record_err(e)
            finally:
                end_stream("load", eval_qs)

        def evaluator(evaluator_idx: int):
            te = None
            my_q = eval_qs[evaluator_idx]
            import types
            fb_tls = types.SimpleNamespace()  # fallback reload decoders
            try:
                # fetch_resources runs once per node: instance 0 fetches,
                # the rest only setup (reference evaluate_worker.cpp:488-534)
                if evaluator_idx > 0:
                    fetch_done.wait()
                te = make_evaluator(evaluator_idx, evaluator_idx > 0,
                                    n_evals)
                if evaluator_idx == 0:
                    fetch_done.set()
                while (w := take(my_q, loaders)) is not None:
                    try:
                        if on_start is not None and on_start(w) is False:
                            if w.chunk_abort is not None:
                                w.chunk_abort.set()  # unblock the loader
                            # leases the producing loader adds after
                            # this are released by its abort path
                            self._release_cache(w)
                            self._task_trace_end(w, status="revoked")
                            continue  # revoked attempt: drop silently
                        self._evaluate_stage(
                            info, te, w, fb_tls,
                            None if w.chunk_q is None
                            else self._queued_chunks(w, stop))
                    except Exception as e:  # noqa: BLE001
                        task_failed(w, e)
                        continue
                    if on_eval_done is not None:
                        on_eval_done(w)
                    self._put_until(save_q, w, stop)
            except BaseException as e:  # noqa: BLE001
                record_err(e)
            finally:
                fetch_done.set()  # never leave siblings waiting
                end_stream("evaluate", [save_q] * self.num_save_workers)
                self._close_decoders(fb_tls)
                if te is not None and close_evaluators:
                    te.close()

        done_count = [0]
        last_done: List[Optional[float]] = [None]
        done_lock = threading.Lock()

        def saver():
            try:
                while (w := take(save_q, evals)) is not None:
                    try:
                        self.save_results(info, w)
                        if on_done is not None:
                            on_done(w)
                    except Exception as e:  # noqa: BLE001
                        task_failed(w, e)
                        continue
                    with done_lock:
                        done_count[0] += 1
                        last_done[0] = time.time()
                        if show_progress:
                            print(f"\rtasks {done_count[0]}/{total}",
                                  end="", flush=True)
            except BaseException as e:  # noqa: BLE001
                record_err(e)

        fetch_done = threading.Event()

        loaders = [threading.Thread(target=loader, name=f"load-{i}")
                   for i in range(n_loaders)]
        evals = [threading.Thread(target=evaluator, args=(i,),
                                  name=f"eval-{i}")
                 for i in range(n_evals)]
        savers = [threading.Thread(target=saver, name=f"save-{i}")
                  for i in range(self.num_save_workers)]
        try:
            # set-up ends as the stage threads start, so that it never
            # overlaps a stage span
            if setup_from is not None:
                self.profiler.add_phase("job.setup", setup_from,
                                        time.time())
            for t in loaders + evals + savers:
                t.start()
            for t in loaders + evals + savers:
                t.join()
            if last_done[0] is not None:
                self.profiler.add_phase("pipeline.drain", last_done[0],
                                        time.time())
        finally:
            # detach the depth gauges from this run's (now dead) queues —
            # but only if this run still owns them: a concurrent pipeline
            # that re-bound the gauge keeps its live sampler
            for stage, fn in depth_fns.items():
                g = _M_QDEPTH.labels(stage=stage)
                if g.clear_function(fn):
                    g.set(0)
        if show_progress:
            print()
        if errors:
            raise errors[0]
        return done_count[0]

    def _run_serial(self, info: A.GraphInfo, source, on_start, on_done,
                    on_eval_done, on_task_error, make_evaluator,
                    close_evaluators: bool, show_progress: bool,
                    total: int, setup_from: Optional[float] = None) -> int:
        """The NO_PIPELINING path: one loop on this thread takes each
        task through load, evaluate and save, by the same stage core
        and evaluator (fused chains, staging, buckets) as the threaded
        pipeline.  Its phases: `job.setup` ends where the threaded path
        starts its stage threads, `pipeline.drain` runs from the last
        save to the return."""
        import types
        if setup_from is not None:
            self.profiler.add_phase("job.setup", setup_from, time.time())
        tls = types.SimpleNamespace()
        fb_tls = types.SimpleNamespace()  # carry-miss fallback decoders
        te = make_evaluator(0, False)
        done = 0
        try:
            while (w := source()) is not None:
                if w == "wait":
                    time.sleep(0.2)
                    continue
                # single inline instance: staging still targets its
                # assigned device so serial runs match the threaded path
                w.instance = 0
                w.device = assigned_device(self.device, 0)
                # Error routing mirrors the threaded path stage by stage:
                # load / evaluate(+on_start) / save(+on_done) failures are
                # task failures (on_task_error may absorb them), while an
                # on_eval_done failure — cluster bookkeeping RPC, not task
                # work — is a pipeline error and propagates (the threaded
                # evaluator calls it outside its per-task try).
                self._task_trace_begin(w)
                try:
                    with self._task_scope(w):
                        self.load_task(info, w, tls)
                    if on_start is not None and on_start(w) is False:
                        self._release_cache(w)
                        self._task_trace_end(w, status="revoked")
                        continue  # revoked attempt
                    # a streamed task decodes its chunks inline; the
                    # carry-miss fallback loads through fb_tls — NOT tls,
                    # whose decoder sessions are suspended mid-run
                    self._evaluate_stage(
                        info, te, w, fb_tls,
                        None if w.chunk_plans is None
                        else self._iter_chunk_items(info, w, tls))
                except Exception as e:  # noqa: BLE001
                    self._fail_task(w, e)
                    if on_task_error is not None and on_task_error(w, e):
                        continue
                    raise
                if on_eval_done is not None:
                    on_eval_done(w)
                try:
                    self.save_results(info, w)
                    if on_done is not None:
                        on_done(w)
                except Exception as e:  # noqa: BLE001
                    self._fail_task(w, e)
                    if on_task_error is not None and on_task_error(w, e):
                        continue
                    raise
                done += 1
                last_done = time.time()
                if show_progress:
                    print(f"\rtasks {done}/{total}", end="", flush=True)
        finally:
            self._close_decoders(tls, fb_tls)
            if close_evaluators:
                te.close()
        if done:
            self.profiler.add_phase("pipeline.drain", last_done, time.time())
        if show_progress:
            print()
        return done

    def run_single_task(self, info: A.GraphInfo, w: TaskItem,
                        save: bool = True,
                        span_attrs: Optional[Dict[str, Any]] = None
                        ) -> TaskItem:
        """Run ONE whole task stage-inline on this thread: load →
        evaluate (→ save), on this executor's device.  The gang-member
        path (engine/gang.py): a gang task executes inside a dedicated
        member process, synchronized with its peers by collectives
        rather than by the streaming pipeline, and only member 0 saves —
        so the member defers `save` until the cross-host agreement check
        passes (`save_results` finishes the job).  The task never
        streams, whatever its job says: a sharded member's halo rows
        (halo_drop / halo_fill) are handled on the whole-task load only.
        `span_attrs` land on the task span (gang id / epoch / member
        rank, so per-host stragglers stay attributable under the gang
        root span).  Returns `w` with `.results` populated."""
        import types
        tls = types.SimpleNamespace()
        fb_tls = types.SimpleNamespace()
        self._task_trace_begin(w, **(span_attrs or {}))
        w.instance = 0
        w.device = assigned_device(self.device, 0)
        te = None
        try:
            with self._task_scope(w):
                self.load_task(info, w, tls, whole=True)
            te = TaskEvaluator(info, self.profiler, self.device,
                               stage=self.stage, instance=0)
            self._evaluate_stage(info, te, w, fb_tls)
            if save:
                self.save_results(info, w)
            return w
        except Exception as e:  # noqa: BLE001
            self._fail_task(w, e)
            raise
        finally:
            self._close_decoders(tls, fb_tls)
            if te is not None:
                te.close()

    # ------------------------------------------------------------------
    # The stage core: one task's evaluate and save, and the cleanup of a
    # failed task — shared by the threaded pipeline, the serial loop and
    # run_single_task
    # ------------------------------------------------------------------

    def _evaluate_stage(self, info: A.GraphInfo, te, w: TaskItem, fb_tls,
                        chunks=None) -> None:
        """The evaluate stage of one task: run it on `te` — a streamed
        task over `chunks`, its (plan, elements) iterator, a whole task
        (`chunks` None) as its one plan — into `w.results`, start the
        sinks' device->host copy, count the stage, and drop the task's
        columns and cache pins.  A failure aborts the task's chunk
        producer, if it has one, and propagates."""
        t0 = time.time()
        try:
            with self._task_scope(w), \
                    self.profiler.span("evaluate", level=0,
                                       task=w.task_idx, job=w.job.job_idx):
                if _faults.ACTIVE:
                    _faults.inject(
                        "pipeline.eval",
                        detail=f"task={w.job.job_idx},{w.task_idx}")
                if chunks is None:
                    w.results = self._execute_chunk(info, te, w, w.plan,
                                                    w.elements, fb_tls)
                else:
                    # merge per-sink results in row order
                    parts: Dict[int, List[ColumnBatch]] = {}
                    n = 0
                    for plan, elements in chunks:
                        res = self._execute_chunk(info, te, w, plan,
                                                  elements, fb_tls)
                        for sid, b in res.items():
                            parts.setdefault(sid, []).append(b)
                        n += 1
                    self.profiler.count("stream_chunks", n)
                    w.results = {sid: concat_batches(lst)
                                 for sid, lst in parts.items()}
        except BaseException:
            if w.chunk_abort is not None:
                w.chunk_abort.set()  # unblock a producing loader
            raise
        # start the sink d2h now: the copy rides under the NEXT task's
        # evaluation instead of blocking the saver
        self._prefetch_results(w)
        dt = time.time() - t0
        _M_STAGE_SECONDS.labels(stage="evaluate").inc(dt)
        _M_STAGE_TASKS.labels(stage="evaluate").inc()
        lbl = device_label(w.device)
        _M_DEV_TASKS.labels(device=lbl).inc()
        _M_DEV_BUSY.labels(device=lbl).inc(dt)
        w.elements = None
        # evaluation is done with the cached pages: unpin them (the sink
        # batches are the task's own tensors, never cache pages)
        self._release_cache(w)

    def save_results(self, info: A.GraphInfo, w: TaskItem) -> None:
        """The save stage of one task: persist its evaluated results,
        count the stage and close the task's span.  The saver threads
        and the serial loop call it before `on_done`; a gang's single
        writer (member 0) calls it as the deferred half of
        `run_single_task(save=False)`, once the collective agreement
        check passed."""
        t0 = time.time()
        with self._task_scope(w), \
                self.profiler.span("save", level=0, task=w.task_idx,
                                   job=w.job.job_idx):
            self._save_task(info, w)
        _M_STAGE_SECONDS.labels(stage="save").inc(time.time() - t0)
        _M_STAGE_TASKS.labels(stage="save").inc()
        # close the span BEFORE on_done: the cluster worker's completion
        # hook ships spans then sends FinishedWork, so the master holds
        # this task's full chain before the bulk can finish
        self._task_trace_end(w)

    def _fail_task(self, w: TaskItem, e: BaseException) -> None:
        """Close a failed task's span and drop what it holds NOW (staged
        columns, results, cache pins): a task requeued after memory
        pressure must not keep holding the very device buffers that
        caused it, and cache pins must not outlive the attempt."""
        if w.trace_span is not None:
            w.trace_span.add_event("error", type=type(e).__name__,
                                   message=str(e)[:200])
        self._task_trace_end(w, status="error")
        w.elements = None
        w.results = None
        self._release_cache(w)

    @staticmethod
    def _put_until(q: "queue.Queue", item, stop: threading.Event,
                   abort: Optional[threading.Event] = None) -> bool:
        """Put on a bounded queue, giving up (False) once `stop` — or
        `abort`, where given — is set: a consumer that died must not
        block its producer forever."""
        while not (stop.is_set() or (abort is not None and abort.is_set())):
            try:
                q.put(item, timeout=0.25)
                return True
            except queue.Full:
                pass
        return False

    def _execute_chunk(self, info: A.GraphInfo, te, w: TaskItem, plan,
                       elements, fb_tls) -> Dict[int, ColumnBatch]:
        """Run one chunk of a task (a whole task is its one chunk).  On
        a StateCarryMiss — the affinity chain's premise broke:
        reordering, a failed predecessor, another instance — re-derive
        the chunk's self-contained plan, reload and pre-stage its
        sources through `fb_tls`, and run it again.  Affinity is an
        optimization only."""
        try:
            return te.execute_task(w.job.jr, plan, elements)
        except StateCarryMiss as e:
            _log.info("task (%d,%d) rows %s: %s — re-running "
                      "self-contained", w.job.job_idx, w.task_idx,
                      plan.output_range, e)
            self.profiler.count("state_carry_miss")
            if w.chunk_plans is None:
                _tr.add_event("state_carry_miss")
            else:
                _tr.add_event("state_carry_miss",
                              chunk=str(plan.output_range))
            plan2 = A.derive_task_streams(
                info, w.job.jr, plan.output_range,
                job_idx=w.job.job_idx, task_idx=w.task_idx)
            tmp = TaskItem(w.job, w.task_idx, plan.output_range,
                           plan=plan2, device=w.device)
            try:
                tmp.elements = self._load_sources(info, tmp, fb_tls)
                self._prestage_device_columns(info, tmp)
                return te.execute_task(w.job.jr, plan2, tmp.elements)
            finally:
                self._release_cache(tmp)

    # ------------------------------------------------------------------
    # Work-packet streaming (PerfParams.stream_work_packets)
    # ------------------------------------------------------------------

    class _VideoFeed:
        """Incremental frame supply for one video source node of one
        streaming task: per-item decoder sessions
        (DecoderAutomata.stream_frames) chained in row order, a small
        row->frame buffer, and retention driven by the later chunks'
        minimum row so stencil back-reach is served from memory instead
        of a per-chunk keyframe re-decode (the reference's element
        cache, evaluate_worker.h:207-218)."""

        def __init__(self, ex: "LocalExecutor", w: TaskItem, tls,
                     node_id: int, si, plans: List[A.TaskPlan],
                     output_format: str, use_cache: bool = False):
            desc = si["table"]
            all_rows = np.unique(np.concatenate([
                np.asarray(p.source_rows[node_id], np.int64)
                for p in plans]))
            # suffix minima: after serving chunk i, rows below the
            # smallest row any LATER chunk requests can be dropped
            mins = [int(np.asarray(p.source_rows[node_id]).min())
                    if len(p.source_rows[node_id]) else np.iinfo(np.int64).max
                    for p in plans]
            suffix = []
            cur = np.iinfo(np.int64).max
            for m in reversed(mins):
                suffix.append(cur)
                cur = min(cur, m)
            self._keep_from = list(reversed(suffix))  # per chunk index
            self._chunk_i = 0
            self._buf: Dict[int, Any] = {}
            self._profiler = ex.profiler

            # decode in slices matched to the chunk row count so peak
            # scratch/buffer is ~one work packet, not a fixed constant
            wp_est = max(4, max(len(p.source_rows[node_id])
                                for p in plans))

            # the streamable guard (load_task) pins the task to ONE
            # item; its own descriptor drives the convert-mark geometry
            # (items of one table may differ — same rule as the
            # whole-task loader's per-item marks)
            item = desc.item_of_row(int(all_rows[0]))
            item_start, item_end = desc.item_bounds(item)
            self._item_start = int(item_start)
            auto = ex._automata(tls, w.job, node_id, si, item,
                                output_format=output_format)
            self.convert = (("yuv420", auto.vd.height, auto.vd.width)
                            if output_format == "yuv420" else None)
            self._hw = (auto.vd.height, auto.vd.width)

            # frame cache (engine/framecache.py): one plan for the
            # whole task's rows, pinned up front — the decode stream
            # then covers only the misses, and each chunk assembles as
            # a page gather + a staging copy of its fresh rows
            self._plan = None
            self._cache = None
            decode_rows = all_rows
            if use_cache:
                cache = _fc.cache()
                plan = cache.plan(
                    w.device, (ex._cache_db_key, desc.id), si["column"],
                    item, output_format, all_rows - item_start,
                    total_rows=item_end - item_start,
                    keyint=ex._keyint_of(si))
                _fc.attach_lease(w, plan.lease)
                self._plan = plan
                self._cache = cache
                self._miss = set((plan.miss_rows
                                  + item_start).tolist())
                decode_rows = plan.miss_rows + item_start

            def gen():
                for rr, fr in auto.stream_frames(
                        (decode_rows - item_start).tolist(),
                        packets_per_call=wp_est,
                        max_frames_per_yield=wp_est):
                    yield rr + item_start, fr

            self._gen = gen() if len(decode_rows) else iter(())

        def batch_for(self, rows: Sequence[int]) -> ColumnBatch:
            rows_arr = np.asarray(rows, np.int64)
            if self._plan is None:
                need = set(rows_arr.tolist()) - self._buf.keys()
            else:
                need = (set(rows_arr.tolist()) & self._miss) \
                    - self._buf.keys()
            t0 = time.time()
            decoded = 0
            with self._profiler.span("load:decode", rows=len(need)):
                while need:
                    rr, fr = next(self._gen)  # StopIteration = decode bug
                    for r, f in zip(rr.tolist(), fr):
                        self._buf[r] = f
                    decoded += len(fr)
                    need -= set(rr.tolist())
                if decoded:
                    lbl = threading.current_thread().name
                    _M_DECODED.labels(loader=lbl).inc(decoded)
                    _M_DECODE_SECONDS.labels(loader=lbl).inc(
                        time.time() - t0)
                if self._plan is None:
                    data = np.stack([self._buf[int(r)] for r in rows_arr]) \
                        if len(rows_arr) else np.zeros((0,), np.uint8)
            if self._plan is not None:
                # page-gather assembly: fresh (miss) rows of this chunk
                # feed page completion and stage once; resident rows
                # gather from the pinned pages on this task's device
                fresh_g = sorted(set(rows_arr.tolist()) & self._miss)
                fresh_local = np.asarray(fresh_g, np.int64) \
                    - self._item_start
                fresh_data = (np.stack([self._buf[r] for r in fresh_g])
                              if fresh_g else np.zeros((0, 1), np.uint8))
                data = self._cache.assemble_rows(
                    self._plan, rows_arr - self._item_start,
                    fresh_local, fresh_data, hw=self._hw)
            keep_from = self._keep_from[self._chunk_i]
            self._chunk_i += 1
            for r in [r for r in self._buf if r < keep_from]:
                del self._buf[r]
            return ColumnBatch(rows_arr, data, convert=self.convert)

    def _iter_chunk_items(self, info: A.GraphInfo, w: TaskItem, tls):
        """Yield (plan, elements) per work-packet chunk of a streaming
        task, decoding incrementally and pre-staging device columns so
        the h2d of chunk k+1 rides under the compute of chunk k."""
        feeds: Dict[int, LocalExecutor._VideoFeed] = {}
        for nid in w.chunk_plans[0].source_rows:
            si = w.job.source_info[nid]
            if si.get("is_video"):
                fmt = ("yuv420" if self._yuv_device_wire(info, nid)
                       else "rgb24")
                feeds[nid] = self._VideoFeed(
                    self, w, tls, nid, si, w.chunk_plans, fmt,
                    use_cache=self._cache_eligible(info, nid))
        for plan in w.chunk_plans:
            elements: Dict[int, ColumnBatch] = {}
            t0 = time.time()
            with self.profiler.span("load", level=0, task=w.task_idx,
                                    job=w.job.job_idx,
                                    chunk=plan.output_range[0]):
                for nid, rows in plan.source_rows.items():
                    if nid in feeds:
                        elements[nid] = feeds[nid].batch_for(rows)
                    else:
                        elements[nid] = self._load_plain_source(
                            w, nid, [int(r) for r in rows], tls,
                            pin=self._pins_decode(info, w, nid))
                self._prestage_device_columns(info, w, elements=elements)
            _M_STAGE_SECONDS.labels(stage="load").inc(time.time() - t0)
            yield plan, elements

    def _produce_chunks(self, info: A.GraphInfo, w: TaskItem, tls,
                        stop: threading.Event) -> None:
        """Loader-side: decode chunks into the task's bounded queue; a
        consumer failure (chunk_abort) or pipeline stop unblocks us."""
        try:
            for item in self._iter_chunk_items(info, w, tls):
                if not self._put_until(w.chunk_q, item, stop, w.chunk_abort):
                    return
            self._put_until(w.chunk_q, _CHUNK_DONE, stop, w.chunk_abort)
        except Exception as e:  # noqa: BLE001 — surfaces on the consumer
            self._put_until(w.chunk_q, (_CHUNK_ERR, e), stop, w.chunk_abort)
        finally:
            # aborted task (consumer failure, pipeline stop): unpin
            # frame-cache pages HERE — production has ended, so no later
            # append races this release; the consumer's own release
            # paths cover the normal completion order
            if w.chunk_abort.is_set() or stop.is_set():
                self._release_cache(w)

    def _queued_chunks(self, w: TaskItem, stop: threading.Event):
        """Evaluator-side: yield a streamed task's chunks as its loader
        puts them on the task's queue, recording the waits."""
        while True:
            t0 = time.time()
            while True:
                try:
                    item = w.chunk_q.get(timeout=0.25)
                    break
                except queue.Empty:
                    if stop.is_set():
                        raise JobException(
                            "pipeline stopped during streaming task")
            waited = time.time() - t0
            _M_CHUNK_WAIT.inc(waited)
            if waited > 0.005:
                # starvation attribution: time the evaluator spent
                # waiting on the loader's chunk production (decode
                # slower than compute shows up here, not as inflated
                # kernel spans)
                self.profiler.add_interval(
                    "evaluate:chunk_wait", t0, t0 + waited, level=1,
                    task=w.task_idx, job=w.job.job_idx)
            if item is _CHUNK_DONE:
                return
            if isinstance(item, tuple) and item[0] is _CHUNK_ERR:
                raise item[1]
            yield item

    def load_task(self, info: A.GraphInfo, w: TaskItem, tls, *,
                  whole: bool = False) -> TaskItem:
        """The load stage: derive the task's row plan and read/decode its
        source elements (shared by the local pipeline and cluster
        workers).  A task streams as its job says
        (JobContext.stream_work_packets) unless `whole` asks for the
        whole task (run_single_task)."""
        t0 = time.time()
        # success-only, like the evaluate/save stage counters: a failing
        # load must not read as the load stage racing ahead
        out = self._load_task(info, w, tls, whole)
        _M_STAGE_SECONDS.labels(stage="load").inc(time.time() - t0)
        _M_STAGE_TASKS.labels(stage="load").inc()
        return out

    def _load_task(self, info: A.GraphInfo, w: TaskItem, tls,
                   whole: bool) -> TaskItem:
        if _faults.ACTIVE:
            _faults.inject("pipeline.decode",
                           detail=f"task={w.job.job_idx},{w.task_idx}")
        with self.profiler.span("load", level=0, task=w.task_idx,
                                job=w.job.job_idx):
            chain = self._chains.get(w.job.job_idx)
            carry = chain.gate_plan(w.task_idx) if chain is not None \
                else None
            start, end = w.output_range
            wp = int(getattr(w.job.jr, "work_packet_size", 0) or 0)
            if w.job.stream_work_packets and not whole and wp > 0 \
                    and (end - start) > wp:
                # Work-packet streaming (reference element cache +
                # feeder, evaluate_worker.h:207-218): the task's io
                # packet never materializes whole — per-chunk plans
                # drive an incremental decode -> h2d -> compute
                # pipeline; peak memory is a few chunks, and the h2d of
                # chunk k+1 rides under the compute of chunk k.
                plans = []
                cur = dict(carry) if carry else None
                for cs in range(start, end, wp):
                    p = A.derive_task_streams(
                        info, w.job.jr, (cs, min(cs + wp, end)),
                        job_idx=w.job.job_idx, task_idx=w.task_idx,
                        carry=cur)
                    if p.carry_watermarks:
                        cur = dict(cur or {})
                        cur.update(p.carry_watermarks)
                    plans.append(p)
                # a video source whose rows span multiple table items
                # keeps the whole-task path: per-item geometry may
                # differ, which the ragged concat handles and the
                # streaming feed's uniform batches would not
                streamable = True
                for nid in plans[0].source_rows:
                    si = w.job.source_info[nid]
                    if si.get("is_video"):
                        desc = si["table"]
                        items = {desc.item_of_row(int(r))
                                 for p in plans
                                 for r in p.source_rows[nid]}
                        if len(items) > 1:
                            streamable = False
                            break
                if streamable:
                    if chain is not None:
                        chain.planned(w.task_idx, cur or {})
                    w.chunk_plans = plans
                    w.plan = None
                    w.elements = None
                    w.chunk_q = queue.Queue(maxsize=2)
                    w.chunk_abort = threading.Event()
                    w.decode_rows = int(sum(
                        len(r) for p in plans
                        for r in p.source_rows.values()))
                    return w
            w.plan = A.derive_task_streams(
                info, w.job.jr, w.output_range,
                job_idx=w.job.job_idx, task_idx=w.task_idx, carry=carry)
            if chain is not None:
                chain.planned(w.task_idx, w.plan.carry_watermarks)
            # sharded gang members: rows owned by neighbor shards are
            # dropped from this member's decode plan BEFORE loading —
            # the loader and frame cache never see them — and restored
            # afterwards so downstream row math stays whole-plan; the
            # halo_fill hook then splices the exchanged boundary rows
            # into the loaded batches (engine/gang.py _make_halo_filler)
            restore: Dict[int, Any] = {}
            if w.halo_drop:
                for nid, drop in w.halo_drop.items():
                    rows = w.plan.source_rows.get(nid)
                    if rows is None or not len(drop):
                        continue
                    restore[nid] = rows
                    w.plan.source_rows[nid] = \
                        rows[~np.isin(rows, drop)]
            w.decode_rows = int(sum(
                len(r) for r in w.plan.source_rows.values()))
            w.elements = self._load_sources(info, w, tls)
            if restore:
                w.plan.source_rows.update(restore)
            if w.halo_fill is not None:
                w.halo_fill(info, w)
            self._prestage_device_columns(info, w)
        return w

    def _prestage_device_columns(self, info: A.GraphInfo, w: TaskItem,
                                 elements: Optional[Dict[int, Any]] = None
                                 ) -> None:
        """Start the host->device transfer of device-bound source columns
        from the LOADER thread.  device_put is async: the copy proceeds
        while this loader decodes the next task and while the evaluator
        computes earlier tasks, so h2d overlaps decode instead of
        serializing at the front of the evaluate stage.  Only columns whose every
        first non-builtin consumer is a device kernel are staged — staging
        a host-kernel input would add a device->host round-trip.  The
        target is the device of the instance this task was assigned to at
        enqueue time (w.device)."""
        if not self.stage:
            return
        cols = w.elements if elements is None else elements
        staged = [nid for nid, b in cols.items()
                  if self._column_device_bound(info, nid)
                  and isinstance(b.data, np.ndarray)
                  and b.data.dtype != object]
        if not staged:
            return
        with self.profiler.span(
                "load:stage", bytes=sum(cols[n].data.nbytes for n in staged)):
            for nid in staged:
                cols[nid] = cols[nid].to_device(w.device)

    def _yuv_device_wire(self, info: A.GraphInfo, node_id: int) -> bool:
        """Should this video column decode to YUV420 wire format?  Yes
        when columns are staged onto the device and every first
        non-builtin consumer is a device kernel (so the conversion runs
        once, on the device)."""
        return self.stage and self._column_device_bound(info, node_id)

    def _pins_decode(self, info: A.GraphInfo, w: TaskItem,
                     node_id: int) -> bool:
        """Should this column's rows decode into pinned host memory?  Yes
        when the loader stages the column onto a CUDA device
        (`_prestage_device_columns`), which then ships the batch with no
        copy of its own."""
        return (self.stage and getattr(w.device, "type", None) == "cuda"
                and self._column_device_bound(info, node_id))

    def _column_device_bound(self, info: A.GraphInfo, node_id: int) -> bool:
        with self._device_bound_lock:
            cache = self._device_bound_cache
            if cache.get("info") is not info:
                cache.clear()
                cache["info"] = info
            if node_id in cache:
                return cache[node_id]
        by_id = {n.id: n for n in info.ops}
        devices: List[bool] = []
        seen = set()
        frontier = [node_id]
        while frontier:
            nid = frontier.pop()
            if nid in seen:
                continue
            seen.add(nid)
            for cid in info.consumers.get(nid, []):
                c = by_id[cid]
                if c.name == O.OUTPUT_OP:
                    devices.append(False)  # sink fetches to host
                elif c.is_builtin:
                    frontier.append(cid)   # gathers run wherever data is
                else:
                    devices.append(
                        c.effective_device() == DeviceType.TPU)
        res = bool(devices) and all(devices)
        with self._device_bound_lock:
            if self._device_bound_cache.get("info") is info:
                self._device_bound_cache[node_id] = res
        return res

    def _load_sources(self, info: A.GraphInfo, w: TaskItem,
                      tls) -> Dict[int, ColumnBatch]:
        """Read/decode exactly the rows the task needs.  Video sources
        arrive as ONE contiguous (N, H, W, 3) batch straight from the
        decoder — the zero-copy head of the batched data path."""
        out: Dict[int, ColumnBatch] = {}
        for node_id, rows in w.plan.source_rows.items():
            si = w.job.source_info[node_id]
            rows_arr = np.asarray(rows, np.int64)
            rows_l = [int(r) for r in rows]
            if not si["is_video"]:
                out[node_id] = self._load_plain_source(
                    w, node_id, rows_l, tls,
                    pin=self._pins_decode(info, w, node_id))
            elif si["is_video"]:
                # rows are global; multi-item video tables (job outputs)
                # hold one independently-decodable item per task
                desc = si["table"]
                # Device-bound frame columns decode to planar YUV420 and
                # convert to RGB ON the accelerator (kernels/color.py):
                # 1.5 B/px instead of 3 B/px over the host->device link,
                # the first-order term of device pipelines (PERF.md §1;
                # the reference shipped NV12 and converted on-GPU,
                # util/image.cu:22).
                fmt = ("yuv420" if self._yuv_device_wire(info, node_id)
                       else "rgb24")
                # paged frame cache (engine/framecache.py): rows already
                # resident in pages on this task's device skip decode
                # AND the host->device copy; only miss ranges decode
                cached = self._load_video_cached(info, w, node_id, si,
                                                 rows_l, fmt, tls)
                if cached is not None:
                    out[node_id] = cached
                    continue
                by_item: Dict[int, List[int]] = {}
                for r in rows_l:
                    it = desc.item_of_row(r)
                    start, _ = desc.item_bounds(it)
                    by_item.setdefault(it, []).append(r - start)
                parts: List[ColumnBatch] = []
                for it, local in sorted(by_item.items()):
                    start, _ = desc.item_bounds(it)
                    auto = self._automata(tls, w.job, node_id, si, it,
                                          output_format=fmt)
                    t0 = time.time()
                    with self.profiler.span("load:decode", rows=len(local)):
                        frames = auto.get_frames(local)
                    lbl = threading.current_thread().name
                    _M_DECODED.labels(loader=lbl).inc(len(local))
                    _M_DECODE_SECONDS.labels(loader=lbl).inc(
                        time.time() - t0)
                    # convert mark carries THIS item's geometry (items of
                    # one table may differ); mixed-geometry concat falls
                    # back to host conversion in concat_batches
                    convert = (("yuv420", auto.vd.height, auto.vd.width)
                               if fmt == "yuv420" else None)
                    parts.append(ColumnBatch(
                        np.asarray(local, np.int64) + start, frames,
                        convert=convert))
                out[node_id] = concat_batches(parts)
        return out

    def _load_plain_source(self, w: TaskItem, node_id: int,
                           rows_l: List[int], tls,
                           pin: bool) -> ColumnBatch:
        """Non-video source rows: custom-storage reads or column loads
        (shared by the whole-task and per-chunk streaming loaders).  A
        column load reads into the row buffer `tls` keeps, and decodes
        before this thread's next read reuses it, into one batch
        (`decode_rows_into`): in pinned memory with `pin`."""
        si = w.job.source_info[node_id]
        rows_arr = np.asarray(rows_l, np.int64)
        n = len(rows_l)
        if "custom" in si:
            with self.profiler.span("load:read", rows=n):
                vals = si["custom"].storage.read_rows(si["custom"], rows_l)
            with self.profiler.span("load:decode", rows=n):
                return ColumnBatch.from_elements(rows_arr, vals)
        from ..storage.items import RowBuffer
        from ..storage.streams import DECODE_COPIES, decode_rows_into
        desc = si["table"]
        codec = si.get("codec", "raw")
        buf = getattr(tls, "row_buffer", None)
        if buf is None:
            buf = tls.row_buffer = RowBuffer()
        with self.profiler.span("load:read", rows=n) as sp:
            vals = self.db.read_rows_into(
                desc.id, si["column"], rows_l, buf,
                sparsity_threshold=w.job.sparsity_threshold)
            sp.set_args(bytes=sum(len(v) for v in vals if v is not None),
                        reads=buf.reads)
            if codec not in DECODE_COPIES:
                # the row itself is the element: it must own its bytes
                vals = [None if v is None else bytes(v) for v in vals]
        self.profiler.count("load_read_fresh" if buf.grew
                            else "load_read_kept")
        with self.profiler.span("load:decode", rows=n):
            got = decode_rows_into(vals, codec,
                                   pinned_empty if pin else np.empty)
            if got.direct:
                self.profiler.count("load_decode_direct", got.direct)
            if got.generic:
                self.profiler.count("load_decode_generic", got.generic)
            if isinstance(got.data, np.ndarray):
                return ColumnBatch(rows_arr, got.data, got.nulls)
            return ColumnBatch.from_elements(rows_arr, got.data)

    def _cache_eligible(self, info: A.GraphInfo, node_id: int) -> bool:
        """Frame-cache eligibility for one video column: the cache holds
        device-staged pages, so only columns the executor stages for a
        device kernel qualify (the YUV420 wire's own condition) — and
        only while the kill switch is up (SCANNER_TPU_FRAME_CACHE=0)."""
        return _fc.enabled() and self._yuv_device_wire(info, node_id)

    @staticmethod
    def _keyint_of(si) -> int:
        """Keyframe-interval estimate for page sizing (pages should map
        onto GOP-decodable units); 0 = unknown."""
        vd = si.get("video_meta")
        ki = getattr(vd, "keyframe_indices", None) if vd is not None \
            else None
        if ki is not None and len(ki) > 1:
            return int(np.median(np.diff(np.asarray(ki, np.int64))))
        return 0

    def _load_video_cached(self, info: A.GraphInfo, w: TaskItem,
                           node_id: int, si, rows_l: List[int], fmt: str,
                           tls) -> Optional[ColumnBatch]:
        """The cache-consulting flavor of the whole-task video load:
        plan (pin resident pages on this task's chip), decode only the
        miss rows, offer them toward page completion, and assemble the
        task's column as a page-table gather.  None = ineligible or
        bypassed — the caller runs the direct decode+stage path."""
        if not self._cache_eligible(info, node_id) or not rows_l:
            return None
        desc = si["table"]
        items = {desc.item_of_row(int(r)) for r in rows_l}
        if len(items) != 1:
            # per-item geometry may differ (the ragged-concat path);
            # pages are per-item, so a multi-item task stays direct
            return None
        item = items.pop()
        start, end = desc.item_bounds(item)
        local = np.asarray(rows_l, np.int64) - start
        cache = _fc.cache()
        plan = cache.plan(w.device, (self._cache_db_key, desc.id),
                          si["column"], item, fmt, local,
                          total_rows=end - start,
                          keyint=self._keyint_of(si))
        # pin BEFORE decoding: a decode failure routes through
        # task_failed -> _release_cache, and the finalizer backstops
        _fc.attach_lease(w, plan.lease)
        miss = plan.miss_rows
        hw = plan.hw
        if len(miss):
            auto = self._automata(tls, w.job, node_id, si, item,
                                  output_format=fmt)
            t0 = time.time()
            with self.profiler.span("load:decode", rows=len(miss)):
                frames = auto.get_frames(miss.tolist())
            lbl = threading.current_thread().name
            _M_DECODED.labels(loader=lbl).inc(len(miss))
            _M_DECODE_SECONDS.labels(loader=lbl).inc(time.time() - t0)
            hw = (auto.vd.height, auto.vd.width)
        else:
            frames = np.zeros((0, 1), np.uint8)
        if fmt == "yuv420" and not (hw and hw[0]):
            return None  # no geometry for the convert mark: bypass
        try:
            data = cache.assemble(plan, miss, frames, hw=hw)
        except _fc.CacheBypass:
            # falling back here re-decodes the miss rows on the direct
            # path (double decode for this one task).  Acceptable: a
            # bypass after plan() requires a pinned hit row to vanish,
            # which pinning exists to prevent — this is a correctness
            # backstop, not a path with a cost budget.
            return None
        convert = (("yuv420", hw[0], hw[1]) if fmt == "yuv420" else None)
        return ColumnBatch(np.asarray(rows_l, np.int64), data,
                           convert=convert)

    def _release_cache(self, w: TaskItem) -> None:
        """Unpin the task's frame-cache pages (evaluation is done with
        them, or the task failed/was revoked).  Idempotent; leases a
        dropped TaskItem never reaches release on are backstopped by
        the finalizer attach_lease installed."""
        leases, w.cache_leases = w.cache_leases, None
        for lease in leases or ():
            lease.release()

    @staticmethod
    def _close_decoders(*spaces) -> None:
        """Close the decoder handles each thread namespace holds
        (_automata) and forget them."""
        for ns in spaces:
            for auto in getattr(ns, "automata", {}).values():
                auto.close()
            ns.automata = {}

    def _automata(self, tls, job: JobContext, node_id: int, si,
                  item: int = 0, output_format: str = "rgb24"):
        cache = getattr(tls, "automata", None)
        if cache is None:
            cache = {}
            tls.automata = cache
        key = (job.job_idx, node_id, item, output_format)
        if key not in cache:
            from ..video.automata import DecoderAutomata
            desc = si["table"]
            if item == 0:
                vd = si["video_meta"]
            else:
                vd = md.VideoDescriptor.deserialize(self.db.backend.read(
                    md.video_meta_path(desc.id, si["column"], item)))
            cache[key] = DecoderAutomata(
                self.db.backend, vd,
                md.column_item_path(desc.id, si["column"], item),
                n_threads=self.decoder_threads,
                output_format=output_format)
        return cache[key]

    def _save_task(self, info: A.GraphInfo, w: TaskItem) -> None:
        """Encode + write one item per sink (reference save_worker.cpp +
        PostEvaluateWorker video encode, evaluate_worker.cpp:1373-1560)."""
        if _faults.ACTIVE:
            _faults.inject("pipeline.save",
                           detail=f"task={w.job.job_idx},{w.task_idx}")
        start, end = w.output_range
        for sink in info.sinks:
            if sink.id in w.job.custom_sinks:
                stream = w.job.custom_sinks[sink.id]
                stream.storage.write_item(
                    stream, start,
                    self._sink_rows(w.results[sink.id], start, end))
                continue
            if sink.id not in w.job.sink_tables:
                continue
            desc, col_name, codec, enc_opts = w.job.sink_tables[sink.id]
            # the single device->host fetch of the batched data path
            rows = self._sink_rows(w.results[sink.id], start, end)
            item_idx = w.task_idx
            if codec == "frame":
                mode = "video" if self._is_encodable(rows) else "pickle"
                with w.job.sink_mode_lock:
                    prev = w.job.sink_modes.get(sink.id)
                    if prev is None:
                        # cross-worker guard: exactly one writer (across all
                        # processes) creates the durable marker; everyone
                        # else reads the winner's mode (distributed savers
                        # share no process state)
                        marker = f"{md.table_dir(desc.id)}/.{col_name}.mode"
                        if self.db.backend.write_exclusive(
                                marker, mode.encode()):
                            prev = mode
                        else:
                            prev = self.db.backend.read(marker).decode()
                        w.job.sink_modes[sink.id] = prev
                    if prev != mode:
                        raise JobException(
                            f"{desc.name}: mixed frame output types across "
                            f"tasks ({prev} vs {mode}); kernels must "
                            f"produce a consistent frame dtype")
                    if mode == "pickle":
                        self._demote_video_column(desc)
                if mode == "video":
                    self._write_video_item(w.job, desc, col_name, item_idx,
                                           rows, enc_opts)
                else:
                    # non-uint8/RGB frame data (e.g. float32 flow fields):
                    # the reference stores these as RAW-format video
                    # columns; here the column degrades to pickled arrays
                    import pickle
                    IT.write_item(
                        self.db.backend,
                        md.column_item_path(desc.id, col_name, item_idx),
                        [e if isinstance(e, NullElement)
                         else pickle.dumps(np.asarray(e),
                                           protocol=pickle.HIGHEST_PROTOCOL)
                         for e in rows])
            else:
                blobs = []
                for e in rows:
                    if isinstance(e, NullElement):
                        blobs.append(e)
                    elif codec == "raw":
                        if not isinstance(e, (bytes, bytearray, memoryview)):
                            raise JobException(
                                f"{desc.name}: raw column got "
                                f"{type(e).__name__}")
                        blobs.append(bytes(e))
                    else:
                        import pickle
                        blobs.append(pickle.dumps(
                            e, protocol=pickle.HIGHEST_PROTOCOL))
                IT.write_item(self.db.backend,
                              md.column_item_path(desc.id, col_name,
                                                  item_idx), blobs)

    def _prefetch_results(self, w: TaskItem) -> None:
        """Kick off the async device->host copy of every sink batch the
        moment evaluation finishes — hung off the TaskItem before it
        enters save_q, so task k's d2h latency rides under task k+1's
        evaluation instead of serializing inside the saver."""
        if not w.results:
            return
        for b in w.results.values():
            if isinstance(b, ColumnBatch):
                b.prefetch_host()

    @staticmethod
    def _sink_rows(batch, start: int, end: int) -> List[Any]:
        """Materialize a sink ColumnBatch's rows [start, end) as host
        elements (array rows become views).  The whole batch is fetched
        FIRST — completing the async copy _prefetch_results started at
        eval-done (a device-side slice would be a fresh array the
        prefetch never covered) — then the contiguous range takes
        ColumnBatch.take_range's direct-slice fast path on host."""
        return batch.to_host().take_range(start, end).elements()

    @staticmethod
    def _is_encodable(rows: List[Any]) -> bool:
        """True when the item is H.264-encodable (uint8 RGB).  Null rows in
        an otherwise-encodable item raise inside _write_video_item, matching
        the reference where video columns cannot hold nulls."""
        saw_frame = False
        for e in rows:
            if isinstance(e, NullElement):
                continue
            a = np.asarray(e)
            if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] != 3:
                return False
            saw_frame = True
        return saw_frame

    def _demote_video_column(self, desc: md.TableDescriptor) -> None:
        col = desc.columns[0]
        already = (col.type == md.ColumnType.BYTES and col.codec == "pickle")
        if not already:
            col.type = md.ColumnType.BYTES
            col.codec = "pickle"
            self.db.write_table_descriptor(desc)

    def _write_video_item(self, job: JobContext, desc: md.TableDescriptor,
                          col_name: str, item_idx: int, rows: List[Any],
                          enc_opts: Dict) -> None:
        from ..video.lib import Encoder
        frames = []
        for e in rows:
            if isinstance(e, NullElement):
                raise JobException(
                    f"{desc.name}: video output cannot store null rows; "
                    f"use a blob column")
            a = np.asarray(e)
            if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] != 3:
                raise JobException(
                    f"{desc.name}: video output requires uint8 HxWx3 "
                    f"frames, got {a.dtype} {a.shape}")
            frames.append(a)
        h, w_ = frames[0].shape[:2]
        keyint = int(enc_opts.get("keyint", 16))
        enc = Encoder(w_, h, fps=job.fps or 30.0, codec="libx264",
                      bitrate=int(enc_opts.get("bitrate", 0)),
                      crf=int(enc_opts.get("crf", 20)), keyint=keyint)
        try:
            for f in frames:
                enc.feed(f)
            enc.flush()
            data, sizes, keys, pts, dts = enc.take_packets()
            vd = md.VideoDescriptor(
                width=w_, height=h, fps=job.fps or 30.0,
                num_frames=len(frames), codec="h264",
                extradata=enc.extradata,
                sample_offsets=np.concatenate(
                    [[0], np.cumsum(sizes[:-1])]).astype(np.uint64)
                if len(sizes) else np.zeros(0, np.uint64),
                sample_sizes=sizes.astype(np.uint64),
                keyframe_indices=np.nonzero(keys)[0].astype(np.int64),
                sample_pts=pts, sample_dts=dts,
                tb_num=enc.fps_den, tb_den=enc.fps_num)
            self.db.backend.write(
                md.column_item_path(desc.id, col_name, item_idx), data)
            self.db.backend.write(
                md.video_meta_path(desc.id, col_name, item_idx),
                vd.serialize())
        finally:
            enc.close()
