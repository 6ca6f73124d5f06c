"""Distributed master/worker services.

Capability parity: reference scanner/engine/master.{h,cpp} +
worker.{h,cpp} + rpc.proto — dynamic task distribution (NextWork/
FinishedWork), worker liveness pinger with strike-out removal, per-task
timeout, job blacklisting after repeated task failures, elastic worker join,
client watchdog, progress reporting.

Differences from the reference, chosen deliberately:
  * Fully pull-based: the master never dials workers.  Workers heartbeat and
    pull tasks; a joining worker starts pulling immediately (elastic join
    without the reference's unstarted_workers dance, master.cpp:514-560).
  * The job spec travels as one cloudpickle blob (graph + resolved
    PerfParams), so there are no op/kernel registration RPCs
    (ListLoadedOps etc., worker.cpp:882-937) — the graph is self-contained.
  * Bulk data never crosses RPC: workers read/write shared storage, master
    owns all metadata writes — same storage-mediated data plane as the
    reference (SURVEY §2.7).  A payload never carries a tensor: rows
    reach storage as host values, and RPCs carry msgpack-able dicts.

Device placement (the PyTorch/CUDA port): the master runs no device op
— its admission and recovery executors are CPU executors that only
plan tasks and create tables.  A worker runs every task on its
`device` ("cuda" by default, "cuda:N" or "cpu", resolved by
`evaluate.resolve_device`, so asking for a card without one raises).
A bulk with `PerfParams.gang_hosts > 0` runs each task on a gang of
workers (engine/gang.py): the master forms the gang and fences it with
a `(gang_id, epoch)` pair, and each member runs in a child process of
its worker, on the worker's device.  A worker started with
`coordinator=` joins a process group for its whole lifetime (NCCL on
its card, gloo on the CPU; parallel/distributed.py `join`), as a JAX
worker joins jax.distributed; it pulls tasks like any other worker.

The file follows the JAX package's engine/service.py class for class:
its RPCs, journal records and checkpoint keys are the JAX package's.
`WorkerPipeline` is the worker's task path below its RPCs, split out of
`Worker` so that it runs from a local task source too.
"""

from __future__ import annotations

import heapq
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Set, Tuple, Union

import cloudpickle
import torch

from ..common import CacheMode, JobException, PerfParams, ScannerException
from ..parallel import distributed as _distributed
from ..storage import Database, make_storage
from ..storage import metadata as md
from ..storage.items import seal_blob
from ..util import clocksync as _clocksync
from ..util import coststats as _coststats
from ..util import faults as _faults
from ..util import health as _health
from ..util import memstats as _memstats
from ..util import metrics as _mx
from ..util import tracing as _tracing
from ..util.log import get_logger
from ..util.metrics import MetricsServer, merge_snapshots
from ..util.profiler import Profiler
from . import controller as _controller
from . import framecache as _framecache
from . import gang as _gang
from . import journal as _journal
from . import rpc
from . import shardmap as _shardmap
from .evaluate import (TaskEvaluator, default_pipeline_instances,
                       resolve_device)
from .executor import _M_TASK_LATENCY, LocalExecutor, TaskItem

PING_INTERVAL = 1.0          # worker heartbeat period
# per-call deadline for heartbeat/ping RPCs.  Deliberately ~2x the ping
# period instead of the 30s client default: a HUNG (accepting but not
# answering) master would otherwise pin the worker's heartbeat thread
# for 30s per call — long past WORKER_STALE_AFTER — and a healthy
# worker would be removed as stale purely because its liveness reports
# were stuck behind a slow peer.
PING_TIMEOUT = 2 * PING_INTERVAL
WORKER_STALE_AFTER = 6.0     # master: no heartbeat -> worker removed
MAX_TASK_FAILURES = 3        # reference master.cpp:2131 blacklist threshold
# transient (storage/RPC) task failures requeue WITHOUT counting a
# blacklist strike — a flaky dependency must not blacklist a healthy
# job.  But "transient" failures that never stop are not transient:
# past this many per task, they start counting strikes like any other
# failure so a dead storage backend still terminates the bulk.
MAX_TRANSIENT_FAILURES = 25
MASTER_SERVICE = "scanner.Master"
WORKER_SERVICE = "scanner.Worker"

# The wire contract of every registered RPC handler (both services):
# the client-side deadline a caller should use, and whether the handler
# is IDEMPOTENT — safe to blind-retry because a duplicate delivery
# cannot double-apply (non-idempotent methods mutate queue/strike/
# profile state and must only ride the UNAVAILABLE-only retry path,
# where the request provably never reached the server).  scanner-check
# SC307 enforces that this table and the registered handler dicts stay
# in sync; new handlers must be classified here to land.  Every
# idempotent=False entry additionally routes through the master's
# generation-fence wrapper (`Master._fenced`) so a superseded master
# cannot accept mutations — scanner-check SC312 keeps the table and
# the wrapped registrations in sync both directions.
# (NewJob stays classified non-idempotent: the admission-token dedupe
# makes a RETRY safe end-to-end, but only when the caller re-presents
# the token — the blind transport-level retry this flag governs does.)
RPC_CONTRACTS = {
    "Ping":             {"timeout_s": PING_TIMEOUT, "idempotent": True},
    "RegisterWorker":   {"timeout_s": 30.0, "idempotent": False},
    "UnregisterWorker": {"timeout_s": PING_TIMEOUT, "idempotent": True},
    "Heartbeat":        {"timeout_s": PING_TIMEOUT, "idempotent": True},
    "NewJob":           {"timeout_s": 120.0, "idempotent": False},
    "GetJob":           {"timeout_s": 30.0, "idempotent": True},
    "NextWork":         {"timeout_s": 30.0, "idempotent": False},
    "StartedWork":      {"timeout_s": 30.0, "idempotent": False},
    "EvalDone":         {"timeout_s": 30.0, "idempotent": True},
    "FinishedWork":     {"timeout_s": 30.0, "idempotent": False},
    # coalesced completion path (engine/shardmap.py): many FinishedWork
    # payloads in one RPC, one journal group-commit — the worker-side
    # batcher a per-shard fan-out needs to keep RPC volume flat
    "FinishedWorkBatch": {"timeout_s": 30.0, "idempotent": False},
    "FailedWork":       {"timeout_s": 30.0, "idempotent": False},
    "GetJobStatus":     {"timeout_s": 30.0, "idempotent": True},
    # the versioned shard map (engine/shardmap.py): served by every
    # shard so clients/workers can resolve routing from any of them
    "GetShardMap":      {"timeout_s": 30.0, "idempotent": True},
    "GetMetrics":       {"timeout_s": 30.0, "idempotent": True},
    "GetHealth":        {"timeout_s": 30.0, "idempotent": True},
    "PokeWatchdog":     {"timeout_s": 30.0, "idempotent": True},
    "PostProfile":      {"timeout_s": 30.0, "idempotent": False},
    "GetProfiles":      {"timeout_s": 30.0, "idempotent": True},
    "ShipSpans":        {"timeout_s": 30.0, "idempotent": False},
    "GetTrace":         {"timeout_s": 30.0, "idempotent": True},
    "ShipMemoryReport": {"timeout_s": 30.0, "idempotent": False},
    "GetMemoryReport":  {"timeout_s": 30.0, "idempotent": True},
    "GetCompileLedger": {"timeout_s": 30.0, "idempotent": True},
    # gang control plane (engine/gang.py): both mutate scheduling
    # state (ack bookkeeping / abort+requeue), so both are fenced —
    # and additionally fenced by (gang_id, epoch): a stale-epoch
    # report answers {"gang_stale": True} instead of being applied.
    # scanner-check SC313 pins every Gang* entry to this shape.
    "GangMemberDone":   {"timeout_s": 30.0, "idempotent": False},
    "GangFailed":       {"timeout_s": 30.0, "idempotent": False},
    "Shutdown":         {"timeout_s": PING_TIMEOUT, "idempotent": True},
}

# Every master RPC a sharded deployment routes per-shard via the shard
# map AND that mutates control-plane state.  scanner-check SC316 pins
# this tuple to the RPC_CONTRACTS idempotent=False set and to the
# `_fenced(...)`-wrapped registrations (extending SC312), both
# directions: a mutating RPC missing here would dodge the stale-map /
# generation fence audit, and an entry here that is not registered
# fenced would let a stale map route a mutation past a failover.
SHARD_ROUTED_RPCS = (
    "RegisterWorker", "NewJob", "NextWork", "StartedWork",
    "FinishedWork", "FinishedWorkBatch", "FailedWork", "PostProfile",
    "ShipSpans", "ShipMemoryReport", "GangMemberDone", "GangFailed",
)

# OOM forensic reports retained on the master (newest win): enough for
# a post-mortem across a worker fleet's pressure event, bounded so a
# flapping job cannot grow master memory
MAX_MEMORY_REPORTS = 16

# cross-host trace assembly bounds: spans kept per bulk on the master
# (overflow counts into the GetTrace/status `spans_dropped` field), the
# straggler top-N surfaced on /statusz + GetJobStatus, and how many
# RECENT bulks keep their full span store — a long-lived master serving
# many bulks must not retain 500k dicts per historical bulk forever
# (the straggler aggregates, which are tiny, are kept for all history)
MAX_BULK_SPANS = 500_000
STRAGGLER_TOP_N = 10
# per-gang straggler attribution rows retained per bulk (newest last);
# part of the straggler aggregates, so they survive compaction
MAX_GANG_SKEW_ROWS = 16
SPAN_HISTORY_BULKS = 4

_mlog = get_logger("master")
_wlog = get_logger("worker")

# control-plane telemetry (docs/observability.md).  The point-in-time
# gauges are refreshed by the master's 0.5s scan loop; the counters are
# bumped inline by the RPC handlers.
_M_WORKERS = _mx.registry().gauge(
    "scanner_tpu_master_workers_active",
    "Workers currently registered and heartbeating.")
_M_HB_AGE = _mx.registry().gauge(
    "scanner_tpu_worker_heartbeat_age_seconds",
    "Seconds since each worker's last heartbeat (master view).",
    labels=["worker"])
_M_TASKS_QUEUED = _mx.registry().gauge(
    "scanner_tpu_master_tasks_queued",
    "Tasks of the active bulk job waiting in the master queue.")
_M_TASKS_OUTSTANDING = _mx.registry().gauge(
    "scanner_tpu_master_tasks_outstanding",
    "Tasks currently assigned to workers (active bulk job).")
_M_TASKS_DONE = _mx.registry().counter(
    "scanner_tpu_master_tasks_completed_total",
    "Tasks completed across all bulk jobs this master served.")
_M_TASK_RETRIES = _mx.registry().counter(
    "scanner_tpu_task_retries_total",
    "Tasks re-queued after a failure or a started-task timeout.")
_M_REVOCATIONS = _mx.registry().counter(
    "scanner_tpu_task_revocations_total",
    "Task attempts revoked (timeout or stale-worker requeue).")
_M_STRIKES = _mx.registry().counter(
    "scanner_tpu_blacklist_strikes_total",
    "Task failures counted toward a job's blacklist threshold.")
_M_TRANSIENT = _mx.registry().counter(
    "scanner_tpu_transient_retries_total",
    "Worker-reported transient (storage/RPC) task failures requeued "
    "without a blacklist strike.")
_M_DRAINS = _mx.registry().counter(
    "scanner_tpu_worker_drains_total",
    "Workers that deregistered via SIGTERM drain (finish in-flight "
    "tasks, stop pulling, UnregisterWorker).")
_M_PREEMPTIONS = _mx.registry().counter(
    "scanner_tpu_worker_preemptions_total",
    "Preemption notices this worker received (spot/preemptible VM "
    "reclaim, or the worker.preempt chaos site): each one starts a "
    "routine drain with the master fencing assignment first.")
_M_PREEMPT_NOTICES = _mx.registry().counter(
    "scanner_tpu_worker_preempt_notices_total",
    "Preemption notices the master observed on worker heartbeats "
    "(master view; survives the preempted worker's exit) — assignment "
    "to the worker is fenced from the first notice.")
_M_ADMISSION_PAUSED = _mx.registry().gauge(
    "scanner_tpu_master_admission_paused",
    "1 while the master's job admission is paused by the "
    "admission_pause remediation playbook (sustained backpressure "
    "shed); NewJob answers a retryable admission_paused reply.")
_M_JOBS_BLACKLISTED = _mx.registry().counter(
    "scanner_tpu_jobs_blacklisted_total",
    "Jobs removed from their bulk after repeated task failures.")
_M_ADMISSION_DEDUP = _mx.registry().counter(
    "scanner_tpu_admission_dedup_total",
    "NewJob admissions deduplicated by client-minted admission token: "
    "a retry after an ambiguous timeout (or across a master restart) "
    "returned the already-admitted bulk id instead of double-running "
    "the bulk.")


def _is_transient_failure(exc: BaseException) -> bool:
    """Failures caused by the environment rather than the task itself —
    storage errors (including crc-detected item corruption), RPC/
    transport errors, timeouts.  The worker tags FailedWork with this so
    the master requeues without a blacklist strike: a flaky dependency
    must not blacklist a healthy job, while a deterministic kernel bug
    still strikes out after MAX_TASK_FAILURES."""
    import grpc

    from ..common import StorageException
    from ..parallel.distributed import RendezvousError
    if _memstats.is_oom(exc):
        # device memory exhaustion: the pressure came from co-scheduled
        # work, not this task — requeue strike-free (the failed attempt
        # freed its staged buffers on the way out)
        return True
    # a failed process-group rendezvous means the PEER SET changed
    # (a member died, a coordinator moved) — the task is fine; the
    # gang re-forms on the remaining capacity strike-free
    return isinstance(exc, (StorageException, rpc.RpcError, grpc.RpcError,
                            ConnectionError, TimeoutError,
                            RendezvousError))


# ---------------------------------------------------------------------------
# Master
# ---------------------------------------------------------------------------

@dataclass
class _WorkerInfo:
    worker_id: int
    address: str
    last_seen: float
    active: bool = True
    # host:port this worker's gang member runner would serve the
    # gang's TCPStore at if elected member 0 (advertised at
    # registration; empty = the worker cannot coordinate a gang)
    gang_address: str = ""
    # spot/preemptible reclaim notice seen on a heartbeat: assignment
    # to this worker is FENCED (NextWork answers wait) while its drain
    # completes — requeues of whatever it cannot finish stay strike-free
    preempting: bool = False
    # alert rule names this worker reported firing on its last
    # heartbeat — the cross-node signal feed for the remediation
    # controller (stage_backpressure lives in worker processes; the
    # master's local health engine cannot see it)
    firing: Set[str] = field(default_factory=set)


@dataclass
class _Gang:
    """One co-scheduled task group (docs/robustness.md §Gang
    scheduling): the member set, its rendezvous wiring, and the
    (gang_id, epoch) fence every gang RPC must present.  Lives in
    `_BulkJob.gangs` from formation until member 0's FinishedWork is
    accepted or the gang aborts — after either, every late report with
    this (gang_id, epoch) is NACKed (`gang_stale`)."""

    gang_id: int
    epoch: int
    key: Tuple[int, int]                 # the (job, task) the gang runs
    attempt: int
    members: List[int]                   # worker ids; members[0] is the
    coordinator: str                     # member 0's gang address
    formed_at: float
    roles_handed: Set[int] = field(default_factory=set)
    acks: Set[int] = field(default_factory=set)   # non-0 members done
    # sharded gangs: member rank -> its shard digest, recorded from
    # GangMemberDone acks that beat the writer's FinishedWork; the
    # commit fold cross-checks them against the digests the writer
    # assembled from (count_shard_fold)
    shard_digests: Dict[int, int] = field(default_factory=dict)
    trace_parent: str = ""               # gang root span traceparent


@dataclass
class _BulkJob:
    bulk_id: int
    spec_blob: bytes                    # graph + resolved perf + cache mode
    task_timeout: float
    # write the table megafile every N completed tasks so a master crash
    # mid-bulk loses at most N tasks of metadata (reference checkpoint
    # every N jobs, master.cpp:1100-1113); 0 disables
    checkpoint_frequency: int = 0
    # Per-job deques + a round-robin ring of job ids: NextWork pops are
    # O(1) (the reference shards tasks for the same reason,
    # master.cpp:1558-1607), and a sticky job bound to another worker is
    # skipped as a WHOLE job — a single shared deque would make every
    # other worker rescan that job's (possibly 10^5) queued tasks per
    # poll, starving later jobs behind it
    queue: Dict[int, Deque[int]] = field(default_factory=dict)
    job_rr: Deque[int] = field(default_factory=deque)
    # (job, task) -> (worker id, clock start, attempt id, started,
    # eval_done).  The `started` flag records whether StartedWork arrived
    # for this attempt: a timeout revocation of a task that only WAITED in
    # a worker's queue is a scheduling artifact and must not count toward
    # job blacklisting.  The attempt id
    # makes assignments distinguishable: after a timeout revocation the
    # same worker may legitimately be re-assigned the task while its stale
    # attempt still runs, and only the *current* attempt's completion may
    # count (reference master.cpp:2111 stop_job_on_worker kills the stale
    # attempt instead; here it reports and is ignored).  `eval_done` means
    # the task is parked in the worker's save stage: it stays outstanding
    # (timeout/fault tracking) but no longer counts against the worker's
    # NextWork window (`held`).
    outstanding: Dict[Tuple[int, int],
                      Tuple[int, float, int, bool, bool]] = \
        field(default_factory=dict)
    next_attempt: int = 0
    # stateful task affinity (PerfParams.stateful_task_affinity + an
    # unbounded-state op in the graph): each job's tasks go, in order,
    # to one worker (reference save_coordinator worker.cpp:373-415);
    # rebound when that worker dies
    sticky: bool = False
    sticky_worker: Dict[int, int] = field(default_factory=dict)
    # worker id -> the sticky job it is currently draining; NextWork
    # serves this job to exhaustion before the ring hands the worker
    # another sticky job — interleaving two chained jobs on one
    # single-instance evaluator would reset kernel streams on every
    # switch and carry-miss every task
    sticky_cur: Dict[int, int] = field(default_factory=dict)
    # per-worker count of outstanding assignments (kept in sync with
    # `outstanding` so the NextWork window check is O(1))
    held: Dict[int, int] = field(default_factory=dict)
    done: Set[Tuple[int, int]] = field(default_factory=set)
    # per-job done-task counts, maintained where done.add happens: the
    # 4 Hz GetJobStatus poll must stay O(jobs) under the control-plane
    # lock, not O(total_tasks)
    job_done: Dict[int, int] = field(default_factory=dict)
    failures: Dict[Tuple[int, int], int] = field(default_factory=dict)
    # transient (storage/RPC) failures per task: requeued strike-free up
    # to MAX_TRANSIENT_FAILURES, then they fall through to `failures`
    transient_failures: Dict[Tuple[int, int], int] = \
        field(default_factory=dict)
    blacklisted_jobs: Set[int] = field(default_factory=set)
    total_tasks: int = 0
    # counters so the finish check is O(1) per FinishedWork (a set
    # comprehension over 10^5-10^6 tasks per completion would be
    # quadratic): tasks in blacklisted jobs, and done-tasks among them
    blacklisted_task_total: int = 0
    done_in_blacklisted: int = 0
    job_tasks: Dict[int, Set[Tuple[int, int]]] = field(default_factory=dict)
    # job idx -> output table names, resolved at admission so completion
    # commits never deserialize the graph under the control-plane lock
    job_sink_names: Dict[int, List[str]] = field(default_factory=dict)
    # job idx -> custom sink streams (finished() barrier on completion)
    job_custom_sinks: Dict[int, list] = field(default_factory=dict)
    job_output_rows: Dict[int, int] = field(default_factory=dict)
    committed_jobs: Set[int] = field(default_factory=set)
    finished: bool = False
    error: str = ""
    profiles: List[dict] = field(default_factory=list)
    # distributed tracing (util/tracing.py): the job's trace_id (from
    # the submitting client's traceparent, or minted at admission), the
    # master-side parent span id new assign spans chain under, the
    # assembled cross-host span store (workers ShipSpans into it), and
    # the incrementally-maintained straggler aggregates — per-stage
    # duration stats plus a bounded min-heap of the slowest task spans
    # ((duration, seq, job, task, node, span_id); seq breaks duration
    # ties so heterogenous payloads never reach tuple comparison)
    trace_id: str = ""
    trace_parent: str = ""
    spans: List[dict] = field(default_factory=list)
    span_drops: int = 0
    span_stats: Dict[str, List[float]] = field(default_factory=dict)
    # per-op roofline aggregates from op.efficiency span events
    # ([eff_sum, n, memory_bound_n] per evaluate:<op> span name) — the
    # straggler summary joins them so a slow stage is attributable to
    # *inefficient* (low eff) vs *overloaded* (high eff, long queue)
    eff_stats: Dict[str, List[float]] = field(default_factory=dict)
    slowest: List[Tuple] = field(default_factory=list)
    slow_seq: int = 0
    # live-status bookkeeping: output rows per task (from the admission
    # job geometry) and cumulative rows through each pipeline stage
    # transition the master observes (NextWork->StartedWork = loaded,
    # EvalDone = evaluated, FinishedWork = saved).  GetJobStatus and
    # /statusz derive per-stage fps and the ETA from these — one source
    # of truth for the client progress bar and the endpoint.
    admitted_at: float = field(default_factory=time.time)
    task_rows: Dict[Tuple[int, int], int] = field(default_factory=dict)
    stage_rows: Dict[str, int] = field(
        default_factory=lambda: {"load": 0, "evaluate": 0, "save": 0})
    # tasks already counted per stage: a retried attempt's second
    # StartedWork/EvalDone must not double-count its rows, or the
    # load/evaluate fps would read (retries+1)x the save fps on a flaky
    # cluster ('save' dedupes via `done`)
    stage_seen: Dict[str, Set[Tuple[int, int]]] = field(
        default_factory=lambda: {"load": set(), "evaluate": set()})

    # client-minted admission token (NewJob dedupe): persisted with the
    # checkpoint/journal so a retried NewJob returns this bulk's id
    # even across a master restart
    admission_token: str = ""
    # wall-clock end of the bulk; 0 while running.  Status fps/elapsed
    # freeze here so querying a historical bulk an hour later does not
    # decay its throughput toward zero.
    finished_at: float = 0.0
    # active-done count when this _BulkJob object started serving (0 at
    # admission; the restored done-count after a master restart).  The
    # ETA divides post-start progress by post-start elapsed — dividing
    # checkpoint-restored completions by seconds-since-recovery would
    # report a completion rate off by orders of magnitude.
    done_at_start: int = 0
    # gang scheduling (PerfParams.gang_hosts > 0): each task is
    # co-scheduled onto a gang of up to gang_hosts live workers
    # instead of answering independent pulls.  `gang_epoch` is the
    # bulk-wide monotonic fence — minted fresh per formation, bumped
    # again on every abort, restored >= its journaled high-water mark
    # across a master failover — so a completion from a superseded
    # gang can never double-commit.  `gang_forming` is the pool of
    # workers waiting for the next formation (joined-order), and
    # `gang_aborted_keys` marks tasks whose re-formation counts as a
    # reform in the metrics.
    gang_hosts: int = 0
    # mesh-partitioned gang evaluation (engine/gang.py sharded members):
    # decided once per bulk from PerfParams.gang_sharded AND the
    # master's [gang] sharded config, and carried on every role reply so
    # all members of a gang run the same mode; gang_halo rides along
    # the same way ([gang] halo_exchange)
    gang_sharded: bool = True
    gang_halo: bool = True
    next_gang_id: int = 0
    gang_epoch: int = 0
    gangs: Dict[int, _Gang] = field(default_factory=dict)
    gang_by_task: Dict[Tuple[int, int], int] = field(default_factory=dict)
    gang_forming: Dict[int, float] = field(default_factory=dict)
    gang_forming_since: float = 0.0
    gang_aborted_keys: Set[Tuple[int, int]] = field(default_factory=set)
    # scan-loop watchdog clock: since when the fleet has had live
    # workers but ZERO gang-capable ones (no gang_address — e.g. the
    # whole fleet runs SCANNER_TPU_GANG=0) while this gang bulk still
    # has work; 0 = capable capacity exists.  Past no_workers_timeout
    # the bulk fails loudly instead of waiting forever on formations
    # that can never happen.
    gang_incapable_since: float = 0.0
    # gangs retired by an accepted member-0 completion (gang_id ->
    # epoch, insertion-bounded): a surviving member's ack that lands
    # AFTER the single writer committed is acknowledged quietly
    # instead of counting as a stale-epoch NACK — it is the normal
    # tail of a healthy gang, not fence traffic
    gang_retired: Dict[int, int] = field(default_factory=dict)
    # cross-host time plane (util/clocksync.py): node -> the worker's
    # most recent advertised {offset, uncertainty, at}, refreshed from
    # heartbeats and from the clock field on every ShipSpans /
    # FinishedWork batch.  GetTrace rebases that node's spans onto
    # master time with it (unless raw_clocks / rebase disabled); the
    # barrier-skew fold corrects member arrival stamps with it.
    clock_offsets: Dict[str, dict] = field(default_factory=dict)
    # (gang_id, epoch) -> in-flight barrier-arrival fold: per-member
    # offset-corrected arrival stamps from absorbed gang.barrier spans.
    # Once all `num` members reported, the max-min skew is observed
    # into the skew histogram and an attribution row is appended.
    gang_arrivals: Dict[Tuple[int, int], dict] = field(
        default_factory=dict)
    # bounded ring of per-gang straggler attribution rows (newest
    # last): gang/epoch, the slowest member's node, its lag vs the
    # median arrival, and whether the gang step was barrier-bound or
    # collective-bound.  Part of the straggler aggregates — survives
    # compaction.
    gang_skew_rows: List[dict] = field(default_factory=list)
    # retention: when this bulk ages out of the last-N history ring its
    # heavy scheduling state (done set, task_rows, per-task maps, the
    # span store) is dropped and status queries serve from this frozen
    # snapshot — Client.stragglers/GetTrace keep working post-completion
    # (aggregates survive compaction; raw spans do not)
    compacted: bool = False
    status_frozen: Optional[dict] = None

    def count_stage(self, stage: str, key: Tuple[int, int]) -> None:
        if key not in self.stage_seen[stage]:
            self.stage_seen[stage].add(key)
            self.stage_rows[stage] += self.task_rows.get(key, 0)

    def mark_finished(self) -> None:
        self.finished = True
        if not self.finished_at:
            self.finished_at = time.time()

    def compact(self, frozen_status: dict) -> None:
        """Drop the heavy per-task state of a finished bulk that aged
        out of the history ring; a long-lived master serving thousands
        of bulks keeps only the tiny straggler aggregates + a frozen
        status per historical bulk instead of 10^5-task done-sets and
        span stores."""
        self.compacted = True
        self.status_frozen = frozen_status
        self.spans = []
        self.done = set()
        self.task_rows = {}
        self.job_tasks = {}
        self.queue = {}
        self.job_rr = deque()
        self.outstanding = {}
        self.held = {}
        self.failures = {}
        self.transient_failures = {}
        self.stage_seen = {"load": set(), "evaluate": set()}
        self.sticky_worker = {}
        self.sticky_cur = {}
        self.gangs = {}
        self.gang_by_task = {}
        self.gang_forming = {}
        self.gang_retired = {}
        self.gang_aborted_keys = set()
        # raw spans are gone, so the per-node rebase map and any
        # incomplete barrier folds go with them; the finished
        # gang_skew_rows are aggregates and stay
        self.clock_offsets = {}
        self.gang_arrivals = {}
        # profiles are deliberately KEPT: GetProfiles / Client.trace
        # device lanes retained them for all history before compaction
        # existed, and they are per-worker (bounded per bulk), not
        # per-task

    def q_push(self, key: Tuple[int, int], front: bool = False) -> None:
        j, t = key
        dq = self.queue.get(j)
        if dq is None:
            dq = self.queue[j] = deque()
            self.job_rr.append(j)
        if front:
            # requeued (revoked/failed/worker-death) task: re-insert in
            # TASK ORDER — sticky chains want the job's deque ascending,
            # and several requeues arriving ascending would reverse at
            # the head with a plain appendleft.  Requeues are rare; the
            # O(n) re-sort is fine.
            if dq and t > dq[0]:
                items = sorted(set(dq) | {t})
                dq.clear()
                dq.extend(items)
            else:
                dq.appendleft(t)
        else:
            dq.append(t)

    def q_count(self) -> int:
        return sum(len(dq) for dq in self.queue.values())

    def q_has_work(self) -> bool:
        return any(self.queue.values())


class Master:
    """The cluster control plane; also the single metadata writer."""

    def __init__(self, db_path: str, port: int = 0,
                 no_workers_timeout: float = 30.0,
                 enable_watchdog: bool = False,
                 storage_type: str = "posix",
                 metrics_port: Optional[int] = None,
                 metrics_host: str = "0.0.0.0",
                 # remediation (engine/controller.py): True builds an
                 # AutoscaleConfig from the [remediation] bounds, or
                 # pass a config; scale_actuator is the pluggable
                 # replica setter (a cluster manager's scale in prod, a
                 # callback in tests; None = audit-only, the desired
                 # count still lands on the autoscale gauge)
                 autoscale=None,
                 scale_actuator=None,
                 # sharded control plane (engine/shardmap.py): this
                 # master's shard id and the deployment's shard count
                 # (None = the [control] shards config default).  All
                 # durable control state — generation claims,
                 # checkpoints, journals — scopes under the shard's
                 # namespace; shard 0 of a 1-shard deployment is the
                 # classic single master, bit-for-bit.
                 shard_id: int = 0,
                 num_shards: Optional[int] = None,
                 advertise_host: str = "localhost"):
        self.db = Database(make_storage(storage_type, db_path=db_path))
        self.no_workers_timeout = no_workers_timeout
        self.shard_id = max(0, int(shard_id))
        self.num_shards = max(1, int(
            num_shards if num_shards is not None
            else _shardmap.num_shards()))
        self._advertise_host = advertise_host
        # the newest shard-map epoch this master has observed — the
        # fence `_fenced` NACKs stale-map mutations against; 0 until a
        # map exists (single-shard deployments never publish one)
        self._map_epoch = 0
        self._shard_map: Optional[_shardmap.ShardMap] = None
        _shardmap.note_identity(self.shard_id, self.num_shards)
        self.enable_watchdog = enable_watchdog
        # master-side span sink (export drained into each bulk's span
        # store): admission/assignment spans are the cross-host glue
        # between the client's root span and worker task spans
        self.tracer = _tracing.Tracer(node="master", export=True)
        self._lock = threading.RLock()
        self._admit_lock = threading.Lock()
        self._workers: Dict[int, _WorkerInfo] = {}
        self._next_worker_id = 0
        self._next_bulk_id = 0
        self._bulk: Optional[_BulkJob] = None
        self._history: Dict[int, _BulkJob] = {}
        # cluster-level clock-offset map (node -> the newest advertised
        # estimate, from heartbeats): seeds each bulk's rebase map so a
        # bulk admitted after the fleet converged starts corrected
        self._clock_offsets: Dict[str, dict] = {}
        # OOM forensic reports shipped by workers (ShipMemoryReport),
        # newest-last, bounded — served back by GetMemoryReport next to
        # this process's own memstats view
        self._mem_reports: Deque[dict] = deque(maxlen=MAX_MEMORY_REPORTS)
        self._last_poke = time.time()
        self._no_worker_since = time.time()
        self._cleared_bulk_id: Optional[int] = None
        self._shutdown = threading.Event()
        # durable control plane (engine/journal.py): claim a monotonic
        # master generation via storage CAS — every mutating RPC reply
        # is stamped with it, checkpoint/journal paths are scoped by
        # it, and a master that sees a newer claim fences itself.
        self.generation = _journal.claim_generation(
            self.db.backend, shard=self.shard_id)
        self._fence = threading.Event()
        self._journal: Optional[_journal.BulkJournal] = (
            _journal.BulkJournal(self.db.backend, self.generation,
                                 shard=self.shard_id)
            if _journal.enabled() else None)
        # NewJob admission-token dedupe: token -> bulk_id, bounded by
        # the insertion ring (a retry after an ambiguous timeout — or
        # across a master restart, via the journaled admit record —
        # returns the existing bulk instead of double-running it)
        self._admission_tokens: Dict[str, int] = {}
        self._admission_token_ring: Deque[str] = deque()
        # a forced-generation (SCANNER_TPU_MASTER_GENERATION) master
        # may already be stale at startup: fence BEFORE recovery so it
        # neither adopts nor persists anything
        self._check_fence()
        # resume an interrupted bulk BEFORE serving RPCs: workers that
        # re-register see the restored bulk as active and pull its
        # remaining tasks (reference recover_and_init_database,
        # master.cpp:1311 + checkpoint master.cpp:1100-1113)
        if not self._fence.is_set():
            self._recover_bulk()
        # every idempotent=False (mutating) handler routes through the
        # generation fence (scanner-check SC312 pins this wrapping to
        # the RPC_CONTRACTS table, both directions)
        self._server = rpc.RpcServer(MASTER_SERVICE, {
            "Ping": self._rpc_ping,
            "RegisterWorker": self._fenced(self._rpc_register_worker),
            "UnregisterWorker": self._rpc_unregister_worker,
            "Heartbeat": self._rpc_heartbeat,
            "NewJob": self._fenced(self._rpc_new_job),
            "GetJob": self._rpc_get_job,
            "NextWork": self._fenced(self._rpc_next_work),
            "StartedWork": self._fenced(self._rpc_started_work),
            "EvalDone": self._rpc_eval_done,
            "FinishedWork": self._fenced(self._rpc_finished_work),
            "FinishedWorkBatch": self._fenced(
                self._rpc_finished_work_batch),
            "FailedWork": self._fenced(self._rpc_failed_work),
            "GetJobStatus": self._rpc_job_status,
            "GetShardMap": self._rpc_get_shard_map,
            "GetMetrics": self._rpc_get_metrics,
            "GetHealth": self._rpc_get_health,
            "PokeWatchdog": self._rpc_poke,
            "PostProfile": self._fenced(self._rpc_post_profile),
            "GetProfiles": self._rpc_get_profiles,
            "ShipSpans": self._fenced(self._rpc_ship_spans),
            "GetTrace": self._rpc_get_trace,
            "ShipMemoryReport": self._fenced(
                self._rpc_ship_memory_report),
            "GangMemberDone": self._fenced(self._rpc_gang_member_done),
            "GangFailed": self._fenced(self._rpc_gang_failed),
            "GetMemoryReport": self._rpc_get_memory_report,
            "GetCompileLedger": self._rpc_get_compile_ledger,
            "Shutdown": self._rpc_shutdown,
        }, port=port, tracer=self.tracer)
        self.port = self._server.port
        self._server.start()
        # sharded deployments publish this shard's address into the
        # durable map (epoch bump — the signal every map holder
        # refreshes on).  A fenced master publishes nothing: its
        # successor owns the shard's map entry now.
        self.advertise_address = f"{advertise_host}:{self.port}"
        if self.num_shards > 1 and not self._fence.is_set():
            try:
                self._adopt_shard_map(_shardmap.register_shard(
                    self.db.backend, self.shard_id,
                    self.advertise_address, self.num_shards))
            except Exception:  # noqa: BLE001 — map publish is not
                # worth failing startup over; the scan loop retries
                _mlog.exception("shard-map publish failed at startup")
        # /metrics + /healthz + /statusz — strictly opt-in: no listener
        # exists unless metrics_port is given (0 = ephemeral port, see
        # .metrics_server.port)
        self.metrics_server: Optional[MetricsServer] = None
        if metrics_port is not None:
            self.metrics_server = MetricsServer(
                port=metrics_port, statusz=self._statusz,
                healthz=lambda: {"role": "master"}, host=metrics_host)
        # the health/SLO engine (util/health.py): worker-liveness and
        # latency-burn rules read series this process maintains, so the
        # master always evaluates them — /healthz, GetJobStatus and
        # GetHealth report the roll-up
        _health.ensure_started()
        # remediation (engine/controller.py): the master owns the
        # admission gate and the autoscaler, so it binds their actions
        # here; the scan loop ticks the controller (hysteresis holds)
        # and feeds worker-reported alerts + the autoscale observation.
        # All of it is inert under SCANNER_TPU_REMEDIATION=0.
        self._admission_paused: Optional[str] = None
        self._worker_firing: Set[str] = set()
        self.autoscaler: Optional[_controller.Autoscaler] = None
        if autoscale:
            cfg = autoscale if isinstance(
                autoscale, _controller.AutoscaleConfig) else \
                _controller.AutoscaleConfig(
                    *_controller.autoscale_bounds())
            self.autoscaler = _controller.Autoscaler(
                cfg, actuator=scale_actuator)
        if _controller.ensure_started() is not None:
            _controller.register_action("pause_admission",
                                        self._pause_admission)
            _controller.register_action("resume_admission",
                                        self._resume_admission)
            _controller.register_action("autoscale",
                                        self._autoscale_nudge)
        self._scan_thread = threading.Thread(
            target=self._scan_loop, name="master-scan", daemon=True)
        self._scan_thread.start()

    # -- generation fence (engine/journal.py) -------------------------------

    def _fenced(self, fn):
        """Generation-fence guard every mutating (idempotent=False)
        master handler routes through (scanner-check SC312): a fenced
        — superseded — master accepts ZERO mutations, and live replies
        are stamped with this master's generation so workers can latch
        it and NACK anything older."""
        def guard(req: dict) -> dict:
            if self._fence.is_set():
                _journal.count_stale_rejection("master")
                return {"error": "master fenced: generation "
                                 f"{self.generation} superseded",
                        "fenced": True, "generation": self.generation}
            # the map-epoch fence (engine/shardmap.py): a caller that
            # routed with an older shard map than this master has seen
            # is NACKed so it refreshes and re-routes — a stale map can
            # never push a mutation past a shard failover.  Requests
            # with no map_epoch stamp (legacy / single-shard callers)
            # always pass.
            me = req.get("map_epoch") if isinstance(req, dict) else None
            if me is not None and int(me) < self._map_epoch:
                _shardmap.count_stale_map_rejection()
                return {"error": f"stale shard map (epoch {int(me)} < "
                                 f"{self._map_epoch})",
                        "stale_map": True,
                        "map_epoch": self._map_epoch,
                        "generation": self.generation}
            reply = fn(req)
            if isinstance(reply, dict):
                reply.setdefault("generation", self.generation)
                if self.num_shards > 1:
                    reply.setdefault("map_epoch", self._map_epoch)
            return reply
        guard.__name__ = getattr(fn, "__name__", "handler")
        return guard

    def _check_fence(self) -> bool:
        """One storage poll: has a newer generation been claimed?  Run
        at startup and by the scan loop (~2 s cadence) — path scoping
        already protects storage structurally, this closes the RPC
        window too."""
        if self._fence.is_set():
            return True
        try:
            newest = _journal.highest_claimed(self.db.backend,
                                              shard=self.shard_id)
        except Exception:  # noqa: BLE001 — a flaky storage poll must
            return False   # not fence a healthy master
        if newest > self.generation:
            self._fence_out(newest)
            return True
        return False

    # -- shard map (engine/shardmap.py) -------------------------------------

    def _adopt_shard_map(self, smap: _shardmap.ShardMap) -> None:
        self._shard_map = smap
        self._map_epoch = max(self._map_epoch, smap.epoch)
        _shardmap.note_map_epoch(self._map_epoch)

    def _refresh_shard_map(self) -> None:
        """One storage poll for a newer map epoch (scan-loop cadence,
        next to the generation-fence poll): a peer shard's failover
        re-publish bumps the epoch, and adopting it here arms the
        stale-map fence against pre-failover routing."""
        if self.num_shards <= 1:
            return
        try:
            smap = _shardmap.load(self.db.backend)
        except Exception:  # noqa: BLE001 — a flaky poll keeps the
            return         # current map; next tick retries
        if smap is not None and smap.epoch > self._map_epoch:
            self._adopt_shard_map(smap)

    def _rpc_get_shard_map(self, req: dict) -> dict:
        """The versioned shard map, served by every shard: clients and
        workers resolve routing from any live master."""
        if self.num_shards > 1 and (
                self._shard_map is None
                or len(self._shard_map.shards) < self.num_shards):
            # startup race: peers registered AFTER this shard adopted
            # its own publish — re-poll inline (bounded: only while
            # the map is still missing members) so a resolver dialing
            # any one shard sees the full membership
            self._refresh_shard_map()
        smap = self._shard_map
        return {"epoch": self._map_epoch,
                "shard_id": self.shard_id,
                "num_shards": self.num_shards,
                "shards": {str(k): v for k, v in
                           (smap.shards if smap else {}).items()},
                "generation": self.generation}

    def _fence_out(self, newest: int) -> None:
        self._fence.set()
        _mlog.error(
            "master generation %d FENCED: generation %d has been "
            "claimed on this db — rejecting all mutating RPCs, "
            "persistence stopped (a successor owns the bulk now)",
            self.generation, newest)

    def _journal_append(self, recs) -> None:
        """Durably journal control-plane events.  Callers invoke this
        OUTSIDE self._lock (storage writes must not stall heartbeats)
        and BEFORE acking the RPC that caused them (write-ahead: an
        acked completion is never lost).  A fenced master journals
        nothing."""
        if not recs or self._journal is None or self._fence.is_set():
            return
        try:
            self._journal.append(*recs)
        except Exception:  # noqa: BLE001 — durability is best-effort
            # past the checkpoint floor: a journal write failure must
            # not fail the task completion that triggered it
            _mlog.exception("bulk journal append failed (recovery "
                            "falls back to the checkpoint window)")

    # -- rpc handlers -------------------------------------------------------

    def _rpc_ping(self, req: dict) -> dict:
        return {"ok": True}

    def _rpc_register_worker(self, req: dict) -> dict:
        with self._lock:
            wid = self._next_worker_id
            self._next_worker_id += 1
            self._workers[wid] = _WorkerInfo(
                wid, req.get("address", ""), time.time(),
                gang_address=str(req.get("gang_address", "") or ""))
        _mlog.info("worker %d registered (%s)", wid, req.get("address", ""))
        return {"worker_id": wid}

    def _rpc_unregister_worker(self, req: dict) -> dict:
        """Graceful worker departure (SIGTERM drain): deactivate NOW
        instead of waiting WORKER_STALE_AFTER for the stale scan, and
        requeue anything it still held (a drained worker finished its
        in-flight tasks first, so normally nothing)."""
        wid = req.get("worker_id")
        recs: List[dict] = []
        with self._lock:
            w = self._workers.get(wid)
            if w is not None and w.active:
                w.active = False
                # deactivation is volatile liveness, but the requeue
                # counts transient failures (strike/blacklist
                # escalation — replayed durable state): a superseded
                # master must not keep reshaping it (SC402)
                if not self._fence.is_set():
                    self._requeue_worker_tasks(wid, recs=recs)
                _M_DRAINS.inc()
                _mlog.info("worker %d deregistered (drain)", wid)
        self._journal_append(recs)
        return {"ok": True}

    def _rpc_heartbeat(self, req: dict) -> dict:
        # clock-sync exchange (util/clocksync.py): t1 = arrival stamp,
        # t2 = reply-build stamp, echoed with the worker's t0 so it can
        # compute offset/RTT.  The worker advertises its converged
        # estimate on the NEXT beat ("clock"); the master publishes it
        # as the per-node offset gauges and keeps it for trace rebase.
        t1 = time.time()
        wid = req["worker_id"]
        if req.get("slim"):
            # the heartbeat fold (engine/shardmap.py): a multi-shard
            # worker sends ONE full beat (clock sync, firing alerts,
            # gang liveness) to the shard whose bulk it is working and
            # a slim liveness-only beat to every other shard — per-
            # (worker, shard) RPC volume stays one beat, but the
            # payload fan-out is coalesced away
            with self._lock:
                w = self._workers.get(wid)
                if w is None or not w.active:
                    return {"reregister": True, "active_bulk": None,
                            "generation": self.generation}
                w.last_seen = time.time()
                bulk = self._bulk
                active = bulk.bulk_id \
                    if bulk and not bulk.finished else None
            _shardmap.count_coalesced("Heartbeat")
            return {"reregister": False, "active_bulk": active,
                    "generation": self.generation, "slim": True}
        recs: List[dict] = []
        with self._lock:
            w = self._workers.get(wid)
            if w is None or not w.active:
                # stale worker rejoining after removal: re-register
                return {"reregister": True, "active_bulk": None}
            w.last_seen = time.time()
            # preemption notice: fence assignment NOW — the worker's
            # drain completes on its own clock, but no new task may be
            # handed to reclaimed capacity in the meantime.  A gang
            # this worker belongs to cannot survive the reclaim: abort
            # it immediately so the epoch bumps and the task re-forms
            # on capacity that is staying.
            if req.get("preempting") and not w.preempting:
                w.preempting = True
                _M_PREEMPT_NOTICES.inc()
                _mlog.warning(
                    "worker %d advertised preemption: assignment "
                    "fenced, drain in progress", wid)
                # the abort mutates durable gang state (journaled):
                # a fenced master marks the worker preempting (volatile
                # assignment fence) but leaves gang scheduling to the
                # successor that owns the bulk now (SC402)
                cur = self._bulk
                if cur is not None and not cur.finished \
                        and not self._fence.is_set():
                    for g in list(cur.gangs.values()):
                        if wid in g.members:
                            self._abort_gang_locked(cur, g, "preempted",
                                                    recs)
                    cur.gang_forming.pop(wid, None)
            # firing alert names ride every beat (tiny: a sorted list
            # of rule-name strings) — the scan loop folds them into
            # cluster-level remediation transitions
            w.firing = set(req.get("firing") or ())
            bulk = self._bulk
            active = bulk.bulk_id \
                if bulk and not bulk.finished else None
            # gang liveness rides the beat: the worker compares its
            # in-flight member runs against this list and reaps a
            # runner whose gang was aborted underneath it — survivors
            # blocked in a dead collective tear down in seconds
            # instead of burning the whole member timeout
            gang_ids = None
            if bulk is not None and bulk.gang_hosts \
                    and not bulk.finished:
                gang_ids = sorted(
                    g.gang_id for g in bulk.gangs.values()
                    if wid in g.members)
            # the worker's advertised clock estimate: publish the
            # gauges and retain per node for GetTrace rebase / the
            # barrier-skew fold (node label matches its span stamps)
            est = req.get("clock")
            if est and _clocksync.enabled():
                node = f"worker{wid}"
                self._clock_offsets[node] = dict(est)
                if bulk is not None and not bulk.compacted:
                    bulk.clock_offsets[node] = dict(est)
                _clocksync.publish(node, est)
        # a preemption-triggered gang abort is journaled like any other
        # scheduling mutation (outside the lock, before the ack)
        self._journal_append(recs)
        # the generation rides every beat so workers latch the newest
        # master even between assignments (Heartbeat itself stays
        # idempotent — no fence guard needed to read liveness)
        reply = {"reregister": False, "active_bulk": active,
                 "generation": self.generation}
        if gang_ids is not None:
            reply["gangs"] = gang_ids
        # four-timestamp stamps for the NTP exchange; echoing t0 keeps
        # the worker side stateless across beats
        if "t0" in req:
            reply["t0"] = req["t0"]
            reply["t1"] = t1
            reply["t2"] = time.time()
        return reply

    def _rpc_new_job(self, req: dict) -> dict:
        """Admit a bulk job: resolve perf, create output tables, build the
        task queue (reference master.cpp:1367 process_job).  The admission
        lock serializes concurrent NewJob calls end-to-end — prepare()
        mutates database metadata and must not interleave."""
        token = req.get("token") or ""
        with self._admit_lock:
            with self._lock:
                # idempotent admission: a client retrying NewJob after
                # an ambiguous timeout (or across a master restart —
                # tokens ride the checkpoint/journal) gets the bulk it
                # already admitted, never a double-run.  Checked under
                # the admission lock so a retry racing the original
                # admission blocks until the token is recorded.
                if token and token in self._admission_tokens:
                    _M_ADMISSION_DEDUP.inc()
                    bid = self._admission_tokens[token]
                    _mlog.info("NewJob token %s deduplicated to "
                               "bulk %d", token[:12], bid)
                    return {"bulk_id": bid, "dedup": True}
                if req.get("resolve"):
                    # lookup-only probe (client ride-through after a
                    # failover): an unknown token must NOT admit a
                    # fresh bulk as a side effect — the client decides
                    # what to do with a lost bulk, not this handler
                    return {"error": "unknown admission token",
                            "unknown_token": True}
                if self._admission_paused:
                    # load shedding (admission_pause playbook): answer
                    # retryable instead of queueing work onto a
                    # backpressured cluster — ClusterClient.run retries
                    # with the hinted delay until resume or deadline
                    return {"error": "admission paused: "
                                     f"{self._admission_paused}",
                            "admission_paused": True,
                            "retry_after": 1.0}
                if self._bulk is not None and not self._bulk.finished:
                    return {"error": "a bulk job is already active"}
            # one trace_id per job: the submitting client's context (the
            # rpc:NewJob server span, re-established by the RPC glue) —
            # or a fresh trace when the caller is untraced, so worker
            # spans still assemble under ONE id either way
            tctx = _tracing.current_context()
            trace_id = tctx.trace_id if tctx else _tracing.new_trace_id()
            trace_parent = tctx.span_id if tctx else ""
            spec = cloudpickle.loads(req["spec"])
            outputs = spec["outputs"]
            perf: PerfParams = spec["perf"]
            cache_mode = CacheMode(spec["cache_mode"])
            # admission only plans tasks and creates tables: the master
            # runs no device op
            ex = LocalExecutor(self.db, device=torch.device("cpu"))
            try:
                info, jobs = ex.prepare(outputs, perf, cache_mode)
            except Exception as e:  # noqa: BLE001
                return {"error": f"{type(e).__name__}: {e}"}
            gang_hosts = max(0, int(getattr(perf, "gang_hosts", 0) or 0))
            sticky = bool(getattr(perf, "stateful_task_affinity", False)
                          and any(n.spec is not None
                                  and getattr(n.spec, "unbounded_state",
                                              False)
                                  for n in info.ops))
            if gang_hosts:
                # a gang task is one synchronized program, not a chain
                # of per-worker state carries: gang mode wins
                sticky = False
            with self._lock:
                bulk = _BulkJob(
                    bulk_id=self._next_bulk_id,
                    spec_blob=cloudpickle.dumps(
                        {"outputs": outputs, "perf": perf,
                         "cache_mode": cache_mode.value}),
                    task_timeout=float(getattr(perf, "task_timeout", 0.0)),
                    checkpoint_frequency=int(
                        getattr(perf, "checkpoint_frequency", 0) or 0),
                    sticky=sticky, gang_hosts=gang_hosts,
                    gang_sharded=bool(
                        getattr(perf, "gang_sharded", True))
                    and _gang.sharded_enabled(),
                    gang_halo=_gang.halo_enabled(),
                    admission_token=token,
                    trace_id=trace_id, trace_parent=trace_parent)
                self._next_bulk_id += 1
                if token:
                    self._record_admission_token_locked(
                        token, bulk.bulk_id)
                for job in jobs:
                    if job.skipped:
                        continue
                    tasks = {(job.job_idx, t) for t in range(len(job.tasks))}
                    bulk.job_tasks[job.job_idx] = tasks
                    for t, (s, e) in enumerate(job.tasks):
                        bulk.task_rows[(job.job_idx, t)] = e - s
                    bulk.job_sink_names[job.job_idx] = [
                        d.name for d, _c, _k, _e in job.sink_tables.values()]
                    bulk.job_custom_sinks[job.job_idx] = \
                        list(job.custom_sinks.values())
                    bulk.job_output_rows[job.job_idx] = job.jr.output_rows
                    bulk.queue[job.job_idx] = deque(
                        sorted(t for _j, t in tasks))
                    bulk.job_rr.append(job.job_idx)
                    bulk.total_tasks += len(tasks)
                if bulk.total_tasks == 0:
                    bulk.mark_finished()
            # persist admission state BEFORE publishing the bulk
            # (outside the control-plane lock; still under the
            # admission lock): the checkpoint write resets the journal
            # for the new bulk, and a worker must not be able to
            # complete — and journal — a task that reset would then
            # delete.  A master crash mid-bulk resumes from here.
            if not bulk.finished:
                self._persist_bulk_checkpoint(bulk)  # scanner-check: disable=SC405 admission lock (not the control-plane lock) serializes admission storage end-to-end by design — heartbeats never wait on it
            with self._lock:
                self._bulk = bulk
                self._no_worker_since = time.time()
                self._history[bulk.bulk_id] = bulk
                self._trim_history_locked()
                _mlog.info(
                    "bulk %d admitted: %d jobs, %d tasks",
                    bulk.bulk_id, len(bulk.job_tasks), bulk.total_tasks)
            return {"bulk_id": bulk.bulk_id}

    def _rpc_get_job(self, req: dict) -> dict:
        with self._lock:
            bulk = self._history.get(req["bulk_id"])
            if bulk is None:
                return {"error": "unknown bulk job"}
            return {"spec": bulk.spec_blob}

    def _touch_worker(self, wid) -> None:
        w = self._workers.get(wid)
        if w is not None and w.active:
            w.last_seen = time.time()

    def _rpc_next_work(self, req: dict) -> dict:
        wid = req["worker_id"]
        bulk_id = req["bulk_id"]
        window = int(req.get("window") or 0)
        recs: List[dict] = []
        try:
            return self._next_work_impl(wid, bulk_id, window, recs)
        finally:
            # a gang formation is a scheduling mutation: its journal
            # record is durable before the role reply acks it (the
            # lock is released by the time this runs)
            self._journal_append(recs)

    def _next_work_impl(self, wid, bulk_id: int, window: int,
                        recs: List[dict]) -> dict:
        with self._lock:
            self._touch_worker(wid)
            bulk = self._bulk
            if bulk is None or bulk.bulk_id != bulk_id or bulk.finished:
                return {"status": "none"}
            w = self._workers.get(wid)
            if w is None or not w.active:
                return {"status": "none"}
            if w.preempting:
                # assignment fence: reclaimed capacity gets nothing new
                # while its drain completes (the worker's own drain
                # stops pulls too — this covers the notice->drain race
                # and externally-observed preemptions)
                return {"status": "wait"}
            if bulk.gang_hosts > 0:
                # gang mode: pulls feed the formation pool instead of
                # popping independent tasks (docs/robustness.md §Gang
                # scheduling)
                return self._gang_next_work_locked(bulk, wid, recs)
            if window:
                # per-worker in-flight window: don't let one node's
                # loaders hoard the queue while its siblings idle
                if bulk.held.get(wid, 0) >= window and bulk.q_has_work():
                    return {"status": "wait"}
            # round-robin over jobs; a sticky (stateful-affinity) job
            # bound to a live other worker is skipped as a whole, so it
            # can never starve later jobs for this worker
            got = None
            if bulk.sticky:
                # finish the worker's current chained job before taking
                # another: job switches reset the evaluator's kernel
                # streams and would carry-miss every task
                jc = bulk.sticky_cur.get(wid)
                dq = bulk.queue.get(jc) if jc is not None else None
                if dq and jc not in bulk.blacklisted_jobs \
                        and bulk.sticky_worker.get(jc) == wid:
                    while dq and got is None:
                        t = dq.popleft()
                        if (jc, t) not in bulk.done:
                            got = (jc, t)
                    if not dq:
                        bulk.queue.pop(jc, None)
                elif jc is not None:
                    bulk.sticky_cur.pop(wid, None)
            for _ in range(len(bulk.job_rr)) if got is None else ():
                j = bulk.job_rr.popleft()
                dq = bulk.queue.get(j)
                if not dq or j in bulk.blacklisted_jobs:
                    bulk.queue.pop(j, None)   # drop from the ring
                    continue
                if bulk.sticky:
                    bw = bulk.sticky_worker.get(j)
                    w2 = self._workers.get(bw) if bw is not None else None
                    if w2 is None or not w2.active:
                        bulk.sticky_worker[j] = wid  # bind (or re-bind)
                        bulk.sticky_cur[wid] = j
                    elif bw != wid:
                        bulk.job_rr.append(j)
                        continue
                    else:
                        bulk.sticky_cur[wid] = j
                while dq and got is None:
                    t = dq.popleft()
                    if (j, t) not in bulk.done:
                        got = (j, t)
                if dq:
                    bulk.job_rr.append(j)
                else:
                    bulk.queue.pop(j, None)
                if got is not None:
                    break
            if got is not None:
                j, t = got
                attempt = bulk.next_attempt
                bulk.next_attempt += 1
                bulk.outstanding[(j, t)] = (wid, time.time(), attempt,
                                            False, False)
                bulk.held[wid] = bulk.held.get(wid, 0) + 1
                _mlog.debug("task (%d,%d) assigned to worker %d "
                            "(attempt %d)", j, t, wid, attempt)
                reply = {"status": "task", "job_idx": j, "task_idx": t,
                         "attempt": attempt}
                # the cross-host hop: an (instantaneous) assignment span
                # in the job's trace whose id the worker parents its
                # task span under — master → worker stays one unbroken
                # chain per attempt
                sp = _tracing.open_span(
                    self.tracer, "master.assign",
                    parent=_tracing.SpanContext(bulk.trace_id,
                                                bulk.trace_parent),
                    job=j, task=t, attempt=attempt, worker=wid) \
                    if bulk.trace_id else None
                if sp is not None:
                    _tracing.close_span(self.tracer, sp)
                    reply["traceparent"] = sp.context().traceparent()
                return reply
            if bulk.outstanding or bulk.q_has_work():
                return {"status": "wait"}
            return {"status": "done"}

    # -- gang scheduling (engine/gang.py, docs/robustness.md) ---------------

    def _gang_next_work_locked(self, bulk: _BulkJob, wid: int,
                               recs: List[dict]) -> dict:
        """One gang-mode pull: hand the caller its role in a formed
        gang, or pool it toward the next formation.  A gang forms when
        `gang_hosts` eligible workers have pooled — or, after
        `[gang] form_timeout_s`, on whatever capacity HAS pooled (the
        loss-tolerant path: a bulk that lost hosts mid-flight re-forms
        smaller instead of waiting for capacity that is gone).  Caller
        holds self._lock."""
        info_w = self._workers.get(wid)
        if info_w is None or not info_w.gang_address:
            # a worker that cannot rendezvous (SCANNER_TPU_GANG=0 /
            # [gang] enabled=false: it registered with no gang
            # address) must never become a member — handing it a gang
            # reply would make it run the task as an ordinary pull and
            # break the single-writer accounting
            return {"status": "wait"}
        for g in bulk.gangs.values():
            if wid in g.members:
                if wid not in g.roles_handed:
                    return self._gang_role_reply_locked(bulk, g, wid)
                return {"status": "wait"}  # its member run is in flight
        # prune pool entries whose workers died/preempted since joining
        for fw in list(bulk.gang_forming):
            info = self._workers.get(fw)
            if info is None or not info.active or info.preempting:
                bulk.gang_forming.pop(fw, None)
        if not bulk.q_has_work():
            if bulk.outstanding or bulk.gangs:
                return {"status": "wait"}
            return {"status": "done"}
        now = time.time()
        if wid not in bulk.gang_forming:
            if not bulk.gang_forming:
                bulk.gang_forming_since = now
            bulk.gang_forming[wid] = now
        full = len(bulk.gang_forming) >= bulk.gang_hosts
        if not full and now - bulk.gang_forming_since \
                < _gang.form_timeout_s():
            return {"status": "wait"}
        # elect members in join order; the coordinator (member 0) must
        # advertise a gang address, and the election ROTATES with the
        # epoch about to be minted — a member whose advertised port
        # went bad (reclaimed since the startup probe) costs one
        # aborted epoch, not an unbounded streak of re-forms electing
        # the same broken coordinator
        pool = sorted(bulk.gang_forming,
                      key=lambda k: bulk.gang_forming[k])
        members = pool[:bulk.gang_hosts]
        able = [m for m in members
                if self._workers.get(m) is not None
                and self._workers[m].gang_address]
        if not able:
            return {"status": "wait"}  # nobody can coordinate yet
        lead = able[(bulk.gang_epoch + 1) % len(able)]
        members.remove(lead)
        members.insert(0, lead)
        coord = self._workers[lead].gang_address
        key = self._gang_pop_task_locked(bulk)
        if key is None:
            return {"status": "wait"}
        attempt = bulk.next_attempt
        bulk.next_attempt += 1
        bulk.gang_epoch += 1
        gid = bulk.next_gang_id
        bulk.next_gang_id += 1
        g = _Gang(gang_id=gid, epoch=bulk.gang_epoch, key=key,
                  attempt=attempt, members=members, coordinator=coord,
                  formed_at=now)
        bulk.gangs[gid] = g
        bulk.gang_by_task[key] = gid
        for m in members:
            bulk.gang_forming.pop(m, None)
            bulk.held[m] = bulk.held.get(m, 0) + 1
        bulk.gang_forming_since = now if bulk.gang_forming else 0.0
        # the gang's timeout clock starts at formation (started=True:
        # a formed gang is executing, not queue-parked)
        bulk.outstanding[key] = (members[0], now, attempt, True, False)
        reform = key in bulk.gang_aborted_keys
        _gang.count_formed(reform)
        _gang.set_epoch(bulk.gang_epoch)
        # the gang root span: every member's task span parents under it
        # so per-host stragglers inside one gang stay attributable
        sp = _tracing.open_span(
            self.tracer, "gang",
            parent=_tracing.SpanContext(bulk.trace_id,
                                        bulk.trace_parent),
            gang=gid, epoch=g.epoch, job=key[0], task=key[1],
            members=len(members)) if bulk.trace_id else None
        if sp is not None:
            _tracing.close_span(self.tracer, sp)
            g.trace_parent = sp.context().traceparent()
        recs.append({"t": "gang", "g": gid, "e": g.epoch,
                     "j": key[0], "k": key[1],
                     "members": list(members)})
        _mlog.info(
            "gang %d formed at epoch %d for task (%d,%d): members %s, "
            "coordinator %s%s", gid, g.epoch, key[0], key[1], members,
            coord, " (re-form)" if reform else "")
        if wid in g.members:
            return self._gang_role_reply_locked(bulk, g, wid)
        # the pool can briefly exceed gang_hosts (a pull that found
        # only blacklisted-job work left a full pool behind): this
        # caller's join-order slot fell outside the elected set — it
        # stays pooled for the NEXT formation instead of crashing the
        # role lookup
        return {"status": "wait"}

    @staticmethod
    def _gang_pop_task_locked(bulk: _BulkJob):
        """Round-robin task pop for gang formation (no stickiness —
        gang bulks never chain state across workers)."""
        for _ in range(len(bulk.job_rr)):
            j = bulk.job_rr.popleft()
            dq = bulk.queue.get(j)
            if not dq or j in bulk.blacklisted_jobs:
                bulk.queue.pop(j, None)
                continue
            got = None
            while dq and got is None:
                t = dq.popleft()
                if (j, t) not in bulk.done:
                    got = (j, t)
            if dq:
                bulk.job_rr.append(j)
            else:
                bulk.queue.pop(j, None)
            if got is not None:
                return got
        return None

    def _gang_role_reply_locked(self, bulk: _BulkJob, g: _Gang,
                                wid: int) -> dict:
        g.roles_handed.add(wid)
        return {"status": "gang", "gang_id": g.gang_id,
                "epoch": g.epoch,
                "process_id": g.members.index(wid),
                "num_processes": len(g.members),
                "coordinator": g.coordinator,
                "job_idx": g.key[0], "task_idx": g.key[1],
                "attempt": g.attempt,
                "task_timeout": bulk.task_timeout,
                # the MASTER decides the evaluation mode per gang and
                # every member reads it off this reply — members can
                # never disagree about sharding mid-gang (a single-host
                # gang degenerates to the replicated body either way)
                "sharded": bool(bulk.gang_sharded
                                and len(g.members) > 1),
                "halo": bool(bulk.gang_halo),
                "traceparent": g.trace_parent or None}

    def _abort_gang_locked(self, bulk: _BulkJob, g: _Gang, reason: str,
                           recs: List[dict], strike: bool = False,
                           error: str = "") -> None:
        """Tear one gang down: bump the epoch (the fence — every late
        report from this gang now NACKs), release member bookkeeping,
        and requeue the task for a fresh gang on the remaining
        capacity.  Aborts are revocations, not task failures: they
        count against the transient cap, never a blacklist strike —
        unless `strike` (a member reported a DETERMINISTIC task error),
        which routes through the ordinary failure path.  Idempotent
        per gang.  Caller holds self._lock."""
        if bulk.gangs.get(g.gang_id) is not g:
            return
        bulk.gangs.pop(g.gang_id, None)
        bulk.gang_by_task.pop(g.key, None)
        bulk.gang_aborted_keys.add(g.key)
        bulk.gang_epoch += 1
        _gang.set_epoch(bulk.gang_epoch)
        _gang.count_aborted(reason)
        recs.append({"t": "gang_abort", "g": g.gang_id, "e": g.epoch})
        self._unassign(bulk, g.key)
        for m in g.members[1:]:
            if m not in g.acks:
                self._dec_held(bulk, m)
        _mlog.warning(
            "gang %d (epoch %d, task (%d,%d)) aborted: %s — epoch "
            "bumped to %d, task requeued for a fresh gang", g.gang_id,
            g.epoch, g.key[0], g.key[1], reason, bulk.gang_epoch)
        if g.key in bulk.done or g.key[0] in bulk.blacklisted_jobs:
            return
        if strike:
            if self._count_strike_locked(bulk, g.key,
                                         error or reason, recs):
                # a blacklist can complete the bulk, and this abort
                # may have arrived on a non-RPC path (heartbeat
                # preemption, stale scan) that runs no finish check of
                # its own — without this, a bulk whose LAST task
                # blacklisted here would hang unfinished forever
                self._maybe_finish_bulk(bulk)
            return
        # strike-free revocation, bounded by the transient cap so a
        # gang that can never form/agree still terminates the bulk
        if self._count_transient_locked(bulk, g.key, recs):
            _M_TRANSIENT.inc()
            _M_REVOCATIONS.inc()
            _M_TASK_RETRIES.inc()
            bulk.q_push(g.key, front=True)
            return
        if self._count_strike_locked(
                bulk, g.key,
                f"gang aborts exhausted the transient cap ({reason})",
                recs):
            self._maybe_finish_bulk(bulk)

    # shared escalation counters (one policy for RPC failures, timeout
    # revocations, and gang aborts — the journal record shapes and
    # caps must never drift between those paths)

    @staticmethod
    def _count_transient_locked(bulk: _BulkJob, key: Tuple[int, int],
                                recs: List[dict]) -> bool:
        """Count one environment-caused failure against the transient
        cap.  True = still under the cap (caller requeues strike-free);
        False = escalate to a strike.  Caller holds self._lock."""
        tn = bulk.transient_failures.get(key, 0) + 1
        bulk.transient_failures[key] = tn
        recs.append({"t": "transient", "j": key[0], "k": key[1],
                     "n": tn})
        return tn <= MAX_TRANSIENT_FAILURES

    def _count_strike_locked(self, bulk: _BulkJob,
                             key: Tuple[int, int], err: str,
                             recs: List[dict]) -> bool:
        """Count one blacklist strike; past MAX_TASK_FAILURES the job
        blacklists (returns True), otherwise the task requeues at the
        front.  Caller holds self._lock."""
        n = bulk.failures.get(key, 0) + 1
        bulk.failures[key] = n
        recs.append({"t": "strike", "j": key[0], "k": key[1], "n": n})
        _M_STRIKES.inc()
        if n >= MAX_TASK_FAILURES:
            self._blacklist_job(bulk, key[0], err, recs=recs)
            return True
        bulk.q_push(key, front=True)
        _M_TASK_RETRIES.inc()
        return False

    def _gang_for_req_locked(self, bulk: _BulkJob, req: dict,
                             rpc_name: str):
        """Resolve a gang RPC's (gang_id, epoch) fence: the live gang,
        or None (counted NACK) when the gang is gone or the epoch is
        stale.  Caller holds self._lock."""
        gid = req.get("gang_id")
        g = bulk.gangs.get(gid) if gid is not None else None
        if g is None or int(req.get("epoch", -1)) != g.epoch:
            _gang.count_stale_nack(rpc_name)
            return None
        return g

    def _fold_gang_shards_locked(self, g: _Gang, req: dict) -> None:
        """Master-side shard commit fold (sharded gangs): the writer's
        FinishedWork carries the per-member shard digests it assembled
        the output from plus the collective total; verify that the
        shards sum to the total and that every member whose ack already
        landed reported the SAME shard digest the writer assembled.
        The gang itself already refused to commit on disagreement
        (member 0's pre-save check), so a mismatch here means a
        reporting-path bug — counted and logged loudly, never a strike
        against the (already committed, already verified) task.  Caller
        holds self._lock."""
        result = "ok"
        try:
            sds = [int(x) & 0xFFFFFFFF
                   for x in (req.get("shard_digests") or ())]
        except (TypeError, ValueError):
            sds = []
        total = req.get("digest")
        if len(sds) != len(g.members) or total is None:
            result = "partial"
        elif sum(sds) & 0xFFFFFFFF != int(total) & 0xFFFFFFFF:
            result = "mismatch"
        else:
            for rank, d in g.shard_digests.items():
                if 0 <= rank < len(sds) and sds[rank] != d:
                    result = "mismatch"
                    break
        if result != "ok":
            _mlog.warning(
                "gang %d epoch %d: shard commit fold %s (writer "
                "digests %s, total %s, acked %s)", g.gang_id, g.epoch,
                result, sds, total, dict(g.shard_digests))
        _gang.count_shard_fold(result)

    def _rpc_gang_member_done(self, req: dict) -> dict:
        """A non-coordinator member finished its (non-writing) part of
        the gang program: record the ack and release its slot in the
        worker's held-count.  Member 0 completes via FinishedWork —
        the gang's single completion report."""
        with self._lock:
            self._touch_worker(req.get("worker_id"))
            bulk = self._bulk
            if bulk is None or bulk.bulk_id != req.get("bulk_id"):
                return {"ok": False}
            gid = req.get("gang_id")
            if gid in bulk.gang_retired \
                    and int(req.get("epoch", -1)) \
                    == bulk.gang_retired[gid]:
                # the writer already committed this gang's task: the
                # surviving member's ack is the healthy tail, not
                # stale fence traffic
                return {"ok": True}
            g = self._gang_for_req_locked(bulk, req, "GangMemberDone")
            if g is None:
                return {"ok": False, "gang_stale": True}
            wid = req.get("worker_id")
            if wid not in g.members or wid == g.members[0]:
                _gang.count_stale_nack("GangMemberDone")
                return {"ok": False, "gang_stale": True}
            if wid not in g.acks:
                g.acks.add(wid)
                self._dec_held(bulk, wid)
            # sharded members carry their shard digest on the ack — the
            # ack path extended to carry shard results; the commit fold
            # verifies them against the writer's assembled view
            if req.get("shard_digest") is not None:
                try:
                    g.shard_digests[g.members.index(wid)] = \
                        int(req["shard_digest"]) & 0xFFFFFFFF
                except (TypeError, ValueError):
                    pass
            return {"ok": True}

    def _rpc_gang_failed(self, req: dict) -> dict:
        """A member reported its gang run failed (rendezvous timeout,
        collective error, runner loss, evaluate error): abort the gang
        — epoch bump, strike-free requeue unless the member classified
        the failure deterministic."""
        recs: List[dict] = []
        try:
            with self._lock:
                self._touch_worker(req.get("worker_id"))
                bulk = self._bulk
                if bulk is None or bulk.bulk_id != req.get("bulk_id"):
                    return {"ok": False}
                g = self._gang_for_req_locked(bulk, req, "GangFailed")
                if g is None:
                    return {"ok": False, "gang_stale": True}
                stage = str(req.get("stage") or "member")
                _mlog.warning(
                    "gang %d epoch %d: member (worker %s) failed at "
                    "%s: %s", g.gang_id, g.epoch,
                    req.get("worker_id"), stage, req.get("error", ""))
                self._abort_gang_locked(
                    bulk, g, f"member_failed:{stage}", recs,
                    strike=not req.get("transient", True),
                    error=str(req.get("error", "")))
                self._maybe_finish_bulk(bulk)
                finished_now = bulk.finished
        finally:
            self._journal_append(recs)
        if finished_now:
            self._clear_bulk_checkpoint(bulk.bulk_id)
        return {"ok": True}

    def _rpc_started_work(self, req: dict) -> dict:
        """Worker signals that evaluation of a prefetched task begins now:
        restart its timeout clock so task_timeout measures execution, not
        time spent queued behind the previous task."""
        key = (req["job_idx"], req["task_idx"])
        with self._lock:
            self._touch_worker(req.get("worker_id"))
            bulk = self._bulk
            if bulk is None or bulk.bulk_id != req["bulk_id"]:
                return {"ok": False}
            cur = bulk.outstanding.get(key)
            if cur is not None and cur[0] == req.get("worker_id") \
                    and cur[2] == req.get("attempt"):
                bulk.outstanding[key] = (cur[0], time.time(), cur[2], True,
                                         cur[4])
                bulk.count_stage("load", key)
                return {"ok": True}
        return {"ok": False, "revoked": True}

    def _rpc_eval_done(self, req: dict) -> dict:
        """Worker signals that a task finished evaluation and is parked in
        its save stage: it stops counting against the worker's NextWork
        window so lagging savers cannot starve the evaluators (it stays
        outstanding for timeout/fault tracking until FinishedWork)."""
        key = (req["job_idx"], req["task_idx"])
        with self._lock:
            self._touch_worker(req.get("worker_id"))
            bulk = self._bulk
            if bulk is None or bulk.bulk_id != req["bulk_id"]:
                return {"ok": False}
            cur = bulk.outstanding.get(key)
            if cur is not None and cur[0] == req.get("worker_id") \
                    and cur[2] == req.get("attempt") and not cur[4]:
                bulk.outstanding[key] = (cur[0], cur[1], cur[2], cur[3],
                                         True)
                self._dec_held(bulk, cur[0])
                bulk.count_stage("evaluate", key)
                return {"ok": True}
        return {"ok": False, "revoked": True}

    def _rpc_finished_work(self, req: dict) -> dict:
        recs: List[dict] = []
        with self._lock:
            reply, need_ckpt, finished_now, bulk = \
                self._finished_work_locked(req, recs)
        # write-ahead: the completion is durable in the journal BEFORE
        # this handler acks — a kill -9 after the ack cannot lose it
        # (outside the control lock; storage must not stall heartbeats)
        self._journal_append(recs)
        if need_ckpt:
            # periodic metadata checkpoint: a master restart mid-bulk finds
            # committed-so-far tables in the megafile and resumes from the
            # persisted done-set.  Written OUTSIDE the control-plane lock —
            # the Database has its own lock, and stalling heartbeats on a
            # storage write would let the stale scan deactivate live
            # workers.
            self.db.write_megafile()
            self._persist_bulk_progress(bulk)
        if finished_now:
            self._clear_bulk_checkpoint(bulk.bulk_id)
        return reply

    def _rpc_finished_work_batch(self, req: dict) -> dict:
        """Coalesced completions (engine/shardmap.py): many FinishedWork
        payloads in one RPC with ONE journal group-commit — the batch
        is durable before any item is acked, so the write-ahead
        contract holds for every item exactly as it does for the
        singleton path.  Per-item replies ride back positionally so the
        worker can dispatch revocation/gang-stale outcomes per task."""
        items = list(req.get("items") or ())
        recs: List[dict] = []
        replies: List[dict] = []
        need_ckpt = finished_now = False
        bulk = None
        with self._lock:
            for item in items:
                it = dict(item)
                it.setdefault("bulk_id", req.get("bulk_id"))
                it.setdefault("worker_id", req.get("worker_id"))
                if "clock" not in it and req.get("clock"):
                    it["clock"] = req["clock"]
                r, ck, fin, b = self._finished_work_locked(it, recs)
                replies.append(r)
                need_ckpt = need_ckpt or ck
                finished_now = finished_now or fin
                bulk = b if b is not None else bulk
        self._journal_append(recs)
        _shardmap.count_coalesced("FinishedWork",
                                  max(0, len(items) - 1))
        if need_ckpt and bulk is not None:
            self.db.write_megafile()
            self._persist_bulk_progress(bulk)
        if finished_now and bulk is not None:
            self._clear_bulk_checkpoint(bulk.bulk_id)
        return {"ok": all(r.get("ok") for r in replies),
                "replies": replies}

    def _finished_work_locked(self, req: dict, recs: List[dict]
                              ) -> Tuple[dict, bool, bool,
                                         Optional[_BulkJob]]:
        """One completion applied under self._lock (shared by the
        singleton and batch handlers).  Returns (reply, need_ckpt,
        finished_now, bulk); the caller journals `recs` and runs the
        checkpoint/cleanup I/O outside the lock."""
        key = (req["job_idx"], req["task_idx"])
        with self._lock:  # reentrant: both callers already hold it
            self._touch_worker(req.get("worker_id"))
            bulk = self._bulk
            if bulk is None or bulk.bulk_id != req["bulk_id"]:
                return {"ok": False}, False, False, None
            # piggybacked trace spans (the worker drains its export
            # buffer into every FinishedWork, so no second RPC rides
            # the per-task hot path): absorbed before the revocation
            # check — a revoked attempt's spans are still real history.
            # The master's OWN spans drain here too: on a large bulk
            # the assign spans would otherwise pool in the tracer's
            # export buffer (cap 65536) until end-of-bulk and overflow.
            self._drain_master_spans_locked()
            self._intake_clock_locked(bulk, req)
            self._absorb_batch_locked(bulk, req.get("spans") or ())
            if bulk.gang_hosts and req.get("gang_id") is not None:
                # gang single-writer commit: only member 0 of the LIVE
                # gang at the CURRENT epoch may complete the task —
                # a completion from an aborted epoch (the gang
                # re-formed underneath a slow writer) or from a
                # non-coordinator member is NACKed, never applied, so
                # the sink commit is exactly-once per task
                g = self._gang_for_req_locked(bulk, req, "FinishedWork")
                if g is None or req.get("worker_id") != g.members[0]:
                    if g is not None:
                        _gang.count_stale_nack("FinishedWork")
                    return {"ok": False, "revoked": True,
                            "gang_stale": True}, False, False, bulk
                # accepted: retire the gang — survivors' late acks are
                # acknowledged via the retired map, and their held
                # slots release here
                if req.get("shard_digests") is not None:
                    self._fold_gang_shards_locked(g, req)
                bulk.gangs.pop(g.gang_id, None)
                bulk.gang_by_task.pop(g.key, None)
                bulk.gang_retired[g.gang_id] = g.epoch
                while len(bulk.gang_retired) > 64:
                    bulk.gang_retired.pop(
                        next(iter(bulk.gang_retired)))
                for m in g.members[1:]:
                    if m not in g.acks:
                        self._dec_held(bulk, m)
            # a completion only counts if this worker still holds the
            # assignment WITH the same attempt id — revoked
            # (timed-out/reassigned) attempts are ignored, the in-process
            # equivalent of the reference killing the slow worker
            # (stop_job_on_worker, master.cpp:2111)
            cur = bulk.outstanding.get(key)
            if cur is None or cur[0] != req.get("worker_id") \
                    or cur[2] != req.get("attempt"):
                return {"ok": False, "revoked": True}, False, False, \
                    bulk
            self._unassign(bulk, key)
            if key in bulk.done or key[0] in bulk.blacklisted_jobs:
                return {"ok": True}, False, False, bulk
            bulk.done.add(key)
            recs.append({"t": "done", "j": key[0], "k": key[1]})
            bulk.job_done[key[0]] = bulk.job_done.get(key[0], 0) + 1
            bulk.stage_rows["save"] += bulk.task_rows.get(key, 0)
            _M_TASKS_DONE.inc()
            # end-to-end latency, enqueue (bulk admission made the task
            # runnable) -> sink-committed: the serving-mode p50/p99 seed
            _M_TASK_LATENCY.observe(time.time() - bulk.admitted_at)
            _mlog.debug("task (%d,%d) finished by worker %d "
                        "(%d/%d done)", key[0], key[1],
                        req.get("worker_id", -1), len(bulk.done),
                        bulk.total_tasks)
            self._maybe_finish_job(bulk, key[0], recs=recs)
            need_ckpt = (bulk.checkpoint_frequency > 0 and not bulk.finished
                         and len(bulk.done) % bulk.checkpoint_frequency == 0)
            self._maybe_finish_bulk(bulk)
            return {"ok": True}, need_ckpt, bulk.finished, bulk

    def _rpc_failed_work(self, req: dict) -> dict:
        key = (req["job_idx"], req["task_idx"])
        err = req.get("error", "")
        recs: List[dict] = []
        with self._lock:
            self._touch_worker(req.get("worker_id"))
            bulk = self._bulk
            if bulk is None or bulk.bulk_id != req["bulk_id"]:
                return {"ok": False}
            cur = bulk.outstanding.get(key)
            if cur is None or cur[0] != req.get("worker_id") \
                    or cur[2] != req.get("attempt"):
                return {"ok": False, "revoked": True}
            self._unassign(bulk, key)
            if key in bulk.done:
                return {"ok": True}
            strike_free = False
            if req.get("transient"):
                # past the cap, a "transient" failure that never stops
                # isn't: fall through and strike like any other
                if self._count_transient_locked(bulk, key, recs):
                    _M_TRANSIENT.inc()
                    _M_TASK_RETRIES.inc()
                    _mlog.warning(
                        "task (%d,%d) transient failure on worker %d "
                        "(%d/%d before strikes begin): %s — requeued "
                        "without a blacklist strike", key[0], key[1],
                        req.get("worker_id", -1),
                        bulk.transient_failures[key],
                        MAX_TRANSIENT_FAILURES, err)
                    bulk.q_push(key, front=True)
                    strike_free = True
            blacklisted_now = finished_now = False
            if not strike_free:
                # job blacklisting past the strike cap (reference
                # master.cpp:2161-2191): one poison stream cannot sink
                # the bulk job
                blacklisted_now = self._count_strike_locked(
                    bulk, key, err, recs)
                _mlog.warning("task (%d,%d) failed on worker %d "
                              "(failure %d/%d): %s", key[0], key[1],
                              req.get("worker_id", -1),
                              bulk.failures[key],
                              MAX_TASK_FAILURES, err)
                self._maybe_finish_bulk(bulk)
                finished_now = bulk.finished
        # write-ahead: durable before the ack (outside the lock)
        self._journal_append(recs)
        if strike_free:
            return {"ok": True}
        if blacklisted_now and not finished_now:
            # a restarted master must not resurrect the poisoned job
            self._persist_bulk_progress(bulk)
        if finished_now:
            self._clear_bulk_checkpoint(bulk.bulk_id)
        return {"ok": True}

    def _job_status_locked(self, bulk: _BulkJob) -> dict:
        """One source of truth for job progress: the GetJobStatus reply,
        the client progress bar, and /statusz all read this.  Caller
        holds self._lock."""
        if bulk.compacted and bulk.status_frozen is not None:
            # compacted historical bulk: the heavy per-task state is
            # gone; serve the snapshot frozen at compaction (worker
            # liveness stays live — it is a cluster fact, not a bulk one)
            st = dict(bulk.status_frozen)
            st["num_workers"] = sum(1 for w in self._workers.values()
                                    if w.active)
            return st
        # freeze the clock at bulk completion: a historical bulk queried
        # later must report its real throughput, not a decayed one
        end = bulk.finished_at or time.time()
        elapsed = max(end - bulk.admitted_at, 1e-6)
        # fps per stage from the master-observed transitions; after a
        # master restart these count post-recovery progress only, so the
        # ETA reflects the live completion rate
        stage_fps = {s: round(r / elapsed, 2)
                     for s, r in bulk.stage_rows.items()}
        active_total = bulk.total_tasks - bulk.blacklisted_task_total
        active_done = len(bulk.done) - bulk.done_in_blacklisted
        eta = None
        done_since_start = active_done - bulk.done_at_start
        if not bulk.finished and done_since_start > 0:
            rate = done_since_start / elapsed
            eta = round((active_total - active_done) / rate, 1)
        per_job = {}
        for j, tasks in bulk.job_tasks.items():
            per_job[j] = {"tasks_done": bulk.job_done.get(j, 0),
                          "tasks_total": len(tasks),
                          "blacklisted": j in bulk.blacklisted_jobs}
        return {
            "finished": bulk.finished,
            "tasks_done": len(bulk.done),
            "total_tasks": bulk.total_tasks,
            "stage_fps": stage_fps,
            "eta_seconds": eta,
            "elapsed_seconds": round(elapsed, 1),
            "per_job": per_job,
            "failed_jobs": sorted(bulk.blacklisted_jobs),
            # failed task attempts the master requeued (strikes and
            # strike-free transient failures): a retry shows here even
            # when the bulk completes.  This package's addition to the
            # JAX package's reply
            "task_failures": sum(bulk.failures.values())
            + sum(bulk.transient_failures.values()),
            "error": bulk.error,
            "num_workers": sum(1 for w in self._workers.values()
                               if w.active),
            # straggler analytics from shipped spans: per-stage stats +
            # top-N slowest tasks with trace ids (also on /statusz)
            "trace_id": bulk.trace_id,
            "stragglers": self._stragglers_locked(bulk),
        }

    def _rpc_job_status(self, req: dict) -> dict:
        with self._lock:
            bulk = self._history.get(req["bulk_id"]) \
                if req.get("bulk_id") is not None else self._bulk
            if bulk is None:
                # still report cluster liveness: lets tooling (e.g.
                # tools/chaos_run.py) wait for workers to register
                # before submitting anything
                st = {"error": "no such bulk job",
                      "num_workers": sum(
                          1 for w in self._workers.values()
                          if w.active)}
            else:
                st = self._job_status_locked(bulk)
        # the master-local health roll-up rides on every status poll
        # (added OUTSIDE the control-plane lock: the engine has a lock
        # of its own) — the 4 Hz client poll and scanner_top see
        # degradation without a second RPC
        st["health"] = _health.rollup()
        return st

    def _statusz(self) -> dict:
        """JSON body of /statusz: live job progress + worker liveness."""
        now = time.time()
        with self._lock:
            workers = [{"worker_id": w.worker_id, "address": w.address,
                        "active": w.active,
                        "heartbeat_age_seconds": round(now - w.last_seen,
                                                       3)}
                       for w in self._workers.values()]
            bulk = self._bulk
            status = self._job_status_locked(bulk) \
                if bulk is not None else None
            bulk_id = bulk.bulk_id if bulk is not None else None
            mem_reports = len(self._mem_reports)
            # the Gang panel (docs/robustness.md §Gang scheduling):
            # live gangs with their epoch fence + the forming pool
            gang_panel = None
            if bulk is not None and bulk.gang_hosts:
                gang_panel = {
                    "gang_hosts": bulk.gang_hosts,
                    "epoch": bulk.gang_epoch,
                    "forming": sorted(bulk.gang_forming),
                    "live": [{"gang_id": g.gang_id, "epoch": g.epoch,
                              "job": g.key[0], "task": g.key[1],
                              "members": list(g.members),
                              "coordinator": g.coordinator,
                              "age_s": round(now - g.formed_at, 3)}
                             for g in bulk.gangs.values()],
                    # per-gang straggler attribution (newest first):
                    # slowest member, lag vs median arrival, and the
                    # barrier/collective verdict — the skew panel
                    # (docs/observability.md §Cross-host time)
                    "skew": list(reversed(bulk.gang_skew_rows))}
        return {"role": "master", "workers": workers,
                "bulk_id": bulk_id, "bulk": status,
                "gang": gang_panel,
                # the fencing epoch (docs/robustness.md §Durable
                # control plane): fenced=True means a successor owns
                # this db and every mutating RPC here is rejected
                "generation": self.generation,
                "fenced": self._fence.is_set(),
                # the Shard panel (docs/robustness.md §Sharded control
                # plane): which partition this master serves and the
                # map epoch its stale-map fence sits at
                "shard": {"shard_id": self.shard_id,
                          "num_shards": self.num_shards,
                          "map_epoch": self._map_epoch},
                # the Health panel: this process's roll-up + firing
                # alerts (util/health.py; outside the control lock)
                "health": _health.status_dict(),
                # the Memory panel: this process's device-memory/ledger
                # view plus how many worker OOM reports are held for
                # GetMemoryReport
                "memory": dict(_memstats.status_dict(),
                               worker_reports=mem_reports),
                # the Frame-cache panel: per-device page pool occupancy
                # and hit rates (engine/framecache.py; a bare master
                # usually has none — workers hold the pages)
                "framecache": _framecache.status_dict(),
                # the Efficiency panel: roofline table + compile-ledger
                # summary (util/coststats.py; a bare master usually has
                # none — workers carry the kernel calls)
                "efficiency": _coststats.status_dict(),
                # the Remediation panel: playbook table + newest audit
                # entries, plus this master's gates
                "remediation": dict(
                    _controller.status_dict(),
                    admission_paused=self._admission_paused,
                    autoscale_desired=self.autoscaler.desired()
                    if self.autoscaler else None)}

    def _rpc_get_metrics(self, req: dict) -> dict:
        """Cluster-wide metrics: this process's snapshot plus every live
        worker's, merged under per-node labels.  The one place the
        master dials workers (at the address each worker advertised at
        registration) — a diagnostic pull outside the job data/control
        plane (which stays strictly worker-pull-based).  Dials run
        concurrently with a short deadline so one wedged worker cannot
        pin an RPC-server thread for the whole scrape, and an
        unreachable worker just drops out of the merged view."""
        from concurrent import futures as _fut

        with self._lock:
            targets = [(w.worker_id, w.address)
                       for w in self._workers.values()
                       if w.active and w.address]
        by_node: Dict[str, dict] = {"master": _mx.registry().snapshot()}

        def pull(wid: int, addr: str):
            c = rpc.RpcClient(addr, WORKER_SERVICE, timeout=2.0)
            try:
                return wid, c.try_call("GetMetrics", retries=0)
            finally:
                c.close()

        # req["workers"]=False: shard fan-in pulls workers through ONE
        # shard only (every shard sees the same fleet; duplicating the
        # worker dials M times would skew the merged counters M-fold)
        if targets and req.get("workers", True):
            with _fut.ThreadPoolExecutor(
                    max_workers=min(16, len(targets))) as pool:
                for wid, reply in pool.map(lambda t: pull(*t), targets):
                    if reply and "snapshot" in reply:
                        by_node[f"worker{wid}"] = reply["snapshot"]
        return {"snapshot": merge_snapshots(by_node),
                "nodes": sorted(by_node)}

    def _rpc_get_health(self, req: dict) -> dict:
        """Cluster-wide health: this process's roll-up plus every live
        worker's (GetHealth dialed at each worker's advertised address,
        the same diagnostic pull plane as GetMetrics), combined into
        one worst-of status with node-prefixed reason codes —
        Client.health() and the scanner_top ALERTS section read this."""
        from concurrent import futures as _fut

        with self._lock:
            targets = [(w.worker_id, w.address)
                       for w in self._workers.values()
                       if w.active and w.address]
        nodes: Dict[str, dict] = {"master": _health.status_dict()}

        def pull(wid: int, addr: str):
            c = rpc.RpcClient(addr, WORKER_SERVICE, timeout=2.0)
            try:
                return wid, c.try_call("GetHealth", retries=0)
            finally:
                c.close()

        if targets and req.get("workers", True):
            with _fut.ThreadPoolExecutor(
                    max_workers=min(16, len(targets))) as pool:
                for wid, reply in pool.map(lambda t: pull(*t), targets):
                    if reply and "health" in reply:
                        nodes[f"worker{wid}"] = reply["health"]
        return _health.merge_status(nodes)

    def _rpc_get_compile_ledger(self, req: dict) -> dict:
        """Cluster-wide compile ledger + roofline table: this process's
        compile report plus every live worker's (GetCompileLedger
        dialed at each worker's advertised address — the same
        diagnostic pull plane as GetMetrics/GetHealth).
        Client.compile_report() and tools/scanner_cost.py read this."""
        from concurrent import futures as _fut

        with self._lock:
            targets = [(w.worker_id, w.address)
                       for w in self._workers.values()
                       if w.active and w.address]
        nodes: Dict[str, dict] = {"master": _coststats.compile_report()}

        def pull(wid: int, addr: str):
            c = rpc.RpcClient(addr, WORKER_SERVICE, timeout=2.0)
            try:
                return wid, c.try_call("GetCompileLedger", retries=0)
            finally:
                c.close()

        if targets and req.get("workers", True):
            with _fut.ThreadPoolExecutor(
                    max_workers=min(16, len(targets))) as pool:
                for wid, reply in pool.map(lambda t: pull(*t), targets):
                    if reply and "report" in reply:
                        nodes[f"worker{wid}"] = reply["report"]
        return {"nodes": nodes}

    def _rpc_poke(self, req: dict) -> dict:
        self._last_poke = time.time()
        return {"ok": True}

    # -- remediation actions (engine/controller.py binds these) -------------

    def _pause_admission(self, transition: dict) -> str:
        """admission_pause playbook, firing side: running bulks keep
        flowing; NEW NewJob admissions answer retryable until the
        backpressure resolves and the hysteresis hold elapses."""
        reason = transition.get("rule", "backpressure")
        lbl = transition.get("labels") or {}
        if lbl:
            reason += "[" + ",".join(
                f"{k}={v}" for k, v in sorted(lbl.items())) + "]"
        with self._lock:
            self._admission_paused = reason
        _M_ADMISSION_PAUSED.set(1)
        return f"admission paused ({reason})"

    def _resume_admission(self, transition: dict) -> str:
        with self._lock:
            self._admission_paused = None
        _M_ADMISSION_PAUSED.set(0)
        return "admission resumed"

    def _autoscale_nudge(self, transition: dict) -> Optional[str]:
        """autoscale_up playbook: a device_saturation firing transition
        makes the autoscaler re-evaluate immediately instead of waiting
        for the next periodic observation."""
        target = self._autoscale_observe()
        return None if target is None else f"desired={target}"

    def _autoscale_observe(self) -> Optional[int]:
        """Feed the autoscaler one observation of the cluster: live
        worker count (preempting workers excluded — their capacity is
        already leaving), master queue depth + outstanding tasks, and
        how many workers report device_saturation firing."""
        a = self.autoscaler
        if a is None:
            return None
        with self._lock:
            workers = sum(1 for w in self._workers.values()
                          if w.active and not w.preempting)
            saturated = sum(
                1 for w in self._workers.values()
                if w.active and "device_saturation" in w.firing)
            bulk = self._bulk
            if bulk is not None and not bulk.finished:
                queued = bulk.q_count()
                outstanding = len(bulk.outstanding)
            else:
                queued = outstanding = 0
        # the master's own engine may also see saturation (in-process
        # clusters share one registry) — count it once
        if not saturated and any(
                f.get("rule") == "device_saturation"
                for f in _health.status_dict().get("firing", ())):
            saturated = 1
        return a.observe(workers=workers, queued=queued,
                         outstanding=outstanding,
                         saturated_workers=saturated)

    def _fold_worker_alerts(self) -> None:
        """Translate worker-reported firing alerts (heartbeat `firing`
        field) into cluster-level transitions for the remediation
        controller: stage_backpressure fires inside worker processes,
        but the admission gate it must actuate lives here."""
        if not _controller.enabled():
            return
        with self._lock:
            union: Set[str] = set()
            for w in self._workers.values():
                if w.active:
                    union |= w.firing
            fired = union - self._worker_firing
            resolved = self._worker_firing - union
            self._worker_firing = union
        ctrl = _controller.controller()
        for rule in sorted(fired):
            ctrl.on_transition({"state": "firing", "rule": rule,
                                "severity": "warning",
                                "labels": {"source": "workers"},
                                "value": None})
        for rule in sorted(resolved):
            ctrl.on_transition({"state": "resolved", "rule": rule,
                                "severity": "warning",
                                "labels": {"source": "workers"},
                                "value": None})

    def _rpc_post_profile(self, req: dict) -> dict:
        with self._lock:
            bulk = self._history.get(req["bulk_id"])
            if bulk is not None:
                bulk.profiles.append(req["profile"])
        return {"ok": True}

    def _rpc_get_profiles(self, req: dict) -> dict:
        with self._lock:
            bulk = self._history.get(req["bulk_id"])
            return {"profiles": list(bulk.profiles) if bulk else []}

    def _trim_history_locked(self) -> None:
        """Bound historical-bulk retention: only the newest
        SPAN_HISTORY_BULKS bulks keep full span stores and per-task
        scheduling state; older finished ones compact to straggler
        aggregates + a frozen status snapshot, which GetJobStatus /
        GetTrace / Client.stragglers keep serving — post-completion
        queries work for the whole ring and degrade (spans only) past
        it, instead of a long-lived master holding every bulk's
        10^5-task done-sets forever.  Caller holds self._lock."""
        for bid in sorted(self._history)[:-SPAN_HISTORY_BULKS]:
            old = self._history[bid]
            if old.finished and not old.compacted:
                old.compact(self._job_status_locked(old))
            else:
                old.spans = []

    # -- trace assembly (util/tracing.py) -----------------------------------

    def _absorb_span_locked(self, bulk: _BulkJob, d: dict) -> None:
        """One shipped span into the bulk's store + the incremental
        straggler aggregates (per-stage stats, slowest-task heap).
        Caller holds self._lock."""
        if bulk.compacted:
            bulk.span_drops += 1  # store dropped at compaction; count,
            # but keep feeding the (retained) aggregates below
        elif len(bulk.spans) < MAX_BULK_SPANS:
            bulk.spans.append(d)
        else:
            bulk.span_drops += 1
        name = d.get("name")
        if not isinstance(name, str):
            return
        dur = max(float(d.get("end") or 0.0)
                  - float(d.get("start") or 0.0), 0.0)
        if name in ("task", "load", "evaluate", "save", "gang") \
                or name.startswith("evaluate:") \
                or name.startswith("gang."):
            st = bulk.span_stats.setdefault(name, [0, 0.0, 0.0])
            st[0] += 1
            st[1] += dur
            st[2] = max(st[2], dur)
        # gang phase spans feed the per-(gang, epoch) barrier-skew fold
        # and the straggler attribution rows (docs/observability.md
        # §Cross-host time)
        if name in ("gang.barrier", "gang.collective"):
            self._fold_gang_phase_locked(bulk, name, d, dur)
        # roofline verdicts ride on the op spans (engine/evaluate.py
        # op.efficiency events); fold them into tiny aggregates so
        # stragglers answer "inefficient or overloaded" per op (the
        # shared fold — tracing.straggler_summary uses the same one)
        _tracing.fold_op_efficiency(d, bulk.eff_stats)
        if name == "task":
            a = d.get("attrs") or {}
            bulk.slow_seq += 1
            heapq.heappush(bulk.slowest, (
                dur, bulk.slow_seq, a.get("job"), a.get("task"),
                d.get("node"), d.get("span_id")))
            if len(bulk.slowest) > STRAGGLER_TOP_N:
                heapq.heappop(bulk.slowest)

    def _fold_gang_phase_locked(self, bulk: _BulkJob, name: str,
                                d: dict, dur: float) -> None:
        """One member's gang.barrier / gang.collective span into the
        per-(gang_id, epoch) fold.  Barrier-entry stamps are corrected
        with the shipping node's clock offset (when trustworthy) so
        the max-min skew compares arrivals on ONE clock; once every
        member reported, the skew histogram observes and an
        attribution row names the slowest member.  Caller holds
        self._lock."""
        a = d.get("attrs") or {}
        try:
            gid, ep = int(a["gang"]), int(a["epoch"])
            member, num = int(a["member"]), int(a["num"])
        except (KeyError, TypeError, ValueError):
            return
        if num <= 0:
            return
        rec = bulk.gang_arrivals.get((gid, ep))
        if rec is None:
            rec = bulk.gang_arrivals[(gid, ep)] = {
                "num": num, "job": a.get("job"), "task": a.get("task"),
                "arrive": {}, "wait": {}, "collective": {}, "node": {},
                "done": False}
            # incomplete folds from gangs that aborted mid-report are
            # garbage after the epoch bumps; bound the map
            if len(bulk.gang_arrivals) > 4 * MAX_GANG_SKEW_ROWS:
                for k in sorted(bulk.gang_arrivals)[
                        :len(bulk.gang_arrivals) - 2 * MAX_GANG_SKEW_ROWS]:
                    if not bulk.gang_arrivals[k]["done"]:
                        del bulk.gang_arrivals[k]
        if rec["done"]:
            return
        node = d.get("node")
        rec["node"][member] = node
        if name == "gang.barrier":
            start = float(d.get("start") or 0.0)
            est = bulk.clock_offsets.get(node) \
                or self._clock_offsets.get(node)
            if _clocksync.should_rebase(est):
                start += float(est["offset"])
            rec["arrive"][member] = start
            rec["wait"][member] = dur
        else:
            rec["collective"][member] = dur
        if len(rec["arrive"]) < num or len(rec["collective"]) < num:
            return
        rec["done"] = True
        arrivals = sorted(rec["arrive"].items(), key=lambda kv: kv[1])
        skew = arrivals[-1][1] - arrivals[0][1]
        _gang.observe_barrier_skew(skew)
        vals = [t for _, t in arrivals]
        median = vals[len(vals) // 2] if len(vals) % 2 \
            else (vals[len(vals) // 2 - 1] + vals[len(vals) // 2]) / 2.0
        slow_member, slow_t = arrivals[-1]
        coll_max = max(rec["collective"].values())
        row = {
            "gang": gid, "epoch": ep,
            "job": rec["job"], "task": rec["task"],
            "skew_s": round(skew, 4),
            "slowest": rec["node"].get(slow_member),
            "member": slow_member,
            "lag_s": round(slow_t - median, 4),
            # the gang step's binding cost: time donated to the last
            # arrival (the skew) vs the post-arrival reduction itself
            "bound": "barrier" if skew >= coll_max else "collective",
            "barrier_wait_max_s": round(max(rec["wait"].values()), 4),
            "collective_max_s": round(coll_max, 4),
        }
        bulk.gang_skew_rows.append(row)
        if len(bulk.gang_skew_rows) > MAX_GANG_SKEW_ROWS:
            del bulk.gang_skew_rows[:len(bulk.gang_skew_rows)
                                    - MAX_GANG_SKEW_ROWS]

    def _drain_master_spans_locked(self) -> None:
        """Move the master's own completed spans (admission, assigns,
        per-task rpc handling) into their bulks' span stores, routed by
        trace_id.  Caller holds self._lock."""
        orphans = []
        for d in self.tracer.drain_export():
            tid = d.get("trace_id")
            for bulk in self._history.values():
                if bulk.trace_id == tid:
                    self._absorb_span_locked(bulk, d)
                    break
            else:
                orphans.append(d)
        # spans for no known bulk (e.g. a pre-admission failure) are
        # dropped — the flight recorder still holds them for a dump
        del orphans

    def _stragglers_locked(self, bulk: _BulkJob) -> dict:
        """Straggler analytics from the incrementally-maintained
        aggregates: per-stage critical-path stats + the top-N slowest
        tasks with their trace ids (jump straight into the merged
        trace).  Shape matches tracing.straggler_summary."""
        per = {}
        for name, (c, tot, mx) in sorted(bulk.span_stats.items()):
            per[name] = {"count": int(c), "total_s": round(tot, 4),
                         "max_s": round(mx, 4),
                         "mean_s": round(tot / c, 4) if c else 0.0}
            # the efficiency join: a slow op at high eff is overloaded
            # (scale it), at low eff inefficient (fix it)
            per[name].update(_tracing.op_efficiency_summary(
                bulk.eff_stats.get(name)))
        slow = [{"job": j, "task": t, "seconds": round(dur, 4),
                 "node": node, "trace_id": bulk.trace_id,
                 "span_id": sid}
                for dur, _seq, j, t, node, sid
                in sorted(bulk.slowest, reverse=True)]
        out = {"per_stage": per, "slowest_tasks": slow,
               "spans": len(bulk.spans),
               "spans_dropped": bulk.span_drops}
        if bulk.gang_skew_rows:
            # per-gang straggler attribution (newest first): which host
            # made each gang slow, by how much, and whether the step
            # was barrier-bound or collective-bound
            out["gangs"] = list(reversed(bulk.gang_skew_rows))
        return out

    def _absorb_batch_locked(self, bulk: _BulkJob, spans) -> None:
        """A shipped batch into the assembly, routed by trace_id —
        stale buffer content from a previous bulk goes home instead of
        polluting this trace.  Caller holds self._lock."""
        for d in spans:
            if isinstance(d, dict) and d.get("trace_id"):
                if d["trace_id"] == bulk.trace_id:
                    self._absorb_span_locked(bulk, d)
                else:
                    for other in self._history.values():
                        if other.trace_id == d["trace_id"]:
                            self._absorb_span_locked(other, d)
                            break

    def _rpc_ship_spans(self, req: dict) -> dict:
        """Out-of-band span shipping: task-completion spans piggyback
        on FinishedWork instead, so this carries the rest — failed
        attempts, the worker's final flush, the client's root span."""
        with self._lock:
            self._touch_worker(req.get("worker_id"))
            self._drain_master_spans_locked()
            bulk = self._history.get(req["bulk_id"])
            if bulk is None:
                return {"ok": False}
            self._intake_clock_locked(bulk, req)
            self._absorb_batch_locked(bulk, req.get("spans") or [])
        return {"ok": True}

    def _intake_clock_locked(self, bulk: _BulkJob, req: dict) -> None:
        """The shipping worker's contemporaneous clock estimate rides
        every span batch ("clock"): refresh the bulk's per-node rebase
        map so GetTrace corrects these spans with the estimate that
        was live when they were stamped.  Caller holds self._lock."""
        est = req.get("clock")
        wid = req.get("worker_id")
        if est and wid is not None and _clocksync.enabled():
            node = f"worker{wid}"
            self._clock_offsets[node] = dict(est)
            if not bulk.compacted:
                bulk.clock_offsets[node] = dict(est)
            _clocksync.publish(node, est)

    def _rpc_get_trace(self, req: dict) -> dict:
        """The assembled cross-host trace of one bulk: every shipped
        worker span plus the master's own, and the straggler summary
        (Client.trace / tools/scanner_trace.py).  Spans are stored
        RAW; remote nodes' timestamps are rebased onto master time at
        read time from the per-node clock offsets — unless the caller
        asks for raw_clocks, rebase is disabled ([trace]
        rebase_clocks), or a node's offset uncertainty exceeds the
        alignment threshold (that node keeps raw stamps; a wrong
        correction smears more than it aligns)."""
        with self._lock:
            bulk = self._history.get(req["bulk_id"]) \
                if req.get("bulk_id") is not None else self._bulk
            if bulk is None:
                return {"error": "no such bulk job"}
            self._drain_master_spans_locked()
            spans = list(bulk.spans)
            offsets = dict(self._clock_offsets)
            offsets.update(bulk.clock_offsets)
            stragglers = self._stragglers_locked(bulk)
            trace_id = bulk.trace_id
            drops = bulk.span_drops
        rebased = False
        if offsets and not req.get("raw_clocks") \
                and _clocksync.rebase_enabled():
            spans = _clocksync.rebase_spans(spans, offsets)
            rebased = any(d.get("clock_rebased") for d in spans)
        return {"trace_id": trace_id,
                "spans": spans,
                "spans_dropped": drops,
                "clock_offsets": offsets,
                "clock_rebased": rebased,
                "stragglers": stragglers}

    # -- memory observability (util/memstats.py) -----------------------------

    def _rpc_ship_memory_report(self, req: dict) -> dict:
        """Workers push their one-shot OOM memory reports here (the
        ShipSpans-style out-of-band path): a worker that OOMs — or
        dies shortly after — leaves its forensics on the master."""
        report = req.get("report")
        if isinstance(report, dict):
            report = dict(report)
            # the report stamps its own origin node; the shipper's id
            # is only the fallback (any sibling worker may ship it)
            if not report.get("node"):
                report["node"] = f"worker{req.get('worker_id', '?')}"
            with self._lock:
                self._mem_reports.append(report)
            _mlog.warning(
                "memory report from worker %s: %s",
                req.get("worker_id"), report.get("reason", ""))
        return {"ok": True}

    def _rpc_get_memory_report(self, req: dict) -> dict:
        """The cluster memory view (Client.memory_report()): this
        process's live memstats snapshot plus every OOM report workers
        shipped, newest last."""
        with self._lock:
            reports = list(self._mem_reports)
        own = _memstats.last_report()
        if own is not None:
            own = dict(own)
            if not own.get("node"):
                own["node"] = "master"
            # in-process clusters share the memstats module: "our own"
            # report may be the very one a worker already shipped —
            # don't serve it twice
            if not any(r.get("seq") == own.get("seq")
                       and r.get("node") == own.get("node")
                       for r in reports):
                reports.append(own)
        return {"memory": _memstats.status_dict(), "reports": reports}

    def _rpc_shutdown(self, req: dict) -> dict:
        """Remote cluster stop (Client.shutdown_cluster / blocking
        start_master deployments).  Forwards Shutdown to every live
        registered worker first (unless workers=False) — their blocking
        wait_for_shutdown loops exit 0 — then releases this master's
        own wait_for_shutdown.  Best-effort fan-out with the ping
        deadline: an unreachable worker is already dead or draining."""
        notified = 0
        if req.get("workers", True):
            from concurrent import futures as _fut

            with self._lock:
                targets = [w.address for w in self._workers.values()
                           if w.active and w.address]

            def poke(addr: str) -> bool:
                c = rpc.RpcClient(addr, WORKER_SERVICE,
                                  timeout=PING_TIMEOUT)
                try:
                    return c.try_call("Shutdown", retries=0) is not None
                finally:
                    c.close()

            if targets:
                # concurrent like _rpc_get_metrics: a fleet of
                # unreachable workers each costs PING_TIMEOUT — serially
                # that would blow the caller's Shutdown deadline
                with _fut.ThreadPoolExecutor(
                        max_workers=min(16, len(targets))) as pool:
                    notified = sum(pool.map(poke, targets))
        self._shutdown.set()
        return {"ok": True, "workers_notified": notified}

    # -- bulk checkpoint / recovery -----------------------------------------

    def _record_admission_token_locked(self, token: str,
                                       bulk_id: int) -> None:
        """Remember a NewJob admission token for dedupe, bounded by the
        insertion ring.  Caller holds self._lock."""
        if token in self._admission_tokens:
            self._admission_tokens[token] = bulk_id
            return
        self._admission_tokens[token] = bulk_id
        self._admission_token_ring.append(token)
        while len(self._admission_token_ring) > _journal.TOKEN_RING:
            old = self._admission_token_ring.popleft()
            self._admission_tokens.pop(old, None)

    @staticmethod
    def _bulk_checkpoint_state(bulk: _BulkJob) -> dict:
        """The admission state needed to resume this bulk after a
        master restart.  Small by construction: the spec blob plus task
        geometry — per-job sink names/custom sinks are re-derived on
        recovery via prepare_readonly (the same derivation workers
        run).  Written as the checkpoint AND journaled as the `admit`
        record, so either survives the other's corruption."""
        return {
            "bulk_id": bulk.bulk_id,
            "spec_blob": bulk.spec_blob,
            "task_timeout": bulk.task_timeout,
            "checkpoint_frequency": bulk.checkpoint_frequency,
            "job_ntasks": {j: len(ts) for j, ts in bulk.job_tasks.items()},
            "job_output_rows": dict(bulk.job_output_rows),
            "sticky": bulk.sticky,
            "gang_hosts": bulk.gang_hosts,
            "gang_sharded": bulk.gang_sharded,
            "gang_halo": bulk.gang_halo,
            "token": bulk.admission_token,
        }

    def _persist_bulk_checkpoint(self, bulk: _BulkJob) -> None:
        """Persist admission state (generation-scoped, checksummed) and
        open a fresh journal for the bulk, with the same state as its
        first record — a corrupt checkpoint then falls back to journal
        replay instead of dropping the bulk."""
        if self._fence.is_set():
            return
        state = self._bulk_checkpoint_state(bulk)
        blob = seal_blob(cloudpickle.dumps(state))
        self.db.backend.write(
            md.bulk_checkpoint_path(self.generation, self.shard_id),
            blob)
        if self._journal is not None:
            self._journal.reset()
            self._journal_append([{"t": "admit", "state": state}])

    @staticmethod
    def _encode_task_set(tasks) -> Dict[int, List[int]]:
        """{job: [s0, e0, s1, e1, ...]} half-open runs — tasks complete
        mostly in order, so a million-task done-set encodes in a few
        runs per job instead of 10^6 tuples per checkpoint write."""
        by_job: Dict[int, List[int]] = {}
        for j, t in tasks:
            by_job.setdefault(j, []).append(t)
        out: Dict[int, List[int]] = {}
        for j, ts in by_job.items():
            ts.sort()
            runs: List[int] = []
            s = p = ts[0]
            for t in ts[1:]:
                if t == p + 1:
                    p = t
                    continue
                runs += [s, p + 1]
                s = p = t
            runs += [s, p + 1]
            out[j] = runs
        return out

    @staticmethod
    def _decode_task_set(enc: Dict[int, List[int]]) -> Set[Tuple[int, int]]:
        return {(j, t) for j, runs in enc.items()
                for i in range(0, len(runs), 2)
                for t in range(runs[i], runs[i + 1])}

    def _persist_bulk_progress(self, bulk: _BulkJob) -> None:
        """Snapshot completion state (under the lock) and write it (storage
        I/O must not stall heartbeats, so callers invoke this outside).
        The journal is cut at the snapshot point: every record the
        snapshot covers lives in a sealed segment below the cut, so
        compaction after the write bounds replay to one checkpoint
        window without ever deleting an uncovered record."""
        if self._fence.is_set():
            return
        with self._lock:
            # C-speed snapshot only; the Python-level run-length encode
            # happens outside so heartbeats/NextWork never wait on it
            done = set(bulk.done)
            prog = {
                "bulk_id": bulk.bulk_id,
                "failures": dict(bulk.failures),
                "transient_failures": dict(bulk.transient_failures),
                "blacklisted_jobs": sorted(bulk.blacklisted_jobs),
                "committed_jobs": sorted(bulk.committed_jobs),
                "error": bulk.error,
                "token": bulk.admission_token,
                # the gang fence's high-water mark: a successor must
                # mint strictly higher epochs than any this master
                # handed out (the journal's gang records cover the
                # checkpoint window on top of this)
                "gang_epoch": bulk.gang_epoch,
            }
            # cut INSIDE the state lock: a mutation not yet in this
            # snapshot can only be journaled after its (post-snapshot)
            # apply, which lands at or above the cut and survives
            cut = self._journal.cut() if self._journal is not None \
                else None
        prog["done_runs"] = self._encode_task_set(done)
        self.db.backend.write(
            md.bulk_progress_path(self.generation, self.shard_id),
            seal_blob(cloudpickle.dumps(prog)))
        if cut is not None and self._journal is not None:
            self._journal.compact_below(cut)
            # re-seed the admit record: compaction may have deleted the
            # segment carrying it, and the corrupt-checkpoint fallback
            # needs admission state IN the journal at all times
            self._journal_append(
                [{"t": "admit",
                  "state": self._bulk_checkpoint_state(bulk)}])

    def _clear_bulk_checkpoint(self, bulk_id: Optional[int] = None) -> None:
        """Remove the (single, fixed-path) bulk checkpoint — but never a
        NEWER active bulk's: callers run outside the control-plane lock,
        so a NewJob admission can land between a bulk finishing and its
        delayed cleanup.  The admission lock serializes us against the
        admission sequence (which writes the new checkpoint while holding
        it)."""
        if self._fence.is_set():
            return  # the successor owns (and clears) control state now
        with self._admit_lock:
            if bulk_id is not None:
                with self._lock:
                    cur = self._bulk
                    if cur is not None and not cur.finished \
                            and cur.bulk_id != bulk_id:
                        return  # a newer active bulk owns the path
            # same contract as the legacy deletes below (baselined):
            # the admission lock exists to serialize storage-mutating
            # admission + checkpoint cleanup end-to-end
            self.db.backend.delete(md.bulk_checkpoint_path(self.generation, self.shard_id))  # scanner-check: disable=SC202 admission lock serializes checkpoint cleanup by design (see baseline twin)
            self.db.backend.delete(md.bulk_progress_path(self.generation, self.shard_id))  # scanner-check: disable=SC202 admission lock serializes checkpoint cleanup by design (see baseline twin)
            if self._journal is not None:
                self._journal.reset()
            # legacy fixed-path state from pre-fencing masters
            self.db.backend.delete(
                md.bulk_checkpoint_path(shard=self.shard_id))
            self.db.backend.delete(
                md.bulk_progress_path(shard=self.shard_id))

    def _load_sealed(self, path: str, what: str) -> Optional[bytes]:
        """Read a (possibly legacy-unsealed) control-plane blob —
        payload, or None (ERROR-logged) on checksum failure so the
        caller falls back to journal replay instead of silently
        resurrecting garbage (or, as the pre-seal code did, silently
        dropping the whole bulk).  One shared policy with tooling
        (journal.read_control_blob)."""
        return _journal.read_control_blob(self.db.backend, path,
                                          what=what)

    def _find_recovery_source(self):
        """Locate the newest predecessor generation (or the legacy
        fixed path) holding bulk state.  Returns (source_gen-or-None,
        admission_state, journal_records, journal_stats) or None."""
        gens = [g for g in
                _journal.claimed_generations(self.db.backend,
                                             shard=self.shard_id)
                if g < self.generation]
        for g in sorted(gens, reverse=True) + [None]:
            records: List[dict] = []
            jstats: Dict[str, int] = {}
            if g is not None:
                records, jstats = _journal.replay(
                    self.db.backend, g, shard=self.shard_id)
            state = None
            payload = self._load_sealed(
                md.bulk_checkpoint_path(g, self.shard_id),
                "bulk checkpoint")
            if payload is not None:
                try:
                    state = cloudpickle.loads(payload)
                except Exception:  # noqa: BLE001
                    _mlog.error(
                        "bulk checkpoint at generation %s is "
                        "undecodable: falling back to journal replay",
                        g)
            if state is None:
                # the journaled `admit` record carries the same
                # admission state the checkpoint does — a corrupt
                # checkpoint costs nothing when the journal survives
                for r in records:
                    if r.get("t") == "admit" \
                            and isinstance(r.get("state"), dict):
                        state = r["state"]
            if state is not None:
                return g, state, records, jstats
        return None

    @staticmethod
    def _apply_journal_records(bulk: _BulkJob, records) -> int:
        """Replay journal records over the progress snapshot.
        Idempotent by construction — done/blacklist/commit records
        union, strike/transient records carry their cumulative count —
        so a record that raced the snapshot applies safely twice."""
        applied = 0
        for r in records:
            t = r.get("t")
            if t == "done":
                key = (int(r["j"]), int(r["k"]))
                if key in bulk.task_rows and key not in bulk.done:
                    bulk.done.add(key)
                    applied += 1
            elif t == "strike":
                key = (int(r["j"]), int(r["k"]))
                bulk.failures[key] = max(bulk.failures.get(key, 0),
                                         int(r.get("n", 1)))
            elif t == "transient":
                key = (int(r["j"]), int(r["k"]))
                bulk.transient_failures[key] = max(
                    bulk.transient_failures.get(key, 0),
                    int(r.get("n", 1)))
            elif t == "blacklist":
                j = int(r["j"])
                if j not in bulk.blacklisted_jobs:
                    bulk.blacklisted_jobs.add(j)
                    applied += 1
                if not bulk.error and r.get("error"):
                    bulk.error = str(r["error"])
            elif t == "commit":
                bulk.committed_jobs.add(int(r["j"]))
            elif t == "gang":
                bulk.next_gang_id = max(bulk.next_gang_id,
                                        int(r.get("g", 0)) + 1)
        # gang-in-flight records restore the epoch fence's high-water
        # mark (journal.gang_epoch_high_water — one fold shared with
        # tooling): a successor's first formation mints a strictly
        # higher epoch, so a pre-failover gang's late completion can
        # never be confused with a live one's (no double-commit
        # across the failover)
        bulk.gang_epoch = max(bulk.gang_epoch,
                              _journal.gang_epoch_high_water(records))
        return applied

    def _drop_recovery_source(self, g: Optional[int]) -> None:
        """Delete a predecessor generation's control state once the
        bulk has been migrated under this master's generation (a crash
        before this leaves both copies; the next recovery prefers the
        newer one)."""
        if g is None:
            self.db.backend.delete(
                md.bulk_checkpoint_path(shard=self.shard_id))
            self.db.backend.delete(
                md.bulk_progress_path(shard=self.shard_id))
        else:
            self.db.backend.delete_prefix(
                md.generation_dir(g, self.shard_id))

    def _recover_bulk(self) -> None:
        """Resume the bulk job a previous master process left behind:
        admission checkpoint (or the journaled admit record when the
        checkpoint is corrupt) + progress snapshot + write-ahead
        journal replay — zero acknowledged completions lost."""
        src = self._find_recovery_source()
        if src is None:
            return
        source_gen, state, records, jstats = src
        try:
            spec = cloudpickle.loads(state["spec_blob"])
            ex = LocalExecutor(self.db, device=torch.device("cpu"))
            _info, jobs = ex.prepare_readonly(spec["outputs"], spec["perf"])
        except Exception:  # noqa: BLE001
            # an unreadable checkpoint must not brick the master; the bulk
            # is lost (client reruns it), new jobs proceed
            _mlog.exception("bulk recovery failed; dropping checkpoint")
            try:
                self._drop_recovery_source(source_gen)
                self._clear_bulk_checkpoint()
            except Exception:  # noqa: BLE001
                pass
            return
        bulk = _BulkJob(
            bulk_id=state["bulk_id"], spec_blob=state["spec_blob"],
            task_timeout=state["task_timeout"],
            checkpoint_frequency=state["checkpoint_frequency"],
            # pre-sticky checkpoints default off (missing key)
            sticky=bool(state.get("sticky", False)),
            # pre-gang checkpoints default to independent pulls
            gang_hosts=int(state.get("gang_hosts", 0) or 0),
            # a failed-over master must keep the SAME evaluation mode
            # the bulk started with (pre-sharding checkpoints ran
            # replicated)
            gang_sharded=bool(state.get("gang_sharded", False)),
            gang_halo=bool(state.get("gang_halo", True)),
            admission_token=str(state.get("token", "") or ""),
            # pre-crash spans are gone with the old process; post-
            # recovery assignments still assemble under one fresh trace
            trace_id=_tracing.new_trace_id())
        for j, n in state["job_ntasks"].items():
            j = int(j)
            job = jobs[j]
            bulk.job_tasks[j] = {(j, t) for t in range(n)}
            for t, (s, e) in enumerate(job.tasks[:n]):
                bulk.task_rows[(j, t)] = e - s
            bulk.job_sink_names[j] = [
                d.name for d, _c, _k, _e in job.sink_tables.values()]
            bulk.job_custom_sinks[j] = list(job.custom_sinks.values())
            bulk.job_output_rows[j] = state["job_output_rows"][j]
            bulk.total_tasks += n
        try:
            prog_payload = self._load_sealed(
                md.bulk_progress_path(source_gen, self.shard_id),
                "bulk progress")
            prog = cloudpickle.loads(prog_payload) \
                if prog_payload is not None else None
            if prog is not None and prog.get("bulk_id") == bulk.bulk_id:
                if "done_runs" in prog:
                    bulk.done = self._decode_task_set(
                        prog["done_runs"])
                else:  # earlier format stored explicit tuples
                    bulk.done = {tuple(k)
                                 for k in prog.get("done", ())}
                bulk.failures = {tuple(k): v
                                 for k, v in prog["failures"].items()}
                bulk.transient_failures = {
                    tuple(k): v for k, v in
                    (prog.get("transient_failures") or {}).items()}
                bulk.blacklisted_jobs = set(prog["blacklisted_jobs"])
                bulk.committed_jobs = set(prog["committed_jobs"])
                bulk.error = prog.get("error", "")
                bulk.gang_epoch = max(
                    bulk.gang_epoch,
                    int(prog.get("gang_epoch", 0) or 0))
        except Exception:  # noqa: BLE001
            # a corrupt progress file costs the snapshot, not the bulk:
            # the journal replay below still restores every record
            # since the last compaction
            _mlog.exception("bulk progress unreadable; resuming from "
                            "admission state + journal replay")
            bulk.done = set()
            bulk.failures = {}
        # write-ahead journal replay: completions/strikes/blacklists
        # acknowledged after the last checkpoint — the records a plain
        # checkpoint-window restart would lose and re-execute
        applied = self._apply_journal_records(bulk, records)
        if bulk.gang_hosts:
            _gang.set_epoch(bulk.gang_epoch)
        if records:
            _mlog.info(
                "journal replay: %d records across %d segments "
                "(%d newly applied over the checkpoint%s)",
                jstats.get("records", 0), jstats.get("segments", 0),
                applied,
                "; torn tail tolerated" if jstats.get("torn") else "")
        # blacklist aggregates from the FINAL sets (snapshot + replay)
        for j in bulk.blacklisted_jobs:
            bulk.blacklisted_task_total += len(
                bulk.job_tasks.get(j, ()))
            bulk.done_in_blacklisted += sum(
                1 for k in bulk.job_tasks.get(j, ())
                if k in bulk.done)
        # ETA baseline: rate counts only post-recovery completions
        bulk.done_at_start = len(bulk.done) - bulk.done_in_blacklisted
        for j, _t in bulk.done:
            bulk.job_done[j] = bulk.job_done.get(j, 0) + 1
        for j, ts in sorted(bulk.job_tasks.items()):
            if j in bulk.blacklisted_jobs:
                continue
            remaining = sorted(t for (_j, t) in ts if (_j, t) not in
                               bulk.done)
            if remaining:
                bulk.queue[j] = deque(remaining)
                bulk.job_rr.append(j)
        if self.num_shards > 1:
            # shard-failover accounting: a journaled (acknowledged)
            # completion that landed back in the queue would re-execute
            # work a worker already finished.  Structurally zero —
            # replay unions into bulk.done before the queue rebuild —
            # and the master-shard-loss chaos drill asserts it stays so.
            journaled = {(int(r["j"]), int(r["k"])) for r in records
                         if r.get("t") == "done"}
            requeued = {(j, t) for j, q in bulk.queue.items()
                        for t in q}
            _shardmap.count_journal_reexec(len(journaled & requeued))
            _shardmap.count_failover()
        # published under the lock: _recover_bulk normally runs before
        # the RPC server exists, but nothing in its signature promises
        # that — and handler threads read these fields under _lock
        with self._lock:
            self._bulk = bulk
            self._history[bulk.bulk_id] = bulk
            self._next_bulk_id = max(self._next_bulk_id,
                                     bulk.bulk_id + 1)
            if bulk.admission_token:
                # client ride-through: a NewJob retried against THIS
                # master with the original token dedupes to the
                # recovered bulk instead of double-running it
                self._record_admission_token_locked(
                    bulk.admission_token, bulk.bulk_id)
        # tasks finished before the crash may complete whole jobs (or the
        # whole bulk, if the crash hit between last-task and cleanup)
        for j in list(bulk.job_tasks):
            self._maybe_finish_job(bulk, j)
        self._maybe_finish_bulk(bulk)
        if bulk.finished:
            self._clear_bulk_checkpoint()
            self._drop_recovery_source(source_gen)
            _mlog.info("recovered bulk %d was already complete", bulk.bulk_id)
        else:
            # migrate the bulk's durable state under THIS generation
            # (fresh checkpoint + progress + journal), then drop the
            # predecessor's — its fenced late writes land in a
            # directory nothing reads again
            self._persist_bulk_checkpoint(bulk)
            self._persist_bulk_progress(bulk)
            self._drop_recovery_source(source_gen)
            _mlog.info(
                "recovered bulk %d from generation %s: %d/%d tasks "
                "done, %d requeued", bulk.bulk_id,
                source_gen if source_gen is not None else "legacy",
                len(bulk.done), bulk.total_tasks, bulk.q_count())

    # -- internals ----------------------------------------------------------

    @staticmethod
    def _dec_held(bulk: _BulkJob, wid: int) -> None:
        n = bulk.held.get(wid, 0) - 1
        if n > 0:
            bulk.held[wid] = n
        else:
            bulk.held.pop(wid, None)

    @classmethod
    def _unassign(cls, bulk: _BulkJob, key) -> Optional[Tuple]:
        """Drop an outstanding assignment, keeping the per-worker held
        count in sync (save-parked tasks were already released)."""
        cur = bulk.outstanding.pop(key, None)
        if cur is not None and not cur[4]:
            cls._dec_held(bulk, cur[0])
        return cur

    def _blacklist_job(self, bulk: _BulkJob, j: int, err: str,
                       recs: Optional[List[dict]] = None) -> None:
        if j in bulk.blacklisted_jobs:
            # idempotent: two timed-out tasks of one job can both trip the
            # failure threshold in a single scan pass; double-counting the
            # finish counters would let the bulk "finish" early
            return
        _mlog.error("job %d blacklisted after repeated failures: %s", j, err)
        _M_JOBS_BLACKLISTED.inc()
        if recs is not None:
            recs.append({"t": "blacklist", "j": j, "error": err})
        bulk.blacklisted_jobs.add(j)
        bulk.blacklisted_task_total += len(bulk.job_tasks.get(j, ()))
        bulk.done_in_blacklisted += sum(
            1 for k in bulk.job_tasks.get(j, ()) if k in bulk.done)
        bulk.queue.pop(j, None)  # the rr ring drops it lazily
        for k in [k for k in bulk.outstanding if k[0] == j]:
            self._unassign(bulk, k)
        if not bulk.error:
            bulk.error = f"job {j} blacklisted after repeated failures: {err}"

    def _maybe_finish_job(self, bulk: _BulkJob, j: int,
                          recs: Optional[List[dict]] = None) -> None:
        if j in bulk.committed_jobs or j in bulk.blacklisted_jobs:
            return
        if bulk.job_tasks[j] <= bulk.done:
            # all tasks of this output stream finished: commit its tables
            # (reference: tables committed per job, master.cpp:1031-1125)
            for name in bulk.job_sink_names.get(j, []):
                if self.db.has_table(name):
                    self.db.commit_table(name)
            for stream in bulk.job_custom_sinks.get(j, []):
                stream.storage.finished(stream,
                                        bulk.job_output_rows.get(j, 0))
            bulk.committed_jobs.add(j)
            if recs is not None:
                recs.append({"t": "commit", "j": j})

    def _maybe_finish_bulk(self, bulk: _BulkJob) -> None:
        active_total = bulk.total_tasks - bulk.blacklisted_task_total
        active_done = len(bulk.done) - bulk.done_in_blacklisted
        if active_done >= active_total and not bulk.outstanding:
            bulk.mark_finished()
            _mlog.info("bulk %d finished: %d/%d tasks done",
                       bulk.bulk_id, len(bulk.done), bulk.total_tasks)
            self.db.write_megafile()

    def _scan_loop(self) -> None:
        """Liveness + timeout scanning (reference start_worker_pinger
        master.cpp:1837 and timeout scan master.cpp:1751-1776)."""
        fence_tick = 0
        while not self._shutdown.is_set():
            time.sleep(0.5)
            now = time.time()
            finished_bulk_id = None
            # generation-fence poll (~2 s): a paused-then-resumed stale
            # master discovers its successor here and stops accepting
            # mutations (path scoping already protects storage)
            fence_tick += 1
            if fence_tick % 4 == 0:
                self._check_fence()
                # same cadence: adopt newer shard-map epochs so the
                # stale-map fence reflects peers' failover re-publishes
                self._refresh_shard_map()
            recs: List[dict] = []
            with self._lock:
                # refresh the point-in-time gauges (0.5s resolution is
                # plenty for a human-watched dashboard)
                _M_WORKERS.set(sum(1 for w in self._workers.values()
                                   if w.active))
                for w in self._workers.values():
                    if w.active:
                        _M_HB_AGE.labels(worker=str(w.worker_id)).set(
                            now - w.last_seen)
                    else:
                        # drop the child: worker ids are never reused,
                        # so keeping one -1 series per dead id would
                        # grow every scrape of a week-old master
                        _M_HB_AGE.remove_labels(worker=str(w.worker_id))
                        # same churn story for the departed node's
                        # clock gauges (the rebase MAP keeps its
                        # estimate — already-shipped spans still need
                        # correcting; only the scrape surface shrinks)
                        _clocksync.unpublish(f"worker{w.worker_id}")
                cur = self._bulk
                if cur is not None and not cur.finished:
                    _M_TASKS_QUEUED.set(cur.q_count())
                    _M_TASKS_OUTSTANDING.set(len(cur.outstanding))
                else:
                    _M_TASKS_QUEUED.set(0)
                    _M_TASKS_OUTSTANDING.set(0)
                # stale workers -> deactivate + requeue their tasks
                for w in self._workers.values():
                    if w.active and now - w.last_seen > WORKER_STALE_AFTER:
                        w.active = False
                        _mlog.warning(
                            "worker %d stale (%.1fs since heartbeat): "
                            "deactivating and requeueing its tasks",
                            w.worker_id, now - w.last_seen)
                        self._requeue_worker_tasks(w.worker_id,
                                                   recs=recs)
                bulk = self._bulk
                if bulk is not None and not bulk.finished:
                    # per-task timeout
                    if bulk.task_timeout > 0:
                        for key, (wid, t0, _a, started, _ed) in \
                                list(bulk.outstanding.items()):
                            if now - t0 > bulk.task_timeout:
                                gid = bulk.gang_by_task.get(key)
                                if gid is not None:
                                    # a timed-out gang is a lost/hung
                                    # member set: abort the whole gang
                                    # (epoch bump + strike-free requeue
                                    # for a fresh gang), not a per-
                                    # worker revocation
                                    g = bulk.gangs.get(gid)
                                    if g is not None:
                                        self._abort_gang_locked(
                                            bulk, g, "timeout", recs)
                                    continue
                                self._unassign(bulk, key)
                                _M_REVOCATIONS.inc()
                                _mlog.warning(
                                    "task (%d,%d) timed out on worker %d "
                                    "after %.1fs (started=%s): revoking",
                                    key[0], key[1], wid, now - t0, started)
                                if not started:
                                    # never began executing: a queue-wait
                                    # artifact, not a task failure
                                    bulk.q_push(key, front=True)
                                    continue
                                self._count_strike_locked(
                                    bulk, key, "task timeout",
                                    recs=recs)
                        self._maybe_finish_bulk(bulk)
                    # no workers at all
                    if not any(w.active for w in self._workers.values()):
                        if now - self._no_worker_since > \
                                self.no_workers_timeout:
                            bulk.error = (
                                f"no workers available after "
                                f"{self.no_workers_timeout}s")
                            bulk.mark_finished()
                    else:
                        self._no_worker_since = now
                        # a gang bulk on a fleet whose live workers are
                        # ALL gang-incapable (registered with no gang
                        # address — SCANNER_TPU_GANG=0 / [gang]
                        # enabled=false) would otherwise wait forever:
                        # every pull answers "wait" and no formation
                        # can ever happen.  Fail it loudly on the same
                        # clock a worker-less bulk gets.
                        if bulk.gang_hosts and not bulk.finished \
                                and (bulk.q_has_work()
                                     or bulk.outstanding):
                            capable = any(
                                w.active and w.gang_address
                                for w in self._workers.values())
                            if capable:
                                bulk.gang_incapable_since = 0.0
                            elif not bulk.gang_incapable_since:
                                bulk.gang_incapable_since = now
                            elif now - bulk.gang_incapable_since \
                                    > self.no_workers_timeout:
                                bulk.error = (
                                    f"gang_hosts={bulk.gang_hosts} "
                                    "but no gang-capable worker "
                                    "joined within "
                                    f"{self.no_workers_timeout}s "
                                    "(fleet running with gang "
                                    "scheduling disabled?)")
                                bulk.mark_finished()
                if bulk is not None and bulk.finished:
                    finished_bulk_id = bulk.bulk_id
                if self.enable_watchdog and \
                        now - self._last_poke > 30.0:
                    self._shutdown.set()
            self._journal_append(recs)
            if finished_bulk_id is not None \
                    and finished_bulk_id != self._cleared_bulk_id:
                self._clear_bulk_checkpoint(finished_bulk_id)
                self._cleared_bulk_id = finished_bulk_id
            # remediation drive (outside the control lock; everything
            # below no-ops under SCANNER_TPU_REMEDIATION=0): fold
            # worker-reported alerts into cluster transitions, run
            # hysteresis-held resolve actions, observe the autoscaler
            if _controller.enabled():
                try:
                    self._fold_worker_alerts()
                    _controller.controller().tick(now)
                    self._autoscale_observe()
                except Exception:  # noqa: BLE001 — remediation must
                    # never kill the liveness scan
                    _mlog.exception("remediation tick failed")

    def _requeue_worker_tasks(self, wid: int,
                              recs: Optional[List[dict]] = None) -> None:
        bulk = self._bulk
        if bulk is None or bulk.finished:
            return
        # a dead/departing worker takes its gang memberships with it:
        # abort those gangs first (epoch bump + strike-free requeue for
        # a fresh gang on the survivors) — the dead worker may be a
        # NON-coordinator member, invisible to the outstanding map
        if recs is None:
            recs = []
        for g in list(bulk.gangs.values()):
            if wid in g.members:
                self._abort_gang_locked(bulk, g, "member_lost", recs)
        bulk.gang_forming.pop(wid, None)
        for key, (owner, _t0, _a, _s, _ed) in list(bulk.outstanding.items()):
            if owner == wid:
                self._unassign(bulk, key)
                bulk.q_push(key, front=True)
                _M_REVOCATIONS.inc()
                _M_TASK_RETRIES.inc()

    def wait_for_shutdown(self) -> None:
        while not self._shutdown.is_set():
            time.sleep(0.2)
        self.stop()

    def stop(self) -> None:
        self._shutdown.set()
        self._server.stop()
        if self.metrics_server is not None:
            self.metrics_server.stop()
            self.metrics_server = None
        # drop this master's heartbeat-age gauge children: with the
        # scan loop gone nothing would ever update or remove them, and
        # a stale high-age sample would keep the health engine's
        # worker_heartbeat_stale alert firing forever in a process that
        # outlives the master (embedders, test suites)
        with self._lock:
            for w in self._workers.values():
                _M_HB_AGE.remove_labels(worker=str(w.worker_id))
            # and this master's per-node clock gauges, for the same
            # outliving-process reason
            for node in self._clock_offsets:
                _clocksync.unpublish(node)
        # unbind this master's remediation actions (owner-checked: a
        # NEWER master's re-registration in the same process must
        # survive this one's delayed stop): a later transition must not
        # actuate a dead instance — and the bound methods would
        # otherwise pin the whole Master object alive.  If admission
        # was paused, clear the gate + gauge on the way out: the
        # resume action is gone, so the pending hysteresis resolve
        # could never reset them in a process that outlives the master
        # (the same dead-master-alerts-forever class the heartbeat-age
        # gauge cleanup above handles).
        if _controller.enabled():
            for name, fn in (("pause_admission", self._pause_admission),
                             ("resume_admission",
                              self._resume_admission),
                             ("autoscale", self._autoscale_nudge)):
                _controller.unregister_action(name, owner=fn)
            with self._lock:
                was_paused = self._admission_paused is not None
                self._admission_paused = None
            if was_paused:
                _M_ADMISSION_PAUSED.set(0)


# ---------------------------------------------------------------------------
# Worker
# ---------------------------------------------------------------------------

class _ShardLink:
    """One worker's connection to one master shard: its own channel,
    the worker id THAT shard handed out (ids are per-shard), a
    generation latch scoped to that shard's namespace, and the
    freshest heartbeat reply.  The worker multiplexes pulls and
    reports across its links (docs/robustness.md §Sharded control
    plane); with one shard no links exist and the legacy single-master
    fields are the whole story."""

    def __init__(self, shard_id: int, address: str):
        self.shard_id = int(shard_id)
        self.address = str(address)
        self.client = rpc.RpcClient(address, MASTER_SERVICE,
                                    timeout=10.0)
        self.worker_id: Optional[int] = None
        self.gen = _journal.GenerationLatch()
        self.hb_reply: dict = {}
        self.hb_reply_at = 0.0
        self.hb_misses = 0

    def redial(self, address: Optional[str] = None) -> None:
        """Fresh channel (the wedged-channel pathology — see
        Worker._heartbeat_loop), optionally at a new address a
        failover respawn re-published."""
        if address:
            self.address = str(address)
        old, self.client = self.client, rpc.RpcClient(
            self.address, MASTER_SERVICE, timeout=10.0)
        old.close()

    def close(self) -> None:
        try:
            self.client.close()
        except Exception:  # noqa: BLE001 — shutdown is best-effort
            pass


# how long completions may pool in the worker-side batcher before a
# FinishedWorkBatch flush (sharded mode only): short enough that the
# master's progress view lags by at most ~one heartbeat fraction
FINISHED_BATCH_WINDOW_S = 0.05


class WorkerPipeline:
    """A worker's task path below its RPCs, on the worker's device.

    `join` takes a bulk's spec the way every worker derives it (the
    executor's `prepare_readonly` and chain setup, with the bulk's
    pipeline shape), and `run` drives `LocalExecutor.run_pipeline` from
    a task source with one `TaskEvaluator` per pipeline instance, kept
    across the bulk's tasks.  `Worker` feeds it tasks pulled from the
    master and reports through the hooks; any other source works the
    same way (a list of `TaskItem`s, for one)."""

    def __init__(self, executor: LocalExecutor, device: torch.device,
                 default_instances: Optional[int] = None):
        self.executor = executor
        self.device = device
        self.default_instances = default_instances
        self.profiler = executor.profiler
        self.info = None
        self.jobs = None
        self.queue_size: Optional[int] = None
        self._evaluators: Dict[int, TaskEvaluator] = {}
        self._lock = threading.Lock()

    def join(self, outputs, perf: PerfParams, profiler: Profiler) -> None:
        """Adopt one bulk: plan its jobs read-only (the master created
        the tables) and drop the previous bulk's evaluators."""
        ex = self.executor
        self.profiler = ex.profiler = profiler
        # the job's PerfParams drive this node's pipeline shape (reference
        # worker.cpp:1467 pipeline instance spin-up from job params); an
        # unset knob restores the worker's constructor default — which on
        # a multi-card host resolves to one pipeline instance per card
        # (engine/evaluate.py default_pipeline_instances)
        ex.pipeline_instances = int(
            getattr(perf, "pipeline_instances_per_node", None)
            or default_pipeline_instances(self.default_instances,
                                          self.device))
        self.queue_size = int(getattr(perf, "queue_size_per_pipeline", 4))
        info, jobs = ex.prepare_readonly(outputs, perf)
        # stateful task affinity: incremental plans when the master's
        # sticky assignment hands us a job's tasks in order (any break
        # degrades to self-contained plans / StateCarryMiss re-runs)
        ex.setup_chains(info, jobs, perf)
        self.close()
        self.info, self.jobs = info, jobs

    def _evaluator(self, idx: int, skip_fetch: bool) -> TaskEvaluator:
        with self._lock:
            te = self._evaluators.get(idx)
            if te is None:
                te = TaskEvaluator(
                    self.info, self.profiler, self.device,
                    stage=self.executor.stage,
                    skip_fetch_resources=skip_fetch,
                    precompile=LocalExecutor.precompile_hint(
                        self.jobs or []),
                    # device affinity: reused instance idx keeps
                    # owning card idx mod n across pipeline entries
                    instance=idx,
                    instances=self.executor.pipeline_instances)
                self._evaluators[idx] = te
            return te

    def run(self, source, **hooks) -> None:
        """Run tasks from `source` (a TaskItem, "wait", or None when
        done) until it runs dry; `hooks` are run_pipeline's on_start /
        on_eval_done / on_done / on_task_error."""
        # level >= 2: capture this node's device timeline for the bulk;
        # its events ship inside the profile (PostProfile) and
        # Profile.write_trace merges them
        from ..util.torchprof import device_trace
        with device_trace(self.profiler):
            self.executor.run_pipeline(
                self.info, source, evaluator_factory=self._evaluator,
                close_evaluators=False, queue_size=self.queue_size,
                **hooks)

    def close(self) -> None:
        with self._lock:
            for te in self._evaluators.values():
                te.close()
            self._evaluators = {}


class Worker:
    """Executes tasks pulled from the master; one process per node.

    Capability parity: reference WorkerImpl (worker.cpp) — job admission,
    local DAG re-analysis, task execution, failure reporting.

    `device` is where this worker's tasks run: "cuda" (the default; the
    current card), "cuda:N", "cpu", or a torch.device — resolved by
    `evaluate.resolve_device`, so asking for a card without one raises.
    `compilation_cache_dir` is accepted for the JAX package's signature
    and ignored: the kernel libraries are built once into
    scanner_tpu_torch/_build/.

    `coordinator` (a parallel.distributed.CoordinatorConfig) joins this
    process to a process group for the worker's lifetime — "nccl" bound
    to the worker's card, "gloo" for a CPU worker — before the worker
    binds its server or starts a thread; a join that fails raises
    `RendezvousError` with nothing started, a constructor that fails
    after the join leaves the group again, and `stop()` leaves it.  Task dispatch does not change: each member registers and
    pulls tasks as any worker does; the group is there for kernels that
    build meshes over it.  A gang bulk's members join a process group
    of their own per gang epoch (engine/gang.py), in child processes.
    """

    def __init__(self, master_address: str, db_path: str, port: int = 0,
                 storage_type: str = "posix",
                 num_load_workers: int = 2, num_save_workers: int = 2,
                 # None = one instance per card on multi-card hosts
                 # (resolved per bulk); explicit wins
                 pipeline_instances: Optional[int] = None,
                 decoder_threads: int = 1,
                 coordinator=None,
                 metrics_port: Optional[int] = None,
                 metrics_host: str = "0.0.0.0",
                 advertise_host: Optional[str] = None,
                 compilation_cache_dir: Optional[str] = None,
                 device: Union[str, torch.device] = "cuda"):
        del compilation_cache_dir  # see the class docstring
        # resolved before anything starts: a worker asked for a card
        # that is not there raises here, with no server bound
        self.device = resolve_device(device)
        # the lifetime group, joined before any server or thread
        # exists (reference worker-per-node topology, worker.cpp:484)
        self.coordinator = coordinator
        self.group_join_s: Optional[float] = None
        if coordinator is not None:
            self.group_join_s = _distributed.join(coordinator, self.device)
        self._server = None
        self.metrics_server: Optional[MetricsServer] = None
        try:
            self._start(master_address, db_path, port, storage_type,
                        num_load_workers, num_save_workers,
                        pipeline_instances, decoder_threads, metrics_port,
                        metrics_host, advertise_host)
        except BaseException:
            # a worker that did not start leaves what it had started:
            # its servers and its lifetime group, so that this process
            # can retry, with another coordinator too
            if self._server is not None:
                self._server.stop()
            if self.metrics_server is not None:
                self.metrics_server.stop()
            if coordinator is not None:
                _distributed.shutdown()
            raise

    def _start(self, master_address, db_path, port, storage_type,
               num_load_workers, num_save_workers, pipeline_instances,
               decoder_threads, metrics_port, metrics_host,
               advertise_host) -> None:
        """The rest of the constructor: the database, the servers, the
        executor, registration with the master and the threads."""
        # gang member runners re-derive the job from these
        # (engine/gang.py: one child process per gang epoch, on this
        # worker's device)
        self._db_path = db_path
        self._storage_type = storage_type
        self.db = Database(make_storage(storage_type, db_path=db_path))
        self.profiler = Profiler(node="worker")
        # this worker's span sink: stage/op spans land here and ship to
        # the master in batches (ShipSpans); the node label is refined
        # to worker<id> once registration hands out the id
        self.tracer = _tracing.Tracer(node="worker", export=True)
        # an OOM report from this process should snapshot THIS worker's
        # flight recorder, not the default client tracer (last Worker
        # constructed wins when several share a test process)
        _memstats.set_tracer(self.tracer)
        self._shutdown = threading.Event()
        # master-generation latch (engine/journal.py): replies stamped
        # with an older generation than the highest seen are a stale
        # (superseded) master's — its assignments and revocations are
        # NACKed instead of acted on
        self._gen = _journal.GenerationLatch()
        # SIGTERM drain mode (start_worker wires the signal): stop
        # pulling, finish in-flight tasks, deregister, then shut down
        self._draining = threading.Event()
        # preemption notice (spot/preemptible reclaim, or the
        # worker.preempt chaos site): drain as above, but ALSO
        # advertise the notice on every heartbeat so the master fences
        # assignment before the drain completes
        self._preempting = False
        self._server = rpc.RpcServer(WORKER_SERVICE, {
            "Ping": lambda req: {"ok": True},
            # serves the master's cluster-wide metrics aggregation
            "GetMetrics": lambda req: {
                "snapshot": _mx.registry().snapshot()},
            # serves the master's cluster-wide health aggregation
            # (GetHealth fan-in -> Client.health())
            "GetHealth": lambda req: {"health": _health.status_dict()},
            # serves the master's compile-ledger/roofline aggregation
            # (GetCompileLedger fan-in -> Client.compile_report())
            "GetCompileLedger": lambda req: {
                "report": _coststats.compile_report()},
            "Shutdown": self._rpc_shutdown,
        }, port=port, tracer=self.tracer)
        self.port = self._server.port
        self._server.start()
        if metrics_port is not None:
            self.metrics_server = MetricsServer(
                port=metrics_port, statusz=self._statusz,
                healthz=lambda: {"role": "worker",
                                 "draining": self._draining.is_set()},
                # SIGTERM drain: not-ready (k8s stops routing) while
                # /healthz stays 200 (still alive, finishing in-flight)
                ready=lambda: not self._draining.is_set(),
                host=metrics_host)
        # health/SLO engine: backpressure/saturation rules read series
        # this worker's pipeline maintains; alert transition instants
        # land on THIS worker's flight recorder (node-labeled)
        _health.set_tracer(self.tracer)
        _health.ensure_started()
        # remediation controller: worker-local playbooks (frame-cache
        # shrink, ladder re-warm) actuate here; master-side ones stay
        # unbound no-ops in this process
        _controller.ensure_started()
        self.executor = LocalExecutor(
            self.db, self.profiler, self.device,
            num_load_workers=num_load_workers,
            num_save_workers=num_save_workers,
            # the per-bulk resolution (_ensure_bulk) overwrites this;
            # the executor field itself just needs a concrete int
            pipeline_instances=pipeline_instances or 1,
            decoder_threads=decoder_threads)
        rpc.wait_for_server(master_address, MASTER_SERVICE)
        # dial the master only AFTER it provably listens: a gRPC channel
        # first dialed against a not-yet-listening address can wedge in
        # connection-refused on some network stacks (see
        # rpc.wait_for_server), and this channel lives for the worker's
        # whole life — except across a master restart, where the
        # heartbeat loop recreates it (see _heartbeat_loop: the same
        # wedge can strike a channel whose peer died and came back)
        self._master_address = master_address
        self.master = rpc.RpcClient(master_address, MASTER_SERVICE,
                                    timeout=10.0)
        self._hb_misses = 0
        # the address other processes can dial THIS worker at (the
        # master's GetMetrics aggregation uses it).  localhost is right
        # for single-host clusters and tests; multi-host deployments
        # pass the pod/host DNS name
        self.advertise_address = \
            f"{advertise_host or 'localhost'}:{self.port}"
        # the port this worker's gang runner would serve the gang's
        # TCPStore at if elected member 0: reserved by a
        # bind-and-release probe (the runner child binds it for real),
        # advertised at registration so the master can mint rendezvous
        # roles.  Empty when gang mode is disabled.
        self._gang_address = ""
        if _gang.enabled():
            import socket as _socket
            with _socket.socket() as _s:
                _s.bind(("0.0.0.0", 0))
                gport = _s.getsockname()[1]
            self._gang_address = \
                f"{advertise_host or 'localhost'}:{gport}"
        reg = self.master.call("RegisterWorker",
                               address=self.advertise_address,
                               gang_address=self._gang_address)
        if reg.get("worker_id") is None:
            # a FENCED (superseded) master answers an error reply:
            # fail startup loudly instead of KeyError-ing — this
            # worker is pointed at the wrong master instance
            raise ScannerException(
                "master refused worker registration: "
                f"{reg.get('error', reg)}")
        self.worker_id = reg["worker_id"]
        self.tracer.node = f"worker{self.worker_id}"
        self.executor.tracer = self.tracer
        _wlog.info("worker %d registered with master %s (port %d)",
                   self.worker_id, master_address, self.port)
        # sharded control plane: resolve the shard map from the seed
        # master and register with every OTHER shard too (each hands
        # out its own worker id).  The legacy fields (self.master /
        # worker_id / _gen / _hb_reply) become an alias for whichever
        # link currently owns this worker's active work — the whole
        # pull/report plumbing speaks through them unchanged.
        self._links: Dict[int, _ShardLink] = {}
        self._active_shard: Optional[int] = None
        self._map = _shardmap.MapHolder()
        self._map_beat = 0
        self._fin_lock = threading.Lock()
        self._fin_items: List[Tuple[int, dict]] = []
        if _shardmap.num_shards() > 1:
            smap_reply = self.master.try_call("GetShardMap",
                                              timeout=PING_TIMEOUT)
            if smap_reply and int(smap_reply.get("num_shards", 1)) > 1 \
                    and smap_reply.get("shards"):
                seed_sid = int(smap_reply.get("shard_id", 0))
                seed = _ShardLink(seed_sid, master_address)
                seed.client.close()
                seed.client = self.master
                seed.worker_id = self.worker_id
                seed.gen = self._gen
                self._links[seed_sid] = seed
                self._active_shard = seed_sid
                self._map.observe(_shardmap.ShardMap(
                    epoch=int(smap_reply.get("epoch", 0)),
                    shards={int(k): v for k, v
                            in smap_reply["shards"].items()},
                    num_shards=int(smap_reply["num_shards"])))
                self._sync_links()
                # completion batcher: pooled FinishedWork flush
                # (FinishedWorkBatch — one journal group-commit per
                # flush on the master; see _queue_finished)
                threading.Thread(target=self._fin_flush_loop,
                                 name="worker-finbatch",
                                 daemon=True).start()
        # cached per-bulk state.  The cache key is (shard, bulk_id):
        # every shard mints its own bulk ids, so bulk 1 on shard 0 and
        # bulk 1 on shard 2 are different jobs — a bare-id cache would
        # silently reuse the wrong spec after a shard switch
        self._bulk_id: Optional[int] = None
        self._bulk_key: Optional[Tuple[Optional[int], int]] = None
        self.pipeline = WorkerPipeline(self.executor, self.device,
                                       pipeline_instances)
        # gang mode (PerfParams.gang_hosts on the active bulk): the
        # raw spec blob travels to member runner children verbatim
        self._gang_hosts = 0
        self._spec_raw: Optional[bytes] = None
        self._task_timeout = 0.0
        self._posted_profiles: set = set()
        # heartbeat runs on its own thread so a long task never makes the
        # master think this worker died (stale-worker scan).  The
        # receive timestamp lets gang liveness judgments require a
        # beat FRESHER than the gang's formation — a stale reply must
        # read as "unknown", never as "aborted".
        self._hb_reply: dict = {}
        self._hb_reply_at = 0.0
        # clock-offset estimator vs the master (util/clocksync.py):
        # fed by the four-timestamp exchange riding every heartbeat;
        # the converged estimate is advertised on the next beat and
        # stamped onto every span batch this worker ships
        self._clock = _clocksync.OffsetEstimator()
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, name="worker-hb", daemon=True)
        self._hb_thread.start()
        self._work_thread = threading.Thread(
            target=self._work_loop, name="worker-loop", daemon=True)
        self._work_thread.start()

    def _heartbeat_loop(self) -> None:
        while not self._shutdown.is_set():
            # spot-reclaim notice check: the worker.preempt chaos site
            # models the cloud metadata server announcing preemption —
            # a raise here IS the notice (routine drain + heartbeat
            # advertisement), distinct from worker.heartbeat below
            # which drops the beat itself
            try:
                if _faults.ACTIVE:
                    _faults.inject("worker.preempt",
                                   detail=str(self.worker_id))
            except Exception:  # noqa: BLE001 — the injected reclaim
                self.preempt("injected spot reclaim")
            try:
                if _faults.ACTIVE:
                    _faults.inject("worker.heartbeat",
                                   detail=str(self.worker_id))
            except Exception:  # noqa: BLE001 — injected fault: this
                time.sleep(PING_INTERVAL)  # beat is dropped, loop lives
                continue
            if self._links:
                # sharded control plane: one beat per (worker, shard)
                # period — the full payload goes to the shard owning
                # this worker's active work, every other shard gets a
                # slim liveness-only beat (see Master._rpc_heartbeat)
                self._beat_shards()
                time.sleep(PING_INTERVAL)
                continue
            # short per-call deadline (PING_TIMEOUT, ~2x the ping
            # period) instead of the 30s client default: a hung master
            # must cost one missed beat, not pin this thread long
            # enough for the stale scan to remove a healthy worker
            try:
                firing = _health.firing_rules()
            except Exception:  # noqa: BLE001 — liveness > health detail
                firing = []
            # the NTP exchange rides the beat: t0 just before send, the
            # master echoes it back with its t1/t2 stamps, t3 below on
            # receipt.  The current estimate is advertised too, so the
            # master publishes the offset gauges and seeds trace rebase.
            hb_kwargs = {}
            if _clocksync.enabled():
                hb_kwargs["t0"] = time.time()
                est = self._clock.estimate()
                if est is not None:
                    hb_kwargs["clock"] = est
            hb = self.master.try_call("Heartbeat", worker_id=self.worker_id,
                                      timeout=PING_TIMEOUT,
                                      preempting=self._preempting,
                                      firing=firing, **hb_kwargs)
            if hb is not None and "t1" in hb and "t0" in hb_kwargs:
                self._clock.add_sample(hb["t0"], hb["t1"], hb["t2"],
                                       time.time())
            if hb is None:
                # ride a master restart out for real: a channel whose
                # peer died mid-dial can wedge past the peer's return
                # (the wait_for_server fresh-channel note) — after 5
                # consecutive missed beats, redial on a FRESH channel
                # so failover to a successor master actually completes
                self._hb_misses += 1
                if self._hb_misses % 5 == 0 \
                        and not self._shutdown.is_set():
                    _wlog.warning(
                        "worker %d: %d consecutive heartbeat misses — "
                        "recreating the master channel (%s)",
                        self.worker_id, self._hb_misses,
                        self._master_address)
                    old, self.master = self.master, rpc.RpcClient(
                        self._master_address, MASTER_SERVICE,
                        timeout=10.0)
                    old.close()
            else:
                self._hb_misses = 0
            if hb is not None and not self._gen.observe(hb):
                # a stale master's view of the cluster: ignore it (its
                # reregister/active_bulk verdicts are not authoritative)
                time.sleep(PING_INTERVAL)
                continue
            if hb is not None:
                if hb.get("reregister"):
                    # don't rejoin a cluster we are leaving
                    if not self._draining.is_set():
                        reg = self.master.try_call(
                            "RegisterWorker",
                            address=self.advertise_address,
                            gang_address=self._gang_address,
                            timeout=PING_TIMEOUT)
                        # a FENCED master answers an error reply with
                        # no worker_id: stay on the old id and keep
                        # beating until a live master answers
                        if reg and reg.get("worker_id") is not None:
                            self.worker_id = reg["worker_id"]
                else:
                    self._hb_reply = hb
                    self._hb_reply_at = time.time()
            time.sleep(PING_INTERVAL)

    # -- sharded control plane (engine/shardmap.py) --------------------

    def _sync_links(self) -> None:
        """Reconcile the per-shard links with the newest shard map:
        dial + register with shards we hold no link to, and redial a
        link whose shard re-published at a different address (a
        failover respawn elsewhere)."""
        smap = self._map.get()
        if smap is None:
            return
        for sid in smap.shard_ids():
            addr = smap.address_of(sid)
            link = self._links.get(sid)
            if link is None:
                link = _ShardLink(sid, addr)
                self._links[sid] = link
            elif link.address != addr:
                link.redial(addr)
                link.worker_id = None  # the new process mints fresh ids
            if link.worker_id is None:
                reg = link.client.try_call(
                    "RegisterWorker", address=self.advertise_address,
                    gang_address=self._gang_address,
                    timeout=PING_TIMEOUT)
                if reg and reg.get("worker_id") is not None:
                    link.gen.observe(reg)
                    link.worker_id = reg["worker_id"]
                    if sid == self._active_shard:
                        self.worker_id = link.worker_id

    def _refresh_map(self) -> None:
        """Adopt a newer shard map from whichever shard answers — a
        respawned shard's re-publish (epoch bump) re-points its link
        here even when the shard we usually ask is the dead one."""
        reply = None
        for link in list(self._links.values()):
            reply = link.client.try_call("GetShardMap",
                                         timeout=PING_TIMEOUT)
            if reply and reply.get("shards"):
                break
        if not reply or not reply.get("shards"):
            return
        smap = _shardmap.ShardMap(
            epoch=int(reply.get("epoch", 0)),
            shards={int(k): v for k, v in reply["shards"].items()},
            num_shards=int(reply.get("num_shards", 1)))
        if self._map.observe(smap):
            self._sync_links()

    def _beat_shards(self) -> None:
        """One heartbeat pass across every shard link.  Exactly one
        full beat per period — to the shard owning our active work
        (clock exchange, firing alerts, gang liveness ride it) — and
        slim liveness-only beats to the rest; the coalescing counter
        on the master records each slim beat as a saved full payload."""
        try:
            firing = _health.firing_rules()
        except Exception:  # noqa: BLE001 — liveness > health detail
            firing = []
        active = self._active_shard
        for link in list(self._links.values()):
            if link.worker_id is None:
                continue
            kwargs: dict = {"worker_id": link.worker_id,
                            "timeout": PING_TIMEOUT,
                            "preempting": self._preempting}
            if link.shard_id != active:
                kwargs["slim"] = True
            else:
                kwargs["firing"] = firing
                if _clocksync.enabled():
                    kwargs["t0"] = time.time()
                    est = self._clock.estimate()
                    if est is not None:
                        kwargs["clock"] = est
            hb = link.client.try_call("Heartbeat", **kwargs)
            if hb is not None and "t1" in hb and "t0" in kwargs:
                self._clock.add_sample(kwargs["t0"], hb["t1"],
                                       hb["t2"], time.time())
            if hb is None:
                # same redial discipline as the single-master loop: 5
                # consecutive misses = assume a wedged channel; the
                # map refresh below re-points the address if the
                # shard's respawn re-published elsewhere
                link.hb_misses += 1
                if link.hb_misses % 5 == 0 \
                        and not self._shutdown.is_set():
                    _wlog.warning(
                        "worker: %d heartbeat misses on shard %d — "
                        "redialing %s", link.hb_misses, link.shard_id,
                        link.address)
                    link.redial()
                continue
            link.hb_misses = 0
            if not link.gen.observe(hb):
                continue  # a superseded shard master's verdicts
            if hb.get("reregister"):
                if not self._draining.is_set():
                    reg = link.client.try_call(
                        "RegisterWorker",
                        address=self.advertise_address,
                        gang_address=self._gang_address,
                        timeout=PING_TIMEOUT)
                    if reg and reg.get("worker_id") is not None:
                        link.worker_id = reg["worker_id"]
                        if link.shard_id == active:
                            self.worker_id = link.worker_id
            else:
                link.hb_reply = hb
                link.hb_reply_at = time.time()
                if link.shard_id == active:
                    self._hb_reply = hb
                    self._hb_reply_at = link.hb_reply_at
        self._map_beat += 1
        smap = self._map.get()
        if self._map_beat % 5 == 0 or (
                smap is not None
                and len(self._links) < smap.num_shards):
            self._refresh_map()

    def _bind_link(self, link: _ShardLink) -> None:
        """Point the legacy single-master fields at one shard's link;
        the pull/report plumbing (_pull_loop, _gang_loop, span/profile
        ships) all speak through self.master / self.worker_id and so
        work unchanged against whichever shard owns the active bulk."""
        self._active_shard = link.shard_id
        self._master_address = link.address
        self.master = link.client
        self.worker_id = link.worker_id
        self._gen = link.gen
        self._hb_reply = link.hb_reply
        self._hb_reply_at = link.hb_reply_at

    def _switch_active_link(self) -> None:
        """Between bulks: re-point the pull plumbing at whichever
        shard currently has work for this worker.  _work_loop only
        calls this while no pull loop runs, so the rebind never races
        an in-flight bulk."""
        cur = self._links.get(self._active_shard) \
            if self._active_shard is not None else None
        if cur is not None \
                and cur.hb_reply.get("active_bulk") is not None:
            return
        for link in self._links.values():
            if link.worker_id is None:
                continue
            if link.hb_reply.get("active_bulk") is not None:
                _wlog.info(
                    "worker: switching to shard %d (bulk %s, worker "
                    "id %d there)", link.shard_id,
                    link.hb_reply.get("active_bulk"), link.worker_id)
                self._bind_link(link)
                return

    def _queue_finished(self, bulk_id: int, item: dict) -> None:
        """Pool a completion for the next FinishedWorkBatch flush
        (sharded mode): the master journals the whole batch in ONE
        group-commit before acking, so pooling trades ≤
        FINISHED_BATCH_WINDOW_S of progress-view lag for an RPC (and
        fsync) per task.  An unflushed completion lost with the
        process re-queues via the ordinary assignment timeout — the
        same contract as a lost FinishedWork RPC."""
        with self._fin_lock:
            self._fin_items.append((bulk_id, item))

    def _fin_flush_loop(self) -> None:
        while not self._shutdown.is_set():
            time.sleep(FINISHED_BATCH_WINDOW_S)
            try:
                self._flush_finished()
            except Exception:  # noqa: BLE001 — keep the flusher alive
                _wlog.exception("finished-work batch flush failed")
        self._flush_finished()  # final drain on shutdown

    def _flush_finished(self) -> None:
        with self._fin_lock:
            items, self._fin_items = self._fin_items, []
        if not items:
            return
        by_bulk: Dict[int, List[dict]] = {}
        for b, item in items:
            by_bulk.setdefault(b, []).append(item)
        for b, its in by_bulk.items():
            if len(its) == 1:
                self.master.try_call(
                    "FinishedWork", bulk_id=b,
                    worker_id=self.worker_id, **its[0])
            else:
                self.master.try_call(
                    "FinishedWorkBatch", bulk_id=b,
                    worker_id=self.worker_id,
                    clock=self._clock.estimate(), items=its)

    def _rpc_shutdown(self, req: dict) -> dict:
        self._shutdown.set()
        return {"ok": True}

    def drain(self) -> None:
        """Begin SIGTERM drain: the pull loop stops taking new tasks,
        in-flight tasks run to completion (and report FinishedWork),
        then the worker deregisters and shuts down.  Size the pod's
        terminationGracePeriod to cover the longest task."""
        if self._draining.is_set():
            return
        _wlog.info("worker %d: drain requested (SIGTERM) — finishing "
                   "in-flight tasks, no new pulls", self.worker_id)
        self._draining.set()

    def draining(self) -> bool:
        return self._draining.is_set()

    def preempt(self, reason: str = "spot reclaim") -> None:
        """Preemption-as-routine: a reclaim notice starts an ordinary
        drain (finish in-flight, stop pulling, deregister) AND
        advertises itself on every remaining heartbeat so the master
        fences assignment immediately — anything this worker cannot
        finish inside the reclaim window requeues strike-free via the
        normal drain/stale paths.  Idempotent."""
        if self._preempting:
            return
        self._preempting = True
        _M_PREEMPTIONS.inc()
        _wlog.warning("worker %d: preemption notice (%s) — fencing via "
                      "heartbeat, draining in-flight tasks",
                      self.worker_id, reason)
        self.drain()

    def preempting(self) -> bool:
        return self._preempting

    def _finish_drain(self) -> None:
        """In-flight work is done: leave the cluster cleanly.  The
        explicit UnregisterWorker makes the master requeue-check and
        deactivate immediately instead of burning WORKER_STALE_AFTER
        on the stale scan."""
        if self._links:
            self._flush_finished()  # pooled completions leave first
            for link in self._links.values():
                if link.worker_id is not None:
                    link.client.try_call("UnregisterWorker",
                                         worker_id=link.worker_id,
                                         timeout=PING_TIMEOUT)
        else:
            self.master.try_call("UnregisterWorker",
                                 worker_id=self.worker_id,
                                 timeout=PING_TIMEOUT)
        _wlog.info("worker %d: drain complete, deregistered",
                   self.worker_id)
        self._shutdown.set()

    def _statusz(self) -> dict:
        # getattr guards: the endpoint is live before __init__ finishes
        ex = getattr(self, "executor", None)
        master = getattr(self, "master", None)
        return {
            "role": "worker",
            "worker_id": getattr(self, "worker_id", None),
            "master": master.address if master else None,
            "master_generation": self._gen.highest(),
            "draining": self._draining.is_set(),
            "preempting": self._preempting,
            "bulk_id": getattr(self, "_bulk_id", None),
            # gang mode (engine/gang.py): the active bulk's requested
            # gang size and the coordinator address this worker
            # advertises for member-0 election
            "gang_hosts": getattr(self, "_gang_hosts", 0),
            "gang_address": getattr(self, "_gang_address", ""),
            "pipeline_instances": ex.pipeline_instances if ex else None,
            "num_load_workers": ex.num_load_workers if ex else None,
            "num_save_workers": ex.num_save_workers if ex else None,
            # the Health panel: roll-up + firing alerts (util/health.py)
            "health": _health.status_dict(),
            # the Memory panel: per-device memory + allocation-ledger view
            "memory": _memstats.status_dict(),
            # the Frame-cache panel: page pool occupancy + hit rates
            "framecache": _framecache.status_dict(),
            # the Efficiency panel: per-op roofline + compile ledger
            "efficiency": _coststats.status_dict(),
            # the Remediation panel: playbooks bound in THIS process
            # (frame-cache shrink, ladder re-warm) + audit tail
            "remediation": _controller.status_dict(),
        }

    # ------------------------------------------------------------------

    def _work_loop(self) -> None:
        while not self._shutdown.is_set():
            if self._draining.is_set():
                # _pull_loop (if any was running) returned after its
                # in-flight tasks finished: deregister and stop
                self._finish_drain()
                break
            if self._links:
                self._switch_active_link()
            bulk_id = self._hb_reply.get("active_bulk")
            if bulk_id is None:
                time.sleep(PING_INTERVAL / 4)
                continue
            try:
                self._ensure_bulk(bulk_id)
                if self._gang_hosts > 0 and _gang.enabled():
                    # gang mode: the bulk's tasks are co-scheduled
                    # member runs, not independent pipeline pulls
                    self._gang_loop(bulk_id)
                else:
                    self._pull_loop(bulk_id)
            except Exception:  # noqa: BLE001
                # a pipeline-level failure (e.g. evaluator construction)
                # must not kill this thread while the heartbeat keeps the
                # worker looking alive — back off and retry
                _wlog.exception("worker %d: pipeline failure in bulk %d",
                                self.worker_id, bulk_id)
                time.sleep(PING_INTERVAL)
                continue
            self._post_profile(bulk_id)
            # the master may report the bulk active for up to one ping
            # after its last task: don't respin the whole pipeline
            # (threads + NextWork RPCs) in a tight loop meanwhile
            time.sleep(PING_INTERVAL / 4)

    def _ship_spans(self, bulk_id: int) -> None:
        """Drain this worker's completed trace spans and ship them to
        the master in one ShipSpans batch — the out-of-band path
        (failed attempts, the final flush); completion spans piggyback
        on FinishedWork instead.  Best-effort: a failed ship loses
        those spans from the assembled trace (the flight recorder
        still holds them locally), never the task."""
        spans = self.tracer.drain_export()
        if spans:
            self.master.try_call("ShipSpans", bulk_id=bulk_id,
                                 worker_id=self.worker_id, spans=spans,
                                 clock=self._clock.estimate())

    def _ship_memory_report(self) -> None:
        """Push the newest unshipped OOM memory report (if any) to the
        master — best-effort, like span shipping: the local log and
        flight recorder still hold the forensics if the RPC fails."""
        report = _memstats.take_unshipped_report()
        if report is None:
            return
        self.master.try_call("ShipMemoryReport",
                             worker_id=self.worker_id, report=report)

    def _post_profile(self, bulk_id: int) -> None:
        """Ship this worker's profile to the master once per bulk job
        (reference: worker profile files, worker.cpp:2067-2138)."""
        if (self._active_shard, bulk_id) in self._posted_profiles:
            return
        self._posted_profiles.add((self._active_shard, bulk_id))
        # final span flush: whatever the per-task ships didn't cover
        # (e.g. spans of tasks that failed mid-pipeline)
        self._ship_spans(bulk_id)
        self._ship_memory_report()
        # serialize the card's timeline INTO the profile before it
        # crosses hosts: the trace *file* path is meaningless on the
        # master's filesystem (util/torchprof.py)
        from ..util.torchprof import embed_device_events
        for rec in self.profiler.device_traces:
            try:
                embed_device_events(rec)
            except Exception:  # noqa: BLE001 — profile > device detail
                _wlog.exception("embedding device trace events failed")
        self.master.try_call("PostProfile", bulk_id=bulk_id,
                             profile=self.profiler.to_dict())

    def _ensure_bulk(self, bulk_id: int) -> None:
        if self._bulk_key == (self._active_shard, bulk_id):
            return
        raw = self.master.call("GetJob", bulk_id=bulk_id)["spec"]
        spec = cloudpickle.loads(raw)
        # master created tables after our metadata cache was filled
        self.db.refresh_meta()
        perf = spec["perf"]
        # gang mode latch + the verbatim spec blob member runner
        # children re-derive the job from (engine/gang.py)
        self._spec_raw = raw
        self._gang_hosts = int(getattr(perf, "gang_hosts", 0) or 0)
        self._task_timeout = float(getattr(perf, "task_timeout", 0.0)
                                   or 0.0)
        # fresh profiler per bulk so PostProfile ships only this job's spans
        self.profiler = Profiler(
            node=f"worker{self.worker_id}",
            level=int(getattr(perf, "profiler_level", 1)))
        self.pipeline.join(spec["outputs"], perf, self.profiler)
        self._bulk_id = bulk_id
        self._bulk_key = (self._active_shard, bulk_id)
        _wlog.info("worker %d joined bulk %d: %d jobs, pipeline=%d",
                   self.worker_id, bulk_id, len(self.pipeline.jobs),
                   self.executor.pipeline_instances)

    def _pull_next(self, bulk_id: int):
        """Ask the master for one task; returns TaskItem, 'wait', None
        (bulk over), or ('task_error', j, t, exc)."""
        if self._draining.is_set():
            return None  # drain: stop pulling, let the pipeline empty
        if self._hb_reply.get("active_bulk") != bulk_id:
            return None
        # the window covers the load+evaluate stages only: save-parked
        # tasks are released from the master's held-count by the EvalDone
        # RPC, so lagging savers can't throttle the evaluators while a
        # small window still spreads small jobs across workers
        window = (self.executor.pipeline_instances
                  + self.executor.num_load_workers)
        reply = self.master.try_call("NextWork", worker_id=self.worker_id,
                                     bulk_id=bulk_id, window=window)
        if reply is not None and not self._gen.observe(reply):
            # stale-generation assignment: NACK — never run work a
            # superseded master handed out (the live master owns the
            # task queue; a double-assignment would race its attempt)
            return "wait"
        if reply is None or reply.get("status") is None \
                or reply["status"] in ("none", "done"):
            return None
        if reply["status"] == "wait":
            return "wait"
        j, t = reply["job_idx"], reply["task_idx"]
        attempt = reply.get("attempt", 0)
        try:
            job = self.pipeline.jobs[j]
            ti = TaskItem(job, t, job.tasks[t], attempt=attempt)
            # the master's assign-span context: this task's span (and
            # everything under it) chains into the job's trace
            ti.trace_ctx = _tracing.parse_traceparent(
                reply.get("traceparent"))
            return ti
        except Exception as e:  # noqa: BLE001  (job-list skew etc.)
            return ("task_error", j, t, attempt, e)

    def _pull_loop(self, bulk_id: int) -> None:
        """Drive the full multi-stage pipeline from the master's queue:
        N loaders pull+decode concurrently (decode releases the GIL), P
        evaluator instances execute, S savers persist — the reference
        worker's per-node stage threads (worker.cpp:1467-1724, 1876-1890).
        The worker keeps up to (loaders + queue depths + P) tasks in
        flight; the master's timeout clock restarts per task at
        StartedWork."""

        def source():
            if self._shutdown.is_set():
                return None
            nxt = self._pull_next(bulk_id)
            if isinstance(nxt, tuple) and nxt[0] == "task_error":
                _tag, j, t, attempt, exc = nxt
                _wlog.error("worker %d: task (%d,%d) unresolvable",
                            self.worker_id, j, t, exc_info=exc)
                self.master.try_call(
                    "FailedWork", bulk_id=bulk_id,
                    worker_id=self.worker_id, job_idx=j, task_idx=t,
                    attempt=attempt,
                    transient=_is_transient_failure(exc),
                    error=f"{type(exc).__name__}: {exc}")
                return "wait"
            return nxt

        def on_start(w) -> bool:
            # restart the master's timeout clock: evaluation of this
            # prefetched task starts now.  A revoked reply means this
            # attempt timed out in our queue and was re-assigned — drop it
            # rather than evaluate/save a stale attempt concurrently with
            # its replacement (reference stop_job_on_worker,
            # master.cpp:2111)
            reply = self.master.try_call(
                "StartedWork", bulk_id=bulk_id, worker_id=self.worker_id,
                job_idx=w.job.job_idx, task_idx=w.task_idx,
                attempt=w.attempt)
            if reply is not None and not self._gen.observe(reply):
                # a stale master's revocation verdict is not
                # authoritative: NACK it and keep the attempt running
                # (the live master still holds the assignment)
                return True
            return reply is None or bool(reply.get("ok"))

        def on_eval_done(w) -> None:
            # hand-off to the save stage: release this task from the
            # NextWork window so parked saves don't starve the evaluators
            self.master.try_call(
                "EvalDone", bulk_id=bulk_id, worker_id=self.worker_id,
                job_idx=w.job.job_idx, task_idx=w.task_idx,
                attempt=w.attempt)

        def on_done(w) -> None:
            # this task's span chain piggybacks ON FinishedWork (the
            # task span closed before on_done fired): the master holds
            # the full chain the moment the completion — which can
            # finish the bulk — lands, with no second per-task RPC
            item = dict(job_idx=w.job.job_idx, task_idx=w.task_idx,
                        attempt=w.attempt,
                        spans=self.tracer.drain_export(),
                        clock=self._clock.estimate())
            if self._links:
                # sharded mode: pool for the FinishedWorkBatch flush
                self._queue_finished(bulk_id, item)
            else:
                self.master.try_call(
                    "FinishedWork", bulk_id=bulk_id,
                    worker_id=self.worker_id, **item)

        def on_task_error(w, exc) -> bool:
            _wlog.exception("worker %d: task (%d,%d) failed",
                            self.worker_id, w.job.job_idx, w.task_idx,
                            exc_info=exc)
            self._ship_spans(bulk_id)  # the error span chain ships too
            # an OOM-failed task generated a memory report: ship it now
            # so the master holds the forensics before the requeue
            self._ship_memory_report()
            self.master.try_call(
                "FailedWork", bulk_id=bulk_id, worker_id=self.worker_id,
                job_idx=w.job.job_idx, task_idx=w.task_idx,
                attempt=w.attempt,
                # storage/RPC failures requeue strike-free on the master
                transient=_is_transient_failure(exc),
                error=f"{type(exc).__name__}: {exc}")
            return True  # keep the pipeline running

        self.pipeline.run(source, on_start=on_start, on_done=on_done,
                          on_eval_done=on_eval_done,
                          on_task_error=on_task_error)

    # -- gang member path (engine/gang.py) ---------------------------------

    def _next_gang(self, bulk_id: int):
        """One gang-mode NextWork pull: a role reply dict, "wait", or
        None (bulk over / draining).  A reply stamped by a stale master
        generation is NACKed exactly like an ordinary assignment — a
        superseded master must not be able to convene a gang."""
        if self._draining.is_set():
            return None
        if self._hb_reply.get("active_bulk") != bulk_id:
            return None
        reply = self.master.try_call("NextWork",
                                     worker_id=self.worker_id,
                                     bulk_id=bulk_id, window=0)
        if reply is not None and not self._gen.observe(reply):
            return "wait"
        if reply is None or reply.get("status") in (None, "none",
                                                    "done"):
            return None
        if reply["status"] == "wait":
            return "wait"
        return reply

    def _gang_loop(self, bulk_id: int) -> None:
        """Drive gang member runs from the master's formation pool:
        pull a role, run the member to completion in its own child
        process, report, repeat.  One member at a time per worker —
        a gang IS this node's unit of work."""
        while not self._shutdown.is_set():
            nxt = self._next_gang(bulk_id)
            if nxt is None:
                return
            if nxt == "wait":
                time.sleep(PING_INTERVAL / 4)
                continue
            try:
                self._run_gang_member(bulk_id, nxt)
            except Exception:  # noqa: BLE001 — a reporting failure
                # must not kill the loop while the heartbeat keeps
                # this worker looking alive
                _wlog.exception("worker %d: gang member run failed",
                                self.worker_id)
                time.sleep(PING_INTERVAL)

    def _run_gang_member(self, bulk_id: int, role: dict) -> None:
        gid, epoch = role["gang_id"], role["epoch"]
        pid = int(role["process_id"])
        task_timeout = float(role.get("task_timeout")
                             or self._task_timeout or 0.0)
        request = {
            "db_path": self._db_path,
            "storage_type": self._storage_type,
            "spec": self._spec_raw, "bulk_id": bulk_id,
            "job_idx": role["job_idx"], "task_idx": role["task_idx"],
            "attempt": role.get("attempt", 0),
            "gang_id": gid, "epoch": epoch,
            "process_id": pid,
            "num_processes": int(role["num_processes"]),
            "coordinator": role["coordinator"],
            "init_timeout": _gang.init_timeout_s(),
            "task_timeout": task_timeout,
            # evaluation mode is the MASTER's call, read off the role
            # reply verbatim — never this worker's local config
            "sharded": bool(role.get("sharded")),
            "halo": bool(role.get("halo", True)),
            "traceparent": role.get("traceparent"),
            "node": f"worker{self.worker_id}",
            # the member evaluates on this worker's own device
            "device": str(self.device),
        }
        _wlog.info(
            "worker %d: gang %d epoch %d — member %d/%d for task "
            "(%d,%d), coordinator %s", self.worker_id, gid, epoch, pid,
            request["num_processes"], role["job_idx"],
            role["task_idx"], role["coordinator"])
        t_form = time.time()

        def gang_alive() -> bool:
            # heartbeat-fed gang liveness: only a beat provably SENT
            # after the formation may testify — its receive time must
            # clear t_form by the beat's own deadline (PING_TIMEOUT),
            # so a reply that was in flight when the gang formed (or a
            # stale reply held across a master hiccup) reads as
            # "unknown" and never reaps a healthy runner.  A fresh
            # beat whose per-worker gang list lacks this gang means it
            # was aborted underneath us — reap now instead of blocking
            # in a dead collective until the member timeout.
            if self._hb_reply_at <= t_form + PING_TIMEOUT:
                return True
            hb = self._hb_reply
            if "gangs" not in hb:
                return True  # legacy master: no liveness feed
            return gid in (hb.get("gangs") or ())

        res = _gang.spawn_member(
            request, timeout=_gang.member_timeout_s(task_timeout),
            alive=gang_alive)
        # the member child's phase seconds fold into THIS process's
        # metrics registry (the child's registry is never scraped);
        # sharded data-plane stats (shard rows, decode rows, halo
        # bytes) fold the same way
        _gang.count_phases(res.get("phases"), res.get("role"))
        _gang.count_shard_stats(res.get("shard"), res.get("role"))
        # the child's kernel launches were made for this worker's task
        _gang.fold_kernel_counts(res.get("cuda_ops"))
        # the member's spans (task under the gang root, stages, ops)
        # came back in the result file — ship them so the gang's whole
        # story assembles under one trace on the master.  The batch
        # carries this worker's clock estimate: the child shares this
        # host's clock, so its spans rebase with the same offset.
        spans = list(res.get("spans") or ()) + self.tracer.drain_export()
        if spans:
            self.master.try_call("ShipSpans", bulk_id=bulk_id,
                                 worker_id=self.worker_id, spans=spans,
                                 clock=self._clock.estimate())
        base = dict(bulk_id=bulk_id, worker_id=self.worker_id,
                    job_idx=role["job_idx"],
                    task_idx=role["task_idx"],
                    attempt=role.get("attempt", 0),
                    gang_id=gid, epoch=epoch)
        if res.get("ok"):
            # single-writer completion: member 0 carries the gang's
            # FinishedWork — with the collective digest total and the
            # per-member shard digests it assembled from (sharded runs)
            # for the master's shard commit fold; everyone else acks,
            # the ack extended to carry its own shard digest
            if pid == 0:
                reply = self.master.try_call(
                    "FinishedWork", **base,
                    digest=res.get("digest"),
                    shard_digests=res.get("shard_digests"))
            else:
                reply = self.master.try_call(
                    "GangMemberDone", **base,
                    shard_digest=res.get("shard_digest"))
            if reply is not None and self._gen.observe(reply) \
                    and reply.get("gang_stale"):
                _wlog.warning(
                    "worker %d: gang %d epoch %d completion NACKed as "
                    "stale — the gang re-formed underneath this "
                    "member", self.worker_id, gid, epoch)
        else:
            _wlog.warning(
                "worker %d: gang %d epoch %d member %d failed at %s: "
                "%s", self.worker_id, gid, epoch, pid,
                res.get("stage"), res.get("error"))
            self.master.try_call(
                "GangFailed", **base,
                stage=res.get("stage", "member"),
                transient=bool(res.get("transient", True)),
                error=str(res.get("error", "")))

    def wait_for_shutdown(self) -> None:
        while not self._shutdown.is_set():
            time.sleep(0.2)
        self.stop()

    def stop(self) -> None:
        self._shutdown.set()
        self._server.stop()
        if self.metrics_server is not None:
            self.metrics_server.stop()
            self.metrics_server = None
        self.pipeline.close()
        if self._links:
            for link in self._links.values():
                link.close()  # the active link IS self.master
            self._links = {}
        else:
            self.master.close()
        if self.coordinator is not None:
            _distributed.shutdown()


# ---------------------------------------------------------------------------
# Client side
# ---------------------------------------------------------------------------

class ClusterClient:
    """Submits bulk jobs to a master and polls progress
    (reference Client.run gRPC path + _start_heartbeat, client.py:324).

    Against a sharded control plane the given address is just the SEED:
    the client resolves the versioned shard map from it (GetShardMap,
    lazily, cached), routes each admission to the shard the token
    hashes to — stamping the map's epoch so a stale map is NACKed
    instead of silently routing past a failover — and fans
    metrics/health/status reads in across every shard."""

    def __init__(self, master_address: str, db: Database,
                 enable_watchdog: bool = False, poll_interval: float = 0.25,
                 master_down_timeout: float = 120.0, **_kw):
        self.db = db
        self._master_address = master_address
        self.master = rpc.RpcClient(master_address, MASTER_SERVICE)
        self.poll_interval = poll_interval
        self._last_refresh = time.time()
        # sharded control plane: the resolved map (None = unsharded,
        # the overwhelmingly common case), per-shard channels keyed by
        # shard id, and the shard the last run() admitted to (its
        # GetJobStatus poll goes there, as does Client.trace's pull)
        self._smap: Optional[_shardmap.ShardMap] = None
        self._smap_resolved = False
        self._shard_clients: Dict[int, rpc.RpcClient] = {}
        self._last_shard: Optional[int] = None
        # how long GetJobStatus may fail continuously before the client
        # gives up — long enough to ride out a master restart (it recovers
        # the bulk from its checkpoint), short enough that a dead master
        # raises instead of hanging the caller forever
        self.master_down_timeout = master_down_timeout
        # bulk id of the most recent run() (Client.trace maps its job id
        # to the master-side bulk through this), and the admission
        # token it was admitted under (NewJob dedupe across retries
        # and master restarts)
        self.last_bulk_id: Optional[int] = None
        self.last_admission_token: Optional[str] = None
        self._watchdog_stop = threading.Event()
        if enable_watchdog:
            t = threading.Thread(target=self._poke_loop, daemon=True)
            t.start()

    def _poke_loop(self) -> None:
        while not self._watchdog_stop.is_set():
            self.master.try_call("PokeWatchdog")
            time.sleep(5.0)

    def _refresh_channel(self) -> None:
        """Replace the master channel with a freshly dialed one (other
        threads pick the new client up on their next call; in-flight
        calls on the closed channel surface as transport failures
        try_call already tolerates)."""
        self._last_refresh = time.time()
        old, self.master = self.master, rpc.RpcClient(
            self._master_address, MASTER_SERVICE)
        old.close()

    # -- sharded control plane (engine/shardmap.py) --------------------

    def _resolve_shard_map(self, force: bool = False) \
            -> Optional[_shardmap.ShardMap]:
        """The cluster's shard map, or None (unsharded).  Resolved
        lazily via GetShardMap — every shard serves it; an unsharded
        master answers num_shards=1, which caches as None — and
        re-resolved on force (a stale-map NACK, a wedged shard)."""
        if self._smap_resolved and not force:
            return self._smap
        reply = self.master.try_call("GetShardMap", timeout=5.0)
        if reply is None and self._smap is not None:
            # the seed shard may be the dead one: any shard serves
            # the map, so ask the rest before giving up
            for sid in self._smap.shard_ids():
                c = self._shard_clients.get(sid)
                if c is None:
                    continue
                reply = c.try_call("GetShardMap", timeout=5.0)
                if reply:
                    break
        if reply is None:
            return self._smap  # unreachable: keep what we have
        self._smap_resolved = True
        if int(reply.get("num_shards", 1) or 1) <= 1 \
                or not reply.get("shards"):
            self._smap = None
        else:
            smap = _shardmap.ShardMap(
                epoch=int(reply.get("epoch", 0)),
                shards={int(k): v
                        for k, v in reply["shards"].items()},
                num_shards=int(reply["num_shards"]))
            if self._smap is None or smap.epoch >= self._smap.epoch:
                self._smap = smap
        return self._smap

    def _shard_client(self, sid: Optional[int]) -> rpc.RpcClient:
        """The channel for one shard (the seed channel doubles as its
        own shard's); dials on first use, re-dials when the map moved
        the shard's address (failover respawn)."""
        smap = self._smap
        addr = smap.address_of(sid) if (smap and sid is not None) \
            else None
        if addr is None or addr == self._master_address:
            return self.master
        c = self._shard_clients.get(sid)
        if c is None or c.address != addr:
            if c is not None:
                c.close()
            c = rpc.RpcClient(addr, MASTER_SERVICE)
            self._shard_clients[sid] = c
        return c

    def _redial_shard(self, sid: Optional[int]) -> None:
        """Fresh channel to one shard (the wedged-channel pathology —
        see _refresh_channel), re-resolving the map first so a
        failover respawn's re-published address is what gets dialed."""
        self._resolve_shard_map(force=True)
        self._last_refresh = time.time()
        if sid is None or self._smap is None:
            self._refresh_channel()
            return
        addr = self._smap.address_of(sid)
        if addr is None or addr == self._master_address:
            self._refresh_channel()
            return
        old = self._shard_clients.pop(sid, None)
        if old is not None:
            old.close()
        self._shard_clients[sid] = rpc.RpcClient(addr, MASTER_SERVICE)

    def run(self, outputs, perf: PerfParams, cache_mode: CacheMode,
            show_progress: bool) -> List[Profiler]:
        import uuid

        from ..util.retry import retry_until_deadline
        spec = cloudpickle.dumps({
            "outputs": list(outputs), "perf": perf,
            "cache_mode": cache_mode.value})
        # client-minted admission token: the master dedupes on it, so
        # NewJob becomes safe to repeat end-to-end — a retry after an
        # ambiguous timeout, or against the SUCCESSOR of a restarted
        # master (tokens ride the checkpoint/journal), returns the
        # already-admitted bulk id instead of double-running the bulk
        token = uuid.uuid4().hex
        self.last_admission_token = token
        # load shedding (admission_pause remediation playbook): a
        # paused master answers retryable instead of admitting onto a
        # backpressured cluster — back off and retry until it resumes,
        # bounded by the same deadline a dead master gets.  Transport
        # failures (a master mid-restart) ride the same deadline: the
        # token makes the repeat safe.
        admit_deadline = time.time() + self.master_down_timeout
        admit_fails = [0]
        # sharded routing: the token hashes to its owning shard, and
        # the admission carries the map epoch it routed with — a
        # master holding a newer map NACKs it (stale_map) and we
        # refresh + re-route instead of mutating past a failover
        smap = self._resolve_shard_map()
        route = {"shard": smap.shard_for(token) if smap else None}

        def _admit() -> dict:
            cli = self._shard_client(route["shard"])
            kwargs = {}
            if self._smap is not None:
                kwargs["map_epoch"] = self._smap.epoch
            try:
                return cli.call("NewJob", spec=spec, token=token,
                                timeout=120.0, **kwargs)
            except rpc.RpcError:
                # the wedged-channel pathology (see _refresh_channel):
                # a channel whose peer died mid-dial can stay stuck
                # past the successor's return — redial fresh every few
                # failed admission attempts, like the status poll does
                admit_fails[0] += 1
                if admit_fails[0] % 8 == 0:
                    if route["shard"] is not None:
                        self._redial_shard(route["shard"])
                        nm = self._smap
                        if nm is not None:
                            route["shard"] = nm.shard_for(token)
                    else:
                        self._refresh_channel()
                raise

        while True:
            reply = retry_until_deadline(
                _admit,
                is_transient=lambda e: isinstance(e, rpc.RpcError),
                deadline=admit_deadline, label="rpc:NewJob:admission")
            if reply.get("admission_paused") \
                    and time.time() < admit_deadline:
                time.sleep(float(reply.get("retry_after") or 1.0))
                continue
            if reply.get("stale_map") \
                    and time.time() < admit_deadline:
                # the map moved underneath this admission (a shard
                # failed over): refresh, re-route, re-present — the
                # token dedupes if the first attempt actually landed
                self._resolve_shard_map(force=True)
                if self._smap is not None:
                    route["shard"] = self._smap.shard_for(token)
                continue
            break
        if "error" in reply:
            raise JobException(reply["error"])
        self._last_shard = route["shard"]
        poll = self._shard_client(route["shard"])
        bulk_id = reply["bulk_id"]
        self.last_bulk_id = bulk_id
        last_ok = time.time()
        retoken_tried = False
        while True:
            # try_call: a master restarting mid-bulk (it recovers the job
            # from its checkpoint) must look like slow progress, not a
            # client-visible failure — but a master that stays dead past
            # master_down_timeout raises instead of hanging forever.
            # Sharded: the poll goes to the ADMITTING shard — re-looked
            # up each pass, so a redial's fresh channel is picked up
            poll = self._shard_client(route["shard"])
            st = poll.try_call("GetJobStatus", bulk_id=bulk_id)
            if st is None:
                now = time.time()
                if now - last_ok > self.master_down_timeout:
                    raise JobException(
                        f"master unreachable for "
                        f"{self.master_down_timeout:.0f}s while waiting "
                        f"on bulk {bulk_id}")
                if now - last_ok > 10.0 \
                        and now - self._last_refresh > 10.0:
                    # a channel whose peer died mid-dial can wedge past
                    # the restart (see rpc.wait_for_server): redial the
                    # restarted/successor master on a FRESH channel
                    if route["shard"] is not None:
                        self._redial_shard(route["shard"])
                    else:
                        self._refresh_channel()
                time.sleep(self.poll_interval)
                continue
            last_ok = time.time()
            if "tasks_done" not in st:
                # the master came back without this bulk under the id
                # we knew: re-present the admission token ONCE — a
                # successor that recovered the bulk (or renumbered it)
                # hands its id back via the dedupe path, and polling
                # resumes; only a truly lost bulk surfaces as an error
                if not retoken_tried:
                    retoken_tried = True
                    # resolve=True: a lookup-only probe — an unknown
                    # token answers unknown_token instead of admitting
                    # a fresh bulk this client would then abandon
                    reply = poll.try_call(
                        "NewJob", spec=spec, token=token, resolve=True,
                        timeout=120.0)
                    if reply and reply.get("dedup") \
                            and reply.get("bulk_id") is not None:
                        bulk_id = reply["bulk_id"]
                        self.last_bulk_id = bulk_id
                        continue
                raise JobException(st.get("error", "bulk job lost"))
            if show_progress:
                # same numbers as /statusz (GetJobStatus is the single
                # source of truth for job progress)
                fps = (st.get("stage_fps") or {}).get("save")
                eta = st.get("eta_seconds")
                extra = ""
                if fps:
                    extra += f" {fps:.0f} rows/s"
                if eta is not None:
                    extra += f" eta {eta:.0f}s"
                print(f"\rtasks {st['tasks_done']}/{st['total_tasks']} "
                      f"workers={st['num_workers']}{extra}",
                      end="", flush=True)
            if st.get("finished"):
                if show_progress:
                    print()
                self.db.refresh_meta()
                if st.get("error"):
                    raise JobException(st["error"])
                if st.get("failed_jobs"):
                    raise JobException(
                        f"jobs failed: {st['failed_jobs']}")
                # workers post profiles right after their last task; give
                # them a beat, then collect what arrived
                time.sleep(2 * self.poll_interval)
                reply = poll.try_call("GetProfiles",
                                      bulk_id=bulk_id) or {}
                return [Profiler.from_dict(d)
                        for d in reply.get("profiles", [])]
            time.sleep(self.poll_interval)

    def metrics(self) -> dict:
        """Cluster-wide merged metrics snapshot (master + every live
        worker, node-labeled) via the master's GetMetrics RPC.
        Sharded: fanned in across every shard — each shard's master
        samples relabel to shard<k>, and the worker fan-out rides ONE
        shard only (every shard sees the same fleet; pulling workers M
        times would skew the merged counters M-fold)."""
        smap = self._resolve_shard_map()
        if smap is None:
            reply = self.master.call("GetMetrics", timeout=30.0)
            return reply["snapshot"]
        sids = smap.shard_ids()
        primary = sids[0] if sids else 0
        by_node: Dict[str, dict] = {}
        for sid in sids:
            reply = self._shard_client(sid).try_call(
                "GetMetrics", timeout=30.0, workers=(sid == primary))
            if not reply or "snapshot" not in reply:
                continue  # a dead shard drops out of the merged view
            snap = reply["snapshot"]
            for entry in snap.values():
                for s in entry.get("samples", []):
                    lb = s.get("labels") or {}
                    if lb.get("node") == "master":
                        s["labels"] = dict(lb, node=f"shard{sid}")
            by_node[f"shard{sid}"] = snap
        # inner node labels (shard<k>/worker<i>) win over the outer
        # key in merge_snapshots, which is exactly what we want here
        return merge_snapshots(by_node)

    def job_status(self, bulk_id: Optional[int] = None) -> dict:
        """Progress of one bulk.  Sharded: asks the admitting shard
        first, then the rest — the bulk lives on exactly one shard."""
        smap = self._resolve_shard_map()
        if smap is None:
            return self.master.call("GetJobStatus", bulk_id=bulk_id)
        order = smap.shard_ids()
        if self._last_shard in order:
            order = [self._last_shard] + \
                [s for s in order if s != self._last_shard]
        best: Optional[dict] = None
        for sid in order:
            st = self._shard_client(sid).try_call("GetJobStatus",
                                                  bulk_id=bulk_id)
            if st and "tasks_done" in st:
                return st
            if st and best is None:
                best = st
        if best is not None:
            return best
        return self.master.call("GetJobStatus", bulk_id=bulk_id)

    def health(self) -> dict:
        """Cluster-wide health roll-up (GetHealth RPC): worst-of status
        across master + every live worker, node-prefixed reason codes,
        and each node's firing alerts.  Sharded: every shard's roll-up
        folds in (worst-of again, shard<k>-prefixed) — an unreachable
        shard reports unhealthy rather than silently vanishing."""
        smap = self._resolve_shard_map()
        if smap is None:
            return self.master.call("GetHealth", timeout=30.0)
        sids = smap.shard_ids()
        primary = sids[0] if sids else 0
        nodes: Dict[str, dict] = {}
        for sid in sids:
            reply = self._shard_client(sid).try_call(
                "GetHealth", timeout=30.0, workers=(sid == primary))
            nodes[f"shard{sid}"] = reply if reply else {
                "status": "unhealthy",
                "reasons": ["shard_unreachable"], "firing": []}
        return _health.merge_status(nodes)

    def get_trace(self, bulk_id: Optional[int] = None,
                  raw_clocks: bool = False) -> dict:
        """The master-assembled cross-host trace of a bulk: span dicts
        from every node plus the straggler summary (GetTrace RPC).
        Remote spans arrive rebased onto master time per node clock
        offset unless raw_clocks=True."""
        # sharded: the trace lives with the bulk, on the admitting shard
        return self._shard_client(self._last_shard).call(
            "GetTrace", bulk_id=bulk_id, raw_clocks=raw_clocks)

    def memory_report(self) -> dict:
        """Cluster memory forensics (GetMemoryReport RPC): the master's
        live device-memory/ledger view plus every OOM report workers
        shipped."""
        return self.master.call("GetMemoryReport")

    def compile_report(self) -> dict:
        """Cluster compile ledger + roofline table (GetCompileLedger
        RPC): per-node compile entries (kernel library builds and CUDA
        graph captures) with cache hit/miss labels
        and the per-(op, device, bucket) efficiency table."""
        return self.master.call("GetCompileLedger", timeout=30.0)

    def ship_spans(self, bulk_id: int, spans: List[dict]) -> None:
        """Contribute client-side spans (the job's root) to the
        master's assembled trace, so GetTrace dumps are self-contained
        — a scanner_trace --verify of the bulk walks every task chain
        to the root without needing this process.  Best-effort."""
        if spans:
            self._shard_client(self._last_shard).try_call(
                "ShipSpans", bulk_id=bulk_id, spans=spans)

    def shutdown_cluster(self, workers: bool = True) -> int:
        """Stop the master — and, by default, every registered worker —
        via the Shutdown RPC (the counterpart of blocking
        start_master/start_worker deployments, whose wait_for_shutdown
        loops exit on it).  Returns how many workers acknowledged.
        Sharded: every shard gets the Shutdown (workers notified once,
        through the first shard — re-notifying is harmless but slow)."""
        smap = self._resolve_shard_map()
        if smap is None:
            reply = self.master.call("Shutdown", workers=workers,
                                     timeout=30.0)
            return int(reply.get("workers_notified", 0))
        notified = 0
        notify = workers
        for sid in smap.shard_ids():
            reply = self._shard_client(sid).try_call(
                "Shutdown", workers=notify, timeout=30.0)
            if reply:
                notified += int(reply.get("workers_notified", 0))
                notify = False
        return notified

    def close(self) -> None:
        self._watchdog_stop.set()
        for c in self._shard_clients.values():
            c.close()
        self._shard_clients = {}
        self.master.close()


# ---------------------------------------------------------------------------
# Process entry points (reference scannerpy start_master/start_worker,
# client.py:1593/1651, tests/spawn_worker.py)
# ---------------------------------------------------------------------------

def start_master(db_path: str, port: int = 5000, block: bool = False,
                 **kw) -> Master:
    m = Master(db_path=db_path, port=port, **kw)
    if block:
        m.wait_for_shutdown()
    return m


def start_worker(master_address: str, db_path: str, port: int = 0,
                 block: bool = False, **kw) -> Worker:
    w = Worker(master_address, db_path=db_path, port=port, **kw)
    if block:
        # SIGTERM = drain (kubernetes pod termination, with a
        # terminationGracePeriod sized for it): finish in-flight tasks, stop
        # pulling, deregister — then wait_for_shutdown returns and the
        # process exits 0 instead of dying mid-task
        import signal

        def _sigterm(_signum, _frame):
            w.drain()

        try:
            signal.signal(signal.SIGTERM, _sigterm)
        except ValueError:
            pass  # not the main thread: the embedder owns signals
        w.wait_for_shutdown()
    return w
