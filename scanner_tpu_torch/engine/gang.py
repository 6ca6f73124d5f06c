"""Gang-scheduled multi-host execution: the member side.

The master (engine/service.py) forms a **gang** for each task of a
`gang_hosts=N` bulk: N live, non-preempting workers are co-scheduled,
minted a `(gang_id, gang_epoch)` fence, and handed rendezvous roles —
member 0's advertised gang address is where its process group's
TCPStore serves, everyone gets `(process_id, num_processes)`.  This
module is what a worker does with its role:

  * **one process per gang epoch** — the member runs in a dedicated
    child process (`python -m scanner_tpu_torch.engine.gang`), so
    joining a process group never collides with the worker's own state,
    a hung collective is bounded by the parent's member timeout instead
    of wedging the worker, and a re-formed gang at a new coordinator
    starts from a clean runtime (parallel/distributed.shutdown() covers
    the in-process case).  The child evaluates on the worker's own
    device, which the request names (`"device"`: a torch child must be
    told which card to use; two members on one host share it, each
    with its own CUDA context);
  * the child rendezvouses with a **bounded** timeout (`[gang]
    init_timeout_s`, which also bounds every collective of the group),
    then evaluates **sharded** (`[gang] sharded`, the default):
    `shard_range` splits the task's output rows over the gang, each
    member loads/decodes ONLY its contiguous shard (the loader plan is
    restricted to `[lo, hi)`; the frame cache keys pages under the
    member's shard identity), stencil boundary rows move between
    neighbor members over the group (`parallel/halo.py`, `[gang]
    halo_exchange`) instead of widening each member's decode, its shard
    digest joins one cross-process reduction over the gang mesh
    (`parallel/mesh.host_mesh`) — the collective both synchronizes the
    gang (a lost host bites HERE) and checks cross-host agreement — and
    the serialized output shards assemble over one all-gather
    (`parallel/distributed.all_gather_rows`).  `[gang] sharded=false`
    keeps the replicated evaluation (every member runs the whole task;
    only the digest is sharded);
  * **single-writer commit**: only member 0 saves sink output — on the
    sharded path after re-deriving the full-task rows from the gathered
    shards and verifying them against the collective total — and only
    after the agreement check passed; members 1..N-1 ack through the
    `GangMemberDone` RPC (extended to carry their shard digest for the
    master's shard commit fold), so sink writes are exactly-once per
    epoch;
  * the child dies with its parent (PR_SET_PDEATHSIG): killing a worker
    kills its gang runner mid-collective — the survivors' collectives
    fail or hang, their parents time the members out, and the master
    aborts + re-forms the gang at `epoch+1` on the remaining capacity
    (a smaller re-formed gang simply recomputes `shard_range` at its
    new `num_processes`).

The group's backend is "gloo", passed explicitly (`BACKEND`): every
gang collective moves host data.  Gloo binds the network interface
that holds the local IPv4 address the kernel routes to the coordinator
from (`gloo_interface`: "lo" for a loopback coordinator), unless
GLOO_SOCKET_IFNAME is already set.

Port-side fields of the member's result dict, beside the JAX package's:
`"cuda_ops"` carries the member process's launch counts of the
hand-written kernels (kernels/cuda_ops.py), which the worker folds into
its own counts as it folds `"phases"`; `"started_at"` and `"ready_at"`
are the host times the child reached its entry point and was ready to
rendezvous, from which the worker derives two more phases: `spawn`
(process start and imports) and `device` (the card's context).

Failure classification: rendezvous/collective/timeout failures are
TRANSIENT (`GangFailed(transient=True)`) — the gang re-forms with zero
blacklist strikes on the survivors; an evaluate error inside the child
is classified like any worker task failure.

Kill switch: ``SCANNER_TPU_GANG=0`` / ``[gang] enabled`` makes workers
ignore gang mode (the master still forms gangs only for bulks that ask).
See docs/robustness.md §Gang scheduling.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

from ..util import faults as _faults
from ..util import metrics as _mx
from ..util.log import get_logger

_log = get_logger("gang")

# the gang's process-group backend: every collective moves host data
BACKEND = "gloo"

# the [gang] config keys this module accepts (scanner-check SC313 keeps
# config.default_config(), this tuple and the docs/guide.md rows in
# sync, all directions)
CONFIG_KEYS = ("enabled", "init_timeout_s", "form_timeout_s",
               "sharded", "halo_exchange")


def _flag(v: Optional[str], default: bool) -> bool:
    if v is None or v == "":
        return default
    return v.strip().lower() not in ("0", "false", "no", "off")


def _env_float(name: str, default: float, floor: float) -> float:
    """Env override with the same clamp the setter applies; a
    malformed value falls back to the default (WARNING) instead of
    taking the importing process down."""
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return max(floor, float(raw))
    except ValueError:
        _log.warning("ignoring malformed %s=%r (want seconds); using "
                     "%s", name, raw, default)
        return default


_enabled = _flag(os.environ.get("SCANNER_TPU_GANG"), True)
_init_timeout_s = _env_float("SCANNER_TPU_GANG_INIT_TIMEOUT", 60.0,
                             floor=1.0)
_form_timeout_s = _env_float("SCANNER_TPU_GANG_FORM_TIMEOUT", 5.0,
                             floor=0.05)
_sharded = _flag(os.environ.get("SCANNER_TPU_GANG_SHARDED"), True)
_halo_exchange = _flag(os.environ.get("SCANNER_TPU_GANG_HALO"), True)


def enabled() -> bool:
    return _enabled


def set_enabled(on: bool) -> None:
    """Deployment default ([gang] enabled); the SCANNER_TPU_GANG env
    var is read at import and wins."""
    global _enabled
    _enabled = bool(on)


def sharded_enabled() -> bool:
    return _sharded


def set_sharded(on: bool) -> None:
    """Deployment default ([gang] sharded): mesh-partitioned gang
    evaluation — each member computes only its row shard and the output
    assembles over the interconnect.  Off = the pre-sharding replicated
    evaluation (every member computes all rows; N× redundancy, 1×
    throughput).  The SCANNER_TPU_GANG_SHARDED env var is read at
    import and wins.  The MASTER's value decides per gang (the flag
    rides the role reply), so members can never disagree mid-gang."""
    global _sharded
    _sharded = bool(on)


def halo_enabled() -> bool:
    return _halo_exchange


def set_halo(on: bool) -> None:
    """Deployment default ([gang] halo_exchange): stencil boundary rows
    move between neighbor members over the gang's process group
    (parallel/halo.py point-to-point pair) instead of each member widening its decode past the
    shard edge.  Off = members decode their halo rows locally (still
    sharded, still bit-exact — just redundant boundary decode).  The
    SCANNER_TPU_GANG_HALO env var is read at import and wins; like
    `sharded`, the master's value rides the role reply."""
    global _halo_exchange
    _halo_exchange = bool(on)


def init_timeout_s() -> float:
    return _init_timeout_s


def set_init_timeout_s(s: float) -> None:
    global _init_timeout_s
    _init_timeout_s = max(1.0, float(s))


def form_timeout_s() -> float:
    return _form_timeout_s


def set_form_timeout_s(s: float) -> None:
    global _form_timeout_s
    _form_timeout_s = max(0.05, float(s))


# gang lifecycle telemetry (docs/observability.md §Metric catalog):
# bumped by the master's formation/abort paths (engine/service.py
# imports these hooks), so the whole fleet's gang story reads off one
# scrape of the master
_M_FORMED = _mx.registry().counter(
    "scanner_tpu_gang_formed_total",
    "Gangs the master formed (a co-scheduled member set minted a fresh "
    "(gang_id, epoch) and handed rendezvous roles).")
_M_ABORTED = _mx.registry().counter(
    "scanner_tpu_gang_aborted_total",
    "Gangs aborted before completing, by reason (member_lost = "
    "stale/unregistered member, member_failed = a member reported "
    "rendezvous/collective/evaluate failure, preempted = a member "
    "advertised spot reclaim, timeout = the task timeout revoked the "
    "gang).  Each abort bumps the epoch and requeues the task for a "
    "fresh gang on the remaining capacity, strike-free.",
    labels=["reason"])
_M_REFORMS = _mx.registry().counter(
    "scanner_tpu_gang_reforms_total",
    "Gang formations for a task whose previous gang aborted — the "
    "loss-tolerant re-forming path (always at a higher epoch).")
_M_EPOCH = _mx.registry().gauge(
    "scanner_tpu_gang_epoch",
    "Highest gang epoch minted by this master for the active bulk; "
    "every gang RPC carries (gang_id, epoch) and stale-epoch replies "
    "are NACKed.")
_M_STALE_NACKS = _mx.registry().counter(
    "scanner_tpu_gang_stale_nacks_total",
    "Gang RPCs NACKed on (gang_id, epoch) fence grounds, by method — "
    "a completion/failure/ack from an aborted (or pre-failover) gang "
    "epoch that was refused instead of double-applied.",
    labels=["rpc"])


def count_formed(reform: bool) -> None:
    _M_FORMED.inc()
    if reform:
        _M_REFORMS.inc()


def count_aborted(reason: str) -> None:
    _M_ABORTED.labels(reason=reason).inc()


def set_epoch(epoch: int) -> None:
    _M_EPOCH.set(epoch)


def count_stale_nack(rpc: str) -> None:
    _M_STALE_NACKS.labels(rpc=rpc).inc()


# cross-host gang phase telemetry (docs/observability.md §Cross-host
# time; scanner-check SC314 keeps this tuple, the registrations below
# and the docs marker table in sync, all directions).  The member child
# times its phases and returns them in the result dict — its registry
# is never scraped — and the parent worker folds them here; the skew
# histogram observes on the MASTER, from offset-corrected member
# barrier arrivals.
GANG_PHASE_SERIES = (
    "scanner_tpu_gang_phase_seconds_total",
    "scanner_tpu_gang_barrier_skew_seconds",
)

_M_PHASE = _mx.registry().counter(
    "scanner_tpu_gang_phase_seconds_total",
    "Seconds gang members spent per phase (spawn = starting the member "
    "process up to its entry point, device = bringing up its card, "
    "rendezvous = joining the process group, "
    "stage = evaluating the task body, barrier = waiting for the "
    "slowest member at the pre-collective barrier, collective = the "
    "post-arrival cross-host reduction, assemble = the output-shard "
    "all-gather), by member role.  Folded from member-child results by "
    "the parent worker.",
    labels=["phase", "role"])
# skew is usually milliseconds; the default latency buckets start at
# 1ms but top out too coarse between 10-100ms, where gang health lives
_M_BARRIER_SKEW = _mx.registry().histogram(
    "scanner_tpu_gang_barrier_skew_seconds",
    "Per-(gang, epoch) barrier-arrival skew: max - min member arrival "
    "at the pre-collective barrier, computed on the master from "
    "offset-corrected member timestamps — the time every host donates "
    "to the slowest one.",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5, 5.0, 10.0))


def count_phases(phases: Optional[Dict[str, float]],
                 role: Optional[str]) -> None:
    """Fold one member child's phase seconds into this (parent worker)
    process's registry."""
    if not phases:
        return
    r = str(role or "member")
    for phase, s in phases.items():
        try:
            _M_PHASE.labels(phase=str(phase), role=r).inc(float(s))
        except (TypeError, ValueError):
            continue


def observe_barrier_skew(seconds: float) -> None:
    _M_BARRIER_SKEW.observe(max(float(seconds), 0.0))


# sharded-gang data-plane telemetry (docs/observability.md §Metric
# catalog; scanner-check SC315 keeps this tuple, the registrations
# below and the docs marker table in sync, all directions).  The first
# three fold member-child results in the parent worker — same path as
# the phase seconds; the commit-fold counter bumps on the MASTER, which
# cross-checks every member's reported shard digest against the gang's
# collective total at completion (the shard commit fold).
GANG_SHARD_SERIES = (
    "scanner_tpu_gang_shard_rows_total",
    "scanner_tpu_gang_shard_decode_rows_total",
    "scanner_tpu_gang_shard_halo_bytes_total",
    "scanner_tpu_gang_shard_commit_folds_total",
)

_M_SHARD_ROWS = _mx.registry().counter(
    "scanner_tpu_gang_shard_rows_total",
    "Output rows gang members evaluated as THEIR shard on the "
    "mesh-partitioned path (sharded gangs sum to the task's rows "
    "across members; replicated gangs never bump this).  Folded from "
    "member-child results by the parent worker, by member role.",
    labels=["role"])
_M_SHARD_DECODE_ROWS = _mx.registry().counter(
    "scanner_tpu_gang_shard_decode_rows_total",
    "Source rows each gang member's loader planned to read/decode for "
    "its shard (shard rows + any stencil halo it decoded locally) — "
    "the per-member decode-isolation signal: on an even N-host shard "
    "this is ~1/N of the replicated decode.  Folded from member-child "
    "results by the parent worker, by member role.",
    labels=["role"])
_M_SHARD_HALO_BYTES = _mx.registry().counter(
    "scanner_tpu_gang_shard_halo_bytes_total",
    "Bytes of stencil boundary rows a gang member received from its "
    "neighbors over the group's halo exchange (parallel/halo.py) instead "
    "of decoding them locally.  Folded from member-child results by "
    "the parent worker, by member role.",
    labels=["role"])
_M_SHARD_FOLD = _mx.registry().counter(
    "scanner_tpu_gang_shard_commit_folds_total",
    "Master-side shard commit folds: at each sharded gang completion "
    "the master folds the members' reported per-shard digests and "
    "cross-checks their sum against the gang's collective total "
    "(ok = every member reported and the sums agree, mismatch = sums "
    "disagree — the completion is still member-0-verified, this flags "
    "a reporting-plane divergence, partial = a member's report never "
    "arrived before the gang retired).",
    labels=["result"])


def count_shard_stats(shard: Optional[Dict[str, Any]],
                      role: Optional[str]) -> None:
    """Fold one member child's sharded data-plane stats into this
    (parent worker) process's registry."""
    if not shard:
        return
    r = str(role or "member")
    try:
        _M_SHARD_ROWS.labels(role=r).inc(float(shard.get("rows") or 0))
        _M_SHARD_DECODE_ROWS.labels(role=r).inc(
            float(shard.get("decode_rows") or 0))
        _M_SHARD_HALO_BYTES.labels(role=r).inc(
            float(shard.get("halo_bytes") or 0))
    except (TypeError, ValueError):
        pass


def count_shard_fold(result: str) -> None:
    _M_SHARD_FOLD.labels(result=str(result)).inc()


def fold_kernel_counts(counts: Optional[Dict[str, int]]) -> None:
    """Fold one member child's hand-written-kernel launch counts (its
    result's "cuda_ops") into this (parent worker) process's counts."""
    if counts:
        from ..kernels import cuda_ops
        cuda_ops.fold_counts(counts)


def _kernel_counts() -> Dict[str, int]:
    """This process's launch counts of the hand-written kernels, if the
    kernel module was ever loaded here (a member whose graph runs no
    kernel never imports it)."""
    ops = sys.modules.get("scanner_tpu_torch.kernels.cuda_ops")
    return ops.counts() if ops is not None else {}


# ---------------------------------------------------------------------------
# parent side: one member child per (gang, epoch)
# ---------------------------------------------------------------------------

def member_timeout_s(task_timeout: float) -> Optional[float]:
    """Wall-clock bound on one member child: rendezvous budget + work
    budget.  `task_timeout=0` means "no timeout" (PerfParams parity):
    the member gets NO deadline either — a runner blocked in a DEAD
    collective is still reaped promptly by the heartbeat gang-liveness
    callback (spawn_member `alive`), which is the mechanism that
    actually detects peer loss; a hard cap here would kill legitimate
    long tasks every attempt until the bulk blacklisted."""
    if not task_timeout or task_timeout <= 0:
        return None
    return init_timeout_s() + max(float(task_timeout), 30.0)


# seconds a member runner may take to leave its group and exit after it
# wrote its result
TEARDOWN_GRACE_S = 10.0


def spawn_member(request: Dict[str, Any],
                 timeout: Optional[float] = None,
                 env: Optional[Dict[str, str]] = None,
                 alive=None) -> Dict[str, Any]:
    """Run one gang member to completion in a child process and return
    its result dict ({"ok": True, "digest": ...} or {"ok": False,
    "stage", "transient", "error"}).  Never raises: every failure shape
    — rendezvous, collective hang (timeout), child crash — comes back
    as a transient result the caller reports via GangFailed.

    `alive` (optional callback) is polled while waiting: returning
    False means the gang was aborted underneath this member (the
    master's heartbeat gang-liveness list) — the runner is reaped
    immediately instead of burning the member timeout blocked in a
    collective whose peer is gone.  A runner whose result file exists
    has finished its work and only leaves the group: `alive` is no
    longer polled (the writer's commit retires the gang from that list
    while a slower member may still be tearing down), and the runner
    gets TEARDOWN_GRACE_S to exit before it is killed; its result
    stands either way.

    Chaos hooks fire HERE, in the worker process, so crash-mode plans
    model host death: the child carries PR_SET_PDEATHSIG and dies with
    us, mid-collective from its peers' point of view.  The child's env
    has SCANNER_TPU_FAULTS stripped — a fresh process per epoch would
    otherwise re-arm counted plans from zero every re-form and never
    converge."""
    detail = (f"gang={request.get('gang_id')}:"
              f"e{request.get('epoch')}:m{request.get('process_id')}")
    try:
        if _faults.ACTIVE:
            # rendezvous-time fault: raise = the member cannot join
            # (reported transient), crash = the host dies before its
            # runner even starts
            _faults.inject("gang.rendezvous", detail=detail)
    except Exception as e:  # noqa: BLE001 — injected rendezvous loss
        return {"ok": False, "stage": "rendezvous", "transient": True,
                "error": f"{type(e).__name__}: {e}"}
    import cloudpickle

    if timeout is None:
        timeout = member_timeout_s(request.get("task_timeout", 0))
    workdir = tempfile.mkdtemp(prefix="gang_member_")
    req_path = os.path.join(workdir, "request.bin")
    res_path = os.path.join(workdir, "result.bin")
    joined = res_path + ".joined"
    request = dict(request, joined_marker=joined)
    with open(req_path, "wb") as fh:
        fh.write(cloudpickle.dumps(request))
    child_env = dict(env if env is not None else os.environ)
    child_env.pop("SCANNER_TPU_FAULTS", None)
    # the child imports this package from the same checkout as its
    # worker, wherever the worker was started from
    child_env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_REPO_DIR, child_env.get("PYTHONPATH")) if p)
    # deliberate child-side plan pass-through: SCANNER_TPU_GANG_CHILD_FAULTS
    # arms the MEMBER process itself (e.g. a gang.collective delay that
    # must slow the member's barrier arrival, not the parent's poll
    # loop).  Kept separate from SCANNER_TPU_FAULTS so counted
    # crash-mode plans stay parent-side and converge across re-forms.
    child_plan = (env if env is not None else os.environ).get(
        "SCANNER_TPU_GANG_CHILD_FAULTS")
    if child_plan:
        child_env["SCANNER_TPU_FAULTS"] = child_plan
    t_spawn = time.time()
    proc = subprocess.Popen(
        [sys.executable, "-m", "scanner_tpu_torch.engine.gang",
         req_path, res_path],
        env=child_env)
    deadline = time.time() + timeout if timeout else None
    injected_collective = False
    finished_at = None
    try:
        while proc.poll() is None:
            if not injected_collective and os.path.exists(joined):
                injected_collective = True
                try:
                    if _faults.ACTIVE:
                        # the child has rendezvoused and is entering
                        # the collective: a crash here kills worker AND
                        # runner (pdeathsig) — host loss mid-collective
                        _faults.inject("gang.collective", detail=detail)
                except Exception as e:  # noqa: BLE001
                    proc.kill()
                    proc.wait()
                    return {"ok": False, "stage": "collective",
                            "transient": True,
                            "error": f"{type(e).__name__}: {e}"}
            if finished_at is None and os.path.exists(res_path):
                finished_at = time.time()
            if finished_at is not None:
                if time.time() - finished_at > TEARDOWN_GRACE_S:
                    _log.warning("gang member %s: runner still tearing "
                                 "down %.1fs after its result: killing "
                                 "it", detail, TEARDOWN_GRACE_S)
                    proc.kill()
                    proc.wait()
                    break
                time.sleep(0.05)
                continue
            if alive is not None and not alive():
                _log.warning("gang member %s: gang aborted underneath "
                             "this member — reaping the runner",
                             detail)
                proc.kill()
                proc.wait()
                return {"ok": False, "stage": "aborted",
                        "transient": True,
                        "error": "gang aborted while member ran"}
            if deadline is not None and time.time() > deadline:
                _log.warning("gang member %s timed out after %.1fs: "
                             "killing the runner", detail, timeout)
                proc.kill()
                proc.wait()
                return {"ok": False, "stage": "timeout",
                        "transient": True,
                        "error": f"member timed out after {timeout:.1f}s "
                                 "(peer lost mid-collective?)"}
            time.sleep(0.05)
        if os.path.exists(res_path):
            # `teardown`: the runner's result written to its exit
            teardown = max(0.0, time.time() - os.path.getmtime(res_path))
            with open(res_path, "rb") as fh:
                res = cloudpickle.loads(fh.read())
            _fold_startup(res, t_spawn)
            res["phases"]["teardown"] = teardown
            return res
        # no result file: the runner died hard (injected host loss, OOM
        # kill, a crashed peer's coordination-service shutdown) — the
        # same transient member-loss shape as a timeout
        return {"ok": False, "stage": "crash", "transient": True,
                "error": f"gang member runner exited "
                         f"{proc.returncode} with no result"}
    finally:
        for p in (req_path, res_path, joined):
            try:
                os.unlink(p)
            except OSError:
                pass
        try:
            os.rmdir(workdir)
        except OSError:
            pass


_REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _fold_startup(res: Dict[str, Any], t_spawn: float) -> None:
    """The member's start-up as two phases, from the child's host
    stamps (same host clock): `spawn` = process start up to its entry
    point (the interpreter and the imports), `device` = entry point to
    ready to rendezvous (the card's context)."""
    ph = res.setdefault("phases", {})
    started, ready = res.get("started_at"), res.get("ready_at")
    if started:
        ph["spawn"] = max(0.0, float(started) - t_spawn)
        if ready:
            ph["device"] = max(0.0, float(ready) - float(started))


# ---------------------------------------------------------------------------
# child side: the member body
# ---------------------------------------------------------------------------

def _die_with_parent() -> None:
    """PR_SET_PDEATHSIG(SIGKILL): the runner must not outlive its
    worker — an orphaned member completing (or committing) after its
    host 'died' would violate the gang's loss semantics.  Linux only;
    elsewhere the parent's kill-on-timeout is the backstop."""
    try:
        import ctypes
        import signal
        libc = ctypes.CDLL(None, use_errno=True)
        PR_SET_PDEATHSIG = 1
        libc.prctl(PR_SET_PDEATHSIG, signal.SIGKILL)
    except Exception:  # noqa: BLE001
        pass


def _digest_rows(rows) -> int:
    """Deterministic uint32 digest of one shard's result rows: bytes
    rows hash directly, array-likes via their buffer, null rows as a
    fixed sentinel — the cross-host agreement currency.  Object-dtype
    arrays and unhashable row types contribute a constant only (their
    buffer holds process-local pointers, which would make identical
    rows disagree across hosts; agreement then still covers row
    counts)."""
    import zlib

    import numpy as np

    from ..common import NullElement
    acc = 0
    for r in rows:
        if isinstance(r, (bytes, bytearray, memoryview)):
            acc = (acc + zlib.crc32(bytes(r))) & 0xFFFFFFFF
        elif isinstance(r, NullElement):
            acc = (acc + 0x9E3779B9) & 0xFFFFFFFF
        else:
            try:
                arr = np.asarray(r)
                if arr.dtype == object:
                    raise TypeError("object rows digest by count")
                acc = (acc + zlib.crc32(np.ascontiguousarray(arr)
                                        .tobytes())) & 0xFFFFFFFF
            except Exception:  # noqa: BLE001
                acc = (acc + 1) & 0xFFFFFFFF
    return acc


def shard_range(n_rows: int, process_id: int,
                num_processes: int) -> tuple:
    """Contiguous per-host row shard [lo, hi) of a task's rows — the
    one split BOTH planes key off: digest staging and, on the sharded
    path, the data rows each member loads/decodes/evaluates.  Ceil-chunk
    layout (equal chunks, remainder on the last non-empty shard, tail
    shards possibly empty) — parallel/distributed.shard_rows — so shard
    blocks stage through the uneven host_local_array path with zero
    re-indexing."""
    from ..parallel.distributed import shard_rows
    return shard_rows(n_rows, process_id, num_processes)


def _gang_mesh(num_processes: int):
    """The ("hosts", "local") mesh over the gang's process group
    (parallel/mesh.host_mesh): row p = member p's one device."""
    from ..parallel.mesh import host_mesh
    return host_mesh(num_processes)


def _collective_digest_sum(num_processes: int, process_id: int,
                           local_digest: int) -> int:
    """One cross-process reduction over the gang mesh: every member
    stages its shard digest as its block of the "hosts" axis
    (parallel/distributed.host_local_array) and the sum comes back on
    every member — the gang's synchronization point AND its agreement
    signal.  Gloo has no uint32 reduction, so the digests (each below
    2**32) sum as int64 and the total is masked to 32 bits: the same
    value as the JAX package's wrapping uint32 sum."""
    import numpy as np
    import torch.distributed as dist

    from ..parallel.distributed import host_local_array

    mesh = _gang_mesh(num_processes)
    t = host_local_array(mesh, ("hosts",),
                         np.array([int(local_digest) & 0xFFFFFFFF],
                                  dtype=np.int64))
    dist.all_reduce(t, op=dist.ReduceOp.SUM,
                    group=mesh.get_group("hosts"))
    return int(t.sum()) & 0xFFFFFFFF


def _iface_of(addr: str) -> Optional[str]:
    """The network interface holding IPv4 address `addr` (Linux)."""
    import fcntl
    import struct
    for _idx, name in socket.if_nameindex():
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            try:
                got = fcntl.ioctl(s.fileno(), 0x8915,  # SIOCGIFADDR
                                  struct.pack("256s",
                                              name[:15].encode()))
            except OSError:
                continue
        if socket.inet_ntoa(got[20:24]) == addr:
            return name
    return None


def gloo_interface(coordinator: str) -> Optional[str]:
    """The interface a member's gloo binds for a gang whose store serves
    at `coordinator` ("host:port"): the one holding the local IPv4
    address the kernel routes to the coordinator from ("lo" for a
    loopback coordinator).  Connecting a UDP socket only asks the
    kernel for the route; it sends nothing.  None when that cannot be
    told (gloo then binds the address of its own hostname)."""
    host = coordinator.rsplit(":", 1)[0].strip("[]") or "localhost"
    try:
        target = socket.getaddrinfo(host, None, socket.AF_INET)[0][4][0]
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect((target, 9))
            local = s.getsockname()[0]
        return _iface_of(local)
    except OSError:
        return None


def _all_gather_bytes(num_processes: int, payload: bytes) -> List[bytes]:
    """All-gather one variable-length byte payload per member over the
    gang mesh: a size round (so every member pads to the same width —
    collectives need static shapes), then one row-sharded gather of the
    padded buffers (parallel/distributed.all_gather_rows).  Returns the
    per-member payloads in rank order, identical on every member — the
    transport sharded members assemble output shards through."""
    import numpy as np

    from ..parallel.distributed import all_gather_rows

    mesh = _gang_mesh(num_processes)
    sizes = all_gather_rows(
        mesh, "hosts", np.array([len(payload)], dtype=np.int64))
    width = max(int(sizes.max()), 1)
    buf = np.zeros((1, width), dtype=np.uint8)
    if payload:
        buf[0, :len(payload)] = np.frombuffer(payload, dtype=np.uint8)
    full = all_gather_rows(mesh, "hosts", buf)
    return [full[p, :int(sizes[p])].tobytes()
            for p in range(num_processes)]


def run_member(req: Dict[str, Any], publish=None) -> Dict[str, Any]:
    """The member body (runs inside the child process): rendezvous →
    evaluate → collective agreement → (member 0) save.  Returns a
    result dict; never raises.  `publish(result)`, when given, is called
    with the finished result before the member leaves its process
    group, so its parent has the result while the runner tears down.

    Phase instrumentation (docs/observability.md §Cross-host time):
    each phase gets a first-class child span under the gang root —
    `gang.rendezvous`, `gang.stage`, `gang.barrier` (entry →
    all-arrived = time donated to the slowest member) and
    `gang.collective` (all-arrived → result-ready) — and its wall
    seconds come back in the result dict ("phases"/"role") so the
    parent worker can fold them into the scraped registry."""
    from ..parallel.distributed import (CoordinatorConfig,
                                        RendezvousError, initialize,
                                        shutdown)
    from ..util import tracing as _tr
    pid = int(req["process_id"])
    num = int(req["num_processes"])
    tracer = _tr.Tracer(
        node=req.get("node") or f"gang-m{pid}", export=True)
    ctx = _tr.parse_traceparent(req.get("traceparent"))
    attrs = {"gang": req.get("gang_id"), "epoch": req.get("epoch"),
             "member": pid, "num": num,
             "job": req.get("job_idx"), "task": req.get("task_idx")}
    phases: Dict[str, float] = {}
    role = "coordinator" if pid == 0 else "member"
    # the worker's own device, resolved here before joining anything: a
    # member asked for a card it cannot see fails loudly — it never
    # evaluates on the CPU instead
    try:
        device = _member_device(req.get("device") or "cuda")
    except Exception as e:  # noqa: BLE001
        return {"ok": False, "stage": "device", "transient": True,
                "error": f"{type(e).__name__}: {e}",
                "spans": tracer.drain_export(),
                "phases": phases, "role": role}
    req = dict(req, device=device)
    if not os.environ.get("GLOO_SOCKET_IFNAME"):
        iface = gloo_interface(req["coordinator"])
        if iface:
            os.environ["GLOO_SOCKET_IFNAME"] = iface
    t_rz = ready_at = time.time()
    rz = _tr.open_span(tracer, "gang.rendezvous", parent=ctx, **attrs)
    try:
        # current-span context so distributed.initialize's rendezvous
        # events land ON the gang.rendezvous span's timeline
        with _tr.use_span(tracer, rz):
            initialize(
                CoordinatorConfig(address=req["coordinator"],
                                  num_processes=num, process_id=pid),
                init_timeout=float(req.get("init_timeout")
                                   or init_timeout_s()),
                backend=BACKEND)
    except RendezvousError as e:
        _tr.close_span(tracer, rz, status="error")
        return {"ok": False, "stage": "rendezvous", "transient": True,
                "error": str(e), "spans": tracer.drain_export(),
                "phases": phases, "role": role, "ready_at": ready_at,
                "started_at": req.get("started_at")}
    except Exception as e:  # noqa: BLE001
        _tr.close_span(tracer, rz, status="error")
        return {"ok": False, "stage": "rendezvous", "transient": True,
                "error": f"{type(e).__name__}: {e}",
                "spans": tracer.drain_export(),
                "phases": phases, "role": role, "ready_at": ready_at,
                "started_at": req.get("started_at")}
    _tr.close_span(tracer, rz)
    phases["rendezvous"] = time.time() - t_rz
    marker = req.get("joined_marker")
    if marker:
        try:
            with open(marker, "w") as fh:
                fh.write("joined")
        except OSError:
            pass
    try:
        try:
            res = _member_body(req, pid, num, tracer, ctx, attrs, phases)
        except Exception as e:  # noqa: BLE001 — collective/commit errors
            # surface as a transient member failure, not a child crash
            res = {"ok": False, "stage": "collective", "transient": True,
                   "error": f"{type(e).__name__}: {e}",
                   "spans": tracer.drain_export()}
        res.setdefault("phases", phases)
        res.setdefault("role", role)
        res["ready_at"] = ready_at
        res["started_at"] = req.get("started_at")
        res["cuda_ops"] = _kernel_counts()
        if publish is not None:
            publish(res)
        if _faults.ACTIVE:
            try:
                # delay = a member that outlives its gang's commit
                _faults.inject("gang.teardown",
                               detail=f"gang={req.get('gang_id')}:"
                                      f"e{req.get('epoch')}:m{pid}")
            except Exception:  # noqa: BLE001 — the result is out
                pass
    finally:
        shutdown()
    return res


def _member_device(name: str) -> str:
    """Resolve the worker's device in the member process and bring its
    card up (a CUDA context of this process's own), so the member's
    spawn cost includes it and its stage phase is the task alone."""
    import torch

    from .evaluate import resolve_device
    dev = resolve_device(name)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)
    return str(dev)


def _member_body(req: Dict[str, Any], pid: int, num: int,
                 tracer, ctx, attrs: Dict[str, Any],
                 phases: Dict[str, float]) -> Dict[str, Any]:
    import cloudpickle
    import torch

    from ..storage import Database, make_storage
    from ..util import tracing as _tr
    from .executor import LocalExecutor, TaskItem

    db = Database(make_storage(req.get("storage_type") or "posix",
                               db_path=req["db_path"]))
    db.refresh_meta()
    ex = LocalExecutor(db, device=torch.device(req["device"]))
    ex.tracer = tracer
    spec = cloudpickle.loads(req["spec"])
    info, jobs = ex.prepare_readonly(spec["outputs"], spec["perf"])
    job = jobs[int(req["job_idx"])]
    task_idx = int(req["task_idx"])
    if req.get("sharded") and num > 1:
        return _sharded_body(req, pid, num, tracer, ctx, attrs, phases,
                             ex, info, job, task_idx)
    w = TaskItem(job, task_idx, tuple(job.tasks[task_idx]),
                 attempt=int(req.get("attempt") or 0))
    w.trace_ctx = ctx
    t_stage = time.time()
    st = _tr.open_span(tracer, "gang.stage", parent=ctx, **attrs)
    try:
        ex.run_single_task(info, w, save=False,
                           span_attrs={"gang": req.get("gang_id"),
                                       "epoch": req.get("epoch"),
                                       "member": pid})
    except Exception as e:  # noqa: BLE001
        from .service import _is_transient_failure
        _tr.close_span(tracer, st, status="error")
        return {"ok": False, "stage": "evaluate",
                "transient": _is_transient_failure(e),
                "error": f"{type(e).__name__}: {e}",
                "spans": tracer.drain_export()}
    _tr.close_span(tracer, st)
    phases["stage"] = time.time() - t_stage
    # per-host digest shards: member p digests only rows [lo, hi) of
    # every sink's output, the collective assembles the full-task sum
    # across hosts, and member 0 — which evaluated the whole task —
    # cross-checks the assembled sum against its own local shard sums:
    # one diverging member fails the gang instead of committing
    start, end = w.output_range
    n_rows = end - start
    lo, hi = shard_range(n_rows, pid, num)
    sink_rows: List[Any] = []
    for sink in info.sinks:
        if sink.id in w.results:
            sink_rows.append(ex._sink_rows(w.results[sink.id],
                                           start, end))
    local = sum(_digest_rows(rows[lo:hi])
                for rows in sink_rows) & 0xFFFFFFFF
    total = _barrier_and_digest(req, pid, num, tracer, ctx, attrs,
                                phases, local)
    if pid == 0:
        expect = 0
        for p in range(num):
            plo, phi = shard_range(n_rows, p, num)
            expect = (expect + sum(_digest_rows(rows[plo:phi])
                                   for rows in sink_rows)) & 0xFFFFFFFF
        if total != expect:
            return {"ok": False, "stage": "agree", "transient": True,
                    "error": f"cross-host digest mismatch: collective "
                             f"sum {total} != member-0 expectation "
                             f"{expect}",
                    "spans": tracer.drain_export()}
        # agreement holds: the single writer commits, exactly once
        ex.save_results(info, w)
    else:
        ex._task_trace_end(w)
    return {"ok": True, "digest": total, "rows": n_rows,
            "shard_digest": local,
            "spans": tracer.drain_export()}


def _barrier_and_digest(req: Dict[str, Any], pid: int, num: int,
                        tracer, ctx, attrs: Dict[str, Any],
                        phases: Dict[str, float], local: int) -> int:
    """The gang's synchronization pair, shared by both evaluation modes:
    the zero-digest barrier reduction (time spent = time donated to the
    slowest member), then the real digest reduction (pure collective
    cost).  The child-side collective fault fires BEFORE barrier entry,
    so a delayed member arrives late and the skew/attribution planes
    see a real straggler, not a slowed parent poll."""
    from ..util import tracing as _tr
    if _faults.ACTIVE:
        _faults.inject("gang.collective",
                       detail=f"gang={req.get('gang_id')}:"
                              f"e{req.get('epoch')}:m{pid}")
    # barrier wait vs transfer/compute, split explicitly: the
    # entry/all-arrived events carry the timestamps the master's skew
    # fold compares.
    t_bar = time.time()
    bar = _tr.open_span(tracer, "gang.barrier", parent=ctx, **attrs)
    if bar is not None:
        bar.add_event("barrier.enter", member=pid)
    _collective_digest_sum(num, pid, 0)
    if bar is not None:
        bar.add_event("barrier.all_arrived", member=pid)
    _tr.close_span(tracer, bar)
    t_col = time.time()
    phases["barrier"] = t_col - t_bar
    col = _tr.open_span(tracer, "gang.collective", parent=ctx, **attrs)
    total = _collective_digest_sum(num, pid, local)
    _tr.close_span(tracer, col)
    phases["collective"] = time.time() - t_col
    return total


def _sharded_body(req: Dict[str, Any], pid: int, num: int,
                  tracer, ctx, attrs: Dict[str, Any],
                  phases: Dict[str, float], ex, info, job,
                  task_idx: int) -> Dict[str, Any]:
    """The mesh-partitioned member body: evaluate ONLY this member's
    row shard (the loader and frame cache see only [lo, hi) plus any
    locally-decoded stencil reach), agree through the same digest
    collective as the replicated path, all-gather the serialized output
    shards over the mesh, and let member 0 — the single writer —
    assemble and commit the full task after cross-checking the
    assembled rows against the collective total.  Per-gang throughput
    is ~N× the replicated path's; the failure machinery (epoch bump →
    re-form smaller, which simply recomputes shard_range at the new
    num_processes) carries over unchanged."""
    import cloudpickle
    import numpy as np

    from ..util import tracing as _tr
    from . import framecache as _fc
    from .batch import ColumnBatch
    from .executor import TaskItem

    start, end = (int(job.tasks[task_idx][0]),
                  int(job.tasks[task_idx][1]))
    n_rows = end - start
    lo, hi = shard_range(n_rows, pid, num)
    # mesh-aware frame cache: pages this member stages are keyed under
    # its (host-shard, device) identity — residency is 1/N per member
    # by construction (the shard plan only ever touches shard rows)
    _fc.set_host_shard(f"s{pid}of{num}")
    w = TaskItem(job, task_idx, (start + lo, start + hi),
                 attempt=int(req.get("attempt") or 0))
    w.trace_ctx = ctx
    halo_stats = {"bytes": 0}
    halo_plan = None
    if req.get("halo", True) and hi > lo and n_rows % num == 0:
        try:
            halo_plan = _plan_halo(info, job, task_idx, num, start, end)
        except Exception:  # noqa: BLE001 — planning is best-effort;
            halo_plan = None  # members fall back to local halo decode
    if halo_plan:
        w.halo_drop = {nid: hp["drops"][pid]
                       for nid, hp in halo_plan.items()}
        w.halo_fill = _make_halo_filler(pid, num, start, n_rows // num,
                                        halo_plan, halo_stats)
        # pre-warm the exchange on the REAL block geometry (frame shape
        # is in the shared job metadata, so every member derives the
        # same warm-up — SPMD-safe) so the group's first point-to-point
        # setup lands here, not inside the timed stage phase
        from ..parallel.halo import warm_halo_exchange
        mesh = _gang_mesh(num)
        for nid in sorted(halo_plan):
            vm = (job.source_info.get(nid) or {}).get("video_meta")
            if vm is None or not (vm.height and vm.width):
                continue
            nl, nh = halo_plan[nid]["need"]
            warm_halo_exchange(
                mesh, (n_rows // num, int(vm.height), int(vm.width), 3),
                np.uint8, nl, nh)
    t_stage = time.time()
    st = _tr.open_span(tracer, "gang.stage", parent=ctx, **attrs)
    shard_rows_by_sink: Dict[int, List[Any]] = {}
    if hi > lo:
        try:
            ex.run_single_task(info, w, save=False,
                               span_attrs={"gang": req.get("gang_id"),
                                           "epoch": req.get("epoch"),
                                           "member": pid,
                                           "shard": f"{lo}:{hi}"})
        except Exception as e:  # noqa: BLE001
            from .service import _is_transient_failure
            _tr.close_span(tracer, st, status="error")
            return {"ok": False, "stage": "evaluate",
                    "transient": _is_transient_failure(e),
                    "error": f"{type(e).__name__}: {e}",
                    "spans": tracer.drain_export()}
        for sink in info.sinks:
            if w.results and sink.id in w.results:
                shard_rows_by_sink[sink.id] = ex._sink_rows(
                    w.results[sink.id], start + lo, start + hi)
    _tr.close_span(tracer, st)
    phases["stage"] = time.time() - t_stage
    local = sum(_digest_rows(rows)
                for rows in shard_rows_by_sink.values()) & 0xFFFFFFFF
    total = _barrier_and_digest(req, pid, num, tracer, ctx, attrs,
                                phases, local)
    # output assembly: one all-gather of the serialized shard rows over
    # the mesh — every member participates (the collective is SPMD),
    # member 0 consumes the result
    t_asm = time.time()
    asm = _tr.open_span(tracer, "gang.assemble", parent=ctx, **attrs)
    payload = cloudpickle.dumps(shard_rows_by_sink)
    blobs = _all_gather_bytes(num, payload)
    _tr.close_span(tracer, asm)
    phases["assemble"] = time.time() - t_asm
    shard_stats = {"lo": lo, "hi": hi, "rows": hi - lo,
                   "decode_rows": int(getattr(w, "decode_rows", 0)),
                   "halo_bytes": int(halo_stats["bytes"]),
                   "gather_bytes": sum(len(b) for b in blobs)}
    if pid != 0:
        ex._task_trace_end(w)
        return {"ok": True, "digest": total, "rows": n_rows,
                "shard_digest": local, "shard": shard_stats,
                "spans": tracer.drain_export()}
    # member 0: verify the ASSEMBLED rows against the collective total
    # — one agreement check covering both a diverging member and any
    # transport corruption in the gather — then commit, exactly once
    per_member = [cloudpickle.loads(b) for b in blobs]
    part_digests = [sum(_digest_rows(rows)
                        for rows in part.values()) & 0xFFFFFFFF
                    for part in per_member]
    expect = sum(part_digests) & 0xFFFFFFFF
    if total != expect:
        ex._task_trace_end(w, status="error")
        return {"ok": False, "stage": "agree", "transient": True,
                "error": f"cross-host digest mismatch: collective sum "
                         f"{total} != assembled-shard expectation "
                         f"{expect}",
                "spans": tracer.drain_export()}
    results: Dict[int, Any] = {}
    rows_global = np.arange(start, end, dtype=np.int64)
    for sink in info.sinks:
        full: List[Any] = []
        for part in per_member:
            full.extend(part.get(sink.id, ()))
        if len(full) != n_rows:
            ex._task_trace_end(w, status="error")
            return {"ok": False, "stage": "agree", "transient": True,
                    "error": f"sharded assembly produced {len(full)} "
                             f"rows for sink {sink.id}, task has "
                             f"{n_rows}",
                    "spans": tracer.drain_export()}
        results[sink.id] = ColumnBatch.from_elements(rows_global, full)
    ex._task_trace_end(w)
    wf = TaskItem(job, task_idx, (start, end), attempt=w.attempt)
    wf.results = results
    ex.save_results(info, wf)
    return {"ok": True, "digest": total, "rows": n_rows,
            "shard_digest": local, "shard": shard_stats,
            "shard_digests": part_digests,
            "spans": tracer.drain_export()}


def _plan_halo(info, job, task_idx: int, num: int, start: int,
               end: int) -> Dict[int, Dict[str, Any]]:
    """Decide — deterministically, from inputs every member shares —
    which video source nodes exchange their stencil boundary rows over
    the group instead of decoding them locally, and by how much.  Each
    member derives ALL members' shard plans (pure analysis, no IO), so
    the eligibility decision and the exchange extents are identical
    across the gang with no agreement round: either every member enters
    the node's halo collective, or none does.

    A node is eligible only when, for EVERY member: its own-window
    source rows are fully covered by its plan (so any neighbor's halo
    row has an owner that decoded it), its out-of-window in-task rows
    form a contiguous single-hop extension of the window (the halo
    shifts reach immediate neighbors only), and all in-task rows live
    in one table item (uniform frame geometry — exchange blocks must
    stack).  Rows outside the task range (stencil reach past the task
    edge) always decode locally and never enter the exchange."""
    import numpy as np

    from ..graph import analysis as A

    n_rows = end - start
    chunk = n_rows // num
    if chunk <= 0:
        return {}
    plans = [A.derive_task_streams(
        info, job.jr, (start + p * chunk, start + (p + 1) * chunk),
        job_idx=job.job_idx, task_idx=task_idx) for p in range(num)]
    out: Dict[int, Dict[str, Any]] = {}
    for nid, si in job.source_info.items():
        if "custom" in si or not si.get("is_video"):
            continue
        desc = si["table"]
        need_lo = need_hi = 0
        drops: List[Any] = []
        items = set()
        ok = False
        for p in range(num):
            plo = start + p * chunk
            phi = plo + chunk
            prows = np.asarray(plans[p].source_rows.get(nid, ()),
                               np.int64)
            pin = prows[(prows >= start) & (prows < end)]
            own = pin[(pin >= plo) & (pin < phi)]
            if len(own) != chunk or own[0] != plo \
                    or own[-1] != phi - 1:
                break
            drop = np.sort(pin[(pin < plo) | (pin >= phi)])
            if len(drop):
                nl = max(0, plo - int(drop.min()))
                nh = max(0, int(drop.max()) - phi + 1)
                if max(nl, nh) > chunk:
                    break
                want = np.concatenate([
                    np.arange(plo - nl, plo, dtype=np.int64),
                    np.arange(phi, phi + nh, dtype=np.int64)])
                if not np.array_equal(drop, want):
                    break
                need_lo = max(need_lo, nl)
                need_hi = max(need_hi, nh)
            items.update(desc.item_of_row(int(r)) for r in pin)
            drops.append(drop)
        else:
            ok = True
        if not ok or (need_lo == 0 and need_hi == 0) or len(items) != 1:
            continue
        out[nid] = {"need": (need_lo, need_hi), "drops": drops}
    return out


def _make_halo_filler(pid: int, num: int, start: int, chunk: int,
                      halo_plan: Dict[int, Dict[str, Any]],
                      halo_stats: Dict[str, int]):
    """Build the post-load hook (executor TaskItem.halo_fill) that runs
    the halo exchange for every eligible node and splices the
    received neighbor rows into the loaded batch — replacing the local
    decode of those rows, which the loader skipped (TaskItem.halo_drop).
    Runs on EVERY member for EVERY eligible node (SPMD collectives);
    members that need no rows from a side still relay their edges."""

    def fill(info, w):
        import numpy as np

        from ..common import ScannerException
        from ..parallel.halo import exchange_row_halo
        from .batch import ColumnBatch

        mesh = _gang_mesh(num)
        plo = start + pid * chunk
        phi = plo + chunk
        for nid in sorted(halo_plan):
            hp = halo_plan[nid]
            need_lo, need_hi = hp["need"]
            batch = (w.elements or {}).get(nid)
            if batch is None:
                raise ScannerException(
                    f"halo fill: source node {nid} missing from the "
                    f"loaded elements")
            own = batch.take_range(plo, phi).to_host()
            block = own.data
            if not isinstance(block, np.ndarray) \
                    or block.dtype == object:
                raise ScannerException(
                    f"halo fill: node {nid} decoded to non-uniform "
                    f"data; geometry eligibility was violated")
            left, right = exchange_row_halo(mesh, block, need_lo,
                                            need_hi, "hosts")
            drop = np.asarray(hp["drops"][pid], np.int64)
            my_left = drop[drop < plo]
            my_right = drop[drop >= phi]
            add_rows: List[Any] = []
            add_data: List[Any] = []
            if len(my_left):
                take = left[len(left) - len(my_left):]
                add_rows.append(my_left)
                add_data.append(take)
                halo_stats["bytes"] += int(take.nbytes)
            if len(my_right):
                take = right[:len(my_right)]
                add_rows.append(my_right)
                add_data.append(take)
                halo_stats["bytes"] += int(take.nbytes)
            if not add_rows:
                continue
            host = batch.to_host()
            rows = np.concatenate([host.rows] + add_rows)
            order = np.argsort(rows, kind="stable")
            nulls = None
            if host.nulls is not None:
                nulls = np.concatenate(
                    [host.nulls,
                     np.zeros(sum(len(r) for r in add_rows), bool)]
                )[order]
            if isinstance(host.data, np.ndarray) \
                    and host.data.dtype != object:
                data = np.concatenate([host.data] + add_data)[order]
            else:
                elems = list(host.data)
                for blockx in add_data:
                    elems.extend(list(blockx))
                data = [elems[int(i)] for i in order]
            w.elements[nid] = ColumnBatch(rows[order], data, nulls,
                                          convert=host.convert)

    return fill


def main(argv: Optional[List[str]] = None) -> int:
    """Child entry: python -m scanner_tpu_torch.engine.gang <req> <res>."""
    started_at = time.time()
    _die_with_parent()
    argv = argv if argv is not None else sys.argv[1:]
    req_path, res_path = argv[0], argv[1]
    import cloudpickle
    with open(req_path, "rb") as fh:
        req = cloudpickle.loads(fh.read())

    def publish(res):
        tmp = res_path + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(cloudpickle.dumps(res))
        os.replace(tmp, res_path)

    res = run_member(dict(req, started_at=started_at), publish=publish)
    if not os.path.exists(res_path):
        publish(res)
    return 0 if res.get("ok") else 3


if __name__ == "__main__":
    sys.exit(main())
