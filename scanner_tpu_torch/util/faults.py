"""Deterministic fault injection for chaos testing.

The robustness machinery in this repo — task reassignment on worker
death, job blacklisting, straggler revocation (engine/service.py),
bulk checkpoint/recovery, storage retries — is only trustworthy if it
actually runs under failures.  This module is the process-wide switch
that makes failures happen on demand, deterministically:

  * a registry of named **injection sites** hooked into the RPC plane,
    the storage backends, and the worker pipeline stages (see SITES);
  * **fault rules** bound to sites, with seeded/counted triggers so a
    run is reproducible: "raise StorageException on the 3rd storage
    write", "crash the process on the 2nd task evaluation", "fail 50%
    of RPC attempts (seed 7) for the first 40 attempts";
  * a live counter ``scanner_tpu_faults_injected_total{site,mode}`` so
    tests assert a fault actually fired instead of passing vacuously.

Disabled-path contract: when no plan is armed, every hook is a single
module-level flag check (``faults.ACTIVE``) — zero allocation, zero
behavior change.  Hot call sites guard with::

    from ..util import faults as _faults
    ...
    if _faults.ACTIVE:
        data = _faults.inject("storage.read", data, detail=path)

Arming (any of):
  * programmatic: ``faults.install("storage.write:raise:n=3")``
  * environment:  ``SCANNER_TPU_FAULTS`` (read at import, so spawned
    worker/master subprocesses arm themselves before serving)
  * config:       ``[faults] plan = "..."`` (Client wires it through)

Plan syntax — clauses joined by ";", fields joined by ":"::

    <site>:<mode>[:key=value]...

modes:
    raise      raise an exception (key ``exc`` picks the type, see _EXC)
    delay      sleep ``seconds`` (a hang, from the caller's view)
    corrupt    flip bytes in the data passing through the site
    crash      os._exit(CRASH_EXIT_CODE) — worker/master death mid-call
    duplicate  deliver the call TWICE (rpc.client.call only): the
               at-least-once model — request arrived, reply lost,
               caller repeats ("partitioned ≠ dead")

trigger keys (default: fire on every matching call):
    n=K       fire on exactly the Kth matching call (1-based)
    after=K   fire on every matching call past the Kth
    every=K   fire on every Kth matching call
    p=F       fire with probability F per call, drawn from a
              ``seed``-ed private RNG (reproducible sequence)
    times=K   stop after K fires (0 = unlimited)
    match=S   only calls whose detail string contains S (e.g. an RPC
              method name or a storage path)
    method=S  rpc.client.call detail is "<method>@<peer>": select one
              RPC method regardless of peer
    peer=S    select one remote address — asymmetric-partition plans
              ("calls to THIS peer fail, others succeed")

other keys: ``exc`` (raise mode), ``msg``, ``seconds`` (delay mode),
``seed`` (p mode).

Example: fail the worker's sink-item writes twice, transiently::

    SCANNER_TPU_FAULTS="storage.write:raise:exc=storage:match=output_:n=2:times=1"

See docs/robustness.md for the full matrix and tests/test_chaos.py for
the suite that drives every site.
"""

from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Union

from ..common import (DeviceOutOfMemory, ScannerException,
                      StorageException)
from . import metrics as _mx
from .log import get_logger

_log = get_logger("faults")

# every hook point wired into the codebase; install() rejects unknown
# sites so a typo'd plan fails loudly instead of injecting nothing
SITES = (
    "rpc.client.call",    # engine/rpc.py RpcClient.call, per attempt
    "rpc.server.handle",  # engine/rpc.py server handler, per request
    "storage.read",       # storage/backend.py read/read_range (data)
    "storage.write",      # storage/backend.py write/write_exclusive
    "gcs.request",        # storage/gcs.py, per retried API attempt
    "pipeline.decode",    # engine/executor.py load stage, per task
    "pipeline.eval",      # engine/executor.py evaluate stage, per task
    "pipeline.save",      # engine/executor.py save stage, per task
    "worker.heartbeat",   # engine/service.py heartbeat loop, per beat
    "worker.preempt",     # engine/service.py heartbeat loop, per beat:
                          # a raise models a spot/preemptible reclaim
                          # notice -> Worker.preempt() routine drain
    "memory.pressure",    # engine/batch.py to_device staging, per h2d
    "gang.rendezvous",    # engine/gang.py spawn_member, before the
                          # member runner starts: raise models a member
                          # that cannot join (transient GangFailed),
                          # crash kills the host pre-rendezvous
    "gang.collective",    # engine/gang.py spawn_member, fired the
                          # moment the member's runner has rendezvoused
                          # and enters the collective: crash = host
                          # death mid-collective (the runner dies with
                          # its worker via PR_SET_PDEATHSIG), raise =
                          # collective failure reported transient
)

MODES = ("raise", "delay", "corrupt", "crash", "duplicate")

# sites whose hook passes payload bytes through inject() — the only
# sites corrupt-mode can act on; install() rejects it elsewhere so a
# plan like "storage.write:corrupt" fails loudly instead of counting
# phantom fires that injected nothing
DATA_SITES = ("storage.read",)

# sites whose hook supports duplicate-delivery mode (the call is made
# TWICE against the peer, modeling at-least-once delivery after an
# ambiguous timeout — "partitioned ≠ dead"); the site's call path must
# ask take_duplicate() explicitly, so install() rejects the mode
# anywhere else
DUPLICATE_SITES = ("rpc.client.call",)

# sites whose detail string is "<method>@<peer>" — the only sites the
# structured method=/peer= selectors can meaningfully match; install()
# rejects them elsewhere (a peer= clause on storage.read would parse
# and then silently never fire)
SELECTOR_SITES = ("rpc.client.call",)

# distinctive exit status for crash-mode so tests can tell an injected
# death from a real one
CRASH_EXIT_CODE = 117

# the disabled-path flag: hooks check this module attribute and nothing
# else when no plan is armed
ACTIVE = False


class FaultInjected(ScannerException):
    """Default exception raised by raise-mode rules."""


class FaultPlanError(ScannerException):
    """Malformed fault-plan spec."""


def _unavailable_exc(msg: str):
    """A grpc.RpcError that the RPC client's backoff treats as a
    transient UNAVAILABLE transport failure — the 'server unreachable'
    storm, injectable without touching the network."""
    import grpc

    class _InjectedUnavailable(grpc.RpcError):
        def code(self):
            return grpc.StatusCode.UNAVAILABLE

        def details(self):
            return msg

        def __str__(self):
            return f"injected UNAVAILABLE: {msg}"

    return _InjectedUnavailable()


# raise-mode exception constructors by `exc=` key.  `storage` and
# `connection` matter most: engine/service.py classifies those as
# transient (requeue without a blacklist strike).
_EXC = {
    "fault": lambda m: FaultInjected(m),
    "scanner": lambda m: ScannerException(m),
    "storage": lambda m: StorageException(m),
    "runtime": lambda m: RuntimeError(m),
    "connection": lambda m: ConnectionError(m),
    "timeout": lambda m: TimeoutError(m),
    "oserror": lambda m: OSError(m),
    "unavailable": _unavailable_exc,
    # device memory exhaustion: what util/memstats.is_oom recognizes —
    # a memory.pressure:raise:exc=oom plan forces the OOM-forensics +
    # transient-requeue path deterministically on CPU
    "oom": lambda m: DeviceOutOfMemory(m),
}

_M_FAULTS = _mx.registry().counter(
    "scanner_tpu_faults_injected_total",
    "Faults fired by the chaos-injection registry (util/faults.py), by "
    "injection site and fault mode.  Zero unless a fault plan is armed.",
    labels=["site", "mode"])


@dataclass
class FaultRule:
    """One armed fault: a site, a mode, and a deterministic trigger."""

    site: str
    mode: str
    exc: str = "fault"
    msg: str = "injected fault"
    seconds: float = 0.0
    n: int = 0
    after: int = 0
    every: int = 0
    p: float = 0.0
    seed: int = 0
    times: int = 0
    match: str = ""
    # structured selectors over the "<method>@<peer>" detail the RPC
    # client site passes (match= stays a raw substring): method=
    # selects one RPC method, peer= one remote address — together they
    # model ASYMMETRIC partitions ("calls to THIS peer fail, others
    # succeed") that a plain substring cannot express safely
    method: str = ""
    peer: str = ""
    # runtime state (not part of the spec)
    calls: int = field(default=0, compare=False)
    fired: int = field(default=0, compare=False)
    _rng: Optional[random.Random] = field(default=None, compare=False,
                                          repr=False)

    def __post_init__(self):
        if self.site not in SITES:
            raise FaultPlanError(
                f"unknown fault site {self.site!r} (known: "
                f"{', '.join(SITES)})")
        if self.mode not in MODES:
            raise FaultPlanError(
                f"unknown fault mode {self.mode!r} (known: "
                f"{', '.join(MODES)})")
        if self.mode == "raise" and self.exc not in _EXC:
            raise FaultPlanError(
                f"unknown exc {self.exc!r} (known: "
                f"{', '.join(sorted(_EXC))})")
        if self.mode == "corrupt" and self.site not in DATA_SITES:
            raise FaultPlanError(
                f"corrupt mode needs a data-carrying site "
                f"({', '.join(DATA_SITES)}); {self.site} passes no "
                f"bytes through inject()")
        if self.mode == "duplicate" and self.site not in DUPLICATE_SITES:
            raise FaultPlanError(
                f"duplicate mode needs a duplicating call site "
                f"({', '.join(DUPLICATE_SITES)}); {self.site} never "
                f"asks take_duplicate()")
        if (self.method or self.peer) \
                and self.site not in SELECTOR_SITES:
            raise FaultPlanError(
                f"method=/peer= selectors need a '<method>@<peer>' "
                f"detail site ({', '.join(SELECTOR_SITES)}); "
                f"{self.site} details carry no peer — use match=")
        if self.p:
            self._rng = random.Random(self.seed)

    def should_fire(self, detail: str) -> bool:
        """Trigger decision for one matching call.  Caller holds the
        registry lock, so counter updates and the RNG draw are atomic
        — the draw sequence is deterministic per rule per process."""
        if self.match and self.match not in detail:
            return False
        if self.method or self.peer:
            m, _sep, p = detail.partition("@")
            if self.method and self.method not in m:
                return False
            if self.peer and self.peer not in p:
                return False
        self.calls += 1
        if self.times and self.fired >= self.times:
            return False
        if self.n:
            hit = self.calls == self.n
        elif self.after:
            hit = self.calls > self.after
        elif self.every:
            hit = self.calls % self.every == 0
        elif self.p:
            hit = self._rng.random() < self.p
        else:
            hit = True
        if hit:
            self.fired += 1
        return hit


class _Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._rules: Dict[str, List[FaultRule]] = {}

    def install(self, rules: Sequence[FaultRule]) -> None:
        by_site: Dict[str, List[FaultRule]] = {}
        for r in rules:
            by_site.setdefault(r.site, []).append(r)
        with self._lock:
            self._rules = by_site

    def clear(self) -> None:
        with self._lock:
            self._rules = {}

    def rules(self) -> List[FaultRule]:
        with self._lock:
            return [r for rs in self._rules.values() for r in rs]

    def take_duplicate(self, site: str, detail: str) -> bool:
        """Trigger decision for the duplicate-delivery rules of a site
        — asked by the call site AFTER a successful call, because only
        the site itself can re-issue the request (inject() cannot)."""
        with self._lock:
            hits = [r for r in self._rules.get(site, ())
                    if r.mode == "duplicate" and r.should_fire(detail)]
        for r in hits:
            _M_FAULTS.labels(site=site, mode="duplicate").inc()
            from . import tracing as _tracing
            _tracing.add_event("fault.injected", site=site,
                               mode="duplicate", detail=detail)
            _log.warning("injecting duplicate delivery at %s "
                         "(detail=%r, fire %d)", site, detail, r.fired)
        return bool(hits)

    def fire(self, site: str, data, detail: str):
        with self._lock:
            # duplicate-mode rules are actioned by take_duplicate()
            # at the call site, never here — inject() must not tick
            # their trigger counters
            hits = [r for r in self._rules.get(site, ())
                    if r.mode != "duplicate" and r.should_fire(detail)]
        for i, r in enumerate(hits):
            try:
                _M_FAULTS.labels(site=site, mode=r.mode).inc()
                # the injection lands on the affected task's trace span
                # (when one is active): a chaos run's merged trace shows
                # WHICH task ate the fault, not just that one fired
                from . import tracing as _tracing
                _tracing.add_event("fault.injected", site=site,
                                   mode=r.mode, detail=detail)
                _log.warning("injecting fault at %s: %s (detail=%r, "
                             "fire %d)", site, r.mode, detail, r.fired)
                if r.mode == "delay":
                    time.sleep(r.seconds)
                elif r.mode == "corrupt":
                    data = _corrupt(data)
                elif r.mode == "crash":
                    # immediate process death — the SIGKILL-grade fault
                    # the cluster's stale-worker scan and bulk recovery
                    # exist for.  os._exit skips atexit/finally:
                    # nothing gets a chance to clean up, exactly like a
                    # real crash.
                    os._exit(CRASH_EXIT_CODE)
                else:  # raise
                    raise _EXC[r.exc](
                        f"{r.msg} [site={site} detail={detail!r}]")
            except BaseException:
                # an earlier rule raising aborts this call: later rules
                # were tentatively marked fired by should_fire but never
                # acted — un-mark them so fired()/the metric never claim
                # an injection that didn't happen
                with self._lock:
                    for later in hits[i + 1:]:
                        later.fired -= 1
                raise
        return data


_registry = _Registry()


def _corrupt(data):
    """Flip every bit of one mid-buffer byte — the silent single-byte
    rot that magic/length checks miss and only a checksum catches.
    (Deliberately not the first byte: flipping a magic number is the
    EASY corruption; the crc32c hardening exists for the rest.)
    Empty/non-bytes data passes through."""
    if not isinstance(data, (bytes, bytearray, memoryview)) or not len(data):
        return data
    b = bytearray(data)
    b[len(b) // 2] ^= 0xFF
    return bytes(b)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def parse_plan(spec: str) -> List[FaultRule]:
    """Parse the ';'-joined clause syntax (module docstring) into rules."""
    rules: List[FaultRule] = []
    for clause in spec.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        fields = clause.split(":")
        if len(fields) < 2:
            raise FaultPlanError(
                f"fault clause needs at least site:mode — {clause!r}")
        kw: Dict[str, Union[str, int, float]] = {}
        for f in fields[2:]:
            k, sep, v = f.partition("=")
            if not sep:
                raise FaultPlanError(
                    f"fault clause field {f!r} is not key=value "
                    f"({clause!r})")
            if k in ("n", "after", "every", "times", "seed"):
                kw[k] = int(v)
            elif k in ("p", "seconds"):
                kw[k] = float(v)
            elif k in ("exc", "msg", "match", "method", "peer"):
                kw[k] = v
            else:
                raise FaultPlanError(
                    f"unknown fault clause key {k!r} ({clause!r})")
        rules.append(FaultRule(site=fields[0], mode=fields[1], **kw))
    return rules


def install(plan: Union[str, FaultRule, Sequence[FaultRule]]) -> None:
    """Arm a fault plan (replacing any previous one) and set ACTIVE."""
    global ACTIVE
    if isinstance(plan, str):
        rules = parse_plan(plan)
    elif isinstance(plan, FaultRule):
        rules = [plan]
    else:
        rules = list(plan)
    _registry.install(rules)
    ACTIVE = bool(rules)
    if rules:
        _log.warning("fault plan armed: %d rule(s) across sites %s",
                     len(rules), sorted({r.site for r in rules}))


def clear() -> None:
    """Disarm all faults; hooks return to the single-flag fast path."""
    global ACTIVE
    _registry.clear()
    ACTIVE = False


def inject(site: str, data=None, detail: str = ""):
    """Run the armed rules for `site` against this call.

    Returns `data` (possibly corrupted), raises, sleeps, or kills the
    process per the matching rules.  Hooks should guard the call with
    ``if faults.ACTIVE`` so the disarmed path costs one flag check."""
    if not ACTIVE:
        return data
    return _registry.fire(site, data, detail)


def take_duplicate(site: str, detail: str = "") -> bool:
    """Should this call be delivered a second time?  Asked by sites in
    DUPLICATE_SITES after a successful call — the fault model for
    at-least-once delivery ("partitioned ≠ dead": the first request
    arrived, its reply was lost, the caller repeats)."""
    if not ACTIVE:
        return False
    return _registry.take_duplicate(site, detail)


def fired(site: Optional[str] = None) -> int:
    """Total fault fires (optionally for one site) — the in-process
    twin of scanner_tpu_faults_injected_total, for test assertions."""
    return sum(r.fired for r in _registry.rules()
               if site is None or r.site == site)


def rules() -> List[FaultRule]:
    return _registry.rules()


# canned plans for tools/chaos_run.py and ad-hoc cluster abuse; each
# reproduces one failure class from docs/robustness.md's matrix
NAMED_PLANS = {
    # worker process dies mid-task -> stale scan + task reassignment
    "worker-crash": "pipeline.eval:crash:n=2",
    # worker wedges mid-eval while its heartbeat stays live ->
    # task_timeout revocation, not stale removal
    "worker-hang": "pipeline.eval:delay:seconds=8:n=1",
    # sink item write fails transiently -> requeue without a
    # blacklist strike
    "sink-write-fail":
        "storage.write:raise:exc=storage:msg=injected sink "
        "failure:match=output_:n=2:times=1",
    # stored item bytes flip -> crc32c detection at read -> retry
    "read-corrupt": "storage.read:corrupt:match=tables/:n=1:times=1",
    # RPC plane UNAVAILABLE storm -> client backoff rides it out
    "unavailable-storm":
        "rpc.client.call:raise:exc=unavailable:p=0.5:seed=7:times=40",
    # master dies handling a completion -> restart + _recover_bulk
    "master-crash": "rpc.server.handle:crash:match=FinishedWork:n=4",
    # every heartbeat after the first is dropped -> stale-worker removal
    "heartbeat-drop": "worker.heartbeat:raise:after=1",
    # device HBM exhausted during h2d staging -> one-shot memory report
    # (top ledger entries with owning task/trace), staged buffers freed,
    # strike-free transient requeue, bit-exact completion
    "memory-pressure": "memory.pressure:raise:exc=oom:n=1:times=1",
    # spot reclaim notice on the armed worker's 2nd heartbeat ->
    # Worker.preempt(): master fences assignment from the notice,
    # in-flight tasks drain, leftovers requeue strike-free, siblings
    # re-absorb the work (chaos_run arms ONE of N workers, so N=3 is
    # the headline "preempt ~30% of workers mid-bulk" plan)
    "worker-preempt": "worker.preempt:raise:n=2:times=1",
    # the headline control-plane drill (docs/robustness.md §Durable
    # control plane): the master is killed handling a FinishedWork
    # mid-bulk AND the client's NewJob is delivered twice (ambiguous-
    # timeout retry).  The successor must recover via checkpoint +
    # journal replay with zero acknowledged completions lost, the
    # duplicate admission must dedupe on the token, and chaos_run
    # additionally spawns a forced-stale master and asserts it is
    # fenced with zero accepted mutations.
    "master-failover":
        "rpc.server.handle:crash:match=FinishedWork:n=4;"
        "rpc.client.call:duplicate:method=NewJob:n=1:times=1",
    # the sharded-control-plane drill (docs/robustness.md §Sharded
    # control plane): one of three master shards is SIGKILLed while it
    # handles a FinishedWork mid-bulk — the fault arms in every shard
    # process, but only the shard that owns the bulk ever handles
    # completions, so exactly the bulk-owning shard dies.  chaos_run
    # respawns that shard (same shard id + port, no plan): the respawn
    # CAS-claims the next generation IN ITS SHARD'S NAMESPACE, replays
    # its journal (failover replay > 0, zero re-executed journaled
    # tasks), re-publishes the shard map at a bumped epoch, and the
    # bulk completes bit-exact with zero strikes while the SURVIVING
    # shards' health roll-ups never leave ok/degraded.
    "master-shard-loss":
        "rpc.server.handle:crash:match=FinishedWork:n=4",
    # the gang drill (docs/robustness.md §Gang scheduling): the armed
    # worker dies the moment its first gang member enters the
    # cross-host collective (the runner dies with it via pdeathsig) ->
    # the gang aborts on member loss, the epoch bumps, and the task
    # re-forms on the surviving workers with zero blacklist strikes.
    # Gangs evaluate SHARDED by default (engine/gang.py _sharded_body),
    # so the member dies mid-collective holding undelivered shard rows
    # and the re-formed smaller mesh recomputes shard_range from
    # scratch; chaos_run.py runs a gang_hosts bulk under this plan and
    # requires bit-exact output, a reform at epoch+1, and zero non-ok
    # shard commit folds
    "gang-host-loss": "gang.collective:crash:n=1:times=1",
}


# spawned subprocesses (tests/spawn_worker.py, deploy manifests) arm
# themselves from the environment before serving anything
_env_plan = os.environ.get("SCANNER_TPU_FAULTS", "")
if _env_plan:
    install(_env_plan)
