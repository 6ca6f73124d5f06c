"""Abstract Master/Worker/Journal protocol model (`torch-model`).

A small state machine mirroring the control-plane protocol of
engine/{service,journal,shardmap}.py at the granularity its safety
story lives:

  * storage — a CAS generation cell (`claim_generation`), one journal
    segment per generation (appends by a superseded master land in its
    own dead segment), and a shard-map epoch cell;
  * masters — generation, a fence flag that LAGS the CAS (the
    `_check_fence` poll), volatile done/committed state, recovery that
    snapshots the predecessor's segment at takeover;
  * worker — pulls assignments, executes, reports `FinishedWork`,
    retries on reply loss (the RPC is idempotent=False — the master's
    done-set membership check is what makes the retry safe), latches
    generations monotonically.

`tools/torch_model.py` explores every interleaving of the enabled
transitions (bounded BFS, analysis/model/explorer.py) and asserts the
three invariants the chaos drills sample dynamically
(docs/robustness.md):

  I1 write-ahead — at every reachable state, every acked completion
     (and the job-commit ack) has a journal record: `_journal_append`
     before the ack, on every path (torch-check SC401).
  I2 no double-apply — the surviving journal lineage (takeover
     snapshot + the survivor's own segment) holds at most one done
     record per task and one commit record per job: the done-set
     dedup guard absorbs non-idempotent retries (SC402/SC312).
  I3 fencing — no record is authored by a master after it observed
     the fence, the claimed generation/map epoch only grow, and the
     shard map is owned by the surviving generation (SC403).

Transitions are anchored to RPC_CONTRACTS (engine/service.py) via
RPC_ANCHORS; torch-check SC406 pins the two in sync both directions
so this model cannot rot away from the source.

`broken=` injects the defects the invariants exist to catch —
``ack_before_commit`` (ack outruns the group-commit; a crash between
them loses an acked completion), ``skip_dedup`` (retry of the
non-idempotent FinishedWork applies twice), ``ignore_fence`` (a
fenced master keeps mutating).  The explorer must find each with a
minimal counterexample schedule; tests/test_torch_model.py pins it.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, FrozenSet, List, Optional, Tuple

__all__ = ["RPC_ANCHORS", "Config", "State", "scenario", "SCENARIOS",
           "enabled", "invariants", "lineage", "Record"]

# model transition (the `t_<name>` functions below) -> RPC_CONTRACTS
# entry.  scanner-check SC406: every value must be a declared contract,
# every idempotent=False contract must appear here, and every key must
# name a defined transition.
RPC_ANCHORS = {
    "register_worker":   "RegisterWorker",
    "new_job":           "NewJob",
    "next_work":         "NextWork",
    "started_work":      "StartedWork",
    "finished_work":     "FinishedWork",
    "finished_batch":    "FinishedWorkBatch",
    "failed_work":       "FailedWork",
    "post_profile":      "PostProfile",
    "ship_spans":        "ShipSpans",
    "ship_memory":       "ShipMemoryReport",
    "gang_member_done":  "GangMemberDone",
    "gang_failed":       "GangFailed",
}

# journal record: (type, payload, author_gen, author_saw_fence)
Record = Tuple[str, object, int, bool]


@dataclass(frozen=True)
class MasterState:
    gen: int
    alive: bool = True
    fence_seen: bool = False
    recovered: bool = True       # False between claim and replay
    snapshot: Tuple[Record, ...] = ()   # predecessor records adopted
    done: FrozenSet[int] = frozenset()
    committed: bool = False
    admitted: bool = False
    telemetry: FrozenSet[str] = frozenset()   # volatile, once per kind
    gang_epoch: int = 0
    gang_acks: FrozenSet[int] = frozenset()
    pending: Tuple[Record, ...] = ()   # broken ack_before_commit only


@dataclass(frozen=True)
class State:
    storage_gen: int
    map_epoch: int
    map_owner: int                      # index into masters
    journals: Tuple[Tuple[Record, ...], ...]   # per generation, 1-based
    masters: Tuple[MasterState, ...]
    registered: bool = False
    # worker assignment: task -> (attempt, reported_failed)
    holding: Tuple[Tuple[int, int], ...] = ()
    acked: FrozenSet[int] = frozenset()
    commit_acked: bool = False
    executions: FrozenSet[Tuple[int, int]] = frozenset()  # (task, attempt)
    retries_left: int = 1
    strikes: FrozenSet[int] = frozenset()


@dataclass(frozen=True)
class Config:
    tasks: int = 1
    masters: int = 1
    failover: bool = False       # second master may claim + recover
    crash: bool = False          # first master may crash + restart
    gang: bool = False           # gang epoch fence transitions
    telemetry: bool = False      # PostProfile/ShipSpans/ShipMemoryReport
    batch: bool = False          # FinishedWorkBatch coalescing
    fail: bool = False           # FailedWork strike path
    retries: int = 1
    # reassignment bound: during the failover overlap a reassign/
    # dedup-absorb cycle (new master assigns, old unfenced master
    # absorbs the report) can repeat until the fence poll lands — real
    # and safe, but unbounded; capping attempts keeps the enumeration
    # exhaustive without hiding any distinct behavior
    max_attempts: int = 3
    # injected defects (tests/test_torch_model.py)
    ack_before_commit: bool = False
    skip_dedup: bool = False
    ignore_fence: bool = False


SCENARIOS: Dict[str, Config] = {
    # single master, crash between any two transitions, restart replays
    # its own journal — the write-ahead (I1) and dedup (I2) kernel
    "crash": Config(tasks=2, masters=1, crash=True, retries=1,
                    fail=True),
    # two masters racing a generation bump: CAS claim, lagging fence
    # poll, takeover snapshot, worker retries — I1 + I2 + I3
    "failover": Config(tasks=1, masters=2, failover=True, retries=1),
    # gang epoch fence: member acks race an abort's epoch bump — a
    # stale-epoch report must never be applied
    "gang": Config(tasks=1, masters=1, gang=True, retries=1),
    # the batch/telemetry/strike surface on one master, no faults —
    # covers the remaining non-idempotent anchors exhaustively
    "surface": Config(tasks=2, masters=1, batch=True, telemetry=True,
                      fail=True, retries=1),
}


def scenario(name: str, broken: Optional[str] = None) -> "tuple[Config, State]":
    cfg = SCENARIOS[name]
    if broken is not None:
        if broken not in ("ack_before_commit", "skip_dedup",
                          "ignore_fence"):
            raise ValueError(f"unknown injected defect: {broken}")
        cfg = replace(cfg, **{broken: True})
    masters = [MasterState(gen=1)]
    for extra in range(1, cfg.masters):
        masters.append(MasterState(gen=1 + extra, alive=False,
                                   recovered=False))
    return cfg, State(
        storage_gen=1, map_epoch=1, map_owner=0,
        journals=tuple(() for _ in range(cfg.masters)),
        masters=tuple(masters), retries_left=cfg.retries)


# -- helpers ---------------------------------------------------------------


def _with_master(s: State, i: int, m: MasterState) -> State:
    ms = list(s.masters)
    ms[i] = m
    return replace(s, masters=tuple(ms))


def _append(s: State, i: int, rec_type: str, payload: object) -> State:
    """Group-commit one record to master i's own segment — mirrors
    `_journal_append`: a master that has SEEN the fence journals
    nothing (ignore_fence drops that guard)."""
    m = s.masters[i]
    rec: Record = (rec_type, payload, m.gen, m.fence_seen)
    js = list(s.journals)
    js[m.gen - 1] = js[m.gen - 1] + (rec,)
    return replace(s, journals=tuple(js))


def _live(s: State, cfg: Config, i: int) -> bool:
    m = s.masters[i]
    return m.alive and m.recovered


def _handler_gate(s: State, cfg: Config, i: int) -> bool:
    """The `_fenced` wrapper: a master that observed the fence NACKs
    every mutation (ignore_fence models losing the guard)."""
    m = s.masters[i]
    if m.fence_seen and not cfg.ignore_fence:
        return False
    return True


def lineage(s: State) -> Tuple[Record, ...]:
    """The surviving journal as recovery reads it: the survivor's
    takeover snapshot plus its own segment."""
    surv = max(range(len(s.masters)),
               key=lambda i: s.masters[i].gen
               if s.masters[i].gen <= s.storage_gen else -1)
    m = s.masters[surv]
    return m.snapshot + s.journals[m.gen - 1]


# -- transitions -----------------------------------------------------------
#
# each t_<name>(s, cfg) returns [(detail, next_state), ...] — every
# enabled instantiation.  Names are pinned to RPC_ANCHORS (SC406);
# internal (non-RPC) steps carry no anchor.


def t_register_worker(s: State, cfg: Config):
    if s.registered:
        return []
    out = []
    for i in range(len(s.masters)):
        if _live(s, cfg, i) and _handler_gate(s, cfg, i):
            out.append((f"worker registers with m{i}",
                        replace(s, registered=True)))
    return out


def t_new_job(s: State, cfg: Config):
    out = []
    for i in range(len(s.masters)):
        m = s.masters[i]
        if not _live(s, cfg, i) or m.admitted \
                or not _handler_gate(s, cfg, i):
            continue
        ns = _append(s, i, "admit", None)
        out.append((f"m{i} admits the bulk (journal reset + admit "
                    "record)",
                    _with_master(ns, i, replace(m, admitted=True))))
    return out


def t_next_work(s: State, cfg: Config):
    if not s.registered:
        return []
    out = []
    held = dict(s.holding)
    for i in range(len(s.masters)):
        m = s.masters[i]
        if not _live(s, cfg, i) or not m.admitted \
                or not _handler_gate(s, cfg, i):
            continue
        for task in range(cfg.tasks):
            if task in m.done or task in held:
                continue
            attempt = max([a for t, a in s.executions if t == task],
                          default=0) + 1
            if attempt > cfg.max_attempts:
                continue
            out.append((f"m{i} assigns task {task} (attempt {attempt})",
                        replace(s, holding=tuple(sorted(
                            list(s.holding) + [(task, attempt)])))))
    return out


def t_started_work(s: State, cfg: Config):
    # lease bookkeeping is volatile; modeled as a no-op ack so the
    # anchor exists — a fenced master still NACKs it
    return []


def _apply_finished(s: State, cfg: Config, i: int, task: int,
                    attempt: int) -> List[Tuple[str, State]]:
    """FinishedWork handler body: dedup -> journal -> apply -> ack,
    with the injected-defect orderings."""
    m = s.masters[i]
    executed = replace(
        s, executions=s.executions | {(task, attempt)})
    if task in m.done and not cfg.skip_dedup:
        # duplicate (retry) absorbed by done-set membership: ack
        # without a second apply
        ns = replace(executed,
                     holding=tuple((t, a) for t, a in s.holding
                                   if t != task),
                     acked=s.acked | {task})
        return [(f"m{i} absorbs duplicate task {task}", ns)]
    if cfg.ack_before_commit:
        # INJECTED DEFECT: ack first, group-commit later (t_flush) —
        # a crash in between loses an acked completion
        ns = _with_master(executed, i,
                          replace(m, done=m.done | {task},
                                  pending=m.pending
                                  + (("done", task, m.gen,
                                      m.fence_seen),)))
        ns = replace(ns,
                     holding=tuple((t, a) for t, a in ns.holding
                                   if t != task),
                     acked=ns.acked | {task})
        return [(f"m{i} ACKS task {task} before the commit", ns)]
    ns = _append(executed, i, "done", task)
    ns = _with_master(ns, i, replace(m, done=m.done | {task}))
    acked = replace(ns,
                    holding=tuple((t, a) for t, a in ns.holding
                                  if t != task),
                    acked=ns.acked | {task})
    out = [(f"m{i} commits+acks task {task}", acked)]
    if s.retries_left > 0:
        # reply lost after the apply: the worker still holds the task
        # and will retry the (non-idempotent) RPC
        lost = replace(ns, retries_left=s.retries_left - 1)
        out.append((f"m{i} commits task {task} but the ack is lost "
                    "(worker will retry)", lost))
    return out


def t_finished_work(s: State, cfg: Config):
    out = []
    for i in range(len(s.masters)):
        if not _live(s, cfg, i) or not s.masters[i].admitted \
                or not _handler_gate(s, cfg, i):
            continue
        for task, attempt in s.holding:
            out.extend(_apply_finished(s, cfg, i, task, attempt))
    return out


def t_finished_batch(s: State, cfg: Config):
    """Coalesced completion (FinishedWorkBatch): every held task lands
    in ONE group-commit, then all are acked."""
    if not cfg.batch or len(s.holding) < 2:
        return []
    out = []
    for i in range(len(s.masters)):
        m = s.masters[i]
        if not _live(s, cfg, i) or not m.admitted \
                or not _handler_gate(s, cfg, i):
            continue
        ns = s
        fresh = []
        for task, attempt in s.holding:
            ns = replace(ns, executions=ns.executions
                         | {(task, attempt)})
            if task not in m.done or cfg.skip_dedup:
                fresh.append(task)
                ns = _append(ns, i, "done", task)
        m2 = replace(ns.masters[i], done=m.done | set(fresh))
        ns = _with_master(ns, i, m2)
        ns = replace(ns, holding=(),
                     acked=ns.acked | {t for t, _a in s.holding})
        out.append((f"m{i} batch-commits tasks "
                    f"{sorted(t for t, _a in s.holding)}", ns))
    return out


def t_failed_work(s: State, cfg: Config):
    if not cfg.fail:
        return []
    out = []
    for i in range(len(s.masters)):
        if not _live(s, cfg, i) or not s.masters[i].admitted \
                or not _handler_gate(s, cfg, i):
            continue
        for task, attempt in s.holding:
            if task in s.strikes:
                continue  # one strike per task bounds the space
            ns = _append(s, i, "strike", task)
            ns = replace(ns,
                         holding=tuple((t, a) for t, a in s.holding
                                       if t != task),
                         strikes=ns.strikes | {task},
                         executions=ns.executions | {(task, attempt)})
            out.append((f"m{i} journals a strike for task {task} "
                        "(requeued)", ns))
    return out


def _telemetry(s: State, cfg: Config, kind: str):
    if not cfg.telemetry:
        return []
    out = []
    for i in range(len(s.masters)):
        m = s.masters[i]
        if not _live(s, cfg, i) or kind in m.telemetry \
                or not _handler_gate(s, cfg, i):
            continue
        out.append((f"m{i} accepts {kind}",
                    _with_master(s, i, replace(
                        m, telemetry=m.telemetry | {kind}))))
    return out


def t_post_profile(s: State, cfg: Config):
    return _telemetry(s, cfg, "profile")


def t_ship_spans(s: State, cfg: Config):
    return _telemetry(s, cfg, "spans")


def t_ship_memory(s: State, cfg: Config):
    return _telemetry(s, cfg, "memory")


def t_gang_member_done(s: State, cfg: Config):
    """Member ack stamped with an epoch: the handler applies it only
    at the LIVE epoch (exact match — `_gang_for_req_locked`), so a
    pre-abort straggler can never land."""
    if not cfg.gang:
        return []
    out = []
    for i in range(len(s.masters)):
        m = s.masters[i]
        if not _live(s, cfg, i) or not _handler_gate(s, cfg, i):
            continue
        for stamped in range(m.gang_epoch + 1):
            if stamped in m.gang_acks:
                continue
            if stamped != m.gang_epoch and not cfg.ignore_fence:
                out.append((f"m{i} NACKs stale gang ack "
                            f"(epoch {stamped} != {m.gang_epoch})", s))
                continue
            # payload records (stamped, live-at-apply): I3 flags any
            # apply where the two differ — a stale straggler landing
            ns = _append(s, i, "gang", (stamped, m.gang_epoch))
            out.append((f"m{i} applies gang ack at epoch {stamped}",
                        _with_master(ns, i, replace(
                            m, gang_acks=m.gang_acks | {stamped}))))
    return out


def t_gang_failed(s: State, cfg: Config):
    if not cfg.gang:
        return []
    out = []
    for i in range(len(s.masters)):
        m = s.masters[i]
        if not _live(s, cfg, i) or not _handler_gate(s, cfg, i) \
                or m.gang_epoch >= 1:
            continue  # one abort bounds the space
        ns = _append(s, i, "gang_abort", m.gang_epoch)
        out.append((f"m{i} aborts the gang (epoch "
                    f"{m.gang_epoch} -> {m.gang_epoch + 1})",
                    _with_master(ns, i, replace(
                        m, gang_epoch=m.gang_epoch + 1))))
    return out


# -- internal (non-RPC) steps ---------------------------------------------


def i_flush_pending(s: State, cfg: Config):
    """The delayed group-commit of the ack_before_commit defect."""
    out = []
    for i in range(len(s.masters)):
        m = s.masters[i]
        if not m.alive or not m.pending:
            continue
        js = list(s.journals)
        js[m.gen - 1] = js[m.gen - 1] + m.pending
        ns = replace(s, journals=tuple(js))
        out.append((f"m{i} flushes its pending journal records",
                    _with_master(ns, i, replace(m, pending=()))))
    return out


def i_claim(s: State, cfg: Config):
    """Successor CAS-claims the next generation and bumps the shard
    map epoch (claim_generation + ShardMap.publish) — the predecessor
    keeps running until its fence poll."""
    if not cfg.failover:
        return []
    out = []
    for i in range(len(s.masters)):
        m = s.masters[i]
        if m.alive or m.gen != s.storage_gen + 1:
            continue
        out.append((f"m{i} claims generation {m.gen} (CAS) and "
                    "publishes the shard map",
                    replace(_with_master(s, i, replace(m, alive=True)),
                            storage_gen=m.gen,
                            map_epoch=s.map_epoch + 1, map_owner=i)))
    return out


def i_recover(s: State, cfg: Config):
    """Takeover replay: snapshot the predecessor's segment as of NOW
    and fold it (idempotent by construction — _apply_journal_records);
    records the predecessor appends later land in a dead segment."""
    out = []
    for i in range(len(s.masters)):
        m = s.masters[i]
        if not m.alive or m.recovered or m.gen != s.storage_gen:
            continue
        snap = ()
        for g in range(m.gen - 1, 0, -1):
            if s.journals[g - 1]:
                snap = s.journals[g - 1]
                break
        done = frozenset(p for t, p, _g, _f in snap if t == "done")
        admitted = any(t == "admit" for t, _p, _g, _f in snap)
        committed = any(t == "commit" for t, _p, _g, _f in snap)
        out.append((f"m{i} recovers: replays {len(snap)} predecessor "
                    "records",
                    _with_master(s, i, replace(
                        m, recovered=True, snapshot=snap, done=done,
                        admitted=admitted or m.admitted,
                        committed=committed))))
    return out


def i_poll_fence(s: State, cfg: Config):
    """_check_fence: a predecessor eventually observes the claim."""
    out = []
    for i in range(len(s.masters)):
        m = s.masters[i]
        if m.alive and not m.fence_seen and m.gen < s.storage_gen:
            out.append((f"m{i} polls storage and observes the fence "
                        f"(generation {s.storage_gen} claimed)",
                        _with_master(s, i, replace(
                            m, fence_seen=True))))
    return out


def i_crash(s: State, cfg: Config):
    if not cfg.crash:
        return []
    out = []
    for i in range(len(s.masters)):
        m = s.masters[i]
        if m.alive and m.gen == s.storage_gen and m.admitted:
            out.append((f"m{i} CRASHES (volatile state wiped)",
                        _with_master(s, i, replace(
                            m, alive=False, recovered=False, pending=(),
                            done=frozenset(), committed=False,
                            telemetry=frozenset()))))
    return out


def i_restart(s: State, cfg: Config):
    if not cfg.crash:
        return []
    out = []
    for i in range(len(s.masters)):
        m = s.masters[i]
        if m.alive or m.gen != s.storage_gen:
            continue
        seg = s.journals[m.gen - 1]
        done = frozenset(p for t, p, _g, _f in seg if t == "done")
        out.append((f"m{i} restarts: replays its own journal "
                    f"({len(seg)} records)",
                    _with_master(s, i, replace(
                        m, alive=True, recovered=True, done=done,
                        admitted=any(t == "admit"
                                     for t, _p, _g, _f in seg),
                        committed=any(t == "commit"
                                      for t, _p, _g, _f in seg)))))
    return out


def i_commit_job(s: State, cfg: Config):
    """_maybe_finish_job: all tasks done -> journal the commit record,
    then the completion becomes client-visible (commit_acked)."""
    out = []
    for i in range(len(s.masters)):
        m = s.masters[i]
        if not _live(s, cfg, i) or not m.admitted or m.committed \
                or not _handler_gate(s, cfg, i):
            continue
        if len(m.done) != cfg.tasks:
            continue
        if cfg.ack_before_commit:
            ns = _with_master(s, i, replace(
                m, committed=True,
                pending=m.pending + (("commit", None, m.gen,
                                      m.fence_seen),)))
            out.append((f"m{i} ACKS the job commit before journaling "
                        "it", replace(ns, commit_acked=True)))
            continue
        ns = _append(s, i, "commit", None)
        ns = _with_master(ns, i, replace(m, committed=True))
        out.append((f"m{i} journals the job commit and publishes "
                    "completion", replace(ns, commit_acked=True)))
    return out


_TRANSITIONS = [
    t_register_worker, t_new_job, t_next_work, t_started_work,
    t_finished_work, t_finished_batch, t_failed_work,
    t_post_profile, t_ship_spans, t_ship_memory,
    t_gang_member_done, t_gang_failed,
    i_flush_pending, i_claim, i_recover, i_poll_fence,
    i_crash, i_restart, i_commit_job,
]


def enabled(s: State, cfg: Config) -> List[Tuple[str, State]]:
    """Every enabled (label, successor) pair — the explorer's branch
    set.  Self-loops (NACK replies) are dropped: they change nothing
    and would make every schedule infinite."""
    out: List[Tuple[str, State]] = []
    for t in _TRANSITIONS:
        for label, ns in t(s, cfg):
            if ns != s:
                out.append((label, ns))
    return out


# -- invariants ------------------------------------------------------------


def _journaled(s: State, rec_type: str, payload: object) -> bool:
    # pending (un-flushed) records do NOT count: a crash wipes them
    for seg in s.journals:
        for t, p, _g, _f in seg:
            if t == rec_type and p == payload:
                return True
    return False


def inv_write_ahead(s: State, cfg: Config) -> Optional[str]:
    """I1: an acked completion is never lost — the journal record must
    exist at the instant of the ack (`_journal_append` docstring)."""
    for task in sorted(s.acked):
        if not _journaled(s, "done", task):
            return (f"task {task} was ACKED but no done-record is in "
                    "any journal — a crash here loses an acked "
                    "completion (write-ahead violated)")
    if s.commit_acked and not _journaled(s, "commit", None):
        return ("the job commit was published but no commit record "
                "is journaled — a crash here un-finishes a finished "
                "job")
    return None


def inv_no_double_apply(s: State, cfg: Config) -> Optional[str]:
    """I2: the surviving lineage applies each record once."""
    lin = lineage(s)
    done_seen = set()
    commits = 0
    for t, p, _g, _f in lin:
        if t == "done":
            if p in done_seen:
                return (f"task {p} has TWO done-records in the "
                        "surviving journal lineage — a retried "
                        "non-idempotent FinishedWork was applied "
                        "twice (dedup guard lost)")
            done_seen.add(p)
        elif t == "commit":
            commits += 1
            if commits > 1:
                return ("two commit records in the surviving "
                        "lineage — the job double-committed")
    return None


def inv_fencing(s: State, cfg: Config) -> Optional[str]:
    """I3: no mutation by a master that observed the fence; claimed
    generation and map epoch only grow; the survivor owns the map."""
    for seg in s.journals:
        for t, p, g, fenced in seg:
            if fenced:
                return (f"a `{t}` record was journaled by generation "
                        f"{g} AFTER it observed the fence — a "
                        "superseded master kept mutating")
            if t == "gang" and p[0] != p[1]:
                return (f"a gang ack stamped epoch {p[0]} was applied "
                        f"at live epoch {p[1]} — a pre-abort "
                        "straggler landed past the epoch fence")
    for i, m in enumerate(s.masters):
        if m.fence_seen and m.gen >= s.storage_gen:
            return (f"m{i} observed a fence for its own live "
                    "generation — the CAS cell went backwards")
    surv = max((m.gen, i) for i, m in enumerate(s.masters)
               if m.gen <= s.storage_gen)[1]
    if s.masters[surv].alive and s.masters[surv].recovered \
            and s.map_owner != surv and s.storage_gen > 1:
        return (f"the shard map is owned by m{s.map_owner} but "
                f"generation {s.storage_gen} (m{surv}) survived — a "
                "stale publish landed")
    return None


def invariants(cfg: Config):
    return [("I1-write-ahead", inv_write_ahead),
            ("I2-no-double-apply", inv_no_double_apply),
            ("I3-fencing", inv_fencing)]
