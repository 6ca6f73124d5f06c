"""Durability & fencing data-flow passes (SC401–SC406).

The write-ahead journal, generation/epoch fencing, and shard-map CAS
(engine/{service,journal,shardmap}.py) carry the paper's fault-
tolerance promise, and their invariants are *semantic*: journal before
ack, fence before mutate, monotone staleness checks, replay arms for
every record type.  Chaos drills sample these dynamically; this pass
family checks them on every run of torch-check, using the
interprocedural layer in core.py (CallGraph + PathSimulator):

  SC401  write-ahead discipline — a master RPC handler that creates a
         journal-intent record (`recs.append({"t": ...})`) or mutates
         replayed durable state must reach `_journal_append`/group-
         commit on every path before its ack (return).  Returns inside
         ``try`` bodies flow through ``finally`` first, so the
         journal-in-finally idiom is clean.
  SC402  path-sensitive fence coverage — durable-state mutations
         reachable from an *unfenced* entry point (handler registered
         without `self._fenced(...)`, or a background-thread target)
         with no fence consultation anywhere on the path.  SC312/313
         only audit registration wrapping; this follows the helpers.
  SC403  epoch/generation staleness discipline — a function that
         mutates durable/latch state and reads a stamped message field
         (`gen`/`generation`/`epoch`/`map_epoch`) must validate it
         with a CAS or a monotone (<, <=, >, >=) comparison — raw
         ==/!= equality, or no check at all, is flagged.  Passing the
         stamped dict (or the stamp) to a callee counts as delegation.
  SC404  journal-record round-trip — every record type appended
         (`{"t": <const>}`) must have a replay arm (a comparison
         against the record's ``t`` field) and appear in RECORD_TYPES,
         and vice versa, so recovery can never meet a record it does
         not understand (or keep a dead arm).
  SC405  no lock held across group-commit/collective waits — sharpens
         SC202: a call that (transitively) reaches `_journal_append`
         or a collective barrier while a `threading.Lock`-family
         attribute is held stalls every heartbeat behind storage.
  SC406  model anchoring — analysis/model/protocol.py (the bounded-
         interleaving protocol model run by tools/torch_model.py)
         must anchor every transition to an RPC_CONTRACTS entry and
         cover every idempotent=False contract, both directions, so
         the model cannot rot away from the source.

Suppression/baseline semantics are the framework's
(docs/static-analysis.md); deliberate sites carry inline
justifications, genuine violations get fixed.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core import (AnalysisPass, CallGraph, Finding, ModuleInfo,
                   PathSimulator, Project)
from .tracer import dotted_name
from .contracts import ContractPass, _const_str, _module_tuple

__all__ = ["DurabilityPass"]

# message fields that stamp a request/reply with an ordering token
_STAMP_KEYS = frozenset({"gen", "generation", "epoch", "map_epoch"})
# attributes journal replay (_apply_journal_records) restores — the
# durable-state surface the write-ahead contract covers
_DURABLE_ATTRS = frozenset({
    "done", "failures", "transient_failures", "blacklisted_jobs",
    "committed_jobs", "next_gang_id", "gang_epoch",
})
_SET_MUTATORS = frozenset({"add", "append", "update", "discard",
                           "remove", "pop", "clear"})
_CAS_NAMES = frozenset({"try_claim", "claim_generation",
                        "write_exclusive"})
# consulting any of these means the method participates in the fence
# protocol (SC402 credit): _journal_append itself checks
# self._fence.is_set() before any durable write
_FENCE_ATTRS = frozenset({"_fence", "_check_fence", "_fenced",
                          "_fence_out"})
_COLLECTIVE_WAITS = frozenset({"_collective_digest_sum",
                               "_all_gather_bytes", "all_gather",
                               "psum", "all_reduce", "barrier"})
_LOCK_CTORS = frozenset({"Lock", "RLock", "Condition", "Semaphore",
                         "BoundedSemaphore"})

# effect-summary lattice for SC401 (what calling a method does to the
# caller's pending-journal state)
_EFFECT_NONE = "none"
_EFFECT_DIRTY = "dirty"    # leaves journal-intent/durable dirt pending
_EFFECT_FLUSH = "flush"    # group-commits (clears pending dirt)


def _last_name(node: Optional[ast.AST]) -> str:
    return (dotted_name(node) or "").split(".")[-1]


def _intent_type(node: ast.AST) -> Optional[str]:
    """Record type of a journal-intent dict literal
    (``{"t": "done", ...}``), else None."""
    if isinstance(node, ast.Dict):
        for k, v in zip(node.keys, node.values):
            if _const_str(k) == "t" and isinstance(v, ast.Constant) \
                    and isinstance(v.value, str):
                return v.value
    return None


def _is_journal_flush(call: ast.Call) -> bool:
    """A direct group-commit: ``self._journal_append(...)`` (bare or
    attribute) or ``<x>._journal.append(...)``."""
    name = _last_name(call.func)
    if name == "_journal_append":
        return True
    if isinstance(call.func, ast.Attribute) and call.func.attr == "append":
        recv = _last_name(call.func.value)
        return recv in ("_journal", "journal")
    return False


def _registrations(mod: ModuleInfo) -> Dict[str, Tuple[bool, str, ast.AST]]:
    """{rpc_name: (fenced, handler_method_attr, key_node)} from the
    RpcServer(MASTER_SERVICE, {...}) registration — like contracts'
    `_master_registrations` but resolving the handler *method name*
    (through the `self._fenced(...)` wrapper) so the durability passes
    can analyze handler bodies."""
    out: Dict[str, Tuple[bool, str, ast.AST]] = {}
    for node in ast.walk(mod.tree):
        if not (isinstance(node, ast.Call)
                and _last_name(node.func) == "RpcServer"
                and len(node.args) >= 2
                and isinstance(node.args[1], ast.Dict)):
            continue
        if _last_name(node.args[0]) != "MASTER_SERVICE":
            continue
        for k, v in zip(node.args[1].keys, node.args[1].values):
            rpc = _const_str(k)
            if rpc is None:
                continue
            fenced = False
            if isinstance(v, ast.Call) and _last_name(v.func) == "_fenced" \
                    and v.args:
                fenced = True
                v = v.args[0]
            method = _last_name(v)
            if method:
                out[rpc] = (fenced, method, k)
    return out


def _thread_targets(cls: ast.ClassDef) -> Set[str]:
    """Method names handed to ``threading.Thread(target=self.X)``
    anywhere in the class — background entry points the fence audit
    must follow."""
    out: Set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Call) and _last_name(node.func) == "Thread":
            for kw in node.keywords:
                if kw.arg == "target" and isinstance(kw.value,
                                                     ast.Attribute) \
                        and isinstance(kw.value.value, ast.Name) \
                        and kw.value.value.id == "self":
                    out.add(kw.value.attr)
    return out


class _EffectWalk:
    """Collects journal-relevant events of one statement in (approx)
    source order: ("dirty", node) for intent-record creation / durable
    mutation, ("flush", node) for group-commit, resolving one-level
    self-calls through `summaries` (the CallGraph fixpoint)."""

    def __init__(self, summaries: Dict[str, str]):
        self.summaries = summaries
        self.events: List[Tuple[str, ast.AST]] = []

    def collect(self, stmt: ast.AST) -> List[Tuple[str, ast.AST]]:
        self.events = []
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            # the simulator walks the body statement-by-statement;
            # only the context expressions belong to the With itself
            for item in stmt.items:
                self._visit(item.context_expr)
        else:
            self._visit(stmt)
        return self.events

    def _visit(self, node: ast.AST) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return
        if isinstance(node, ast.Call):
            if _is_journal_flush(node):
                # the intent dicts in its args are consumed by the
                # commit, not separate pending dirt
                self.events.append(("flush", node))
                return
            func = node.func
            if isinstance(func, ast.Attribute):
                if func.attr == "append" and len(node.args) == 1 \
                        and _intent_type(node.args[0]) is not None:
                    self.events.append(("dirty", node))
                    return
                if func.attr in _SET_MUTATORS \
                        and _last_name(func.value) in _DURABLE_ATTRS:
                    self.events.append(("dirty", node))
                    return
                if isinstance(func.value, ast.Name) \
                        and func.value.id == "self":
                    eff = self.summaries.get(func.attr, _EFFECT_NONE)
                    if eff == _EFFECT_FLUSH:
                        self.events.append(("flush", node))
                    elif eff == _EFFECT_DIRTY:
                        self.events.append(("dirty", node))
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                attr = None
                if isinstance(t, ast.Attribute):
                    attr = t.attr
                elif isinstance(t, ast.Subscript) \
                        and isinstance(t.value, ast.Attribute):
                    attr = t.value.attr
                if attr in _DURABLE_ATTRS:
                    self.events.append(("dirty", t))
        for child in ast.iter_child_nodes(node):
            self._visit(child)


class _WriteAheadSim(PathSimulator):
    """SC401 path walker.  State = (dirty, flushed):
    dirty — some path holds journal intent / durable mutation not yet
    group-committed; flushed — every path performed a commit."""

    def __init__(self, summaries: Dict[str, str]):
        self._walk = _EffectWalk(summaries)
        self.exit_state: Optional[Tuple[bool, bool]] = None
        self.dirty_exits: List[ast.AST] = []

    def initial(self):
        return (False, False)

    def join(self, a, b):
        return (a[0] or b[0], a[1] and b[1])

    def transfer(self, state, stmt):
        dirty, flushed = state
        for kind, _node in self._walk.collect(stmt):
            if kind == "flush":
                dirty, flushed = False, True
            else:
                dirty = True
        return (dirty, flushed)

    def _exit(self, state, node):
        self.exit_state = state if self.exit_state is None \
            else self.join(self.exit_state, state)
        if state[0]:
            self.dirty_exits.append(node)

    def on_return(self, state, node):
        self._exit(state, node)

    def on_end(self, state, node):
        self._exit(state, node)


def _method_summaries(cg: CallGraph) -> Dict[str, str]:
    """Fixpoint effect summary per method (what a call to it does to
    the caller's pending-journal state)."""
    summaries = {name: _EFFECT_NONE for name in cg.methods}
    for _ in range(len(cg.methods) + 2):
        changed = False
        for name, fn in cg.methods.items():
            sim = _WriteAheadSim(summaries)
            sim.run(fn)
            exit_state = sim.exit_state or (False, False)
            eff = _EFFECT_DIRTY if exit_state[0] else (
                _EFFECT_FLUSH if exit_state[1] else _EFFECT_NONE)
            if summaries[name] != eff:
                summaries[name] = eff
                changed = True
        if not changed:
            break
    return summaries


class DurabilityPass(AnalysisPass):
    name = "durability"
    codes = {
        "SC401": "RPC handler acks (returns) with journal-intent "
                 "records or durable mutations not group-committed on "
                 "every path (write-ahead: commit before ack)",
        "SC402": "durable-state mutation reachable from an unfenced "
                 "entry point (handler or background thread) with no "
                 "fence consultation on the path",
        "SC403": "stamped message field (gen/epoch/map_epoch) used "
                 "before mutation without a CAS/monotone comparison "
                 "(raw equality or no check)",
        "SC404": "journal record type without a replay arm / replay "
                 "arm or RECORD_TYPES entry without an appender",
        "SC405": "lock held across journal group-commit or collective "
                 "wait (heartbeats stall behind storage)",
        "SC406": "protocol model and RPC_CONTRACTS drift (transition "
                 "without a contract, or non-idempotent contract "
                 "missing from the model)",
    }

    def run(self, project: Project) -> List[Finding]:
        out: List[Finding] = []
        for mod in project.modules:
            out.extend(self._module_passes(mod))
        out.extend(self._journal_round_trip(project))
        out.extend(self._model_anchoring(project))
        return out

    # -- SC401 / SC402 / SC405 (per master-service class) ----------------

    def _module_passes(self, mod: ModuleInfo) -> List[Finding]:
        out: List[Finding] = []
        regs = _registrations(mod)
        for cls in [n for n in ast.walk(mod.tree)
                    if isinstance(n, ast.ClassDef)]:
            cls_methods = {s.name for s in cls.body
                           if isinstance(s, (ast.FunctionDef,
                                             ast.AsyncFunctionDef))}
            cls_regs = {rpc: (fenced, meth, node)
                        for rpc, (fenced, meth, node) in regs.items()
                        if meth in cls_methods}
            if not cls_regs:
                continue
            cg = CallGraph(mod, cls)
            summaries = _method_summaries(cg)
            out.extend(self._write_ahead(mod, cg, cls_regs, summaries))
            out.extend(self._fence_coverage(mod, cls, cg, cls_regs,
                                            summaries))
            out.extend(self._lock_across_commit(mod, cls, cg))
        out.extend(self._staleness(mod))
        return out

    def _write_ahead(self, mod: ModuleInfo, cg: CallGraph,
                     regs: Dict[str, Tuple[bool, str, ast.AST]],
                     summaries: Dict[str, str]) -> List[Finding]:
        out: List[Finding] = []
        for rpc, (_fenced, meth, _node) in sorted(regs.items()):
            fn = cg.methods.get(meth)
            if fn is None:
                continue
            sim = _WriteAheadSim(summaries)
            sim.run(fn)
            for node in sim.dirty_exits:
                out.append(mod.finding(
                    "SC401",
                    f"handler `{meth}` (RPC `{rpc}`) can ack with "
                    "journal-intent records or durable mutations not "
                    "yet group-committed — `_journal_append` must "
                    "dominate every return (write-ahead: an acked "
                    "completion is never lost)", node))
        return out

    def _fence_coverage(self, mod: ModuleInfo, cls: ast.ClassDef,
                        cg: CallGraph,
                        regs: Dict[str, Tuple[bool, str, ast.AST]],
                        summaries: Dict[str, str]) -> List[Finding]:
        out: List[Finding] = []
        fence_aware = {
            name for name, fn in cg.methods.items()
            if any(isinstance(n, ast.Attribute)
                   and n.attr in _FENCE_ATTRS
                   for n in ast.walk(fn))}
        walk = _EffectWalk({})  # direct events only — no summaries
        mutators: Dict[str, ast.AST] = {}
        for name, fn in cg.methods.items():
            for stmt in ast.walk(fn):
                if not isinstance(stmt, ast.stmt):
                    continue
                evs = [n for kind, n in walk.collect(stmt)
                       if kind == "dirty"]
                if evs:
                    mutators.setdefault(name, evs[0])
                    break
        entries: Dict[str, str] = {}
        for rpc, (fenced, meth, _node) in regs.items():
            if not fenced:
                entries.setdefault(meth, f"unfenced handler `{meth}` "
                                         f"(RPC `{rpc}`)")
        for meth in sorted(_thread_targets(cls)):
            entries.setdefault(meth, f"background thread `{meth}`")
        for entry, label in sorted(entries.items()):
            if entry in fence_aware:
                continue
            reachable = {entry} | cg.transitive_callees(entry)
            for m in sorted(reachable & set(mutators)):
                # a mutator that consults the fence itself (or through
                # a callee — _journal_append checks the fence flag
                # before any durable write) participates in the
                # protocol; the bug is mutation with no consultation
                if ({m} | cg.transitive_callees(m)) & fence_aware:
                    continue
                out.append(mod.finding(
                    "SC402",
                    f"durable-state mutation in `{m}` is reachable "
                    f"from {label} with no fence consultation on the "
                    "path — a superseded master would keep applying "
                    "it (SC312 only audits registration wrapping)",
                    mutators[m]))
        return out

    def _lock_across_commit(self, mod: ModuleInfo, cls: ast.ClassDef,
                            cg: CallGraph) -> List[Finding]:
        locks: Set[str] = set()
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call) \
                    and _last_name(node.value.func) in _LOCK_CTORS:
                for t in node.targets:
                    if isinstance(t, ast.Attribute) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id == "self":
                        locks.add(t.attr)
        if not locks:
            return []
        flushy = {name for name, fn in cg.methods.items()
                  if any(isinstance(n, ast.Call) and _is_journal_flush(n)
                         for n in ast.walk(fn))}
        reach_flush = cg.reaching(flushy) if flushy else set()
        out: List[Finding] = []

        def visit(node: ast.AST, held: Tuple[str, ...],
                  meth: str) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                return
            if isinstance(node, (ast.With, ast.AsyncWith)):
                add = []
                for item in node.items:
                    ctx = item.context_expr
                    if isinstance(ctx, ast.Attribute) \
                            and isinstance(ctx.value, ast.Name) \
                            and ctx.value.id == "self" \
                            and ctx.attr in locks:
                        add.append(ctx.attr)
                for s in node.body:
                    visit(s, held + tuple(add), meth)
                return
            if isinstance(node, ast.Call) and held:
                name = _last_name(node.func)
                blocking = None
                if _is_journal_flush(node):
                    blocking = "journal group-commit"
                elif name in _COLLECTIVE_WAITS:
                    blocking = f"collective wait `{name}`"
                elif isinstance(node.func, ast.Attribute) \
                        and isinstance(node.func.value, ast.Name) \
                        and node.func.value.id == "self" \
                        and node.func.attr in reach_flush \
                        and node.func.attr != meth:
                    blocking = (f"`{node.func.attr}` (transitively "
                                "group-commits)")
                if blocking is not None:
                    out.append(mod.finding(
                        "SC405",
                        f"{blocking} while holding "
                        f"`self.{'`, `self.'.join(held)}` — commit "
                        "waits must run outside control-plane locks "
                        "or every heartbeat stalls behind storage",
                        node))
            for child in ast.iter_child_nodes(node):
                visit(child, held, meth)

        for name, fn in cg.methods.items():
            for stmt in fn.body:
                visit(stmt, (), name)
        return out

    # -- SC403 -----------------------------------------------------------

    def _staleness(self, mod: ModuleInfo) -> List[Finding]:
        out: List[Finding] = []
        for fn in [n for n in ast.walk(mod.tree)
                   if isinstance(n, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))]:
            out.extend(self._staleness_fn(mod, fn))
        return out

    @staticmethod
    def _stamp_read(node: ast.AST) -> Optional[Tuple[str, Optional[str]]]:
        """(stamp_key, receiver_name) when `node` reads a stamped field
        — ``x.get("gen")`` / ``x["epoch"]`` — else None."""
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "get" and node.args \
                and _const_str(node.args[0]) in _STAMP_KEYS:
            recv = node.func.value
            return (_const_str(node.args[0]),
                    recv.id if isinstance(recv, ast.Name) else None)
        if isinstance(node, ast.Subscript) \
                and _const_str(node.slice) in _STAMP_KEYS:
            recv = node.value
            return (_const_str(node.slice),
                    recv.id if isinstance(recv, ast.Name) else None)
        return None

    def _staleness_fn(self, mod: ModuleInfo,
                      fn: ast.FunctionDef) -> List[Finding]:
        reads: List[Tuple[str, Optional[str], ast.AST]] = []
        tainted: Set[str] = set()
        receivers: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node is not fn:
                continue
            sr = self._stamp_read(node)
            if sr is not None:
                reads.append((sr[0], sr[1], node))
                if sr[1]:
                    receivers.add(sr[1])
        if not reads:
            return []

        def has_stamp(sub: ast.AST) -> bool:
            for n in ast.walk(sub):
                if self._stamp_read(n) is not None:
                    return True
                if isinstance(n, ast.Name) and n.id in tainted:
                    return True
            return False

        # taint names assigned from stamp reads (one forward pass)
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and has_stamp(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        tainted.add(t.id)

        monotone = equality = cas = delegated = False
        mutating = False
        eq_node: Optional[ast.AST] = None
        walk = _EffectWalk({})
        for node in ast.walk(fn):
            if isinstance(node, ast.Compare):
                operands = [node.left] + list(node.comparators)
                if any(has_stamp(o) for o in operands):
                    for op in node.ops:
                        if isinstance(op, (ast.Lt, ast.LtE, ast.Gt,
                                           ast.GtE)):
                            monotone = True
                        elif isinstance(op, (ast.Eq, ast.NotEq)):
                            equality = True
                            eq_node = eq_node or node
            elif isinstance(node, ast.Call):
                name = _last_name(node.func)
                if name in _CAS_NAMES:
                    cas = True
                elif name in ("max", "min") and has_stamp(node):
                    monotone = True
                elif any(isinstance(a, ast.Name)
                         and (a.id in receivers or a.id in tainted)
                         for a in node.args):
                    delegated = True
            if isinstance(node, ast.stmt):
                if any(kind == "dirty"
                       for kind, _n in walk.collect(node)):
                    mutating = True
                if isinstance(node, (ast.Assign, ast.AugAssign)):
                    targets = node.targets if isinstance(node, ast.Assign) \
                        else [node.target]
                    if any(isinstance(t, ast.Attribute) for t in targets) \
                            and has_stamp(node.value):
                        mutating = True  # latch write from a stamp
        if not mutating:
            return []
        out: List[Finding] = []
        keys = sorted({k for k, _r, _n in reads})
        if equality and not (monotone or cas):
            out.append(mod.finding(
                "SC403",
                f"`{fn.name}` validates stamped field(s) "
                f"{', '.join(keys)} with raw ==/!= equality before "
                "mutating — staleness checks must be CAS or monotone "
                "(>=): equality re-admits any replayed stamp",
                eq_node or fn))
        elif not (monotone or cas or equality or delegated):
            out.append(mod.finding(
                "SC403",
                f"`{fn.name}` reads stamped field(s) {', '.join(keys)} "
                "and mutates durable/latch state without any "
                "CAS/monotone staleness check (and without delegating "
                "the stamp to a validator)", reads[0][2]))
        return out

    # -- SC404 -----------------------------------------------------------

    @staticmethod
    def _journal_coupled(mod: ModuleInfo) -> bool:
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name == "_journal_append":
                return True
            if isinstance(node, ast.Assign) \
                    and any(isinstance(t, ast.Name)
                            and t.id == "RECORD_TYPES"
                            for t in node.targets):
                return True
        return False

    def _journal_round_trip(self, project: Project) -> List[Finding]:
        mods = [m for m in project.modules if self._journal_coupled(m)]
        if not mods:
            return []
        appended: Dict[str, Tuple[ModuleInfo, ast.AST]] = {}
        replayed: Dict[str, Tuple[ModuleInfo, ast.AST]] = {}
        declared: Optional[Set[str]] = None
        declared_at: Optional[Tuple[ModuleInfo, ast.AST]] = None
        for mod in mods:
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.Dict):
                    rt = _intent_type(node)
                    if rt is not None:
                        appended.setdefault(rt, (mod, node))
            tup = _module_tuple(mod, "RECORD_TYPES")
            if tup is not None:
                declared = set(tup)
                declared_at = (mod, mod.tree)
            for fn in [n for n in ast.walk(mod.tree)
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))]:
                t_names: Set[str] = set()
                for node in ast.walk(fn):
                    if isinstance(node, ast.Assign) \
                            and self._is_t_read(node.value):
                        t_names |= {t.id for t in node.targets
                                    if isinstance(t, ast.Name)}
                for node in ast.walk(fn):
                    if not isinstance(node, ast.Compare):
                        continue
                    operands = [node.left] + list(node.comparators)
                    reads_t = any(
                        self._is_t_read(o)
                        or (isinstance(o, ast.Name) and o.id in t_names)
                        for o in operands)
                    if not reads_t:
                        continue
                    for o in operands:
                        c = _const_str(o)
                        if c is not None:
                            replayed.setdefault(c, (mod, node))
                        elif isinstance(o, (ast.Tuple, ast.List,
                                            ast.Set)):
                            for el in o.elts:
                                cs = _const_str(el)
                                if cs is not None:
                                    replayed.setdefault(cs, (mod, node))
        out: List[Finding] = []
        for rt in sorted(set(appended) - set(replayed)):
            mod, node = appended[rt]
            out.append(mod.finding(
                "SC404",
                f"journal record type `{rt}` is appended but no "
                "replay arm compares against it — recovery would "
                "silently drop it", node))
        for rt in sorted(set(replayed) - set(appended)):
            mod, node = replayed[rt]
            out.append(mod.finding(
                "SC404",
                f"replay arm handles record type `{rt}` but nothing "
                "appends it — dead recovery code or a renamed "
                "appender", node))
        if declared is not None and declared_at is not None:
            dmod, dnode = declared_at
            for rt in sorted(declared - set(appended)):
                out.append(dmod.finding(
                    "SC404",
                    f"RECORD_TYPES declares `{rt}` but nothing "
                    "appends it", dnode))
            for rt in sorted(set(appended) - declared):
                mod, node = appended[rt]
                out.append(mod.finding(
                    "SC404",
                    f"record type `{rt}` is appended but missing from "
                    "RECORD_TYPES — tooling that folds over the "
                    "declared set will not see it", node))
        return out

    @staticmethod
    def _is_t_read(node: ast.AST) -> bool:
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "get" and node.args:
            return _const_str(node.args[0]) == "t"
        if isinstance(node, ast.Subscript):
            return _const_str(node.slice) == "t"
        return False

    # -- SC406 -----------------------------------------------------------

    def _model_anchoring(self, project: Project) -> List[Finding]:
        model_mod: Optional[ModuleInfo] = None
        for m in project.modules:
            if "analysis/model/" in m.relpath:
                if self._anchors(m) is not None:
                    model_mod = m
                    break
        contracts_mod: Optional[ModuleInfo] = None
        contracts: Optional[Dict[str, object]] = None
        for m in project.modules:
            got = ContractPass._contract_idempotency(m)
            if got is not None:
                contracts_mod, contracts = m, got
                break
        out: List[Finding] = []
        has_model_pkg = any("analysis/model/" in m.relpath
                            for m in project.modules)
        if model_mod is None:
            if has_model_pkg and contracts is not None:
                anchor = next(m for m in project.modules
                              if "analysis/model/" in m.relpath)
                out.append(anchor.finding(
                    "SC406",
                    "analysis/model/ defines no RPC_ANCHORS dict — "
                    "the protocol model must anchor its transitions "
                    "to RPC_CONTRACTS so it cannot rot from the "
                    "source", anchor.tree))
            return out
        anchors = self._anchors(model_mod) or {}
        transitions = {n.name[2:] for n in ast.walk(model_mod.tree)
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))
                       and n.name.startswith("t_")}
        for key, (rpc, node) in sorted(anchors.items()):
            if key not in transitions:
                out.append(model_mod.finding(
                    "SC406",
                    f"RPC_ANCHORS names transition `{key}` but the "
                    f"model defines no `t_{key}` — the anchor points "
                    "at nothing", node))
            if contracts is not None and rpc not in contracts:
                out.append(model_mod.finding(
                    "SC406",
                    f"model transition `{key}` anchors RPC `{rpc}` "
                    "which has no RPC_CONTRACTS entry — the model "
                    "describes an RPC the engine does not declare",
                    node))
        if contracts is not None and contracts_mod is not None:
            anchored_rpcs = {rpc for rpc, _n in anchors.values()}
            for rpc, idem in sorted(contracts.items()):
                if idem is False and rpc not in anchored_rpcs:
                    out.append(model_mod.finding(
                        "SC406",
                        f"RPC `{rpc}` is classified idempotent=False "
                        "but no model transition anchors it — the "
                        "bounded-interleaving explorer is blind to a "
                        "mutating RPC (add a transition or an anchor)",
                        model_mod.tree))
        return out

    @staticmethod
    def _anchors(mod: ModuleInfo
                 ) -> Optional[Dict[str, Tuple[str, ast.AST]]]:
        """{transition: (rpc, key_node)} from the module-level
        RPC_ANCHORS dict literal, or None when absent."""
        for stmt in mod.tree.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name) \
                    and stmt.targets[0].id == "RPC_ANCHORS" \
                    and isinstance(stmt.value, ast.Dict):
                out: Dict[str, Tuple[str, ast.AST]] = {}
                for k, v in zip(stmt.value.keys, stmt.value.values):
                    ks, vs = _const_str(k), _const_str(v)
                    if ks is not None and vs is not None:
                        out[ks] = (vs, k)
                return out
        return None
