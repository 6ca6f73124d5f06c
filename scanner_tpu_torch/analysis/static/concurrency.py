"""Concurrency lints over the threaded pipeline (SC201–SC203).

The engine runs ~a dozen thread kinds (stage loaders/evaluators/savers,
heartbeat, master scan loop, metrics scrapes, warm-up) against ~19
Lock/RLock sites.  Deadlocks and torn state don't reproduce in unit
tests; the only cheap time to catch them is statically, at review:

  SC201  lock-order hazard: two locks acquired in opposite orders on
         different paths (ABBA deadlock), or a non-reentrant Lock
         re-acquired on a path that may already hold it
  SC202  blocking call while holding a lock: RPC, storage/file I/O,
         sleeps, unbounded queue/event waits — one slow peer and every
         thread contending that lock convoys behind it
  SC203  attribute written both under a lock and bare: the bare write
         races the locked readers/writers (lost update, torn check)

The analysis is intentionally first-order: locks are identified by
their declaration site (`self._x = threading.Lock()` in class C →
"mod.C._x"; module-level `L = threading.Lock()` → "mod.L"), acquisition
by `with <lock>:`, and call edges one level deep (self-methods within a
class, bare functions within a module).  That shallow model already
covers every lock in this codebase; anything it can't see, it stays
silent about (no speculative aliasing)."""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core import AnalysisPass, Finding, ModuleInfo, Project
from .tracer import dotted_name

# receiver-method calls considered blocking when made under a lock.
# (name-based: precise enough at this codebase's idiom, and a false
# positive is one inline suppression away)
_BLOCKING_SIMPLE = {"time.sleep", "wait_for_server", "subprocess.run",
                    "subprocess.check_call", "subprocess.check_output",
                    "subprocess.Popen"}
_RPC_METHODS = {"call", "try_call"}
_STORAGE_METHODS = {"read", "read_range", "write", "write_exclusive",
                    "list_prefix", "delete", "delete_prefix"}
_STORAGE_RECEIVER_HINTS = ("storage", "backend")
_QUEUE_RECEIVER_HINTS = ("q", "queue")


def _mod_base(mod: ModuleInfo) -> str:
    return mod.relpath[:-3].replace("/", ".")


@dataclass
class _LockDecl:
    key: str        # "engine.service.Master._lock"
    reentrant: bool


@dataclass
class _FuncInfo:
    mod: ModuleInfo
    cls: Optional[str]
    fn: ast.FunctionDef
    acquires: Set[str] = field(default_factory=set)  # direct only


class _ClassModel:
    def __init__(self, mod: ModuleInfo, node: ast.ClassDef):
        self.mod = mod
        self.node = node
        self.name = node.name
        self.locks: Dict[str, _LockDecl] = {}   # attr -> decl
        self.methods: Dict[str, ast.FunctionDef] = {}
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign):
                t = sub.targets[0] if len(sub.targets) == 1 else None
                if isinstance(t, ast.Attribute) and isinstance(
                        t.value, ast.Name) and t.value.id == "self":
                    kind = _lock_ctor(sub.value)
                    if kind:
                        self.locks[t.attr] = _LockDecl(
                            f"{_mod_base(mod)}.{self.name}.{t.attr}",
                            reentrant=(kind == "RLock"))
        for sub in node.body:
            if isinstance(sub, ast.FunctionDef):
                self.methods[sub.name] = sub


def _lock_ctor(value: ast.AST) -> Optional[str]:
    if isinstance(value, ast.Call):
        d = dotted_name(value.func) or ""
        last = d.split(".")[-1]
        if last in ("Lock", "RLock"):
            return last
    return None


def _module_locks(mod: ModuleInfo) -> Dict[str, _LockDecl]:
    out: Dict[str, _LockDecl] = {}
    for stmt in mod.tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name):
            kind = _lock_ctor(stmt.value)
            if kind:
                name = stmt.targets[0].id
                out[name] = _LockDecl(f"{_mod_base(mod)}.{name}",
                                      reentrant=(kind == "RLock"))
    return out


@dataclass
class _Edge:
    src: str
    dst: str
    mod: ModuleInfo
    node: ast.AST       # where dst is acquired (or the call site)
    via: str = ""       # call chain note for the message


class ConcurrencyPass(AnalysisPass):
    name = "concurrency"
    codes = {
        "SC201": "inconsistent lock acquisition order / self-deadlock",
        "SC202": "blocking call while holding a lock",
        "SC203": "shared attribute written outside its lock",
    }

    def run(self, project: Project) -> List[Finding]:
        findings: List[Finding] = []
        edges: List[_Edge] = []
        lock_decls: Dict[str, _LockDecl] = {}

        for mod in project.modules:
            mod_locks = _module_locks(mod)
            lock_decls.update({d.key: d for d in mod_locks.values()})
            classes = [
                _ClassModel(mod, n) for n in mod.tree.body
                if isinstance(n, ast.ClassDef)]
            module_funcs = {n.name: n for n in mod.tree.body
                            if isinstance(n, ast.FunctionDef)}
            for cm in classes:
                lock_decls.update({d.key: d for d in cm.locks.values()})

            for cm in classes:
                for mname, fn in cm.methods.items():
                    self._walk_function(
                        mod, fn, cm, mod_locks, classes, module_funcs,
                        edges, findings)
                findings.extend(self._check_unguarded_writes(mod, cm))
            for fname, fn in module_funcs.items():
                self._walk_function(mod, fn, None, mod_locks, classes,
                                    module_funcs, edges, findings)

        findings.extend(self._order_findings(edges, lock_decls))
        return findings

    # -- lock model helpers ---------------------------------------------

    @staticmethod
    def _lock_of_expr(expr: ast.AST, cls: Optional[_ClassModel],
                      mod_locks: Dict[str, _LockDecl]
                      ) -> Optional[_LockDecl]:
        if isinstance(expr, ast.Attribute) and isinstance(
                expr.value, ast.Name) and expr.value.id == "self" \
                and cls is not None:
            return cls.locks.get(expr.attr)
        if isinstance(expr, ast.Name):
            return mod_locks.get(expr.id)
        return None

    @staticmethod
    def _direct_acquires(fn: ast.FunctionDef, cls: Optional[_ClassModel],
                         mod_locks: Dict[str, _LockDecl]) -> Set[str]:
        out: Set[str] = set()
        for sub in ast.walk(fn):
            if isinstance(sub, ast.With):
                for item in sub.items:
                    d = ConcurrencyPass._lock_of_expr(
                        item.context_expr, cls, mod_locks)
                    if d:
                        out.add(d.key)
        return out

    # -- per-function walk: edges + SC202 -------------------------------

    def _walk_function(self, mod: ModuleInfo, fn: ast.FunctionDef,
                       cls: Optional[_ClassModel],
                       mod_locks: Dict[str, _LockDecl],
                       classes: Sequence[_ClassModel],
                       module_funcs: Dict[str, ast.FunctionDef],
                       edges: List[_Edge],
                       findings: List[Finding]) -> None:
        class_by_name = {c.name: c for c in classes}

        def callee_acquires(call: ast.Call) -> Tuple[Set[str], str]:
            """Locks a one-level-resolved callee acquires directly."""
            f = call.func
            if isinstance(f, ast.Attribute) and isinstance(
                    f.value, ast.Name) and f.value.id == "self" \
                    and cls is not None:
                target = cls.methods.get(f.attr)
                if target is not None:
                    return (self._direct_acquires(target, cls, mod_locks),
                            f"self.{f.attr}()")
            elif isinstance(f, ast.Name):
                target = module_funcs.get(f.id)
                if target is not None:
                    return (self._direct_acquires(target, None, mod_locks),
                            f"{f.id}()")
                c = class_by_name.get(f.id)
                if c is not None and "__init__" in c.methods:
                    return (self._direct_acquires(
                        c.methods["__init__"], c, mod_locks),
                        f"{f.id}()")
            return set(), ""

        def visit(node: ast.AST, held: Tuple[str, ...]) -> None:
            if isinstance(node, ast.With):
                new_held = held
                for i in node.items:
                    d = self._lock_of_expr(i.context_expr, cls, mod_locks)
                    if d is None:
                        # a non-lock context manager may still make calls
                        visit(i.context_expr, new_held)
                        continue
                    for h in new_held:
                        edges.append(_Edge(h, d.key, mod, node))
                    new_held = new_held + (d.key,)
                for child in node.body:
                    visit(child, new_held)
                return
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node is not fn:
                # nested def: runs later, not under the current locks
                return
            if isinstance(node, ast.Call) and held:
                self._check_blocking(mod, node, held, findings)
                acq, via = callee_acquires(node)
                for key in acq:
                    for h in held:
                        edges.append(_Edge(h, key, mod, node, via=via))
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        visit(fn, ())

    def _check_blocking(self, mod: ModuleInfo, call: ast.Call,
                        held: Tuple[str, ...],
                        findings: List[Finding]) -> None:
        d = dotted_name(call.func) or ""
        lockset = ", ".join(k.rsplit(".", 2)[-2] + "." +
                            k.rsplit(".", 2)[-1] for k in held)
        kwnames = {kw.arg for kw in call.keywords}

        def hit(what: str) -> None:
            findings.append(mod.finding(
                "SC202",
                f"{what} while holding {lockset} — every thread "
                "contending that lock convoys behind this call", call))

        if d in _BLOCKING_SIMPLE or d.endswith(".sleep"):
            hit(f"`{d}` (blocking)")
            return
        if isinstance(call.func, ast.Attribute):
            meth = call.func.attr
            recv = dotted_name(call.func.value) or ""
            recv_last = recv.split(".")[-1].lower()
            if meth in _RPC_METHODS:
                hit(f"RPC `{recv}.{meth}()`")
            elif meth in _STORAGE_METHODS and any(
                    h in recv_last for h in _STORAGE_RECEIVER_HINTS):
                hit(f"storage I/O `{recv}.{meth}()`")
            elif meth == "get" and "timeout" not in kwnames \
                    and not call.args \
                    and any(recv_last == h or recv_last.endswith("_" + h)
                            or recv_last.endswith(h)
                            for h in _QUEUE_RECEIVER_HINTS) \
                    and recv_last not in ("config",):
                hit(f"unbounded `{recv}.get()`")
            elif meth in ("wait", "join") and not call.args \
                    and "timeout" not in kwnames and recv:
                hit(f"unbounded `{recv}.{meth}()`")
        elif isinstance(call.func, ast.Name) and call.func.id == "open":
            hit("file I/O `open()`")

    # -- SC201 ----------------------------------------------------------

    def _order_findings(self, edges: List[_Edge],
                        decls: Dict[str, _LockDecl]) -> List[Finding]:
        out: List[Finding] = []
        seen: Set[Tuple[str, str]] = set()
        graph: Dict[str, Set[str]] = {}
        for e in edges:
            graph.setdefault(e.src, set()).add(e.dst)

        # self-acquisition of a non-reentrant Lock
        for e in edges:
            if e.src == e.dst and not decls.get(
                    e.dst, _LockDecl(e.dst, False)).reentrant:
                if ("self", e.dst) in seen:
                    continue
                seen.add(("self", e.dst))
                via = f" via {e.via}" if e.via else ""
                out.append(e.mod.finding(
                    "SC201",
                    f"non-reentrant Lock `{_short(e.dst)}` re-acquired on "
                    f"a path that may already hold it{via} — instant "
                    "self-deadlock", e.node))

        # opposite-order pairs (ABBA)
        for e in edges:
            if e.src == e.dst:
                continue
            if e.src in graph.get(e.dst, ()):  # dst -> src exists too
                pair = tuple(sorted((e.src, e.dst)))
                if ("abba",) + pair in seen:
                    continue
                seen.add(("abba",) + pair)
                out.append(e.mod.finding(
                    "SC201",
                    f"lock order inversion: `{_short(e.src)}` -> "
                    f"`{_short(e.dst)}` here, but the opposite order "
                    "exists elsewhere — ABBA deadlock when the two "
                    "paths interleave", e.node))
        return out

    # -- SC203 ----------------------------------------------------------

    def _check_unguarded_writes(self, mod: ModuleInfo,
                                cm: _ClassModel) -> List[Finding]:
        if not cm.locks:
            return []
        locked_attrs: Set[str] = set()
        unlocked_sites: Dict[str, List[ast.AST]] = {}

        for mname, fn in cm.methods.items():
            if mname == "__init__":
                continue  # construction happens-before publication

            def visit(node: ast.AST, held: bool) -> None:
                if isinstance(node, ast.With):
                    now_held = held or any(
                        self._lock_of_expr(i.context_expr, cm, {})
                        for i in node.items)
                    for child in node.body:
                        visit(child, now_held)
                    return
                targets: List[ast.AST] = []
                if isinstance(node, ast.Assign):
                    targets = node.targets
                elif isinstance(node, ast.AugAssign):
                    targets = [node.target]
                for t in targets:
                    if isinstance(t, ast.Attribute) and isinstance(
                            t.value, ast.Name) and t.value.id == "self" \
                            and t.attr not in cm.locks:
                        if held:
                            locked_attrs.add(t.attr)
                        else:
                            unlocked_sites.setdefault(
                                t.attr, []).append(node)
                for child in ast.iter_child_nodes(node):
                    visit(child, held)

            visit(fn, False)

        out: List[Finding] = []
        for attr in sorted(locked_attrs):
            for site in unlocked_sites.get(attr, []):
                out.append(mod.finding(
                    "SC203",
                    f"`self.{attr}` is written under "
                    f"`{cm.name}`'s lock elsewhere but bare here — the "
                    "unlocked write races the locked readers", site))
        return out


def _short(key: str) -> str:
    return ".".join(key.rsplit(".", 2)[-2:])
