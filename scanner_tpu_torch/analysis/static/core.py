"""Pass framework for the port's static analyzer (torch-check).

The port makes the JAX package's promises — scheduling, shape
stability, fault tolerance are the engine's problem — so the same
properties must hold of the port's own source.  This module is the
JAX package's pass skeleton, kept as the port's own copy:

  * `ModuleInfo` — one parsed source file: AST with parent/scope maps,
    raw lines, inline-suppression lookup;
  * `Project` — the set of modules under analysis plus repo context the
    contract passes need (docs text, repo root);
  * `AnalysisPass` — base class; a pass walks the project and returns
    `Finding`s, each tagged with a stable code (SCxxx);
  * suppression — inline (`# scanner-check: disable=SC202 reason`) for
    single sites, or a committed JSON baseline whose entries carry
    line-number-independent fingerprints plus a mandatory one-line
    justification (reviewed like code).

What differs from the JAX package's copy is the documentation side of
the contracts: the port keeps the JAX package's metric, env and config
names, so `Project.docs_text()` reads the shared pages `docs/*.md` AND
the port's own pages under `docs/torch/`; a name in the port's
`reference-only` table (docs/torch/) is documented and deliberately not
read; and the consumers that count as using a name are the port's own
(`tests/test_torch_*.py`, `tests/torch_*.py`, `tools/torch_*.py`,
`chip_smoke.py`), not the JAX package's.

Passes live in tracer.py / concurrency.py / contracts.py /
durability.py; the CLI in cli.py (tools/torch_check.py calls it).
docs/torch/analysis.md is the user-facing page.
"""

from __future__ import annotations

import ast
import hashlib
import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = [
    "Finding", "ModuleInfo", "Project", "AnalysisPass",
    "CallGraph", "PathSimulator",
    "load_baseline", "write_baseline", "BaselineError",
    "split_findings", "find_repo_root",
]

# inline suppression: a trailing comment on the offending line —
#   x = np.sum(y)  # scanner-check: disable=SC101 host reduction is intended
_SUPPRESS_RE = re.compile(
    r"#\s*scanner-check:\s*disable=([A-Z0-9,\s]+?)(?:\s+\S.*)?$")
# whole-file opt-out (generated files, vendored code) in the first lines
_SUPPRESS_FILE_RE = re.compile(
    r"#\s*scanner-check:\s*disable-file=([A-Z0-9,\s]+?)(?:\s+\S.*)?$")
_FILE_PRAGMA_WINDOW = 10

# the documentation side of the contracts: the shared pages, then the
# port's own
DOC_DIRS = ("docs", os.path.join("docs", "torch"))
# rows of a `reference-only` table: `name` | ... | reason
_REFERENCE_ONLY_RE = re.compile(
    r"<!--\s*reference-only:begin\s*-->(.*?)"
    r"<!--\s*reference-only:end\s*-->", re.S)
# (directory under the root, file-name prefixes) of the port's consumers
_AUX_SOURCES = (("tests", ("test_torch_", "torch_")),
                ("tools", ("torch_",)),
                ("", ("chip_smoke",)))


@dataclass(frozen=True)
class Finding:
    """One analyzer hit.  `fingerprint` is stable under unrelated edits:
    it hashes the *snippet text* (whitespace-collapsed), not the line
    number, so a baseline survives code moving around it."""

    code: str          # e.g. "SC202"
    message: str
    path: str          # repo-relative, forward slashes
    line: int          # 1-based
    scope: str         # enclosing Class.method / function qualname, or ""
    snippet: str = ""  # source line the finding anchors to

    @property
    def fingerprint(self) -> str:
        norm = " ".join(self.snippet.split())
        h = hashlib.sha1(
            f"{self.code}|{self.path}|{self.scope}|{norm}".encode()
        ).hexdigest()[:12]
        return f"{self.code}:{self.path}:{self.scope or '<module>'}:{h}"

    def format(self) -> str:
        where = f" [{self.scope}]" if self.scope else ""
        return f"{self.path}:{self.line}: {self.code} {self.message}{where}"

    def to_dict(self) -> dict:
        return {"code": self.code, "message": self.message,
                "path": self.path, "line": self.line, "scope": self.scope,
                "snippet": self.snippet, "fingerprint": self.fingerprint}


class ModuleInfo:
    """One parsed python file plus the lookups every pass needs."""

    def __init__(self, path: str, relpath: str, source: str):
        self.path = path
        self.relpath = relpath.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self._parents: Dict[ast.AST, ast.AST] = {}
        self._scopes: Dict[ast.AST, str] = {}
        self._index(self.tree, None, ())
        self._file_suppressed = self._file_pragmas()

    @classmethod
    def parse(cls, path: str, root: str) -> "ModuleInfo":
        with open(path, encoding="utf-8") as f:
            src = f.read()
        return cls(path, os.path.relpath(path, root), src)

    def _index(self, node: ast.AST, parent: Optional[ast.AST],
               scope: Tuple[str, ...]) -> None:
        if parent is not None:
            self._parents[node] = parent
        self._scopes[node] = ".".join(scope)
        child_scope = scope
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            child_scope = scope + (node.name,)
        for child in ast.iter_child_nodes(node):
            self._index(child, node, child_scope)

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self._parents.get(node)

    def scope_of(self, node: ast.AST) -> str:
        """Qualname of the class/function enclosing `node` (the node's
        own name included when it is itself a def/class)."""
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            base = self._scopes.get(node, "")
            return f"{base}.{node.name}" if base else node.name
        return self._scopes.get(node, "")

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def _file_pragmas(self) -> Set[str]:
        codes: Set[str] = set()
        for text in self.lines[:_FILE_PRAGMA_WINDOW]:
            m = _SUPPRESS_FILE_RE.search(text)
            if m:
                codes.update(c.strip() for c in m.group(1).split(",")
                             if c.strip())
        return codes

    def suppressed(self, code: str, lineno: int) -> bool:
        """Inline suppression on the finding's own line (or the file
        pragma).  `ALL` disables every code."""
        if self._file_suppressed & {code, "ALL"}:
            return True
        m = _SUPPRESS_RE.search(self.line_text(lineno))
        if not m:
            return False
        codes = {c.strip() for c in m.group(1).split(",")}
        return bool(codes & {code, "ALL"})

    def finding(self, code: str, message: str, node: ast.AST) -> Finding:
        line = getattr(node, "lineno", 1)
        return Finding(code=code, message=message, path=self.relpath,
                       line=line, scope=self.scope_of(node),
                       snippet=self.line_text(line).strip())


def find_repo_root(start: str) -> str:
    """Walk up from `start` to the checkout root (setup.py/pytest.ini)."""
    d = os.path.abspath(start)
    if os.path.isfile(d):
        d = os.path.dirname(d)
    while True:
        if any(os.path.exists(os.path.join(d, probe))
               for probe in ("setup.py", "pytest.ini", ".git")):
            return d
        up = os.path.dirname(d)
        if up == d:
            return os.path.abspath(start)
        d = up


def _collect_py(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames
                               if d != "__pycache__"
                               and not d.startswith(".")]
                out.extend(os.path.join(dirpath, f)
                           for f in filenames if f.endswith(".py"))
        elif p.endswith(".py"):
            out.append(p)
    return sorted(set(os.path.abspath(p) for p in out))


class Project:
    """Everything a pass may look at: the parsed modules plus repo-level
    context (docs, auxiliary source trees) for the contract passes."""

    def __init__(self, paths: Sequence[str], root: Optional[str] = None):
        files = _collect_py(paths)
        if not files and not root:
            raise ValueError(f"no python files under {list(paths)}")
        self.root = os.path.abspath(
            root if root is not None
            else find_repo_root(files[0] if files else "."))
        self.modules: List[ModuleInfo] = []
        self.parse_errors: List[Finding] = []
        for f in files:
            try:
                self.modules.append(ModuleInfo.parse(f, self.root))
            except SyntaxError as e:
                rel = os.path.relpath(f, self.root).replace(os.sep, "/")
                self.parse_errors.append(Finding(
                    code="SC001", message=f"file does not parse: {e.msg}",
                    path=rel, line=e.lineno or 1, scope=""))
        self._docs_text: Optional[str] = None
        self._reference_only: Optional[Dict[str, str]] = None
        self._aux_sources: Optional[str] = None

    def module(self, rel_suffix: str) -> Optional[ModuleInfo]:
        """Find a module by repo-relative path suffix
        (e.g. 'util/faults.py')."""
        for m in self.modules:
            if m.relpath.endswith(rel_suffix):
                return m
        return None

    def docs_text(self) -> str:
        """Concatenated markdown of the shared pages <root>/docs/*.md and
        the port's own pages <root>/docs/torch/*.md — the documentation
        side of every code↔docs contract."""
        if self._docs_text is None:
            parts = []
            for sub in DOC_DIRS:
                docs = os.path.join(self.root, sub)
                if os.path.isdir(docs):
                    for name in sorted(os.listdir(docs)):
                        if name.endswith(".md"):
                            with open(os.path.join(docs, name),
                                      encoding="utf-8") as f:
                                parts.append(f.read())
            self._docs_text = "\n".join(parts)
        return self._docs_text

    def doc_page(self, name: str) -> str:
        """One page by name: the shared docs/<name> followed by the
        port's docs/torch/<name> where it exists (the port catalogues
        what only it has beside the shared catalogue)."""
        parts = []
        for sub in DOC_DIRS:
            p = os.path.join(self.root, sub, name)
            if os.path.exists(p):
                with open(p, encoding="utf-8") as f:
                    parts.append(f.read())
        return "\n".join(parts)

    def reference_only(self) -> Dict[str, str]:
        """name -> reason for every row of the port's `reference-only`
        tables under docs/torch/: JAX package names (env vars, series,
        config keys) the shared pages document and the port
        deliberately does not have.  The contract passes treat such a
        name as documented and not read by design."""
        if self._reference_only is None:
            out: Dict[str, str] = {}
            text = ""
            d = os.path.join(self.root, DOC_DIRS[1])
            if os.path.isdir(d):
                for name in sorted(os.listdir(d)):
                    if name.endswith(".md"):
                        with open(os.path.join(d, name),
                                  encoding="utf-8") as f:
                            text += f.read() + "\n"
            for block in _REFERENCE_ONLY_RE.findall(text):
                for row in block.splitlines():
                    cells = [c.strip() for c in row.strip().strip("|")
                             .split("|")]
                    m = re.fullmatch(r"`([^`]+)`", cells[0]) \
                        if cells else None
                    if m and len(cells) >= 2:
                        out[m.group(1)] = cells[-1]
            self._reference_only = out
        return self._reference_only

    def aux_source_text(self) -> str:
        """Raw text of the port's consumers (not AST-analyzed — they are
        consumers, not the analyzed surface): tests/test_torch_*.py,
        tests/torch_*.py, tools/torch_*.py and chip_smoke.py, so
        contract passes can tell 'registered but unused anywhere' from
        'used only by tests'.  The JAX package's tests and tools are not
        the port's consumers: a name only they use is not the port's."""
        if self._aux_sources is None:
            parts = []
            for sub, prefixes in _AUX_SOURCES:
                d = os.path.join(self.root, sub)
                if not os.path.isdir(d):
                    continue
                for fn in sorted(os.listdir(d)):
                    if fn.endswith(".py") and fn.startswith(prefixes):
                        with open(os.path.join(d, fn),
                                  encoding="utf-8") as f:
                            parts.append(f.read())
            self._aux_sources = "\n".join(parts)
        return self._aux_sources


class CallGraph:
    """Self-method call graph of one class — the interprocedural layer
    under the SC4xx durability passes.  The earlier passes resolve
    `self._helper()` exactly one level; this closes the relation so a
    pass can ask "which methods can *transitively* reach X" (a journal
    flush, a fence poll, a durable-state mutation) without re-walking
    the class per query.

    Edges include bare `self.method` references (not just calls): a
    method handed to `threading.Thread(target=self._loop)` is reachable
    from the spawning method for every safety question these passes
    ask."""

    def __init__(self, mod: "ModuleInfo", cls: ast.ClassDef):
        self.mod = mod
        self.cls = cls
        self.methods: Dict[str, ast.FunctionDef] = {}
        for stmt in cls.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.methods.setdefault(stmt.name, stmt)
        self.callees: Dict[str, Set[str]] = {}
        names = set(self.methods)
        for name, fn in self.methods.items():
            refs: Set[str] = set()
            for node in ast.walk(fn):
                if isinstance(node, ast.Attribute) \
                        and isinstance(node.value, ast.Name) \
                        and node.value.id == "self" \
                        and node.attr in names:
                    refs.add(node.attr)
            self.callees[name] = refs
        self._closure: Dict[str, Set[str]] = {}

    def transitive_callees(self, name: str) -> Set[str]:
        """Every method reachable from `name` via self-references
        (`name` itself excluded unless it is recursive)."""
        cached = self._closure.get(name)
        if cached is not None:
            return cached
        seen: Set[str] = set()
        stack = list(self.callees.get(name, ()))
        while stack:
            m = stack.pop()
            if m in seen:
                continue
            seen.add(m)
            stack.extend(self.callees.get(m, ()))
        self._closure[name] = seen
        return seen

    def reaches(self, name: str, targets: Iterable[str]) -> bool:
        """Can `name` reach any of `targets` (directly or
        transitively)?"""
        t = set(targets)
        return bool(t & (self.transitive_callees(name) | {name}))

    def reaching(self, targets: Iterable[str]) -> Set[str]:
        """Reverse closure: every method that can reach any of
        `targets` (the targets themselves included when defined
        here)."""
        t = set(targets)
        return {m for m in self.methods
                if m in t or t & self.transitive_callees(m)}


class PathSimulator:
    """Per-path abstract interpretation over one function body — the
    path-sensitivity layer under SC401 (write-ahead discipline).

    Subclasses choose a state lattice (any immutable value) and
    override `initial`/`join`/`transfer`; the walker handles control
    flow so passes don't re-implement it:

      * `if` — union of both arms;
      * loops — fixpoint (body zero or more times);
      * `try` — handlers entered from *any prefix* of the body
        (an exception can strike between any two statements);
      * `finally` — applied before any `return` inside the `try`
        escapes (a handler that journals in `finally` commits before
        its ack leaves the function);
      * `return`/`raise` — terminate the path (`on_return` fires for
        returns, after enclosing `finally` bodies are applied).

    `on_end` fires with the state at the implicit fall-off-the-end
    return."""

    _FIXPOINT_LIMIT = 16

    def initial(self):
        return frozenset()

    def join(self, a, b):
        return a | b

    def transfer(self, state, stmt: ast.stmt):
        return state

    def on_return(self, state, node: ast.AST) -> None:
        pass

    def on_end(self, state, node: ast.AST) -> None:
        pass

    def run(self, fn: ast.FunctionDef) -> None:
        self._finally_stack: List[List[ast.stmt]] = []
        end = self._block(fn.body, self.initial())
        if end is not None:
            self.on_end(end, fn)

    # -- walker ----------------------------------------------------------

    def _block(self, stmts: Sequence[ast.stmt], state):
        """Returns the fall-through state, or None when every path
        terminated (return/raise/continue/break)."""
        for stmt in stmts:
            if state is None:
                break
            state = self._stmt(stmt, state)
        return state

    def _join_opt(self, a, b):
        if a is None:
            return b
        if b is None:
            return a
        return self.join(a, b)

    def _stmt(self, stmt: ast.stmt, state):
        if isinstance(stmt, ast.Return):
            st = self.transfer(state, stmt)
            for finalbody in reversed(self._finally_stack):
                out = self._block(finalbody, st)
                if out is not None:
                    st = out
            self.on_return(st, stmt)
            return None
        if isinstance(stmt, ast.Raise):
            self.transfer(state, stmt)
            return None
        if isinstance(stmt, (ast.Break, ast.Continue)):
            return None
        if isinstance(stmt, ast.If):
            return self._join_opt(self._block(stmt.body, state),
                                  self._block(stmt.orelse, state))
        if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            cur = state
            for _ in range(self._FIXPOINT_LIMIT):
                out = self._block(stmt.body, cur)
                nxt = cur if out is None else self.join(cur, out)
                if nxt == cur:
                    break
                cur = nxt
            return self._join_opt(cur, self._block(stmt.orelse, cur)
                                  if stmt.orelse else cur)
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            return self._block(stmt.body, self.transfer(state, stmt))
        if isinstance(stmt, ast.Try):
            handler_entry = state
            cur = state
            for s in stmt.body:
                if cur is None:
                    break
                if stmt.finalbody:
                    self._finally_stack.append(stmt.finalbody)
                try:
                    cur = self._stmt(s, cur)
                finally:
                    if stmt.finalbody:
                        self._finally_stack.pop()
                if cur is not None:
                    handler_entry = self.join(handler_entry, cur)
            out = None
            if cur is not None:
                out = self._block(stmt.orelse, cur) \
                    if stmt.orelse else cur
            for h in stmt.handlers:
                out = self._join_opt(out,
                                     self._block(h.body, handler_entry))
            if stmt.finalbody:
                if out is None:
                    # every path inside returned/raised — the finally
                    # still runs (returns already flowed through it via
                    # the stack), but nothing falls through
                    self._block(stmt.finalbody, handler_entry)
                    return None
                out = self._block(stmt.finalbody, out)
            return out
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return state
        return self.transfer(state, stmt)


class AnalysisPass:
    """Base class: subclasses set `name`, document their `codes`, and
    implement run().  Finding codes are the stable public surface —
    suppressions and baselines refer to them, so codes are never
    renumbered."""

    name: str = ""
    codes: Dict[str, str] = {}

    def run(self, project: Project) -> List[Finding]:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------

class BaselineError(Exception):
    pass


def load_baseline(path: str) -> Dict[str, dict]:
    """fingerprint -> entry.  Every entry must carry a non-empty
    one-line justification: the baseline is a reviewed list of accepted
    exceptions, not a dumping ground."""
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    entries = doc.get("entries", [])
    out: Dict[str, dict] = {}
    for e in entries:
        fp = e.get("fingerprint")
        if not fp:
            raise BaselineError(f"{path}: entry without fingerprint: {e}")
        just = (e.get("justification") or "").strip()
        if not just or just.upper().startswith("TODO"):
            raise BaselineError(
                f"{path}: entry {fp} lacks a justification — every "
                "baselined finding needs a one-line reason")
        if fp in out:
            raise BaselineError(
                f"{path}: duplicate fingerprint {fp} — one entry per "
                "accepted finding (merge the duplicates; a copy-paste "
                "here silently double-counts an exception)")
        out[fp] = e
    return out


def write_baseline(path: str, findings: Iterable[Finding],
                   previous: Optional[Dict[str, dict]] = None,
                   justification: str = "TODO: justify") -> int:
    """(Re)write the baseline from `findings`, keeping justifications of
    entries that persist from `previous`.  Returns the number of NEW
    entries (which carry the placeholder/bulk `justification` and must
    be edited before load_baseline will accept the file, unless a real
    justification was passed)."""
    previous = previous or {}
    entries, new, written = [], 0, set()
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.code)):
        # findings on twin lines of one scope share a fingerprint, and
        # load_baseline refuses duplicates: one entry covers them all
        if f.fingerprint in written:
            continue
        written.add(f.fingerprint)
        old = previous.get(f.fingerprint)
        if old is None:
            new += 1
        entries.append({
            "fingerprint": f.fingerprint,
            "code": f.code,
            "path": f.path,
            "scope": f.scope,
            "message": f.message,
            "justification": (old or {}).get("justification",
                                             justification),
        })
    doc = {"comment": "scanner-check accepted findings; every entry "
                      "needs a one-line justification "
                      "(docs/static-analysis.md)",
           "entries": entries}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    return new


@dataclass
class SplitResult:
    unsuppressed: List[Finding] = field(default_factory=list)
    inline_suppressed: List[Finding] = field(default_factory=list)
    baselined: List[Finding] = field(default_factory=list)
    stale_baseline: List[str] = field(default_factory=list)


def split_findings(project: Project, findings: Sequence[Finding],
                   baseline: Optional[Dict[str, dict]] = None
                   ) -> SplitResult:
    """Partition raw findings into actionable / inline-suppressed /
    baselined, and report baseline entries that no longer match
    anything (stale — they should be pruned)."""
    baseline = baseline or {}
    by_path = {m.relpath: m for m in project.modules}
    res = SplitResult()
    seen_fps: Set[str] = set()
    for f in findings:
        seen_fps.add(f.fingerprint)
        mod = by_path.get(f.path)
        if mod is not None and mod.suppressed(f.code, f.line):
            res.inline_suppressed.append(f)
        elif f.fingerprint in baseline:
            res.baselined.append(f)
        else:
            res.unsuppressed.append(f)
    res.stale_baseline = sorted(set(baseline) - seen_fps)
    return res
