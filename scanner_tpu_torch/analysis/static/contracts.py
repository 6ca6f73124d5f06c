"""Contract lints: code ↔ docs ↔ wiring drift (SC301–SC307).

Operational surfaces (the metric catalog, env-var and config knobs,
fault-injection sites, the RPC method table) are contracts: dashboards,
deploy manifests, chaos plans, and runbooks are written against them.
Nothing but convention keeps them in sync with the source — so these
passes make each one checkable:

  SC301  metric series registered in source but missing from the
         docs/observability.md catalog (or catalogued but gone)
  SC302  metric naming contract: `scanner_tpu_[a-z0-9_]+`, counters end
         `_total`, every series carries a help string
  SC303  `SCANNER_TPU_*` env var read in source but undocumented under
         docs/ (or documented but never read)
  SC304  config `[section] key` read that `config.default_config()`
         doesn't declare, or a declared key no doc page mentions
  SC305  fault-injection drift: `faults.inject("site")` literal not in
         `faults.SITES`, a SITES entry with no wired hook, or a
         NAMED_PLANS clause naming an unknown site
  SC306  RPC drift: a client `.call("Method")` no server registers, or
         a registered handler nothing in the repo ever invokes
  SC307  RPC classification: every registered handler needs an
         `RPC_CONTRACTS` entry (timeout class + idempotency — what the
         retry/backoff layer is allowed to do with it)
  SC308  alert-rule contract drift: the health engine's DEFAULT_RULES
         names and the docs/observability.md default-ruleset table may
         not drift (both directions; the table is delimited by
         `default-alert-rules:begin/end` markers), and the `[alerts]`
         config section must declare exactly the keys
         health.CONFIG_KEYS accepts
  SC309  cost-model / efficiency-series drift: every device (TPU)
         kernel registered under `kernels/` must declare a `cost()`
         descriptor hook (roofline attribution, util/coststats.py),
         and coststats' EFFICIENCY_SERIES tuple, the series it
         actually registers, and the marker-delimited efficiency table
         in docs/observability.md (`efficiency-series:begin/end`) may
         not drift — all three pairings, both directions
  SC310  frame-cache contract drift (engine/framecache.py): the
         FRAMECACHE_SERIES tuple, the series the module actually
         registers, and the marker-delimited table in
         docs/observability.md (`framecache-series:begin/end`) may not
         drift (all pairings, both directions); and the `[perf]`
         frame_cache_* config keys config.default_config() declares
         must be exactly framecache.CONFIG_KEYS (both directions)
  SC311  remediation contract drift (engine/controller.py): every
         DEFAULT_PLAYBOOKS entry must bind an alert that exists in
         health.DEFAULT_RULES; the playbook names and alert bindings
         must match the marker-delimited playbook matrix in
         docs/robustness.md (`remediation-playbooks:begin/end`), both
         directions; and the `[remediation]` config keys
         config.default_config() declares must be exactly
         controller.CONFIG_KEYS (both directions)
  SC312  generation-fence routing drift (engine/service.py +
         engine/journal.py): every RPC_CONTRACTS entry classified
         `idempotent=False` must register its MASTER_SERVICE handler
         wrapped in the generation-fence helper (`self._fenced(...)`),
         and every fence-wrapped registration must be classified
         non-idempotent — a mutating handler outside the fence lets a
         superseded (stale) master keep accepting mutations; and the
         `[robustness]` journal_* config keys config.default_config()
         declares must be exactly journal.CONFIG_KEYS (both
         directions)
  SC313  gang contract drift (engine/service.py + engine/gang.py,
         extending SC312): every `Gang*` RPC_CONTRACTS entry must be
         classified `idempotent=False` AND register its master handler
         through the generation fence, in both directions — gang RPCs
         mutate scheduling state and additionally carry the
         (gang_id, epoch) fence, so an unfenced or misclassified gang
         handler would let a stale master (or a blind retry)
         double-apply completion/abort traffic; and the `[gang]`
         config keys config.default_config() declares, the
         gang.CONFIG_KEYS tuple, and the `[gang] <key>` rows in
         docs/guide.md may not drift (all pairings, both directions)
  SC314  cross-host time contract drift (util/clocksync.py +
         engine/gang.py): clocksync.CLOCKSYNC_SERIES and
         gang.GANG_PHASE_SERIES must match the series each module
         registers, and their union must match the marker-delimited
         table in docs/observability.md
         (`clocksync-series:begin/end`), both directions; the
         `gang.*` span names engine/gang.py opens must match the
         `gang-phase-taxonomy:begin/end` table in
         docs/observability.md, both directions — an undocumented
         phase span (or a documented phantom) makes merged-timeline
         skew triage lie; and the `[trace]` clock keys
         config.default_config() declares (all but the tracing-owned
         `enabled`) must be exactly clocksync.CONFIG_KEYS (both
         directions)
  SC315  sharded gang data-plane drift (engine/gang.py):
         gang.GANG_SHARD_SERIES must match the `_shard_`-named series
         the module registers AND the marker-delimited
         `gang-shard-series:begin/end` table in docs/observability.md
         (all pairings, both directions); and the sharded path's
         config gates (`[gang] sharded` / `halo_exchange`) must
         travel with the data plane — gang.CONFIG_KEYS and
         config.default_config() must declare both whenever
         GANG_SHARD_SERIES exists, and a gate without a data plane is
         flagged too (both directions)
  SC316  sharded control-plane drift (engine/shardmap.py +
         engine/service.py): shardmap.SHARD_SERIES must match the
         series the module registers AND the marker-delimited
         `shard-series:begin/end` table in docs/observability.md
         (all pairings, both directions); the `[control]` config
         keys config.default_config() declares must be exactly
         shardmap.CONFIG_KEYS (both directions); and the
         shard-routed RPC surface may not drift (extending SC312):
         every service.SHARD_ROUTED_RPCS method must be classified
         `idempotent=False` and register its master handler through
         the generation fence, and every idempotent=False contract
         must be shard-routed — a mutating RPC missing from the
         routing tuple would land on the dial-time shard regardless
         of which master owns the bulk it mutates
  SC317  whole-pipeline fusion drift (graph/fusion.py):
         fusion.FUSION_SERIES must match the series the module
         registers AND the marker-delimited
         `fusion-series:begin/end` table in docs/observability.md
         (all pairings, both directions); the `[perf] fusion_*`
         config keys config.default_config() declares must be
         exactly fusion.CONFIG_KEYS (both directions); and a kernel
         class overriding `execute_traced` (declaring itself
         trace-composable for fusion) without a `cost()` hook is
         flagged (extends SC309) — the planner's fusability gate
         keys on cost(), so such a kernel silently never fuses
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core import AnalysisPass, Finding, ModuleInfo, Project
from .tracer import dotted_name

_SERIES_RE = re.compile(r"scanner_tpu_[a-z0-9_]*[a-z0-9]")
_SERIES_OK_RE = re.compile(r"scanner_tpu_[a-z0-9_]+\Z")
_ENV_RE = re.compile(r"SCANNER_TPU_[A-Z0-9_]*[A-Z0-9]")
# prometheus exposition suffixes a doc may legitimately mention
_EXPOSITION_SUFFIXES = ("_bucket", "_sum", "_count")

_REG_KINDS = ("counter", "gauge", "histogram")


def _const_str(node: Optional[ast.AST]) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _read_doc(project: Project, name: str) -> str:
    """The shared docs/<name> and the port's docs/torch/<name>."""
    return project.doc_page(name)


# ---------------------------------------------------------------------------
# metric registrations
# ---------------------------------------------------------------------------

class _Registration:
    def __init__(self, mod: ModuleInfo, node: ast.Call, kind: str,
                 name: Optional[str], help_arg: Optional[ast.AST]):
        self.mod = mod
        self.node = node
        self.kind = kind
        self.name = name
        self.help_arg = help_arg


def _metric_registrations(mod: ModuleInfo) -> List[_Registration]:
    out = []
    for node in ast.walk(mod.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _REG_KINDS):
            continue
        base = node.func.value
        if isinstance(base, ast.Call):
            base_ok = (dotted_name(base.func) or "").split(".")[-1] \
                == "registry"
        else:
            # module-level singleton idiom: _REGISTRY.gauge(...)
            base_ok = (dotted_name(base) or "").split(".")[-1] \
                .lower().lstrip("_") == "registry"
        if not base_ok:
            continue
        name = _const_str(node.args[0]) if node.args else None
        help_arg = node.args[1] if len(node.args) > 1 else None
        out.append(_Registration(mod, node, node.func.attr, name,
                                 help_arg))
    return out


# ---------------------------------------------------------------------------
# env reads
# ---------------------------------------------------------------------------

def _env_reads(mod: ModuleInfo) -> List[Tuple[str, ast.AST]]:
    """(var, node) for every SCANNER_TPU_* read through os.environ /
    environ / env (.get / [] / .pop)."""
    out: List[Tuple[str, ast.AST]] = []

    def is_env_base(e: ast.AST) -> bool:
        d = dotted_name(e) or ""
        return d.split(".")[-1] in ("environ",) or d in ("env",)

    for node in ast.walk(mod.tree):
        var: Optional[str] = None
        if isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute) \
                and node.func.attr in ("get", "pop") \
                and is_env_base(node.func.value) and node.args:
            var = _const_str(node.args[0])
        elif isinstance(node, ast.Subscript) and is_env_base(node.value):
            var = _const_str(node.slice)
        if var and _ENV_RE.fullmatch(var):
            out.append((var, node))
    return out


# ---------------------------------------------------------------------------
# config reads
# ---------------------------------------------------------------------------

def _default_config_keys(mod: ModuleInfo) -> Set[Tuple[str, str]]:
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.FunctionDef) \
                and node.name == "default_config":
            for sub in ast.walk(node):
                if isinstance(sub, ast.Return) and isinstance(
                        sub.value, ast.Dict):
                    keys: Set[Tuple[str, str]] = set()
                    for sk, sv in zip(sub.value.keys, sub.value.values):
                        sec = _const_str(sk)
                        if sec is None or not isinstance(sv, ast.Dict):
                            continue
                        for kk in sv.keys:
                            k = _const_str(kk)
                            if k is not None:
                                keys.add((sec, k))
                    return keys
    return set()


def _config_reads(mod: ModuleInfo) -> List[Tuple[str, str, ast.AST]]:
    """(section, key, node) for config dict reads:
    cfg["sec"]["key"], cfg.get("sec", {}).get("key", d), and one level
    of local aliasing (n = cfg["sec"]; n.get("key"))."""
    out: List[Tuple[str, str, ast.AST]] = []

    def is_cfg_base(e: ast.AST) -> bool:
        if isinstance(e, ast.Attribute) and e.attr == "config":
            return True
        return isinstance(e, ast.Name) and e.id in ("cfg", "config")

    def section_of(e: ast.AST) -> Optional[str]:
        """'storage' if e is <cfg-base>["storage"] or
        <cfg-base>.get("storage", ...)"""
        if isinstance(e, ast.Subscript) and is_cfg_base(e.value):
            return _const_str(e.slice)
        if isinstance(e, ast.Call) and isinstance(e.func, ast.Attribute) \
                and e.func.attr in ("get", "setdefault") \
                and is_cfg_base(e.func.value) and e.args:
            return _const_str(e.args[0])
        return None

    for fn in [n for n in ast.walk(mod.tree)
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]:
        aliases: Dict[str, str] = {}
        for sub in ast.walk(fn):
            if isinstance(sub, ast.Assign) and len(sub.targets) == 1 \
                    and isinstance(sub.targets[0], ast.Name):
                sec = section_of(sub.value)
                if sec is not None:
                    aliases[sub.targets[0].id] = sec

        def base_section(e: ast.AST) -> Optional[str]:
            sec = section_of(e)
            if sec is not None:
                return sec
            if isinstance(e, ast.Name):
                return aliases.get(e.id)
            return None

        for sub in ast.walk(fn):
            if isinstance(sub, ast.Subscript):
                sec = base_section(sub.value)
                key = _const_str(sub.slice)
                if sec is not None and key is not None:
                    out.append((sec, key, sub))
            elif isinstance(sub, ast.Call) and isinstance(
                    sub.func, ast.Attribute) and sub.func.attr == "get" \
                    and sub.args:
                sec = base_section(sub.func.value)
                key = _const_str(sub.args[0])
                if sec is not None and key is not None:
                    out.append((sec, key, sub))
    return out


# ---------------------------------------------------------------------------
# fault sites
# ---------------------------------------------------------------------------

def _module_tuple(mod: ModuleInfo, name: str) -> Optional[List[str]]:
    for stmt in mod.tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name) \
                and stmt.targets[0].id == name \
                and isinstance(stmt.value, (ast.Tuple, ast.List)):
            vals = [_const_str(e) for e in stmt.value.elts]
            return [v for v in vals if v is not None]
    return None


def _module_dict_keys(mod: ModuleInfo, name: str) -> Optional[Set[str]]:
    """String keys of a module-level dict assignment whose VALUES may be
    arbitrary expressions (faults._EXC maps exc names to constructors —
    _module_str_dict cannot read it)."""
    for stmt in mod.tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name) \
                and stmt.targets[0].id == name \
                and isinstance(stmt.value, ast.Dict):
            keys = {_const_str(k) for k in stmt.value.keys}
            return {k for k in keys if k is not None}
    return None


def _module_str_dict(mod: ModuleInfo, name: str
                     ) -> Optional[Dict[str, str]]:
    for stmt in mod.tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name) \
                and stmt.targets[0].id == name \
                and isinstance(stmt.value, ast.Dict):
            out = {}
            for k, v in zip(stmt.value.keys, stmt.value.values):
                ks, vs = _const_str(k), _const_str(v)
                if ks is not None and vs is not None:
                    out[ks] = vs
            return out
    return None


# ---------------------------------------------------------------------------
# rpc surface
# ---------------------------------------------------------------------------

def _rpc_registrations(mod: ModuleInfo) -> List[Tuple[str, ast.AST]]:
    """(method_name, dict_key_node) from RpcServer(service, {...})."""
    out: List[Tuple[str, ast.AST]] = []
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call) \
                and (dotted_name(node.func) or "").split(".")[-1] \
                == "RpcServer" and len(node.args) >= 2 \
                and isinstance(node.args[1], ast.Dict):
            for k in node.args[1].keys:
                name = _const_str(k)
                if name is not None:
                    out.append((name, k))
    return out


def _rpc_invocations(mod: ModuleInfo) -> List[Tuple[str, ast.AST]]:
    out: List[Tuple[str, ast.AST]] = []
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute) \
                and node.func.attr in ("call", "try_call") and node.args:
            name = _const_str(node.args[0])
            if name is not None:
                out.append((name, node))
    return out


_AUX_CALL_RE = re.compile(r"\.(?:try_)?call\(\s*['\"]([A-Za-z_][\w]*)")


# ---------------------------------------------------------------------------
# the pass
# ---------------------------------------------------------------------------

class ContractPass(AnalysisPass):
    name = "contracts"
    codes = {
        "SC301": "metric series out of sync with docs/observability.md",
        "SC302": "metric naming/help contract violation",
        "SC303": "SCANNER_TPU_* env var out of sync with docs/",
        "SC304": "config key read undeclared or undocumented",
        "SC305": "fault-injection site drift (SITES vs wired hooks)",
        "SC306": "RPC method drift (called vs registered)",
        "SC307": "RPC handler missing RPC_CONTRACTS classification",
        "SC308": "alert-rule drift (DEFAULT_RULES vs docs vs [alerts])",
        "SC309": "cost-model / efficiency-series drift (kernel cost "
                 "hooks, EFFICIENCY_SERIES, docs efficiency table)",
        "SC310": "frame-cache contract drift (FRAMECACHE_SERIES, docs "
                 "framecache table, [perf] frame_cache_* config keys)",
        "SC311": "remediation contract drift (DEFAULT_PLAYBOOKS vs "
                 "health rules vs docs playbook matrix vs "
                 "[remediation] config keys)",
        "SC312": "generation-fence routing drift (idempotent=False "
                 "RPC_CONTRACTS entries vs _fenced-wrapped master "
                 "handlers vs [robustness] journal config keys)",
        "SC313": "gang contract drift (Gang* RPC_CONTRACTS entries "
                 "must be non-idempotent + fence-wrapped; [gang] "
                 "config keys vs gang.CONFIG_KEYS vs docs/guide.md "
                 "rows)",
        "SC314": "cross-host time contract drift (CLOCKSYNC_SERIES + "
                 "GANG_PHASE_SERIES vs registrations vs docs "
                 "clocksync-series table; gang.* span names vs the "
                 "gang-phase-taxonomy table; [trace] clock keys vs "
                 "clocksync.CONFIG_KEYS)",
        "SC315": "sharded gang data-plane drift (GANG_SHARD_SERIES vs "
                 "gang registrations vs docs gang-shard-series table; "
                 "[gang] sharded/halo_exchange gates vs the data "
                 "plane)",
        "SC316": "sharded control-plane drift (SHARD_SERIES vs "
                 "shardmap registrations vs docs shard-series table; "
                 "[control] keys vs shardmap.CONFIG_KEYS; "
                 "SHARD_ROUTED_RPCS vs idempotent=False + "
                 "fence-wrapped master handlers)",
        "SC317": "whole-pipeline fusion drift (FUSION_SERIES vs "
                 "fusion registrations vs docs fusion-series table; "
                 "[perf] fusion_* keys vs fusion.CONFIG_KEYS; "
                 "execute_traced overrides without a cost() hook)",
    }

    def run(self, project: Project) -> List[Finding]:
        out: List[Finding] = []
        out.extend(self._metrics(project))
        out.extend(self._env_vars(project))
        out.extend(self._config_keys(project))
        out.extend(self._fault_sites(project))
        out.extend(self._rpc_surface(project))
        out.extend(self._alert_rules(project))
        out.extend(self._cost_model(project))
        out.extend(self._frame_cache(project))
        out.extend(self._remediation(project))
        out.extend(self._fence_routing(project))
        out.extend(self._gang_contract(project))
        out.extend(self._clocksync_contract(project))
        out.extend(self._gang_shard_contract(project))
        out.extend(self._shard_contract(project))
        out.extend(self._fusion_contract(project))
        return out

    # -- SC301 / SC302 ---------------------------------------------------

    def _metrics(self, project: Project) -> List[Finding]:
        out: List[Finding] = []
        doc = _read_doc(project, "observability.md")
        doc_names = {n for n in _SERIES_RE.findall(doc)}
        registered: Dict[str, _Registration] = {}
        for mod in project.modules:
            for reg in _metric_registrations(mod):
                if reg.name is None:
                    # dynamic name: can't check statically — flag it,
                    # the whole catalog idea depends on literal names
                    out.append(mod.finding(
                        "SC302",
                        f"{reg.kind}() with a non-literal series name — "
                        "series must be static so the catalog lint can "
                        "see them", reg.node))
                    continue
                registered.setdefault(reg.name, reg)
                if not _SERIES_OK_RE.fullmatch(reg.name):
                    out.append(mod.finding(
                        "SC302",
                        f"series `{reg.name}` does not match "
                        "scanner_tpu_[a-z0-9_]+", reg.node))
                elif reg.kind == "counter" \
                        and not reg.name.endswith("_total"):
                    out.append(mod.finding(
                        "SC302",
                        f"counter `{reg.name}` should end `_total`",
                        reg.node))
                help_str = _const_str(reg.help_arg)
                if help_str is None or not help_str.strip():
                    out.append(mod.finding(
                        "SC302",
                        f"series `{reg.name}` lacks a help string",
                        reg.node))
                if doc and reg.name not in doc_names:
                    out.append(mod.finding(
                        "SC301",
                        f"series `{reg.name}` is not catalogued in "
                        "docs/observability.md", reg.node))
        if doc and registered:
            base_doc_names = set()
            for n in doc_names:
                for suf in _EXPOSITION_SUFFIXES:
                    if n.endswith(suf) and n[:-len(suf)] in doc_names:
                        break
                else:
                    base_doc_names.add(n)
            ref_only = project.reference_only()
            for name in sorted(set(ref_only) & set(registered)):
                reg = registered[name]
                out.append(reg.mod.finding(
                    "SC301",
                    f"series `{name}` is registered here but the port's "
                    "reference-only table says the port does not have "
                    "it", reg.node))
            for name in sorted(base_doc_names - set(registered)
                               - set(ref_only)):
                for suf in _EXPOSITION_SUFFIXES:
                    if name.endswith(suf) and name[:-len(suf)] \
                            in registered:
                        break
                else:
                    out.append(Finding(
                        code="SC301",
                        message=f"docs/observability.md catalogues "
                                f"`{name}` but no source registers it",
                        path="docs/observability.md", line=1, scope="",
                        snippet=name))
        return out

    # -- SC303 -----------------------------------------------------------

    def _env_vars(self, project: Project) -> List[Finding]:
        out: List[Finding] = []
        docs = project.docs_text()
        doc_vars = set(_ENV_RE.findall(docs))
        read_vars: Set[str] = set()
        for mod in project.modules:
            for var, node in _env_reads(mod):
                read_vars.add(var)
                if docs and var not in doc_vars:
                    out.append(mod.finding(
                        "SC303",
                        f"env var `{var}` is read here but documented "
                        "nowhere under docs/ — knobs nobody can find "
                        "don't exist", node))
        ref_only = project.reference_only()
        for mod in project.modules:
            for var, node in _env_reads(mod):
                if var in ref_only:
                    out.append(mod.finding(
                        "SC303",
                        f"env var `{var}` is read here but the port's "
                        "reference-only table says the port does not "
                        "read it", node))
        if docs and read_vars:
            # vars also appear in code as manifest WRITES (deploy.py) and
            # plain mentions; only flag doc vars never read anywhere in
            # the analyzed source or auxiliary text, nor listed as
            # reference-only (documented, not read by design)
            aux = project.aux_source_text() + "".join(
                m.source for m in project.modules)
            for var in sorted(doc_vars - read_vars - set(ref_only)):
                if var not in aux:
                    out.append(Finding(
                        code="SC303",
                        message=f"docs mention env var `{var}` but "
                                "nothing reads it",
                        path="docs", line=1, scope="", snippet=var))
        return out

    # -- SC304 -----------------------------------------------------------

    def _config_keys(self, project: Project) -> List[Finding]:
        out: List[Finding] = []
        cfg_mod = None
        for m in project.modules:
            if m.relpath.endswith("config.py") \
                    and _default_config_keys(m):
                cfg_mod = m
                break
        if cfg_mod is None:
            return out
        declared = _default_config_keys(cfg_mod)
        docs = project.docs_text()
        # reads anywhere in the analyzed tree must be declared keys
        # (master_address-style alternates must still be declared or
        # documented)
        declared_keys = {k for _s, k in declared}
        for mod in project.modules:
            for sec, key, node in _config_reads(mod):
                if (sec, key) in declared:
                    continue
                if key in declared_keys:
                    continue  # cross-section helper access patterns
                if docs and re.search(rf"\b{re.escape(key)}\b", docs):
                    continue  # undeclared but documented alternate
                out.append(mod.finding(
                    "SC304",
                    f"config read `[{sec}] {key}` is neither declared "
                    "in config.default_config() nor documented under "
                    "docs/", node))
        if docs:
            for sec, key in sorted(declared):
                if not re.search(rf"\b{re.escape(key)}\b", docs):
                    out.append(cfg_mod.finding(
                        "SC304",
                        f"config key `[{sec}] {key}` is declared in "
                        "default_config() but no docs/ page mentions it",
                        cfg_mod.tree))
        return out

    # -- SC305 -----------------------------------------------------------

    def _fault_sites(self, project: Project) -> List[Finding]:
        out: List[Finding] = []
        fmod = project.module("util/faults.py")
        if fmod is None:
            return out
        sites = _module_tuple(fmod, "SITES")
        if not sites:
            return out
        site_set = set(sites)
        hooked: Set[str] = set()
        for mod in project.modules:
            if mod is fmod:
                continue
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.Call) \
                        and (dotted_name(node.func) or "").split(".")[-1] \
                        == "inject" and node.args:
                    site = _const_str(node.args[0])
                    if site is None:
                        continue
                    hooked.add(site)
                    if site not in site_set:
                        out.append(mod.finding(
                            "SC305",
                            f"faults.inject({site!r}) names a site "
                            "missing from faults.SITES — install() will "
                            "reject every plan targeting it", node))
        for site in sites:
            if site not in hooked:
                out.append(fmod.finding(
                    "SC305",
                    f"faults.SITES entry `{site}` has no wired "
                    "inject() hook — plans targeting it arm nothing "
                    "and chaos tests pass vacuously", fmod.tree))
        plans = _module_str_dict(fmod, "NAMED_PLANS") or {}
        data_sites = _module_tuple(fmod, "DATA_SITES") or []
        # clause-level validation beyond the site name: a canned plan
        # with a typo'd mode or an exc= key the _EXC table doesn't
        # construct would only fail when someone finally runs it
        modes = set(_module_tuple(fmod, "MODES") or ())
        exc_keys = _module_dict_keys(fmod, "_EXC")
        for name, plan in plans.items():
            for clause in plan.split(";"):
                fields = clause.strip().split(":")
                site = fields[0]
                if site and site not in site_set:
                    out.append(fmod.finding(
                        "SC305",
                        f"NAMED_PLANS[{name!r}] targets unknown site "
                        f"`{site}`", fmod.tree))
                if len(fields) > 1 and modes and fields[1] not in modes:
                    out.append(fmod.finding(
                        "SC305",
                        f"NAMED_PLANS[{name!r}] uses unknown mode "
                        f"`{fields[1]}` (known: "
                        f"{', '.join(sorted(modes))})", fmod.tree))
                for f in fields[2:]:
                    k, sep, v = f.partition("=")
                    if sep and k == "exc" and exc_keys is not None \
                            and v not in exc_keys:
                        out.append(fmod.finding(
                            "SC305",
                            f"NAMED_PLANS[{name!r}] names unknown "
                            f"exc `{v}` — parse_plan will reject the "
                            "plan at arm time", fmod.tree))
        for site in data_sites:
            if site not in site_set:
                out.append(fmod.finding(
                    "SC305",
                    f"DATA_SITES entry `{site}` is not in SITES",
                    fmod.tree))
        return out

    # -- SC308 -----------------------------------------------------------

    _ALERT_DOC_BLOCK_RE = re.compile(
        r"<!--\s*default-alert-rules:begin\s*-->(.*?)"
        r"<!--\s*default-alert-rules:end\s*-->", re.S)
    _ALERT_DOC_NAME_RE = re.compile(r"^\|\s*`([a-z0-9_]+)`", re.M)

    @staticmethod
    def _default_rule_names(mod: ModuleInfo
                            ) -> Optional[List[Tuple[str, ast.AST]]]:
        """(name, node) per element of the module-level DEFAULT_RULES
        tuple — the literal `name=` kwarg (or first positional string)
        of each rule constructor call."""
        for stmt in mod.tree.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name) \
                    and stmt.targets[0].id == "DEFAULT_RULES" \
                    and isinstance(stmt.value, (ast.Tuple, ast.List)):
                out: List[Tuple[str, ast.AST]] = []
                for el in stmt.value.elts:
                    if not isinstance(el, ast.Call):
                        continue
                    name = None
                    for kw in el.keywords:
                        if kw.arg == "name":
                            name = _const_str(kw.value)
                    if name is None and el.args:
                        name = _const_str(el.args[0])
                    if name is not None:
                        out.append((name, el))
                return out
        return None

    def _alert_rules(self, project: Project) -> List[Finding]:
        out: List[Finding] = []
        hmod = project.module("util/health.py")
        if hmod is None:
            return out
        rules = self._default_rule_names(hmod)
        doc = _read_doc(project, "observability.md")
        if rules:
            block = self._ALERT_DOC_BLOCK_RE.search(doc) if doc else None
            if doc and block is None:
                out.append(hmod.finding(
                    "SC308",
                    "health.DEFAULT_RULES exists but docs/"
                    "observability.md has no default-alert-rules "
                    "marker table (<!-- default-alert-rules:begin/end "
                    "-->) — operators cannot see what alerts by "
                    "default", hmod.tree))
            elif block is not None:
                doc_names = set(
                    self._ALERT_DOC_NAME_RE.findall(block.group(1)))
                for name, node in rules:
                    if name not in doc_names:
                        out.append(hmod.finding(
                            "SC308",
                            f"default alert rule `{name}` is missing "
                            "from the docs/observability.md "
                            "default-ruleset table", node))
                for name in sorted(doc_names
                                   - {n for n, _ in rules}):
                    out.append(Finding(
                        code="SC308",
                        message=f"docs/observability.md default-ruleset "
                                f"table lists `{name}` but "
                                "health.DEFAULT_RULES has no such rule",
                        path="docs/observability.md", line=1, scope="",
                        snippet=name))
        # [alerts] config keys <-> health.CONFIG_KEYS, both directions:
        # a declared key the engine never reads is dead config; an
        # accepted key config doesn't declare is unreachable
        schema = _module_tuple(hmod, "CONFIG_KEYS")
        cfg_mod = None
        for m in project.modules:
            if m.relpath.endswith("config.py") \
                    and _default_config_keys(m):
                cfg_mod = m
                break
        if schema is not None and cfg_mod is not None:
            declared = {k for sec, k in _default_config_keys(cfg_mod)
                        if sec == "alerts"}
            if declared:
                for k in sorted(declared - set(schema)):
                    out.append(cfg_mod.finding(
                        "SC308",
                        f"config key `[alerts] {k}` is declared but "
                        "health.CONFIG_KEYS does not accept it",
                        cfg_mod.tree))
                for k in sorted(set(schema) - declared):
                    out.append(hmod.finding(
                        "SC308",
                        f"health.CONFIG_KEYS accepts `{k}` but "
                        "config.default_config() declares no "
                        f"`[alerts] {k}`", hmod.tree))
        return out

    # -- SC309 -----------------------------------------------------------

    _EFF_DOC_BLOCK_RE = re.compile(
        r"<!--\s*efficiency-series:begin\s*-->(.*?)"
        r"<!--\s*efficiency-series:end\s*-->", re.S)

    @staticmethod
    def _tpu_kernel_classes(mod: ModuleInfo
                            ) -> List[Tuple[str, bool, ast.AST]]:
        """(class name, has_cost, node) for every class registered as a
        TPU device op via a @register_op(device=DeviceType.TPU, ...)
        decorator."""
        out: List[Tuple[str, bool, ast.AST]] = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            is_tpu = False
            for dec in node.decorator_list:
                if not isinstance(dec, ast.Call):
                    continue
                if (dotted_name(dec.func) or "").split(".")[-1] \
                        != "register_op":
                    continue
                for kw in dec.keywords:
                    if kw.arg == "device" and (
                            dotted_name(kw.value) or "").endswith("TPU"):
                        is_tpu = True
            if is_tpu:
                has_cost = any(
                    isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and b.name == "cost" for b in node.body)
                out.append((node.name, has_cost, node))
        return out

    def _cost_model(self, project: Project) -> List[Finding]:
        out: List[Finding] = []
        # direction 1: every TPU device kernel in kernels/ declares its
        # analytical cost() hook — the roofline join otherwise degrades
        # to derived defaults silently, and a new stdlib op would ship
        # without an efficiency story
        for mod in project.modules:
            if "kernels/" not in mod.relpath:
                continue
            for name, has_cost, node in self._tpu_kernel_classes(mod):
                if not has_cost:
                    out.append(mod.finding(
                        "SC309",
                        f"TPU device kernel `{name}` declares no "
                        "cost() descriptor hook — roofline attribution "
                        "(util/coststats.py) falls back to derived "
                        "defaults; declare FLOPs/bytes as f(shape) or "
                        "justify the fallback", node))
        # directions 2+3: EFFICIENCY_SERIES <-> the series coststats
        # actually registers <-> the marker-delimited efficiency table
        # in docs/observability.md, both ways each
        cmod = project.module("util/coststats.py")
        if cmod is None:
            return out
        declared = _module_tuple(cmod, "EFFICIENCY_SERIES")
        if declared is None:
            return out
        declared_set = set(declared)
        registered = {r.name for r in _metric_registrations(cmod)
                      if r.name}
        for name in sorted(registered - declared_set):
            out.append(cmod.finding(
                "SC309",
                f"series `{name}` is registered in coststats but "
                "missing from EFFICIENCY_SERIES — the SC309 catalog "
                "contract cannot see it", cmod.tree))
        for name in sorted(declared_set - registered):
            out.append(cmod.finding(
                "SC309",
                f"EFFICIENCY_SERIES names `{name}` but coststats "
                "registers no such series", cmod.tree))
        doc = _read_doc(project, "observability.md")
        if not doc:
            return out
        block = self._EFF_DOC_BLOCK_RE.search(doc)
        if block is None:
            out.append(cmod.finding(
                "SC309",
                "coststats declares EFFICIENCY_SERIES but docs/"
                "observability.md has no efficiency-series marker "
                "table (<!-- efficiency-series:begin/end -->)",
                cmod.tree))
            return out
        doc_names = {n for n in _SERIES_RE.findall(block.group(1))}
        base_doc = set()
        for n in doc_names:
            for suf in _EXPOSITION_SUFFIXES:
                if n.endswith(suf) and n[:-len(suf)] in doc_names:
                    break
            else:
                base_doc.add(n)
        for name in sorted(declared_set - base_doc):
            out.append(cmod.finding(
                "SC309",
                f"efficiency series `{name}` is missing from the "
                "docs/observability.md efficiency-series table",
                cmod.tree))
        for name in sorted(base_doc - declared_set):
            out.append(Finding(
                code="SC309",
                message=f"docs/observability.md efficiency-series "
                        f"table lists `{name}` but coststats' "
                        "EFFICIENCY_SERIES has no such series",
                path="docs/observability.md", line=1, scope="",
                snippet=name))
        return out

    # -- SC310 -----------------------------------------------------------

    _FC_DOC_BLOCK_RE = re.compile(
        r"<!--\s*framecache-series:begin\s*-->(.*?)"
        r"<!--\s*framecache-series:end\s*-->", re.S)

    def _frame_cache(self, project: Project) -> List[Finding]:
        out: List[Finding] = []
        fmod = project.module("engine/framecache.py")
        if fmod is None:
            return out
        declared = _module_tuple(fmod, "FRAMECACHE_SERIES")
        if declared is not None:
            declared_set = set(declared)
            registered = {r.name for r in _metric_registrations(fmod)
                          if r.name}
            for name in sorted(registered - declared_set):
                out.append(fmod.finding(
                    "SC310",
                    f"series `{name}` is registered in framecache but "
                    "missing from FRAMECACHE_SERIES — the SC310 catalog "
                    "contract cannot see it", fmod.tree))
            for name in sorted(declared_set - registered):
                out.append(fmod.finding(
                    "SC310",
                    f"FRAMECACHE_SERIES names `{name}` but framecache "
                    "registers no such series", fmod.tree))
            doc = _read_doc(project, "observability.md")
            if doc:
                block = self._FC_DOC_BLOCK_RE.search(doc)
                if block is None:
                    out.append(fmod.finding(
                        "SC310",
                        "framecache declares FRAMECACHE_SERIES but "
                        "docs/observability.md has no framecache-series "
                        "marker table (<!-- framecache-series:begin/end "
                        "-->)", fmod.tree))
                else:
                    doc_names = {n for n in
                                 _SERIES_RE.findall(block.group(1))}
                    base_doc = set()
                    for n in doc_names:
                        for suf in _EXPOSITION_SUFFIXES:
                            if n.endswith(suf) \
                                    and n[:-len(suf)] in doc_names:
                                break
                        else:
                            base_doc.add(n)
                    for name in sorted(declared_set - base_doc):
                        out.append(fmod.finding(
                            "SC310",
                            f"frame-cache series `{name}` is missing "
                            "from the docs/observability.md "
                            "framecache-series table", fmod.tree))
                    for name in sorted(base_doc - declared_set):
                        out.append(Finding(
                            code="SC310",
                            message=f"docs/observability.md "
                                    f"framecache-series table lists "
                                    f"`{name}` but framecache's "
                                    "FRAMECACHE_SERIES has no such "
                                    "series",
                            path="docs/observability.md", line=1,
                            scope="", snippet=name))
        # [perf] frame_cache_* config keys <-> framecache.CONFIG_KEYS,
        # both directions (the SC308 [alerts] pattern): a declared key
        # the cache never reads is dead config; an accepted key config
        # doesn't declare is unreachable
        schema = _module_tuple(fmod, "CONFIG_KEYS")
        cfg_mod = None
        for m in project.modules:
            if m.relpath.endswith("config.py") \
                    and _default_config_keys(m):
                cfg_mod = m
                break
        if schema is not None and cfg_mod is not None:
            perf_keys = {k for sec, k in _default_config_keys(cfg_mod)
                         if sec == "perf"
                         and k.startswith("frame_cache")}
            if perf_keys or schema:
                for k in sorted(perf_keys - set(schema)):
                    out.append(cfg_mod.finding(
                        "SC310",
                        f"config key `[perf] {k}` is declared but "
                        "framecache.CONFIG_KEYS does not accept it",
                        cfg_mod.tree))
                for k in sorted(set(schema) - perf_keys):
                    out.append(fmod.finding(
                        "SC310",
                        f"framecache.CONFIG_KEYS accepts `{k}` but "
                        "config.default_config() declares no "
                        f"`[perf] {k}`", fmod.tree))
        return out

    # -- SC311 -----------------------------------------------------------

    _PB_DOC_BLOCK_RE = re.compile(
        r"<!--\s*remediation-playbooks:begin\s*-->(.*?)"
        r"<!--\s*remediation-playbooks:end\s*-->", re.S)
    # matrix rows lead `| `playbook` | `alert` | ...`
    _PB_DOC_ROW_RE = re.compile(
        r"^\|\s*`([a-z0-9_]+)`\s*\|\s*`([a-z0-9_]+)`", re.M)

    @staticmethod
    def _default_playbooks(mod: ModuleInfo
                           ) -> Optional[List[Tuple[str, str, ast.AST]]]:
        """(name, alert, node) per element of the module-level
        DEFAULT_PLAYBOOKS tuple — the literal `name=`/`alert=` kwargs
        of each playbook constructor call."""
        for stmt in mod.tree.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name) \
                    and stmt.targets[0].id == "DEFAULT_PLAYBOOKS" \
                    and isinstance(stmt.value, (ast.Tuple, ast.List)):
                out: List[Tuple[str, str, ast.AST]] = []
                for el in stmt.value.elts:
                    if not isinstance(el, ast.Call):
                        continue
                    name = alert = None
                    for kw in el.keywords:
                        if kw.arg == "name":
                            name = _const_str(kw.value)
                        elif kw.arg == "alert":
                            alert = _const_str(kw.value)
                    if name is not None and alert is not None:
                        out.append((name, alert, el))
                return out
        return None

    def _remediation(self, project: Project) -> List[Finding]:
        out: List[Finding] = []
        cmod = project.module("engine/controller.py")
        if cmod is None:
            return out
        playbooks = self._default_playbooks(cmod)
        if playbooks:
            # direction 1: every playbook binds a REAL alert — an
            # action wired to a rule name the health engine never
            # evaluates can never fire
            hmod = project.module("util/health.py")
            rule_names = {n for n, _node in
                          (self._default_rule_names(hmod) or ())} \
                if hmod is not None else None
            if rule_names is not None:
                for name, alert, node in playbooks:
                    if alert not in rule_names:
                        out.append(cmod.finding(
                            "SC311",
                            f"playbook `{name}` binds alert `{alert}` "
                            "but health.DEFAULT_RULES has no such rule "
                            "— the playbook can never fire", node))
            # directions 2+3: playbook names + alert bindings <-> the
            # docs/robustness.md marker matrix, both ways
            doc = _read_doc(project, "robustness.md")
            block = self._PB_DOC_BLOCK_RE.search(doc) if doc else None
            if doc and block is None:
                out.append(cmod.finding(
                    "SC311",
                    "controller declares DEFAULT_PLAYBOOKS but docs/"
                    "robustness.md has no remediation-playbooks marker "
                    "table (<!-- remediation-playbooks:begin/end -->) — "
                    "operators cannot see what auto-remediates",
                    cmod.tree))
            elif block is not None:
                doc_rows = dict(
                    self._PB_DOC_ROW_RE.findall(block.group(1)))
                by_name = {n: (a, node) for n, a, node in playbooks}
                for name, (alert, node) in sorted(by_name.items()):
                    if name not in doc_rows:
                        out.append(cmod.finding(
                            "SC311",
                            f"playbook `{name}` is missing from the "
                            "docs/robustness.md remediation-playbooks "
                            "matrix", node))
                    elif doc_rows[name] != alert:
                        out.append(cmod.finding(
                            "SC311",
                            f"playbook `{name}` binds alert `{alert}` "
                            f"but the docs matrix row says "
                            f"`{doc_rows[name]}`", node))
                for name in sorted(set(doc_rows) - set(by_name)):
                    out.append(Finding(
                        code="SC311",
                        message=f"docs/robustness.md "
                                f"remediation-playbooks matrix lists "
                                f"`{name}` but controller."
                                "DEFAULT_PLAYBOOKS has no such "
                                "playbook",
                        path="docs/robustness.md", line=1, scope="",
                        snippet=name))
        # [remediation] config keys <-> controller.CONFIG_KEYS, both
        # directions (the SC308/[alerts] pattern)
        schema = _module_tuple(cmod, "CONFIG_KEYS")
        cfg_mod = None
        for m in project.modules:
            if m.relpath.endswith("config.py") \
                    and _default_config_keys(m):
                cfg_mod = m
                break
        if schema is not None and cfg_mod is not None:
            declared = {k for sec, k in _default_config_keys(cfg_mod)
                        if sec == "remediation"}
            if declared:
                for k in sorted(declared - set(schema)):
                    out.append(cfg_mod.finding(
                        "SC311",
                        f"config key `[remediation] {k}` is declared "
                        "but controller.CONFIG_KEYS does not accept "
                        "it", cfg_mod.tree))
                for k in sorted(set(schema) - declared):
                    out.append(cmod.finding(
                        "SC311",
                        f"controller.CONFIG_KEYS accepts `{k}` but "
                        "config.default_config() declares no "
                        f"`[remediation] {k}`", cmod.tree))
        return out

    # -- SC312 -----------------------------------------------------------

    @staticmethod
    def _contract_idempotency(mod: ModuleInfo) -> Optional[Dict[str, object]]:
        """{method: idempotent-const-or-None} from the module-level
        RPC_CONTRACTS dict literal (None when the flag is not a bool
        constant — SC307 already flags incomplete entries)."""
        for stmt in mod.tree.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name) \
                    and stmt.targets[0].id == "RPC_CONTRACTS" \
                    and isinstance(stmt.value, ast.Dict):
                out: Dict[str, object] = {}
                for k, v in zip(stmt.value.keys, stmt.value.values):
                    ks = _const_str(k)
                    if ks is None:
                        continue
                    idem = None
                    if isinstance(v, ast.Dict):
                        for vk, vv in zip(v.keys, v.values):
                            if _const_str(vk) == "idempotent" \
                                    and isinstance(vv, ast.Constant) \
                                    and isinstance(vv.value, bool):
                                idem = vv.value
                    out[ks] = idem
                return out
        return None

    @staticmethod
    def _master_registrations(mod: ModuleInfo
                              ) -> Dict[str, Tuple[bool, ast.AST]]:
        """{method: (fence_wrapped, key_node)} from the RpcServer
        registration whose service argument resolves through
        MASTER_SERVICE — the fence only guards the master's control
        plane (worker-service handlers are all idempotent reads)."""
        out: Dict[str, Tuple[bool, ast.AST]] = {}
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and (dotted_name(node.func) or "").split(".")[-1]
                    == "RpcServer" and len(node.args) >= 2
                    and isinstance(node.args[1], ast.Dict)):
                continue
            svc = dotted_name(node.args[0]) or ""
            if not svc.split(".")[-1] == "MASTER_SERVICE":
                continue
            for k, v in zip(node.args[1].keys, node.args[1].values):
                name = _const_str(k)
                if name is None:
                    continue
                wrapped = isinstance(v, ast.Call) and (
                    dotted_name(v.func) or "").split(".")[-1] \
                    == "_fenced"
                out[name] = (wrapped, k)
        return out

    def _fence_routing(self, project: Project) -> List[Finding]:
        out: List[Finding] = []
        cmod: Optional[ModuleInfo] = None
        contracts: Optional[Dict[str, object]] = None
        for mod in project.modules:
            got = self._contract_idempotency(mod)
            if got is not None:
                cmod, contracts = mod, got
                break
        if cmod is not None and contracts is not None:
            registered = self._master_registrations(cmod)
            if registered:
                # direction 1: every mutating (idempotent=False)
                # contract routes its master handler through the fence
                for name, idem in sorted(contracts.items()):
                    if idem is not False or name not in registered:
                        continue
                    wrapped, node = registered[name]
                    if not wrapped:
                        out.append(cmod.finding(
                            "SC312",
                            f"RPC `{name}` is classified "
                            "idempotent=False but its master handler "
                            "is registered without the generation-"
                            "fence wrapper (`self._fenced(...)`) — a "
                            "superseded (stale) master would keep "
                            "accepting this mutation", node))
                # direction 2: every fence-wrapped registration is
                # classified non-idempotent — fencing a read means the
                # table and the code disagree about what mutates
                for name, (wrapped, node) in sorted(registered.items()):
                    if wrapped and contracts.get(name) is not False:
                        out.append(cmod.finding(
                            "SC312",
                            f"master handler `{name}` is wrapped in "
                            "the generation fence but RPC_CONTRACTS "
                            "does not classify it idempotent=False — "
                            "the table and the fence routing disagree "
                            "about whether it mutates", node))
        # [robustness] journal_* config keys <-> journal.CONFIG_KEYS,
        # both directions (the SC308/SC310/SC311 pattern)
        jmod = project.module("engine/journal.py")
        schema = _module_tuple(jmod, "CONFIG_KEYS") \
            if jmod is not None else None
        cfg_mod = None
        for m in project.modules:
            if m.relpath.endswith("config.py") \
                    and _default_config_keys(m):
                cfg_mod = m
                break
        if jmod is not None and schema is not None \
                and cfg_mod is not None:
            declared = {k for sec, k in _default_config_keys(cfg_mod)
                        if sec == "robustness"
                        and k.startswith("journal")}
            if declared or schema:
                for k in sorted(declared - set(schema)):
                    out.append(cfg_mod.finding(
                        "SC312",
                        f"config key `[robustness] {k}` is declared "
                        "but journal.CONFIG_KEYS does not accept it",
                        cfg_mod.tree))
                for k in sorted(set(schema) - declared):
                    out.append(jmod.finding(
                        "SC312",
                        f"journal.CONFIG_KEYS accepts `{k}` but "
                        "config.default_config() declares no "
                        f"`[robustness] {k}`", jmod.tree))
        return out

    # -- SC313 -----------------------------------------------------------

    _GANG_DOC_KEY_RE = re.compile(r"`\[gang\]\s+([a-z0-9_]+)`")

    def _gang_contract(self, project: Project) -> List[Finding]:
        """Gang contract lints: the Gang* RPC surface's fencing shape
        (specializing SC312 — a gang RPC must be BOTH classified
        non-idempotent and fence-wrapped, whichever side drifted), and
        the three-way [gang] config pairing (default_config ↔
        gang.CONFIG_KEYS ↔ docs/guide.md rows)."""
        out: List[Finding] = []
        cmod: Optional[ModuleInfo] = None
        contracts: Optional[Dict[str, object]] = None
        for mod in project.modules:
            got = self._contract_idempotency(mod)
            if got is not None:
                cmod, contracts = mod, got
                break
        if cmod is not None and contracts is not None:
            registered = self._master_registrations(cmod)
            gang_entries = sorted(n for n in contracts
                                  if n.startswith("Gang"))
            for name in gang_entries:
                if contracts.get(name) is not False:
                    out.append(cmod.finding(
                        "SC313",
                        f"gang RPC `{name}` is not classified "
                        "idempotent=False in RPC_CONTRACTS — gang "
                        "RPCs mutate scheduling state behind the "
                        "(gang_id, epoch) fence and must never ride "
                        "the blind-retry path", cmod.tree))
                if registered and name not in registered:
                    out.append(cmod.finding(
                        "SC313",
                        f"gang RPC `{name}` has an RPC_CONTRACTS "
                        "entry but no MASTER_SERVICE handler "
                        "registration", cmod.tree))
                elif registered and not registered[name][0]:
                    out.append(cmod.finding(
                        "SC313",
                        f"gang RPC `{name}`'s master handler is "
                        "registered without the generation-fence "
                        "wrapper (`self._fenced(...)`) — a superseded "
                        "master could keep accepting gang mutations",
                        registered[name][1]))
            if registered:
                for name, (_wrapped, node) in sorted(
                        registered.items()):
                    if name.startswith("Gang") \
                            and name not in contracts:
                        out.append(cmod.finding(
                            "SC313",
                            f"master registers gang handler `{name}` "
                            "with no RPC_CONTRACTS entry — the gang "
                            "surface must be classified", node))
        # [gang] config keys <-> gang.CONFIG_KEYS <-> docs/guide.md
        # rows, all pairings both directions (the SC312 journal
        # pattern plus the doc leg)
        gmod = project.module("engine/gang.py")
        schema = _module_tuple(gmod, "CONFIG_KEYS") \
            if gmod is not None else None
        cfg_mod = None
        for m in project.modules:
            if m.relpath.endswith("config.py") \
                    and _default_config_keys(m):
                cfg_mod = m
                break
        if gmod is not None and schema is not None \
                and cfg_mod is not None:
            declared = {k for sec, k in _default_config_keys(cfg_mod)
                        if sec == "gang"}
            if declared or schema:
                for k in sorted(declared - set(schema)):
                    out.append(cfg_mod.finding(
                        "SC313",
                        f"config key `[gang] {k}` is declared but "
                        "gang.CONFIG_KEYS does not accept it",
                        cfg_mod.tree))
                for k in sorted(set(schema) - declared):
                    out.append(gmod.finding(
                        "SC313",
                        f"gang.CONFIG_KEYS accepts `{k}` but "
                        "config.default_config() declares no "
                        f"`[gang] {k}`", gmod.tree))
                doc = _read_doc(project, "guide.md")
                if doc:
                    doc_keys = set(self._GANG_DOC_KEY_RE.findall(doc))
                    for k in sorted(set(schema) - doc_keys):
                        out.append(gmod.finding(
                            "SC313",
                            f"gang.CONFIG_KEYS accepts `{k}` but "
                            "docs/guide.md has no `[gang] "
                            f"{k}` row", gmod.tree))
                    for k in sorted(doc_keys - set(schema)):
                        out.append(Finding(
                            code="SC313",
                            message=f"docs/guide.md documents "
                                    f"`[gang] {k}` but "
                                    "gang.CONFIG_KEYS accepts no such "
                                    "key",
                            path="docs/guide.md", line=1, scope="",
                            snippet=k))
        return out

    # -- SC314 -----------------------------------------------------------

    _CS_DOC_BLOCK_RE = re.compile(
        r"<!--\s*clocksync-series:begin\s*-->(.*?)"
        r"<!--\s*clocksync-series:end\s*-->", re.S)
    _PHASE_DOC_BLOCK_RE = re.compile(
        r"<!--\s*gang-phase-taxonomy:begin\s*-->(.*?)"
        r"<!--\s*gang-phase-taxonomy:end\s*-->", re.S)
    _GANG_SPAN_RE = re.compile(r"`(gang\.[a-z0-9_.]+)`")

    @staticmethod
    def _doc_base_series(block_text: str) -> Set[str]:
        """Series names in a doc block, exposition suffixes folded
        into their base series (the SC309/SC310 convention)."""
        doc_names = set(_SERIES_RE.findall(block_text))
        base = set()
        for n in doc_names:
            for suf in _EXPOSITION_SUFFIXES:
                if n.endswith(suf) and n[:-len(suf)] in doc_names:
                    break
            else:
                base.add(n)
        return base

    @staticmethod
    def _gang_span_names(mod: ModuleInfo) -> Set[str]:
        """Every `gang.*` string literal handed to an open_span call —
        the code-side phase taxonomy."""
        names: Set[str] = set()
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "open_span"):
                continue
            for arg in node.args:
                s = _const_str(arg)
                if s is not None and s.startswith("gang."):
                    names.add(s)
        return names

    def _clocksync_contract(self, project: Project) -> List[Finding]:
        """Cross-host time lints: the clock-sync + gang-phase metric
        surface (module tuples ↔ registrations ↔ the clocksync-series
        doc table), the gang phase-span taxonomy (open_span literals
        ↔ the gang-phase-taxonomy doc table), and the `[trace]` clock
        keys (default_config ↔ clocksync.CONFIG_KEYS).  Merged
        timelines are only trustworthy if the reader can look every
        series and span name up — an undocumented phase is a blind
        spot in exactly the trace meant to explain stragglers."""
        out: List[Finding] = []
        csmod = project.module("util/clocksync.py")
        if csmod is None:
            return out
        gmod = project.module("engine/gang.py")
        doc = _read_doc(project, "observability.md")

        declared_union: Set[str] = set()
        have_tuple = False
        # per-module: the declared tuple must match what the module
        # registers.  clocksync registers nothing but clock series, so
        # the pairing is exact; gang.py also owns lifecycle counters,
        # so the reverse leg only claims phase/skew-named series
        cs_series = _module_tuple(csmod, "CLOCKSYNC_SERIES")
        if cs_series is not None:
            have_tuple = True
            declared_union |= set(cs_series)
            registered = {r.name for r in _metric_registrations(csmod)
                          if r.name}
            for name in sorted(registered - set(cs_series)):
                out.append(csmod.finding(
                    "SC314",
                    f"series `{name}` is registered in clocksync but "
                    "missing from CLOCKSYNC_SERIES — the SC314 catalog "
                    "contract cannot see it", csmod.tree))
            for name in sorted(set(cs_series) - registered):
                out.append(csmod.finding(
                    "SC314",
                    f"CLOCKSYNC_SERIES names `{name}` but clocksync "
                    "registers no such series", csmod.tree))
        gp_series = _module_tuple(gmod, "GANG_PHASE_SERIES") \
            if gmod is not None else None
        if gp_series is not None and gmod is not None:
            have_tuple = True
            declared_union |= set(gp_series)
            registered = {r.name for r in _metric_registrations(gmod)
                          if r.name}
            phase_named = {n for n in registered
                           if "_phase_" in n or "_skew_" in n}
            for name in sorted(phase_named - set(gp_series)):
                out.append(gmod.finding(
                    "SC314",
                    f"series `{name}` is registered in gang but "
                    "missing from GANG_PHASE_SERIES — the SC314 "
                    "catalog contract cannot see it", gmod.tree))
            for name in sorted(set(gp_series) - registered):
                out.append(gmod.finding(
                    "SC314",
                    f"GANG_PHASE_SERIES names `{name}` but gang "
                    "registers no such series", gmod.tree))
        # union <-> the clocksync-series doc table, both directions
        if have_tuple and doc:
            block = self._CS_DOC_BLOCK_RE.search(doc)
            if block is None:
                out.append(csmod.finding(
                    "SC314",
                    "clocksync declares CLOCKSYNC_SERIES but "
                    "docs/observability.md has no clocksync-series "
                    "marker table (<!-- clocksync-series:begin/end "
                    "-->)", csmod.tree))
            else:
                base_doc = self._doc_base_series(block.group(1))
                for name in sorted(declared_union - base_doc):
                    out.append(csmod.finding(
                        "SC314",
                        f"cross-host time series `{name}` is missing "
                        "from the docs/observability.md "
                        "clocksync-series table", csmod.tree))
                for name in sorted(base_doc - declared_union):
                    out.append(Finding(
                        code="SC314",
                        message=f"docs/observability.md "
                                f"clocksync-series table lists "
                                f"`{name}` but neither "
                                "CLOCKSYNC_SERIES nor "
                                "GANG_PHASE_SERIES has such a series",
                        path="docs/observability.md", line=1,
                        scope="", snippet=name))
        # gang.* phase spans <-> the gang-phase-taxonomy doc table,
        # both directions
        span_names = self._gang_span_names(gmod) \
            if gmod is not None else set()
        if span_names and doc and gmod is not None:
            block = self._PHASE_DOC_BLOCK_RE.search(doc)
            if block is None:
                out.append(gmod.finding(
                    "SC314",
                    "gang opens phase spans but docs/observability.md "
                    "has no gang-phase-taxonomy marker table (<!-- "
                    "gang-phase-taxonomy:begin/end -->)", gmod.tree))
            else:
                doc_spans = set(
                    self._GANG_SPAN_RE.findall(block.group(1)))
                for name in sorted(span_names - doc_spans):
                    out.append(gmod.finding(
                        "SC314",
                        f"gang opens span `{name}` but the "
                        "docs/observability.md gang-phase-taxonomy "
                        "table has no row for it — the merged "
                        "timeline would show an unexplained phase",
                        gmod.tree))
                for name in sorted(doc_spans - span_names):
                    out.append(Finding(
                        code="SC314",
                        message=f"docs/observability.md "
                                f"gang-phase-taxonomy table documents "
                                f"span `{name}` but gang opens no "
                                "such span",
                        path="docs/observability.md", line=1,
                        scope="", snippet=name))
        # [trace] clock keys <-> clocksync.CONFIG_KEYS, both
        # directions.  `enabled` is the tracing core's own switch and
        # is excluded; everything else under [trace] belongs to the
        # clock-sync layer and must be declared by it
        schema = _module_tuple(csmod, "CONFIG_KEYS")
        cfg_mod = None
        for m in project.modules:
            if m.relpath.endswith("config.py") \
                    and _default_config_keys(m):
                cfg_mod = m
                break
        if schema is not None and cfg_mod is not None:
            trace_keys = {k for sec, k in _default_config_keys(cfg_mod)
                          if sec == "trace" and k != "enabled"}
            if trace_keys or schema:
                for k in sorted(trace_keys - set(schema)):
                    out.append(cfg_mod.finding(
                        "SC314",
                        f"config key `[trace] {k}` is declared but "
                        "clocksync.CONFIG_KEYS does not accept it",
                        cfg_mod.tree))
                for k in sorted(set(schema) - trace_keys):
                    out.append(csmod.finding(
                        "SC314",
                        f"clocksync.CONFIG_KEYS accepts `{k}` but "
                        "config.default_config() declares no "
                        f"`[trace] {k}`", csmod.tree))
        return out

    # -- SC315 -----------------------------------------------------------

    _SHARD_DOC_BLOCK_RE = re.compile(
        r"<!--\s*gang-shard-series:begin\s*-->(.*?)"
        r"<!--\s*gang-shard-series:end\s*-->", re.S)
    # the [gang] keys that gate the sharded data plane: mode switch +
    # halo exchange.  They must exist wherever the plane's series do —
    # a data plane without its kill switches strands an operator mid-
    # incident, and gates with no plane are stale doc surface
    _SHARD_GATE_KEYS = ("sharded", "halo_exchange")

    def _gang_shard_contract(self, project: Project) -> List[Finding]:
        """Sharded gang data-plane lints: GANG_SHARD_SERIES ↔ the
        `_shard_`-named series engine/gang.py registers ↔ the
        gang-shard-series marker table in docs/observability.md (all
        pairings, both directions), plus the travel-together rule for
        the `[gang] sharded`/`halo_exchange` gates (gang.CONFIG_KEYS
        and config.default_config() must both declare them exactly
        when the data plane exists)."""
        out: List[Finding] = []
        gmod = project.module("engine/gang.py")
        if gmod is None:
            return out
        series = _module_tuple(gmod, "GANG_SHARD_SERIES")
        registered = {r.name for r in _metric_registrations(gmod)
                      if r.name}
        shard_named = {n for n in registered if "_shard_" in n}
        schema = _module_tuple(gmod, "CONFIG_KEYS") or ()
        if series is None:
            if shard_named:
                out.append(gmod.finding(
                    "SC315",
                    "gang registers shard series ("
                    + ", ".join(f"`{n}`" for n in sorted(shard_named))
                    + ") but declares no GANG_SHARD_SERIES tuple — "
                    "the SC315 catalog contract cannot see them",
                    gmod.tree))
            else:
                for k in self._SHARD_GATE_KEYS:
                    if k in schema:
                        out.append(gmod.finding(
                            "SC315",
                            f"gang.CONFIG_KEYS accepts `{k}` but the "
                            "module declares no GANG_SHARD_SERIES "
                            "data plane — a sharding gate with "
                            "nothing to gate", gmod.tree))
            return out
        for name in sorted(shard_named - set(series)):
            out.append(gmod.finding(
                "SC315",
                f"series `{name}` is registered in gang but missing "
                "from GANG_SHARD_SERIES — the SC315 catalog contract "
                "cannot see it", gmod.tree))
        for name in sorted(set(series) - registered):
            out.append(gmod.finding(
                "SC315",
                f"GANG_SHARD_SERIES names `{name}` but gang "
                "registers no such series", gmod.tree))
        doc = _read_doc(project, "observability.md")
        if doc:
            block = self._SHARD_DOC_BLOCK_RE.search(doc)
            if block is None:
                out.append(gmod.finding(
                    "SC315",
                    "gang declares GANG_SHARD_SERIES but "
                    "docs/observability.md has no gang-shard-series "
                    "marker table (<!-- gang-shard-series:begin/end "
                    "-->)", gmod.tree))
            else:
                base_doc = self._doc_base_series(block.group(1))
                for name in sorted(set(series) - base_doc):
                    out.append(gmod.finding(
                        "SC315",
                        f"sharded gang series `{name}` is missing "
                        "from the docs/observability.md "
                        "gang-shard-series table", gmod.tree))
                for name in sorted(base_doc - set(series)):
                    out.append(Finding(
                        code="SC315",
                        message="docs/observability.md "
                                "gang-shard-series table lists "
                                f"`{name}` but GANG_SHARD_SERIES has "
                                "no such series",
                        path="docs/observability.md", line=1,
                        scope="", snippet=name))
        cfg_mod = None
        for m in project.modules:
            if m.relpath.endswith("config.py") \
                    and _default_config_keys(m):
                cfg_mod = m
                break
        gang_cfg = {k for sec, k in _default_config_keys(cfg_mod)
                    if sec == "gang"} if cfg_mod is not None else None
        for k in self._SHARD_GATE_KEYS:
            if k not in schema:
                out.append(gmod.finding(
                    "SC315",
                    "gang declares GANG_SHARD_SERIES but "
                    f"gang.CONFIG_KEYS has no `{k}` gate — the "
                    "sharded data plane ships without its kill "
                    "switch", gmod.tree))
            if gang_cfg is not None and k not in gang_cfg:
                out.append(cfg_mod.finding(
                    "SC315",
                    "gang declares GANG_SHARD_SERIES but "
                    f"config.default_config() declares no `[gang] "
                    f"{k}` — the sharded data plane ships without "
                    "its declared default", cfg_mod.tree))
        return out

    # -- SC316 -----------------------------------------------------------

    _SHARDMAP_DOC_BLOCK_RE = re.compile(
        r"<!--\s*shard-series:begin\s*-->(.*?)"
        r"<!--\s*shard-series:end\s*-->", re.S)

    def _shard_contract(self, project: Project) -> List[Finding]:
        """Sharded control-plane lints: shardmap.SHARD_SERIES ↔ the
        series engine/shardmap.py registers ↔ the shard-series marker
        table in docs/observability.md (all pairings, both
        directions); `[control]` keys in config.default_config() ↔
        shardmap.CONFIG_KEYS (both directions); and the shard-routing
        leg extending SC312 — every service.SHARD_ROUTED_RPCS method
        must be classified idempotent=False AND fence-wrapped, and
        every idempotent=False contract must be shard-routed, so a
        mutating RPC can never land on a master that does not own
        the bulk it mutates."""
        out: List[Finding] = []
        shmod = project.module("engine/shardmap.py")
        if shmod is None:
            return out
        series = _module_tuple(shmod, "SHARD_SERIES")
        registered = {r.name for r in _metric_registrations(shmod)
                      if r.name}
        if series is None:
            if registered:
                out.append(shmod.finding(
                    "SC316",
                    "shardmap registers series ("
                    + ", ".join(f"`{n}`" for n in sorted(registered))
                    + ") but declares no SHARD_SERIES tuple — the "
                    "SC316 catalog contract cannot see them",
                    shmod.tree))
        else:
            for name in sorted(registered - set(series)):
                out.append(shmod.finding(
                    "SC316",
                    f"series `{name}` is registered in shardmap but "
                    "missing from SHARD_SERIES — the SC316 catalog "
                    "contract cannot see it", shmod.tree))
            for name in sorted(set(series) - registered):
                out.append(shmod.finding(
                    "SC316",
                    f"SHARD_SERIES names `{name}` but shardmap "
                    "registers no such series", shmod.tree))
            doc = _read_doc(project, "observability.md")
            if doc:
                block = self._SHARDMAP_DOC_BLOCK_RE.search(doc)
                if block is None:
                    out.append(shmod.finding(
                        "SC316",
                        "shardmap declares SHARD_SERIES but "
                        "docs/observability.md has no shard-series "
                        "marker table (<!-- shard-series:begin/end "
                        "-->)", shmod.tree))
                else:
                    base_doc = self._doc_base_series(block.group(1))
                    for name in sorted(set(series) - base_doc):
                        out.append(shmod.finding(
                            "SC316",
                            f"control-plane shard series `{name}` is "
                            "missing from the docs/observability.md "
                            "shard-series table", shmod.tree))
                    for name in sorted(base_doc - set(series)):
                        out.append(Finding(
                            code="SC316",
                            message="docs/observability.md "
                                    "shard-series table lists "
                                    f"`{name}` but SHARD_SERIES has "
                                    "no such series",
                            path="docs/observability.md", line=1,
                            scope="", snippet=name))
        # [control] keys <-> shardmap.CONFIG_KEYS, both directions
        schema = _module_tuple(shmod, "CONFIG_KEYS")
        cfg_mod = None
        for m in project.modules:
            if m.relpath.endswith("config.py") \
                    and _default_config_keys(m):
                cfg_mod = m
                break
        if schema is not None and cfg_mod is not None:
            control_keys = {k for sec, k in
                            _default_config_keys(cfg_mod)
                            if sec == "control"}
            if control_keys or schema:
                for k in sorted(control_keys - set(schema)):
                    out.append(cfg_mod.finding(
                        "SC316",
                        f"config key `[control] {k}` is declared but "
                        "shardmap.CONFIG_KEYS does not accept it",
                        cfg_mod.tree))
                for k in sorted(set(schema) - control_keys):
                    out.append(shmod.finding(
                        "SC316",
                        f"shardmap.CONFIG_KEYS accepts `{k}` but "
                        "config.default_config() declares no "
                        f"`[control] {k}`", shmod.tree))
        # shard-routing leg (extends SC312): SHARD_ROUTED_RPCS <->
        # the idempotent=False, fence-wrapped master surface.  A
        # mutating RPC must follow the bulk to its owning shard AND
        # stay behind the generation fence there — routing without
        # fencing (or vice versa) reopens the stale-master window
        # sharding was meant to close.
        smod = project.module("engine/service.py")
        routed = _module_tuple(smod, "SHARD_ROUTED_RPCS") \
            if smod is not None else None
        if smod is None or routed is None:
            return out
        contracts = self._contract_idempotency(smod)
        registered_m = self._master_registrations(smod)
        if contracts is None or not registered_m:
            return out
        for name in routed:
            if name not in contracts:
                out.append(smod.finding(
                    "SC316",
                    f"SHARD_ROUTED_RPCS routes `{name}` but "
                    "RPC_CONTRACTS has no such entry — an "
                    "unclassified method cannot be routed safely",
                    smod.tree))
                continue
            if contracts.get(name) is not False:
                out.append(smod.finding(
                    "SC316",
                    f"SHARD_ROUTED_RPCS routes `{name}` but "
                    "RPC_CONTRACTS does not classify it "
                    "idempotent=False — only mutating RPCs follow "
                    "the bulk to its owning shard", smod.tree))
            reg = registered_m.get(name)
            if reg is None:
                out.append(smod.finding(
                    "SC316",
                    f"SHARD_ROUTED_RPCS routes `{name}` but the "
                    "master service registers no such handler",
                    smod.tree))
            elif not reg[0]:
                out.append(smod.finding(
                    "SC316",
                    f"shard-routed RPC `{name}` is registered "
                    "without the generation-fence wrapper "
                    "(`self._fenced(...)`) — a superseded shard "
                    "master would keep accepting this mutation",
                    reg[1]))
        for name, idem in sorted(contracts.items()):
            if idem is False and name not in routed:
                out.append(smod.finding(
                    "SC316",
                    f"RPC `{name}` is classified idempotent=False "
                    "but is missing from SHARD_ROUTED_RPCS — a "
                    "mutating RPC pinned to the dial-time shard "
                    "would bypass bulk ownership", smod.tree))
        return out

    # -- SC317 -----------------------------------------------------------

    _FUSION_DOC_BLOCK_RE = re.compile(
        r"<!--\s*fusion-series:begin\s*-->(.*?)"
        r"<!--\s*fusion-series:end\s*-->", re.S)

    def _fusion_contract(self, project: Project) -> List[Finding]:
        out: List[Finding] = []
        fmod = project.module("graph/fusion.py")
        if fmod is None:
            return out
        declared = _module_tuple(fmod, "FUSION_SERIES")
        if declared is not None:
            declared_set = set(declared)
            registered = {r.name for r in _metric_registrations(fmod)
                          if r.name}
            for name in sorted(registered - declared_set):
                out.append(fmod.finding(
                    "SC317",
                    f"series `{name}` is registered in fusion but "
                    "missing from FUSION_SERIES — the SC317 catalog "
                    "contract cannot see it", fmod.tree))
            for name in sorted(declared_set - registered):
                out.append(fmod.finding(
                    "SC317",
                    f"FUSION_SERIES names `{name}` but fusion "
                    "registers no such series", fmod.tree))
            doc = _read_doc(project, "observability.md")
            if doc:
                block = self._FUSION_DOC_BLOCK_RE.search(doc)
                if block is None:
                    out.append(fmod.finding(
                        "SC317",
                        "fusion declares FUSION_SERIES but "
                        "docs/observability.md has no fusion-series "
                        "marker table (<!-- fusion-series:begin/end "
                        "-->)", fmod.tree))
                else:
                    doc_names = {n for n in
                                 _SERIES_RE.findall(block.group(1))}
                    base_doc = set()
                    for n in doc_names:
                        for suf in _EXPOSITION_SUFFIXES:
                            if n.endswith(suf) \
                                    and n[:-len(suf)] in doc_names:
                                break
                        else:
                            base_doc.add(n)
                    for name in sorted(declared_set - base_doc):
                        out.append(fmod.finding(
                            "SC317",
                            f"fusion series `{name}` is missing from "
                            "the docs/observability.md fusion-series "
                            "table", fmod.tree))
                    for name in sorted(base_doc - declared_set):
                        out.append(Finding(
                            code="SC317",
                            message=f"docs/observability.md "
                                    f"fusion-series table lists "
                                    f"`{name}` but fusion's "
                                    "FUSION_SERIES has no such series",
                            path="docs/observability.md", line=1,
                            scope="", snippet=name))
        # [perf] fusion_* config keys <-> fusion.CONFIG_KEYS, both
        # directions (the SC310 frame_cache_* pattern)
        schema = _module_tuple(fmod, "CONFIG_KEYS")
        cfg_mod = None
        for m in project.modules:
            if m.relpath.endswith("config.py") \
                    and _default_config_keys(m):
                cfg_mod = m
                break
        if schema is not None and cfg_mod is not None:
            perf_keys = {k for sec, k in _default_config_keys(cfg_mod)
                         if sec == "perf" and k.startswith("fusion")}
            if perf_keys or schema:
                for k in sorted(perf_keys - set(schema)):
                    out.append(cfg_mod.finding(
                        "SC317",
                        f"config key `[perf] {k}` is declared but "
                        "fusion.CONFIG_KEYS does not accept it",
                        cfg_mod.tree))
                for k in sorted(set(schema) - perf_keys):
                    out.append(fmod.finding(
                        "SC317",
                        f"fusion.CONFIG_KEYS accepts `{k}` but "
                        "config.default_config() declares no "
                        f"`[perf] {k}`", fmod.tree))
        # extends SC309: an `execute_traced` override advertises the
        # kernel as trace-composable, but the planner's fusability gate
        # keys on cost() — without it the kernel silently never fuses
        for mod in project.modules:
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.ClassDef):
                    continue
                names = {b.name for b in node.body
                         if isinstance(b, (ast.FunctionDef,
                                           ast.AsyncFunctionDef))}
                if "execute_traced" in names and "execute" in names \
                        and "cost" not in names:
                    out.append(mod.finding(
                        "SC317",
                        f"kernel `{node.name}` overrides "
                        "execute_traced (fusion trace hook) but "
                        "declares no cost() descriptor — the planner's "
                        "fusability gate keys on cost(), so this "
                        "kernel can never fuse; declare one or drop "
                        "the override", node))
        return out

    # -- SC306 / SC307 ---------------------------------------------------

    def _rpc_surface(self, project: Project) -> List[Finding]:
        out: List[Finding] = []
        registered: Dict[str, Tuple[ModuleInfo, ast.AST]] = {}
        for mod in project.modules:
            for name, node in _rpc_registrations(mod):
                registered[name] = (mod, node)
        if not registered:
            return out
        invoked: Set[str] = set()
        for mod in project.modules:
            for name, node in _rpc_invocations(mod):
                invoked.add(name)
                if name not in registered:
                    out.append(mod.finding(
                        "SC306",
                        f"RPC `{name}` is called here but no RpcServer "
                        "registers a handler for it (typo or dead "
                        "method?)", node))
        invoked |= set(_AUX_CALL_RE.findall(project.aux_source_text()))
        # indirection idiom: wait_for_server(addr, svc, method="Ping")
        # invokes via a parameter — count string defaults of args named
        # `method` as invocations
        for mod in project.modules:
            for node in ast.walk(mod.tree):
                if not isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                a = node.args
                pos = a.args[len(a.args) - len(a.defaults):]
                for arg, dflt in list(zip(pos, a.defaults)) + [
                        (ka, kd) for ka, kd in zip(a.kwonlyargs,
                                                   a.kw_defaults)
                        if kd is not None]:
                    if arg.arg == "method":
                        s = _const_str(dflt)
                        if s:
                            invoked.add(s)
        for name, (mod, node) in sorted(registered.items()):
            if name not in invoked:
                out.append(mod.finding(
                    "SC306",
                    f"RPC handler `{name}` is registered but never "
                    "invoked by any client in the repo (incl. tests/ "
                    "and tools/)", node))
        # SC307: classification table
        contracts: Optional[Dict[str, ast.AST]] = None
        cmod: Optional[ModuleInfo] = None
        for mod in project.modules:
            for stmt in mod.tree.body:
                if isinstance(stmt, ast.Assign) and len(stmt.targets) \
                        == 1 and isinstance(stmt.targets[0], ast.Name) \
                        and stmt.targets[0].id == "RPC_CONTRACTS" \
                        and isinstance(stmt.value, ast.Dict):
                    contracts = {}
                    for k, v in zip(stmt.value.keys, stmt.value.values):
                        ks = _const_str(k)
                        if ks is None:
                            continue
                        contracts[ks] = k
                        # a present-but-incomplete entry is the same
                        # drift SC307 exists for: the classification
                        # must carry BOTH the deadline class and the
                        # idempotency verdict, as dict literals the
                        # lint can see
                        if not isinstance(v, ast.Dict):
                            out.append(mod.finding(
                                "SC307",
                                f"RPC_CONTRACTS entry `{ks}` is not a "
                                "dict literal — timeout/idempotency "
                                "must be statically checkable", v))
                            continue
                        have = {_const_str(vk) for vk in v.keys}
                        for want in ("timeout_s", "idempotent"):
                            if want not in have:
                                out.append(mod.finding(
                                    "SC307",
                                    f"RPC_CONTRACTS entry `{ks}` lacks "
                                    f"`{want}` (every handler needs a "
                                    "deadline class AND an idempotency "
                                    "verdict)", v))
                    cmod = mod
        if contracts is None:
            anchor_mod, anchor_node = next(iter(registered.values()))
            out.append(anchor_mod.finding(
                "SC307",
                "RPC handlers are registered but no RPC_CONTRACTS "
                "table declares their timeout/idempotency classes — "
                "the retry layer is flying blind", anchor_node))
            return out
        for name, (mod, node) in sorted(registered.items()):
            if name not in contracts:
                out.append(mod.finding(
                    "SC307",
                    f"RPC handler `{name}` has no RPC_CONTRACTS entry "
                    "(timeout class + idempotency)", node))
        for name in sorted(contracts):
            if name not in registered:
                assert cmod is not None
                out.append(cmod.finding(
                    "SC307",
                    f"RPC_CONTRACTS entry `{name}` matches no "
                    "registered handler", contracts[name]))
        return out
