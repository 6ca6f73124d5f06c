"""Capture-safety / shape-stability lints for the port (SC101–SC106).

In the port the "trace" is the CUDA-graph capture: a fused chain
(graph/fusion.py) runs as ONE call whose members' `execute_traced`
bodies engine/evaluate.py `FusedKernelInstance._capture` records once
per (bucket, input signature, stream args) and every later call
replays.  Python runs once, at the capture; a replay re-launches the
recorded kernels and nothing else.  So anything in a captured body
that happens on the host — a numpy call on a tensor, a `.item()`, an
`if` on a tensor's value, a wall-clock read, a draw from a host or
default RNG, a module global — either breaks the capture (a sync
inside a capture is an error), or bakes one value into every replay.
The bucket ladder bounds the captures (one per rung); a device-kernel
call that skips it captures again for every new shape.  The codes are
the JAX package's, each pointed at what it means here.

Codes
  SC101  numpy call on a tensor inside a captured body
  SC102  host sync or concretisation in a captured body: `.item()`,
         `.tolist()`, `.cpu()`, `.numpy()`, `bool()`/`int()`/`float()`
         of a tensor, `if`/`while`/`assert` on a tensor,
         `torch.cuda.synchronize`
  SC103  nondeterminism in a captured body: a wall clock, `random`,
         `np.random`, uuid, os.urandom, or a `torch.rand*`/`randn*`/
         `randint`/... draw (or an in-place `uniform_`/`normal_`/...)
         without an explicit `generator=`
  SC104  mutable module global read in a captured body (its value at
         capture is baked into the graph), or a `global` statement
  SC105  a device-kernel call that bypasses the bucket ladder: in
         engine/evaluate.py, a `.kernel.execute(...)` /
         `.kernel.execute_traced(...)` in a function that neither
         takes its batch from `bucket_for`/`bucket_ladder` nor is
         reached only from functions that do; elsewhere, any
         `.kernel.execute(...)` (the ladder lives in evaluate.py)
  SC106  default-card placement in engine/, kernels/ or models/:
         `torch.device("cuda")` without an index, `.cuda()` without a
         device, `torch.cuda.current_device()` (other than in a
         comparison), a `device="cuda"` argument, or a device chosen
         by `torch.cuda.is_available()` instead of taken from the
         caller.  `engine/evaluate.py resolve_device` is the one place
         that turns the caller's "cuda" into a card, by an inline
         pragma with its reason

Captured bodies are the `execute_traced` methods and, transitively,
the module-level functions of the same module that they call by name
(the way the JAX package's pass follows functions handed to jit
wrappers).  A `Kernel` subclass that declares `cost()` (what makes an
op fusable, graph/fusion.py `fusable`) but not `execute_traced`
inherits the default, which runs `execute()`: then `execute()` is the
captured body.  `finish()` is host-side and out of scope.  A branch that
only a host value can take — the body of `if isinstance(x, np.ndarray)`
(or of a list/tuple), the body of `if not isinstance(x, torch.Tensor)`,
the `else` of `if isinstance(x, torch.Tensor)` — never runs in a
capture and is skipped.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from .core import AnalysisPass, Finding, ModuleInfo, Project

# tensor attributes that are host values with no sync (shape-dependent
# code SHOULD branch on these)
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                 "requires_grad", "itemsize"}
# builtins whose result is a host value with no sync, even on tensors
_STATIC_FUNCS = {"len", "isinstance", "issubclass", "type", "range",
                 "hasattr", "getattr", "enumerate", "id"}
# tensor methods returning host values without a sync
_STATIC_METHODS = {"size", "dim", "numel", "nelement", "element_size",
                   "is_contiguous", "stride", "data_ptr", "get_device",
                   "is_floating_point", "storage_offset"}
# tensor methods that copy to the host and wait for the card
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
# annotations of a parameter that is a host value, not a tensor
_HOST_ANNOTATIONS = {"int", "float", "bool", "str", "bytes", "tuple",
                     "list", "dict", "Tuple", "List", "Dict", "Sequence",
                     "Optional", "device", "dtype", "Callable"}

_CLOCK_CALLS = {"time.time", "time.perf_counter", "time.monotonic",
                "time.time_ns", "time.perf_counter_ns",
                "datetime.datetime.now", "datetime.datetime.utcnow",
                "datetime.now", "datetime.utcnow",
                "uuid.uuid4", "uuid.uuid1", "os.urandom"}
# torch draws that take a `generator=` (without one they read the
# process's default generator, whose state a replay does not advance
# the way the host expects)
_TORCH_RANDOM = {"rand", "randn", "randint", "randperm", "rand_like",
                 "randn_like", "randint_like", "normal", "bernoulli",
                 "multinomial", "poisson"}
_INPLACE_RANDOM = {"uniform_", "normal_", "random_", "bernoulli_",
                   "exponential_", "geometric_", "log_normal_",
                   "cauchy_"}
_MUTATOR_METHODS = {"append", "extend", "add", "update", "pop", "popitem",
                    "remove", "discard", "clear", "insert", "setdefault"}
# SC106's scope: the code that places work on a card
_PLACEMENT_DIRS = ("engine", "kernels", "models")
# SC105: the bucket ladder's entry points
_LADDER_NAMES = {"bucket_for", "bucket_ladder"}


def dotted_name(node: ast.AST) -> Optional[str]:
    """'torch.cuda.synchronize' for nested Attribute/Name chains, else
    None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _import_aliases(mod: ModuleInfo) -> Dict[str, str]:
    """local name -> dotted module/object it refers to."""
    out: Dict[str, str] = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def _resolve(mod_aliases: Dict[str, str], dotted: Optional[str]
             ) -> Optional[str]:
    """Rewrite the leading alias of a dotted name to its import target:
    np.random.rand -> numpy.random.rand."""
    if not dotted:
        return None
    head, _, rest = dotted.partition(".")
    target = mod_aliases.get(head)
    if target is None:
        return dotted
    return f"{target}.{rest}" if rest else target


def _mutable_globals(mod: ModuleInfo) -> Set[str]:
    """Module-level names bound to mutable containers AND mutated from
    inside some function body (import-time population — the decorator
    registry pattern — is fine: it happens before any capture)."""
    mutable: Set[str] = set()
    for stmt in mod.tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name):
            v = stmt.value
            is_mut = isinstance(v, (ast.List, ast.Dict, ast.Set,
                                    ast.ListComp, ast.DictComp,
                                    ast.SetComp))
            if isinstance(v, ast.Call):
                ctor = dotted_name(v.func) or ""
                is_mut = ctor.split(".")[-1] in (
                    "list", "dict", "set", "defaultdict", "deque",
                    "Counter", "OrderedDict", "bytearray")
            if is_mut:
                mutable.add(stmt.targets[0].id)
    if not mutable:
        return set()
    mutated: Set[str] = set()
    for node in ast.walk(mod.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for sub in ast.walk(node):
            if isinstance(sub, ast.AugAssign) and isinstance(
                    sub.target, ast.Name) and sub.target.id in mutable:
                mutated.add(sub.target.id)
            elif isinstance(sub, ast.Assign):
                for t in sub.targets:
                    if isinstance(t, ast.Subscript) and isinstance(
                            t.value, ast.Name) and t.value.id in mutable:
                        mutated.add(t.value.id)
            elif isinstance(sub, ast.Call) and isinstance(
                    sub.func, ast.Attribute) \
                    and sub.func.attr in _MUTATOR_METHODS \
                    and isinstance(sub.func.value, ast.Name) \
                    and sub.func.value.id in mutable:
                mutated.add(sub.func.value.id)
    return mutable & mutated


def _isinstance_of(test: ast.AST, aliases: Dict[str, str]
                   ) -> Optional[Set[str]]:
    """The resolved type names of `isinstance(x, T)` / `isinstance(x,
    (T1, T2))`, else None."""
    if not (isinstance(test, ast.Call) and dotted_name(test.func)
            == "isinstance" and len(test.args) == 2):
        return None
    t = test.args[1]
    elts = t.elts if isinstance(t, ast.Tuple) else [t]
    return {_resolve(aliases, dotted_name(e)) or "" for e in elts}


_HOST_TYPES = {"numpy.ndarray", "list", "tuple", "bytes"}


def _host_only(stmt: ast.If, aliases: Dict[str, str]) -> List[ast.stmt]:
    """The statements of `stmt` that only a host value reaches (skipped:
    a capture hands every body tensors)."""
    test = stmt.test
    neg = isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not)
    types = _isinstance_of(test.operand if neg else test, aliases)
    if not types:
        return []
    tensor = "torch.Tensor" in types
    host = bool(types & _HOST_TYPES)
    if (host and not neg) or (tensor and neg):
        return list(stmt.body)
    if tensor and not neg:
        return list(stmt.orelse)
    return []


def _walk_captured(fn: ast.FunctionDef, aliases: Dict[str, str]
                   ) -> List[ast.AST]:
    """Every node of `fn` a capture can run: all of it but the
    host-only branches."""
    skip: Set[int] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.If):
            for s in _host_only(node, aliases):
                skip.update(id(n) for n in ast.walk(s))
    out: List[ast.AST] = []
    stack: List[ast.AST] = [fn]
    while stack:
        node = stack.pop()
        if id(node) in skip:
            continue
        out.append(node)
        stack.extend(ast.iter_child_nodes(node))
    return out


def _tensor_params(fn: ast.FunctionDef, method: bool,
                   host_annotations: bool = True) -> Set[str]:
    """Parameters that carry tensors: every positional/keyword parameter
    (and *args) but `self`, one with a constant default, and (unless
    `host_annotations` is off) one annotated with a host type."""
    args = fn.args
    pos = args.posonlyargs + args.args
    defaults: Dict[str, ast.AST] = {}
    for a, d in zip(pos[len(pos) - len(args.defaults):], args.defaults):
        defaults[a.arg] = d
    for a, d in zip(args.kwonlyargs, args.kw_defaults):
        if d is not None:
            defaults[a.arg] = d
    out: Set[str] = set()
    for i, a in enumerate(pos + args.kwonlyargs):
        if method and i == 0:
            continue
        if isinstance(defaults.get(a.arg), ast.Constant):
            continue
        ann = dotted_name(a.annotation) if a.annotation is not None \
            else None
        if isinstance(a.annotation, ast.Subscript):
            ann = dotted_name(a.annotation.value)
        if host_annotations and ann \
                and ann.split(".")[-1] in _HOST_ANNOTATIONS:
            continue
        out.add(a.arg)
    if args.vararg:
        out.add(args.vararg.arg)
    return out


def _inherits_default_traced(cls: ast.ClassDef,
                             aliases: Dict[str, str]) -> bool:
    """A direct subclass of the op base class `Kernel`, whose default
    `execute_traced` delegates to `execute`."""
    for b in cls.bases:
        name = _resolve(aliases, dotted_name(b)) or ""
        if name == "Kernel" or name.endswith(".Kernel"):
            return True
    return False


class _Context:
    def __init__(self, fn: ast.FunctionDef, params: Set[str], reason: str):
        self.fn = fn
        self.params = params
        self.reason = reason  # what made it captured, for messages


def _find_capture_contexts(mod: ModuleInfo, aliases: Dict[str, str]
                           ) -> List[_Context]:
    """`execute_traced` methods, then the module-level functions they
    call by name, transitively."""
    top: Dict[str, ast.FunctionDef] = {
        s.name: s for s in mod.tree.body if isinstance(s, ast.FunctionDef)}
    ctxs: Dict[ast.FunctionDef, _Context] = {}
    work: List[ast.FunctionDef] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        methods = {s.name: s for s in node.body
                   if isinstance(s, ast.FunctionDef)}
        if "execute_traced" in methods:
            s = methods["execute_traced"]
            ctxs[s] = _Context(s, _tensor_params(s, True),
                               f"{node.name}.execute_traced")
        elif "execute" in methods and "cost" in methods \
                and _inherits_default_traced(node, aliases):
            # Kernel.execute_traced returns self.execute(*cols): the
            # capture runs `execute` itself, on tensors whatever the
            # row types its annotations declare
            s = methods["execute"]
            ctxs[s] = _Context(
                s, _tensor_params(s, True, host_annotations=False),
                f"{node.name}.execute, which the inherited "
                "Kernel.execute_traced runs")
        else:
            continue
        work.append(s)
    while work:
        fn = work.pop()
        for sub in _walk_captured(fn, aliases):
            if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name):
                callee = top.get(sub.func.id)
                if callee is not None and callee not in ctxs:
                    ctxs[callee] = _Context(
                        callee, _tensor_params(callee, False),
                        f"called from {ctxs[fn].reason}")
                    work.append(callee)
    return list(ctxs.values())


class _TensorExpr:
    """Conservative 'does this expression carry a tensor' evaluator over
    a set of known-tensor local names."""

    def __init__(self, tensors: Set[str]):
        self.tensors = tensors

    def check(self, node: Optional[ast.AST]) -> bool:
        if node is None:
            return False
        if isinstance(node, ast.Name):
            return node.id in self.tensors
        if isinstance(node, ast.Attribute):
            if node.attr in _STATIC_ATTRS:
                return False
            return self.check(node.value)
        if isinstance(node, ast.Subscript):
            # x[i] is a tensor if x is; shape[0] is a host value because
            # .shape already returned False above
            return self.check(node.value)
        if isinstance(node, ast.Call):
            fname = dotted_name(node.func)
            if fname in _STATIC_FUNCS:
                return False
            if isinstance(node.func, ast.Attribute):
                if node.func.attr in _STATIC_METHODS | _SYNC_METHODS:
                    return False
                if self.check(node.func.value):
                    return True
            return any(self.check(a) for a in node.args) or any(
                self.check(kw.value) for kw in node.keywords)
        if isinstance(node, ast.BinOp):
            return self.check(node.left) or self.check(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.check(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self.check(v) for v in node.values)
        if isinstance(node, ast.Compare):
            return self.check(node.left) or any(
                self.check(c) for c in node.comparators)
        if isinstance(node, ast.IfExp):
            return self.check(node.body) or self.check(node.orelse)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self.check(e) for e in node.elts)
        if isinstance(node, ast.Starred):
            return self.check(node.value)
        return False


def _has_generator(call: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in call.keywords)


def _is_cuda_literal(node: Optional[ast.AST]) -> bool:
    return isinstance(node, ast.Constant) and node.value == "cuda"


def _is_device_value(node: ast.AST, aliases: Dict[str, str]) -> bool:
    """A device literal ("cuda"/"cpu"/"cuda:N") or a torch.device(...)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.split(":")[0] in ("cuda", "cpu")
    if isinstance(node, ast.Call):
        return (_resolve(aliases, dotted_name(node.func)) or "") \
            == "torch.device"
    return False


def _calls_is_available(node: ast.AST, aliases: Dict[str, str]) -> bool:
    return any(isinstance(n, ast.Call) and (_resolve(
        aliases, dotted_name(n.func)) or "") == "torch.cuda.is_available"
        for n in ast.walk(node))


class TracerSafetyPass(AnalysisPass):
    name = "tracer"
    codes = {
        "SC101": "numpy call on a tensor inside a captured body",
        "SC102": "host sync / concretisation in a captured body",
        "SC103": "nondeterminism (clock/random) in a captured body",
        "SC104": "mutable module global read in a captured body",
        "SC105": "device-kernel call bypassing the bucket ladder",
        "SC106": "default-card placement in engine/kernels/models code",
    }

    def run(self, project: Project) -> List[Finding]:
        out: List[Finding] = []
        for mod in project.modules:
            aliases = _import_aliases(mod)
            mut_globals = _mutable_globals(mod)
            for ctx in _find_capture_contexts(mod, aliases):
                out.extend(self._check_context(mod, aliases, ctx,
                                               mut_globals))
            out.extend(self._check_ladder(mod))
            out.extend(self._check_placement(mod, aliases))
        return out

    # -- SC101..SC104 over one captured body -----------------------------

    def _check_context(self, mod: ModuleInfo, aliases: Dict[str, str],
                       ctx: _Context, mut_globals: Set[str]
                       ) -> List[Finding]:
        fn = ctx.fn
        out: List[Finding] = []
        tensors = set(ctx.params)
        te = _TensorExpr(tensors)
        body_nodes = _walk_captured(fn, aliases)
        local_names = {a.arg for a in (fn.args.posonlyargs + fn.args.args
                                       + fn.args.kwonlyargs)}
        # two propagation sweeps: simple forward def-use chains plus one
        # level of later-defined helper use
        for _ in range(2):
            for sub in body_nodes:
                if isinstance(sub, ast.Assign) and te.check(sub.value):
                    for t in sub.targets:
                        for n in ast.walk(t):
                            if isinstance(n, ast.Name):
                                tensors.add(n.id)
                elif isinstance(sub, ast.AugAssign) and isinstance(
                        sub.target, ast.Name):
                    if te.check(sub.value) or sub.target.id in tensors:
                        tensors.add(sub.target.id)
                elif isinstance(sub, ast.For) and te.check(sub.iter):
                    for n in ast.walk(sub.target):
                        if isinstance(n, ast.Name):
                            tensors.add(n.id)
        for sub in body_nodes:
            if isinstance(sub, (ast.Assign, ast.AugAssign, ast.For)):
                for t in (sub.targets if isinstance(sub, ast.Assign)
                          else [sub.target]):
                    local_names.update(n.id for n in ast.walk(t)
                                       if isinstance(n, ast.Name))
        where = f"captured `{fn.name}` ({ctx.reason})"

        for sub in body_nodes:
            if isinstance(sub, (ast.If, ast.While)) and te.check(sub.test):
                kind = "while" if isinstance(sub, ast.While) else "if"
                out.append(mod.finding(
                    "SC102",
                    f"host `{kind}` on a tensor's value inside {where} — "
                    "it syncs at capture and the branch taken then is "
                    "baked into every replay; use torch.where (or branch "
                    "on .shape/.dtype/.device)", sub))
            elif isinstance(sub, ast.Assert) and te.check(sub.test):
                out.append(mod.finding(
                    "SC102",
                    f"assert on a tensor's value inside {where} syncs at "
                    "capture", sub))
            elif isinstance(sub, ast.Call):
                out.extend(self._check_call(mod, aliases, sub, te, where))
            elif isinstance(sub, ast.Global):
                out.append(mod.finding(
                    "SC104",
                    f"`global {', '.join(sub.names)}` inside {where}: "
                    "writes happen once, at capture, never on replay",
                    sub))
            elif isinstance(sub, ast.Name) and isinstance(
                    sub.ctx, ast.Load) and sub.id in mut_globals \
                    and sub.id not in local_names:
                out.append(mod.finding(
                    "SC104",
                    f"mutable module global `{sub.id}` read inside "
                    f"{where} — its value at capture is baked into the "
                    "graph; later changes never reach a replay (pass it "
                    "as an argument, part of the graph's key)", sub))
        return out

    def _check_call(self, mod: ModuleInfo, aliases: Dict[str, str],
                    sub: ast.Call, te: _TensorExpr, where: str
                    ) -> List[Finding]:
        fname = dotted_name(sub.func) or ""
        resolved = _resolve(aliases, fname) or ""
        root = fname.split(".")[0]
        root_target = aliases.get(root, root)
        args_tensor = any(te.check(a) for a in sub.args) or any(
            te.check(kw.value) for kw in sub.keywords)
        if isinstance(sub.func, ast.Attribute) \
                and sub.func.attr in _SYNC_METHODS \
                and te.check(sub.func.value):
            return [mod.finding(
                "SC102",
                f"`.{sub.func.attr}()` on a tensor inside {where} copies "
                "to the host and waits for the card — illegal during a "
                "capture (move it to finish())", sub)]
        if fname in ("bool", "int", "float") and any(
                te.check(a) for a in sub.args):
            return [mod.finding(
                "SC102",
                f"`{fname}()` of a tensor inside {where} syncs to read "
                "its value", sub)]
        if resolved.endswith("cuda.synchronize"):
            return [mod.finding(
                "SC102",
                f"`{fname}` inside {where}: a capture may not synchronize "
                "the card", sub)]
        if root_target == "numpy" or resolved.startswith("numpy."):
            if ".random" in f".{resolved}" or fname.startswith(
                    f"{root}.random."):
                return [mod.finding(
                    "SC103",
                    f"`{fname}` inside {where}: host RNG is drawn once at "
                    "capture — pass a torch.Generator", sub)]
            if args_tensor:
                return [mod.finding(
                    "SC101",
                    f"`{fname}` applied to a tensor inside {where} — "
                    "numpy copies it to the host (a sync, illegal in a "
                    "capture) and its result is a constant of the graph; "
                    "use torch", sub)]
            return []
        if resolved in _CLOCK_CALLS or fname in _CLOCK_CALLS:
            return [mod.finding(
                "SC103",
                f"`{fname}` inside {where} is read once, at capture "
                "(a stale constant in every replay)", sub)]
        if root_target == "random" and "." in fname:
            return [mod.finding(
                "SC103",
                f"`{fname}` inside {where}: host RNG inside a capture — "
                "use torch with an explicit generator=", sub)]
        if resolved.startswith("torch.") \
                and resolved.split(".")[-1] in _TORCH_RANDOM \
                and resolved.count(".") == 1 and not _has_generator(sub):
            return [mod.finding(
                "SC103",
                f"`{fname}` without generator= inside {where} draws from "
                "the process's default generator — pass an explicit "
                "torch.Generator", sub)]
        if isinstance(sub.func, ast.Attribute) \
                and sub.func.attr in _INPLACE_RANDOM \
                and not _has_generator(sub):
            return [mod.finding(
                "SC103",
                f"`.{sub.func.attr}()` without generator= inside {where} "
                "draws from the process's default generator — pass an "
                "explicit torch.Generator", sub)]
        return []

    # -- SC105 -----------------------------------------------------------

    def _check_ladder(self, mod: ModuleInfo) -> List[Finding]:
        out: List[Finding] = []
        in_dispatch = mod.relpath.endswith("engine/evaluate.py")
        calls: List[ast.Call] = []
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in ("execute", "execute_traced") \
                    and isinstance(node.func.value, ast.Attribute) \
                    and node.func.value.attr == "kernel":
                calls.append(node)
        if not in_dispatch:
            for node in calls:
                if node.func.attr == "execute":
                    out.append(mod.finding(
                        "SC105",
                        "direct device-kernel execute() outside "
                        "engine/evaluate.py bypasses the bucket ladder — "
                        "every new call shape is a new CUDA-graph "
                        "capture", node))
            return out
        if not calls:
            return out
        fine = self._ladder_functions(mod)
        for node in calls:
            fn = self._enclosing_function(mod, node)
            if fn is None or fn.name not in fine:
                out.append(mod.finding(
                    "SC105",
                    f"device-kernel `{node.func.attr}()` in "
                    f"`{fn.name if fn else '<module>'}` takes a batch "
                    "that no bucket_for/bucket_ladder shaped — every new "
                    "batch size is a new CUDA-graph capture", node))
        return out

    @staticmethod
    def _enclosing_function(mod: ModuleInfo, node: ast.AST
                            ) -> Optional[ast.FunctionDef]:
        """The outermost function around `node` below module or class
        level (a closure inside a dispatch method is that method's)."""
        found = None
        cur = mod.parent(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                found = cur
            cur = mod.parent(cur)
        return found

    @staticmethod
    def _ladder_functions(mod: ModuleInfo) -> Set[str]:
        """Names of the module's functions whose batches come from the
        ladder: those that call bucket_for/bucket_ladder or take a
        `ladder` parameter, then (least fixpoint) those called only
        from such functions."""
        fns: Dict[str, List[ast.FunctionDef]] = {}
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fns.setdefault(node.name, []).append(node)
        callers: Dict[str, Set[str]] = {n: set() for n in fns}
        seeds: Set[str] = set()
        for name, defs in fns.items():
            for fn in defs:
                if any(a.arg == "ladder" for a in fn.args.args):
                    seeds.add(name)
                for sub in ast.walk(fn):
                    if not isinstance(sub, ast.Call):
                        continue
                    callee = sub.func.attr if isinstance(
                        sub.func, ast.Attribute) else (
                        sub.func.id if isinstance(sub.func, ast.Name)
                        else None)
                    if callee in _LADDER_NAMES:
                        seeds.add(name)
                    elif callee in callers and callee != name:
                        callers[callee].add(name)
        fine = set(seeds)
        changed = True
        while changed:
            changed = False
            for name, who in callers.items():
                if name not in fine and who and who <= fine:
                    fine.add(name)
                    changed = True
        return fine

    # -- SC106 -----------------------------------------------------------

    def _check_placement(self, mod: ModuleInfo,
                         aliases: Dict[str, str]) -> List[Finding]:
        """Engine/kernels/models code never picks a card on its own: the
        caller's device (resolved once by engine.evaluate.resolve_device,
        then assigned per instance by assigned_device/instance_devices)
        is threaded through.  A bare "cuda" means whatever card is
        current on the calling thread — card 0 for every loader and
        evaluator thread of a multi-card worker."""
        parts = mod.relpath.replace("\\", "/").split("/")
        if not any(d in parts for d in _PLACEMENT_DIRS):
            return []
        out: List[Finding] = []
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                resolved = _resolve(aliases, dotted_name(node.func)) or ""
                if resolved == "torch.device" and len(node.args) == 1 \
                        and _is_cuda_literal(node.args[0]) \
                        and not node.keywords:
                    out.append(mod.finding(
                        "SC106",
                        "`torch.device(\"cuda\")` without an index is "
                        "whatever card is current — take the device from "
                        "the caller (the instance's assigned device)",
                        node))
                elif isinstance(node.func, ast.Attribute) \
                        and node.func.attr == "cuda" \
                        and not node.args and not node.keywords \
                        and resolved != "torch.cuda":
                    out.append(mod.finding(
                        "SC106",
                        "`.cuda()` without a device moves to the current "
                        "card — use .to(device) with the caller's device",
                        node))
                elif resolved == "torch.cuda.current_device" \
                        and not isinstance(mod.parent(node), ast.Compare):
                    out.append(mod.finding(
                        "SC106",
                        "`torch.cuda.current_device()` picks the calling "
                        "thread's card — resolve the caller's device "
                        "through engine.evaluate.resolve_device", node))
                for kw in node.keywords:
                    if kw.arg == "device" and _is_cuda_literal(kw.value):
                        out.append(mod.finding(
                            "SC106",
                            "`device=\"cuda\"` places on the current card "
                            "— pass the caller's device", node))
            elif isinstance(node, ast.IfExp) \
                    and _calls_is_available(node.test, aliases) \
                    and (_is_device_value(node.body, aliases)
                         or _is_device_value(node.orelse, aliases)):
                out.append(mod.finding(
                    "SC106",
                    "device chosen by `torch.cuda.is_available()` — the "
                    "port never falls back silently; take the device "
                    "from the caller", node))
            elif isinstance(node, ast.If) \
                    and _calls_is_available(node.test, aliases) \
                    and any(isinstance(s, ast.Assign)
                            and _is_device_value(s.value, aliases)
                            for s in node.body + node.orelse):
                out.append(mod.finding(
                    "SC106",
                    "device chosen by `torch.cuda.is_available()` — the "
                    "port never falls back silently; take the device "
                    "from the caller", node))
        return out
