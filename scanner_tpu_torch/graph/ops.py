"""Op graph DSL: registries, kernel registration, graph node types.

Capability parity: reference scannerpy/op.py (OpGenerator:121, Op:244,
OpColumn:47, register_python_op:317) + scanner/api/op.h (REGISTER_OP
macro) + the registries in scanner/engine/*_registry.*.

Kernels here are Python classes (device kernels work on torch tensors).
The engine decides host-vs-accelerator placement from OpSpec.device.
"""

from __future__ import annotations

import dataclasses
import inspect
import threading
import typing
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

from ..common import (BlobType, DeviceType, FrameType, GraphException,
                      SliceList)

# Builtin op names (reference dag_analysis.h:27-37)
INPUT_OP = "Input"
OUTPUT_OP = "Output"
SAMPLE_OP = "Sample"
SPACE_OP = "Space"
SLICE_OP = "Slice"
UNSLICE_OP = "Unslice"
BUILTIN_OPS = {INPUT_OP, OUTPUT_OP, SAMPLE_OP, SPACE_OP, SLICE_OP, UNSLICE_OP}


class Kernel:
    """Base class for user kernels (reference scannerpy/kernel.py:15 and
    api/kernel.h:145 BaseKernel).

    Lifecycle: __init__(config, **op_args) -> [fetch_resources once per node]
    -> [setup_with_resources] -> per stream: new_stream(**stream_args) ->
    execute(...) repeatedly; reset() on discontinuity (state ops).
    """

    def __init__(self, config: "KernelConfig"):
        self.config = config

    def fetch_resources(self) -> None:
        """Called once per node (not per pipeline instance) before setup."""

    def setup_with_resources(self) -> None:
        """Called after fetch_resources completed on the node."""

    def new_stream(self, **kwargs) -> None:
        """Per-stream (per-job) argument binding."""

    def reset(self) -> None:
        """State reset on row discontinuity (stateful kernels)."""

    def execute(self, *cols, **kwcols):
        raise NotImplementedError

    def execute_traced(self, *cols):
        """Tensor-in, tensor-out core of ``execute()`` for whole-pipeline
        fusion (graph/fusion.py + engine/evaluate.py FusedKernelInstance):
        the engine composes consecutive members' ``execute_traced``
        bodies head to tail and, on a card, captures the composition as
        one CUDA graph per bucket.  So this must take and return tensors
        on the input's device, launch its work on the current stream,
        and stay free of host syncs and uploads from pageable memory
        after its first call at a shape (no per-row python results, no
        ``.cpu()``).  The default delegates to ``execute()`` — right for
        kernels whose execute body is already tensor code; kernels with
        a host-side tail (e.g. a float-list conversion) override this
        with the device core and put the conversion in ``finish()``."""
        return self.execute(*cols)

    def finish(self, result):
        """Host-side tail conversion applied to the chain-tail kernel's
        ``execute_traced`` result outside the fused call, restoring the
        exact ``execute()`` result protocol (identity by default)."""
        return result

    def precompile_input(self, name: str):
        """Optional warm-up hook for the engine's bucket-ladder
        precompile (engine/evaluate.py): return one example row for the
        non-frame input column `name` (frame columns are synthesized by
        the engine), or None to opt this op out of generic warm-up.
        The example only needs the right shape/dtype — warm-up results
        are discarded."""
        return None

    def cost(self, shapes):
        """Optional analytical cost descriptor for ONE execute() call
        (the roofline-attribution hook, util/coststats.py): `shapes`
        holds one entry per positional input — the array shape tuple
        for array inputs, the element count for per-row lists.  Return
        a `coststats.CostDescriptor` (or a dict with `flops` /
        `bytes_in` / `bytes_out` keys), or None to fall back to the
        observed argument bytes.  Declaring it also makes the op
        fusable (graph/fusion.py)."""
        return None

    def close(self) -> None:
        pass


@dataclass
class KernelConfig:
    device: DeviceType
    args: Dict[str, Any] = field(default_factory=dict)
    node_id: int = 0
    # engine-provided: torch devices visible to this kernel instance
    devices: List[Any] = field(default_factory=list)


@dataclass
class OpSpec:
    """Registered op metadata (reference OpInfo/OpRegistry + KernelFactory)."""

    name: str
    input_columns: List[Tuple[str, bool]]   # (name, is_frame)
    output_columns: List[Tuple[str, bool]]
    kernel_factory: Optional[Callable[..., Kernel]] = None
    device: DeviceType = DeviceType.CPU
    stencil: List[int] = field(default_factory=lambda: [0])
    batch: int = 1
    # None = stateless; >=0 = bounded state with that warmup
    bounded_state: Optional[int] = None
    unbounded_state: bool = False
    variadic: bool = False
    # per output column: "frame" | "raw" (bytes) | "pickle" (objects)
    output_codecs: List[str] = field(default_factory=list)
    # names of per-stream (new_stream) parameters
    stream_arg_names: List[str] = field(default_factory=list)
    # names of init (kernel constructor) parameters
    init_arg_names: List[str] = field(default_factory=list)

    @property
    def is_stateful(self) -> bool:
        return self.unbounded_state or self.bounded_state is not None

    def __reduce__(self):
        """Serialize with the kernel class hidden behind a NESTED
        cloudpickle blob, restored through the local registry first
        (`_restore_op_spec`).

        Job specs travel as cloudpickle blobs, and test/user modules
        often ride by value (``register_pickle_by_value``).  Unpickling
        a by-value class in the SAME process is not a no-op even when
        cloudpickle's tracker dedupes it back to the original class
        object: the restore re-applies the pickled class ``__dict__``
        onto the original, silently REBINDING every class attribute to
        a dump-time copy (a mutable registry like ``executed_on = []``
        loses all appends made since the dump — the
        test_distributed_histogram registry-identity flake, where a
        late-joining worker's spec load wiped the list mid-run).
        Nesting the class blob means a process whose registry already
        holds the op NEVER deserializes the class at all — the
        registered spec IS the identity; only a process without the
        registration (a spawned worker that never imported the
        defining module) pays the class unpickle, where there is no
        original to clobber."""
        fields_d = {f.name: getattr(self, f.name)
                    for f in dataclasses.fields(self)
                    if f.name != "kernel_factory"}
        fac = self.kernel_factory
        if fac is None:
            return (_restore_op_spec, (fields_d, None, None))
        identity = (getattr(fac, "__module__", None),
                    getattr(fac, "__qualname__", None))
        # reentrancy guard: the class's own dump reaches its `_op_spec`
        # backref and would recurse dumps(class) forever; the nested
        # copy travels factory-less (the outer spec carries the blob)
        active = getattr(_SPEC_REDUCE_GUARD, "active", None)
        if active is None:
            active = _SPEC_REDUCE_GUARD.active = set()
        if id(fac) in active:
            return (_restore_op_spec, (fields_d, identity, None))
        active.add(id(fac))
        try:
            import cloudpickle
            blob = cloudpickle.dumps(fac)
        finally:
            active.discard(id(fac))
        return (_restore_op_spec, (fields_d, identity, blob))


_SPEC_REDUCE_GUARD = threading.local()


def _restore_op_spec(fields_d: Dict[str, Any],
                     identity: Optional[Tuple],
                     blob: Optional[bytes]) -> "OpSpec":
    """Unpickle-side twin of OpSpec.__reduce__: when the local registry
    holds a same-named op whose class matches the dump-time identity
    (module + qualname), the REGISTERED spec is returned verbatim —
    one canonical identity per process, zero class deserialization.
    Otherwise the embedded class blob is loaded (spawned workers)."""
    name = fields_d.get("name")
    if identity is not None and name is not None and registry.has(name):
        local = registry.get(name)
        lf = local.kernel_factory
        if lf is not None and (getattr(lf, "__module__", None),
                               getattr(lf, "__qualname__", None)) \
                == tuple(identity):
            return local
    factory = None
    if blob is not None:
        import cloudpickle
        factory = cloudpickle.loads(blob)
    return OpSpec(kernel_factory=factory, **fields_d)


class OpRegistry:
    def __init__(self):
        self._ops: Dict[str, OpSpec] = {}

    def register(self, spec: OpSpec) -> None:
        if spec.name in BUILTIN_OPS:
            raise GraphException(f"cannot register builtin name {spec.name}")
        self._ops[spec.name] = spec

    def get(self, name: str) -> OpSpec:
        if name not in self._ops:
            raise GraphException(
                f"op not registered: {name} (have: {sorted(self._ops)})")
        return self._ops[name]

    def has(self, name: str) -> bool:
        return name in self._ops

    def canonical_factory(self, spec: OpSpec) -> Optional[Callable]:
        """Resolve a spec's kernel factory to ONE canonical class.

        Job specs travel as cloudpickle blobs; with
        ``register_pickle_by_value`` the kernel class rides by value,
        and the unpickled spec can carry a *class copy* distinct from
        the locally-registered original (cloudpickle's class tracker
        is best-effort).  In-process clusters then split identity:
        kernels execute on the copy while everything that looked the
        class up by name (tests, class-level state, re-registration)
        holds the original.  When the local registry has a same-named
        op whose class is the same module+qualname, the registered
        class IS the op — return it; otherwise (spawned workers that
        never imported the defining module, genuinely different ops)
        the spec's own factory stands."""
        fac = spec.kernel_factory
        local = self._ops.get(spec.name)
        if fac is None or local is None or local.kernel_factory is None:
            return fac
        lf = local.kernel_factory
        if lf is fac:
            return fac
        if (getattr(lf, "__module__", None)
                == getattr(fac, "__module__", None)
                and getattr(lf, "__qualname__", None)
                == getattr(fac, "__qualname__", None)):
            return lf
        return fac

    def names(self) -> List[str]:
        return sorted(self._ops)


registry = OpRegistry()


def _is_frame_ann(ann) -> bool:
    return ann is FrameType


def _strip_seq(ann) -> Tuple[Any, int]:
    """Unwrap Sequence[...] layers; returns (inner, depth)."""
    depth = 0
    while typing.get_origin(ann) in (list, tuple, typing.Sequence,
                                     typing.get_origin(Sequence[int])):
        args = typing.get_args(ann)
        if not args:
            break
        ann = args[0]
        depth += 1
    return ann, depth


def register_op(name: Optional[str] = None,
                device: DeviceType = DeviceType.CPU,
                batch: int = 1,
                stencil: Optional[List[int]] = None,
                bounded_state: Optional[int] = None,
                unbounded_state: bool = False):
    """Decorator registering a Kernel class or a plain function as an op.

    Input/output columns are inferred from the `execute` type annotations
    (reference register_python_op, op.py:317-575): FrameType = video frames,
    anything else = serialized blob.  Sequence[...] wrapping indicates
    batch and/or stencil axes and is validated against the decl.
    """

    def wrap(target):
        op_name = name or target.__name__
        if inspect.isclass(target) and issubclass(target, Kernel):
            cls = target
            exec_fn = target.execute
            skip_self = 1
        elif callable(target):
            # plain function kernel: def f(config, col: T, ...) -> Out
            fn = target

            class FnKernel(Kernel):
                def __init__(self, config, **kw):
                    super().__init__(config)
                    self._kw = kw

                def execute(self, *cols):
                    return fn(self.config, *cols, **self._kw)

            FnKernel.__name__ = op_name
            cls = FnKernel
            exec_fn = fn
            skip_self = 1  # `config` occupies the first slot
        else:
            raise GraphException(f"cannot register {target!r} as op")

        # eval_str resolves PEP-563 string annotations (modules using
        # `from __future__ import annotations`)
        sig = inspect.signature(exec_fn, eval_str=True)
        params = list(sig.parameters.values())[skip_self:]
        in_cols: List[Tuple[str, bool]] = []
        variadic = False
        init_args: List[str] = []
        for p in params:
            if p.kind == inspect.Parameter.VAR_POSITIONAL:
                inner, _ = _strip_seq(p.annotation)
                in_cols.append((p.name, _is_frame_ann(inner)))
                variadic = True
            elif p.annotation is not inspect.Parameter.empty:
                inner, _ = _strip_seq(p.annotation)
                in_cols.append((p.name, _is_frame_ann(inner)))
            else:
                init_args.append(p.name)
        def codec_of(inner) -> str:
            if _is_frame_ann(inner):
                return "frame"
            if inner is bytes:
                return "raw"
            return "pickle"

        ret = sig.return_annotation
        out_cols: List[Tuple[str, bool]] = []
        out_codecs: List[str] = []
        if ret is inspect.Signature.empty or ret is None:
            out_cols = [("output", False)]
            out_codecs = ["pickle"]
        elif typing.get_origin(ret) is tuple:
            for i, r in enumerate(typing.get_args(ret)):
                inner, _ = _strip_seq(r)
                out_cols.append((f"output{i}", _is_frame_ann(inner)))
                out_codecs.append(codec_of(inner))
        else:
            inner, _ = _strip_seq(ret)
            out_cols = [("output", _is_frame_ann(inner))]
            out_codecs = [codec_of(inner)]

        # new_stream kwargs (per-stream args)
        stream_args: List[str] = []
        ns = getattr(cls, "new_stream", None)
        if ns is not None and ns is not Kernel.new_stream:
            stream_args = [p.name for p in
                           list(inspect.signature(ns).parameters.values())[1:]
                           if p.kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD,
                                         inspect.Parameter.KEYWORD_ONLY)]
        # constructor kwargs beyond config
        if inspect.isclass(target):
            ctor = inspect.signature(cls.__init__)
            init_args = [p.name for p in
                         list(ctor.parameters.values())[2:]
                         if p.kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD,
                                       inspect.Parameter.KEYWORD_ONLY)]

        spec = OpSpec(
            name=op_name, input_columns=in_cols, output_columns=out_cols,
            kernel_factory=cls, device=device,
            stencil=list(stencil) if stencil else [0], batch=batch,
            bounded_state=bounded_state, unbounded_state=unbounded_state,
            variadic=variadic, output_codecs=out_codecs,
            stream_arg_names=stream_args, init_arg_names=init_args)
        registry.register(spec)
        target._op_spec = spec
        return target

    return wrap


# ---------------------------------------------------------------------------
# Graph node types
# ---------------------------------------------------------------------------

class OpColumn:
    """A named output stream of a graph node (reference op.py:47)."""

    def __init__(self, op: "OpNode", column: str, is_frame: bool):
        self.op = op
        self.column = column
        self.is_frame = is_frame
        # output-encoding options (reference OpColumn.compress/lossless)
        self.encode_options: Dict[str, Any] = {}

    def lossless(self) -> "OpColumn":
        c = OpColumn(self.op, self.column, self.is_frame)
        c.encode_options = {"codec": "video", "crf": 0}
        return c

    def compress(self, codec: str = "video", bitrate: int = 0,
                 crf: int = 20, keyint: int = 16) -> "OpColumn":
        c = OpColumn(self.op, self.column, self.is_frame)
        c.encode_options = {"codec": codec, "bitrate": bitrate, "crf": crf,
                            "keyint": keyint}
        return c

    def __repr__(self):
        return f"OpColumn({self.op.name}.{self.column})"


class OpNode:
    """One node of the computation graph."""

    _counter = [0]

    def __init__(self, name: str,
                 inputs: Dict[str, Union[OpColumn, List[OpColumn]]],
                 job_args: Optional[Dict[str, List[Any]]] = None,
                 device: Optional[DeviceType] = None,
                 stencil: Optional[List[int]] = None,
                 batch: Optional[int] = None,
                 warmup: Optional[int] = None,
                 extra: Optional[Dict[str, Any]] = None,
                 init_args: Optional[Dict[str, Any]] = None,
                 fuse: Optional[bool] = None):
        self.name = name
        self.inputs = inputs
        self.job_args = job_args or {}     # per-stream op args (length = #jobs)
        self.init_args = init_args or {}   # kernel constructor args
        self.device = device
        self.stencil = stencil
        self.batch = batch
        self.warmup = warmup
        # whole-pipeline fusion override (graph/fusion.py): False pins
        # this node to staged dispatch (a chain boundary); None/True
        # leave the planner's eligibility + cost decision in charge
        self.fuse = fuse
        self.extra = extra or {}           # builtin payload (sampler kind etc.)
        self.id = OpNode._counter[0]
        OpNode._counter[0] += 1

        if name in BUILTIN_OPS:
            self.spec: Optional[OpSpec] = None
            out_is_frame = self._builtin_output_is_frame()
            self.outputs = [OpColumn(self, "output", out_is_frame)]
        else:
            self.spec = registry.get(name)
            self.outputs = [OpColumn(self, cname, isf)
                            for cname, isf in self.spec.output_columns]

    def _builtin_output_is_frame(self) -> bool:
        for v in self.inputs.values():
            cols = v if isinstance(v, list) else [v]
            for c in cols:
                return c.is_frame
        return True  # Input op: frames by default; set explicitly by caller

    @property
    def is_builtin(self) -> bool:
        return self.name in BUILTIN_OPS

    def input_columns(self) -> List[OpColumn]:
        out: List[OpColumn] = []
        for v in self.inputs.values():
            if isinstance(v, list):
                out.extend(v)
            else:
                out.append(v)
        return out

    def effective_stencil(self) -> List[int]:
        if self.stencil is not None:
            return list(self.stencil)
        if self.spec is not None:
            return list(self.spec.stencil)
        return [0]

    def effective_batch(self) -> int:
        if self.batch is not None:
            return int(self.batch)
        if self.spec is not None:
            return int(self.spec.batch)
        return 1

    def effective_device(self) -> DeviceType:
        if self.device is not None:
            return self.device
        if self.spec is not None:
            return self.spec.device
        return DeviceType.CPU

    def __getitem__(self, column: str) -> OpColumn:
        for c in self.outputs:
            if c.column == column:
                return c
        raise GraphException(f"op {self.name} has no output column {column}")

    def __repr__(self):
        return f"OpNode({self.name}#{self.id})"


class OpGenerator:
    """`ops.Name(col=..., arg=...)` dynamic op construction
    (reference OpGenerator, op.py:121-133)."""

    def __getattr__(self, name: str):
        def make(*args, **kwargs) -> OpColumn:
            spec = registry.get(name)
            device = kwargs.pop("device", None)
            stencil = kwargs.pop("stencil", None)
            batch = kwargs.pop("batch", None)
            warmup = kwargs.pop("bounded_state", None)
            fuse = kwargs.pop("fuse", None)
            inputs: Dict[str, Union[OpColumn, List[OpColumn]]] = {}
            job_args: Dict[str, List[Any]] = {}
            init_args: Dict[str, Any] = {}
            if spec.variadic:
                if kwargs.get(spec.input_columns[0][0]) is not None:
                    cols = kwargs.pop(spec.input_columns[0][0])
                else:
                    cols = list(args)
                if not all(isinstance(c, OpColumn) for c in cols):
                    raise GraphException(
                        f"{name}: variadic inputs must be OpColumns")
                inputs[spec.input_columns[0][0]] = list(cols)
            else:
                in_names = {n for n, _ in spec.input_columns}
                for n, _ in spec.input_columns:
                    if n in kwargs:
                        v = kwargs.pop(n)
                        if not isinstance(v, OpColumn):
                            raise GraphException(
                                f"{name}: input {n} must be an OpColumn")
                        inputs[n] = v
                if len(inputs) != len(in_names):
                    missing = in_names - set(inputs)
                    raise GraphException(f"{name}: missing inputs {missing}")
            # remaining kwargs: per-stream args (lists) or init args
            for k, v in kwargs.items():
                if k in spec.stream_arg_names:
                    if not isinstance(v, (list, SliceList)):
                        raise GraphException(
                            f"{name}: per-stream arg {k} must be a list "
                            f"(one entry per input stream)")
                    job_args[k] = v
                else:
                    init_args[k] = v
            node = OpNode(name, inputs, job_args=job_args, device=device,
                          stencil=stencil, batch=batch, warmup=warmup,
                          init_args=init_args, fuse=fuse)
            if len(node.outputs) == 1:
                return node.outputs[0]
            return node  # caller selects columns via node['col']

        return make
