from . import analysis, ops, samplers
from .ops import (Kernel, KernelConfig, OpColumn, OpGenerator, OpNode,
                  OpSpec, register_op, registry)
from .streams_dsl import IOGenerator, StreamsGenerator, TaskPartitioner

__all__ = [
    "analysis", "ops", "samplers", "Kernel", "KernelConfig", "OpColumn",
    "OpGenerator", "OpNode", "OpSpec", "register_op", "registry",
    "IOGenerator", "StreamsGenerator", "TaskPartitioner",
]
