"""scanner_tpu_torch: the PyTorch/CUDA port of scanner_tpu.

Capabilities mirror scanner-research/scanner (SIGGRAPH 2018): computation
graphs (Source -> Ops -> Sink) over tables of keyframe-indexed video streams,
executed by a runtime that decodes exactly the frames each task needs and
runs device kernels as hand-written CUDA kernels on an NVIDIA card (H100,
sm_90a), or on the CPU when the client asks for it.  Ported so far: the
single-node path, the image stdlib, the model zoo, the pose model
(`models`: serving through PoseDetect, training with ring attention on
the flash-attention kernel, `parallel`), the storage back ends and the
master/worker cluster (`engine/service.py`); the JAX package beside it
is the reference.
"""

from .common import (BlobType, BoundaryCondition, CacheMode, DeviceType,
                     FrameType, GraphException, JobException, NullElement,
                     PerfParams, ScannerException, SliceList, StorageException)

from .engine.client import Client, Table
from .graph.ops import Kernel, KernelConfig, register_op
from .storage.streams import NamedStream, NamedVideoStream, StoredStream

# reference-compat alias
register_python_op = register_op

__version__ = "0.1.0"

__all__ = [
    "BlobType", "BoundaryCondition", "CacheMode", "DeviceType", "FrameType",
    "GraphException", "JobException", "NullElement", "PerfParams",
    "ScannerException", "SliceList", "StorageException",
    "Client", "Table", "Kernel", "KernelConfig", "register_op",
    "register_python_op", "NamedStream", "NamedVideoStream", "StoredStream",
]
