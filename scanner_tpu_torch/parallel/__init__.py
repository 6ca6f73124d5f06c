"""In-program parallelism on torch.distributed: mesh layouts and their
DTensor placements, halo exchange, ring and Ulysses sequence-parallel
attention, GPipe stages, and the gang's process groups.  One rank on
the card, or several ranks over any backend torch.distributed offers
(gloo ranks on the CPU in the tests)."""

from .mesh import (AXIS_ORDER, auto_axes, device_mesh, make_mesh,
                   shard_batch, sharding)
from .halo import sharded_stencil_map, temporal_diff
from .pp import make_pipeline, stack_stage_params
from .ring_attention import make_ring_attention, reference_attention
from .ulysses import make_ulysses_attention
from .distributed import (CoordinatorConfig, host_local_array,
                          initialize, is_initialized, replicate_to_global)

__all__ = [
    "AXIS_ORDER", "auto_axes", "device_mesh", "make_mesh", "shard_batch",
    "sharding", "sharded_stencil_map", "temporal_diff", "make_pipeline",
    "stack_stage_params", "make_ring_attention",
    "make_ulysses_attention", "reference_attention",
    "CoordinatorConfig", "host_local_array", "initialize",
    "is_initialized", "replicate_to_global",
]
