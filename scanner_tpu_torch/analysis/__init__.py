"""Offline analyses of the port's own source.

`analysis.static` is the static-analysis suite (`tools/torch_check.py`):
AST passes that enforce the program properties the engine's correctness
and performance story depend on — capture safety of the bodies a fused
chain records into a CUDA graph, lock-order discipline in the threaded
pipeline, write-ahead and fencing discipline in the control plane, and
the code↔docs↔wiring contracts (metric catalog, env vars, config keys,
fault sites, RPC surface).  `analysis.model` is the bounded-interleaving
checker of the control-plane protocol (`tools/torch_model.py`).  Both
are the JAX package's, kept as the port's own copies.  See
docs/static-analysis.md and docs/torch/analysis.md.
"""

from . import static  # noqa: F401
