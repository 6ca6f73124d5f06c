"""Gang-scheduled multi-host execution: what this package has of it.

In the JAX package a bulk with `PerfParams.gang_hosts = N > 0` runs
each task on a **gang**: the master co-schedules N live workers, fences
them with a `(gang_id, epoch)` pair, and each member's child process
joins one multi-process runtime and evaluates a mesh-partitioned shard.
Both halves wait for ROADMAP A.7 here: the member half needs
`parallel/distributed`, and the master's scheduling half has nothing
to schedule without it.

So this package's master refuses such a bulk at admission
(engine/service.py `_rpc_new_job`) with `REFUSAL`, its workers pull
only independent tasks, and the config's `[gang]` keys are parsed and
ignored (config.py).  A local `Client` run treats any `gang_hosts` as
a single-host job, as the JAX package's does.
"""

from __future__ import annotations

REFUSAL = ("gang scheduling (PerfParams.gang_hosts > 0) is not "
           "ported to scanner_tpu_torch: the gang member half "
           "waits for ROADMAP A.7 (multi-GPU and gangs)")


def requested(perf) -> bool:
    """True when a bulk's PerfParams ask for gang hosts."""
    return int(getattr(perf, "gang_hosts", 0) or 0) > 0
