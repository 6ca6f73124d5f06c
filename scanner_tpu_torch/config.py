"""User configuration (~/.scanner_tpu.toml).

Capability parity: reference scannerpy/config.py (Config:27-110 —
storage type/db_path, master/worker network addresses).  The file format
is the JAX package's, key for key, so one TOML configures either
package; keys the port has no use for are parsed and ignored (their
property docstrings say so).
"""

from __future__ import annotations

import os
try:
    import tomllib
except ModuleNotFoundError:  # Python < 3.11: tomllib is vendored tomli
    import tomli as tomllib
from typing import Any, Dict, Optional

from .common import ScannerException

DEFAULT_PATH = os.path.expanduser("~/.scanner_tpu.toml")


def default_config() -> Dict[str, Any]:
    return {
        "storage": {
            # "posix" | "gcs" | "memory"; a gs://bucket/prefix db_path
            # selects gcs automatically (reference config.py:56)
            "type": "posix",
            "db_path": os.path.expanduser("~/.scanner_tpu/db"),
        },
        "network": {
            # empty master = run jobs in-process; set a hostname (even
            # "localhost") to connect to a cluster master
            "master": "",
            "master_port": 5000,
            "worker_port": 5001,
            # 0 disables the /metrics|/healthz|/statusz endpoint (the
            # default); any other value binds it on that port
            # (docs/observability.md)
            "metrics_port": 0,
        },
        "perf": {
            # the JAX package's persistent compilation-cache directory.
            # Parsed and ignored by this package: its kernel libraries
            # are built once into scanner_tpu_torch/_build/.
            "compilation_cache_dir": "",
            # paged per-device frame cache (engine/framecache.py):
            # decoded frames are pooled in keyframe-aligned pages and
            # reused across tasks (stencil overlap, Gather samplings,
            # hot clips) instead of re-decoding + re-staging.  On by
            # default; SCANNER_TPU_FRAME_CACHE=0 overrides per process.
            "frame_cache_enabled": True,
            # per-device capacity target in MB (LRU-evicted past it; a
            # firing hbm_pressure alert shrinks it further);
            # SCANNER_TPU_FRAME_CACHE_MB overrides per process.
            "frame_cache_mb": 256,
            # frames per cache page; 0 (the default) auto-derives the
            # smallest keyframe-interval multiple >= 32 so pages map
            # onto GOP-decodable units.
            "frame_cache_page_frames": 0,
            # chain fusion (graph/fusion.py): chains of consecutive
            # fusable device ops run as ONE captured CUDA graph per
            # bucket.  On by default; SCANNER_TPU_FUSION=0
            # overrides per process (the staged-path A/B lever).
            "fusion_enabled": True,
            # minimum chain length the fusion planner will fuse (a
            # singleton IS the staged path; raise to bound planner
            # aggressiveness).
            "fusion_min_chain": 2,
        },
        "memory": {
            # memory observability (util/memstats.py): per-device memory
            # gauges + the allocation ledger every engine-owned device
            # buffer registers in.  On by default (nanoseconds per
            # buffer); SCANNER_TPU_MEMSTATS=0 overrides per process.
            "enabled": True,
            # ledger entries named in an OOM/status memory report
            # (largest first); SCANNER_TPU_MEMSTATS_TOPN overrides.
            "report_top_n": 10,
        },
        "trace": {
            # distributed-tracing span recording (util/tracing.py):
            # task/stage/op spans, flight recorder, cross-host trace
            # assembly.  On by default (low overhead, docs/
            # observability.md); the SCANNER_TPU_TRACING env var
            # overrides per process.
            "enabled": True,
            # cross-host clock-offset estimation (util/clocksync.py):
            # NTP-style exchange piggybacked on heartbeats, published
            # as clock_offset gauges and carried on span batches.  The
            # SCANNER_TPU_CLOCKSYNC env var overrides per process.
            "clocksync_enabled": True,
            # rebase remote span timestamps onto master time during
            # trace assembly (GetTrace); per-call raw_clocks /
            # scanner_trace --raw-clocks is the escape hatch.
            "rebase_clocks": True,
        },
        "alerts": {
            # the health/SLO engine (util/health.py): declarative alert
            # rules evaluated in-process over the metrics registry,
            # rolled up into /healthz | /readyz | /alertz and
            # Client.health().  On by default (a ~1 Hz sample of the
            # rule-referenced series); SCANNER_TPU_HEALTH=0 overrides
            # per process.
            "enabled": True,
            # user alert rules appended to the built-in default
            # ruleset; ";"-separated clauses, grammar in
            # docs/observability.md §Health & SLOs.  "" = defaults only.
            "rules": "",
        },
        "remediation": {
            # the alert->action remediation controller
            # (engine/controller.py): autoscaling, preemption drain,
            # admission pause, frame-cache shrink, ladder re-warm.  On
            # by default; SCANNER_TPU_REMEDIATION=0 overrides per
            # process (the signal-only kill switch).
            "enabled": True,
            # dry-run: playbooks decide (cooldown/hysteresis/rate
            # limit, audit, metrics) but never invoke their action —
            # the staging-environment mode.
            "dry_run": False,
            # autoscaler replica bounds ([min,max]) used when a master
            # runs with autoscale=True (docs/robustness.md
            # §Remediation playbooks).
            "autoscale_min": 1,
            "autoscale_max": 8,
        },
        "robustness": {
            # write-ahead bulk journal (engine/journal.py): between
            # checkpoints the master appends completion/strike/
            # blacklist/admission events as checksummed segment
            # objects, so a master kill -9 mid-bulk loses ZERO
            # acknowledged completions (docs/robustness.md §Durable
            # control plane).  On by default; SCANNER_TPU_JOURNAL=0
            # overrides per process (recovery then rides the
            # checkpoint window alone).
            "journal_enabled": True,
            # records per journal segment before rotation (bounds the
            # open-segment rewrite cost and the per-segment blast
            # radius of a torn tail); SCANNER_TPU_JOURNAL_ROTATE
            # overrides per process.
            "journal_rotate_records": 256,
        },
        "gang": {
            # gang-scheduled multi-host execution (engine/gang.py,
            # docs/robustness.md §Gang scheduling): a bulk with
            # PerfParams.gang_hosts > 0 co-schedules each task onto a
            # gang of live workers that rendezvous into one
            # torch.distributed process group.  On by default (inert
            # unless a bulk asks); SCANNER_TPU_GANG=0 overrides per
            # process.
            "enabled": True,
            # bound on the process-group rendezvous at gang start —
            # a lost member must not pin the survivors in initialize
            # forever; SCANNER_TPU_GANG_INIT_TIMEOUT overrides.
            "init_timeout_s": 60,
            # how long the master waits for a full gang_hosts pool
            # before forming on whatever capacity HAS pooled (the
            # loss-tolerant re-form path);
            # SCANNER_TPU_GANG_FORM_TIMEOUT overrides.
            "form_timeout_s": 5,
            # mesh-partitioned gang evaluation: each member evaluates
            # only its row shard and member 0 assembles the output
            # over the interconnect (~N× per-gang throughput); off =
            # the replicated N×-redundant evaluation.  The master's
            # value decides per gang; SCANNER_TPU_GANG_SHARDED
            # overrides per process.
            "sharded": True,
            # stencil boundary rows exchange between neighbor members
            # over the gang's process group (parallel/halo.py) instead of each member
            # decoding past its shard edge; SCANNER_TPU_GANG_HALO
            # overrides per process.
            "halo_exchange": True,
        },
        "control": {
            # master shards in the horizontally sharded control plane
            # (engine/shardmap.py, docs/robustness.md §Sharded control
            # plane): bulks partition across this many masters by
            # consistent hash on the admission token.  1 (the default)
            # is the classic single-master cluster, bit-for-bit;
            # SCANNER_TPU_CONTROL_SHARDS overrides per process.
            "shards": 1,
        },
        "faults": {
            # deterministic fault-injection plan (docs/robustness.md for
            # the clause syntax; util/faults.py implements it).  "" (the
            # default) disarms every injection site; the
            # SCANNER_TPU_FAULTS env var overrides per process.  NEVER
            # set in production config — this exists for chaos testing.
            "plan": "",
        },
    }


def dump_toml(cfg: Dict[str, Any]) -> str:
    """Minimal TOML writer (the environment has no toml-writing lib)."""
    lines = []
    for section, values in cfg.items():
        lines.append(f"[{section}]")
        for k, v in values.items():
            if isinstance(v, str):
                lines.append(f'{k} = "{v}"')
            elif isinstance(v, bool):
                lines.append(f"{k} = {str(v).lower()}")
            else:
                lines.append(f"{k} = {v}")
        lines.append("")
    return "\n".join(lines)


class Config:
    def __init__(self, config_path: Optional[str] = None,
                 db_path: Optional[str] = None):
        path = config_path or DEFAULT_PATH
        cfg = default_config()
        if os.path.exists(path):
            with open(path, "rb") as f:
                loaded = tomllib.load(f)
            for section, values in loaded.items():
                cfg.setdefault(section, {}).update(values)
        elif config_path is not None:
            raise ScannerException(f"config file not found: {config_path}")
        if db_path is not None:
            cfg["storage"]["db_path"] = db_path
        self.config = cfg
        self.config_path = path

    @property
    def storage_type(self) -> str:
        return self.config["storage"]["type"]

    @property
    def db_path(self) -> str:
        return self.config["storage"]["db_path"]

    @property
    def master_address(self) -> Optional[str]:
        """host:port of the cluster master, or None for in-process
        execution.  Accepts either master/master_port or a combined
        master_address key."""
        n = self.config["network"]
        if n.get("master_address"):
            return n["master_address"]
        if n.get("master"):
            return f"{n['master']}:{n['master_port']}"
        return None

    @property
    def compilation_cache_dir(self) -> Optional[str]:
        """The JAX package's compilation-cache directory, or None when
        unset (the default).  This package ignores it: its kernel
        libraries are built into scanner_tpu_torch/_build/."""
        d = self.config.get("perf", {}).get("compilation_cache_dir", "")
        return d or None

    @property
    def frame_cache_enabled(self) -> bool:
        """Paged per-device frame cache (the deployment default;
        SCANNER_TPU_FRAME_CACHE overrides per process)."""
        return bool(self.config.get("perf", {}).get(
            "frame_cache_enabled", True))

    @property
    def frame_cache_mb(self) -> int:
        """Per-device frame-cache capacity target in MB
        (SCANNER_TPU_FRAME_CACHE_MB overrides per process)."""
        return int(self.config.get("perf", {}).get("frame_cache_mb",
                                                   256))

    @property
    def frame_cache_page_frames(self) -> int:
        """Frames per frame-cache page (0 = keyframe-aligned auto)."""
        return int(self.config.get("perf", {}).get(
            "frame_cache_page_frames", 0))

    @property
    def fusion_enabled(self) -> bool:
        """Chain fusion of device ops (one CUDA graph per bucket) (the
        deployment default; SCANNER_TPU_FUSION overrides per
        process)."""
        return bool(self.config.get("perf", {}).get("fusion_enabled",
                                                    True))

    @property
    def fusion_min_chain(self) -> int:
        """Minimum member count the fusion planner fuses (>= 2)."""
        return int(self.config.get("perf", {}).get("fusion_min_chain",
                                                   2))

    @property
    def memstats_enabled(self) -> bool:
        """Memory accounting (device-memory gauges + allocation ledger; the
        deployment default — SCANNER_TPU_MEMSTATS overrides)."""
        return bool(self.config.get("memory", {}).get("enabled", True))

    @property
    def memstats_report_top_n(self) -> int:
        """Ledger entries named in a memory report, largest first."""
        return int(self.config.get("memory", {}).get("report_top_n", 10))

    @property
    def tracing_enabled(self) -> bool:
        """Distributed-tracing span recording (the deployment default;
        SCANNER_TPU_TRACING overrides per process)."""
        return bool(self.config.get("trace", {}).get("enabled", True))

    @property
    def clocksync_enabled(self) -> bool:
        """Cross-host clock-offset estimation (the deployment default;
        SCANNER_TPU_CLOCKSYNC overrides per process)."""
        return bool(self.config.get("trace", {}).get(
            "clocksync_enabled", True))

    @property
    def rebase_clocks(self) -> bool:
        """Rebase remote span timestamps onto master time during trace
        assembly (per-call raw_clocks is the escape hatch)."""
        return bool(self.config.get("trace", {}).get(
            "rebase_clocks", True))

    @property
    def alerts_enabled(self) -> bool:
        """Health/SLO alert engine (the deployment default;
        SCANNER_TPU_HEALTH overrides per process)."""
        return bool(self.config.get("alerts", {}).get("enabled", True))

    @property
    def alert_rules(self) -> str:
        """User alert rules ([alerts] rules clause spec), "" = only the
        built-in default ruleset."""
        return str(self.config.get("alerts", {}).get("rules", "") or "")

    @property
    def remediation_enabled(self) -> bool:
        """Alert->action remediation controller (the deployment
        default; SCANNER_TPU_REMEDIATION overrides per process)."""
        return bool(self.config.get("remediation", {}).get("enabled",
                                                           True))

    @property
    def remediation_dry_run(self) -> bool:
        """Remediation dry-run: decisions audit but never actuate."""
        return bool(self.config.get("remediation", {}).get("dry_run",
                                                           False))

    @property
    def remediation_autoscale_bounds(self) -> tuple:
        """(min, max) worker replica bounds for the autoscaler."""
        r = self.config.get("remediation", {})
        return (int(r.get("autoscale_min", 1)),
                int(r.get("autoscale_max", 8)))

    @property
    def journal_enabled(self) -> bool:
        """Write-ahead bulk journal (the deployment default;
        SCANNER_TPU_JOURNAL overrides per process)."""
        return bool(self.config.get("robustness", {}).get(
            "journal_enabled", True))

    @property
    def journal_rotate_records(self) -> int:
        """Records per journal segment before rotation
        (SCANNER_TPU_JOURNAL_ROTATE overrides per process)."""
        return int(self.config.get("robustness", {}).get(
            "journal_rotate_records", 256))

    @property
    def gang_enabled(self) -> bool:
        """Gang-scheduled multi-host execution (the deployment
        default; SCANNER_TPU_GANG overrides per process)."""
        return bool(self.config.get("gang", {}).get("enabled", True))

    @property
    def gang_init_timeout_s(self) -> float:
        """Rendezvous bound for gang members
        (SCANNER_TPU_GANG_INIT_TIMEOUT overrides per process)."""
        return float(self.config.get("gang", {}).get("init_timeout_s",
                                                     60))

    @property
    def gang_form_timeout_s(self) -> float:
        """How long the master holds out for a full gang before
        forming on the pooled capacity
        (SCANNER_TPU_GANG_FORM_TIMEOUT overrides per process)."""
        return float(self.config.get("gang", {}).get("form_timeout_s",
                                                     5))

    @property
    def gang_sharded(self) -> bool:
        """Mesh-partitioned gang evaluation — members evaluate only
        their row shard (the deployment default;
        SCANNER_TPU_GANG_SHARDED overrides per process)."""
        return bool(self.config.get("gang", {}).get("sharded", True))

    @property
    def gang_halo_exchange(self) -> bool:
        """Stencil boundary rows exchange between neighbor members
        over the mesh instead of decoding redundantly (the deployment
        default; SCANNER_TPU_GANG_HALO overrides per process)."""
        return bool(self.config.get("gang", {}).get("halo_exchange",
                                                    True))

    @property
    def control_shards(self) -> int:
        """Master shard count for the sharded control plane (the
        deployment default; SCANNER_TPU_CONTROL_SHARDS overrides per
        process)."""
        return int(self.config.get("control", {}).get("shards", 1))

    @property
    def faults_plan(self) -> Optional[str]:
        """Armed fault-injection plan spec, or None (the default: all
        injection sites disabled, zero overhead)."""
        plan = self.config.get("faults", {}).get("plan", "")
        return plan or None

    @property
    def metrics_port(self) -> Optional[int]:
        """Port for the live /metrics endpoint, or None when disabled
        (the default: telemetry serving is strictly opt-in)."""
        port = int(self.config["network"].get("metrics_port", 0) or 0)
        return port or None

    @staticmethod
    def write_default(path: str = DEFAULT_PATH) -> str:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(dump_toml(default_config()))
        return path
