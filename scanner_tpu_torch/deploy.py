"""Cluster deployment tooling for GKE GPU node pools.

The counterpart of the JAX package's deploy.py (GKE TPU node pools), and
like it a retarget of the reference's scannerpy/kube.py (CloudConfig,
MachineType, ClusterConfig with price estimation, Cluster
create/scale/delete managing master + worker deployments,
kube.py:38-779) — here back to GPU node pools, for workers that run
scanner_tpu_torch on NVIDIA H100 cards:

  * gcloud lifecycle COMMANDS are generated as pure argv lists
    (`cluster_create_commands` etc.) and only executed when gcloud is
    present, so every path is testable offline and operators can audit
    and copy the exact commands.  A node pool asks for its cards with
    `--accelerator type=<accelerator>,count=<gpus>,gpu-driver-version=
    latest`: GKE installs the NVIDIA software on its nodes.
  * workers are a StatefulSet behind a headless Service.  A worker group
    that spans several hosts (`MachineType.hosts > 1`, the counterpart
    of a multi-host TPU slice) is one StatefulSet on a node pool of its
    own: every pod derives its rank from its pod ordinal and dials pod
    0 as the coordinator of the process group it joins for its
    lifetime (`Worker(coordinator=)`, NCCL on its cards;
    parallel/distributed.py `join`).
  * each worker pod asks for `nvidia.com/gpu` cards, selects nodes by
    `cloud.google.com/gke-accelerator`, runs `start_worker(...,
    device='cuda')` and mounts an in-memory /dev/shm: NCCL needs more
    shared memory than a container gets by default.  With
    `pipeline_instances=None` a worker runs one pipeline instance per
    card (engine/evaluate.py `default_pipeline_instances`).
  * the worker env wires SCANNER_TPU_LOG and the gang's rendezvous
    bound; a ConfigMap carries ~/.scanner_tpu.toml with the same
    sections the JAX package writes.  `compilation_cache_dir` is
    accepted and unused (the port's Worker ignores it: its kernels are
    built once into scanner_tpu_torch/_build/), so nothing is written
    for it.
"""

from __future__ import annotations

import json
import shutil
import subprocess
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .common import ScannerException
from .config import dump_toml

# GCE machine types by (GKE accelerator type, cards per host): the A3
# family is the one that carries H100s
GPU_MACHINE_TYPES = {
    ("nvidia-h100-80gb", 1): "a3-highgpu-1g",
    ("nvidia-h100-80gb", 2): "a3-highgpu-2g",
    ("nvidia-h100-80gb", 4): "a3-highgpu-4g",
    ("nvidia-h100-80gb", 8): "a3-highgpu-8g",
    ("nvidia-h100-mega-80gb", 8): "a3-megagpu-8g",
}
# us-central1 on-demand ballpark $/hr per machine, cards, vCPUs and
# memory included: documented estimates from the public Compute Engine
# GPU pricing page, like the reference's price table — not quotes.
# Spot ~= 60% off.
GPU_MACHINE_PRICES = {
    "a3-highgpu-1g": 11.06,
    "a3-highgpu-2g": 22.12,
    "a3-highgpu-4g": 44.25,
    "a3-highgpu-8g": 88.49,
    "a3-megagpu-8g": 97.48,
}
SPOT_DISCOUNT = 0.4
CPU_PRICE_PER_CORE = 0.033
# the port the lifetime group's rank 0 serves its TCPStore at
COORDINATOR_PORT = 8476


@dataclass
class CloudConfig:
    project: str
    zone: str = "us-central1-a"
    storage_bucket: Optional[str] = None


@dataclass
class MachineType:
    """One worker group's node shape: `hosts` machines (1 = one
    machine per worker; more = a group joined into one process group,
    the counterpart of a multi-host TPU slice), each with `gpus` cards of
    GKE accelerator type `accelerator`; `cpus` and `memory_gb` are the
    worker pod's requests."""

    accelerator: str = "nvidia-h100-80gb"
    gpus: int = 1
    hosts: int = 1
    cpus: int = 20
    memory_gb: int = 160
    spot: bool = False

    def machine_type(self) -> str:
        try:
            return GPU_MACHINE_TYPES[(self.accelerator, int(self.gpus))]
        except KeyError:
            raise ScannerException(
                f"no known GCE machine type carries {self.gpus} x "
                f"{self.accelerator}; add it to GPU_MACHINE_TYPES")

    def price_per_hour(self) -> float:
        """One worker group's machines (all `hosts` of them)."""
        price = GPU_MACHINE_PRICES.get(self.machine_type(), 0.0) \
            * max(1, self.hosts)
        return price * SPOT_DISCOUNT if self.spot else price


@dataclass
class ClusterConfig:
    id: str
    # worker groups: pods when hosts == 1, StatefulSets of `hosts` pods
    # (each on a node pool of its own) when hosts > 1
    num_workers: int
    master_cpus: int = 8
    worker: MachineType = field(default_factory=MachineType)
    # the image must hold scanner_tpu_torch with torch for CUDA, nvcc
    # (the kernels are built at first use) and grpcio
    image: str = "scanner-tpu-torch:latest"
    db_path: str = "/data/db"      # or gs://bucket/db for the GCS backend
    master_port: int = 5000
    # None = workers run one pipeline instance per card
    # (engine/evaluate.py default_pipeline_instances); an explicit int —
    # including 1 — is used as given
    pipeline_instances: Optional[int] = None
    log_level: str = "info"
    autoscale: bool = False
    max_workers: Optional[int] = None
    # 0 = no /metrics|/healthz|/statusz endpoint (the default); non-zero
    # serves it on that port on master AND workers and exposes the
    # container port for Prometheus scraping
    metrics_port: int = 0
    # accepted for the JAX package's signature and unused: the port's
    # Worker ignores a compilation cache (its kernels are built once
    # into scanner_tpu_torch/_build/), so no manifest mentions it
    compilation_cache_dir: str = ""
    # seconds kubernetes waits between SIGTERM and SIGKILL on worker
    # pods.  start_worker maps SIGTERM to drain mode (finish in-flight
    # tasks, stop pulling, deregister — engine/service.py Worker.drain),
    # so size this to cover the longest task plus its save
    termination_grace_period: int = 120
    # user alert rules appended to the built-in health/SLO ruleset,
    # wired into the ConfigMap's [alerts] section.  "" = defaults only
    alert_rules: str = ""
    # alert->action remediation (engine/controller.py), wired into the
    # ConfigMap's [remediation] section for every pod
    remediation: bool = True
    remediation_dry_run: bool = False
    autoscale_min: int = 1
    autoscale_max: int = 8
    # gang-scheduled execution (engine/gang.py): the [gang] ConfigMap
    # section and each worker's rendezvous bound
    gang: bool = True
    gang_init_timeout_s: int = 60
    gang_form_timeout_s: int = 5
    gang_sharded: bool = True
    gang_halo_exchange: bool = True

    def price_per_hour(self) -> float:
        return (self.master_cpus * CPU_PRICE_PER_CORE
                + self.num_workers * self.worker.price_per_hour())


# ---------------------------------------------------------------------------
# gcloud lifecycle commands (pure; execution is optional)
# ---------------------------------------------------------------------------

def _pool_cmd(cloud: CloudConfig, cfg: ClusterConfig, name: str,
              nodes: int) -> List[str]:
    w = cfg.worker
    c = ["gcloud", "container", "--project", cloud.project,
         "node-pools", "create", name,
         "--cluster", cfg.id,
         "--zone", cloud.zone,
         "--machine-type", w.machine_type(),
         "--accelerator",
         f"type={w.accelerator},count={w.gpus},gpu-driver-version=latest",
         "--num-nodes", str(nodes)]
    if w.spot:
        c.append("--spot")
    return c


def cluster_create_commands(cloud: CloudConfig,
                            cfg: ClusterConfig) -> List[List[str]]:
    """argv lists that bring up the GKE cluster + GPU node pool(s)
    (reference kube.py get_or_create_cluster; gcloud only runs when the
    operator executes these)."""
    hosts = cfg.worker.hosts
    cmds = [
        ["gcloud", "container", "--project", cloud.project,
         "clusters", "create", cfg.id,
         "--zone", cloud.zone,
         "--num-nodes", "1",
         "--machine-type", f"n2-standard-{cfg.master_cpus}"],
    ]
    if hosts <= 1:
        pool = _pool_cmd(cloud, cfg, f"{cfg.id}-gpu", cfg.num_workers)
        if cfg.autoscale:
            max_nodes = cfg.max_workers or cfg.num_workers * 2
            pool += ["--enable-autoscaling", "--min-nodes", "0",
                     "--max-nodes", str(max_nodes)]
        cmds.append(pool)
        return cmds
    # one node pool PER worker group: a group's process group must form
    # on its own machines, and only a dedicated pool (selected via
    # cloud.google.com/gke-nodepool) keeps its pods together.  With
    # autoscale, idle groups park at 0 nodes.
    n_pools = (cfg.max_workers or cfg.num_workers * 2) \
        if cfg.autoscale else cfg.num_workers
    for i in range(n_pools):
        # surplus autoscale pools (no StatefulSet yet) start empty
        nodes = hosts if i < cfg.num_workers else 0
        pool = _pool_cmd(cloud, cfg, f"{cfg.id}-gpu-{i}", nodes)
        if cfg.autoscale:
            pool += ["--enable-autoscaling", "--min-nodes", "0",
                     "--max-nodes", str(hosts)]
        cmds.append(pool)
    return cmds


def cluster_delete_commands(cloud: CloudConfig,
                            cfg: ClusterConfig) -> List[List[str]]:
    return [["gcloud", "container", "--project", cloud.project,
             "clusters", "delete", cfg.id, "--zone", cloud.zone,
             "--quiet"]]


def cluster_resize_commands(cloud: CloudConfig, cfg: ClusterConfig,
                            num_workers: int) -> List[List[str]]:
    """Scale worker capacity from cfg.num_workers to num_workers.
    Single-host: resize the shared pool.  Multi-host: groups scale by
    creating/deleting whole per-group pools."""
    if cfg.autoscale:
        # autoscaling pools follow their pods: scaling is kubectl-only
        return []
    base = ["gcloud", "container", "--project", cloud.project]
    if cfg.worker.hosts <= 1:
        return [base + ["clusters", "resize", cfg.id,
                        "--node-pool", f"{cfg.id}-gpu",
                        "--num-nodes", str(num_workers),
                        "--zone", cloud.zone, "--quiet"]]
    cur = cfg.num_workers
    cmds = [_pool_cmd(cloud, cfg, f"{cfg.id}-gpu-{i}", cfg.worker.hosts)
            for i in range(cur, num_workers)]          # grow
    for i in range(num_workers, cur):                   # shrink
        cmds.append(base + ["node-pools", "delete", f"{cfg.id}-gpu-{i}",
                            "--cluster", cfg.id,
                            "--zone", cloud.zone, "--quiet"])
    return cmds


# ---------------------------------------------------------------------------
# kubernetes manifests (pure)
# ---------------------------------------------------------------------------

def config_manifest(cfg: ClusterConfig) -> Dict:
    """ConfigMap carrying ~/.scanner_tpu.toml for every pod."""
    sections = {
        "storage": {"type": "gcs" if cfg.db_path.startswith("gs://")
                    else "posix",
                    "db_path": cfg.db_path},
        "network": {"master": f"{cfg.id}-master",
                    "master_port": cfg.master_port,
                    "worker_port": 5001,
                    "metrics_port": cfg.metrics_port},
    }
    if cfg.alert_rules:
        sections["alerts"] = {"rules": cfg.alert_rules}
    sections["remediation"] = {
        "enabled": cfg.remediation,
        "dry_run": cfg.remediation_dry_run,
        "autoscale_min": cfg.autoscale_min,
        "autoscale_max": cfg.autoscale_max,
    }
    sections["gang"] = {
        "enabled": cfg.gang,
        "init_timeout_s": cfg.gang_init_timeout_s,
        "form_timeout_s": cfg.gang_form_timeout_s,
        "sharded": cfg.gang_sharded,
        "halo_exchange": cfg.gang_halo_exchange,
    }
    return {
        "apiVersion": "v1", "kind": "ConfigMap",
        "metadata": {"name": f"{cfg.id}-config"},
        "data": {"scanner_tpu.toml": dump_toml(sections)},
    }


def _metrics_arg(cfg: ClusterConfig) -> str:
    return f", metrics_port={cfg.metrics_port}" if cfg.metrics_port else ""


def _probes(cfg: ClusterConfig) -> Dict:
    """Container liveness/readiness probes against the metrics
    endpoint's health routes (util/metrics.py MetricsServer):
    liveness -> /healthz (200 whenever the process can answer),
    readiness -> /readyz (503 while the health roll-up is unhealthy or
    a SIGTERM drain is in progress).  Only emitted when the endpoint
    exists (metrics_port set)."""
    if not cfg.metrics_port:
        return {}
    return {
        "livenessProbe": {
            "httpGet": {"path": "/healthz", "port": cfg.metrics_port},
            "periodSeconds": 10, "failureThreshold": 6},
        "readinessProbe": {
            "httpGet": {"path": "/readyz", "port": cfg.metrics_port},
            "periodSeconds": 5, "failureThreshold": 2},
    }


def master_manifest(cfg: ClusterConfig) -> Dict:
    """The master runs no device op: a CPU Deployment."""
    ports = [{"containerPort": cfg.master_port}]
    if cfg.metrics_port:
        ports.append({"containerPort": cfg.metrics_port,
                      "name": "metrics"})
    return {
        "apiVersion": "apps/v1", "kind": "Deployment",
        "metadata": {"name": f"{cfg.id}-master"},
        "spec": {
            "replicas": 1,
            "selector": {"matchLabels": {"app": f"{cfg.id}-master"}},
            "template": {
                "metadata": {"labels": {"app": f"{cfg.id}-master"}},
                "spec": {"containers": [{
                    "name": "master", "image": cfg.image,
                    "command": ["python", "-c",
                                ("from scanner_tpu_torch.engine.service "
                                 "import start_master; start_master("
                                 f"'{cfg.db_path}', port={cfg.master_port}"
                                 f"{_metrics_arg(cfg)},"
                                 " block=True)")],
                    "env": [{"name": "SCANNER_TPU_LOG",
                             "value": cfg.log_level}],
                    "ports": ports,
                    **_probes(cfg),
                    "resources": {"requests": {"cpu": str(cfg.master_cpus)}},
                }]},
            },
        },
    }


def _worker_command(cfg: ClusterConfig, group: int = 0) -> List[str]:
    """Worker entry: a single-host group starts a plain worker on its
    cards; a multi-host group's pods derive their rank from the pod
    ordinal (each group is its own StatefulSet) and join pod 0's
    process group for their lifetime before serving."""
    # each pod advertises its stable headless-service DNS name so the
    # master's GetMetrics aggregation can dial it across hosts
    adv = (f"advertise_host=os.environ['POD_NAME'] + "
           f"'.{cfg.id}-workers', ")
    args = (f"start_worker('{cfg.id}-master:{cfg.master_port}', "
            f"'{cfg.db_path}', "
            f"pipeline_instances={cfg.pipeline_instances}"
            f"{_metrics_arg(cfg)}, {adv}")
    if cfg.worker.hosts <= 1:
        return ["python", "-c",
                ("import os; "
                 "from scanner_tpu_torch.engine.service import "
                 "start_worker; "
                 f"{args}device='cuda', block=True)")]
    sts = f"{cfg.id}-worker-s{group}"
    return ["python", "-c", (
        "import os; "
        "from scanner_tpu_torch.engine.service import start_worker; "
        "from scanner_tpu_torch.parallel.distributed import "
        "CoordinatorConfig; "
        "pid = int(os.environ['POD_NAME'].rsplit('-', 1)[1]); "
        f"coord = CoordinatorConfig("
        f"address=\"{sts}-0.{cfg.id}-workers:{COORDINATOR_PORT}\", "
        f"num_processes={cfg.worker.hosts}, process_id=pid); "
        f"{args}coordinator=coord, device='cuda', block=True)")]


def _worker_statefulset(cfg: ClusterConfig, name: str, replicas: int,
                        command: List[str],
                        extra_selector: Optional[Dict] = None) -> Dict:
    node_selector = {
        "cloud.google.com/gke-accelerator": cfg.worker.accelerator}
    node_selector.update(extra_selector or {})
    return {
        "apiVersion": "apps/v1", "kind": "StatefulSet",
        "metadata": {"name": name},
        "spec": {
            "serviceName": f"{cfg.id}-workers",
            "replicas": replicas,
            "podManagementPolicy": "Parallel",
            "selector": {"matchLabels": {"app": f"{cfg.id}-worker",
                                         "sts": name}},
            "template": {
                "metadata": {"labels": {"app": f"{cfg.id}-worker",
                                        "sts": name}},
                "spec": {
                    "nodeSelector": node_selector,
                    # SIGTERM -> Worker.drain; give in-flight tasks this
                    # long to finish before the SIGKILL follow-up
                    "terminationGracePeriodSeconds":
                        cfg.termination_grace_period,
                    "containers": [{
                        "name": "worker", "image": cfg.image,
                        "command": command,
                        **({"ports": [{"containerPort": cfg.metrics_port,
                                       "name": "metrics"}]}
                           if cfg.metrics_port else {}),
                        **_probes(cfg),
                        "env": [
                            {"name": "SCANNER_TPU_LOG",
                             "value": cfg.log_level},
                            {"name": "POD_NAME",
                             "valueFrom": {"fieldRef": {
                                 "fieldPath": "metadata.name"}}},
                            # gang member runners rendezvous with this
                            # bound (engine/gang.py); 0 also strips the
                            # gang port reservation from the worker
                            *([{"name": "SCANNER_TPU_GANG_INIT_TIMEOUT",
                                "value": str(cfg.gang_init_timeout_s)}]
                              if cfg.gang else
                              [{"name": "SCANNER_TPU_GANG",
                                "value": "0"}]),
                        ],
                        "resources": {
                            "requests": {
                                "cpu": str(cfg.worker.cpus),
                                "memory": f"{cfg.worker.memory_gb}Gi"},
                            "limits": {"nvidia.com/gpu":
                                       str(cfg.worker.gpus)},
                        },
                        "volumeMounts": [
                            {"name": "config",
                             "mountPath": "/root/.scanner_tpu.toml",
                             "subPath": "scanner_tpu.toml"},
                            {"name": "dshm", "mountPath": "/dev/shm"}],
                    }],
                    "volumes": [
                        {"name": "config",
                         "configMap": {"name": f"{cfg.id}-config"}},
                        # NCCL's shared-memory transport needs more than
                        # the container runtime's default /dev/shm
                        {"name": "dshm",
                         "emptyDir": {"medium": "Memory"}}],
                },
            },
        },
    }


def worker_manifests(cfg: ClusterConfig) -> List[Dict]:
    """Worker StatefulSets behind one headless Service.

    Single-host groups: one StatefulSet, one pod per group.  Multi-host
    groups: one StatefulSet PER GROUP, pinned to that group's dedicated
    node pool (cloud.google.com/gke-nodepool), so its process group
    forms on its own machines."""
    hosts = cfg.worker.hosts
    if hosts <= 1:
        return [_worker_statefulset(cfg, f"{cfg.id}-worker",
                                    cfg.num_workers,
                                    _worker_command(cfg))]
    return [
        _worker_statefulset(
            cfg, f"{cfg.id}-worker-s{i}", hosts,
            _worker_command(cfg, group=i),
            extra_selector={
                "cloud.google.com/gke-nodepool": f"{cfg.id}-gpu-{i}"})
        for i in range(cfg.num_workers)
    ]


def worker_manifest(cfg: ClusterConfig) -> Dict:
    """Single-manifest accessor (single-host configs)."""
    ms = worker_manifests(cfg)
    if len(ms) != 1:
        raise ScannerException(
            "multi-host configs produce one StatefulSet per worker "
            "group; use worker_manifests()")
    return ms[0]


def service_manifest(cfg: ClusterConfig) -> Dict:
    return {
        "apiVersion": "v1", "kind": "Service",
        "metadata": {"name": f"{cfg.id}-master"},
        "spec": {
            "selector": {"app": f"{cfg.id}-master"},
            "ports": [{"port": cfg.master_port,
                       "targetPort": cfg.master_port}],
        },
    }


def workers_service_manifest(cfg: ClusterConfig) -> Dict:
    """Headless service giving StatefulSet pods stable DNS names
    (<pod>.<cfg.id>-workers) — the coordinator address for multi-host
    groups."""
    return {
        "apiVersion": "v1", "kind": "Service",
        "metadata": {"name": f"{cfg.id}-workers"},
        "spec": {
            "clusterIP": "None",
            "selector": {"app": f"{cfg.id}-worker"},
            "ports": [{"port": COORDINATOR_PORT, "name": "coordinator"}],
        },
    }


class Cluster:
    """Lifecycle wrapper (reference kube.py Cluster): create/scale/delete
    via gcloud/kubectl; manifests() and *_commands() work without
    either installed."""

    def __init__(self, cloud: CloudConfig, cfg: ClusterConfig):
        self.cloud = cloud
        self.cfg = cfg

    # -- pure outputs ---------------------------------------------------

    def manifests(self) -> List[Dict]:
        return [config_manifest(self.cfg), master_manifest(self.cfg),
                service_manifest(self.cfg),
                workers_service_manifest(self.cfg),
                *worker_manifests(self.cfg)]

    def manifests_json(self) -> str:
        return "\n---\n".join(json.dumps(m, indent=2)
                              for m in self.manifests())

    def create_commands(self) -> List[List[str]]:
        return cluster_create_commands(self.cloud, self.cfg)

    def delete_commands(self) -> List[List[str]]:
        return cluster_delete_commands(self.cloud, self.cfg)

    # -- execution (requires gcloud/kubectl on PATH) --------------------

    def _run(self, argv: List[str],
             input_data: Optional[str] = None):
        if shutil.which(argv[0]) is None:
            raise ScannerException(
                f"{argv[0]} not available; use manifests_json() / "
                f"*_commands() and run manually")
        return subprocess.run(argv, input=input_data, text=True,
                              check=True, capture_output=True)

    def create_cluster(self) -> None:
        for cmd in self.create_commands():
            self._run(cmd)

    def delete_cluster(self) -> None:
        for cmd in self.delete_commands():
            self._run(cmd)

    def create(self) -> None:
        self._run(["kubectl", "apply", "-f", "-"],
                  input_data=self.manifests_json())

    def scale(self, num_workers: int) -> None:
        if shutil.which("kubectl") is None:
            raise ScannerException(
                "kubectl not available; use manifests_json() / "
                "*_commands() and run manually")
        # pool changes are derived from old-vs-new worker counts, so
        # compute them BEFORE mutating cfg
        resize = cluster_resize_commands(self.cloud, self.cfg, num_workers)
        old = self.cfg.num_workers
        if self.cfg.worker.hosts <= 1:
            self._run(["kubectl", "scale",
                       f"statefulset/{self.cfg.id}-worker",
                       f"--replicas={num_workers}"])
        else:
            # group-granular: apply manifests for the new group set,
            # drop StatefulSets of removed groups
            self.cfg.num_workers = num_workers
            self._run(["kubectl", "apply", "-f", "-"],
                      input_data=self.manifests_json())
            for i in range(num_workers, old):
                self._run(["kubectl", "delete", "statefulset",
                           f"{self.cfg.id}-worker-s{i}", "--ignore-not-found"])
        self.cfg.num_workers = num_workers
        if not resize:
            return  # autoscaling pools follow their pods
        if shutil.which("gcloud") is None:
            # the operator applies the pool changes with the printed
            # commands
            print("deploy: gcloud not available; run manually:")
            for cmd in resize:
                print(" ", " ".join(cmd))
            return
        for cmd in resize:
            self._run(cmd)

    def delete(self) -> None:
        self._run(["kubectl", "delete", "-f", "-"],
                  input_data=self.manifests_json())

    def master_address(self) -> str:
        return f"{self.cfg.id}-master:{self.cfg.master_port}"

    def scale_actuator(self):
        """The autoscaler-facing replica setter
        (``Master(autoscale=True, scale_actuator=cluster.scale_actuator())``):
        just ``Cluster.scale`` — kubernetes removes surplus pods via
        SIGTERM, which ``start_worker`` maps to ``Worker.drain``, so an
        autoscale-down never kills in-flight tasks."""
        return self.scale
