"""GKE GPU node pools (scanner_tpu_torch/deploy.py): the JAX package's
five deploy tests (tests/test_extensions.py) for GPU pools, and the
manifests held against the JAX package's for the same shared
ClusterConfig fields — the ConfigMap TOML, the master Deployment, the
probes, ports, env and grace period are the same; only the accelerator
parts (node pools, node selectors, resources, /dev/shm) and the
package name in the generated programs differ.  Every generated `-c`
program parses and imports no module of the JAX package."""

import ast
import copy

import pytest

from scanner_tpu import deploy as jdeploy

from scanner_tpu_torch.common import ScannerException
from scanner_tpu_torch.deploy import (CloudConfig, Cluster, ClusterConfig,
                                      MachineType, cluster_resize_commands)

H100_8 = dict(accelerator="nvidia-h100-80gb", gpus=8)
MEGA_2 = dict(accelerator="nvidia-h100-mega-80gb", gpus=8, hosts=2)


def _by_kind(cfg, cloud=None):
    return {(m["kind"], m["metadata"]["name"]): m
            for m in Cluster(cloud or CloudConfig(project="p"),
                             cfg).manifests()}


def _programs(manifests):
    for m in manifests.values():
        spec = m.get("spec", {}).get("template", {}).get("spec", {})
        for c in spec.get("containers", []):
            yield c["command"][2]


def _check_program(src):
    tree = ast.parse(src)  # a generated -c program must be valid python
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        elif isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("scanner_tpu", "jax"), src
            assert name.startswith("scanner_tpu_torch") or name == "os"


def test_deploy_manifests():
    cfg = ClusterConfig(id="sc", num_workers=4,
                        worker=MachineType(**H100_8))
    cluster = Cluster(CloudConfig(project="p"), cfg)
    by_kind = _by_kind(cfg)
    assert ("Deployment", "sc-master") in by_kind
    assert ("ConfigMap", "sc-config") in by_kind
    workers = by_kind[("StatefulSet", "sc-worker")]
    assert workers["spec"]["replicas"] == 4  # single-host: 1 pod each
    pod = workers["spec"]["template"]["spec"]
    limits = pod["containers"][0]["resources"]["limits"]
    assert limits == {"nvidia.com/gpu": "8"}
    assert pod["nodeSelector"] == {
        "cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
    # NCCL's shared memory: an in-memory /dev/shm
    assert {"name": "dshm", "mountPath": "/dev/shm"} in \
        pod["containers"][0]["volumeMounts"]
    assert {"name": "dshm", "emptyDir": {"medium": "Memory"}} in \
        pod["volumes"]
    # SIGTERM drain window (Worker.drain)
    assert pod["terminationGracePeriodSeconds"] == \
        cfg.termination_grace_period
    assert cfg.price_per_hour() > 0
    assert "sc-master" in cluster.manifests_json()
    toml = by_kind[("ConfigMap", "sc-config")]["data"]["scanner_tpu.toml"]
    assert 'type = "posix"' in toml
    program = pod["containers"][0]["command"][2]
    assert "device='cuda'" in program and "coordinator" not in program
    # None = one pipeline instance per card
    assert "pipeline_instances=None" in program
    for src in _programs(by_kind):
        _check_program(src)


def test_deploy_multihost_slice():
    """A worker group of two a3-megagpu-8g hosts: each group is its OWN
    StatefulSet pinned to a dedicated node pool (gke-nodepool) so its
    process group forms on its own machines; rank = pod ordinal,
    coordinator at pod 0's headless-service DNS name, NCCL on the
    cards."""
    cfg = ClusterConfig(id="sc", num_workers=3,
                        worker=MachineType(**MEGA_2),
                        db_path="gs://bkt/db")
    by_kind = _by_kind(cfg)
    for i in range(3):
        workers = by_kind[("StatefulSet", f"sc-worker-s{i}")]
        assert workers["spec"]["replicas"] == 2   # hosts per group
        pod = workers["spec"]["template"]["spec"]
        assert pod["nodeSelector"] == {
            "cloud.google.com/gke-accelerator": "nvidia-h100-mega-80gb",
            "cloud.google.com/gke-nodepool": f"sc-gpu-{i}"}
        payload = pod["containers"][0]["command"][2]
        _check_program(payload)
        assert "num_processes=2" in payload
        assert f"sc-worker-s{i}-0.sc-workers:8476" in payload
        assert "rsplit('-', 1)[1]" in payload
        assert "coordinator=coord" in payload
        assert "device='cuda'" in payload
    svc = by_kind[("Service", "sc-workers")]
    assert svc["spec"]["clusterIP"] == "None"
    toml = by_kind[("ConfigMap", "sc-config")]["data"]["scanner_tpu.toml"]
    assert 'type = "gcs"' in toml
    with pytest.raises(ScannerException, match="StatefulSet per worker"):
        from scanner_tpu_torch.deploy import worker_manifest
        worker_manifest(cfg)


def test_deploy_metrics_port_wiring():
    def manifests(port):
        return _by_kind(ClusterConfig(id="sc", num_workers=2,
                                      worker=MachineType(**H100_8),
                                      metrics_port=port))

    on = manifests(9090)
    mc = on[("Deployment", "sc-master")]["spec"]["template"]["spec"][
        "containers"][0]
    _check_program(mc["command"][2])
    assert "metrics_port=9090" in mc["command"][2]
    assert {"containerPort": 9090, "name": "metrics"} in mc["ports"]
    wc = on[("StatefulSet", "sc-worker")]["spec"]["template"]["spec"][
        "containers"][0]
    _check_program(wc["command"][2])
    assert "metrics_port=9090" in wc["command"][2]
    assert {"containerPort": 9090, "name": "metrics"} in wc["ports"]
    assert "advertise_host=os.environ['POD_NAME'] + '.sc-workers'" \
        in wc["command"][2]
    assert wc["readinessProbe"]["httpGet"] == {"path": "/readyz",
                                               "port": 9090}
    assert "metrics_port = 9090" in on[("ConfigMap", "sc-config")][
        "data"]["scanner_tpu.toml"]

    off = manifests(0)
    mc = off[("Deployment", "sc-master")]["spec"]["template"]["spec"][
        "containers"][0]
    assert "metrics_port" not in mc["command"][2]
    wc = off[("StatefulSet", "sc-worker")]["spec"]["template"]["spec"][
        "containers"][0]
    assert "metrics_port" not in wc["command"][2]
    assert "ports" not in wc and "livenessProbe" not in wc


def test_deploy_compilation_cache_wiring():
    """compilation_cache_dir is accepted and unused: the port's Worker
    ignores it, so no manifest carries it ([perf] section, env var or
    program), whatever its value."""
    def manifests(cache):
        return _by_kind(ClusterConfig(id="sc", num_workers=2,
                                      worker=MachineType(**H100_8),
                                      compilation_cache_dir=cache))

    on, off = manifests("gs://bkt/xla-cache"), manifests("")
    assert on == off
    toml = on[("ConfigMap", "sc-config")]["data"]["scanner_tpu.toml"]
    assert "[perf]" not in toml and "compilation_cache" not in toml
    wc = on[("StatefulSet", "sc-worker")]["spec"]["template"]["spec"][
        "containers"][0]
    assert not any("COMPILATION" in e["name"] for e in wc["env"])
    assert "xla-cache" not in Cluster(
        CloudConfig(project="p"),
        ClusterConfig(id="sc", num_workers=2, worker=MachineType(**H100_8),
                      compilation_cache_dir="gs://bkt/xla-cache")
    ).manifests_json()


def test_deploy_gcloud_commands():
    cfg = ClusterConfig(id="sc", num_workers=2,
                        worker=MachineType(**MEGA_2, spot=True),
                        autoscale=True)
    cluster = Cluster(CloudConfig(project="proj", zone="us-east5-a"), cfg)
    cmds = cluster.create_commands()
    assert cmds[0][:3] == ["gcloud", "container", "--project"]
    # multi-host + autoscale: one pool PER candidate group (autoscale
    # cap = 2x num_workers), each 0..hosts nodes
    pools = cmds[1:]
    assert len(pools) == 4
    for i, pool in enumerate(pools):
        assert "node-pools" in pool and "--spot" in pool
        assert pool[pool.index("create") + 1] == f"sc-gpu-{i}"
        assert "--enable-autoscaling" in pool
        want_nodes = "2" if i < 2 else "0"
        assert pool[pool.index("--num-nodes") + 1] == want_nodes
        assert pool[pool.index("--machine-type") + 1] == "a3-megagpu-8g"
        assert pool[pool.index("--accelerator") + 1] == \
            "type=nvidia-h100-mega-80gb,count=8,gpu-driver-version=latest"
        assert pool[pool.index("--max-nodes") + 1] == "2"
    # autoscale: pools pre-exist and follow their pods
    assert cluster_resize_commands(cluster.cloud, cfg, 3) == []
    # non-autoscale multi-host: group-granular pool create/delete
    cfg2 = ClusterConfig(id="sc", num_workers=2,
                         worker=MachineType(**MEGA_2))
    grow = cluster_resize_commands(cluster.cloud, cfg2, 3)
    assert len(grow) == 1 and "sc-gpu-2" in grow[0] \
        and "--accelerator" in grow[0]
    shrink = cluster_resize_commands(cluster.cloud, cfg2, 1)
    assert len(shrink) == 1 and "delete" in shrink[0] \
        and "sc-gpu-1" in shrink[0]
    # single host: one shared pool, resized in place
    cfg3 = ClusterConfig(id="sc", num_workers=2,
                         worker=MachineType(**H100_8))
    (pool,) = cluster_create_commands_of(cfg3)[1:]
    assert pool[pool.index("create") + 1] == "sc-gpu"
    assert pool[pool.index("--machine-type") + 1] == "a3-highgpu-8g"
    (resize,) = cluster_resize_commands(cluster.cloud, cfg3, 5)
    assert resize[resize.index("--node-pool") + 1] == "sc-gpu"
    assert resize[resize.index("--num-nodes") + 1] == "5"
    dele = cluster.delete_commands()[0]
    assert "delete" in dele and "sc" in dele


def cluster_create_commands_of(cfg):
    from scanner_tpu_torch.deploy import cluster_create_commands
    return cluster_create_commands(CloudConfig(project="p"), cfg)


@pytest.mark.parametrize("gpus,want", [(1, "a3-highgpu-1g"),
                                       (2, "a3-highgpu-2g"),
                                       (4, "a3-highgpu-4g"),
                                       (8, "a3-highgpu-8g")])
def test_machine_types_and_prices(gpus, want):
    m = MachineType(gpus=gpus)
    assert m.machine_type() == want
    assert m.price_per_hour() > 0
    assert MachineType(gpus=gpus, spot=True).price_per_hour() \
        < m.price_per_hour()
    assert MachineType(gpus=gpus, hosts=2).price_per_hour() \
        == pytest.approx(2 * m.price_per_hour())
    with pytest.raises(ScannerException, match="GPU_MACHINE_TYPES"):
        MachineType(accelerator="nvidia-h100-mega-80gb",
                    gpus=gpus if gpus != 8 else 3).machine_type()


def test_cluster_config_fields_follow_the_jax_package():
    """Every field of the JAX ClusterConfig, in the same order (the
    worker's machine type aside, which names cards, not a slice)."""
    from dataclasses import fields
    assert [f.name for f in fields(ClusterConfig)] == \
        [f.name for f in fields(jdeploy.ClusterConfig)]


def _strip_worker(m):
    """A worker StatefulSet with its accelerator parts and programs
    taken out (node selector, resources, the /dev/shm mount, the -c
    program)."""
    m = copy.deepcopy(m)
    pod = m["spec"]["template"]["spec"]
    del pod["nodeSelector"]
    pod["volumes"] = [v for v in pod["volumes"] if v["name"] != "dshm"]
    c = pod["containers"][0]
    del c["resources"], c["command"], c["image"]
    c["volumeMounts"] = [v for v in c["volumeMounts"]
                         if v["name"] != "dshm"]
    return m


@pytest.mark.parametrize("kw", [
    {}, {"metrics_port": 9090}, {"db_path": "gs://bkt/db"},
    {"alert_rules": "x = value(a) > 1", "remediation_dry_run": True},
    {"gang": False}, {"gang_sharded": False, "pipeline_instances": 1,
                      "termination_grace_period": 30, "log_level": "debug"},
    {"autoscale": True, "max_workers": 5}])
@pytest.mark.parametrize("multihost", [False, True])
def test_manifests_match_the_jax_package(kw, multihost):
    tpu = "v5litepod-8" if multihost else "v5litepod-4"
    gpu = MEGA_2 if multihost else H100_8
    mine = _by_kind(ClusterConfig(id="sc", num_workers=3,
                                  worker=MachineType(**gpu), **kw))
    ref = {(m["kind"], m["metadata"]["name"]): m for m in jdeploy.Cluster(
        jdeploy.CloudConfig(project="p"),
        jdeploy.ClusterConfig(id="sc", num_workers=3,
                              worker=jdeploy.MachineType(tpu_type=tpu),
                              **kw)).manifests()}
    assert set(mine) == set(ref)
    for key in ref:
        a, b = mine[key], ref[key]
        if key[0] == "StatefulSet":
            sa, sb = _strip_worker(a), _strip_worker(b)
            assert sa == sb, key
            pa = a["spec"]["template"]["spec"]["containers"][0][
                "command"][2]
            pb = b["spec"]["template"]["spec"]["containers"][0][
                "command"][2]
            _check_program(pa)
            # the same program with the port's package, on its cards
            assert pa == pb.replace("scanner_tpu.", "scanner_tpu_torch.") \
                .replace("block=True)", "device='cuda', block=True)")
        elif key[0] == "Deployment":
            ca = a["spec"]["template"]["spec"]["containers"][0]
            cb = b["spec"]["template"]["spec"]["containers"][0]
            _check_program(ca["command"][2])
            assert ca["command"][2] == cb["command"][2].replace(
                "scanner_tpu.", "scanner_tpu_torch.")
            a, b = copy.deepcopy(a), copy.deepcopy(b)
            for m in (a, b):
                c = m["spec"]["template"]["spec"]["containers"][0]
                del c["command"], c["image"]
            assert a == b
        else:   # the ConfigMap and both Services: the same
            assert a == b, key
