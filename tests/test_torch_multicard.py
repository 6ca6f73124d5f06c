"""Several cards, held on the CPU: DataParallelApply over replicas, the
evaluator's card partitions and Worker(coordinator=).

  * DataParallelApply over ["cpu"] * 4 against the JAX package's over 4
    of the conftest's virtual CPU devices, on the same seeded numpy
    weights and batches of 8 and 13 rows (13 pads to 16): every output
    leaf at rtol 1e-5, atol 1e-6 (float32 matrix products and tanh on
    both sides);
  * every model op of the port over three CPU replicas against one, on
    an uneven batch of seven 64 x 64 frames: the same rows (each frame
    runs the same operations on one replica or another);
  * instance_devices / assigned_device against the JAX mapping for 1, 2,
    3 and 5 instances over four cards (torch.cuda.device_count patched:
    the partition is pure index arithmetic);
  * a TaskEvaluator(devices=[...]) hands the list to its device model
    kernel and nothing to a kernel pinned to the CPU;
  * two Worker(device="cpu", coordinator=CoordinatorConfig(..., 2, r))
    processes (tests/torch_coord_worker.py) join one gloo group for
    their lifetime, serve config 1 from one master with the local run's
    rows, leave the group and exit.
"""

import json
import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from scanner_tpu.engine import evaluate as jev
from scanner_tpu.models.infer import DataParallelApply as JaxDataParallel

import scanner_tpu_torch as st
import scanner_tpu_torch.kernels  # noqa: F401
import scanner_tpu_torch.models  # noqa: F401
from scanner_tpu_torch import models as tmodels
from scanner_tpu_torch.common import DeviceType
from scanner_tpu_torch.engine import evaluate as tev
from scanner_tpu_torch.engine import service as tservice
from scanner_tpu_torch.graph import analysis as TA
from scanner_tpu_torch.graph.ops import KernelConfig
from scanner_tpu_torch.models.infer import DataParallelApply
from scanner_tpu_torch.storage import Database, PosixStorage
from scanner_tpu_torch.util.profiler import Profiler
from torch_model_checks import stop_process_engine  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
DP_TOL = dict(rtol=1e-5, atol=1e-6)
CPU = torch.device("cpu")


def _weights():
    rng = np.random.RandomState(0)
    return {"w1": rng.randn(6, 16).astype(np.float32) * 0.4,
            "b1": rng.randn(16).astype(np.float32) * 0.1,
            "w2": rng.randn(16, 3).astype(np.float32) * 0.4,
            "b2": rng.randn(3).astype(np.float32) * 0.1}


def _jax_apply(p, x):
    h = jnp.tanh(x @ p["w1"] + p["b1"])
    return {"y": h @ p["w2"] + p["b2"],
            "aux": (jnp.sum(h * h, axis=1), h[:, :2])}


class _TorchMLP(nn.Module):
    def __init__(self, p):
        super().__init__()
        for k, v in p.items():
            setattr(self, k, nn.Parameter(torch.from_numpy(v)))

    def forward(self, x):
        h = torch.tanh(x @ self.w1 + self.b1)
        return {"y": h @ self.w2 + self.b2,
                "aux": ((h * h).sum(dim=1), h[:, :2])}


@pytest.mark.parametrize("rows", [8, 13])
def test_data_parallel_apply_matches_jax_over_four_devices(rows):
    p = _weights()
    x = np.random.RandomState(rows).randn(rows, 6).astype(np.float32)
    jdp = JaxDataParallel(jax.jit(_jax_apply),
                          {k: jnp.asarray(v) for k, v in p.items()},
                          jax.devices()[:4])
    assert jdp._mesh is not None
    want = jdp(x)
    dp = DataParallelApply(_TorchMLP(p), ["cpu"] * 4)
    assert len({id(m) for m in dp.replicas}) == 4
    got = dp(x)
    for g, w in [(got["y"], want["y"]), (got["aux"][0], want["aux"][0]),
                 (got["aux"][1], want["aux"][1])]:
        assert isinstance(g, np.ndarray) and g.shape == w.shape
        assert g.shape[0] == rows
        np.testing.assert_allclose(g, np.asarray(w), **DP_TOL)
    # a tensor batch stays a tensor on the first device, same values
    t = dp(torch.from_numpy(x))
    assert t["y"].device == CPU
    np.testing.assert_array_equal(t["y"].numpy(), got["y"])
    # the FLOP probe counts the whole batch on one replica
    one = DataParallelApply(_TorchMLP(p), ["cpu"])
    assert dp.cost_flops(x) == one.cost_flops(x) == \
        2 * rows * (6 * 16 + 16 * 3)


def _scenes(n=7):
    from scanner_tpu_torch.models import detect_train as dt
    rng = np.random.RandomState(41)
    return np.stack([dt.render_rect_scene(rng)[0] for _ in range(n)])


@pytest.mark.parametrize("op", ["ObjectDetect", "FaceDetect",
                                "FaceEmbedding", "InstanceSegment",
                                "PoseDetect"])
def test_model_ops_over_replicas_match_one_device(op):
    """Replication carries every model op's state (weights, the anchor
    and ROI paths built per device): three replicas on an uneven batch
    give one device's rows, host and tensor batches alike."""
    frames = _scenes()

    def build(devices):
        return getattr(tmodels, op)(
            KernelConfig(device=DeviceType.TPU, devices=devices), width=8)
    one, three = build([CPU]), build([CPU] * 3)
    assert len(three._dp.replicas) == 3
    want = one.execute(frames)
    got = three.execute(frames)
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    on_dev = three.execute(torch.from_numpy(frames))
    assert isinstance(on_dev, torch.Tensor)
    np.testing.assert_array_equal(on_dev.numpy(), want)


@pytest.mark.parametrize("instances", [1, 2, 3, 5])
def test_instance_partitions_match_jax(instances, monkeypatch):
    jdevs = jax.devices()[:4]
    monkeypatch.setattr(jev, "kernel_devices", lambda: list(jdevs))
    monkeypatch.delenv("SCANNER_TPU_DEVICE_AFFINITY", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    card = torch.device("cuda", 0)
    assert [d.index for d in tev.kernel_devices(card)] == [0, 1, 2, 3]
    for i in range(instances):
        want = [d.id for d in jev.instance_devices(i, instances)]
        got = [d.index for d in tev.instance_devices(card, i, instances)]
        assert got == want
        assert tev.assigned_device(card, i).index \
            == jev.assigned_device(i).id == got[0]
    # a client on another card starts its cards there
    assert [d.index for d in tev.instance_devices(
        torch.device("cuda", 2), 0, 1)] == [2, 3, 0, 1]
    assert tev.instance_devices(CPU, 0, instances) == [CPU]


class _Stream:
    is_video = False

    def __init__(self, n):
        self.n = n


def test_task_evaluator_hands_model_kernels_its_devices():
    from scanner_tpu_torch.graph.ops import OpGenerator
    from scanner_tpu_torch.graph.streams_dsl import IOGenerator
    io, ops = IOGenerator(), OpGenerator()
    src = io.Input([_Stream(8)])
    dev_pose = ops.PoseDetect(frame=src, width=8)
    host_pose = ops.PoseDetect(frame=src, width=8, device=DeviceType.CPU)
    info = TA.analyze([io.Output(dev_pose, [_Stream(0)]),
                       io.Output(host_pose, [_Stream(0)])])

    def seen(te):
        return sorted((ki.node.effective_device().name,
                       tuple(str(d) for d in ki.kernel.config.devices),
                       tuple(str(d) for d in ki.kernel._dp.devices))
                      for ki in te.kernels.values())
    te = tev.TaskEvaluator(info, Profiler(), CPU, devices=[CPU] * 3)
    try:
        assert seen(te) == [("CPU", (), ("cpu",)),
                            ("TPU", ("cpu",) * 3, ("cpu",) * 3)]
    finally:
        te.close()
    te = tev.TaskEvaluator(info, Profiler(), CPU, instance=1, instances=2)
    try:   # the default: this instance's partition of the host
        assert seen(te) == [("CPU", (), ("cpu",)),
                            ("TPU", ("cpu",), ("cpu",))]
    finally:
        te.close()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _config1(client, out):
    src = client.io.Input([st.NamedStream(client, "frames")])
    client.run(client.io.Output(client.ops.Histogram(frame=src),
                                [st.NamedStream(client, out)]),
               st.PerfParams.manual(4, 8), show_progress=False,
               cache_mode=st.CacheMode.Overwrite)
    return np.stack(list(st.NamedStream(client, out).load()))


def test_two_coordinator_workers_serve_config1(tmp_path):
    frames = np.random.RandomState(5).randint(
        0, 256, (24, 48, 64, 3)).astype(np.uint8)
    local = st.Client(db_path=str(tmp_path / "local"), device="cpu")
    try:
        local.new_table("frames", ["frame"], [[f] for f in frames],
                        codecs={"frame": "pickle"})
        want = _config1(local, "hist")
    finally:
        local.stop()
    db = str(tmp_path / "cluster")
    Database(PosixStorage(db)).new_table(
        "frames", ["frame"], [[f] for f in frames],
        codecs={"frame": "pickle"})
    master = tservice.Master(db_path=db, no_workers_timeout=60.0)
    addr = f"localhost:{master.port}"
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    kids = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_coord_worker.py"), addr,
         db, coord, str(r), "2", str(tmp_path / f"w{r}.json")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    client = st.Client(db_path=db, master=addr)
    logs = ["", ""]
    try:
        deadline = time.time() + 90
        while client.job_status()["num_workers"] < 2:
            assert time.time() < deadline \
                and all(k.poll() is None for k in kids), \
                [k.poll() for k in kids]
            time.sleep(0.1)
        got = _config1(client, "hist")
        assert client.shutdown_cluster() == 2
        logs = [k.communicate(timeout=60)[0] for k in kids]
    finally:
        client.stop()
        for k in kids:
            if k.poll() is None:
                k.kill()
                k.communicate()
        master.stop()
    np.testing.assert_array_equal(got, want)
    for r, k in enumerate(kids):
        assert k.returncode == 0, logs[r][-3000:]
        with open(tmp_path / f"w{r}.json") as fh:
            info = json.load(fh)
        assert info["join_s"] > 0
        del info["join_s"]
        assert info == {"backend": "gloo", "world_size": 2, "rank": r,
                        "left_group": True}
