"""The port stands alone: scanner_tpu_torch, its tools (tools/torch_*.py),
the chaos tool's spawn helpers (tests/torch_spawn_*.py) and
chip_smoke.py import neither jax nor the JAX package (scanner_tpu),
every relative import of
the port resolves inside it (the gang's parallel/ modules and its
member child included), and asking for a card that is not there raises
instead of carrying on on the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch
from torch_model_checks import stop_process_engine  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "scanner_tpu_torch")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    tools = os.path.join(REPO, "tools")
    out += [os.path.join(tools, f) for f in os.listdir(tools)
            if f.startswith("torch_") and f.endswith(".py")]
    here = os.path.join(REPO, "tests")
    out += [os.path.join(here, f) for f in os.listdir(here)
            if f.startswith("torch_spawn_") and f.endswith(".py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _module_exists(base_dir, dotted):
    path = os.path.join(base_dir, *dotted.split(".")) if dotted else base_dir
    return os.path.isfile(path + ".py") or os.path.isfile(
        os.path.join(path, "__init__.py"))


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(open(path).read(), path)
    here = os.path.dirname(path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif isinstance(node, ast.ImportFrom):
            base = here
            for _ in range(node.level - 1):
                base = os.path.dirname(base)
            assert os.path.commonpath([base, PKG]) == PKG, \
                f"{path}:{node.lineno} relative import leaves the port"
            mod = node.module or ""
            ok = _module_exists(base, mod) or all(
                _module_exists(base, f"{mod}.{a.name}".strip("."))
                for a in node.names)
            assert ok, f"{path}:{node.lineno} unresolved import {mod!r}"
            continue
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "orbax",
                               "scanner_tpu"), \
                f"{path}:{node.lineno} imports {name}"


PORTED_OPS = ["Blur", "CropResize", "FaceDetect", "FaceEmbedding",
              "Grayscale", "HistDiff", "Histogram", "HistogramDelta",
              "ImageDecode", "ImageEncode", "InstanceSegment",
              "ObjectDetect", "OpenPose", "OpticalFlow", "PoseDetect",
              "Resize", "SamEmbed", "ShotBoundary"]


def test_import_with_jax_blocked():
    """Every module of the port imports with jax and the JAX package
    absent, and importing the stdlib and the models registers every
    ported op."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['scanner_tpu'] = None; "
            "import scanner_tpu_torch, scanner_tpu_torch.kernels; "
            "import scanner_tpu_torch.kernels.cuda_ops; "
            "import scanner_tpu_torch.kernels.attention; "
            "import scanner_tpu_torch.kernels.image; "
            "import scanner_tpu_torch.parallel; "
            "import scanner_tpu_torch.models; "
            "import scanner_tpu_torch.models.pose_train; "
            "import scanner_tpu_torch.models.detect_train; "
            "import scanner_tpu_torch.models.seg_train; "
            "import scanner_tpu_torch.models.checkpoint; "
            "import scanner_tpu_torch.models.infer; "
            "from scanner_tpu_torch.graph.ops import registry; "
            "print(','.join(sorted(registry.names())))")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().split(",") == PORTED_OPS


CLUSTER_MODULES = ["util.retry", "util.clocksync", "config", "storage.gcs",
                   "storage.custom", "engine.rpc", "engine.journal",
                   "engine.shardmap", "engine.gang", "engine.service"]


def test_cluster_modules_import_with_jax_blocked():
    """The storage back ends and the cluster control plane import with
    jax and the JAX package absent."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['scanner_tpu'] = None; import importlib; "
            + "; ".join(f"importlib.import_module('scanner_tpu_torch.{m}')"
                        for m in CLUSTER_MODULES)
            + "; print(sorted(m for m in sys.modules "
              "if m.split('.')[0] in ('jax', 'scanner_tpu') "
              "and sys.modules[m] is not None))")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_analysis_and_spawn_helpers_import_with_jax_blocked():
    """The port's analysis suite and the chaos tool's spawn helpers
    import with jax and the JAX package absent (the analysis is pure
    `ast`, like the JAX package's, but the port keeps its own copy)."""
    code = ("import sys, runpy; sys.modules['jax'] = None; "
            "sys.modules['scanner_tpu'] = None; "
            "sys.path.insert(0, 'tests'); "
            "import scanner_tpu_torch.analysis.static, "
            "scanner_tpu_torch.analysis.model, torch_spawn_master, "
            "torch_spawn_worker; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'scanner_tpu') "
            "and sys.modules[m] is not None))")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


GANG_MODULES = ["parallel.distributed", "parallel.mesh", "parallel.halo",
                "engine.gang"]


def test_gang_modules_and_member_child_run_with_jax_blocked(tmp_path):
    """The gang's modules import with jax and the JAX package absent, and
    so does the member child `python -m scanner_tpu_torch.engine.gang`:
    run on a request whose rendezvous cannot complete, it reports the
    failure in its result file and exits 3."""
    import cloudpickle
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    req, res = str(tmp_path / "req.bin"), str(tmp_path / "res.bin")
    with open(req, "wb") as fh:
        fh.write(cloudpickle.dumps({
            "process_id": 1, "num_processes": 2, "gang_id": 0, "epoch": 1,
            "coordinator": f"127.0.0.1:{port}", "init_timeout": 1,
            "device": "cpu"}))
    code = ("import sys, runpy, importlib; sys.modules['jax'] = None; "
            "sys.modules['scanner_tpu'] = None; "
            + "; ".join(f"importlib.import_module('scanner_tpu_torch.{m}')"
                        for m in GANG_MODULES)
            + f"; sys.argv = ['gang', {req!r}, {res!r}]; "
              "runpy.run_module('scanner_tpu_torch.engine.gang', "
              "run_name='__main__')")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 3, r.stderr
    with open(res, "rb") as fh:
        out = cloudpickle.loads(fh.read())
    assert out["ok"] is False and out["stage"] == "rendezvous"


SHARDING_MODULES = ["parallel.collectives", "parallel.mesh",
                    "parallel.distributed", "parallel.halo", "parallel.pp",
                    "parallel.ulysses", "models.pose", "models.checkpoint"]


def test_sharding_modules_import_with_jax_blocked():
    """The in-program sharding modules (the pipeline, Ulysses, the
    differentiable collectives, the sharded train step and its
    checkpoints) import with jax and the JAX package absent."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['scanner_tpu'] = None; import importlib; "
            + "; ".join(f"importlib.import_module('scanner_tpu_torch.{m}')"
                        for m in SHARDING_MODULES)
            + "; from scanner_tpu_torch.parallel import ("
              "make_pipeline, make_ulysses_attention, sharded_stencil_map, "
              "temporal_diff, sharding, shard_batch, replicate_to_global); "
              "from scanner_tpu_torch.models.pose import ("
              "PipelinedTemporalStack, pp_params_to_plain, "
              "plain_params_to_pp, param_shardings, "
              "make_sharded_train_step); "
              "print(sorted(m for m in sys.modules "
              "if m.split('.')[0] in ('jax', 'scanner_tpu') "
              "and sys.modules[m] is not None))")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_make_mesh_defaults_to_the_cards(monkeypatch):
    """make_mesh lays out every CUDA card unless given devices; without
    a card it raises rather than laying out the CPU."""
    import scanner_tpu_torch as st
    from scanner_tpu_torch.parallel.mesh import make_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(st.ScannerException, match="no CUDA card"):
        make_mesh({"dp": 1})
    assert make_mesh({"dp": 2}, devices=["cpu", "cpu"]).shape == \
        {"dp": 2, "sp": 1, "tp": 1}


def test_cuda_client_raises_without_card(tmp_path, monkeypatch):
    import scanner_tpu_torch as st
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(st.ScannerException, match="no CUDA card"):
        st.Client(db_path=str(tmp_path / "db"))
    with pytest.raises(st.ScannerException, match="no CUDA card"):
        st.Client(db_path=str(tmp_path / "db"), device="cuda:0")
    st.Client(db_path=str(tmp_path / "db"), device="cpu")


def test_replicas_resolve_their_devices_as_a_client_does(monkeypatch):
    """DataParallelApply's devices go through resolve_device: "cuda"
    without a card raises the client's error, not whatever
    torch.cuda.current_device() does without one."""
    import scanner_tpu_torch as st
    from scanner_tpu_torch.models.infer import DataParallelApply
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in ("cuda", "cuda:0", torch.device("cuda")):
        with pytest.raises(st.ScannerException, match="no CUDA card"):
            DataParallelApply(torch.nn.Linear(2, 2), [dev])
    dp = DataParallelApply(torch.nn.Linear(2, 2), ["cpu", "cpu"])
    assert dp.devices == [torch.device("cpu")] * 2


def test_kernel_wrapper_refuses_other_devices():
    from scanner_tpu_torch.kernels import cuda_ops
    x = torch.zeros((1, 2, 2, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no histogram kernel"):
        cuda_ops.histogram_frames(x)


def test_pose_entry_points_raise_without_card(monkeypatch, tmp_path):
    """init_params and the train loops default to the card and raise
    without one, before they write a checkpoint; PoseDetect runs on the
    device the engine hands it."""
    import scanner_tpu_torch as st
    from scanner_tpu_torch.models import detect_train, pose, pose_train
    from scanner_tpu_torch.models import seg_train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(st.ScannerException, match="no CUDA card"):
        pose.init_params(0, width=8)
    ckpt = str(tmp_path / "ckpt")
    for train in (pose_train.train_pose, detect_train.train_detector,
                  detect_train.train_embedding, seg_train.train_segmenter):
        with pytest.raises(st.ScannerException, match="no CUDA card"):
            train(ckpt, steps=1)
    assert not os.path.exists(ckpt)
    m = pose.init_params(0, device="cpu", width=8)
    assert next(m.parameters()).device.type == "cpu"
