"""The port stands alone: scanner_tpu_torch and chip_smoke.py import
neither jax nor the JAX package (scanner_tpu), every relative import of
the port resolves inside it, and asking for a card that is not there
raises instead of carrying on on the CPU."""

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
            assert top not in ("jax", "jaxlib", "flax", "optax",
                               "scanner_tpu"), \
                f"{path}:{node.lineno} imports {name}"


PORTED_OPS = ["Blur", "CropResize", "FaceDetect", "FaceEmbedding",
              "Grayscale", "HistDiff", "Histogram", "HistogramDelta",
              "ImageDecode", "ImageEncode", "InstanceSegment",
              "ObjectDetect", "OpticalFlow", "PoseDetect", "Resize",
              "ShotBoundary"]


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


def test_cuda_client_raises_without_card(tmp_path, monkeypatch):
    import scanner_tpu_torch as st
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(st.ScannerException, match="no CUDA card"):
        st.Client(db_path=str(tmp_path / "db"))
    with pytest.raises(st.ScannerException, match="no CUDA card"):
        st.Client(db_path=str(tmp_path / "db"), device="cuda:0")
    st.Client(db_path=str(tmp_path / "db"), device="cpu")


def test_kernel_wrapper_refuses_other_devices():
    from scanner_tpu_torch.kernels import cuda_ops
    x = torch.zeros((1, 2, 2, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no histogram kernel"):
        cuda_ops.histogram_frames(x)


def test_pose_entry_points_raise_without_card(monkeypatch):
    """init_params and train_pose default to the card and raise without
    one; PoseDetect runs on the device the engine hands it."""
    import scanner_tpu_torch as st
    from scanner_tpu_torch.models import pose, pose_train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(st.ScannerException, match="no CUDA card"):
        pose.init_params(0, width=8)
    with pytest.raises(st.ScannerException, match="no CUDA card"):
        pose_train.train_pose(steps=1)
    m = pose.init_params(0, device="cpu", width=8)
    assert next(m.parameters()).device.type == "cpu"
