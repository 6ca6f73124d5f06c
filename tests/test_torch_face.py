"""The face embedding (EmbeddingNet, FaceEmbedding): the port against the
JAX package on the CPU, on the same parameters and seeded numpy inputs.

Tolerances:
  * float32: embeddings within rtol 1e-4 / atol 1e-5;
  * bfloat16 (the op's dtype): cosine >= 0.99 between the two packages'
    embeddings of the same crop, the bound `chip_smoke.py` holds the card
    to against the CPU.  The pooled feature is rounded to bf16 after a
    float32 mean, as jnp.mean of a bf16 array does;
  * shipped weights through Client(device="cpu"): recall@1 >= 0.75 over
    8 identities, the bound of tests/test_models.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanner_tpu.common import DeviceType
from scanner_tpu.graph.ops import KernelConfig as JConfig
from scanner_tpu.models import face as jface

import scanner_tpu_torch as st
import scanner_tpu_torch.models  # noqa: F401
from scanner_tpu_torch.graph.ops import KernelConfig as TConfig
from scanner_tpu_torch.models import detect_train as tdata
from scanner_tpu_torch.models import face as tface
from scanner_tpu_torch.models.convert import (load_params, shipped_weights,
                                              torch_state)

from torch_model_checks import (random_params, run_on_frames,
                                stop_process_engine)  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _identities(seed):
    """(gallery, probe): two views of each of 8 identities."""
    rng = np.random.RandomState(seed)
    gallery = np.stack([tdata.render_identity(i, rng) for i in range(8)])
    probe = np.stack([tdata.render_identity(i, rng) for i in range(8)])
    return gallery, probe


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_embedding_net_matches_flax(dtype):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    x = np.random.RandomState(4).randint(0, 256, (3, 64, 64, 3)) \
        .astype(np.uint8)
    jm = jface.EmbeddingNet(width=8, dtype=jdt)
    params = random_params(jm, jnp.asarray(x), 2)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = load_params(tface.EmbeddingNet(width=8, dtype=tdt),
                     jax.tree_util.tree_map(np.asarray, params))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (3, 128)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    else:
        assert (got * want).sum(axis=1).min() >= 0.99
    # a frame of zeros embeds to a finite vector, never 0/0
    with torch.no_grad():
        z = tm(torch.zeros((1, 64, 64, 3), dtype=torch.uint8))
    assert torch.isfinite(z).all()


def test_shipped_weights_load_whole():
    flat = dict(np.load(shipped_weights("embed_w8.npz")))
    state = torch_state(flat, tface.EmbeddingNet(width=8))
    assert len(state) == len(flat) == 58


def test_op_matches_jax_on_shipped_weights():
    gallery, probe = _identities(7)
    frames = np.concatenate([gallery, probe])
    want = np.asarray(jface.FaceEmbedding(JConfig(device=DeviceType.CPU),
                                          width=8).execute(frames))
    got = tface.FaceEmbedding(TConfig(device=DeviceType.CPU),
                              width=8).execute(frames)
    assert isinstance(got, np.ndarray) and got.shape == want.shape \
        == (16, 128)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)
    assert (got * want).sum(axis=1).min() >= 0.99


def test_shipped_weights_recall_through_client(tmp_path):
    """The shipped embedding separates identities: each probe view's
    nearest gallery view is its own identity's (recall@1 >= 0.75,
    chance 1/8)."""
    gallery, probe = _identities(99)
    sc = st.Client(db_path=str(tmp_path / "db"), device="cpu")
    try:
        rows = run_on_frames(sc, st, "views",
                             np.concatenate([gallery, probe]),
                             "FaceEmbedding", "emb", width=8)
    finally:
        sc.stop()
    emb = np.stack(rows)
    assert emb.shape == (16, 128) and emb.dtype == np.float32
    pred = (emb[8:] @ emb[:8].T).argmax(axis=1)
    recall = float((pred == np.arange(8)).mean())
    assert recall >= 0.75, f"recall@1 {recall:.2f}"


# FLOPs of one call (the MFU probe): the port counts with
# torch.utils.flop_counter (convolutions and matrix products, 2 per
# multiply-add); the JAX package asks XLA's cost analysis, which also
# counts elementwise work (activations, casts, the decode) but folds
# some of it away.  On 2 frames of 64 x 64 at width 8 the two read
# within 2 % of each other (measured on the CPU: ObjectDetect and
# FaceDetect 1.0198, FaceEmbedding 0.9853, InstanceSegment 1.0016), so
# the bound is 5 %.
FLOPS_RATIO_BOUND = 0.05


def test_infer_cost_flops_match_jax():
    frames = np.random.RandomState(6).randint(0, 256, (2, 64, 64, 3)) \
        .astype(np.uint8)
    want = jface.FaceEmbedding(JConfig(device=DeviceType.CPU),
                               width=8).infer_cost_flops(frames)
    got = tface.FaceEmbedding(TConfig(device=DeviceType.CPU),
                              width=8).infer_cost_flops(frames)
    assert want and got
    assert abs(got / want - 1.0) <= FLOPS_RATIO_BOUND
