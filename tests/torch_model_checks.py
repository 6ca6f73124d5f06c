"""Shared helpers of the port's tests (not a test module): seeded flax
parameters, the bf16 comparison bound, a run of an op through a Client
over a stored frame table, the fixture that stops the process health
engine, and the allocation ledger's leak guard.  The scoring of rows against ground truth or against another run
lives in the port (models/detect_train.py, models/seg_train.py), where
chip_smoke.py uses it too."""

import numpy as np
import pytest

from scanner_tpu_torch.models.detect_train import (  # noqa: F401
    boxes_agree, recall)
from scanner_tpu_torch.models.seg_train import (  # noqa: F401
    matched_mask_ious, segment_quality)


@pytest.fixture(autouse=True, scope="module")
def stop_process_engine():
    """Every port Client and pipeline starts the port's process health
    engine; a test module that imports this fixture stops the engine's
    sampling thread when the module ends, so it does not tick through
    later modules of the same worker (some of them timed)."""
    yield
    from scanner_tpu_torch.util import health
    if health._ENGINE is not None:
        health._ENGINE.stop()


@pytest.fixture()
def ledger_leak_guard():
    """Opt-in leak guard on the port's allocation ledger
    (util/memstats.py), as tests/conftest.py's is on the JAX package's:
    fail if entries registered during the test are still live after it.
    Release is finalizer-driven, so collect a few times before judging;
    kind=cache entries are the frame cache's resident pages, not leaks."""
    import gc

    from scanner_tpu_torch.util import memstats

    gc.collect()
    before = {e["id"] for e in memstats.entries()}
    yield memstats
    leaked = []
    for _ in range(4):
        gc.collect()
        leaked = [e for e in memstats.entries()
                  if e["id"] not in before and e["kind"] != "cache"]
        if not leaked:
            break
    assert not leaked, (
        f"engine left {len(leaked)} registered device buffer(s) in the "
        f"allocation ledger: {leaked[:5]}")


def random_params(module, x, seed):
    """A flax parameter tree for `module` on input `x`, filled from a
    seeded numpy generator: kernels N(0, 1 / fan_in), biases and norm
    offsets N(0, 0.1), norm scales 1 + N(0, 0.1).  The shapes come from
    jax.eval_shape, which compiles nothing (flax's own init compiles each
    initializer and takes seconds on the CPU)."""
    import jax   # the card's machine runs the card tests without jax
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.randn(*leaf.shape) / np.sqrt(fan_in)) \
                .astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.1 * rng.randn(*leaf.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def assert_close_bf16(got, want):
    """bfloat16 outputs of the two packages: |got - want| <= 2 % of the
    largest |want|.  bf16 keeps 8 significant bits, so one rounding moves
    a value by up to 2^-9 of itself, and a dozen layers that round at
    other places (summation order, fused casts) move outputs by a few
    ulps of the output's scale; each package's own bf16 error against
    its float32 run is 1.5 % of that scale on SSDDetector."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= 0.02 * float(np.abs(want).max()), err


def assert_matches(dtype, got, want):
    """float32 ("f32"): rtol 1e-4 / atol 1e-5, the same formulas summed in
    another order; bfloat16: assert_close_bf16."""
    if dtype == "f32":
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-4, atol=1e-5)
    else:
        assert_close_bf16(got, want)


def run_on_frames(client, pkg, table, frames, op, out, **kw):
    """Store `frames` as a pickled-frame table, run `op` over it through
    `client` and return the stored rows."""
    client.new_table(table, ["frame"], [[f] for f in frames],
                     overwrite=True, codecs={"frame": "pickle"})
    src = client.io.Input([pkg.NamedStream(client, table)])
    col = getattr(client.ops, op)(frame=src, **kw)
    client.run(client.io.Output(col, [pkg.NamedStream(client, out)]),
               pkg.PerfParams.manual(8, 16), show_progress=False,
               cache_mode=pkg.CacheMode.Overwrite)
    return list(pkg.NamedStream(client, out).load())
