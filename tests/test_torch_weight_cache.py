"""models/weight_cache.py: one copy of a model op's weights per process,
device and dtype, keyed by the weight file or the seed."""

import os

import numpy as np
import pytest
import torch

from scanner_tpu_torch.models import weight_cache


class Builds:
    """A build function that records the paths it was given."""

    def __init__(self):
        self.paths = []

    def __call__(self, path):
        self.paths.append(path)
        return object()


@pytest.fixture
def npz(tmp_path):
    d = tmp_path / "ckpt"
    d.mkdir()
    path = d / "w.npz"
    np.savez(path, a=np.zeros(3, np.float32))
    return str(path)


@pytest.mark.parametrize("name", ["file", "directory"])
def test_a_file_is_built_once_and_named_to_build(npz, name):
    build = Builds()
    arg = npz if name == "file" else os.path.dirname(npz)
    op = f"op-{name}"
    first = weight_cache.shared(op, arg, 0, "cpu", torch.bfloat16, build)
    again = weight_cache.shared(op, arg, 7, "cpu", torch.bfloat16, build)
    assert again is first
    assert build.paths == [os.path.realpath(npz)]


def test_seeds_dtypes_and_ops_are_kept_apart():
    build = Builds()
    a = weight_cache.shared("op-seed", None, 1, "cpu", torch.bfloat16, build)
    assert weight_cache.shared("op-seed", "", 1, "cpu", torch.bfloat16,
                               build) is a
    f32 = weight_cache.shared("op-seed", None, 1, "cpu", torch.float32, build)
    other = weight_cache.shared("op-other", None, 1, "cpu", torch.bfloat16,
                                build)
    assert len({id(a), id(f32), id(other)}) == 3
    assert build.paths == [None, None, None]
    # both dtypes and both ops are still kept
    assert weight_cache.shared("op-seed", None, 1, "cpu", torch.float32,
                               build) is f32
    assert weight_cache.shared("op-seed", None, 1, "cpu", torch.bfloat16,
                               build) is a
    assert len(build.paths) == 3


def test_another_source_replaces_the_kept_copy(npz):
    build = Builds()
    op = "op-replace"
    first = weight_cache.shared(op, None, 1, "cpu", torch.bfloat16, build)
    second = weight_cache.shared(op, None, 2, "cpu", torch.bfloat16, build)
    assert second is not first
    # seed 1 was replaced, not kept beside seed 2
    assert weight_cache.shared(op, None, 1, "cpu", torch.bfloat16,
                               build) is not first
    f = weight_cache.shared(op, npz, 0, "cpu", torch.bfloat16, build)
    # the same file rewritten is built anew
    st = os.stat(npz)
    os.utime(npz, ns=(st.st_atime_ns, st.st_mtime_ns + 10 ** 9))
    assert weight_cache.shared(op, npz, 0, "cpu", torch.bfloat16,
                               build) is not f
    assert build.paths == [None, None, None, os.path.realpath(npz),
                           os.path.realpath(npz)]
    assert sum(k[0] == op for k in weight_cache._CACHE) == 1


def test_a_failed_build_keeps_nothing(npz):
    def fails(path):
        raise KeyError("missing")

    build = Builds()
    op = "op-fail"
    weight_cache.shared(op, None, 1, "cpu", torch.bfloat16, build)
    with pytest.raises(KeyError):
        weight_cache.shared(op, npz, 0, "cpu", torch.bfloat16, fails)
    weight_cache.shared(op, npz, 0, "cpu", torch.bfloat16, build)
    assert build.paths == [None, os.path.realpath(npz)]


def test_a_directory_must_hold_one_npz(tmp_path):
    with pytest.raises(ValueError):
        weight_cache.shared("op-dir", str(tmp_path), 0, "cpu",
                            torch.bfloat16, Builds())
