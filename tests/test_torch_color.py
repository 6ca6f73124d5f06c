"""YUV420 -> RGB: the port's torch flavor on CPU tensors against the JAX
package's device (jnp) and host (numpy) flavors, bit-exact at the odd
geometries of tests/test_yuv_wire.py."""

import numpy as np
import pytest
import torch

from scanner_tpu.kernels import color as jcolor
from scanner_tpu.video.lib import yuv420_frame_bytes

from scanner_tpu_torch.kernels import color as tcolor


@pytest.mark.parametrize("h,w", [(96, 128), (97, 129), (33, 31), (1, 1)])
def test_yuv420_bit_exact_against_jax(h, w):
    rng = np.random.RandomState(h * 1000 + w)
    flat = rng.randint(0, 256, (3, yuv420_frame_bytes(h, w))).astype(
        np.uint8)
    jhost = jcolor.yuv420_to_rgb_host(flat, h, w)
    jdev = np.asarray(jcolor.yuv420_to_rgb_device(flat, h, w))
    got = tcolor.yuv420_to_rgb_device(torch.from_numpy(flat), h, w)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (3, h, w, 3)
    np.testing.assert_array_equal(got.numpy(), jhost)
    np.testing.assert_array_equal(got.numpy(), jdev)
    np.testing.assert_array_equal(tcolor.yuv420_to_rgb_host(flat, h, w),
                                  jhost)
