"""The CUDA histogram kernel against its plain version, bit for bit, on
the card.  Marked `cuda`: it needs an NVIDIA card with nvcc (sm_90a) and
skips elsewhere.  Run on the card with

    python -m pytest tests/test_torch_cuda.py -q
"""

import pytest
import torch

from scanner_tpu_torch.kernels import color, cuda_ops

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode; its "
                    "plain version is tested on the CPU)")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(16, 480, 640, 3), (3, 97, 131, 3),
                                   (1, 1, 1, 3), (2, 5, 7, 1),
                                   (4, 33, 41, 4)])
def test_frames_kernel_bit_exact(card, shape):
    g = torch.Generator().manual_seed(sum(shape))
    f = torch.randint(0, 256, shape, generator=g, dtype=torch.uint8)
    want = cuda_ops.histogram_frames_plain(f)
    before = cuda_ops.histogram_launches
    got = cuda_ops.histogram_frames(f.to(card))
    torch.cuda.synchronize()
    assert cuda_ops.histogram_launches == before + 1
    assert torch.equal(got.cpu(), want)
    if shape[0] > 1:   # a view whose start is not 16-byte aligned
        got = cuda_ops.histogram_frames(f.to(card)[1:])
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want[1:])


def test_flat_frames_kernel_bit_exact(card):
    f = torch.full((16, 480, 640, 3), 200, dtype=torch.uint8)
    got = cuda_ops.histogram_frames(f.to(card))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), cuda_ops.histogram_frames_plain(f))


@pytest.mark.parametrize("rows,pix,bins", [(5, 1000, 16), (3, 7, 4),
                                           (48, 30001, 16), (2, 50, 128)])
def test_ids_kernel_bit_exact(card, rows, pix, bins):
    g = torch.Generator().manual_seed(rows + pix)
    v = torch.randint(-2, bins + 3, (rows, pix), generator=g,
                      dtype=torch.int32)
    got = cuda_ops.histogram_ids(v.to(card), bins)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), cuda_ops.histogram_ids_plain(v, bins))


def test_wrapper_raises_on_non_contiguous(card):
    f = torch.zeros((2, 8, 8, 3), dtype=torch.uint8, device=card)
    with pytest.raises(ValueError):
        cuda_ops.histogram_frames(f.transpose(1, 2))


def test_color_on_card_bit_exact(card):
    import numpy as np
    h, w = 97, 129
    n = h * w + 2 * ((h + 1) // 2) * ((w + 1) // 2)
    flat = np.random.RandomState(0).randint(0, 256, (3, n)).astype(np.uint8)
    got = color.yuv420_to_rgb_device(torch.from_numpy(flat).to(card), h, w)
    assert (got.cpu().numpy() == color.yuv420_to_rgb_host(flat, h, w)).all()
