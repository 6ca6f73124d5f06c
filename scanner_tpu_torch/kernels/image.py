"""Image encode/decode kernels.

Capability parity: reference util/image_encoder.cpp (lodepng/jpeg encode)
and the scannertools image ops.  PIL handles the codecs; these are host
(CPU) ops by nature, and frames that reach them are host arrays (the
engine fetches a device column once for a host op).
"""

from __future__ import annotations

import io

import numpy as np

from ..common import FrameType
from ..graph.ops import Kernel, register_op
from ..video.ingest import decode_image


@register_op()
class ImageEncode(Kernel):
    """frame -> encoded image bytes (png/jpeg/webp)."""

    def __init__(self, config, format: str = "png", quality: int = 90):
        super().__init__(config)
        self.format = format.upper()
        self.quality = int(quality)

    def execute(self, frame: FrameType) -> bytes:
        from PIL import Image
        img = Image.fromarray(np.asarray(frame))
        buf = io.BytesIO()
        kw = {"quality": self.quality} if self.format == "JPEG" else {}
        img.save(buf, format=self.format, **kw)
        return buf.getvalue()


@register_op()
class ImageDecode(Kernel):
    """encoded image bytes -> RGB frame."""

    def execute(self, data: bytes) -> FrameType:
        return decode_image(data)


@register_op()
class Grayscale(Kernel):
    """RGB frame -> single-channel-replicated grayscale frame (host op)."""

    def execute(self, frame: FrameType) -> FrameType:
        f = np.asarray(frame).astype(np.float32)
        g = (0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2])
        return np.repeat(g[..., None], 3, axis=-1).astype(np.uint8)
