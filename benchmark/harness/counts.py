"""Bytes of the measured work, from shapes alone, so the
yardstick stays the same whatever implements the work."""

from __future__ import annotations


def histogram_bytes_per_frame(height: int, width: int, channels: int,
                              bins: int) -> int:
    """Bytes a per-frame channel histogram must move: the uint8 frame
    read once and its (channels, bins) int32 counts written once."""
    return height * width * channels + channels * bins * 4
