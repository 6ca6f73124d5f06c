"""Sequence parallelism on torch.distributed.  Only ring attention is
ported so far (on one rank on the card; over several ranks on any
backend torch.distributed offers)."""

from .ring_attention import make_ring_attention, reference_attention

__all__ = ["make_ring_attention", "reference_attention"]
