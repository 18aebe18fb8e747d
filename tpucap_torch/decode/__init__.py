"""Decode engines of the port: batched greedy and beam search on the
device, and the ids -> caption join."""

from tpucap_torch.decode.beam import BeamResult, beam_decode, normalized_scores
from tpucap_torch.decode.greedy import DecodeResult, greedy_decode
from tpucap_torch.decode.text import ids_to_captions

__all__ = [
    "BeamResult",
    "DecodeResult",
    "beam_decode",
    "greedy_decode",
    "ids_to_captions",
    "normalized_scores",
]
