"""Decode engines of the port: batched greedy, beam search and ancestral
sampling (temperature, top-k, top-p) on the device, forced-prefix priming,
constrained (must-include) beam search, diverse beam search (grouped beams
with a Hamming penalty), the product-of-experts ``EnsembleDecoder``, MBR
(consensus) reranking of candidate pools on the host, the continuous
(slot-recycling) greedy and beam engines of the online server, and the
ids -> caption join."""

from tpucap_torch.decode.beam import BeamResult, beam_decode, normalized_scores
from tpucap_torch.decode.constrained import (
    MAX_CONSTRAINTS,
    ConstrainedBeamResult,
    constrained_beam_decode,
)
from tpucap_torch.decode.continuous import ContinuousDecodeEngine, SlotState
from tpucap_torch.decode.continuous_beam import BeamSlotState, ContinuousBeamEngine
from tpucap_torch.decode.diverse import DiverseBeamResult, diverse_beam_decode
from tpucap_torch.decode.ensemble import EnsembleDecoder
from tpucap_torch.decode.greedy import DecodeResult, greedy_decode
from tpucap_torch.decode.mbr import mbr_select
from tpucap_torch.decode.prefix import prime_prefix
from tpucap_torch.decode.sample import sample_decode
from tpucap_torch.decode.text import ids_to_captions

__all__ = [
    "BeamResult",
    "BeamSlotState",
    "ConstrainedBeamResult",
    "ContinuousBeamEngine",
    "ContinuousDecodeEngine",
    "DecodeResult",
    "DiverseBeamResult",
    "EnsembleDecoder",
    "MAX_CONSTRAINTS",
    "SlotState",
    "beam_decode",
    "constrained_beam_decode",
    "diverse_beam_decode",
    "greedy_decode",
    "ids_to_captions",
    "mbr_select",
    "normalized_scores",
    "prime_prefix",
    "sample_decode",
]
