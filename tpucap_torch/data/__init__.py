"""Data layer of the port: host JPEG decode and normalization
(``preprocess``), the prefetching batch loader (``pipeline``) and the
dataset readers (``flickr8k``)."""

from tpucap_torch.data.flickr8k import (
    load_coco_annotations,
    load_descriptions,
    load_descriptions_json,
    load_karpathy_json,
    load_split,
    prepare_descriptions,
)

__all__ = [
    "load_coco_annotations",
    "load_descriptions",
    "load_descriptions_json",
    "load_karpathy_json",
    "load_split",
    "prepare_descriptions",
]
