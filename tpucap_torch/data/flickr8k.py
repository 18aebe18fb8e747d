"""Dataset readers (port of ``tpucap.data.flickr8k``).

- ``Flickr8k.token.txt``: lines of ``<image>.jpg#<n>\\t<caption>``, 5
  captions an image (a line without a tab splits on whitespace);
- ``Flickr_8k.{train,dev,test}Images.txt``: one ``<image>.jpg`` a line;
- a ``{image_id: [captions]}`` JSON, a COCO captions annotation file, and a
  Karpathy ``dataset_*.json`` with its splits.

Image ids are the file name less its extension, as in the reference.
"""

from __future__ import annotations

import json

from tpucap_torch.text.clean import clean_descriptions, wrap_caption


def load_descriptions(token_file) -> dict[str, list[str]]:
    """Parse a Flickr8k token file -> {image_id: [raw captions]}."""
    out: dict[str, list[str]] = {}
    with open(token_file) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            tag, _, caption = line.partition("\t")
            if not caption:
                parts = line.split()
                tag, caption = parts[0], " ".join(parts[1:])
            image_id = tag.split("#")[0].rsplit(".", 1)[0]
            out.setdefault(image_id, []).append(caption)
    return out


def load_descriptions_json(path) -> dict[str, list[str]]:
    with open(path) as f:
        return {str(k): list(v) for k, v in json.load(f).items()}


def load_coco_annotations(path) -> dict[str, list[str]]:
    """A COCO captions annotation file ({"images": [{"id", "file_name"}],
    "annotations": [{"image_id", "caption"}]}) -> {file stem: [captions]};
    an annotation whose image is not listed keys on ``str(image_id)``."""
    with open(path) as f:
        payload = json.load(f)
    stems = {
        img["id"]: str(img["file_name"]).rsplit(".", 1)[0]
        for img in payload.get("images", [])
    }
    out: dict[str, list[str]] = {}
    for ann in payload.get("annotations", []):
        stem = stems.get(ann["image_id"], str(ann["image_id"]))
        out.setdefault(stem, []).append(ann["caption"])
    return out


def load_karpathy_json(
    path, *, restval_to_train: bool = True
) -> tuple[dict[str, list[str]], dict[str, list[str]]]:
    """A Karpathy ``dataset_{flickr8k,flickr30k,coco}.json`` -> ``(
    {stem: [raw captions]}, {"train"|"val"|"test"|...: [stems]})``. A
    sentence's text is its ``raw`` field, else its ``tokens`` joined; an
    image without a split is ``"train"``; COCO's ``restval`` folds into
    train unless ``restval_to_train=False``."""
    with open(path) as f:
        payload = json.load(f)
    desc: dict[str, list[str]] = {}
    splits: dict[str, list[str]] = {"train": [], "val": [], "test": []}
    for img in payload.get("images", []):
        stem = str(img["filename"]).rsplit(".", 1)[0]
        desc[stem] = [
            s["raw"] if s.get("raw") else " ".join(s.get("tokens", []))
            for s in img.get("sentences", [])
        ]
        split = str(img.get("split", "train"))
        if split == "restval" and restval_to_train:
            split = "train"
        splits.setdefault(split, []).append(stem)
    return desc, splits


def load_split(split_file) -> list[str]:
    """Parse a split file -> list of image ids."""
    ids = []
    with open(split_file) as f:
        for line in f:
            line = line.strip()
            if line:
                ids.append(line.rsplit(".", 1)[0])
    return ids


def prepare_descriptions(
    descriptions: dict[str, list[str]],
    split_ids: list[str] | None = None,
) -> dict[str, list[str]]:
    """Clean and wrap the captions with startseq/endseq, optionally kept to
    a split (ids absent from ``descriptions`` are skipped)."""
    if split_ids is not None:
        descriptions = {i: descriptions[i] for i in split_ids if i in descriptions}
    else:
        descriptions = dict(descriptions)
    cleaned = clean_descriptions(descriptions)
    return {i: [wrap_caption(c) for c in caps] for i, caps in cleaned.items()}
