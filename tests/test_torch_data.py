"""tpucap_torch's dataset readers and caption cleaning against tpucap's, on
generated token, split, JSON, COCO and Karpathy files; exact (string work,
no arithmetic).

The files hold each edge case the readers handle: a token line without a
tab (whitespace fallback), tags with several dots and without ``#``, blank
and whitespace-only lines, COCO annotations whose image is not listed (the
id as text), Karpathy sentences with ``raw``, with ``tokens`` only and with
an empty ``raw``, images without a split, ``restval`` folded or kept, and
split ids absent from the descriptions. Captions are drawn by hypothesis:
punctuation, digits, one-letter words, mixed case and non-ASCII letters.
"""

import json
import string

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tpucap.data import flickr8k as jdata
from tpucap.text import clean as jclean
from tpucap_torch import data as tdata
from tpucap_torch.text import clean as tclean

torch.set_num_threads(2)

SETTINGS = settings(max_examples=60, deadline=None, derandomize=True, database=None)

WORDS = ["A", "dog", "dog's", "runs,", "in", "the", "park.", "2", "dogs2", "x", "Café",
         "naïve", "ÉTÉ", "über-cool", "(red)", "I", "3rd", "co-op", "Ünïcödé!", "--", "b"]
captions = st.lists(
    st.one_of(st.sampled_from(WORDS), st.text(
        alphabet=string.ascii_letters + string.digits + string.punctuation + "éüßøΩ", max_size=8)),
    max_size=12,
).map(" ".join)


@SETTINGS
@given(captions)
def test_clean_caption_matches_tpucap(caption):
    assert tclean.clean_caption(caption) == jclean.clean_caption(caption)
    assert tclean.wrap_caption(caption) == jclean.wrap_caption(caption)


@SETTINGS
@given(st.dictionaries(st.sampled_from(["a", "b", "c", "1000268201_693b08cb0e"]),
                       st.lists(captions, max_size=4), max_size=4))
def test_clean_descriptions_updates_in_place_as_tpucap(desc):
    ours, theirs = {k: list(v) for k, v in desc.items()}, {k: list(v) for k, v in desc.items()}
    out = tclean.clean_descriptions(ours)
    assert out is ours
    assert jclean.clean_descriptions(theirs) is theirs
    assert ours == theirs


def _write_dataset(root, seed):
    rng = np.random.default_rng(seed)
    ids = [f"img{i:03d}" for i in range(8)] + ["1000268201_693b08cb0e", "a.b.c"]

    def cap():
        return " ".join(rng.choice(WORDS, size=int(rng.integers(0, 9))))

    lines = []
    for i in ids:
        for n in range(int(rng.integers(1, 6))):
            lines.append(f"{i}.jpg#{n}\t{cap()}")
    lines += [
        "",
        "   ",
        f"{ids[0]}.jpg#9 whitespace separated caption, no tab",
        f"{ids[1]}#0\tno extension on the tag",
        "noext\tan id without a dot or hash",
        f"{ids[2]}.jpg#1\t",  # a tab and no caption: the whitespace fallback
        "\t\tleading tabs",
    ]
    rng.shuffle(lines)
    (root / "tokens.txt").write_text("\n".join(lines) + "\n")
    (root / "split.txt").write_text(
        "\n".join([f"{ids[3]}.jpg", "", "missing.jpg", f"{ids[9]}.jpg", ids[4], "  ", "a.b.c.jpg"]) + "\n"
    )
    (root / "desc.json").write_text(json.dumps({i: [cap(), cap()] for i in ids[:4]} | {"7": ["num"]}))
    coco = {
        "images": [{"id": k, "file_name": f"COCO_val2014_{k:012d}.jpg"} for k in (1, 2, 3)],
        "annotations": [
            {"image_id": int(k), "caption": cap()} for k in rng.choice([1, 2, 3, 4, 5], size=12)
        ],
    }
    (root / "coco.json").write_text(json.dumps(coco))
    sentence_forms = [
        lambda: {"raw": cap(), "tokens": ["ignored"]},
        lambda: {"tokens": cap().split()},
        lambda: {"raw": "", "tokens": cap().split()},
        lambda: {},
    ]
    images = []
    for k, split in enumerate(["train", "val", "test", "restval", None, "restval", "extra"]):
        img = {
            "filename": f"k{k}.jpg",
            "sentences": [sentence_forms[j % 4]() for j in range(int(rng.integers(0, 6)))],
        }
        if split is not None:
            img["split"] = split
        images.append(img)
    (root / "karpathy.json").write_text(json.dumps({"images": images}))
    return root


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_readers_match_tpucap(tmp_path, seed):
    root = _write_dataset(tmp_path, seed)
    got = tdata.load_descriptions(root / "tokens.txt")
    want = jdata.load_descriptions(root / "tokens.txt")
    assert got == want and list(got) == list(want)
    assert tdata.load_split(root / "split.txt") == jdata.load_split(root / "split.txt")
    assert tdata.load_descriptions_json(root / "desc.json") == jdata.load_descriptions_json(
        root / "desc.json")
    got_coco = tdata.load_coco_annotations(root / "coco.json")
    assert got_coco == jdata.load_coco_annotations(root / "coco.json")
    assert {"4", "5"} & set(got_coco)  # annotations of unlisted images key on the id
    for restval in (True, False):
        got_k = tdata.load_karpathy_json(root / "karpathy.json", restval_to_train=restval)
        assert got_k == jdata.load_karpathy_json(root / "karpathy.json", restval_to_train=restval)
    assert "restval" in got_k[1] and "extra" in got_k[1]
    split = tdata.load_split(root / "split.txt")
    for ids in (None, split, []):
        for source in (dict(got), got_k[0]):
            a, b = {k: list(v) for k, v in source.items()}, {k: list(v) for k, v in source.items()}
            prepared = tdata.prepare_descriptions(a, ids)
            assert prepared == jdata.prepare_descriptions(b, ids)
            assert list(prepared) == list(jdata.prepare_descriptions(dict(source), ids))
            assert a == source  # the caller's mapping is left alone
    assert "missing" not in tdata.prepare_descriptions(got, split)
