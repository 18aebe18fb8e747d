"""Host time of each caption metric family of ``tpucap_torch.train.evaluate``
at ``chip_smoke.py`` phase 7's size: 1000 images with 5 references each.

    python3 scripts/metric_rates.py    # from the repo root; CPU only

The references are phase 7's (``chip_smoke.training_corpus``: 8 to 30
words of the synthetic 7579-word vocabulary, seeded); each hypothesis is 33 words drawn
from the vocabulary's first 300, so that words repeat across images as a
trained model's do. Each family ('bleu', 'cider', 'rouge_l', 'meteor',
'diversity') is scored alone through ``evaluate_captions``, in turn, three
rounds; prints the host, then each family's seconds (every round and the
median) and its share of the sum of medians.
"""

from __future__ import annotations

import os
import platform
import statistics
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import EVAL_IMAGES, EVAL_REFS, VOCAB, corpus, training_corpus  # noqa: E402
from tpucap_torch.text import Tokenizer  # noqa: E402
from tpucap_torch.train.evaluate import METRICS, evaluate_captions  # noqa: E402

ROUNDS, HYP_WORDS, HYP_VOCAB = 3, 33, 300


def main() -> int:
    tok = Tokenizer()
    tok.fit_on_texts(corpus(VOCAB - 3)["corpus"])
    desc = training_corpus(tok, EVAL_IMAGES, 13, refs=EVAL_REFS)
    words = [w for w in tok.word_index if w not in ("startseq", "endseq")]
    rng = np.random.default_rng(0)
    generated = {k: " ".join(rng.choice(words[:HYP_VOCAB], HYP_WORDS)) for k in desc}
    print(f"host: {platform.processor() or platform.machine()}, {os.cpu_count()} cpus, "
          f"python {platform.python_version()}; {EVAL_IMAGES} images x {EVAL_REFS} references, "
          f"{HYP_WORDS}-word hypotheses")
    times: dict[str, list[float]] = {m: [] for m in METRICS}
    for _ in range(ROUNDS):
        for m in METRICS:
            t0 = time.perf_counter()
            evaluate_captions(desc, generated, metrics=(m,))
            times[m].append(time.perf_counter() - t0)
    medians = {m: statistics.median(t) for m, t in times.items()}
    total = sum(medians.values())
    for m in METRICS:
        print(f"{m}: seconds {[round(t, 5) for t in times[m]]} median {medians[m]:.5f} "
              f"({100 * medians[m] / total:.1f} % of {total:.5f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
