"""Times kernels K1 (preprocess), K3 (bf16 merge head and vocab
projection) and K4 (bf16 identity block) from one or more copies of the
port, in turns, on one CUDA card.

    python3 scripts/kernel_versions.py TREE [TREE ...]

Each TREE is a directory that holds a ``tpucap_torch/`` package, for
example a copy of the repository with one kernel source edited: this is how
a kernel's versions are compared within one run on one card. All trees'
kernels are built first, in parallel; then each tree is timed in a process
of its own, in the order given and the first tree once more at the end, so
that a drift of the card shows. Per tree it prints one JSON line:

- ``k1_ms``: ``preprocess_u8`` at the main path's shape (uint8 (256, 224,
  224, 3) -> bf16, caffe), three timings; ``k1_299_ms``, from (256, 300,
  250, 3) to 299 (the resize route); ``k1_err``, ``k1_299_err``, the max
  abs errors against ``preprocess_u8_plain``;
- ``head_ms``: ``merge_head`` at the decode shape (fe bf16 and h' f32
  (768, 256), W_p (256, 256) bf16, with W_p's K-major copy made
  beforehand where the tree's ``merge_head`` takes one, as the decode keeps
  it), three timings; ``head_addmm_ms``, ``torch.addmm`` in f32 on fe + h';
  ``head_err``, against ``merge_head_plain``;
- ``step_ms``: one whole decode step from ``make_fused_merge_step`` (the
  embedding gather, K2, the merge head and the projection) at the decode
  shape, bf16, three timings: the step's device time, whichever kernels the
  tree's step launches; ``step_err``, its logits against the plain versions';
- ``k3_ms``: ``vocab_proj`` at the decode shape (768 x 256 @ 256 x 7579,
  bf16 W_o with its K-major copy made beforehand, as the decode keeps it),
  three timings; ``addmm_ms``, ``torch.addmm`` in f32 on the same inputs;
  ``k3_err``, the max abs error against ``vocab_proj_plain``;
- ``<stage>_ms`` and ``<stage>_err`` for ``fused_identity_block`` at
  ResNet-50's four stage shapes, bf16, batch 256, against
  ``fused_identity_block_plain``; ``pass_ms``, the best of each stage
  weighted by its blocks (12 launches).

Times are ``chip_smoke.cuda_ms``: CUDA events around launches replayed from
one CUDA graph. The card's name and power limit are printed first. Needs
one CUDA card and nvcc; exits non-zero without a card.
"""

from __future__ import annotations

import inspect
import json
import subprocess
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def time_tree(tree: str) -> dict:
    sys.path[:0] = [tree, str(ROOT)]
    import torch

    import chip_smoke as cs
    import tpucap_torch
    from tpucap_torch.ops import decoder_step, lstm_step, preprocess
    from tpucap_torch.ops.bottleneck import fused_identity_block, fused_identity_block_plain

    if not Path(tpucap_torch.__file__).resolve().is_relative_to(Path(tree).resolve()):
        raise RuntimeError(f"tpucap_torch came from {tpucap_torch.__file__}, not {tree}")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    res = {"tree": tree}
    # Older trees name the K-major copy vocab_weight_kmajor and make none of W_p.
    kmajor = getattr(decoder_step, "weight_kmajor", None) or decoder_step.vocab_weight_kmajor

    scale, bias, flip = cs._affine("caffe", dev)
    for key, shape, size in (("k1", (cs.BATCH, cs.IMAGE, cs.IMAGE, 3), cs.IMAGE),
                             ("k1_299", (cs.BATCH, 300, 250, 3), 299)):
        imgs = torch.randint(0, 256, shape, generator=g, device=dev, dtype=torch.uint8)
        rows = preprocess._index_table(size, shape[1], dev)
        cols = preprocess._index_table(size, shape[2], dev)
        got = preprocess.preprocess_u8(imgs, (size, size), "caffe", torch.bfloat16)
        want = preprocess.preprocess_u8_plain(imgs, rows, cols, scale, bias, flip, torch.bfloat16)
        res[f"{key}_err"] = cs.max_err(got, want)
        res[f"{key}_ms"] = [
            cs.cuda_ms(lambda: preprocess.preprocess_u8(imgs, (size, size), "caffe", torch.bfloat16))
            for _ in range(3)
        ]
        del imgs, got, want

    M, U, V = cs.BATCH * cs.BEAM, cs.WIDTH, cs.VOCAB
    fe = torch.randn((M, U), generator=g, device=dev).relu().bfloat16()
    h32 = torch.randn((M, U), generator=g, device=dev) * 0.5
    wp = (torch.randn((U, U), generator=g, device=dev) * U**-0.5).bfloat16()
    bp = (torch.randn(U, generator=g, device=dev) * 0.1).bfloat16()
    extra = (kmajor(wp),) if "wp_t" in inspect.signature(decoder_step.merge_head).parameters else ()
    res["head_err"] = cs.max_err(decoder_step.merge_head(fe, h32, wp, bp, *extra),
                                 decoder_step.merge_head_plain(fe, h32, wp, bp))
    res["head_ms"] = [cs.cuda_ms(lambda: decoder_step.merge_head(fe, h32, wp, bp, *extra)) for _ in range(3)]
    a32, wp32, bp32 = fe.float() + h32, wp.float(), bp.float()
    res["head_addmm_ms"] = cs.cuda_ms(lambda: torch.addmm(bp32, a32, wp32))

    merged = torch.randn((M, U), generator=g, device=dev).relu()
    wo = (torch.randn((U, V), generator=g, device=dev) * U**-0.5).bfloat16()
    bo = (torch.randn(V, generator=g, device=dev) * 0.1).bfloat16()
    wo_t = kmajor(wo)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).bfloat16()

    params = {
        "embedding": {"table": rnd(V, U, scale=0.05)},
        "cells": [{"kernel": rnd(U, 4 * U, scale=U**-0.5), "recurrent": rnd(U, 4 * U, scale=U**-0.5),
                   "bias": rnd(4 * U, scale=0.1)}],
        "pre_out": {"kernel": wp, "bias": bp}, "out": {"kernel": wo, "bias": bo},
    }
    state = {"fe": fe, "h": rnd(M, 1, U, scale=0.5), "c": rnd(M, 1, U)}
    token = torch.randint(0, V, (M,), generator=g, device=dev)
    step = decoder_step.make_fused_merge_step(types.SimpleNamespace(num_layers=1))
    cell = params["cells"][0]
    x = params["embedding"]["table"][token]
    h32 = lstm_step.lstm_cell_plain(x, state["h"][:, 0], state["c"][:, 0], cell["kernel"],
                                    cell["recurrent"], cell["bias"])[2]
    m_plain = decoder_step.merge_head_plain(fe, h32, wp, bp)
    res["step_err"] = cs.max_err(step(params, state, token)[0], decoder_step.vocab_proj_plain(m_plain, wo, bo))
    res["step_ms"] = [cs.cuda_ms(lambda: step(params, state, token)) for _ in range(3)]
    got = decoder_step.vocab_proj(merged, wo, bo, wo_t)
    res |= {
        "k3_err": cs.max_err(got, decoder_step.vocab_proj_plain(merged, wo, bo)),
        "k3_ms": [cs.cuda_ms(lambda: decoder_step.vocab_proj(merged, wo, bo, wo_t)) for _ in range(3)],
        "addmm_ms": cs.cuda_ms(lambda: torch.addmm(bo.float(), merged, wo.float())),
    }
    for name, S, C, Mc, _ in cs.STAGES:
        p1, p2, p3 = cs._block_params(C, Mc, g, dev, torch.bfloat16)
        x = torch.randn((cs.BATCH, S, S, C), generator=g, device=dev).relu().bfloat16()
        got = fused_identity_block(p1, p2, p3, x)
        res[f"{name}_err"] = cs.max_err(got, fused_identity_block_plain(p1, p2, p3, x))
        res[f"{name}_ms"] = [cs.cuda_ms(lambda: fused_identity_block(p1, p2, p3, x), 10) for _ in range(2)]
        del x, got
    res["pass_ms"] = sum(min(res[f"{n}_ms"]) * b for n, _, _, _, b in cs.STAGES)
    return res


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(time_tree(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("kernel_versions: no CUDA device", file=sys.stderr)
        return 1
    build = "import sys; sys.path.insert(0, sys.argv[1]); from tpucap_torch import _build; _build.build_all()"
    procs = [subprocess.Popen([sys.executable, "-c", build, t]) for t in argv]
    if any(p.wait() for p in procs):
        print("kernel_versions: a build failed", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)
    rc = 0
    for tree in [*argv, argv[0]]:
        r = subprocess.run([sys.executable, __file__, "--one", tree], capture_output=True, text=True)
        print(r.stdout.strip() or r.stderr[-2000:], flush=True)
        rc |= r.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
