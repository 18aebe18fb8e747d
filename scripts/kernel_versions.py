"""Times kernels K1 (preprocess), K3 (bf16 merge head and vocab
projection), K4 (bf16 identity block), K5 (bf16 flash attention) and K5b
(its two bf16 backward kernels) from one or more copies of the port, in
turns, on one CUDA card.

    python3 scripts/kernel_versions.py [--only GROUP,...] TREE [TREE ...]

GROUP is one of k1, k3, k4, k5b (default: all); ``--only k5b`` times K5
and K5b alone.

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
- ``dkv_ms`` and ``dq_ms``: K5b's dK/dV and dQ kernels at the joint
  training step's shape (batch 64, L 196, 12 heads of 64), bf16, q, k, v
  as views of one qkv projection and the gradients into views of one
  buffer, three timings each; ``dkv_err``, ``dq_err``, the max abs errors
  against their plain versions; ``sdpa_bwd_ms``, the backward of
  ``F.scaled_dot_product_attention`` on the same inputs, measured as
  ``chip_smoke.py`` measures it (forward + backward, less the forward);
  ``k5_ms``, K5's forward (no statistics) on the same q, k, v, three
  timings; ``k5b_attributes``, each backward kernel's registers, shared
  memory and blocks an SM, where the tree can report them.

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
GROUPS = ("k1", "k3", "k4", "k5b")


def time_tree(tree: str, groups: tuple[str, ...] = GROUPS) -> dict:
    sys.path[:0] = [tree, str(ROOT)]
    import torch

    import tpucap_torch

    if not Path(tpucap_torch.__file__).resolve().is_relative_to(Path(tree).resolve()):
        raise RuntimeError(f"tpucap_torch came from {tpucap_torch.__file__}, not {tree}")
    dev = torch.device("cuda")
    res = {"tree": tree}
    for group in groups:  # each group's inputs from a generator of its own
        g = torch.Generator(device=dev).manual_seed(1)
        res |= {"k1": time_k1, "k3": time_k3, "k4": time_k4, "k5b": time_k5b}[group](dev, g)
    return res


def time_k1(dev, g) -> dict:
    import torch

    import chip_smoke as cs
    from tpucap_torch.ops import preprocess

    res = {}
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
    return res


def time_k3(dev, g) -> dict:
    import torch

    import chip_smoke as cs
    from tpucap_torch.ops import decoder_step, lstm_step

    res = {}
    # Older trees name the K-major copy vocab_weight_kmajor and make none of W_p.
    kmajor = getattr(decoder_step, "weight_kmajor", None) or decoder_step.vocab_weight_kmajor
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
    return res


def time_k4(dev, g) -> dict:
    import torch

    import chip_smoke as cs
    from tpucap_torch.ops.bottleneck import fused_identity_block, fused_identity_block_plain

    res = {}
    for name, S, C, Mc, _ in cs.STAGES:
        p1, p2, p3 = cs._block_params(C, Mc, g, dev, torch.bfloat16)
        x = torch.randn((cs.BATCH, S, S, C), generator=g, device=dev).relu().bfloat16()
        got = fused_identity_block(p1, p2, p3, x)
        res[f"{name}_err"] = cs.max_err(got, fused_identity_block_plain(p1, p2, p3, x))
        res[f"{name}_ms"] = [cs.cuda_ms(lambda: fused_identity_block(p1, p2, p3, x), 10) for _ in range(2)]
        del x, got
    res["pass_ms"] = sum(min(res[f"{n}_ms"]) * b for n, _, _, _, b in cs.STAGES)
    return res


def time_k5b(dev, g) -> dict:
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from tpucap_torch.ops import attention as A

    B, L, heads, d = cs.TRAIN_BATCH, cs.VIT_L, cs.VIT_HEADS, cs.VIT_D
    scale = d**-0.5
    qkv = torch.randn((B, L, 3 * heads * d), generator=g, device=dev).bfloat16()
    do = torch.randn((B, L, heads, d), generator=g, device=dev).bfloat16()
    q, k, v = A.qkv_views(qkv, heads)
    o, lse = A.flash_attention_plain(q, k, v, scale, with_lse=True)
    di = A.attention_di(o, do)
    grads = torch.empty_like(qkv)
    dq, dk, dv = A.qkv_views(grads, heads)

    def dkv():
        A.flash_attention_bwd_dkv(q, k, v, do, lse, di, scale, dk, dv)

    def dqk():
        A.flash_attention_bwd_dq(q, k, v, do, lse, di, scale, dq)

    dkv()
    dqk()
    want_dk, want_dv = A.flash_attention_bwd_dkv_plain(q, k, v, do, lse, di, scale)
    res = {
        "dkv_err": max(cs.max_err(dk, want_dk), cs.max_err(dv, want_dv)),
        "dq_err": cs.max_err(dq, A.flash_attention_bwd_dq_plain(q, k, v, do, lse, di, scale)),
        "dkv_ms": [cs.cuda_ms(dkv) for _ in range(3)],
        "dq_ms": [cs.cuda_ms(dqk) for _ in range(3)],
        "k5_ms": [cs.cuda_ms(lambda: A.flash_attention(q, k, v, scale)) for _ in range(3)],
    }
    qt, kt, vt = (a.detach().transpose(1, 2).requires_grad_() for a in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, scale=scale)

    res["sdpa_bwd_ms"] = cs.cuda_ms(lambda: torch.autograd.grad(sdpa_fwd(), (qt, kt, vt), dot)) - cs.cuda_ms(sdpa_fwd)
    if hasattr(A, "flash_attention_bwd_attributes"):
        res["k5b_attributes"] = A.flash_attention_bwd_attributes(torch.bfloat16)
    return res


def main(argv: list[str]) -> int:
    groups = GROUPS
    if argv[:1] == ["--only"]:
        groups, argv = tuple(argv[1].split(",")) if len(argv) > 1 else (), argv[2:]
    if not argv or not groups or not set(groups) <= set(GROUPS):
        print(__doc__, file=sys.stderr)
        return 2
    if argv[0] == "--one":
        print(json.dumps(time_tree(argv[1], groups)), flush=True)
        return 0
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
        r = subprocess.run([sys.executable, __file__, "--only", ",".join(groups), "--one", tree],
                           capture_output=True, text=True)
        print(r.stdout.strip() or r.stderr[-2000:], flush=True)
        rc |= r.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
