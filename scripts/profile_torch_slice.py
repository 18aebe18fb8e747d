"""Where a batch of the port's serving slice, and a training step, spend
their time on the card.

    python3 scripts/profile_torch_slice.py [PART ...]   # from the repo root; one CUDA card

PART is any of slice, fused, vit, train, continuous, dials (default: all).

Builds the same full-width pipelines as chip_smoke.py (1-layer merge LSTM,
bf16, batch 256, beam 3, vocab 7579, random weights from a seed) with the
encoder of each path: ``slice`` ResNet-50 (BN folded), ``fused`` the same
with its identity blocks as kernel K4, ``vit`` ViT-B/16 with flash
attention (kernel K5). For each it runs one warm-up
batch, then traces with ``torch.profiler``:

- ``batch``: one whole ``CaptioningPipeline.caption_batch``;
- ``encode``: its first half alone (preprocess kernel K1 + the encoder);
- ``decode``: its second half alone (init_state + beam search, whose step
  is kernels K2 + K3, + the id-to-word drain).

Then ``train``: the joint step of ``fit_finetune`` (ViT-B/16 with flash
attention + lstm1, batch 64, bf16 compute with f32 masters, Adam;
``make_joint_train_step``, whose attention launches kernel K5 forward and
K5's dK/dV and dQ kernels), as ``joint step``, and the decoder's step on
features (``make_train_step``, lstm1, batch 256, T 35, bf16) as ``decoder
step``, the shapes of chip_smoke.py's phase 5.

Then ``continuous``: one sync group (chip_smoke.P15_TICKS ticks) of the
serving engines behind ``ContinuousCaptionServer`` on path A's bf16
decoder with every slot live (chip_smoke.P15_MAX_BATCH: 64 lanes greedy,
64 groups of 3 lanes at beam 3), the shapes of phase 15 (f)-(h).

Then ``dials``: path A's f32 decoder at phase 16's shapes
(chip_smoke.P16_ROWS rows of features): one unconstrained beam-3
``generate``, one beam-3 ``generate_continuation`` with phase 16's
prefixes, and one ``generate_constrained`` at each C of
chip_smoke.P16_CONSTRAINTS, with phase 16's words.

Each part is first run untraced three times (host clock around work that
ends in a synchronize; the median is kept), then traced once, in the same
process on the same inputs. For each it prints both wall times, the device
time summed over kernels, the device's busy time (the union of kernel
intervals), device time by group of kernels, and the top kernels; then one
JSON line with those numbers. A trace adds host cost to every launch but
not to a kernel's device time, so the busy share that counts is the traced
busy time over the untraced wall (``busy_share``); the traced wall's share
(``busy_share_traced``) is printed beside it to show the tracer's cost.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the slice's shapes and pipeline)
from tpucap_torch.ops.preprocess import fused_preprocess  # noqa: E402
from tpucap_torch.text import Tokenizer  # noqa: E402

GROUPS = (  # first match wins; substrings of the demangled kernel name
    ("port K1 preprocess_u8", ("preprocess_u8_same_kernel", "preprocess_u8_gather_kernel")),
    ("port K2 lstm_cell", ("lstm_cell_kernel",)),
    ("port K3 merge_head", ("merge_head_kernel",)),
    ("port K3 vocab_proj", ("vocab_proj_kernel",)),
    ("port K3 SIMT (f32, other widths)", ("linear_kernel",)),
    ("port K4 identity_block", ("identity_block_kernel",)),
    ("port K5 flash_attention", ("flash_kernel",)),
    ("port K5b dK/dV", ("dkv_kernel",)),
    ("port K5b dQ", ("dq_kernel",)),
    ("convolution", ("conv", "cudnn", "fprop", "implicit_gemm", "nchwToNhwc", "nhwcToNchw")),
    ("matmul (cuBLAS)", ("gemm", "Gemm", "xmma", "cutlass", "nvjet")),
    ("sort", ("RadixSort", "radix_sort", "sort_")),
    ("elementwise", ("elementwise_kernel",)),
    ("reduction", ("reduce_kernel",)),
    ("pool", ("pool",)),
    ("gather/index", ("index", "gather", "Index", "Gather")),
    ("memcpy/memset", ("Memcpy", "Memset")),
)


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def busy_us(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s >= end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def untraced_ms(fn, runs: int = 3) -> float:
    walls = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def trace(name: str, fn) -> dict:
    plain_wall_ms = untraced_ms(fn)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.end > e.time_range.start
    ]
    if not kernels:
        raise AssertionError(f"{name}: the trace holds no device time")
    by_group: dict[str, float] = defaultdict(float)
    by_name: dict[str, list] = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        by_group[group_of(e.name)] += us
        by_name[e.name][0] += us
        by_name[e.name][1] += 1
    device_us = sum(by_group.values())
    union_us = busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
    busy_share = union_us / 1e3 / plain_wall_ms
    print(f"{name}: untraced wall ms {plain_wall_ms:.3f}; traced wall ms {wall_us / 1e3:.3f}; "
          f"device kernel ms {device_us / 1e3:.3f}; device busy ms {union_us / 1e3:.3f}; "
          f"busy share {busy_share:.4f} (traced wall: {union_us / wall_us:.4f}); "
          f"device launches {len(kernels)}")
    for group, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"{name}: group {group}: ms {us / 1e3:.3f} ({us / device_us:.4f} of device time)")
    for kname, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"{name}: kernel {us / 1e3:8.3f} ms x{n:4d} {kname[:100]}")
    return {
        "untraced_wall_ms": plain_wall_ms, "traced_wall_ms": wall_us / 1e3,
        "device_kernel_ms": device_us / 1e3, "device_busy_ms": union_us / 1e3,
        "busy_share": busy_share, "busy_share_traced": union_us / wall_us,
        "device_launches": len(kernels),
        "group_ms": {k: v / 1e3 for k, v in by_group.items()},
    }


def make_path(path: str):
    if path == "vit":
        pipe = chip_smoke.make_pipeline("bf16", encoder="vit_b16")
        pipe.encoder = dataclasses.replace(pipe.encoder, attention_impl="flash")
        return pipe
    pipe = chip_smoke.make_pipeline("bf16")
    if path == "fused":
        pipe.encoder = dataclasses.replace(pipe.encoder, fused_blocks=True)
    return pipe


def profile_path(path: str, dev) -> dict:
    pipe = make_path(path)
    enc = pipe.encoder
    g = torch.Generator(device=dev).manual_seed(2)
    B, S = chip_smoke.BATCH, chip_smoke.IMAGE
    images = torch.randint(0, 256, (B, S, S, 3), generator=g, device=dev, dtype=torch.uint8)
    pipe.caption_batch(images)  # warm-up: build, cuDNN plans, allocator
    params = pipe._inference_params()
    cfg = pipe.config.decode

    # caption_batch's body, cut in two at the features.
    @torch.inference_mode()
    def encode():
        x = fused_preprocess(images, enc.input_size, enc.preprocess_mode, out_dtype=torch.bfloat16)
        return pipe._apply_encoder(params["encoder"], x)

    feats = encode()

    @torch.inference_mode()
    def decode():
        return pipe._captions(pipe._decode(params["decoder"], feats, "beam", cfg.beam_width))

    return {
        "batch": trace(f"{path} batch", lambda: pipe.caption_batch(images)),
        "encode": trace(f"{path} encode", encode),
        "decode": trace(f"{path} decode", decode),
    }


def profile_train(dev, tokenizer) -> dict:
    """One joint step and one decoder step, each after a warm-up step."""
    from tpucap_torch.config import TrainConfig
    from tpucap_torch.models.decoders import build_decoder
    from tpucap_torch.train import (
        TrainState,
        build_optimizer,
        build_training_tokens,
        encoder_learning_rate_optimizer,
        make_joint_train_step,
        make_train_step,
    )

    pipe = chip_smoke.finetune_pipeline(tokenizer, "bf16")
    opt = encoder_learning_rate_optimizer(build_optimizer(TrainConfig()), encoder_lr_scale=0.1)
    joint = make_joint_train_step(pipe.encoder, pipe.decoder, opt, compute_dtype=torch.bfloat16, donate=True)
    state = TrainState.create(pipe.params, opt, torch.Generator(device=dev).manual_seed(0))
    desc = chip_smoke.training_corpus(tokenizer, chip_smoke.TRAIN_BATCH, 9)
    _, tokens = build_training_tokens(tokenizer, desc, chip_smoke.MAX_LEN)
    tokens = torch.from_numpy(tokens).to(dev).long()
    g = torch.Generator(device=dev).manual_seed(12)
    S = chip_smoke.IMAGE
    images = torch.rand((chip_smoke.TRAIN_BATCH, S, S, 3), generator=g, device=dev) * 2 - 1
    box = [state]

    def joint_step():
        box[0], _ = joint(box[0], images, tokens)

    joint_step()  # warm-up: allocator, cuBLAS
    out = {"joint step": trace("train joint step", joint_step)}

    dec = build_decoder("lstm1", chip_smoke.VOCAB, chip_smoke.DEC_FEATURES,
                        embed_dim=chip_smoke.WIDTH, hidden_dim=chip_smoke.WIDTH)
    dopt = build_optimizer(TrainConfig())
    step = make_train_step(dec, dopt, compute_dtype=torch.bfloat16, donate=True)
    dparams = chip_smoke.tree_to(dec.init(torch.Generator().manual_seed(0)), dev)
    dbox = [TrainState.create(dparams, dopt, torch.Generator(device=dev).manual_seed(0))]
    B = chip_smoke.DEC_TRAIN_BATCH
    feats = torch.randn((B, chip_smoke.DEC_FEATURES), generator=g, device=dev)
    dtokens = torch.randint(1, chip_smoke.VOCAB, (B, chip_smoke.MAX_LEN + 1), generator=g, device=dev)

    def decoder_step():
        dbox[0], _ = step(dbox[0], feats, dtokens)

    decoder_step()
    out["decoder step"] = trace("train decoder step", decoder_step)
    return out


def profile_continuous(dev) -> dict:
    """A sync group of each continuous engine at full occupancy."""
    from tpucap_torch.serve import ContinuousCaptionServer

    pipe = make_path("fused")
    g = torch.Generator(device=dev).manual_seed(3)
    out = {}
    for label, width in (("greedy", 1), ("beam", chip_smoke.BEAM)):
        srv = ContinuousCaptionServer(pipe, slots=chip_smoke.P15_MAX_BATCH,
                                      ticks_per_sync=chip_smoke.P15_TICKS, beam_width=width)
        srv.close()
        eng = srv._engine
        ids = list(range(eng.slots))
        feats = torch.randn((eng.slots, chip_smoke.DEC_FEATURES), generator=g, device=dev)
        state = eng.admit(eng.init_state(), eng.pad_ids(ids), feats.to(eng.feature_dtype))
        eng.tick(state, chip_smoke.P15_TICKS)  # warm-up

        def group(state=state, eng=eng):
            eng.tick(state, chip_smoke.P15_TICKS)
            [t.cpu() for t in eng.flags(state)]  # the server's flags fetch

        out[label] = trace(f"continuous {label} sync group", group)
    return out


def profile_dials(dev, tokenizer) -> dict:
    """The per-request dials' decodes beside the plain beam decode."""
    pipe = chip_smoke.served_pipeline("f32", tokenizer)
    g = torch.Generator(device=dev).manual_seed(16)
    n = chip_smoke.P16_ROWS
    feats = torch.randn((n, chip_smoke.DEC_FEATURES), generator=g, device=dev)
    prefixes = chip_smoke.p16_prefixes(tokenizer, n, seed=16)
    runs = {
        "beam": ("dials beam 3", lambda: pipe.generate(feats, method="beam")),
        "continuation": ("dials continuation beam 3",
                         lambda: pipe.generate_continuation(feats, prefixes, method="beam")),
    }
    for c in chip_smoke.P16_CONSTRAINTS:
        words = chip_smoke.p16_words(tokenizer, n, c, seed=160 + c)
        runs[f"C={c}"] = (f"dials constrained C={c}",
                          lambda words=words: pipe.generate_constrained(feats, words))
    out = {}
    for key, (label, fn) in runs.items():
        fn()  # warm-up: the allocator's first growth for the new shapes
        out[key] = trace(label, fn)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_slice: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    parts = sys.argv[1:] or ["slice", "fused", "vit", "train", "continuous", "dials"]
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    for path in ("slice", "fused", "vit"):
        if path in parts:
            result[path] = profile_path(path, dev)
    tokenizer = Tokenizer()
    tokenizer.fit_on_texts(chip_smoke.corpus(chip_smoke.VOCAB - 3)["corpus"])
    if "train" in parts:
        result["train"] = profile_train(dev, tokenizer)
    if "continuous" in parts:
        result["continuous"] = profile_continuous(dev)
    if "dials" in parts:
        result["dials"] = profile_dials(dev, tokenizer)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
