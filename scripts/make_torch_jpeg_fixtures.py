"""Write the JPEG fixtures of tpucap_torch's decoder and their reference
digests.

    JAX_PLATFORMS=cpu python scripts/make_torch_jpeg_fixtures.py

Needs PIL and libjpeg's headers (to encode) and tpucap's libjpeg-turbo
decoder (the reference), so it runs on a host that has them, not on the
card's machine. It writes
into ``tests/data/torch_jpeg/``:

- six baseline JPEGs, 500x375 and 375x500, of smooth content with some
  texture: 4:2:0, 4:2:2, 4:4:4, gray, one with restart markers, one with
  optimized Huffman tables; then a progressive 4:2:0 one (PIL), and a
  4:1:1 and a 4:4:0 one, which only libjpeg writes (its compressor is
  built here with ``gcc -ljpeg``); then from that compressor an
  arithmetic-coded 4:2:0 one with restarts (SOF9), an arithmetic
  progressive one (SOF10), an Adobe CMYK one and a YCCK one;
- ``digests.json``: for each, the SHA-256 of tpucap's decode at its own
  size, and at 224 x 224 (nearest resize) with ``fast_scale=False`` (8/8)
  and with tpucap's default ``fast_scale=True`` (5/8 for these sizes). The
  CMYK and YCCK files, which tpucap's decoder refuses as libjpeg-turbo
  refuses them out as RGB, have ``"reference": "load_image"``: the digests
  of tpucap's ``load_image`` (PIL) at their own size and at 224.

``chip_smoke.py`` phase 6 holds the card machine's build of the port's
decoder against these digests (that machine has no libjpeg, and the port
reads no JPEG through PIL);
``tests/test_torch_jpeg.py`` checks that the port and tpucap both still give
them.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import io
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
from PIL import Image

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tpucap.ops import jpeg as jpeg_ops  # noqa: E402

OUT = ROOT / "tests" / "data" / "torch_jpeg"
SIZE = 224

# name -> (height, width, PIL mode or "libjpeg", PIL's save options or
# libjpeg_compressor's)
FIXTURES = {
    "a_420.jpg": (375, 500, "RGB", dict(quality=90, subsampling=2)),
    "b_422.jpg": (500, 375, "RGB", dict(quality=85, subsampling=1)),
    "c_444.jpg": (375, 500, "RGB", dict(quality=80, subsampling=0)),
    "d_gray.jpg": (500, 375, "L", dict(quality=90)),
    "e_restart.jpg": (375, 500, "RGB", dict(quality=75, subsampling=2, restart_marker_blocks=7)),
    "f_optimized.jpg": (500, 375, "RGB", dict(quality=95, subsampling=2, optimize=True)),
    "g_progressive.jpg": (375, 500, "RGB", dict(quality=90, subsampling=2, progressive=True)),
    "h_411.jpg": (375, 500, "libjpeg", dict(quality=85, sampling="4x1,1x1,1x1")),
    "i_440.jpg": (500, 375, "libjpeg", dict(quality=85, sampling="1x2,1x1,1x1")),
    "j_arith.jpg": (375, 500, "libjpeg", dict(quality=85, arith=True, restart=4)),
    "k_arith_progressive.jpg": (500, 375, "libjpeg", dict(quality=90, arith=True, scans="1")),
    "l_cmyk.jpg": (375, 500, "cmyk", dict(quality=90, sampling="1x1,1x1,1x1,1x1", color="cmyk")),
    "m_ycck.jpg": (500, 375, "cmyk", dict(quality=90, sampling="2x2,1x1,1x1,2x2", color="ycck")),
}
# A libjpeg compressor for what PIL cannot write: any integral sampling
# factors, RGB-coded files, CMYK and YCCK files (with libjpeg's Adobe
# marker), scan scripts, arithmetic coding with its DAC conditioning.
# argv: raw in, jpeg out, width, height, components (1, 3, or 4 for CMYK
# input), quality, sampling "HxV,HxV,...", color ("ycc", "rgb", "cmyk",
# "ycck"), scans ("0" sequential, "1" jpeg_simple_progression, else a
# script "c,c/Ss/Se/Ah/Al;..."), restart interval in MCUs, arithmetic
# (0/1), optimized tables (0/1), and every arithmetic table's DC L, DC U
# and AC Kx.
COMPRESS_C = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <jpeglib.h>

int main(int argc, char **argv) {
  if (argc != 16) return 2;
  int w = atoi(argv[3]), h = atoi(argv[4]), nc = atoi(argv[5]);
  size_t n = (size_t)w * h * nc;
  unsigned char *px = malloc(n);
  FILE *f = fopen(argv[1], "rb");
  if (!f || fread(px, 1, n, f) != n) return 3;
  fclose(f);
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr e;
  c.err = jpeg_std_error(&e);
  jpeg_create_compress(&c);
  FILE *o = fopen(argv[2], "wb");
  jpeg_stdio_dest(&c, o);
  c.image_width = w;
  c.image_height = h;
  c.input_components = nc;
  c.in_color_space = nc == 1 ? JCS_GRAYSCALE : (nc == 4 ? JCS_CMYK : JCS_RGB);
  jpeg_set_defaults(&c);
  if (!strcmp(argv[8], "rgb")) jpeg_set_colorspace(&c, JCS_RGB);
  if (!strcmp(argv[8], "cmyk")) jpeg_set_colorspace(&c, JCS_CMYK);
  if (!strcmp(argv[8], "ycck")) jpeg_set_colorspace(&c, JCS_YCCK);
  jpeg_set_quality(&c, atoi(argv[6]), TRUE);
  const char *sp = argv[7];
  for (int i = 0; i < c.num_components && *sp; i++) {
    int hs, vs, used;
    if (sscanf(sp, "%dx%d%n", &hs, &vs, &used) != 2) return 4;
    c.comp_info[i].h_samp_factor = hs;
    c.comp_info[i].v_samp_factor = vs;
    sp += used;
    if (*sp == ',') sp++;
  }
  c.restart_interval = atoi(argv[10]);
  c.arith_code = atoi(argv[11]);
  c.optimize_coding = atoi(argv[12]);
  for (int i = 0; i < NUM_ARITH_TBLS; i++) {
    c.arith_dc_L[i] = (UINT8)atoi(argv[13]);
    c.arith_dc_U[i] = (UINT8)atoi(argv[14]);
    c.arith_ac_K[i] = (UINT8)atoi(argv[15]);
  }
  const char *scans = argv[9];
  static jpeg_scan_info script[64];
  if (!strcmp(scans, "1")) {
    jpeg_simple_progression(&c);
  } else if (strcmp(scans, "0")) {
    int k = 0;
    for (const char *q = scans; *q && k < 64; k++) {
      jpeg_scan_info *si = &script[k];
      si->comps_in_scan = 0;
      while (1) {
        int v, used;
        if (sscanf(q, "%d%n", &v, &used) != 1) return 5;
        si->component_index[si->comps_in_scan++] = v;
        q += used;
        if (*q != ',') break;
        q++;
      }
      int used;
      if (sscanf(q, "/%d/%d/%d/%d%n", &si->Ss, &si->Se, &si->Ah, &si->Al, &used) != 4) return 6;
      q += used;
      if (*q == ';') q++;
    }
    c.scan_info = script;
    c.num_scans = k;
  }
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = px + (size_t)c.next_scanline * w * nc;
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  fclose(o);
  jpeg_destroy_compress(&c);
  return 0;
}
"""


def libjpeg_compressor(workdir: Path):
    """Builds COMPRESS_C in workdir; returns compress(image, quality=85,
    sampling="2x2,1x1,1x1", color="ycc", scans="0", restart=0,
    arith=False, optimize=False, dac=(0, 1, 5)) -> JPEG bytes; an image
    of four channels is CMYK input. ``dac`` is (L, U, Kx) for every
    arithmetic table."""
    src, exe = workdir / "compress.c", workdir / "compress"
    src.write_text(COMPRESS_C)
    subprocess.run(["gcc", "-O2", "-o", str(exe), str(src), "-ljpeg"], check=True,
                   capture_output=True)
    count = [0]

    def compress(img, quality=85, sampling="2x2,1x1,1x1", color="ycc", scans="0", restart=0,
                 arith=False, optimize=False, dac=(0, 1, 5)):
        img = np.ascontiguousarray(img, np.uint8)
        h, w = img.shape[:2]
        nc = 1 if img.ndim == 2 else img.shape[2]
        count[0] += 1
        raw, out = workdir / f"{count[0]}.raw", workdir / f"{count[0]}.jpg"
        raw.write_bytes(img.tobytes())
        args = [raw, out, w, h, nc, quality, sampling, color, scans, restart, int(arith),
                int(optimize), *dac]
        subprocess.run([str(exe), *map(str, args)], check=True, capture_output=True)
        return out.read_bytes()

    return compress


def content(h: int, w: int, seed: int) -> np.ndarray:
    """Smooth color fields with stripes and a little grain."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    f = rng.uniform(0.005, 0.03, (3, 2))
    ph = rng.uniform(0, 2 * np.pi, (3,))
    chans = [
        128 + 90 * np.sin(f[c, 0] * x + f[c, 1] * y + ph[c])
        + 25 * np.sin(0.35 * x + 0.2 * c) * (y > h / 2)
        for c in range(3)
    ]
    img = np.stack(chans, -1) + rng.normal(0, 4, (h, w, 3))
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def tpucap_native(blob: bytes, h: int, w: int) -> np.ndarray:
    """tpucap's libjpeg decode at the image's own size (target 0 x 0)."""
    lib = jpeg_ops._load()
    out = np.empty((h, w, 3), np.uint8)
    data = np.frombuffer(blob, np.uint8)
    offsets = np.zeros(1, np.int64)
    sizes = np.array([len(blob)], np.int64)
    status = np.zeros(1, np.int32)
    failures = lib.tpucap_decode_jpeg_batch(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        1, 0, 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        1, 0,
    )
    if failures:
        raise ValueError(f"tpucap's decoder refused the image: status {status[0]}")
    return out


def sha256(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def reference_digests(blob: bytes) -> dict:
    """The digests.json entry of one JPEG, from tpucap's decoder; of a CMYK
    or YCCK one, from tpucap's ``load_image``."""
    with Image.open(io.BytesIO(blob)) as im:
        w, h = im.size
        cmyk = im.mode == "CMYK"
    if cmyk:
        from tpucap.data.preprocess import load_image

        return {
            "shape": [h, w],
            "reference": "load_image",
            "native": sha256(load_image(io.BytesIO(blob)).astype(np.uint8)),
            str(SIZE): sha256(load_image(io.BytesIO(blob), (SIZE, SIZE)).astype(np.uint8)),
        }
    return {
        "shape": [h, w],
        "native": sha256(tpucap_native(blob, h, w)),
        str(SIZE): sha256(jpeg_ops.decode_jpeg_batch([blob], SIZE, fast_scale=False)[0]),
        f"{SIZE}_fast": sha256(jpeg_ops.decode_jpeg_batch([blob], SIZE, fast_scale=True)[0]),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args()
    args.out.mkdir(parents=True, exist_ok=True)
    digests = {
        "reference": "tpucap.ops.jpeg.decode_jpeg_batch (libjpeg-turbo): "
        "'native' at the image's own size, '<size>' with fast_scale=False, "
        "'<size>_fast' with fast_scale=True; where 'reference' is 'load_image', "
        "tpucap.data.preprocess.load_image (PIL) at the image's own size and at <size>",
        "size": SIZE,
        "files": {},
    }
    total = 0
    workdir = Path(tempfile.mkdtemp())
    compress = libjpeg_compressor(workdir)
    for seed, (name, (h, w, mode, opts)) in enumerate(FIXTURES.items()):
        if mode == "libjpeg":
            blob = compress(content(h, w, seed), **opts)
        elif mode == "cmyk":
            ink = np.concatenate([content(h, w, seed), content(h, w, seed + 1)[..., :1]], -1)
            blob = compress(ink, **opts)
        else:
            im = Image.fromarray(content(h, w, seed))
            if mode == "L":
                im = im.convert("L")
            buf = io.BytesIO()
            im.save(buf, "JPEG", **opts)
            blob = buf.getvalue()
        (args.out / name).write_bytes(blob)
        total += len(blob)
        digests["files"][name] = reference_digests(blob)
        print(f"{name}: {w}x{h} {mode} {opts} {len(blob)} bytes")
    (args.out / "digests.json").write_text(json.dumps(digests, indent=1) + "\n")
    print(f"{len(FIXTURES)} files, {total} bytes")


if __name__ == "__main__":
    main()
