"""End-to-end demo on synthetic word images (the counterpart of
examples/synthetic_demo.py).

Generates a small rendered-word dataset, trains the flagship model with
the CLI trainer, evaluates it with greedy and dictionary-constrained
beam-5 search, writes the HTML results gallery, and exports an `.aocrx`
artifact that it replays against the live model: the port's whole
surface in one run.

    python -m aocr_torch.demo [--workdir DIR] [--words N] [--epochs N]
        [--batch_size N] [--augment] [--mode stripes|font] [--extra FLAGS]
        [--device cpu]

It runs on the CUDA device unless --device names another.  The JAX
package's demo claims >99% exact match in ~5 minutes on a TPU v5e; the
port's figures on the H100 are in PERF.md.  On the CPU use --words 64
--epochs 30 for a quick smoke run.  The renderers are the port's own
copies of tests/synth.py's: the port imports nothing of the JAX package
or of the tests.
"""

from __future__ import annotations

import argparse
import os
import random
import re
import time
from typing import List, Optional

import numpy as np

from aocr_torch import vocab

_FONT_DIR = "/usr/share/fonts/truetype/dejavu"
FONT_NAMES = ("DejaVuSans.ttf", "DejaVuSans-Bold.ttf", "DejaVuSerif.ttf",
              "DejaVuSerif-Bold.ttf", "DejaVuSansMono.ttf",
              "DejaVuSansMono-Bold.ttf")


def font_paths() -> List[str]:
    """The DejaVu families the font renderer draws from (those present)."""
    return [os.path.join(_FONT_DIR, n) for n in FONT_NAMES
            if os.path.exists(os.path.join(_FONT_DIR, n))]


def render_word(label: str, height: int = 32, width: int = 100
                ) -> np.ndarray:
    """(height, width) float32 image in [0, 255] encoding the label: each
    character a band of stripes whose period and phase its id sets (a
    learnable positional code, not real text)."""
    img = np.full((height, width), 255.0, np.float32)
    n = len(label)
    if n == 0:
        return img
    band_w = max(width // max(n, 1), 1)
    ys = np.arange(height)[:, None]
    for i, ch in enumerate(label):
        cid = vocab.char_to_id(ch)
        x0, x1 = i * band_w, min((i + 1) * band_w, width)
        xs = np.arange(x0, x1)[None, :]
        period = 2 + (cid % 7)
        pattern = ((ys + xs * (1 + cid % 3)) // period) % 2
        img[:, x0:x1] = np.where(pattern, 255.0 - cid * 6.0, cid * 5.0)
    return img


def render_word_font(label: str, height: int = 32, width: int = 100,
                     rng: Optional[np.random.RandomState] = None
                     ) -> np.ndarray:
    """(height, width) float32 grayscale image in [0, 255]: the label in a
    DejaVu font, dark on light, rendered at its natural aspect and then
    bilinearly squashed to the geometry.  With rng the family, size,
    levels and margins vary per call; without it DejaVuSans 28 px, black
    on white."""
    from PIL import Image, ImageDraw, ImageFont

    paths = font_paths()
    if not paths:
        raise RuntimeError(f"no DejaVu fonts under {_FONT_DIR}: use "
                           "--mode stripes")
    if rng is None:
        path, size, fg, bg, mx, my = paths[0], 28, 0.0, 255.0, 4, 3
    else:
        path = paths[rng.randint(len(paths))]
        size = rng.randint(22, 34)
        fg = float(rng.uniform(0, 60))
        bg = float(rng.uniform(200, 255))
        mx, my = rng.randint(2, 9), rng.randint(1, 6)
    font = ImageFont.truetype(path, size)
    l, t, r, b = font.getbbox(label or " ")
    canvas = Image.new("L", (max(r - l, 1) + 2 * mx, max(b - t, 1) + 2 * my),
                       int(round(bg)))
    ImageDraw.Draw(canvas).text((mx - l, my - t), label, fill=int(round(fg)),
                                font=font)
    return np.asarray(canvas.resize((width, height), Image.BILINEAR),
                      np.float32)


def make_dataset(root: str, labels, manifest_name: str, mode: str = "stripes",
                 render_rng: Optional[np.random.RandomState] = None,
                 height: int = 32, width: int = 100) -> str:
    """Write a .npy crop a label under root/images and the `path label`
    manifest root/manifest_name; returns the manifest's path."""
    if mode not in ("stripes", "font"):
        raise ValueError(f"mode {mode!r}: stripes or font")
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    lines = []
    for i, label in enumerate(labels):
        img = (render_word(label, height, width) if mode == "stripes"
               else render_word_font(label, height, width, rng=render_rng))
        rel = f"images/{i:04d}_{label}.npy"
        np.save(os.path.join(root, rel), img)
        lines.append(f"{rel} {label}")
    manifest = os.path.join(root, manifest_name)
    with open(manifest, "w") as f:
        f.write("\n".join(lines) + "\n")
    return manifest


def demo_words(n: int) -> List[str]:
    """examples/synthetic_demo.py's words: n draws of 3-8 lowercase letters
    and digits (random.Random(0)), deduplicated and sorted."""
    rng = random.Random(0)
    chars = "abcdefghijklmnopqrstuvwxyz0123456789"
    return sorted({"".join(rng.choice(chars)
                           for _ in range(rng.randint(3, 8)))
                   for _ in range(n)})


def accuracy(log_path: str) -> float:
    """The exact match of a test phase: its last 'Accuracy = ' line."""
    with open(log_path) as f:
        hits = re.findall(r"Accuracy = ([0-9.]+)", f.read())
    if not hits:
        raise RuntimeError(f"{log_path}: no accuracy line")
    return float(hits[-1])


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="End-to-end demo of aocr_torch on synthetic words")
    p.add_argument("--workdir", default="demo_workdir")
    p.add_argument("--words", type=int, default=2000)
    p.add_argument("--epochs", type=int, default=120)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--augment", action="store_true",
                   help="train with on-device augmentation (-augment)")
    p.add_argument("--mode", choices=["stripes", "font"], default="stripes",
                   help="word renderer: stripe code or PIL DejaVu glyphs")
    p.add_argument("--extra", default="",
                   help="extra aocr_torch.train flags, space-separated")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    return p


def main(argv=None, device=None) -> dict:
    """Run the demo (argv as the CLI's; `device` overrides --device).
    Returns {"words", "greedy_exact_match", "dict_exact_match", "gallery",
    "artifact", "replayed", "artifact_matches", "seconds"}."""
    args = parser().parse_args(argv)
    device = device if device is not None else args.device

    from aocr_torch import export as export_lib
    from aocr_torch import train
    from aocr_torch.api import AttentionOCR
    from aocr_torch.visualizer import generate_html

    t0 = time.perf_counter()
    work = args.workdir
    os.makedirs(work, exist_ok=True)
    words = demo_words(args.words)
    rng = np.random.RandomState(0) if args.mode == "font" else None
    make_dataset(work, words, "train.txt", args.mode, rng)
    make_dataset(work, words[:256], "val.txt", args.mode, rng)
    with open(os.path.join(work, "dict.txt"), "w") as f:
        f.write("\n".join(words))
    print(f"dataset: {len(words)} words in {work}", flush=True)

    model_dir = os.path.join(work, "model")
    common = ["-data_base_dir", work, "-data_path", "train.txt",
              "-val_data_path", "val.txt", "-model_dir", model_dir,
              "-batch_size", str(args.batch_size), "-input_feed",
              *args.extra.split()]

    print("=== training ===", flush=True)
    train.main(common + (["-augment"] if args.augment else []) + [
        "-phase", "train", "-log_path", os.path.join(work, "train.log"),
        "-num_epochs", str(args.epochs), "-steps_per_checkpoint", "512",
        "-num_batches_val", "4", "-learning_rate", "0.2",
        "-learning_rate_min", "0.01", "-lr_decay", "0.7"], device=device)

    print("=== greedy evaluation ===", flush=True)
    results = os.path.join(work, "results")
    test_log = os.path.join(work, "test.log")
    train.main(common + ["-phase", "test", "-load_model", "-visualize",
                         "-log_path", test_log, "-output_dir", results],
               device=device)

    print("=== beam-5 + dictionary evaluation ===", flush=True)
    beam_log = os.path.join(work, "test_beam.log")
    train.main(common + ["-phase", "test", "-load_model", "-log_path",
                         beam_log, "-beam_size", "5", "-use_dictionary",
                         "-dictionary_path", os.path.join(work, "dict.txt")],
               device=device)

    html = generate_html.generate(results, work)
    print(f"gallery: {html}", flush=True)

    print("=== deployment artifact ===", flush=True)
    art = os.path.join(work, "model.aocrx")
    ocr = AttentionOCR.load(model_dir, device=device)
    # the live model's routes, the kernels' custom ops on the card
    export_lib.export_recognizer(ocr, art, use_pallas=ocr.cfg.use_pallas,
                                 device=device)
    rec = export_lib.ExportedRecognizer.load(art, device=device)
    with open(os.path.join(work, "val.txt")) as f:
        sample = [os.path.join(work, line.split()[0]) for line in f][:8]
    texts, _ = rec.recognize(sample)
    live, _ = ocr.recognize(sample)
    match = sum(a == b for a, b in zip(texts, live))
    print(f"artifact: {art} ({os.path.getsize(art) / 1e6:.1f} MB); "
          f"replayed {len(sample)} val images, {match}/{len(sample)} match "
          f"the live model: {texts}", flush=True)
    out = {"words": len(words), "greedy_exact_match": accuracy(test_log),
           "dict_exact_match": accuracy(beam_log), "gallery": html,
           "artifact": art, "replayed": len(sample),
           "artifact_matches": match,
           "seconds": time.perf_counter() - t0}
    print(f"exact match: greedy {out['greedy_exact_match']:.4f}, "
          f"dictionary beam-5 {out['dict_exact_match']:.4f}; "
          f"{out['seconds']:.1f} s", flush=True)
    return out


if __name__ == "__main__":
    main()
