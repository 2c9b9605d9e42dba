"""Offline HTML results gallery (counterpart of
aocr/visualizer/generate_html.py, the port's own copy: it needs only the
standard library, numpy and PIL):

    python -m aocr_torch.visualizer.generate_html --output_dir results \
        --data_base_dir data [--freq_path freq.json]

Consumes the `results.txt` TSV written by the test phase with -visualize
(img_path \t gold \t pred \t score_pred \t score_gold, from
aocr_torch.train.Trainer.step_eval, as the reference's
src/model/model.lua:628-633), copies the referenced images into
`website/images/` (a .npy crop rendered to a PNG), and writes a
filterable gallery (All / Correct / Incorrect tabs) with optional
lexicon-frequency annotations.  Frequency dictionaries load from .json
({word: count}) or legacy .pkl pickles.
"""

from __future__ import annotations

import argparse
import hashlib
import html
import json
import os
import pickle
import shutil
import urllib.parse
import sys
from typing import Dict, Optional

_PAGE_HEAD = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>aocr results</title>
<style>
body { font-family: sans-serif; margin: 1.5em; background: #fafafa; }
ul { list-style: none; padding: 0; display: flex; flex-wrap: wrap; gap: 12px; }
li { background: #fff; border: 1px solid #ddd; border-radius: 6px;
     padding: 10px; width: 240px; font-size: 13px; }
li.f-correct { border-left: 4px solid #2e7d32; }
li.f-incorrect { border-left: 4px solid #c62828; }
li img { image-rendering: pixelated; max-width: 220px; border: 1px solid #eee; }
nav button { margin-right: 8px; padding: 6px 14px; cursor: pointer; }
nav button.active { font-weight: bold; background: #e0e0e0; }
.hidden { display: none; }
</style></head><body>
<h1>Attention-OCR results</h1>
<nav>
<button id="b-all" class="active" onclick="show('all')">All</button>
<button id="b-correct" onclick="show('correct')">Correct</button>
<button id="b-incorrect" onclick="show('incorrect')">Incorrect</button>
</nav>
<p id="summary"></p>
<ul id="gallery">
"""

_PAGE_TAIL = """</ul>
<script>
function show(which) {
  document.querySelectorAll('nav button').forEach(b => b.classList.remove('active'));
  document.getElementById('b-' + which).classList.add('active');
  document.querySelectorAll('#gallery li').forEach(li => {
    li.classList.toggle('hidden',
      which !== 'all' && !li.classList.contains('f-' + which));
  });
}
const n = document.querySelectorAll('#gallery li').length;
const ok = document.querySelectorAll('#gallery li.f-correct').length;
document.getElementById('summary').textContent =
  ok + ' / ' + n + ' correct (' + (n ? (100*ok/n).toFixed(2) : 0) + '%)';
</script>
</body></html>
"""


def load_freq(path: Optional[str]) -> Dict[str, int]:
    if not path:
        return {}
    if not os.path.exists(path):
        # an explicitly-passed but missing file must not silently drop the
        # frequency annotations (the reference asserts existence)
        raise FileNotFoundError(f"freq file {path} not found")
    if path.endswith(".json"):
        with open(path) as f:
            return json.load(f)
    with open(path, "rb") as f:
        return pickle.load(f, encoding="latin-1")


def _npy_to_png(src: str, dst: str) -> bool:
    """Render a (H, W[, C]) float/uint8 .npy crop to a PNG; False on any
    decode problem (the gallery card then shows text only)."""
    try:
        import numpy as np
        from PIL import Image

        arr = np.load(src)
        if arr.ndim == 3 and arr.shape[-1] == 1:
            arr = arr[..., 0]
        if arr.ndim not in (2, 3):
            return False
        a = arr.astype("float32")
        if a.max() <= 1.0 + 1e-6:
            a = a * 255.0
        a = a.clip(0, 255).astype("uint8")
        Image.fromarray(a).save(dst)
        return True
    except Exception:
        return False


def generate(
    output_dir: str,
    data_base_dir: str,
    freq_path: Optional[str] = None,
) -> str:
    result_path = os.path.join(output_dir, "results.txt")
    if not os.path.exists(result_path):
        raise FileNotFoundError(f"Result file {result_path} not found")
    website_dir = os.path.join(output_dir, "website")
    img_dir = os.path.join(website_dir, "images")
    if os.path.isdir(img_dir):
        shutil.rmtree(img_dir)  # stale copies from previous runs
    os.makedirs(img_dir, exist_ok=True)
    freq = load_freq(freq_path)
    total = sum(freq.values()) if freq else 0

    html_path = os.path.join(website_dir, "index.html")
    with open(result_path) as fin, open(html_path, "w") as fout:
        fout.write(_PAGE_HEAD)
        for line in fin:
            items = line.rstrip("\n").split("\t")
            if len(items) != 5:
                continue
            img_path, gold, pred, score_pred, score_gold = items
            # Prefix with a short hash of the full path: flattening alone
            # would collide 'a/b.png' with 'a_b.png' and silently overwrite.
            digest = hashlib.sha1(img_path.encode()).hexdigest()[:8]
            base = f"{digest}_{os.path.basename(img_path)}"
            src = os.path.join(data_base_dir, img_path)
            dst = os.path.join(img_dir, base)
            img_tag = ""
            if os.path.exists(src):
                if src.endswith(".npy"):
                    # synthetic datasets store raw arrays; render to PNG so
                    # the gallery actually shows the crop
                    base = base[: -len(".npy")] + ".png"
                    dst = os.path.join(img_dir, base)
                    ok = _npy_to_png(src, dst)
                else:
                    shutil.copy(src, dst)
                    ok = True
                if ok:
                    # URL context needs percent-encoding, not just HTML
                    # escaping ('#'/'?'/'%' in names break the src)
                    img_tag = ('<img src="images/'
                               f'{urllib.parse.quote(base)}" /><br/>\n')
            cls = "f-correct" if gold == pred else "f-incorrect"
            fout.write(f'<li class="{cls} f-all">\n{img_tag}')
            fout.write(
                f"gold: {html.escape(gold)} ({html.escape(score_gold)})<br/>\n"
            )
            fout.write(
                f"predicted: {html.escape(pred)} ({html.escape(score_pred)})<br/>\n"
            )
            if freq:
                fout.write(
                    f"gold frequency: {freq.get(gold, 0)} out of {total}<br/>\n"
                )
                fout.write(
                    f"predicted frequency: {freq.get(pred, 0)} out of {total}<br/>\n"
                )
            fout.write("</li>\n")
        fout.write(_PAGE_TAIL)
    return html_path


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--output_dir", default="results",
                   help="Directory containing results.txt")
    p.add_argument("--data_base_dir", default="data",
                   help="Base directory of image paths in results.txt")
    p.add_argument("--freq_path", default=None,
                   help="Optional word-frequency dict (.json or .pkl)")
    args = p.parse_args(argv)
    path = generate(args.output_dir, args.data_base_dir, args.freq_path)
    print(f"Wrote {path}")


if __name__ == "__main__":
    sys.exit(main())
