"""Serialized inference artifacts: the whole decode as `torch.export`
programs (counterpart of aocr/export.py).

`export_recognizer` traces the ENTIRE decode (CNN + bi-LSTM encoder +
greedy/beam attention decode, optionally trie-constrained) with
`torch.export` and packs it with the weights, the dictionary table and
the vocab codec into one self-contained `.aocrx` zip.
`ExportedRecognizer.load` runs it with no model code, no Config and no
tracing: the program is replayed, not rebuilt, so an artifact's numerics
are frozen at export time.

    python -m aocr_torch.export -model_dir train/ -out m.aocrx
    rec = ExportedRecognizer.load("m.aocrx")          # on cuda
    words, scores = rec.recognize(images)

Design notes:

- The batch dimension is exported symbolically by default
  (`torch.export.Dim`, traced at an example batch of 2 so that the 0/1
  specialization does not pin it), so one artifact serves any batch
  size; `batch=<int>` pins it instead (the loader then pads partial
  batches by repeating the last row).
- The program holds only aten operations by default (`use_pallas=False`,
  the plain route), which `torch.export.load` alone runs.  With
  `use_pallas=True` it holds the port's kernels as the custom ops
  `aocr_torch::...` on the routes of the model's config (`pallas_greedy`,
  `pallas_beam`); their launch plans, weight packing and scratch are
  sized inside each op from the real batch, so a symbolic batch passes
  through.  Loading such an artifact imports the ops' registrations
  (`aocr_torch.ops.cuda.OPS`): the one piece of the port it needs.
- The decode runs all max_len steps (`early_exit=False`): the host loops'
  all-frozen exit branches on a tensor's value, which a traced program
  cannot, and a frozen row's further steps emit PAD at no cost.
- A program is traced on the caller's device and moved to the serving
  device at load (`torch.export.passes.move_to_device_pass`), so a plain
  artifact traced on a CPU build box serves on the card.
- Weights live in the artifact as `.npy` members in the checkpoint layout
  (the names, shapes and values of aocr's artifact of the same
  checkpoint; no pickle anywhere), NOT inside the program: they are the
  program's inputs, and the conversion to the port's layout (the conv
  transposes) is traced into it.  So the program member holds no weight
  bytes, and `update_weights` redeploys a checkpoint by reusing it byte
  for byte.
- The format is "aocrx-torch": aocr's loader refuses such an artifact,
  and this loader refuses aocr's StableHLO artifacts, naming the way to
  re-export.
"""

from __future__ import annotations

import io
import json
import os
import zipfile
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.export.passes import move_to_device_pass

from aocr_torch import data, decode, devices, vocab, weights
from aocr_torch.api import AttentionOCR
from aocr_torch.checkpoint import _LEAF_TAG, _flatten, _unflatten
from aocr_torch.config import GEOMETRY_FIELDS, Config
from aocr_torch.ops import cuda
from aocr_torch.utils import trie as trie_lib

FORMAT = "aocrx-torch"
FORMAT_VERSION = 1
# aocr's artifacts (StableHLO programs), which this package cannot run
JAX_FORMAT = "aocrx"
_META_MEMBER = "__meta__.json"


def _program_member(width: int) -> str:
    return f"__program__.w{int(width)}.bin"


def _write_artifact(path: str, meta: dict, programs: dict,
                    arrays: dict) -> None:
    """Single home for the .aocrx zip layout (export_recognizer and
    update_weights must emit byte-compatible artifacts)."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as z:
        z.writestr(_META_MEMBER, json.dumps(meta))
        for w, program in programs.items():
            z.writestr(_program_member(w), program)
        for name, arr in arrays.items():
            buf = io.BytesIO()
            np.lib.format.write_array(buf, np.ascontiguousarray(arr),
                                      allow_pickle=False)
            z.writestr(name + ".npy", buf.getvalue())


def _leaf_names(skel) -> List[str]:
    """The member names of a skeleton's leaves in traversal order: the
    order of the program's weight inputs."""
    if isinstance(skel, dict):
        if set(skel) == {_LEAF_TAG}:
            return [skel[_LEAF_TAG]]
        return [n for v in skel.values() for n in _leaf_names(v)]
    if isinstance(skel, list):
        return [n for v in skel for n in _leaf_names(v)]
    return []


def _checkpoint_arrays(ocr) -> Tuple[dict, dict]:
    """(skeleton, arrays) of `ocr`'s weights in the checkpoint layout, and
    of its dictionary table where one is set."""
    params, stats = weights.to_numpy(ocr.params, ocr.batch_stats)
    arrays: dict = {}
    skeleton = {"params": _flatten(params, "params", arrays),
                "batch_stats": _flatten(stats, "batch_stats", arrays)}
    trie = ocr.dictionary_table
    if trie is not None:
        skeleton["trie"] = _flatten(
            np.asarray(trie.cpu().numpy(), np.int32), "trie", arrays)
    return skeleton, arrays


class _Decode(torch.nn.Module):
    """The exported program: the weights (checkpoint layout) and batch
    statistics as lists in skeleton order, the images (B, H, W, 1)
    float32 and, with a dictionary, the trie table in; (labels (B, T)
    int32, scores (B,) float32) out."""

    def __init__(self, skeleton: dict, cfg, K: int, T: int):
        super().__init__()
        self.skeleton, self.cfg, self.K, self.T = skeleton, cfg, K, T
        self.param_names = _leaf_names(skeleton["params"])
        self.stat_names = _leaf_names(skeleton["batch_stats"])

    def forward(self, params: List[torch.Tensor],
                batch_stats: List[torch.Tensor], images: torch.Tensor,
                trie: Optional[torch.Tensor] = None):
        p = weights.conv_to_port(_unflatten(
            self.skeleton["params"], dict(zip(self.param_names, params))))
        s = _unflatten(self.skeleton["batch_stats"],
                       dict(zip(self.stat_names, batch_stats)))
        return decode.beam_decode(p, s, images, self.cfg, beam_size=self.K,
                                  max_len=self.T, trie_table=trie,
                                  early_exit=False)


def _inputs(skeleton: dict, arrays: dict, device) -> list:
    """The program's inputs other than the images, on `device`: [param
    leaves, stat leaves] and, with a dictionary, the trie."""
    leaves = lambda k: [torch.from_numpy(np.array(arrays[n])).to(device)
                        for n in _leaf_names(skeleton[k])]
    out = [leaves("params"), leaves("batch_stats")]
    if "trie" in skeleton:
        out.append(leaves("trie")[0])
    return out


def export_recognizer(
    ocr,
    path: str,
    *,
    beam_size: Optional[int] = None,
    max_len: Optional[int] = None,
    batch: Union[str, int] = "poly",
    use_pallas: bool = False,
    widths: Optional[Sequence[int]] = None,
    device=None,
) -> str:
    """Export an `AttentionOCR`'s decode program to a `.aocrx` artifact.

    `ocr` supplies the weights, geometry, and (if a dictionary is set) the
    trie constraint, all of which are frozen into the artifact.
    `beam_size`/`max_len` default to the model config.  `batch="poly"`
    exports a symbolic batch dimension; an int pins it.  `use_pallas`
    traces the kernels' custom ops on the config's routes instead of the
    plain route.  `widths` exports one program per image width: for
    keep_aspect_ratio models it defaults to the serving width ladder
    (data.width_ladder), so the artifact accepts every clamped-aspect
    width; fixed-width models export the single configured width.  The
    programs are traced on `device` (default: the CUDA device).  Returns
    `path`."""
    dev = devices.resolve(device)
    cfg = ocr.cfg.replace(use_pallas=use_pallas)
    K = min(beam_size or cfg.beam_size, cfg.target_vocab_size)
    T = max_len or cfg.max_decoder_l
    if widths is None:
        widths = (data.width_ladder(cfg) if cfg.keep_aspect_ratio
                  else [cfg.image_width])
    widths = sorted({int(w) for w in widths})
    if not widths or widths[0] < 1:
        raise ValueError(f"bad widths {widths}")
    if batch != "poly":
        b = int(batch)
        if b < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")

    skeleton, arrays = _checkpoint_arrays(ocr)
    use_trie = "trie" in skeleton
    module = _Decode(skeleton, cfg, K, T)
    args = _inputs(skeleton, arrays, dev)
    spec = [[None] * len(args[0]), [None] * len(args[1]), None]
    if batch == "poly":
        # an example batch of 2: a batch of 1 would be specialized
        spec[2] = {0: torch.export.Dim("b", min=1)}
        b = 2
    if use_trie:
        spec.append(None)
    programs = {}
    for w in widths:
        images = torch.full((b, cfg.image_height, w, 1), 255.0, device=dev)
        with torch.no_grad():
            ep = torch.export.export(
                module, (*args[:2], images, *args[2:]),
                dynamic_shapes=tuple(spec), strict=False)
        # the example inputs hold the weights: not part of the program
        ep.example_inputs = None
        buf = io.BytesIO()
        torch.export.save(ep, buf)
        programs[w] = buf.getvalue()

    meta = {
        "format": FORMAT,
        "version": FORMAT_VERSION,
        "torch_version": torch.__version__,
        "device": dev.type,
        "beam_size": K,
        "max_len": T,
        "use_dictionary": use_trie,
        "use_pallas": use_pallas,
        "batch": "poly" if batch == "poly" else b,
        "widths": widths,
        "geometry": {k: getattr(cfg, k) for k in GEOMETRY_FIELDS},
        "compute_dtype": cfg.compute_dtype,
        # codec spec so even a non-aocr consumer can map ids -> text
        "vocab": {
            "pad": vocab.PAD, "go": vocab.GO, "eos": vocab.EOS,
            "id_to_char": {
                str(i): vocab.id_to_char(i)
                for i in range(vocab.NUM_SPECIAL, vocab.VOCAB_SIZE)
            },
        },
        "skeleton": skeleton,
    }
    _write_artifact(path, meta, programs, arrays)
    return path


def _read_meta(z: zipfile.ZipFile, path: str) -> dict:
    """The artifact's meta; ValueError for aocr's artifacts, foreign zips
    and future versions."""
    meta = json.loads(z.read(_META_MEMBER).decode())
    if meta.get("format") == JAX_FORMAT:
        raise ValueError(
            f"{path} is an aocr artifact (a StableHLO program), which "
            "aocr_torch cannot run: re-export its checkpoint with "
            "`python -m aocr_torch.export -model_dir <dir> -out <file>`")
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path} is not an {FORMAT} artifact")
    if meta.get("version", 0) > FORMAT_VERSION:
        raise ValueError(
            f"{path} has {FORMAT} version {meta['version']}; this "
            f"build reads up to {FORMAT_VERSION}")
    return meta


def _read_arrays(z: zipfile.ZipFile) -> dict:
    return {info.filename[:-4]: np.lib.format.read_array(
                io.BytesIO(z.read(info)), allow_pickle=False)
            for info in z.infolist() if info.filename.endswith(".npy")}


def update_weights(src_path: str, ocr, out_path: str) -> str:
    """Weight-only re-export: write a new artifact that reuses `src_path`'s
    already-traced programs with `ocr`'s weights (and dictionary table).
    This is why weights are npy members instead of program constants: a
    fine-tuned checkpoint redeploys without retracing.  Every leaf must
    match the source artifact's shape/dtype exactly."""
    with zipfile.ZipFile(src_path, "r") as z:
        meta = _read_meta(z, src_path)
        programs = {w: z.read(_program_member(w)) for w in meta["widths"]}
        old = _read_arrays(z)
    if meta["use_dictionary"] != (ocr.dictionary_table is not None):
        raise ValueError(
            "dictionary presence must match the source artifact "
            f"(source use_dictionary={meta['use_dictionary']}): the trie "
            "is a program input with a fixed shape")
    _skel, arrays = _checkpoint_arrays(ocr)
    if set(arrays) != set(old):
        raise ValueError(
            "weight tree mismatch vs the source artifact: "
            f"missing={sorted(set(old) - set(arrays))[:3]} "
            f"extra={sorted(set(arrays) - set(old))[:3]}")
    for name, arr in arrays.items():
        if arr.shape != old[name].shape or arr.dtype != old[name].dtype:
            raise ValueError(
                f"{name}: {arr.shape}/{arr.dtype} does not match the "
                f"exported {old[name].shape}/{old[name].dtype}")
    _write_artifact(out_path, meta, programs, arrays)
    return out_path


class ExportedRecognizer:
    """Run a `.aocrx` artifact: deserialized torch.export programs + the
    packed weights, on one device.

    No model code executes: `recognize` replays the exported program."""

    def __init__(self, programs, inputs, meta, device: torch.device):
        self._programs = programs  # {width: the program's module}
        self._inputs = inputs  # [params, batch_stats(, trie)]
        self.meta = meta
        self.device = device

    @property
    def widths(self) -> List[int]:
        """Image widths the artifact has programs for (ascending)."""
        return sorted(self._programs)

    @classmethod
    def load(cls, path: str, device=None) -> "ExportedRecognizer":
        """Read the artifact and move its programs and weights to `device`
        (default: the CUDA device).  An artifact with kernels needs the
        ops' registrations, which this imports first."""
        dev = devices.resolve(device)
        with zipfile.ZipFile(path, "r") as z:
            meta = _read_meta(z, path)
            if meta["use_pallas"]:
                cuda.register_ops()
            programs = {}
            for w in meta["widths"]:
                ep = torch.export.load(io.BytesIO(z.read(_program_member(w))))
                programs[int(w)] = move_to_device_pass(ep, dev).module()
            arrays = _read_arrays(z)
        return cls(programs, _inputs(meta["skeleton"], arrays, dev), meta,
                   dev)

    # ------------------------------------------------------------ running

    def preprocess_config(self):
        """Geometry `Config` for turning raw images into program inputs.
        A single-width artifact forces keep_aspect_ratio off (every image
        resizes to the one exported width); a multi-width artifact keeps
        the model's aspect-preserving preprocessing, and widths pad UP to
        the exported ladder.  Shared by path ingest here and by
        `aocr_torch.serve -artifact` HTTP ingest."""
        g = dict(self.meta["geometry"])
        if len(self._programs) == 1:
            g["keep_aspect_ratio"] = False
            g["image_width"] = self.widths[0]
        else:
            # a custom -widths ladder may be narrower than the model's
            # aspect bound: clamp so ingest RESIZES wide images into the
            # exported range instead of producing a width _pad_width must
            # reject (which would fail a whole coalesced serving batch)
            top_ar = self.widths[-1] / g["image_height"]
            g["max_aspect_ratio"] = min(g["max_aspect_ratio"], top_ar)
            g["min_aspect_ratio"] = min(g["min_aspect_ratio"],
                                        g["max_aspect_ratio"])
        return Config(**g)

    def _pad_width(self, img: np.ndarray) -> np.ndarray:
        """Pad an (H, W, 1) image's width up to the next exported width
        with the background value (255 pre-normalization)."""
        w = img.shape[1]
        for step in self.widths:
            if w <= step:
                if w == step:
                    return img
                return np.pad(img, ((0, 0), (0, step - w), (0, 0)),
                              constant_values=255.0)
        raise ValueError(
            f"image width {w} exceeds the widest exported program "
            f"({self.widths[-1]}); re-export with wider -widths")

    def recognize(
        self,
        images: Union[np.ndarray, Sequence[str]],
    ) -> Tuple[List[str], np.ndarray]:
        """Decode a stacked (B, H, W[, 1]) float batch, a bare path, a
        list of image paths, or a list of (H, W[, 1]) arrays (widths may
        mix: rows pad up to the exported width ladder and bucket per
        program).  Returns (transcripts, best-beam log-prob scores) in
        input order."""
        arrs = data.images_to_arrays(images, self.preprocess_config())
        n = len(arrs)
        if n == 0:
            # the symbolic batch is constrained >= 1; short-circuit instead
            return [], np.empty((0,), np.float32)
        arrs = [self._pad_width(a) for a in arrs]
        words: List[Optional[str]] = [None] * n
        scores = np.empty((n,), np.float32)
        by_width: dict = {}
        for i, a in enumerate(arrs):
            by_width.setdefault(a.shape[1], []).append(i)
        for w, idx in sorted(by_width.items()):
            lab, sc = self._decode_width(w, np.stack([arrs[i] for i in idx]))
            for i, word in zip(idx, vocab.decode_batch(lab)):
                words[i] = word
            scores[idx] = sc
        return words, scores

    def _decode_width(self, width: int, images: np.ndarray):
        n = images.shape[0]
        fixed = self.meta["batch"]
        if fixed != "poly":
            # pinned-batch artifact: chunk, padding the tail by repeating
            # the last row (sliced off after the fetch)
            labels_l, scores_l = [], []
            for lo in range(0, n, fixed):
                chunk = images[lo:lo + fixed]
                real = chunk.shape[0]
                if real < fixed:
                    pad = np.repeat(chunk[-1:], fixed - real, axis=0)
                    chunk = np.concatenate([chunk, pad])
                lab, sc = self._call(width, chunk)
                labels_l.append(lab[:real])
                scores_l.append(sc[:real])
            return np.concatenate(labels_l), np.concatenate(scores_l)
        return self._call(width, images)

    def _call(self, width: int, images: np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(images, np.float32))
        with torch.inference_mode():
            lab, sc = self._programs[width](
                self._inputs[0], self._inputs[1], x.to(self.device),
                *self._inputs[2:])
            return lab.cpu().numpy(), sc.cpu().numpy()


def main(argv: Optional[Sequence[str]] = None, device=None) -> int:
    """CLI: `python -m aocr_torch.export -model_dir train/ -out
    model.aocrx`, with aocr.export's flags; the checkpoint loads and the
    programs are traced on `device` (default: the CUDA device)."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="aocr_torch.export",
        description="Export a checkpoint to a self-contained .aocrx "
                    "inference artifact (torch.export programs + weights)")
    ap.add_argument("-model_dir", required=True,
                    help="checkpoint dir (or file) to export")
    ap.add_argument("-out", required=True, help="output .aocrx path")
    ap.add_argument("-beam_size", type=int, default=None)
    ap.add_argument("-max_len", type=int, default=None)
    ap.add_argument("-batch", default="poly",
                    help='"poly" (any batch size) or a fixed int')
    ap.add_argument("-platforms", default=None,
                    help="refused: a torch.export program moves to the "
                         "serving device when it is loaded")
    ap.add_argument("-use_pallas", action="store_true",
                    help="trace the CUDA kernels into the artifact as the "
                         "custom ops aocr_torch::... (loading it needs "
                         "aocr_torch's op registrations)")
    ap.add_argument("-widths", default=None,
                    help="comma-separated image widths to export programs "
                         "for (default: the width ladder for "
                         "keep_aspect_ratio models, else the one "
                         "configured width)")
    ap.add_argument("-dictionary_path", default=None,
                    help="constrain decoding to this word list")
    ap.add_argument("-allow_digit_prefix", action="store_true")
    ap.add_argument("-update_from", default=None,
                    help="source .aocrx whose traced programs are reused "
                         "(weight-only re-export: no retracing)")
    args = ap.parse_args(argv)
    if args.platforms is not None:
        raise ValueError(
            f"-platforms {args.platforms}: a torch.export program has no "
            "lowering targets; it is traced on this process's device and "
            "moved to the serving device when it is loaded "
            "(ExportedRecognizer.load(path, device=...))")

    ocr = AttentionOCR.load(args.model_dir, device=device)
    if args.dictionary_path:
        # load_dictionary caches the built DAWG next to the word list
        ocr.set_dictionary_table(trie_lib.load_dictionary(
            args.dictionary_path, args.allow_digit_prefix))
    if args.update_from:
        update_weights(args.update_from, ocr, args.out)
        size = os.path.getsize(args.out) / 1e6
        print(f"wrote {args.out} ({size:.1f} MB, program reused from "
              f"{args.update_from})")
        return 0
    batch = args.batch if args.batch == "poly" else int(args.batch)
    widths = ([int(w) for w in args.widths.split(",")]
              if args.widths else None)
    export_recognizer(
        ocr, args.out, beam_size=args.beam_size, max_len=args.max_len,
        batch=batch, use_pallas=args.use_pallas, widths=widths,
        device=device)
    size = os.path.getsize(args.out) / 1e6
    print(f"wrote {args.out} ({size:.1f} MB, traced on "
          f"{ocr.device}, batch={batch})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
