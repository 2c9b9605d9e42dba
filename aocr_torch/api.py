"""Library API (counterpart of aocr/api.py, greedy recognition only):

    ocr = AttentionOCR.load("train/", device="cuda")   # an aocr checkpoint
    words, scores = ocr.recognize(images)    # (B, 32, W, 1) or a list

Image paths, device-side preprocessing, `shard()`, `score()` and the
dictionary constraint are not ported yet (ROADMAP).
"""

from __future__ import annotations

import os
from dataclasses import asdict
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from aocr import checkpoint, vocab
from aocr.config import GEOMETRY_FIELDS, STRUCT_FIELDS, Config
from aocr_torch import decode, weights
from aocr_torch.models import model as model_lib


def _device(device) -> torch.device:
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device


class AttentionOCR:
    """A loaded (or freshly initialized) attention-OCR model on one
    device (default: the first CUDA device if there is one, else CPU)."""

    def __init__(self, cfg: Config, params: dict, batch_stats: dict,
                 global_step: int = 0, device=None):
        self.cfg = cfg.validate()
        self.device = _device(device)
        move = lambda tree: weights.tree_map(tree,
                                             lambda _p, t: t.to(self.device))
        self.params = move(params)
        self.batch_stats = move(batch_stats)
        self.global_step = global_step

    @classmethod
    def create(cls, cfg: Optional[Config] = None, seed: Optional[int] = None,
               device=None) -> "AttentionOCR":
        """Random weights from a torch.Generator seeded with `seed` (default
        cfg.seed); the numbers differ from the JAX package's init."""
        cfg = cfg or Config(input_feed=True)
        gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
        params, stats = model_lib.init(cfg, gen)
        return cls(cfg, params, stats, device=device)

    @classmethod
    def load(cls, model_dir_or_path: str, cfg: Optional[Config] = None,
             device=None) -> "AttentionOCR":
        """Load an npz-v2 checkpoint written by either package (a file, or
        a model dir's final-model).  Structure fields come from the
        checkpoint; geometry too unless `cfg` overrides it; runtime knobs
        (dtype, kernels) from `cfg` or the defaults, as aocr.api does."""
        path = model_dir_or_path
        if os.path.isdir(path):
            path = checkpoint.final_path(path)
        ckpt = checkpoint.load(path)
        saved = ckpt["config"]
        base = cfg if cfg is not None else Config()
        overrides = base.geometry_overrides()
        fields = list(STRUCT_FIELDS) + [k for k in GEOMETRY_FIELDS
                                        if k not in overrides]
        saved_cfg = base.replace(**{k: saved[k] for k in fields if k in saved})
        params, stats = weights.from_numpy(ckpt["params"],
                                           ckpt["batch_stats"])
        return cls(saved_cfg, params, stats, ckpt["global_step"], device)

    def save(self, model_dir: str) -> str:
        """Write an npz-v2 checkpoint (model-<step> and final-model) that
        either package loads; returns the model-<step> path."""
        params, stats = weights.to_numpy(self.params, self.batch_stats)
        return checkpoint.save(
            model_dir, params, stats, asdict(self.cfg), self.global_step,
            {"learning_rate": self.cfg.learning_rate})

    def use_dictionary(self, words: Sequence[str],
                       allow_digit_prefix: bool = False) -> None:
        raise NotImplementedError(
            "dictionary decoding is not ported yet: the trie operands of "
            "the greedy kernels are the next ROADMAP item")

    def set_dictionary_table(self, table) -> None:
        raise NotImplementedError(
            "dictionary decoding is not ported yet: the trie operands of "
            "the greedy kernels are the next ROADMAP item")

    def _prepare_groups(self, images) -> List[Tuple[List[int], np.ndarray]]:
        """A stacked (B, H, W[, 1]) array, or a list of (H, W[, 1]) arrays
        of mixed widths -> width-homogeneous (indices, (b, H, W, 1))
        batches, in ascending width order."""
        if isinstance(images, str) or (
                isinstance(images, (list, tuple)) and images
                and isinstance(images[0], str)):
            raise NotImplementedError(
                "image paths are not ported yet; pass decoded (H, W) "
                "float32 arrays in [0, 255]")
        if hasattr(images, "ndim"):
            a = np.asarray(images, np.float32)
            if a.ndim == 3:
                a = a[..., None]
            if a.ndim != 4:
                raise ValueError(f"bad image batch shape {a.shape}")
            return [(list(range(a.shape[0])), a)]
        by_width: dict = {}
        arrs = []
        for i, it in enumerate(images):
            a = np.asarray(it, np.float32)
            if a.ndim == 2:
                a = a[..., None]
            if a.ndim != 3:
                raise ValueError(f"expected an (H, W[, 1]) image, got "
                                 f"{a.shape}")
            arrs.append(a)
            by_width.setdefault(a.shape[1], []).append(i)
        return [(idx, np.stack([arrs[i] for i in idx]))
                for _w, idx in sorted(by_width.items())]

    @torch.inference_mode()
    def recognize(self, images: Union[np.ndarray, Sequence[np.ndarray]],
                  beam_size: Optional[int] = None,
                  max_len: Optional[int] = None
                  ) -> Tuple[List[str], np.ndarray]:
        """Decode a batch (stacked array or per-image arrays; widths may
        mix).  Returns (transcripts, log-prob scores) in input order."""
        groups = self._prepare_groups(images)
        n = sum(len(idx) for idx, _ in groups)
        words: List[Optional[str]] = [None] * n
        scores = np.empty((n,), np.float32)
        K = beam_size or self.cfg.beam_size
        T = max_len or self.cfg.max_decoder_l
        for idx, x in groups:
            labels, sc = decode.beam_decode(
                self.params, self.batch_stats,
                torch.from_numpy(x).to(self.device), self.cfg,
                beam_size=K, max_len=T)
            labels, sc = labels.cpu().numpy(), sc.cpu().numpy()
            for j, i in enumerate(idx):
                words[i] = vocab.decode(labels[j])
                scores[i] = sc[j]
        return words, scores
