"""Library API (counterpart of aocr/api.py: greedy, beam and dictionary
recognition, and scoring):

    ocr = AttentionOCR.load("train/")        # an aocr checkpoint, on cuda
    words, scores = ocr.recognize(images)    # (B, 32, W, 1) or a list
    words, scores = ocr.recognize(images, beam_size=5)
    ocr.use_dictionary(["word", ...])        # constrain to a lexicon
    gold = ocr.score(images, ["word", ...])  # teacher-forced log-probs
    ocr.shard()                              # recognize over every GPU

`recognize` and `score` take a stacked array, a list of (H, W[, 1])
arrays, or image paths: decoded and preprocessed on the host by
`data.images_to_arrays`, or with `cfg.device_preprocess` decoded on the
host and preprocessed on the device (`preprocess.preprocess_varsize`).
Every entry point runs on the first CUDA device unless the caller names
another device (`device="cpu"`); without CUDA the default raises.
`shard()` splits each recognize batch over several devices, one host
thread a device (aocr.api's data-parallel inference, in one process).
"""

from __future__ import annotations

import contextlib
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import asdict
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from aocr_torch import checkpoint, data, devices, preprocess, vocab
from aocr_torch.config import GEOMETRY_FIELDS, STRUCT_FIELDS, Config
from aocr_torch import decode, train_step, weights
from aocr_torch.models import model as model_lib
from aocr_torch.parallel import mesh as mesh_lib
from aocr_torch.utils import trie as trie_lib


class AttentionOCR:
    """A loaded (or freshly initialized) attention-OCR model on one
    device (default: the current CUDA device)."""

    def __init__(self, cfg: Config, params: dict, batch_stats: dict,
                 global_step: int = 0, device=None):
        self.cfg = cfg.validate()
        self.device = devices.resolve(device)
        move = lambda tree: weights.tree_map(tree,
                                             lambda _p, t: t.to(self.device))
        self.params = move(params)
        self.batch_stats = move(batch_stats)
        self.global_step = global_step
        self._trie: Optional[torch.Tensor] = None
        # shard(): the devices recognize splits over, the weights (and
        # trie) replicated to each, one decode thread a shard
        self._shards: List[torch.device] = []
        self._replicas: dict = {}
        self._pool: Optional[ThreadPoolExecutor] = None

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
        """Constrain decoding to a word list (trie transition table).  For
        a word-list file prefer set_dictionary_table(
        trie.load_dictionary(path)), which caches the built DAWG."""
        self.set_dictionary_table(
            trie_lib.build_transition_table(words, allow_digit_prefix))

    def set_dictionary_table(self, table) -> None:
        """Constrain decoding to a prebuilt (nodes, V) int32 transition
        table (utils.trie.build_transition_table / load_dictionary), kept
        on self.device."""
        table = torch.as_tensor(np.asarray(table, np.int32))
        if table.ndim != 2 or table.shape[1] != self.cfg.target_vocab_size:
            raise ValueError(f"trie table of shape {tuple(table.shape)}, "
                             f"expected (nodes, {self.cfg.target_vocab_size})")
        self._trie = table.to(self.device).contiguous()
        self._replicate()

    def clear_dictionary(self) -> None:
        """Drop the dictionary constraint set by use_dictionary()."""
        self._trie = None
        self._replicate()

    @property
    def dictionary_table(self) -> Optional[torch.Tensor]:
        """The active trie transition table (None when unconstrained)."""
        return self._trie

    def shard(self, num_shards: Optional[int] = None,
              devices: Optional[Sequence] = None) -> "AttentionOCR":
        """Split recognize() batches across devices (data parallel, one
        process): the weights are replicated once to each device, each
        batch is padded to a multiple of the shard count by repeating its
        last row, split in row order, decoded on each device from a host
        thread of its own (recognize syncs on the host for the
        transcripts, so one thread would run the devices in series), and
        the padding sliced off.  num_shards=None uses every local device
        of self.device's kind; `devices` may name a device more than once
        (each entry is one shard).  shard(1) or unshard() restores
        single-device dispatch.  Only recognize() runs sharded."""
        if num_shards is not None and num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        if devices is not None and len(devices) == 0:
            raise ValueError("devices must be non-empty")
        if mesh_lib.world() > 1:
            raise ValueError(
                "AttentionOCR.shard() is single-process; under a "
                "multi-process group run one recognizer per process over "
                "its local devices")
        if num_shards == 1 and devices is None:
            return self.unshard()
        devs = mesh_lib.make_mesh(num_data=num_shards, devices=devices,
                                  kind=self.device.type)
        self.unshard()
        self._shards = devs
        self._replicate()
        self._pool = ThreadPoolExecutor(max_workers=len(devs),
                                        thread_name_prefix="aocr-shard")
        return self

    def _replicate(self) -> None:
        """The weights and trie on each distinct shard device, once."""
        self._replicas = {}
        for d in self._shards:
            if d in self._replicas:
                continue
            move = lambda tree: weights.tree_map(tree, lambda _p, t: t.to(d))
            self._replicas[d] = (
                move(self.params), move(self.batch_stats),
                None if self._trie is None else self._trie.to(d))

    @property
    def num_shards(self) -> int:
        """The number of shards recognize() splits over (1 = one
        device)."""
        return max(1, len(self._shards))

    def unshard(self) -> "AttentionOCR":
        """Back to single-device recognize on self.device."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
        self._shards, self._replicas, self._pool = [], {}, None
        return self

    def _prepare_groups(self, images) -> List[Tuple[List[int], object]]:
        """A stacked (B, H, W[, 1]) array, a path, or a list of image paths
        or (H, W[, 1]) arrays of mixed widths -> width-homogeneous
        (indices, (b, H, W, 1)) batches, in ascending width order: numpy
        arrays, or tensors on self.device where the device preprocessed
        them.  Paths are decoded and preprocessed on the host by
        data.images_to_arrays, as aocr.api does; with
        cfg.device_preprocess and a list of paths, the host only decodes
        (data.load_raw) and the luminance and resize run on the device
        (aocr.api's serving fast path)."""
        if hasattr(images, "ndim"):
            a = np.asarray(images, np.float32)
            if a.ndim == 3:
                a = a[..., None]
            if a.ndim != 4:
                raise ValueError(f"bad image batch shape {a.shape}")
            return [(list(range(a.shape[0])), a)]
        if isinstance(images, str):
            images = [images]  # a bare path is one image
        if self.cfg.device_preprocess and images and isinstance(
                images[0], str):
            raws, by_width = [], {}
            for i, item in enumerate(images):
                r = data.load_raw(item, self.cfg)
                if r is None:
                    raise ValueError(f"cannot decode image {item}")
                raws.append(r[0])
                by_width.setdefault(r[1], []).append(i)
            groups = []
            for w, idx in sorted(by_width.items()):
                buf, sizes = data.pack_raw([raws[i] for i in idx])
                groups.append((idx, preprocess.preprocess_varsize(
                    buf, sizes, self.cfg.image_height, w, self.device)))
            return groups
        arrs = data.images_to_arrays(images, self.cfg)
        by_width: dict = {}
        for i, a in enumerate(arrs):
            by_width.setdefault(a.shape[1], []).append(i)
        return [(idx, np.stack([arrs[i] for i in idx]))
                for _w, idx in sorted(by_width.items())]

    @torch.inference_mode()
    def recognize(self, images: Union[np.ndarray, Sequence[np.ndarray],
                                      str, Sequence[str]],
                  beam_size: Optional[int] = None,
                  max_len: Optional[int] = None
                  ) -> Tuple[List[str], np.ndarray]:
        """Decode a batch (stacked array, image paths or per-image arrays;
        widths may mix).  Returns (transcripts, log-prob scores) in input order."""
        groups = self._prepare_groups(images)
        n = sum(len(idx) for idx, _ in groups)
        words: List[Optional[str]] = [None] * n
        scores = np.empty((n,), np.float32)
        K = beam_size or self.cfg.beam_size
        T = max_len or self.cfg.max_decoder_l
        for idx, x in groups:
            if self._shards:
                labels, sc = self._decode_sharded(x, K, T)
            else:
                labels, sc = self._decode_on(self.device, x, K, T)
            for j, i in enumerate(idx):
                words[i] = vocab.decode(labels[j])
                scores[i] = sc[j]
        return words, scores

    def _decode_on(self, dev: torch.device, x, K: int, T: int):
        """beam_decode of the rows x on dev with its replica of the
        weights: (labels, scores) as numpy."""
        params, stats, trie = self._replicas.get(
            dev, (self.params, self.batch_stats, self._trie))
        with torch.inference_mode(), (torch.cuda.device(dev)
                                      if dev.type == "cuda"
                                      else contextlib.nullcontext()):
            labels, sc = decode.beam_decode(
                params, stats, torch.as_tensor(x).to(dev), self.cfg,
                beam_size=K, max_len=T, trie_table=trie)
            return labels.cpu().numpy(), sc.cpu().numpy()

    def _decode_sharded(self, x, K: int, T: int):
        """x split over the shards, padded by repeating its last row."""
        n, B = len(self._shards), x.shape[0]
        pad = (-B) % n
        if pad:
            tail = x[-1:].repeat(pad, *([1] * (x.ndim - 1))) if isinstance(
                x, torch.Tensor) else np.repeat(x[-1:], pad, 0)
            x = (torch.cat([x, tail]) if isinstance(x, torch.Tensor)
                 else np.concatenate([x, tail]))
        m = x.shape[0] // n
        jobs = [self._pool.submit(self._decode_on, d, x[i * m:(i + 1) * m],
                                  K, T)
                for i, d in enumerate(self._shards)]
        parts = [j.result() for j in jobs]
        labels = np.concatenate([p[0] for p in parts])[:B]
        return labels, np.concatenate([p[1] for p in parts])[:B]

    @torch.inference_mode()
    def score(self, images, transcripts: Sequence[str]) -> np.ndarray:
        """Per-sample gold log-prob of the given transcripts
        (teacher-forced, eval mode), in input order."""
        transcripts = list(transcripts)
        groups = self._prepare_groups(images)
        n = sum(len(idx) for idx, _ in groups)
        if n != len(transcripts):
            raise ValueError(f"{n} images but {len(transcripts)} "
                             "transcripts")
        out = np.empty((n,), np.float32)
        for idx, x in groups:
            targets, targets_eval, _ = vocab.encode_batch(
                [transcripts[i] for i in idx])
            _, gold = train_step.eval_loss_step(
                self.params, self.batch_stats, x, targets, targets_eval,
                self.cfg)
            out[idx] = gold.float().cpu().numpy()
        return out
