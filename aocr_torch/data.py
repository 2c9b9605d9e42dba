"""Data pipeline: manifest reader, image decode/resize, width-bucketed batching.

Behavioral parity with the reference DataGen
(`reference src/data/data_gen.lua:15-154`):

- manifest: one `image_path label` pair per whitespace-split line; paths are
  relative to `data_base_dir` (absolute paths work with base dir "/")
- lazy per-image decode with skip-on-error (pcall guard, data_gen.lua:67,84)
- RGB -> luminance * 255 (data_gen.lua:71), aspect ratio clamped to
  [min_aspect_ratio, max_aspect_ratio] (:74-76), then — reproducing the
  reference's hard-coded override (:77-78) — width forced to `image_width`
  (default 100) unless cfg.keep_aspect_ratio, and bilinear-resized to
  (32, W)
- decoded images and encoded labels are cached on first touch (:80-81)
- width-bucketed batching: a batch is emitted when a width bucket reaches
  batch_size (:92-121); after the cursor sweeps the manifest, remaining
  partial buckets are flushed one per call (:125-153); when everything is
  flushed the cursor resets and `next_batch` returns None (epoch end)
- batch payload {images, targets, targets_eval, num_nonzeros, img_paths}
  with targets=[GO, c1..cn] / targets_eval=[c1..cn, EOS], PAD-filled,
  num_nonzeros = sum(len+1) (:106-117)

Bucketing by exact width keeps every batch one shape.  Decode runs
host-side (PIL for image files, np.load for `.npy` arrays (H, W) or
(H, W, C), uint8 or float, which need no PIL); resize and grayscale
conversion are vectorized numpy (bilinear, matching torch.image.scale's
default) or the native library.

The port's own copy of aocr/data.py: the same batch stream from the same
manifest and seed (tests/test_torch_port_eval.py).  Under
`-device_preprocess` the host only decodes (`load_raw`) and pads the raw
pixels into one buffer (`pack_raw`); aocr_torch.preprocess does the
luminance and resize on the device.
"""

from __future__ import annotations

import os
import random
from typing import Dict, Iterator, List, NamedTuple, Optional

import numpy as np

from aocr_torch import vocab
from aocr_torch.config import Config
from aocr_torch.utils import native


class Batch(NamedTuple):
    images: Optional[np.ndarray]  # (B, 32, W, 1) float32 in [0, 255];
    # None in device-preprocess mode (raw/sizes/out_w set instead)
    targets: np.ndarray  # (B, T) int32 [GO, c1..cn] PAD-filled
    targets_eval: np.ndarray  # (B, T) int32 [c1..cn, EOS] PAD-filled
    num_nonzeros: int
    img_paths: List[str]
    # Device-preprocess payload (cfg.device_preprocess): the host decoded
    # the bytes but did no pixel math; preprocess.preprocess_varsize
    # turns it into (B, 32, out_w, 1) on the device.
    raw: Optional[np.ndarray] = None  # (B, Hp, Wp, 3) uint8|float32
    sizes: Optional[np.ndarray] = None  # (B, 2) int32 true (h, w)
    out_w: Optional[int] = None  # resize target width of this bucket

    @property
    def rows(self) -> int:
        return self.targets.shape[0]


def _rgb_to_luminance(img: np.ndarray) -> np.ndarray:
    """ITU-R 601 luma — the same weights torch's image.rgb2y uses."""
    if img.ndim == 2:
        return img
    if img.shape[-1] == 1:
        return img[..., 0]
    return (
        0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    )


def _bilinear_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Vectorized bilinear resample of a (H, W) array (align_corners=False
    convention, matching torch image.scale / jax.image.resize 'linear')."""
    in_h, in_w = img.shape
    if (in_h, in_w) == (out_h, out_w):
        return img.astype(np.float32)
    ys = (np.arange(out_h) + 0.5) * (in_h / out_h) - 0.5
    xs = (np.arange(out_w) + 0.5) * (in_w / out_w) - 0.5
    y0 = np.clip(np.floor(ys), 0, in_h - 1).astype(np.int64)
    x0 = np.clip(np.floor(xs), 0, in_w - 1).astype(np.int64)
    y1 = np.minimum(y0 + 1, in_h - 1)
    x1 = np.minimum(x0 + 1, in_w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :]
    im = img.astype(np.float32)
    top = im[y0][:, x0] * (1 - wx) + im[y0][:, x1] * wx
    bot = im[y1][:, x0] * (1 - wx) + im[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def _target_width(w: int, h: int, cfg: Config) -> int:
    aspect = np.clip(w / h, cfg.min_aspect_ratio, cfg.max_aspect_ratio)
    if cfg.keep_aspect_ratio:
        return int(np.ceil(aspect * cfg.image_height))
    return cfg.image_width  # reference hard-codes 100 (data_gen.lua:78)


def _snap_pad(img: np.ndarray, cfg: Config) -> np.ndarray:
    """-snap_width_ladder: background-pad an aspect-resized (H, W) image's
    width UP to the next shared-ladder step — the identical treatment the
    serving batcher gives ingest (serve._Batcher.pad_width), so training,
    eval, and serving all see the same pixel geometry.  Bounds the
    per-width compiled-program count: natural word widths are near-unique
    (one program per distinct width otherwise — a 3k-word corpus spans
    ~180), the ladder has <=9 steps."""
    if not (cfg.keep_aspect_ratio and cfg.snap_width_ladder):
        return img
    w = img.shape[1]
    for step in width_ladder(cfg):
        if w <= step:
            if w == step:
                return img
            return np.pad(img, ((0, 0), (0, step - w)),
                          constant_values=255.0)
    return img  # wider than the ladder top (clamped upstream)


def width_ladder(cfg: Config) -> List[int]:
    """Fixed width steps covering every clamped-aspect width the
    preprocessing can produce (x1.5 geometric steps, endpoint-clamped).
    Under -keep_aspect_ratio each distinct image width is a distinct
    compiled program; padding widths UP to this ladder bounds the program
    count.  The JAX package's serving batcher and multi-width artifact
    export use the same steps."""
    h = cfg.image_height
    lo = max(int(h * cfg.min_aspect_ratio), 8)
    # ceil, matching _target_width: with int() the widest clamped aspect
    # could preprocess to ceil(h*max_ar) = hi + 1 and bypass the ladder
    hi = int(np.ceil(h * cfg.max_aspect_ratio))
    steps = [lo]
    while steps[-1] < hi:
        steps.append(min(int(steps[-1] * 1.5), hi))
    return steps


def images_to_arrays(items, cfg: Config) -> List[np.ndarray]:
    """Normalize a recognize()-style input into a list of (H, W, 1)
    float32 arrays: a bare path string, a stacked (B, H, W[, 1]) array,
    a list of paths (decoded + preprocessed via cfg), or a list of
    (H, W[, 1]) arrays — widths may mix.  The ONE home for the
    accepted-inputs contract of the library API (aocr_torch.api), as
    aocr.api and aocr.export take it."""
    if isinstance(items, str):
        items = [items]  # a bare path is one image, not N characters
    if hasattr(items, "ndim"):
        a = np.asarray(items, np.float32)
        if a.ndim == 3:
            a = a[..., None]
        assert a.ndim == 4, f"bad image batch shape {a.shape}"
        return list(a)
    out = []
    for it in items:
        if isinstance(it, str):
            img = load_and_preprocess(it, cfg)
            if img is None:
                raise ValueError(f"cannot decode image {it}")
            out.append(img[..., None])
        else:
            a = np.asarray(it, np.float32)
            if a.ndim == 2:
                a = a[..., None]
            assert a.ndim == 3, f"expected (H, W[, 1]) image, got {a.shape}"
            out.append(a)
    return out


def load_and_preprocess(
    path, cfg: Config
) -> Optional[np.ndarray]:
    """Decode one image -> (32, W) float32 luminance in [0, 255], or None on
    any decode failure (the reference's pcall-skip behavior).

    path: a filesystem path, or raw encoded image bytes (serving ingest)
    — PIL decodes either."""
    try:
        if isinstance(path, (bytes, bytearray)):
            import io

            path = io.BytesIO(path)
        if isinstance(path, str) and path.endswith(".npy"):
            arr = np.load(path)
            if arr.ndim == 3:
                arr = _rgb_to_luminance(arr)
            if arr.ndim != 2 or arr.size == 0:
                return None  # malformed array: skip, don't crash the epoch
            img = arr.astype(np.float32)
            if img.max() <= 1.0 + 1e-6:
                img = img * 255.0
        else:
            from PIL import Image

            with Image.open(path) as im:
                rgb = im.convert("RGB")
                w, h = rgb.size
                if h == 0 or w == 0:
                    return None
                img_w = _target_width(w, h, cfg)
                # Fast path: raw bytes -> C++ luminance+resize with the GIL
                # released (decode threads scale); numpy fallback below.
                out = native.luminance_resize_u8(
                    rgb.tobytes(), h, w, 3, cfg.image_height, img_w
                )
                if out is not None:
                    return _snap_pad(out, cfg)
                arr = np.asarray(rgb, np.float32) / 255.0
            img = _rgb_to_luminance(arr) * 255.0
    except Exception:
        return None
    h, w = img.shape
    if h == 0 or w == 0:
        return None
    img_w = _target_width(w, h, cfg)
    out = native.luminance_resize(img, cfg.image_height, img_w)
    if out is None:
        out = _bilinear_resize(img, cfg.image_height, img_w)
    return _snap_pad(out, cfg)


def load_raw(path: str, cfg: Config):
    """Device-preprocess decode: bytes -> raw pixels, no host pixel math.

    Returns (raw (h, w, c) uint8|float32, target width) or None on a
    decode failure.  Luminance and resize happen later on the device
    (aocr_torch.preprocess.preprocess_varsize)."""
    try:
        if path.endswith(".npy"):
            arr = np.load(path)
            if arr.ndim == 2:
                arr = arr[..., None]
            if arr.ndim != 3 or arr.size == 0:
                return None  # malformed array: skip, don't crash the epoch
            raw = arr.astype(np.float32)
            if raw.max() <= 1.0 + 1e-6:
                raw = raw * 255.0
        else:
            from PIL import Image

            with Image.open(path) as im:
                raw = np.asarray(im.convert("RGB"))  # (h, w, 3) uint8
    except Exception:
        return None
    h, w = raw.shape[:2]
    if h == 0 or w == 0:
        return None
    return raw, _target_width(w, h, cfg)


def pack_raw(raws: List[np.ndarray]):
    """Pad raw images (bottom/right, zeros) into one (B, Hp, Wp, 3)
    buffer and (B, 2) true sizes for preprocess.preprocess_varsize.  The
    buffer's dims round up to multiples of (16, 64), as aocr.data's do."""
    up = lambda n, m: ((n + m - 1) // m) * m  # noqa: E731
    sizes = np.array([r.shape[:2] for r in raws], np.int32)
    hp = up(int(sizes[:, 0].max()), 16)
    wp = up(int(sizes[:, 1].max()), 64)
    any_float = any(r.dtype != np.uint8 for r in raws)
    dt = np.float32 if any_float else np.uint8
    buf = np.zeros((len(raws), hp, wp, 3), dt)
    for i, r in enumerate(raws):
        if r.shape[-1] == 1:
            r = np.repeat(r, 3, axis=-1)  # luma of replicated gray = gray
        buf[i, : r.shape[0], : r.shape[1]] = r[..., :3]
    return buf, sizes


class DataGen:
    """Width-bucketed batch generator over a `path label` manifest."""

    def __init__(self, data_base_dir: str, data_path: str, cfg: Config,
                 rng: Optional[random.Random] = None, log=None):
        self.cfg = cfg
        self.data_base_dir = data_base_dir
        self.rng = rng or random.Random(cfg.seed)
        self._log = log or print
        manifest = data_path
        if not os.path.exists(manifest):
            manifest = os.path.join(data_base_dir, data_path)
        if not os.path.exists(manifest):
            raise FileNotFoundError(f"Data file {data_path} not found")
        self.lines: List[List] = []
        # Labels are validated/truncated HERE, once: both checks are
        # path-independent, so doing them per-epoch in _load_record wasted
        # a full image decode per bad-label record per sweep.
        # - out-of-vocab labels: skipped like a bad image (the reference
        #   would assert at batch time, utils.lua str2numlist)
        # - over-length labels: fair truncation cap (closes the reference's
        #   open TODO, README.md:12 — it asserts at model.lua:264)
        cap = cfg.max_decoder_l - 1
        n_oov = n_trunc = 0
        with open(manifest) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 2:
                    continue
                label = parts[1]
                try:
                    vocab.encode(label)
                except ValueError:
                    n_oov += 1
                    continue
                if len(label) > cap:
                    n_trunc += 1
                    label = label[:cap]
                # [path, label, cached_img]
                self.lines.append([parts[0], label, None])
        if n_oov:
            self._log(f"Warning: skipped {n_oov} manifest lines with "
                      f"out-of-vocab labels")
        if n_trunc:
            self._log(f"Warning: truncating {n_trunc} labels longer than "
                      f"{cap} chars to fit max_decoder_l")
        self.cursor = 0
        self.buffer: Dict[int, List] = {}
        self._device = cfg.device_preprocess
        self._loader = load_raw if self._device else load_and_preprocess
        # Multi-host lockstep requires identical target shapes on every
        # host each step: pad every batch's targets to max_decoder_l
        # instead of the batch max (aocr/parallel/multihost.py).
        self._pad_targets_to = (
            cfg.max_decoder_l if (cfg.multihost or cfg.pad_targets)
            else None)
        self._pool = None
        self._pending: Dict[int, object] = {}  # id(rec) -> Future
        if cfg.decode_workers > 0:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(
                max_workers=cfg.decode_workers,
                thread_name_prefix="aocr-decode",
            )

    def shard(self, shard_id: int, num_shards: int) -> "DataGen":
        """Keep only this host's slice of the manifest (multi-host data
        parallelism: each process feeds its own rows).  Returns self."""
        assert 0 <= shard_id < num_shards
        self.lines = self.lines[shard_id::num_shards]
        self.cursor = 0
        self.buffer.clear()
        self._pending.clear()  # abandon decodes of rows we no longer own
        return self

    def close(self) -> None:
        """Release the decode thread pool (also called by __del__)."""
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None
            self._pending.clear()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def size(self) -> int:
        return len(self.lines)

    def shuffle(self) -> None:
        self.rng.shuffle(self.lines)

    def _emit(self, img_w: int) -> Batch:
        entries = self.buffer.pop(img_w)
        B = len(entries)
        cfg = self.cfg
        labels = [e[1] for e in entries]
        paths = [e[2] for e in entries]
        targets, targets_eval, nnz = vocab.encode_batch(
            labels, pad_to=self._pad_targets_to
        )
        if self._device:
            return Batch(None, targets, targets_eval, nnz, paths,
                         *pack_raw([e[0] for e in entries]), out_w=img_w)
        images = np.empty((B, cfg.image_height, img_w, 1), np.float32)
        for i, (img, _label, _path) in enumerate(entries):
            images[i, :, :, 0] = img
        return Batch(images, targets, targets_eval, nnz, paths)

    def _schedule_lookahead(self) -> None:
        """Submit decodes for upcoming records to the thread pool (PIL
        releases the GIL, so decodes run concurrently with batching and
        with each other).  Keyed by record identity so shuffles are safe."""
        window = self.cfg.decode_workers * 4
        for j in range(self.cursor, min(self.cursor + window,
                                        len(self.lines))):
            rec = self.lines[j]
            needs_decode = rec[2] is None or rec[2] is self._UNCACHED
            if needs_decode and id(rec) not in self._pending:
                path = os.path.join(self.data_base_dir, rec[0])
                self._pending[id(rec)] = self._pool.submit(
                    self._loader, path, self.cfg)

    def _load_record(self, rec) -> Optional[np.ndarray]:
        """Decode one manifest record.  Returns the image or None
        (undecodable — the reference's pcall-skip).  Labels were already
        validated/truncated at manifest load."""
        fut = self._pending.pop(id(rec), None)
        if fut is not None:
            img = fut.result()
        else:
            img = self._loader(
                os.path.join(self.data_base_dir, rec[0]), self.cfg)
        return img

    # Record cache states: None = not (successfully) decoded yet — failures
    # stay None and are retried next sweep, matching the reference's
    # per-epoch pcall (data_gen.lua:67); _UNCACHED = decodable but not kept
    # in RAM (cfg.cache_images=False); ndarray = cached decoded image
    # (reference data_gen.lua:80).
    _UNCACHED = "ok"

    def next_batch(self, batch_size: int) -> Optional[Batch]:
        while self.cursor < len(self.lines):
            rec = self.lines[self.cursor]
            img = None
            if rec[2] is None:
                if self._pool is not None:
                    self._schedule_lookahead()
                img = self._load_record(rec)
                if img is None:
                    pass  # retried on the next sweep (reference behavior)
                elif self.cfg.cache_images:
                    rec[2] = img
                else:
                    rec[2] = self._UNCACHED
            elif rec[2] is self._UNCACHED:
                if self._pool is not None:
                    self._schedule_lookahead()
                img = self._load_record(rec)
            else:  # cached: ndarray (host mode) or (raw, width) tuple
                img = rec[2]
            if img is None:
                self.cursor += 1
                continue
            if self._device:
                payload, img_w = img  # (raw pixels, target width)
            else:
                payload, img_w = img, img.shape[1]
            self.cursor += 1
            self.buffer.setdefault(img_w, []).append(
                (payload, rec[1], rec[0]))
            if len(self.buffer[img_w]) == batch_size:
                return self._emit(img_w)
        # cursor exhausted: flush partial buckets one per call
        if not self.buffer:
            self.cursor = 0
            return None
        img_w = next(iter(self.buffer))
        return self._emit(img_w)

    def epoch(self, batch_size: int) -> Iterator[Batch]:
        while True:
            b = self.next_batch(batch_size)
            if b is None:
                return
            yield b


def prefetched(iterator: Iterator[Batch], depth: int) -> Iterator[Batch]:
    """Run `iterator` in a background thread, keeping up to `depth` batches
    ready — host-side decode/bucketing overlaps device compute.  depth<=0
    is a passthrough.  Worker exceptions re-raise in the consumer.

    If the consumer abandons the generator early (exception / break), the
    worker is told to stop and joined before control returns, so the
    underlying DataGen is never left with a concurrent mutator."""
    if depth <= 0:
        yield from iterator
        return
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not _put(item):
                    return
            _put(done)
        except BaseException as e:  # propagate to the consumer
            _put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        # Wait until the worker has actually finished: returning with it
        # still inside next_batch would hand the caller a DataGen with a
        # live concurrent mutator (the next epoch/validation would then
        # race it).  _put observes `stop` within 0.1 s, so this is bounded
        # by one in-flight next_batch call; drain the queue anyway in case
        # a consumer-side error left it full.
        while t.is_alive():
            try:
                q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=0.2)
