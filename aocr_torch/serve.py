"""Micro-batching HTTP serving front end (counterpart of aocr/serve.py).

A threaded HTTP server whose concurrent single-image requests are
coalesced into device batches: the card sees large batched
`AttentionOCR.recognize` calls instead of batch-1 decodes.

- request threads decode bytes -> (32, W) luminance on the host (PIL
  releases the GIL, so ingest parallelizes) and enqueue;
- one batcher thread drains the queue, groups by beam size, waits at
  most `batch_window_ms` to fill up to `max_batch` rows, and runs ONE
  `recognize` per group (mixed widths bucket inside it); only this
  thread calls the model;
- results flow back through per-request events.

Run:  python -m aocr_torch.serve -model_dir train/ -port 8000
POST /recognize       body = encoded image (PNG/JPEG/...); optional
                      ?beam_size=K.  -> {"text": ..., "score": ...}
POST /recognize_batch {"images": [<base64>, ...]} -> {"results": [...]}
GET  /healthz         -> {"status": "ok", ...}
GET  /stats           -> request/batch counters and latency percentiles

The model runs on the CUDA device unless the caller names another
(`serve(..., device="cpu")`, `main(argv, device="cpu")`).  `-num_shards
N` splits each coalesced batch over N local devices
(`AttentionOCR.shard`; 0 = every local device).  `-artifact m.aocrx`
serves a `.aocrx` artifact (`python -m aocr_torch.export`) instead of a
checkpoint: its beam size, dictionary and batch are frozen into it, so
the knobs that would change them raise before the load.
"""

from __future__ import annotations

import argparse
import base64
import json
import queue
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from aocr_torch import data, devices
from aocr_torch.api import AttentionOCR
from aocr_torch.config import Config
from aocr_torch.parallel import mesh
from aocr_torch.utils import trie as trie_lib


class _Pending:
    __slots__ = ("image", "beam_size", "event", "text", "score", "error",
                 "cancelled", "t0")

    def __init__(self, image: np.ndarray, beam_size: int):
        self.image = image
        self.beam_size = beam_size
        self.event = threading.Event()
        self.text: Optional[str] = None
        self.score: Optional[float] = None
        self.error: Optional[str] = None
        self.cancelled = False
        self.t0 = 0.0


class QueueFull(Exception):
    """Raised by submit() when the pending queue exceeds its bound: the
    HTTP layer turns it into 429 (503 while draining), so overload sheds
    instead of piling up."""


class _ArtifactRecognizer:
    """AttentionOCR-shaped facade over an `.aocrx` deployment artifact
    (aocr_torch.export.ExportedRecognizer), so that the batcher serves
    frozen programs and live checkpoints through one code path.

    The artifact fixes the decode mode at export time: exactly one beam
    size (and dictionary constraint) is available.  A single-width
    artifact resizes every ingest image to its one exported width; a
    multi-width artifact serves through ITS width ladder (aspect-
    preserving ingest, widths padded up to the exported steps)."""

    def __init__(self, rec):
        self._rec = rec
        self.device = rec.device
        self.beam_size = int(rec.meta["beam_size"])
        self.cfg = rec.preprocess_config().replace(
            beam_size=self.beam_size)
        b = rec.meta["batch"]
        # a pinned-batch artifact has one device shape (the loader chunks
        # and pads to it), which the batcher must know: ladder-padding
        # request groups on top of that would be wasted decode rows
        self.fixed_device_batch = None if b == "poly" else int(b)
        # a multi-width artifact carries its own width ladder; the batcher
        # pads ingest widths to THE ARTIFACT'S steps (a re-derived ladder
        # could feed widths no program was exported for)
        self.serving_width_ladder = (rec.widths if len(rec.widths) > 1
                                     else None)

    def recognize(self, images, beam_size=None):
        if beam_size is not None and beam_size != self.beam_size:
            raise ValueError(
                f"artifact was exported with beam_size={self.beam_size}; "
                f"{beam_size} is not available")
        # the list passes through: widths may mix (the loader buckets per
        # exported program and returns results in input order)
        return self._rec.recognize(list(images))


class BatchingRecognizer:
    """Coalesce concurrent recognize() calls into device batches.

    Device batches use a fixed ladder of row counts (1, 8, 32, max_batch;
    a group pads up by repeating its last image and the results are
    sliced), so the decode meets a handful of shapes, each planned and
    launched once in warmup, instead of one per arrival pattern.  Under
    keep_aspect_ratio the widths pad up to data.width_ladder's steps the
    same way.  fixed_device_batch: the model runs one pinned device shape
    whatever the group's size (a pinned-batch artifact chunks inside), so
    groups are not padded and warmup runs that one shape."""

    def __init__(self, ocr: AttentionOCR, max_batch: int = 64,
                 batch_window_ms: float = 5.0, max_queue: int = 1024,
                 request_timeout_s: float = 120.0,
                 fixed_device_batch: Optional[int] = None):
        self.ocr = ocr
        self.max_batch = max_batch
        self.fixed_device_batch = fixed_device_batch
        if fixed_device_batch:
            self.ladder = [fixed_device_batch]
        else:
            self.ladder = sorted({n for n in (1, 8, 32, max_batch)
                                  if n <= max_batch})
        # an artifact's own widths where it has several; else
        # data.width_ladder under keep_aspect_ratio; None when the
        # fixed-width preprocessing already yields one width
        override = getattr(ocr, "serving_width_ladder", None)
        if override:
            self.width_ladder = sorted(override)
        else:
            self.width_ladder = (data.width_ladder(ocr.cfg)
                                 if ocr.cfg.keep_aspect_ratio else None)
        self.window_s = batch_window_ms / 1000.0
        self.max_queue = max_queue
        self.request_timeout_s = request_timeout_s
        self.q: "queue.Queue[_Pending]" = queue.Queue()
        self.stats = {"requests": 0, "batches": 0, "batched_rows": 0,
                      "padded_rows": 0, "errors": 0, "timeouts": 0,
                      "rejected": 0, "draining": False}
        self._latencies: list = []  # recent seconds, trimmed at _lat_cap
        self._lat_cap = 4096
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._draining = threading.Event()
        # queued + in-flight requests, guarded by _lock: incremented
        # before enqueue, decremented after the batcher finishes an item
        # (result delivered, errored, or dropped as cancelled); drain()
        # waits on it
        self._inflight = 0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def pad_width(self, img: np.ndarray) -> np.ndarray:
        """Pad an (H, W) image's width up to the next width-ladder step
        with the background value (255 before normalization)."""
        if self.width_ladder is None:
            return img
        w = img.shape[1]
        for step in self.width_ladder:
            if w <= step:
                if w == step:
                    return img
                return np.pad(img, ((0, 0), (0, step - w)),
                              constant_values=255.0)
        return img  # wider than the ladder top (clamped upstream)

    def _pad_to(self, n: int) -> int:
        if self.fixed_device_batch:
            return n  # the device shape is pinned; padding adds nothing
        for step in self.ladder:
            if n <= step:
                return step
        return self.max_batch

    def warmup(self, beam_sizes):
        """Decode once at every (ladder batch size, [width,] beam size), on
        the caller's thread, before traffic: the kernel build and each
        launch plan's first use happen here, not on the batcher thread
        under a request's timeout."""
        h = self.ocr.cfg.image_height
        widths = self.width_ladder or [self.ocr.cfg.image_width]
        for beam in beam_sizes:
            for w in widths:
                dummy = np.zeros((h, w), np.float32)
                for n in self.ladder:
                    self.ocr.recognize([dummy] * n, beam_size=beam)

    def snapshot_stats(self) -> dict:
        """Point-in-time counters and latency percentiles."""
        with self._lock:
            out = dict(self.stats)
            lats = list(self._latencies)
        out["draining"] = self._draining.is_set()
        if lats:
            arr = np.sort(np.asarray(lats, np.float64))
            pick = lambda q: float(  # noqa: E731
                arr[min(int(q * len(arr)), len(arr) - 1)])
            out["latency_s"] = {
                "count": len(arr),
                "p50": round(pick(0.50), 4),
                "p90": round(pick(0.90), 4),
                "p99": round(pick(0.99), 4),
                "max": round(float(arr[-1]), 4),
            }
        return out

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def drain(self, timeout_s: float = 60.0) -> bool:
        """Graceful shutdown, phase 1: refuse new submits (QueueFull ->
        503), let the batcher finish everything already queued.  Returns
        True when the queue fully drained."""
        self._draining.set()
        with self._lock:
            self.stats["draining"] = True
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if self._inflight == 0:
                    return True
            time.sleep(0.02)
        return False

    def close(self, drain_timeout_s: float = 0.0):
        if drain_timeout_s > 0:
            self.drain(drain_timeout_s)
        self._stop.set()
        self._thread.join(timeout=5)

    def submit_async(self, image: np.ndarray, beam_size: int,
                     reserve: int = 1) -> _Pending:
        """Enqueue one image without waiting (see wait()).  `reserve` is
        the number of rows the caller is about to enqueue as a group, so
        a multi-image request fits entirely or is rejected whole."""
        if (self._draining.is_set()
                or self.q.qsize() + reserve > self.max_queue):
            with self._lock:
                self.stats["rejected"] += reserve
            raise QueueFull()
        p = _Pending(self.pad_width(image), beam_size)
        p.t0 = time.monotonic()
        with self._lock:
            self.stats["requests"] += 1
            self._inflight += 1
        self.q.put(p)
        return p

    def wait(self, p: _Pending) -> _Pending:
        """Block until p resolves (or times out); records latency."""
        if not p.event.wait(self.request_timeout_s):
            # mark it dead so the batcher drops it; the batcher may have
            # completed p between the wait expiring and this line, so
            # re-check the event under the lock and keep a finished result
            with self._lock:
                if not p.event.is_set():
                    p.cancelled = True
                    p.error = "timeout"
                    self.stats["timeouts"] += 1
        with self._lock:
            self._latencies.append(time.monotonic() - p.t0)
            if len(self._latencies) > self._lat_cap:
                del self._latencies[: self._lat_cap // 2]
        return p

    def submit(self, image: np.ndarray, beam_size: int) -> _Pending:
        return self.wait(self.submit_async(image, beam_size))

    def _drain_queue(self) -> list:
        """Block for one request, then collect until max_batch or the
        batching window closes."""
        try:
            first = self.q.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.monotonic() + self.window_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                batch.append(self.q.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _run(self):
        while not self._stop.is_set():
            popped = self._drain_queue()
            try:
                self._process(popped)
            finally:
                if popped:
                    with self._lock:
                        self._inflight -= len(popped)

    def _process(self, popped: list):
        batch = [p for p in popped if not p.cancelled]
        if not batch:
            return
        by_beam: dict = {}
        for p in batch:
            by_beam.setdefault(p.beam_size, []).append(p)
        for beam, group in by_beam.items():
            # pad to the ladder size by repeating the last image: one
            # shape per ladder step, results sliced below
            n = len(group)
            target = self._pad_to(n)
            images = [p.image for p in group]
            images += [images[-1]] * (target - n)
            try:
                words, scores = self.ocr.recognize(images, beam_size=beam)
                for p, w, s in zip(group, words[:n], scores[:n]):
                    p.text, p.score = w, float(s)
            except Exception as e:  # the boundary: answer, keep serving
                with self._lock:
                    self.stats["errors"] += len(group)
                for p in group:
                    p.error = f"{type(e).__name__}: {e}"
            with self._lock:
                self.stats["batches"] += 1
                self.stats["batched_rows"] += n
                self.stats["padded_rows"] += target - n
            for p in group:
                p.event.set()


def make_handler(recognizer: BatchingRecognizer, cfg: Config,
                 allowed_beams=None):
    allowed_beams = allowed_beams or {cfg.beam_size}

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # quiet; the stats endpoint instead
            pass

        def do_GET(self):
            if self.path.startswith("/healthz"):
                self._json(200, {"status": "ok", "model_params": True})
            elif self.path.startswith("/stats"):
                self._json(200, recognizer.snapshot_stats())
            else:
                self._json(404, {"error": "not found"})

        def _beam_from_query(self, query: str):
            """The parsed beam size, or None (a response already sent)."""
            beam = cfg.beam_size
            qs = parse_qs(query)
            if "beam_size" in qs:
                try:
                    beam = int(qs["beam_size"][0])
                except ValueError:
                    self._json(400, {"error": "bad beam_size"})
                    return None
                if beam not in allowed_beams:
                    # only warmed beam sizes are served: an unwarmed one
                    # would plan its launches on the batcher thread
                    self._json(400, {
                        "error": "beam_size not enabled on this server",
                        "allowed": sorted(allowed_beams),
                    })
                    return None
            return beam

        def _read_body(self) -> bytes:
            length = int(self.headers.get("Content-Length", 0))
            return self.rfile.read(length) if length > 0 else b""

        def _empty(self, raw: bytes) -> bool:
            """True, after answering 400, where the body is empty."""
            if raw:
                return False
            self._json(400, {"error": "empty body"})
            return True

        def _refuse(self):
            if recognizer.draining:
                self._json(503, {"error": "server draining"})
            else:
                self._json(429, {"error": "queue full, retry later"})

        def _do_batch(self, query: str, raw: bytes):
            """POST /recognize_batch: {"images": [<base64>, ...]} -> one
            coalesced device batch, results in input order."""
            beam = self._beam_from_query(query)
            if beam is None or self._empty(raw):
                return
            try:
                items = json.loads(raw)["images"]
                if not isinstance(items, list) or not items:
                    raise ValueError("no images")
                blobs = [base64.b64decode(s) for s in items]
            except (ValueError, KeyError, TypeError):
                self._json(400, {"error": 'expected {"images": '
                                          '[<base64>, ...]}'})
                return
            imgs = []
            for i, blob in enumerate(blobs):
                img = data.load_and_preprocess(blob, cfg)
                if img is None:
                    self._json(400, {"error": f"cannot decode image {i}"})
                    return
                imgs.append(img)
            pending = []
            try:
                for img in imgs:
                    pending.append(recognizer.submit_async(
                        img, beam, reserve=len(imgs) - len(pending)))
            except QueueFull:
                for p in pending:  # all or nothing: drop the partial group
                    p.cancelled = True
                self._refuse()
                return
            results = [recognizer.wait(p) for p in pending]
            self._json(200, {"results": [
                {"error": p.error} if p.error is not None
                else {"text": p.text, "score": p.score}
                for p in results
            ]})

        def do_POST(self):
            parsed = urlparse(self.path)
            # the body is read before any answer: an answer that left it
            # unread would have the socket's close reset the connection,
            # and the client could lose the answer
            raw = self._read_body()
            if parsed.path == "/recognize_batch":
                self._do_batch(parsed.query, raw)
                return
            if parsed.path != "/recognize":
                self._json(404, {"error": "not found"})
                return
            beam = self._beam_from_query(parsed.query)
            if beam is None or self._empty(raw):
                return
            img = data.load_and_preprocess(raw, cfg)
            if img is None:
                self._json(400, {"error": "cannot decode image"})
                return
            try:
                p = recognizer.submit(img, beam)
            except QueueFull:
                self._refuse()
                return
            if p.error is not None:
                self._json(500, {"error": p.error})
            else:
                self._json(200, {"text": p.text, "score": p.score})

    return Handler


def serve(model_dir: Optional[str] = None, host: str = "0.0.0.0",
          port: int = 8000,
          max_batch: int = 64, batch_window_ms: float = 5.0,
          cfg: Optional[Config] = None, warmup: bool = True,
          warmup_beams=(), max_queue: int = 1024,
          request_timeout_s: float = 120.0,
          ready_event: Optional[threading.Event] = None,
          server_box: Optional[list] = None,
          dictionary_path: Optional[str] = None,
          allow_digit_prefix: bool = False,
          num_shards: int = 1,
          artifact: Optional[str] = None,
          device=None):
    """Load the checkpoint in model_dir, or the `.aocrx` artifact, on
    `device` (default: the CUDA device), warm the ladder's shapes, and
    serve until shut down (a SIGTERM or SIGINT drains first).  server_box,
    when given, receives (httpd, recognizer) before ready_event is set."""
    # the flags first, before the checkpoint load, so a typo fails fast
    if (model_dir is None) == (artifact is None):
        raise ValueError("pass exactly one of -model_dir / -artifact")
    if artifact is not None:
        # the artifact froze its decode mode at export time; these knobs
        # have nothing to act on, so they raise instead of being ignored
        frozen = {"-dictionary": dictionary_path,
                  "-num_shards != 1": num_shards != 1 or None,
                  "-beam_size/cfg": cfg, "-warmup_beams": warmup_beams or
                  None}
        bad = [k for k, v in frozen.items() if v]
        if bad:
            raise ValueError(
                f"{', '.join(bad)} cannot be combined with -artifact: "
                "beam size, dictionary, and sharding are frozen into the "
                "artifact at export time")
    if num_shards < 0:
        raise ValueError(
            f"-num_shards must be >= 0 (0 = all local devices), "
            f"got {num_shards}")
    if num_shards > 1:
        have = len(mesh.local_devices(devices.resolve(device)))
        if num_shards > have:
            raise ValueError(
                f"-num_shards {num_shards} but only {have} local devices")
    if artifact is not None:
        from aocr_torch.export import ExportedRecognizer

        ocr = _ArtifactRecognizer(ExportedRecognizer.load(artifact, device))
        model_dir = artifact  # for the startup banner
        print(f"artifact: beam_size={ocr.beam_size}, "
              f"dictionary={ocr._rec.meta['use_dictionary']}, "
              f"batch={ocr._rec.meta['batch']}")
    else:
        ocr = AttentionOCR.load(model_dir, cfg=cfg, device=device)
    if num_shards != 1:
        # each coalesced batch split over the devices, the weights
        # replicated, no communication in the decode
        ocr.shard(None if num_shards == 0 else num_shards)
        print(f"sharded inference over {ocr.num_shards} devices")
    if dictionary_path:
        # every served transcript is a prefix-trie walk over the word
        # list (the reference's -use_dictionary); load_dictionary caches
        # the built DAWG next to the word list
        table = trie_lib.load_dictionary(
            dictionary_path, allow_digit_prefix=allow_digit_prefix)
        ocr.set_dictionary_table(table)
        print(f"dictionary: {table.shape[0]} trie nodes from "
              f"{dictionary_path}")
    recognizer = BatchingRecognizer(
        ocr, max_batch, batch_window_ms, max_queue=max_queue,
        request_timeout_s=request_timeout_s,
        fixed_device_batch=getattr(ocr, "fixed_device_batch", None))
    allowed_beams = {ocr.cfg.beam_size} | set(warmup_beams)
    if warmup:
        print(f"warming up decode for batch sizes {recognizer.ladder} x "
              f"beams {sorted(allowed_beams)} ...")
        recognizer.warmup(sorted(allowed_beams))
    handler = make_handler(recognizer, ocr.cfg, allowed_beams)

    class Server(ThreadingHTTPServer):
        # the stdlib default listen backlog of 5 resets concurrent clients
        # under load
        request_queue_size = 256
        daemon_threads = True

    httpd = Server((host, port), handler)
    if server_box is not None:
        server_box.append((httpd, recognizer))
    print(f"serving {model_dir} on {host}:{httpd.server_address[1]} "
          f"(max_batch={max_batch}, window={batch_window_ms}ms, "
          f"device {ocr.device})")

    # Graceful drain on SIGTERM/SIGINT: refuse new work (503), let the
    # batcher flush everything queued, then stop the accept loop.  Signal
    # handlers install only on the main thread.
    def _graceful(signum, _frame):
        print(f"signal {signum}: draining ...", flush=True)

        def _worker():
            recognizer.drain(timeout_s=request_timeout_s)
            httpd.shutdown()

        threading.Thread(target=_worker, daemon=True).start()

    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, _graceful)
        signal.signal(signal.SIGINT, _graceful)
    if ready_event is not None:
        ready_event.set()
    try:
        httpd.serve_forever()
    finally:
        recognizer.close()
        httpd.server_close()


def main(argv=None, device=None):
    """The CLI: parse argv (default sys.argv[1:]) as aocr.serve does and
    serve on `device` (default: the CUDA device)."""
    p = argparse.ArgumentParser(
        prog="aocr_torch.serve", description="micro-batching OCR HTTP server")
    p.add_argument("-model_dir", "--model_dir", default=None)
    p.add_argument("-artifact", "--artifact", default=None,
                   help=".aocrx deployment artifact "
                        "(python -m aocr_torch.export)")
    p.add_argument("-host", "--host", default="0.0.0.0")
    p.add_argument("-port", "--port", type=int, default=8000)
    p.add_argument("-max_batch", "--max_batch", type=int, default=64)
    p.add_argument("-batch_window_ms", "--batch_window_ms", type=float,
                   default=5.0)
    p.add_argument("-beam_size", "--beam_size", type=int, default=None)
    p.add_argument("-warmup_beams", "--warmup_beams", default="",
                   help="extra beam sizes to warm and allow, "
                        "comma-separated (e.g. 1,5)")
    p.add_argument("-no_warmup", "--no_warmup", dest="warmup",
                   action="store_false", default=True)
    p.add_argument("-max_queue", "--max_queue", type=int, default=1024)
    p.add_argument("-request_timeout_s", "--request_timeout_s", type=float,
                   default=120.0)
    p.add_argument("-dictionary", "--dictionary", default=None,
                   help="word-list file; constrains every decode to the "
                        "dictionary trie (the CLI's -use_dictionary)")
    p.add_argument("-allow_digit_prefix", "--allow_digit_prefix",
                   action="store_true", default=False)
    p.add_argument("-num_shards", "--num_shards", type=int, default=1,
                   help="shard each device batch across N local devices "
                        "(0 = all)")
    args = p.parse_args(argv)
    cfg = Config(beam_size=args.beam_size) if args.beam_size else None
    beams = tuple(int(b) for b in args.warmup_beams.split(",") if b)
    serve(args.model_dir, args.host, args.port, args.max_batch,
          args.batch_window_ms, cfg, warmup=args.warmup,
          warmup_beams=beams, max_queue=args.max_queue,
          request_timeout_s=args.request_timeout_s,
          dictionary_path=args.dictionary,
          allow_digit_prefix=args.allow_digit_prefix,
          num_shards=args.num_shards, artifact=args.artifact,
          device=device)


if __name__ == "__main__":
    main()
