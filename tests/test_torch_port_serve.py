"""aocr_torch.serve, the micro-batching HTTP server, on the CPU: held
against aocr.serve on one checkpoint (the same PNG requests give equal
transcripts and scores within 1e-4, float32), and tests/test_serve.py's
cases that need no artifact and no shards, on the port's server
(device="cpu", so every kernel wrapper takes its plain version).  The
option not ported, -artifact, raises before any checkpoint load, and
-num_shards is validated before it (tests/test_torch_port_parallel.py
serves through AttentionOCR.shard)."""

import base64
import io
import json
import re
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from aocr.api import AttentionOCR as JaxOCR
from aocr.config import Config
from aocr_torch import serve as tserve
from aocr_torch.api import AttentionOCR
from aocr_torch.config import Config as TConfig
from tests import synth
from tests.test_torch_port_api import _sharpened

KW = dict(input_feed=True, encoder_num_hidden=16, target_embedding_size=8,
          max_decoder_l=8, image_width=32)
CFG = Config(**KW)
TCFG = TConfig(**KW)


def _start(serve_fn, timeout=120, **kw):
    """serve_fn(**kw) on a daemon thread; returns (base url, httpd,
    recognizer)."""
    ready = threading.Event()
    box = []
    t = threading.Thread(target=serve_fn, daemon=True, kwargs=dict(
        host="127.0.0.1", port=0, ready_event=ready, server_box=box, **kw))
    t.start()
    assert ready.wait(timeout), "server did not start"
    httpd, recognizer = box[0]
    return f"http://127.0.0.1:{httpd.server_address[1]}", httpd, recognizer


def _stop(httpd, recognizer):
    httpd.shutdown()
    recognizer.close()


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """An aocr checkpoint of the tiny model: the JAX package's init,
    scaled so that transcripts depend on the image."""
    d = str(tmp_path_factory.mktemp("serve_model"))
    _sharpened(JaxOCR.create(CFG)).save(d)
    return d


@pytest.fixture(scope="module")
def server(model_dir):
    base, httpd, recognizer = _start(
        tserve.serve, model_dir=model_dir, batch_window_ms=80.0, cfg=TCFG,
        warmup_beams=(2,), device="cpu")
    yield base, recognizer
    _stop(httpd, recognizer)


def _png_bytes(word: str, width: int = 32) -> bytes:
    from PIL import Image

    arr = synth.render_word(word, 32, width).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _post(url: str, body: bytes):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def _post_all(url: str, bodies):
    """POST every body at once, one thread each; the answers in order."""
    results = [None] * len(bodies)

    def post_one(i):
        results[i] = _post(url, bodies[i])

    threads = [threading.Thread(target=post_one, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    return results


def test_port_server_matches_aocr_server(model_dir):
    """The slice as a whole: aocr.serve and aocr_torch.serve on the same
    checkpoint answer the same PNG posts (single and batched, greedy)
    with equal transcripts and scores within 1e-4."""
    from aocr import serve as jserve

    words = ["ab", "cd", "e1", "xyz", "q0"]
    bodies = [_png_bytes(w, W) for w, W in zip(words, (32, 32, 48, 20, 32))]
    batch = json.dumps({"images": [base64.b64encode(b).decode()
                                   for b in bodies]}).encode()
    answers = []
    for serve_fn, extra in ((jserve.serve, {}),
                            (tserve.serve, {"device": "cpu"})):
        base, httpd, rec = _start(
            serve_fn, model_dir=model_dir, max_batch=8,
            batch_window_ms=20.0, cfg=None, warmup=False, **extra)
        try:
            singles = [_post(f"{base}/recognize", b) for b in bodies[:2]]
            status, payload = _post(f"{base}/recognize_batch", batch)
            assert status == 200 and all(s == 200 for s, _ in singles)
            answers.append([p for _, p in singles] + payload["results"])
        finally:
            _stop(httpd, rec)
    want, got = answers
    assert [a["text"] for a in got] == [a["text"] for a in want]
    np.testing.assert_allclose([a["score"] for a in got],
                               [a["score"] for a in want], rtol=0,
                               atol=1e-4)


def test_recognize_and_batching(server):
    base, recognizer = server
    words = ["ab", "cd", "ef", "gh", "ij", "kl"]
    results = _post_all(f"{base}/recognize", [_png_bytes(w) for w in words])
    for status, payload in results:
        assert status == 200
        assert isinstance(payload["text"], str)
        assert payload["score"] <= 0.0
    # every request went through a batch, and with an 80 ms window the 6
    # concurrent posts needed fewer batches than rows
    stats = recognizer.snapshot_stats()
    assert stats["requests"] >= len(words)
    assert stats["batched_rows"] >= len(words)
    assert stats["batches"] < stats["batched_rows"]
    lat = stats["latency_s"]
    assert lat["count"] >= len(words)
    assert 0 <= lat["p50"] <= lat["p99"] <= lat["max"]
    # each served transcript is the model's own on the decoded image
    imgs = [synth.render_word(w, 32, 32).astype(np.float32) for w in words]
    direct, _ = recognizer.ocr.recognize(imgs)
    assert [p["text"] for _, p in results] == direct


def test_health_stats_and_errors(server):
    base, _ = server
    with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
        assert r.status == 200 and json.loads(r.read())["status"] == "ok"
    with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
        assert "requests" in json.loads(r.read())
    # undecodable body -> 400
    req = urllib.request.Request(f"{base}/recognize", data=b"not an image",
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400
    # unknown path -> 404
    with pytest.raises(urllib.error.HTTPError) as e404:
        urllib.request.urlopen(f"{base}/nope", timeout=30)
    assert e404.value.code == 404
    # a warmed beam_size override answers; an unwarmed one is refused
    status, payload = _post(f"{base}/recognize?beam_size=2",
                            _png_bytes("zz"))
    assert status == 200 and isinstance(payload["text"], str)
    req = urllib.request.Request(f"{base}/recognize?beam_size=7",
                                 data=_png_bytes("zz"), method="POST")
    with pytest.raises(urllib.error.HTTPError) as e2:
        urllib.request.urlopen(req, timeout=30)
    assert e2.value.code == 400
    assert json.loads(e2.value.read())["allowed"] == [1, 2]


def test_stats_endpoint_has_percentiles(server):
    base, _ = server
    _post(f"{base}/recognize", _png_bytes("ab"))
    with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
        snap = json.loads(r.read())
    assert "latency_s" in snap and "p99" in snap["latency_s"]
    assert snap["draining"] is False
    assert snap["errors"] == 0 and snap["timeouts"] == 0


def test_graceful_drain_flushes_queue_then_rejects():
    """Drain (what SIGTERM starts): everything already queued is decoded
    and returned; new submits are refused."""
    ocr = AttentionOCR.create(TCFG, device="cpu")
    rec = tserve.BatchingRecognizer(ocr, max_batch=8, batch_window_ms=50.0,
                                    request_timeout_s=120.0)
    try:
        rec.warmup([1])
        img = synth.render_word("ab", 32, 32).astype(np.float32)
        results = []
        threads = [threading.Thread(target=lambda: results.append(
            rec.submit(img, 1))) for _ in range(5)]
        for t in threads:
            t.start()
        assert rec.drain(timeout_s=60.0), "queue did not drain"
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        assert len(results) == 5
        assert all(p.error is None and isinstance(p.text, str)
                   for p in results)
        with pytest.raises(tserve.QueueFull):
            rec.submit(img, 1)
        assert rec.snapshot_stats()["draining"] is True
    finally:
        rec.close()


def test_drain_answers_503_over_http(model_dir):
    base, httpd, rec = _start(tserve.serve, model_dir=model_dir,
                              max_batch=8, cfg=TCFG, warmup=False,
                              device="cpu")
    try:
        assert _post(f"{base}/recognize", _png_bytes("ab"))[0] == 200
        assert rec.drain(timeout_s=30.0)
        req = urllib.request.Request(f"{base}/recognize",
                                     data=_png_bytes("ab"), method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 503
        assert json.loads(e.value.read()) == {"error": "server draining"}
    finally:
        _stop(httpd, rec)


def test_serve_with_dictionary(tmp_path, model_dir):
    """-dictionary FILE constrains every served transcript to the word
    list (the reference's -use_dictionary as a serving feature)."""
    dict_file = tmp_path / "dict.txt"
    dictionary = ["ab", "cd", "zz", "a", "c", "z"]
    dict_file.write_text("\n".join(dictionary) + "\n")
    base, httpd, rec = _start(
        tserve.serve, model_dir=model_dir, batch_window_ms=20.0, cfg=TCFG,
        warmup_beams=(2,), dictionary_path=str(dict_file), device="cpu")
    try:
        assert rec.ocr.dictionary_table is not None
        for word in ("ab", "qq"):  # qq is out of the dictionary on purpose
            for beam in ("", "?beam_size=2"):
                status, payload = _post(f"{base}/recognize{beam}",
                                        _png_bytes(word))
                assert status == 200
                assert payload["text"] in dictionary + [""], payload
    finally:
        _stop(httpd, rec)


def test_width_ladder_under_keep_aspect_ratio():
    """-keep_aspect_ratio serving pads widths up to a fixed ladder, so
    only the warmed shapes are ever decoded."""
    cfg = TCFG.replace(keep_aspect_ratio=True)
    ocr = AttentionOCR.create(cfg, device="cpu")
    rec = tserve.BatchingRecognizer(ocr, max_batch=4)
    try:
        ladder = rec.width_ladder
        assert ladder is not None and ladder[0] >= 8
        assert ladder[-1] == int(cfg.image_height * cfg.max_aspect_ratio)
        assert all(a < b for a, b in zip(ladder, ladder[1:]))
        assert len(ladder) < 12
        img = np.zeros((32, 33), np.float32)
        padded = rec.pad_width(img)
        assert padded.shape[1] in ladder and padded.shape[1] >= 33
        img2 = np.zeros((32, ladder[1]), np.float32)
        assert rec.pad_width(img2) is img2
        assert (padded[:, 33:] == 255.0).all()
    finally:
        rec.close()


def test_fixed_width_has_no_ladder():
    ocr = AttentionOCR.create(TCFG, device="cpu")
    rec = tserve.BatchingRecognizer(ocr, max_batch=4)
    try:
        assert rec.width_ladder is None
        img = np.zeros((32, 33), np.float32)
        assert rec.pad_width(img) is img
        assert rec.ladder == [1, 4]
        assert [rec._pad_to(n) for n in (1, 2, 4)] == [1, 4, 4]
    finally:
        rec.close()


def test_recognize_batch_endpoint(server):
    """POST /recognize_batch decodes many images in one request and
    device batch, results in input order; malformed bodies get 400."""
    base, recognizer = server
    words = ["ab", "cd", "ef"]
    body = json.dumps({"images": [
        base64.b64encode(_png_bytes(w)).decode() for w in words]}).encode()
    before = recognizer.snapshot_stats()
    status, payload = _post(f"{base}/recognize_batch", body)
    assert status == 200
    results = payload["results"]
    assert len(results) == 3
    after = recognizer.snapshot_stats()
    # the three rows coalesced: one batch of 3 rows, padded to 8
    assert after["batches"] == before["batches"] + 1
    assert after["padded_rows"] == before["padded_rows"] + 5
    for w, r in zip(words, results):
        s_one, p_one = _post(f"{base}/recognize", _png_bytes(w))
        assert s_one == 200 and r["text"] == p_one["text"]
    for junk in (b"junk", b'{"images": []}', b'{"images": [3]}',
                 json.dumps({"images": ["bm90IGFuIGltYWdl"]}).encode()):
        req = urllib.request.Request(f"{base}/recognize_batch", data=junk,
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 400


@pytest.mark.parametrize("argv,item", [
    (["-artifact", "m.aocrx"], "ROADMAP queue 1: Export"),
    (["-model_dir", "missing", "-num_shards", "2"],
     "-num_shards 2 but only 1 local devices"),
    (["-model_dir", "missing", "-num_shards", "0"], None)],
    # the cases' ids from when -num_shards was refused
    ids=["argv0-ROADMAP queue 1: Export", "argv1-ROADMAP queue 1: Parallel",
         "argv2-ROADMAP queue 1: Parallel"])
def test_unported_options_raise_before_load(monkeypatch, argv, item):
    """-artifact names its ROADMAP item by title, through serve() and the
    CLI, before any checkpoint load (made to fail loudly here).
    -num_shards, once refused too, is validated as aocr.serve does: more
    shards than local devices (the one CPU) raise before the load, and 0
    (every local device) reaches it."""
    def no_load(*_a, **_k):
        raise AssertionError("the checkpoint was loaded")

    monkeypatch.setattr(tserve.AttentionOCR, "load", no_load)
    kw = {k.lstrip("-"): (int(v) if k == "-num_shards" else v)
          for k, v in zip(argv[::2], argv[1::2])}
    error = (AssertionError if item is None else ValueError
             if "num_shards" in item else NotImplementedError)
    match = "the checkpoint was loaded" if item is None else re.escape(item)
    with pytest.raises(error, match=match):
        tserve.serve(device="cpu", **kw)
    with pytest.raises(error, match=match):
        tserve.main(argv, device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        tserve.serve(device="cpu")


def test_serve_defaults_to_cuda(model_dir):
    """No device means CUDA: without it, serve raises before serving."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.serve(model_dir=model_dir, port=0)
