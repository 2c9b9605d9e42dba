"""Bulk recognition: back-to-back `AttentionOCR.recognize` calls of one
caller (a closed loop), each on a stacked (B, H, W) float32 numpy batch
drawn in turn from a pool of distinct seeded batches.

Traffic keys: batch, beam, max_len (the decode cap), width, pool (the
batches set-up makes), never_emitted (inputs.NEVER_EMITTED_BIAS),
sample_rows (the answers `correct` judges), trace_calls (the calls a
--trace 1 run profiles).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from .. import inputs, stats
from ..reference import compare

# the faults control.py reads in the reference put in the program's place
FAULTS = ("wrong_pick",)


@dataclass
class State:
    cfg: dict
    traffic: dict
    seed: int
    device: torch.device
    weights: tuple        # the benchmark's (params, batch_stats)
    pool: list            # numpy (B, H, W) batches
    ocr: object = None    # the program under test


@dataclass
class Result:
    seconds: float = 0.0
    calls: list = field(default_factory=list)  # (pool index, s, texts, scores)
    failed: int = 0
    traced: list = field(default_factory=list)

    @property
    def attempted(self) -> int:
        return len(self.calls)


def setup(cfg: dict, traffic: dict, seed: int, device) -> State:
    """The program on the benchmark's weights, the pool, one warm-up call
    at the cell's only shape."""
    from aocr_torch import weights as wlib
    from aocr_torch.api import AttentionOCR
    from aocr_torch.config import Config

    conf = Config(**cfg["config"])
    params, bstats = inputs.make_weights(cfg["config"], seed, device,
                                         traffic["never_emitted"])
    st = State(cfg, traffic, seed, torch.device(device), (params, bstats),
               [])
    rng = inputs.host_rng(seed, 1)
    st.pool = [inputs.word_images(rng, traffic["batch"], traffic["width"],
                                  conf.image_height)
               for _ in range(traffic["pool"])]
    st.ocr = AttentionOCR(conf, wlib.conv_to_port(inputs.clone_tree(params)),
                          inputs.clone_tree(bstats), device=device)
    _call(st, st.pool[0])
    return st


def _call(st: State, x):
    return st.ocr.recognize(x, beam_size=st.traffic["beam"],
                            max_len=st.traffic["max_len"])


def window(st: State, seconds: float, tracer=None) -> Result:
    res = Result()
    P = len(st.pool)
    t0 = time.perf_counter()
    i = 0
    while i == 0 or time.perf_counter() - t0 < seconds:
        if tracer is not None:
            tracer.before(i, time.perf_counter() - t0)
        with torch.profiler.record_function("portbench.batch"):
            x = st.pool[i % P]
        a = time.perf_counter()
        try:
            with torch.profiler.record_function("portbench.call"):
                texts, scores = _call(st, x)
        except RuntimeError:
            res.failed += 1
            texts, scores = None, None
        b = time.perf_counter()
        with torch.profiler.record_function("portbench.read"):
            res.calls.append((i % P, b - a, texts, scores))
        if tracer is not None:
            tracer.after()
        i += 1
    res.seconds = time.perf_counter() - t0
    if tracer is not None:
        res.traced = list(tracer.traced)
    return res


def end_to_end(st: State, res: Result) -> dict:
    images = len(res.calls) * st.traffic["batch"]
    return {"recognize_images_per_s": images / res.seconds,
            "recognize_p95_ms": stats.percentile(
                [c[1] * 1e3 for c in res.calls], 95)}


def layer_info(st: State, res: Result) -> list:
    """What the per-layer readers count, for each traced call."""
    T, K = st.traffic["max_len"], st.traffic["beam"]
    return [{"entry": "recognize", "B": st.traffic["batch"], "K": K, "T": T,
             "W": st.traffic["width"],
             "row_steps": compare.row_steps(res.calls[i][2] or [], T)}
            for i in res.traced if res.calls[i][2] is not None]


def release(st: State) -> None:
    """Free the program's state before the reference runs."""
    st.ocr = None
    if st.device.type == "cuda":
        torch.cuda.empty_cache()


def _sample(st: State, res: Result) -> list:
    """(call, row) pairs drawn from the seed, with the longest answer."""
    rng = inputs.host_rng(st.seed, 2)
    done = [c for c, call in enumerate(res.calls) if call[2] is not None]
    B, n = st.traffic["batch"], st.traffic["sample_rows"]
    picks = set()
    if done:
        longest = max(((c, r) for c in done
                       for r in range(B)),
                      key=lambda cr: len(res.calls[cr[0]][2][cr[1]]))
        picks.add(longest)
        while len(picks) < min(n, len(done) * B):
            picks.add((int(done[rng.integers(len(done))]),
                       int(rng.integers(B))))
    return sorted(picks)


def _images(st: State, res: Result, picks):
    import numpy as np

    x = np.stack([st.pool[res.calls[c][0]][r] for c, r in picks])
    return torch.from_numpy(x).to(st.device)


def check(st: State, res: Result, control: str = None) -> dict:
    """The readings `correct` compares: the program's answers, or, with
    `control`, the reference's in the program's place on the same
    sampled rows: at that precision, or with a wrong pick ("wrong_pick",
    compare.decode_control)."""
    picks = _sample(st, res)
    if not picks or res.failed:
        return {"answered": 0.0}
    params, bstats = st.weights
    x = _images(st, res, picks)
    T, K = st.traffic["max_len"], st.traffic["beam"]
    if control is None:
        texts = [res.calls[c][2][r] for c, r in picks]
        scores = [float(res.calls[c][3][r]) for c, r in picks]
    else:
        wrong = control == "wrong_pick"
        texts, scores = compare.decode_control(
            params, bstats, st.cfg["config"], x, K, T,
            "float32" if wrong else control, wrong)
    return compare.recognize_readings(params, bstats, st.cfg["config"], x,
                                      texts, scores, K, T)
