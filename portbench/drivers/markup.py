"""Bulk formula recognition with im2markup: back-to-back
`AttentionOCR.recognize` calls of one caller (a closed loop) on a model
made with `spec=` (models/im2markup.py), each on a stacked (B, H, W)
float32 numpy batch drawn in turn from a pool of distinct seeded
batches.  The window, the end-to-end metrics and the sample `correct`
judges are drivers/recognize.py's; the inputs, the weights and the
comparison are im2markup's (markup_inputs.py, reference/markup_compare.py).

Traffic keys: batch, beam (1), max_len (the decode cap), height, width,
pool (the batches set-up makes), never_emitted
(inputs.NEVER_EMITTED_BIAS), sample_rows (the answers `correct` judges),
trace_calls (the calls a --trace 1 run profiles).
"""

from __future__ import annotations

import torch

from .. import inputs, markup_inputs
from ..reference import markup_compare
from .recognize import Result, State, _call, _images, _sample
# the rest of the driver's interface, as recognize.py has it
from .recognize import FAULTS, end_to_end, release, window  # noqa: F401


def names(cfg: dict) -> list:
    """The token names by id: the four specials, then the benchmark's
    synthetic vocabulary."""
    V = cfg["config"]["target_vocab_size"]
    return ["<pad>", "<go>", "<eos>", "<unk>"] + markup_inputs.token_names(V)


def setup(cfg: dict, traffic: dict, seed: int, device) -> State:
    """The program on the benchmark's weights, the pool, one warm-up call
    at the cell's only shape."""
    from aocr_torch.api import AttentionOCR
    from aocr_torch.config import Config
    from aocr_torch.models import im2markup

    conf = Config(**cfg["config"])
    spec = im2markup.Spec(**cfg["spec"], tokens=tuple(names(cfg)[4:]))
    params, bstats = markup_inputs.make_weights(cfg, seed, device,
                                                traffic["never_emitted"])
    st = State(cfg, traffic, seed, torch.device(device), (params, bstats),
               [])
    rng = inputs.host_rng(seed, 1)
    st.pool = [markup_inputs.formula_images(rng, traffic["batch"],
                                            traffic["height"],
                                            traffic["width"])
               for _ in range(traffic["pool"])]
    st.ocr = AttentionOCR(conf, inputs.clone_tree(params),
                          inputs.clone_tree(bstats), device=device,
                          spec=spec)
    _call(st, st.pool[0])
    return st


def layer_info(st: State, res: Result) -> list:
    """What the per-layer readers count, for each traced call."""
    T = st.traffic["max_len"]
    return [{"entry": "markup", "B": st.traffic["batch"], "K": 1, "T": T,
             "Hi": st.traffic["height"], "W": st.traffic["width"],
             "row_steps": markup_compare.row_steps(res.calls[i][2] or [], T)}
            for i in res.traced if res.calls[i][2] is not None]


def check(st: State, res: Result, control: str = None) -> dict:
    """The readings `correct` compares: the program's answers, or, with
    `control`, the reference's in the program's place on the same
    sampled rows: at that precision, or with a wrong pick."""
    picks = _sample(st, res)
    if not picks or res.failed:
        return {"answered": 0.0}
    params, bstats = st.weights
    x = _images(st, res, picks)
    T, tok_names = st.traffic["max_len"], names(st.cfg)
    if control is None:
        texts = [res.calls[c][2][r] for c, r in picks]
        scores = [float(res.calls[c][3][r]) for c, r in picks]
    else:
        wrong = control == "wrong_pick"
        texts, scores = markup_compare.decode_control(
            params, bstats, st.cfg, tok_names, x, T,
            "float32" if wrong else control, wrong)
    return markup_compare.readings(params, bstats, st.cfg, tok_names, x,
                                   texts, scores, T)
