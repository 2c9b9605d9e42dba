"""What decides `correct` in an im2markup cell: the program's answers held
against the plain reference (reference/im2markup.py, float32, TF32 off),
on the benchmark's weights and images, in blocks of rows.  Nothing here
imports the program.

A transcript is read back into the tokens the decoder emitted (its
tokens by name, then EOS where it stopped before the cap; PAD and GO are
never emitted, inputs.NEVER_EMITTED_BIAS).  The reference is fed those
tokens (teacher forcing) over the same image and gives
- token_gap: the widest gap by which an emitted token's log-prob lies
  below the reference's best at that step (greedy: 0 up to rounding);
- score_err: the widest distance between a returned score and the
  reference's log-prob of the returned tokens.
"""

from __future__ import annotations

import math

import torch

from . import im2markup as ref
from . import network

BLOCK = 16  # rows the reference runs at once


def _convs(cfg_file: dict):
    return [tuple(tuple(v) if isinstance(v, list) else v for v in c)
            for c in cfg_file["spec"]["convs"]]


def tokens_of(text: str, T: int, ids: dict):
    """The tokens a transcript was read from, or None where no decode
    could have given it."""
    toks = text.split()
    if len(toks) > T or any(t not in ids for t in toks):
        return None
    out = [ids[t] for t in toks]
    return out + [ref.EOS] if len(out) < T else out


def row_steps(texts, T: int) -> list:
    """Decoder steps each transcript took (EOS counted), at most T."""
    return [min(len(t.split()) + 1, T) for t in texts]


def _ids(names) -> dict:
    return {n: i for i, n in enumerate(names)}


@torch.no_grad()
def readings(params, stats, cfg_file: dict, names, images, texts, scores,
             T: int) -> dict:
    """images (n, H, W) float32 on the reference's device; texts and
    scores (n,) the answers to judge; names the token names by id."""
    ids, convs = _ids(names), _convs(cfg_file)
    feed = cfg_file["config"]["input_feed"]
    toks = [tokens_of(t, T, ids) for t in texts]
    bad = [i for i, t in enumerate(toks) if t is None]
    toks = [t if t is not None else [ref.EOS] for t in toks]
    dev = images.device
    gaps, refs = [], []
    for a in range(0, len(toks), BLOCK):
        part = toks[a:a + BLOCK]
        n, Tm = len(part), max(len(t) for t in part)
        tok = torch.full((n, Tm), ref.PAD, dtype=torch.long, device=dev)
        for i, t in enumerate(part):
            tok[i, :len(t)] = torch.tensor(t)
        live = tok != ref.PAD
        fed = torch.cat([torch.full((n, 1), ref.GO, dtype=torch.long,
                                    device=dev), tok[:, :-1]], 1)
        context = ref.encode(params, stats, images[a:a + BLOCK], convs)
        lp = ref.teacher_forced(params, context, fed, feed)
        picked = lp.gather(-1, tok[..., None])[..., 0]
        gaps.append(torch.where(live, lp.amax(-1) - picked, 0.0).amax(1))
        refs.append(torch.where(live, picked, 0.0).sum(1))
    got = torch.as_tensor(scores, dtype=torch.float32, device=dev)
    out = {}
    for k, v in (("score_err", (got - torch.cat(refs)).abs()),
                 ("token_gap", torch.cat(gaps))):
        v[bad] = math.inf
        v = torch.where(torch.isfinite(v), v, math.inf)
        out[k] = float(v.max())
    return out


@torch.no_grad()
def decode_control(params, stats, cfg_file: dict, names, images, T: int,
                   precision: str, wrong_pick: bool = False):
    """The reference in the program's place, greedy: its transcripts and
    scores for images at a lower precision (the control, network.Precision),
    or with a wrong pick (a fault: row i takes its runner-up at step i mod
    T, with its own log-prob)."""
    q, convs = network.Precision(precision).q, _convs(cfg_file)
    feed = cfg_file["config"]["input_feed"]
    texts, scores = [], []
    for a in range(0, images.shape[0], BLOCK):
        x = images[a:a + BLOCK]
        context = ref.encode(params, stats, x, convs, q)
        wrong = (torch.arange(a, a + x.shape[0], device=x.device) % T
                 if wrong_pick else None)
        toks, sc = ref.greedy(params, context, feed, T, q, wrong)
        for row in toks.tolist():
            kept = []
            for t in row:
                if t == ref.EOS:
                    break
                if t > ref.GO:
                    kept.append(names[t])
            texts.append(" ".join(kept))
        scores += sc.tolist()
    return texts, scores
