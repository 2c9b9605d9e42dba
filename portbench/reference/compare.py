"""What decides `correct`: the program's answers held against the plain
reference, on inputs the benchmark made.  Nothing here imports the
program.

Recognition (greedy or beam): a transcript is read back into the tokens
the decoder emitted (its characters, then EOS where it stopped before
the cap: PAD and GO are never emitted, inputs.NEVER_EMITTED_BIAS).  The
reference, float32, is fed those tokens (teacher forcing) over the same
image, and gives
- token_gap: the widest gap by which an emitted token's log-prob lies
  below the reference's best at that step (greedy: 0 up to rounding);
- score_err: the widest distance between a returned score and the
  reference's log-prob of the returned tokens;
- beam_gap (beam): the widest distance by which the returned tokens'
  log-prob lies below the best that the reference's own beam search
  finds, and beam_gap_median, the median of that over the rows.

The reference runs its products in float32 with TF32 off, whatever the
process had set (network.products).

Training: the first three steps of the timed step object against three
reference steps from the same weights on the same batches:
- loss_gap: the widest relative gap of a step's loss;
- grad_gap: the first step's clipped gradient, worked out from the
  program's parameters before and after it ((p0 - p1) / lr); per leaf
  the gap of the two norms over the larger of the reference leaf's norm
  and the median leaf's; the worst leaf;
- delta_gap: the same of the parameters' change over the three steps,
  over the leaves whose reference gradient is at least a thousandth of
  the median leaf's (the conv biases before a train-mode BatchNorm get a
  gradient of nought to rounding, and are left out by that rule).
"""

from __future__ import annotations

import math

import torch

from . import network as net

CHARS = "0123456789abcdefghijklmnopqrstuvwxyz"  # ids 3..38
LEAF_FLOOR = 1e-3


def tokens_of(text: str, T: int):
    """The tokens a transcript was read from, or None where no decode
    could have given it."""
    if len(text) > T or any(c not in CHARS for c in text):
        return None
    ids = [CHARS.index(c) + 3 for c in text]
    return ids + [net.EOS] if len(ids) < T else ids


def text_of(tokens) -> str:
    out = []
    for t in tokens:
        t = int(t)
        if t == net.EOS:
            break
        if t > net.EOS:
            out.append(CHARS[t - 3])
    return "".join(out)


def row_steps(texts, T: int) -> list:
    """Decoder steps each transcript took (EOS counted), at most T."""
    return [min(len(t) + 1, T) for t in texts]


@torch.no_grad()
def recognize_readings(params, stats, cfg: dict, images, texts, scores,
                       beam: int, T: int) -> dict:
    """images (n, H, W) float32 on the reference's device; texts and
    scores (n,) the answers to judge."""
    with net.products():
        return _recognize_readings(params, stats, cfg, images, texts,
                                   scores, beam, T)


def _recognize_readings(params, stats, cfg, images, texts, scores, beam, T):
    dev = images.device
    toks = [tokens_of(t, T) for t in texts]
    bad = [i for i, t in enumerate(toks) if t is None]
    toks = [t if t is not None else [net.EOS] for t in toks]
    n, Tm = len(toks), max(len(t) for t in toks)
    tok = torch.full((n, Tm), net.PAD, dtype=torch.long, device=dev)
    for i, t in enumerate(toks):
        tok[i, :len(t)] = torch.tensor(t)
    live = tok != net.PAD
    fed = torch.cat([torch.full((n, 1), net.GO, dtype=torch.long,
                                device=dev), tok[:, :-1]], 1)
    context, init = net.encode(params, stats, images)
    lp = net.teacher_forced(params, context, init, fed, cfg["input_feed"])
    picked = lp.gather(-1, tok[..., None])[..., 0]
    gap = torch.where(live, lp.amax(-1) - picked, 0.0).amax(1)
    ref = torch.where(live, picked, 0.0).sum(1)
    got = torch.as_tensor(scores, dtype=torch.float32, device=dev)
    out = {"score_err": (got - ref).abs()}
    if beam == 1:
        out["token_gap"] = gap
    else:
        _t, best = net.beam(params, context, init, cfg["input_feed"], T,
                            beam)
        out["beam_gap"] = best - ref
    res = {}
    for k, v in out.items():
        v = v.clone()
        v[bad] = math.inf
        v = torch.where(torch.isfinite(v), v, math.inf)
        res[k] = float(v.max())
        if k == "beam_gap":
            res["beam_gap_median"] = float(v.median())
    return res


@torch.no_grad()
def decode_control(params, stats, cfg: dict, images, beam: int, T: int,
                   precision: str, wrong_pick: bool = False):
    """The reference in the program's place: its transcripts and scores
    for images, at a lower precision (the control), or with a wrong pick
    (a fault: greedy takes the runner-up at one step of each row, row i
    at step i mod T; beam search returns its second beam), each with its
    own log-prob."""
    pr = net.Precision(precision)
    with net.products(pr):
        context, init = net.encode(params, stats, images, pr)
        if beam == 1:
            wrong = torch.arange(images.shape[0], device=images.device) % T \
                if wrong_pick else None
            toks, sc = net.greedy(params, context, init, cfg["input_feed"],
                                  T, pr, wrong)
        else:
            toks, sc = net.beam(params, context, init, cfg["input_feed"], T,
                                beam, pr, int(wrong_pick))
    return [text_of(r) for r in toks.tolist()], sc.tolist()


def flatten(tree, path=()) -> dict:
    if isinstance(tree, dict):
        return {p: x for k, v in tree.items()
                for p, x in flatten(v, path + (k,)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: x for i, v in enumerate(tree)
                for p, x in flatten(v, path + (i,)).items()}
    return {path: tree}


def reference_steps(params, stats, batches, lr: float, input_feed: bool,
                    precision: str = "float32"):
    """Reference SGD steps over batches [(images, targets, targets_eval)]:
    (losses, the first step's clipped grads, params after the last), the
    trees flattened by path."""
    pr = net.Precision(precision)
    p, losses, first = params, [], None
    with net.products(pr):
        for images, tg, te in batches:
            loss, grads, new = net.train_step(p, stats, images, tg, te, lr,
                                              input_feed, pr)
            losses.append(float(loss))
            first = grads if first is None else first
            p = unflatten(params, new)
    return losses, first, flatten(p)


def unflatten(like, flat: dict, path=()):
    if isinstance(like, dict):
        return {k: unflatten(v, flat, path + (k,)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return [unflatten(v, flat, path + (i,)) for i, v in enumerate(like)]
    return flat[path]


def _worst(got: dict, want: dict, keys) -> float:
    med = float(torch.tensor([want[k] for k in keys]).median()) if keys else 0
    worst = 0.0
    for k in keys:
        g = got.get(k, math.nan)
        gap = abs(g - want[k]) / max(want[k], med, 1e-30)
        worst = max(worst, gap if math.isfinite(gap) else math.inf)
    return worst


def train_readings(losses, p0: dict, p1: dict, p3: dict, lr: float,
                   ref_losses, ref_grads: dict, ref_p3: dict) -> dict:
    """The program's three losses and flattened params (before, after
    step 1, after step 3) against the reference's."""
    norm = lambda x: float(x.double().norm())  # noqa: E731
    loss_gap = max((abs(a - b) / abs(b) if math.isfinite(a) else math.inf)
                   for a, b in zip(losses, ref_losses))
    g_ref = {k: norm(v) for k, v in ref_grads.items()}
    g_got = {k: norm((p0[k] - p1[k]) / lr) for k in p0 if k in p1}
    med = float(torch.tensor(list(g_ref.values())).median())
    moved = [k for k, v in g_ref.items() if v >= LEAF_FLOOR * med]
    d_ref = {k: norm(ref_p3[k] - p0[k]) for k in moved}
    d_got = {k: norm(p3[k] - p0[k]) for k in moved if k in p3}
    return {"loss_gap": loss_gap,
            "grad_gap": _worst(g_got, g_ref, list(g_ref)),
            "delta_gap": _worst(d_got, d_ref, moved)}
