"""The CLI trainer's step: `train_step.make_train_step(cfg)` dispatched
back to back on batches drawn in turn from a pool of distinct seeded
batches, each fed as `train.py` feeds it (numpy images and the labels
padded by `vocab.encode_batch`, copied to the device at each step), the
loss read one step behind through a pinned copy, as the trainer reads
it.

Set-up builds the one step object and drives it through its first
`check_steps` steps on pool batches 0, 1, 2, ... through the window's own
call and feed (`correct` compares those steps), then one step for each
label width of the pool those steps did not cover; the window goes on
from that state.

Traffic keys: batch, width, pool, label_law (shape, scale, min, max of
the word lengths), never_emitted (inputs.NEVER_EMITTED_BIAS), lr,
check_steps, trace_calls.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import torch

from .. import inputs
from ..reference import compare

# the faults control.py reads in the reference put in the program's place
# (a state left unchanged reads 1 by delta_gap's measure and needs no run)
FAULTS = ("half",)


@dataclass
class State:
    cfg: dict
    traffic: dict
    seed: int
    device: torch.device
    weights: tuple
    pool: list                   # (images, labels, targets, targets_eval)
    step: object = None
    model: list = None           # [params, batch_stats, opt_state]
    losses: list = field(default_factory=list)   # of the checked steps
    snaps: dict = field(default_factory=dict)    # params after steps 1, n
    done: int = 0                # steps taken


@dataclass
class Result:
    seconds: float = 0.0
    steps: list = field(default_factory=list)   # (pool index, loss)
    failed: int = 0
    traced: list = field(default_factory=list)

    @property
    def attempted(self) -> int:
        return len(self.steps)


def setup(cfg: dict, traffic: dict, seed: int, device) -> State:
    from aocr_torch import train_step, vocab
    from aocr_torch import weights as wlib
    from aocr_torch.config import Config

    conf = Config(**cfg["config"])
    params, bstats = inputs.make_weights(cfg["config"], seed, device,
                                         traffic["never_emitted"])
    st = State(cfg, traffic, seed, torch.device(device), (params, bstats), [])
    rng = inputs.host_rng(seed, 1)
    B = traffic["batch"]
    for _ in range(traffic["pool"]):
        images = inputs.word_images(rng, B, traffic["width"],
                                    conf.image_height)[..., None]
        labels = inputs.words(rng, B, traffic["label_law"])
        tg, te, _nnz = vocab.encode_batch(labels)
        st.pool.append((images, labels, tg, te))
    p = wlib.conv_to_port(inputs.clone_tree(params))
    st.model = [p, inputs.clone_tree(bstats), train_step.init_opt_state(p, conf)]
    st.step = train_step.make_train_step(conf)
    n = traffic["check_steps"]
    for k in range(n):
        st.losses.append(_read(_step(st, k)))
        if k + 1 in (1, n):
            st.snaps[k + 1] = st.model[0]
    seen = {st.pool[k][2].shape[1] for k in range(n)}
    for k, b in enumerate(st.pool):
        if b[2].shape[1] not in seen:
            seen.add(b[2].shape[1])
            _read(_step(st, k))
    return st


def _step(st: State, k: int):
    """One step on pool batch k, fed as the trainer feeds it; returns the
    pending loss."""
    from aocr_torch import augment

    images, _labels, tg, te = st.pool[k]
    dev = st.device
    with torch.profiler.record_function("portbench.batch"):
        im = torch.from_numpy(images).to(dev)
        tg, te = torch.from_numpy(tg).to(dev), torch.from_numpy(te).to(dev)
    with torch.profiler.record_function("portbench.call"):
        p, s, o = st.model
        out = st.step(p, s, o, im, tg, te, st.traffic["lr"],
                      augment.step_key(st.seed, st.done))
        st.model = [out.params, out.batch_stats, out.opt_state]
        st.done += 1
    return _later(out.loss_sum)


def _later(x: torch.Tensor):
    """The loss to read later without waiting for work queued after it."""
    if x.device.type != "cuda":
        return x.detach().clone()
    host = torch.empty((), dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


def _read(pending) -> float:
    with torch.profiler.record_function("portbench.read"):
        if isinstance(pending, tuple):
            pending[1].synchronize()
            return float(pending[0])
        return float(pending)


def window(st: State, seconds: float, tracer=None) -> Result:
    res = Result()
    P = len(st.pool)
    inflight = None
    t0 = time.perf_counter()
    i = 0
    while i == 0 or time.perf_counter() - t0 < seconds:
        if tracer is not None:
            tracer.before(i, time.perf_counter() - t0)
        k = (st.done + i) % P
        pending = _step(st, k)
        if inflight is not None:
            res.steps.append((inflight[0], _read(inflight[1])))
        inflight = (k, pending)
        if tracer is not None:
            tracer.after()
        i += 1
    res.steps.append((inflight[0], _read(inflight[1])))
    if st.device.type == "cuda":
        torch.cuda.synchronize()
    res.seconds = time.perf_counter() - t0
    res.failed = sum(not math.isfinite(loss) for _k, loss in res.steps)
    if tracer is not None:
        res.traced = list(tracer.traced)
    return res


def end_to_end(st: State, res: Result) -> dict:
    return {"train_images_per_s":
            len(res.steps) * st.traffic["batch"] / res.seconds}


def layer_info(st: State, res: Result) -> list:
    out = []
    for i in res.traced:
        if i >= len(res.steps):
            continue
        _images, _labels, tg, te = st.pool[res.steps[i][0]]
        out.append({"entry": "train", "B": te.shape[0], "T": te.shape[1],
                    "W": st.traffic["width"],
                    "row_steps": (te != 0).sum(1).tolist()})
    return out


def release(st: State) -> None:
    st.model = st.step = None
    if st.device.type == "cuda":
        torch.cuda.empty_cache()


def _ref_layout(flat: dict) -> dict:
    """The program's conv weights (O, I, kh, kw) back to the reference's
    (kh, kw, I, O); the other leaves as they are."""
    return {k: (v.permute(2, 3, 1, 0) if k[0] == "cnn" and k[-1] == "w"
                else v) for k, v in flat.items()}


def check(st: State, res: Result, control: str = None) -> dict:
    """The readings `correct` compares (reference/compare.py): the
    program's first steps, or, with `control`, the reference's at that
    precision in the program's place, against the float32 reference."""
    params, bstats = st.weights
    n = st.traffic["check_steps"]
    batches = []
    for k in range(n):
        images, labels, _tg, _te = st.pool[k]
        tg, te = inputs.encode_batch(labels)
        batches.append((torch.from_numpy(images[..., 0]).to(st.device),
                        torch.from_numpy(tg).to(st.device),
                        torch.from_numpy(te).to(st.device)))
    lr, feed = st.traffic["lr"], st.cfg["config"]["input_feed"]
    p0 = compare.flatten(params)
    if control is None:
        losses = st.losses
        p1 = _ref_layout(compare.flatten(st.snaps[1]))
        pn = _ref_layout(compare.flatten(st.snaps[n]))
    else:
        # "half": the fault of a step that leaves out half of its batch
        # and takes the mean over the rest; else a lower precision
        half = control == "half"
        sub = [tuple(t[:t.shape[0] // 2] for t in b) for b in batches] \
            if half else batches
        losses, g1, pn = compare.reference_steps(
            params, bstats, sub, lr, feed, "float32" if half else control)
        p1 = {k: p0[k] - lr * g for k, g in g1.items()}
    ref_losses, ref_g1, ref_pn = compare.reference_steps(
        params, bstats, batches, lr, feed)
    return compare.train_readings(losses, p0, p1, pn, lr, ref_losses,
                                  ref_g1, ref_pn)
