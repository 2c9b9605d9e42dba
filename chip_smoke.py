#!/usr/bin/env python3
"""Smoke run of aocr_torch on one NVIDIA GPU (H100): greedy recognition,
the training step, beam and dictionary recognition, the image gradient,
the CLI trainer and the results gallery, the micro-batching server,
device preprocessing, augmentation, the Torch7 checkpoint import,
data-parallel training and evaluation, sharded recognition, the
training options (dropout, remat, simple attention, the fused encoder
projection), DP x TP training, export, the CLI's default decoder
without input feed, -keep_aspect_ratio over the width ladder with
Adadelta, and the demo, at the full width of the default model, through
their twelve CUDA kernels (thirteen rows: lstm_fwd's two modes).

    python3 chip_smoke.py [--seed N]

Phases, each raising on failure:
  1. environment: the card (nvidia-smi), CUDA, the kernel build from
     aocr_torch/csrc (nvcc, sm_90a, one process per source);
  2. each kernel against its plain PyTorch version on the card, at the
     main paths' shapes (recognition B=512, T=50; training B=400, T=11,
     the three pools after conv2/4/6; conv1_pool also at the width
     ladder's ends W=16 and 320, lstm_fwd at their L=3 and 79), in
     float32 and bfloat16, with
     stated tolerances; tf_fwd, tf_bwd and lstm_bwd also at a ragged
     B=37; conv1_pool_bwd's two calls bit-identical; conv1_pool_dx bit
     for bit, also at B=37 and W=36; decode_step on its cluster and rows
     routes at B=1, 8, 32, 512 with an all-NaN row, and at B=512 with
     the 88k trie plane and a row left no valid token; greedy_loop also
     at im2markup's decode (L=1,240, H=512, T=150, bf16), its attention
     split by positions, at B=256, 37 and under a random trie;
     lstm_fwd also at H=2400, B=8; a tiny model (H=128)
     trained on the card to exact match, whose bf16 greedy and beam-5
     transcripts on the kernel routes (greedy_loop, decode_step,
     beam_loop, beam_step), with and without a trie, must equal the plain
     route's; beam_step at K=5 and K=10 (no trie, the 88k trie, refill);
  3. recognition end to end: numpy weights from --seed through
     aocr_torch.weights, AttentionOCR.recognize on requests of 1, 8, 32
     and 512 word images (W=100) and a mixed-width list, bf16 (the
     serving configuration) and float32, pallas_greedy "loop" and "tail";
     every kernel's launch count must move; float32 transcripts must
     equal the plain route's on the card and the CPU's on a small input;
  3b. beam and dictionary recognition end to end: recognize(beam_size=5)
     at B=512 and on a mixed-width list, bf16 and float32, pallas_beam
     "loop" and "tail"; greedy and beam-5 under the 88k-word synthetic
     lexicon of bench.py; beam_step and beam_loop (and the trie operands
     of decode_step and greedy_loop) must launch; float32 transcripts
     equal the plain route's and the CPU's;
  3c. recognize(beam_size=10) at B=512, bf16 and float32: wider than
     beam_loop.MAX_K, so the default route launches beam_step once a
     step (its own launch counts); float32 transcripts equal the plain
     route's;
  4. training end to end: 5 make_train_step steps (SGD) at B=400 on
     32x100 crops of 10-letter words (T=11), bf16 and float32, from the
     same numpy weights; every training kernel's launch count must move;
     float32 step 1 (loss_sum, grad norms, updated params) must match
     the plain route on the card and the CPU at a small size; loss_sum
     must fall over the steps; AttentionOCR.score once;
  4b. the image gradient through cnn.apply(train=True) at B=400, float32
     (conv1_pool_dx and pool_bwd launch), against the plain route;
  4c. the CLI trainer (aocr_torch.train.main) on 1,000 + 400 crops
     written from --seed: bf16 train (a padded partial batch each
     epoch), the same epoch with -device_preprocess and with -augment,
     -load_model resume, beam-5 test (its results.txt rendered by
     python -m aocr_torch.visualizer.generate_html: one <li> a row, a
     PNG a crop) and dictionary test, with launch counts (pool_bwd 3 a
     step); float32 train and beam-5 test with the kernels against
     -no_use_pallas;
  4d. serving (aocr_torch.serve on a thread, the model saved from the
     numpy weights): a bf16 and a float32 server (max_batch 512, beam-5
     warmed) through 64 clients x 8 PNG posts and 512 at once (a quarter
     beam-5) and a /recognize_batch of 512: every answer 200 with a text
     of the vocabulary and a finite score, float32 texts equal to a
     direct recognize of the decoded images but at plain near-ties
     (< 1e-4, counted), /stats counting every request without errors or
     timeouts, /healthz 200, an undecodable body and an unwarmed beam
     400, 503 after the drain; requests/s, latency percentiles, rows a
     batch and padded rows, /recognize_batch images/s against a direct
     recognize; a bf16 server under -dictionary (the 88k lexicon) without
     warmup, its transcripts on the lexicon's prefixes; the decoder
     weight packing's share of a recognize at B=1, 8, 32;
  4e. device preprocessing: recognize on 512 RGB .npy paths with
     device_preprocess and without (images within 1e-3, float32
     transcripts equal but at plain near-ties, ms of each), bf16 and
     float32; preprocess_varsize on the card against the CPU;
  4f. augmentation: the bf16 train step at B=400 with cfg.augment, 5
     steps twice (the same step-1 loss, finite, not the unaugmented
     loss), its ms against the step without augment, in turns;
  4g. the Torch7 import: the reference's checkpoint tree of the default
     model from --seed numpy weights, written by aocr_torch.t7 with 8-
     and 4-byte longs, `python -m aocr_torch.torch_import` into model
     dirs, loaded on the card: params bit-equal to the mapped weights,
     greedy and beam-5 transcripts and scores at B=512 equal to the
     directly built model's (bf16 and float32); the stream's MB and the
     import's seconds;
  4h. data-parallel training at world size 1 over NCCL: 5
     make_dp_train_step steps at B=400, bf16 and float32, each held to
     make_train_step from the same state (float32 params 1e-4, loss
     1e-5), the step's ms beside the one-card step's (host clock);
  4i. world size 2 on the one card: two processes (spawn) over a gloo
     group, the kernels built before the spawn: which collectives gloo
     runs on CUDA tensors; 3 DP steps and a masked tail with 200 and 100
     real rows, each step held to one process at B=400 (float32 params
     rtol 1e-3 atol 2e-4, loss 1e-5; bf16 reported), params bit-equal
     across the ranks; the DP eval (beam-5, 500 rows padded to 512):
     labels, accuracy and cer_sum exact, nll 1e-5; the CLI trainer at
     -num_shards 2 against -num_shards 1 (step perplexities 1e-5, only
     rank 0 writes); the training kernels launch in each rank;
  4j. AttentionOCR.shard(devices=[cuda:0, cuda:0]) on B=512 and a
     mixed-width list, greedy and beam-5: float32 transcripts equal
     unshard()'s (bf16 reported); shard(2) raises on one card; a bf16
     server at -num_shards 0 answers 64 posts.  No scaling figure: the
     machine has one card;
  4k. the training options at B=400, T=11, 3 steps from the --seed
     weights, bf16 and float32: dropout 0.3 (each (step, site) keep rate
     within 0.7 +- 0.005, bf16 params bit-equal for one key twice and
     moved by another, remat + dropout = dropout within 1e-6), remat
     (float32 = no remat within the train step's gates; peak memory at
     B=400 and 1600, bf16), the simple attention (kernel route = plain
     route) and -fused_encoder_proj (float32 step = unfused step; bf16
     greedy and beam-5 transcripts at B=512 equal the unfused model's;
     its A/B); the teacher-forced kernels launch only on the fused
     step; each option's bf16 step ms;
  4l. DP x TP over gloo on the one card: the (1, 2) grid in 2
     processes and the (2, 2) grid in 4, float32 B=400: 3 steps and a
     masked tail, each held to one process (loss 1e-4, params rtol 1e-3
     atol 3e-4, grad norms 1e-5), replicated leaves bit-equal on every
     rank and each shard across its data ranks, a dropout step at (1,
     2), bf16 reported, the step's ms (not a scaling figure); at (2, 2)
     the eval on the gathered params over the 4 ranks and the CLI
     trainer at -num_shards 2 -num_model_shards 2 against -num_shards
     1, its checkpoint loaded in one process;
  4m. export (after 4d): aocr_torch.export at B=512, T=50 (12 for the
     host-loop routes, whose traces unroll their steps): a plain greedy
     float32 artifact traced on the CPU (in a spawned process) and
     loaded on the card against the live use_pallas=False recognize;
     kernel artifacts (the custom ops aocr_torch::...) traced on the
     card for greedy float32 and bf16 (greedy_loop), beam-5 under the
     88k lexicon (beam_loop), beam-10 (beam_step) and the greedy tail
     route (decode_step, its weights packed once a decode), each held
     to the live recognize of its model (transcripts equal, scores rtol
     1e-5) with its launches counted; update_weights with a perturbed
     projector against the live model holding it; a /recognize_batch
     of 64 PNGs through serve(artifact=...) against a direct call; each
     artifact's MB, trace and load seconds and recognize ms beside the
     live recognize's;
  4n. the CLI's default decoder, without input feed (cli_config; layer
     0's weights one segment), at full width: the decoder kernels
     against their plain versions (greedy_loop at B=512 with and
     without the 88k trie, decode_step at B=1 and 512, beam_step at K=5
     and 10, beam_loop, tf_fwd and tf_bwd at B=400 and 37), the trained
     fixture's bf16 transcripts on every kernel route, phases 3-3c on
     its model (float32 transcripts equal to the plain route's), 5
     float32 train steps each held to the plain route's step from the
     same state, and the CLI trainer without -input_feed (float32, 3
     steps and a greedy test, kernels against -no_use_pallas);
  4o. -keep_aspect_ratio -snap_width_ladder over the ladder 16 ... 320
     (L = 3 ... 79) on that decoder: greedy_loop and beam_loop against
     their plain versions at L=3 and L=79 (B=512, T=50, random states
     that keep the searches live, with and without the 88k trie, both
     dtypes); recognize at every width (B=64)
     and a B=512 list of every width, greedy and beam-5, both dtypes
     (float32 transcripts equal to the plain route's); 2 Adadelta train
     steps at every width, each held to the plain route's from one
     state; the CLI trainer with -optimizer adadelta on words rendered
     at the ladder's widths (a step a width bucket; its perplexity and
     params errors against -no_use_pallas stated, not held: see
     tools/keep_aspect_drift_torch.py) and its beam-5 test, kernels
     against -no_use_pallas (its distinct transcripts logged); a server's wave of PNGs of widths between the
     steps (/stats' padded rows) against a direct recognize; a
     multi-width .aocrx bit-equal to the live route at every width,
     served once;
  4p. python -m aocr_torch.demo at a reduced size (DEMO_WORDS words,
     DEMO_EPOCHS epochs): its artifact equal to the live model on every
     replayed image, the greedy exact match at least DEMO_FLOOR;
  5. timing: each kernel against its plain version (CUDA events), its
     bound (the larger of its operations over the card's peak and its
     bytes over 3.35 TB/s) and, where PyTorch computes the same function
     (cuDNN's LSTM; the unfused pool backward's two calls), that;
     lstm_fwd at B=1, 8, 32, 512 (collect=False) and 400 (collect=True)
     with cuDNN in the same turns, its launch plans and ptxas registers;
     greedy_loop at B=1, 8, 32, 512 (all 50 steps run; check_loop with
     and without the 88k trie at each), the 88k-trie and all-EOS decodes,
     its launch plans and ptxas registers; beam_loop likewise at K=5
     (check_beam_loop at each B), the 88k-trie search and the one whose
     beams all pick EOS at their first step; the
     recognize images/s at B=512, W=100, bf16, T=50, greedy, beam-5,
     dictionary beam-5 and beam-10; the tail-route recognize (bf16 and
     float32) on decode_step's two routes in turns; decode_step at B=1,
     8, 32, 512 on both routes; beam_step at K=5 and K=10; tf_fwd without
     residuals (score's call) at B=1,
     32 and 400 against its plain version, and the two teacher-forced
     kernels' launch plans and ptxas registers; lstm_bwd's plan (its
     route by dtype), conv1_pool_bwd's plan, both kernels' ptxas
     registers; the bf16 train step (ms, images/s) and its
     pool_bwd.ENABLE A/B; one profile of each path.
Prints the card's name and power limit, one JSON line of kernel results,
and last {"ok": true, "device": {...}}.  Exits non-zero without a CUDA
device or outside a checkout of the repo.  Never imports jax.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

# The serving batch and crop of the default model (aocr.serve's ladder)
B_SERVE, W_SERVE, T_MAX = 512, 100, 50
# The train step bench.py times: B=400 crops of 10-letter words (T=11)
B_TRAIN, WORD_LEN, TRAIN_STEPS = 400, 10, 5
# the pools after conv2, conv4 and conv6 at the train step's shapes
# (NCHW) and their windows: the pool_bwd kernel's three launches a step
POOLS = [((B_TRAIN, 128, 16, 50), (2, 2)), ((B_TRAIN, 256, 8, 25), (2, 1)),
         ((B_TRAIN, 512, 4, 25), (2, 1))]
# the teacher-forced forward without residuals (score) is timed at these
# batches; both teacher-forced kernels are also checked at a ragged one
TF_TIMED, TF_RAGGED = (1, 32, B_TRAIN), 37
# the CLI trainer's data set: 1,000 train and 400 validation crops
N_TRAIN, N_VAL = 1000, 400
# The reference's beam width (-beam_size 5)
BEAM = 5
# beam_step is checked and timed at K=5 and at K=10, the width of the
# beam-10 recognize (wider than beam_loop.MAX_K, so beam_step's route)
BEAM_STEP_K = (BEAM, 10)
# The H100 SXM's published peaks (NVIDIA's data sheet, dense, at 700 W)
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
PEAK_BYTES = 3.35e12


def base_config():
    """The library's default model at full width, as AttentionOCR.create
    makes it: CNN 64->512, encoder 512 per direction, decoder 1024 x 2
    layers with input feed, E=20, V=39.  The CLI trainer's default has no
    input feed (cli_config)."""
    from aocr_torch.config import Config

    return Config(input_feed=True, max_decoder_l=T_MAX)


def cli_config():
    """The CLI trainer's default decoder at full width: base_config
    without input feed (Config's default), so layer 0's weights hold one
    segment (the embedding's rows and h0's) instead of two."""
    return base_config().replace(input_feed=False)


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------ weights / data

def numpy_model(cfg, seed: int):
    """Reference-layout (params, batch_stats) made with numpy: the
    reference's init laws (uniform +-1/sqrt(fan_in), normal embedding),
    with a gain of 2 on the conv weights and the projector so that
    transcripts depend on the image (at init the CNN features barely
    vary between images).  The recurrent weights keep the init law: with
    larger gains the random decoder turns chaotic and float32 summation
    order alone flips tokens after a few dozen steps.  Rows rarely emit
    EOS, so a decode runs all T steps: the early exit's worst case."""
    import numpy as np

    from aocr_torch.models.cnn import CONV_DEFS

    rs = np.random.RandomState(seed)

    def u(bound, *shape, gain=1.0):
        return (rs.uniform(-bound, bound, shape) * gain).astype(np.float32)

    cnn, stats = {}, {}
    for name, i, o, kh, kw, _pad, bn in CONV_DEFS:
        b = 1.0 / math.sqrt(i * kh * kw)
        cnn[name] = {"w": u(b, kh, kw, i, o, gain=2.0), "b": u(b, o)}
        if bn:
            cnn[name + "_bn"] = {"scale": np.ones(o, np.float32),
                                 "bias": np.zeros(o, np.float32)}
            stats[name + "_bn"] = {"mean": np.zeros(o, np.float32),
                                   "var": np.ones(o, np.float32)}

    def layer(i, h):
        return {"wi": u(1 / math.sqrt(i), i, 4 * h),
                "bi": u(1 / math.sqrt(i), 4 * h),
                "wh": u(1 / math.sqrt(h), h, 4 * h),
                "bh": u(1 / math.sqrt(h), 4 * h)}

    He, Hd, E, V = (cfg.encoder_num_hidden, cfg.decoder_num_hidden,
                    cfg.target_embedding_size, cfg.target_vocab_size)
    enc = lambda: {"layers": [layer(cfg.cnn_feature_size if k == 0 else He,
                                    He)
                              for k in range(cfg.encoder_num_layers)]}
    params = {
        "cnn": cnn, "encoder_fw": enc(), "encoder_bw": enc(),
        "decoder": {
            "embedding": rs.standard_normal((V, E)).astype(np.float32),
            # layer 0 reads the embedding, and h~ with input feed
            "layers": [layer((E + Hd * cfg.input_feed) if k == 0 else Hd,
                             Hd)
                       for k in range(cfg.decoder_num_layers)],
            "w_a": u(1 / math.sqrt(Hd), Hd, Hd),
            "w_c": u(1 / math.sqrt(2 * Hd), 2 * Hd, Hd)},
        "projector": {"w": u(1 / math.sqrt(Hd), Hd, V, gain=2.0),
                      "b": u(1 / math.sqrt(Hd), V)},
    }
    return params, stats


def word_images(rs, n: int, width: int):
    """n (32, width) float32 images in [0, 255]: dark vertical strokes of
    random position, width and ink on white, a different layout each."""
    import numpy as np

    imgs = np.full((n, 32, width), 255.0, np.float32)
    for img in imgs:
        for _ in range(rs.randint(2, 9)):
            x = rs.randint(0, width - 3)
            w = rs.randint(1, 4)
            y0, y1 = sorted(rs.randint(4, 29, 2))
            img[y0:y1 + 2, x:x + w] = rs.uniform(0, 90)
    return imgs


# ------------------------------------------------------------ helpers

def cuda_ms(fn, n: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def time_pair(kernel, plain, n: int):
    """(kernel ms, kernel ms, plain ms, plain ms) in turns plain, kernel,
    kernel, plain; the plain version runs n//2 times a turn."""
    p1 = cuda_ms(plain, max(1, n // 2), 1)
    k1 = cuda_ms(kernel, n)
    k2 = cuda_ms(kernel, n)
    p2 = cuda_ms(plain, max(1, n // 2), 1)
    return k1, k2, p1, p2


@contextlib.contextmanager
def plain_route():
    """Run each kernel's plain PyTorch version in its wrapper's place (on
    the card), to hold the kernel route against it."""
    from aocr_torch.ops.cuda import (beam_loop, beam_step, conv1_pool,
                                     decode_step, greedy_loop, lstm_fwd)

    swaps = [(conv1_pool, "conv1_relu_pool", conv1_pool.conv1_relu_pool_plain),
             (lstm_fwd, "lstm_fwd_scan", lstm_fwd.lstm_fwd_scan_plain),
             (decode_step, "fused_decode_tail",
              decode_step.fused_decode_tail_plain),
             (greedy_loop, "fused_greedy_loop",
              greedy_loop.fused_greedy_loop_plain),
             (beam_step, "fused_beam_tail", beam_step.fused_beam_tail_plain),
             (beam_loop, "fused_beam_loop", beam_loop.fused_beam_loop_plain)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    try:
        for m, n, f in swaps:
            setattr(m, n, f)
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


FAILURES: list = []


def check(ok: bool, what: str) -> None:
    """Record a failed check; the run goes on so that one call shows every
    failure and every reading, and exits non-zero at its end."""
    if not ok:
        FAILURES.append(what)
        log(f"FAIL: {what}")


def tensor_bytes(*objs) -> int:
    """Bytes of every tensor in objs (nested tuples, lists, dicts)."""
    import torch

    if len(objs) != 1:
        return sum(tensor_bytes(o) for o in objs)
    o = objs[0]
    if isinstance(o, torch.Tensor):
        return o.numel() * o.element_size()
    if isinstance(o, dict):
        return tensor_bytes(*o.values()) if o else 0
    if isinstance(o, (tuple, list)):
        return tensor_bytes(*o) if o else 0
    return 0


def bound(flops: float, nbytes: int, name: str):
    """(ms, "operations" or "bytes"): the least time the card could take,
    the larger of flops over the peak of the dtype `name` and nbytes (each
    input read once, each output written once) over 3.35 TB/s."""
    t_ops = flops / PEAK_FLOPS[name] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def step_flops(H: int, L: int, V: int, nl: int, input_feed: bool,
               gates: bool = True, proj: bool = True) -> float:
    """Multiply-adds x 2 of one decoder row step: the LSTM stack's gate
    matmuls, q = W_a h, the scores and context vector over L, W_c, and the
    projector over the V real columns."""
    k0 = 2 * H if input_feed else H
    f = 2 * H * H + 4 * L * H + 4 * H * H + (2 * H * V if proj else 0)
    if gates:
        f += 2 * 4 * H * (k0 + (nl - 1) * 2 * H)
    return float(f)


def synthetic_lexicon():
    """bench.py's stand-in for the Synth90k lexicon: 88,172 random
    lowercase words of 3-13 letters (lengths from a gamma law), seed 7;
    returns (words, (N, V) int32 DAWG table)."""
    import string

    import numpy as np

    from aocr_torch.utils import trie

    rng = np.random.RandomState(7)
    chars = list(string.ascii_lowercase)
    words = set()
    while len(words) < 88172:
        n = max(3, min(13, int(rng.gamma(4.0, 1.6))))
        words.add("".join(rng.choice(chars, size=n)))
    words = sorted(words)
    return words, trie.build_transition_table(words)


# ------------------------------------------------------------ phase 2

def kernel_checks(dev, results: dict, table) -> None:
    """Each kernel vs its plain version at the main path's shapes: conv1
    at W=100 and 81 and at the width ladder's ends (16, 320), lstm_fwd
    at their contexts (L=24, 3, 79), then the decoder kernels
    (decoder_kernel_checks) on the library's default decoder; the trie
    operands of decode_step and greedy_loop with `table`, the 88k
    lexicon's DAWG on the card."""
    import torch

    from aocr_torch.ops.cuda import conv1_pool, lstm_fwd

    g = torch.Generator().manual_seed(7)
    rand = lambda *s, lo=-1.0, hi=1.0: (torch.rand(*s, generator=g)
                                        * (hi - lo) + lo)
    cfg = base_config()
    B = B_SERVE
    He = cfg.encoder_num_hidden
    for dt in (torch.float32, torch.bfloat16):
        name = "f32" if dt == torch.float32 else "bf16"
        # conv1: images scaled to [-1, 1], conv1's init law
        for W in (100, 81, 16, 320):
            x = rand(B, 32, W, 1).to(dev, dt)
            w = rand(64, 1, 3, 3, lo=-1 / 3, hi=1 / 3).to(dev)
            b = rand(64, lo=-1 / 3, hi=1 / 3).to(dev)
            got = conv1_pool.conv1_relu_pool(x, w, b)
            want = conv1_pool.conv1_relu_pool_plain(x, w, b)
            tol = 1e-5 if dt == torch.float32 else 2 ** -7
            err = (got.float() - want.float()).abs()
            check(bool((err <= tol + tol * want.float().abs()).all()),
                  f"conv1_pool {name} W={W}: max err {err.max().item()}")
            results.setdefault(("conv1_pool", name), []).append(
                err.max().item())
            log(f"check conv1_pool {name} B={B} W={W}: max_abs_err "
                f"{err.max().item():.3g} (tol {tol:.3g} abs + rel)")
        # lstm_fwd: one encoder direction, H=512, over the contexts of
        # W = 100, 16 and 320
        tol = 1e-4 if dt == torch.float32 else 5e-2
        wh = rand(He, 4 * He, lo=-He ** -0.5, hi=He ** -0.5).to(dev, dt)
        c0, h0 = torch.zeros(B, He, device=dev), torch.zeros(B, He, device=dev)
        for L in (W_SERVE // 4 - 1, 3, 79):
            xp = rand(L, B, 4 * He).to(dev, dt)
            for reverse in (False, True):
                hs, (cf, hf) = lstm_fwd.lstm_fwd_scan(wh, xp, c0, h0, reverse)
                hs_p, (cf_p, hf_p) = lstm_fwd.lstm_fwd_scan_plain(
                    wh, xp, c0, h0, reverse)
                err = max((a.float() - b.float()).abs().max().item()
                          for a, b in ((hs, hs_p), (cf, cf_p), (hf, hf_p)))
                check(err <= tol, f"lstm_fwd {name} L={L} reverse={reverse}:"
                                  f" {err}")
                results.setdefault(("lstm_fwd", name), []).append(err)
                log(f"check lstm_fwd {name} B={B} L={L} H={He} "
                    f"reverse={reverse}: max_abs_err {err:.3g} (tol "
                    f"{tol:.3g})")
        # past 128 units a block (H > 2048) bf16 warps hold 3 mma tiles
        L = W_SERVE // 4 - 1
        Hw, Bw = 2400, 8
        wh = rand(Hw, 4 * Hw, lo=-Hw ** -0.5, hi=Hw ** -0.5).to(dev, dt)
        xp = rand(L, Bw, 4 * Hw).to(dev, dt)
        z = torch.zeros(Bw, Hw, device=dev)
        got = lstm_fwd.lstm_fwd_scan(wh, xp, z, z, False)
        want = lstm_fwd.lstm_fwd_scan_plain(wh, xp, z, z, False)
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in ((got[0], want[0]), (got[1][0], want[1][0]),
                               (got[1][1], want[1][1])))
        check(err <= tol, f"lstm_fwd {name} H={Hw} B={Bw}: {err}")
        log(f"check lstm_fwd {name} B={Bw} L={L} H={Hw} (plan "
            f"{lstm_fwd.plan(Hw, Bw, dt, 1)}): max_abs_err {err:.3g} "
            f"(tol {tol:.3g})")
    decoder_kernel_checks(dev, results, table, cfg, g, DECODE_TIMED,
                          ("auto", "rows"))
    markup_loop_checks(dev, g)


def markup_trie(dev, V: int, g, nodes: int = 64, fan: int = 12):
    """A random (nodes, V) int32 transition table over im2markup's
    vocabulary: `fan` children a node among the tokens past EOS."""
    import torch

    from aocr_torch import vocab

    table = torch.full((nodes, V), -1, dtype=torch.int32)
    for n in range(nodes):
        kids = vocab.EOS + 1 + torch.randperm(V - vocab.EOS - 1,
                                              generator=g)[:fan]
        table[n, kids] = torch.randint(0, nodes, (fan,), generator=g,
                                       dtype=torch.int32)
    return table.to(dev)


def markup_loop_checks(dev, g) -> None:
    """greedy_loop at im2markup's decode (models/im2markup.py: L=1,240,
    H=512, one layer, input feed, E=80, V=503, T=150) in bf16, where its
    attention is split by positions: at B=256 (the benchmark's batch), a
    ragged B=37, and B=256 under a random trie, PAD and EOS biased off so
    that every row runs all 150 steps; each against the plain version
    (check_loop's tolerances), the launch counts zeroed just before it
    and then one launch, split; its plan line logged."""
    import torch

    from aocr_torch import vocab, weights
    from aocr_torch.models import im2markup
    from aocr_torch.ops import cuda
    from aocr_torch.ops.cuda import greedy_loop

    cfg = im2markup.config()
    Hd, E, nl, T = (cfg.decoder_num_hidden, cfg.target_embedding_size,
                    cfg.decoder_num_layers, cfg.max_decoder_l)
    L, dt = 1240, torch.bfloat16
    p, _ = numpy_model(cfg, 5)
    tp, _ = weights.from_numpy({"decoder": p["decoder"],
                                "projector": p["projector"]}, {}, dev)
    tables = greedy_loop.build_tables(tp["decoder"], tp["projector"], E,
                                      True, dt)
    tables["pb"][[vocab.PAD, vocab.EOS]] = -1e4
    V, Vp = tables["eg"].shape[0], tables["pw"].shape[1]
    trie = markup_trie(dev, V, g)
    for B, trie_table in ((256, None), (37, None), (256, trie)):
        what = (", im2markup"
                + (", a random trie" if trie_table is not None else ""))
        ctx = (torch.rand(L, B, Hd, generator=g) * 2 - 1).to(dev, dt)
        c0 = (torch.rand(B, Hd, generator=g) * 2 - 1).to(dev)
        h0 = (torch.rand(B, Hd, generator=g) * 2 - 1).to(dev)
        cuda.reset_launch_counts()
        check_loop("bf16", tables, (ctx, c0, h0, nl, True, T), 3e-2, what,
                   trie_table=trie_table)
        moved = (greedy_loop.launches, greedy_loop.launches_split)
        check(moved == (1, 1), f"greedy_loop bf16{what} B={B}: launches, "
                               f"launches_split {moved}, not (1, 1)")
        line = greedy_loop.plans[(Hd, B, dt, L, Vp, nl)][1]
        check("attention split by positions" in line,
              f"greedy_loop bf16{what} B={B}: not split ({line})")
        log(f"  {line}")


def decoder_kernel_checks(dev, results: dict, table, cfg, g, batches,
                          routes) -> None:
    """The greedy decoder kernels of cfg's decoder vs their plain
    versions, float32 and bf16, at the recognition shape (L=24): the
    decode_step checks at `batches` on `routes` (decode_step_checks),
    then greedy_loop over T steps at B=512, with about half and all of
    the rows stopping at step 1, and under the 88k trie."""
    import torch

    from aocr_torch import weights
    from aocr_torch.ops.cuda import greedy_loop

    rand = lambda *s, lo=-1.0, hi=1.0: (torch.rand(*s, generator=g)
                                        * (hi - lo) + lo)
    B, L, T = B_SERVE, W_SERVE // 4 - 1, T_MAX
    Hd, E, feed = (cfg.decoder_num_hidden, cfg.target_embedding_size,
                   cfg.input_feed)
    what = "" if feed else ", no input feed"
    for dt in (torch.float32, torch.bfloat16):
        name = "f32" if dt == torch.float32 else "bf16"
        # decoder tables from the model's weights (numpy_model)
        p, _ = numpy_model(cfg, 3)
        tp, _ = weights.from_numpy({"decoder": p["decoder"],
                                    "projector": p["projector"]}, {}, dev)
        tables = greedy_loop.build_tables(tp["decoder"], tp["projector"], E,
                                          feed, dt)
        ctx = rand(L, B, Hd).to(dev, dt)
        # tail: one step at the batches, the 88k trie plane, an
        # all-invalid row and an all-NaN row
        decode_step_checks(name, dt, tables, table, g, results, batches,
                           routes)
        tol = 1e-4 if dt == torch.float32 else 3e-2
        # loop: the whole T-step decode; then with the EOS bias raised so
        # that about half the rows stop at step 1 (the PAD/EOS freeze beside
        # live rows of the same block), and so that every row does (each
        # block's early exit)
        c0, h0 = rand(B, Hd).to(dev), rand(B, Hd).to(dev)
        loop_args = (ctx, c0, h0, cfg.decoder_num_layers, feed, T)
        err = check_loop(name, tables, loop_args, tol, what)
        results.setdefault(("greedy_loop", name), []).append(err)
        for frac in (0.5, 1.0):
            eos = eos_tables(tables, loop_args, frac)
            err = check_loop(name, eos, loop_args, tol,
                             f"{what}, EOS at step 1 for ~{frac:.0%} of rows")
            results[("greedy_loop", name)].append(err)
        err = check_loop(name, tables, loop_args, tol, f"{what}, 88k trie",
                         trie_table=table)
        results[("greedy_loop", name)].append(err)


# decode_step's checked and timed batches: the serving latencies and the
# serving batch (recognize's tail route)
DECODE_TIMED = (1, 8, 32, B_SERVE)


def decode_step_checks(name, dt, tables, table, g, results, batches,
                       routes) -> None:
    """decode_step on `routes` ("auto": the cluster plan; "rows": the
    first port's rows kernel, decode_step.ROUTE = "rows") against its
    plain version at `batches`, the decoder of the recognition shape
    (L=24): h~ and the
    deltas within tol (1e-4 float32, 3e-2 bf16), tokens equal but at the
    plain version's near-ties; prev a mix of live and frozen rows; from
    B=8 on row 3 all NaN (must pick PAD, as the plain version does); at
    B=512 also the 88k trie plane at inner nodes, with row 5 (live) left
    no valid token (PAD at -1e30): every pick valid.  Each route's launch
    count must move."""
    import torch

    from aocr_torch import vocab
    from aocr_torch.ops.cuda import decode_step, greedy_loop

    dev = table.device
    rand = lambda *s: torch.rand(*s, generator=g) * 2 - 1
    L, H, V = W_SERVE // 4 - 1, tables["wa"].shape[0], tables["eg"].shape[0]
    Vp = tables["pw"].shape[1]
    tol = 1e-4 if dt == torch.float32 else 3e-2
    w = (tables["wa"], tables["wc"], tables["pw"], tables["pb"])
    for route in routes:
        decode_step.ROUTE = route
        try:
            for B in batches:
                ctx = rand(L, B, H).to(dev, dt)
                h = rand(B, H)
                if B >= 8:
                    h[3] = float("nan")
                h = h.to(dev, dt)
                prev = torch.randint(0, V, (B,), generator=g,
                                     dtype=torch.int32).to(dev)
                prev[:B // 4] = 5  # more live rows
                if B >= 8:
                    prev[3] = 5  # the NaN row live: all its log-probs NaN
                planes = [None]
                if B == B_SERVE:
                    inner = (table >= 0).any(1).nonzero().flatten()
                    nodes = inner[torch.randint(0, len(inner), (B,),
                                                generator=g).to(dev)]
                    plane = greedy_loop.trie_valid(table, nodes.int(), Vp,
                                                   pad_ok=True)
                    plane[5] = 0.0
                    plane[3] = 1.0  # the NaN row stays all NaN
                    prev[5] = 5
                    planes.append(plane)
                for plane in planes:
                    what = (f"decode_step {name} {route} route B={B}"
                            + (" 88k trie plane" if plane is not None
                               else ""))
                    packed = decode_step.pack_weights(
                        w[0], w[1], ctx, w[2], V)
                    n = (decode_step.launches, decode_step.launches_rows)
                    ht, tok, d = decode_step.fused_decode_tail(
                        h, ctx, prev, *w, valid=plane, packed=packed)
                    moved = (decode_step.launches - n[0],
                             decode_step.launches_rows - n[1])
                    check(moved == (1, int(route == "rows")),
                          f"{what}: launch counts moved {moved}")
                    ht_p, tok_p, d_p = decode_step.fused_decode_tail_plain(
                        h, ctx, prev, *w, valid=plane)
                    _, logp0 = decode_step.attention_logp_tail(
                        h, ctx, *w, dt)
                    _, _, logp = decode_step.freeze_and_pick(logp0, prev,
                                                             plane)
                    top2 = logp.topk(2, dim=-1).values
                    fin = torch.isfinite(ht_p).all(1)
                    clear = ((top2[:, 0] - top2[:, 1]) > tol) & fin
                    err = max((ht - ht_p)[fin].abs().max().item(),
                              (d - d_p)[fin].abs().max().item())
                    check(err <= tol, f"{what}: max err {err}")
                    check(bool((tok == tok_p)[clear].all()),
                          f"{what}: tokens differ beyond near-ties")
                    if B >= 8:
                        check(int(tok[3]) == int(tok_p[3]) == vocab.PAD,
                              f"{what}: the all-NaN row picked "
                              f"{int(tok[3])} (plain {int(tok_p[3])})")
                    if plane is not None:
                        ok = plane.gather(1, tok.long()[:, None])[:, 0] > 0
                        ok[5] = True  # no valid token there
                        check(bool(ok.all()),
                              f"{what}: a token the plane forbids")
                        check(int(tok[5]) == vocab.PAD
                              and float(d[5]) == float(d_p[5]),
                              f"{what}: the row with no valid token picked "
                              f"{int(tok[5])} at {float(d[5])}")
                    results.setdefault(("decode_step", name), []).append(err)
                    log(f"check {what} L={L} H={H}: max_abs_err {err:.3g} "
                        f"(tol {tol:.3g}); tokens agree "
                        f"{(tok == tok_p).float().mean().item():.4f} (all "
                        f"rows with margin > tol)"
                        + ("; the all-NaN row picks PAD" if B >= 8 else ""))
        finally:
            decode_step.ROUTE = "auto"


def eos_tables(tables: dict, loop_args, frac: float) -> dict:
    """A copy of the loop tables whose EOS bias makes `frac` of the rows
    emit EOS at step 1 (bisection on the plain version's first step)."""
    from aocr_torch import vocab
    from aocr_torch.ops.cuda import greedy_loop

    ctx, c0, h0, nl, feed, _T = loop_args
    lo, hi = -100.0, 100.0
    for _ in range(30):
        mid = (lo + hi) / 2
        t = dict(tables, pb=tables["pb"].clone())
        t["pb"][vocab.EOS] += mid
        lab, _ = greedy_loop.fused_greedy_loop_plain(ctx, c0, h0, t, nl, feed,
                                                     1)
        if (lab[:, 0] == vocab.EOS).float().mean().item() < frac:
            lo = mid
        else:
            hi = mid
    t = dict(tables, pb=tables["pb"].clone())
    t["pb"][vocab.EOS] += hi
    return t


def check_loop(name: str, tables: dict, loop_args, tol: float, what: str,
               trie_table=None) -> float:
    """greedy_loop against its plain version: rows agree up to the first
    step whose plain margin is a near-tie (< tol); after EOS a row holds
    PAD; scores of agreeing rows within stol; under a trie every
    transcript is a path of it.  Returns the score error."""
    import torch

    from aocr_torch import vocab
    from aocr_torch.ops.cuda import greedy_loop

    ctx, c0, h0, nl, feed, T = loop_args
    B = ctx.shape[1]
    lab, sc = greedy_loop.fused_greedy_loop(ctx, c0, h0, tables, nl, feed, T,
                                            trie_table=trie_table)
    lab_p, sc_p, margin = greedy_loop.fused_greedy_loop_plain(
        ctx, c0, h0, tables, nl, feed, T, return_margins=True,
        trie_table=trie_table)
    differ = lab != lab_p
    first = torch.where(differ.any(1), differ.float().argmax(1),
                        torch.full_like(differ[:, 0], T, dtype=torch.long))
    for r in differ.any(1).nonzero().flatten().tolist():
        check(margin[r, first[r]].item() < tol,
              f"greedy_loop {name}{what}: row {r} differs at step "
              f"{first[r].item()} with margin {margin[r, first[r]]}")
    ended = (lab == vocab.EOS).cumsum(1) > 0
    after = torch.cat([torch.zeros_like(ended[:, :1]), ended[:, :-1]], 1)
    check(bool((lab[after] == vocab.PAD).all()),
          f"greedy_loop {name}{what}: a token after EOS is not PAD")
    if trie_table is not None:
        node = torch.zeros_like(lab[:, 0])
        for t in range(T):
            tok = lab[:, t]
            step = trie_table[node.long(), tok.long()]
            ok = (step >= 0) | ((tok == vocab.PAD) & (t > 0))
            check(bool(ok.all()), f"greedy_loop {name}{what}: step {t} "
                                  "leaves the trie")
            node = torch.where(tok == vocab.PAD, node, step.clamp(min=0))
    same = ~differ.any(1)
    err = (sc - sc_p)[same].abs().max().item() if bool(same.any()) else 0.0
    stol = 1e-3 if tables["wa"].dtype == torch.float32 else 0.5
    check(err <= stol, f"greedy_loop {name}{what}: score err {err}")
    steps = (lab != vocab.PAD).sum(1).float()
    log(f"check greedy_loop {name} B={B} T={T} L={ctx.shape[0]} "
        f"H={ctx.shape[2]}{what}: rows identical "
        f"{same.float().mean().item():.4f} (the rest diverge at a near-tie "
        f"< {tol:.3g}); rows ended by EOS {ended[:, -1].float().mean():.4f},"
        f" mean steps {steps.mean().item():.2f}; score max_abs_err "
        f"{err:.3g} (tol {stol:.3g})")
    return err


# ------------------------------------------------------------ phase 3

def end_to_end(dev, seed: int, base=None):
    """Drive AttentionOCR.recognize on base's model (by default the
    library's, base_config); returns (launch counts, the models, the
    requests)."""
    import numpy as np
    import torch

    from aocr_torch import weights
    from aocr_torch.api import AttentionOCR
    from aocr_torch.ops import cuda
    from aocr_torch.ops.cuda import decode_step

    base = base or base_config()
    tag = "" if base.input_feed else "no input feed "
    np_params, np_stats = numpy_model(base, seed)
    rs = np.random.RandomState(seed + 1)
    requests = [word_images(rs, n, W_SERVE) for n in (1, 8, 32, B_SERVE)]
    mixed = [im for w in (100, 81, 121, 100, 81, 181, 100, 81)
             for im in word_images(rs, 2, w)]
    requests.append(mixed)

    def model(dtype, route):
        cfg = base.replace(compute_dtype=dtype, pallas_greedy=route)
        p, s = weights.from_numpy(np_params, np_stats)
        return AttentionOCR(cfg, p, s, device=dev)

    models = {(dt, r): model(dt, r) for dt in ("bfloat16", "float32")
              for r in ("loop", "tail")}
    cuda.reset_launch_counts()
    outs = {k: [m.recognize(req) for req in requests]
            for k, m in models.items()}
    torch.cuda.synchronize()
    counts = cuda.launch_counts()
    log(f"{tag}recognize path launch counts: {counts}")
    for k in ("conv1_pool", "lstm_fwd", "decode_step", "greedy_loop"):
        check(counts[k] > 0, f"kernel {k} never launched on the {tag}"
                             "recognize path")
    # the tail route's steps all on decode_step's cluster plans
    check(decode_step.launches_rows == 0,
          f"decode_step took its rows route {decode_step.launches_rows} "
          "times on the recognize path")

    for (dt, route), res in outs.items():
        for req, (words, scores) in zip(requests, res):
            check(len(words) == len(req) and scores.shape == (len(req),),
                  "recognize returned the wrong number of results")
            check(bool(np.isfinite(scores).all()), "non-finite scores")
            check(bool((scores <= 0).all()), "log-prob scores above 0")
    with plain_route():
        plain = {k: [m.recognize(req) for req in requests]
                 for k, m in models.items()}
    for (dt, route), res in outs.items():
        got = [w for words, _ in res for w in words]
        want = [w for words, _ in plain[(dt, route)] for w in words]
        agree = float(np.mean([a == b for a, b in zip(got, want)]))
        lens = [len(w) for w in got]
        log(f"e2e {tag}{dt} {route}: {len(got)} transcripts, "
            f"{len(set(got))} distinct, mean length {np.mean(lens):.2f}; "
            f"agreement with the plain route on the card {agree:.4f}")
        if dt == "float32":
            check(got == want, f"{tag}float32 {route}: kernel and plain "
                               "routes disagree")
            dsc = max(np.abs(a[1] - b[1]).max() for a, b in
                      zip(res, plain[(dt, route)]))
            check(dsc <= 1e-3, f"{tag}float32 {route}: score gap {dsc}")
    # a reference on a small input: the port on the CPU (plain versions)
    small = requests[2][:4]
    ref = AttentionOCR(models[("float32", "loop")].cfg,
                       *weights.from_numpy(np_params, np_stats), device="cpu")
    want_w, want_s = ref.recognize(small)
    for route in ("loop", "tail"):
        got_w, got_s = models[("float32", route)].recognize(small)
        check(got_w == want_w, f"{tag}float32 {route}: card and CPU "
                               "disagree")
        check(bool(np.allclose(got_s, want_s, rtol=1e-4, atol=1e-3)),
              f"{tag}float32 {route}: card and CPU scores differ")
    log(f"e2e {tag}float32 card == CPU on 4 images: {want_w}")
    return counts, models, requests


# ------------------------------------------------------------ beam kernels

def beam_parting(name, what, got, want, margin, tol) -> int:
    """Rows where the kernel's and the plain version's (token, parent)
    histories, each (T, B, K), part must part at a step whose plain margin
    (T, B) is a near-tie (< tol): the first step where a token or a parent
    differs (two candidates that swap slots at a tie can share a token, and
    every later step of the row differs from then on); returns how many
    rows parted."""
    differ = ((got[0] != want[0]) | (got[1] != want[1])).any(-1)  # (T, B)
    rows = differ.any(0).nonzero().flatten().tolist()
    worst = 0.0
    for b in rows:
        t = int(differ[:, b].float().argmax())
        worst = max(worst, margin[t, b].item())
        check(margin[t, b].item() < tol,
              f"beam_loop {name}{what}: row {b} parts at step {t} with "
              f"plain margin {margin[t, b].item():.3g}")
    if rows:
        log(f"  beam_loop {name}{what}: the widest plain margin at a "
            f"parting step is {worst:.3g}")
    return len(rows)


def beam_step_checks(name, dt, K, ctx, tables, table, tiny, results, g,
                     tol) -> None:
    """beam_step against its plain version for one step of B x K beams
    (some frozen): without a trie, with the 88k lexicon's plane, and with a
    tiny lexicon's plane without PAD (rows run short of K valid candidates
    and refill).  h~ within tol, picks that differ only at plain near-ties
    (< tol), scores of the other rows within 1e-5 relative in float32."""
    import torch

    from aocr_torch import vocab
    from aocr_torch.ops.cuda import beam_step, greedy_loop

    L, B, Hd = ctx.shape
    dev = ctx.device
    V = base_config().target_vocab_size
    f32 = dt == torch.float32
    rand = lambda *s: torch.rand(*s, generator=g) * 2 - 1
    vp = tables["pw"].shape[1]
    h = rand(B, K * Hd).to(dev, dt)
    prev = torch.randint(3, V, (B, K), generator=g, dtype=torch.int32)
    prev[::7, 1], prev[::11] = vocab.EOS, vocab.PAD
    scores = (-20 * torch.rand(B, K, generator=g)).sort(
        1, descending=True)[0]
    prev, scores = prev.to(dev), scores.to(dev)
    inner = (table >= 0).any(1).nonzero().flatten()
    nodes = inner[torch.randint(0, len(inner), (B, K), generator=g)
                  .to(dev)].to(torch.int32)
    tnodes = torch.randint(0, tiny.shape[0], (B, K), generator=g,
                           dtype=torch.int32).to(dev)
    planes = {
        "": None,
        ", 88k trie": greedy_loop.trie_valid(
            table, nodes, vp, pad_ok=True).reshape(B, -1),
        ", refill (tiny lexicon, no PAD)": greedy_loop.trie_valid(
            tiny, tnodes, vp, pad_ok=False).reshape(B, -1)}
    for what, plane in planes.items():
        args = (ctx, h, prev, scores, tables["wa"], tables["wc"],
                tables["pw"], tables["pb"], K, V)
        got = beam_step.fused_beam_tail(*args, valid=plane)
        want = beam_step.fused_beam_tail_plain(*args, valid=plane)
        _, total = beam_step.beam_totals(*args, valid=plane)
        margin = beam_step.topk_margin(total, K)
        differ = ((got[2] != want[2]) | (got[3] != want[3])).any(1)
        if plane is not None:
            differ |= got[4] != want[4]
        same = ~differ
        herr = (got[0] - want[0]).abs().max().item()
        serr = ((got[1] - want[1]).abs() / want[1].abs().clamp(
            min=1e-30))[same].max().item()
        check(herr <= tol, f"beam_step {name} K={K}{what}: h~ err {herr}")
        check(bool((margin[differ] < tol).all()),
              f"beam_step {name} K={K}{what}: picks differ beyond "
              "near-ties")
        check(serr <= (1e-5 if f32 else 1e-2),
              f"beam_step {name} K={K}{what}: score rel err {serr}")
        results.setdefault(("beam_step", name), []).append(herr)
        nv = (f", rows short of K valid {(got[4] < K).sum().item()}"
              if plane is not None else "")
        log(f"check beam_step {name} B={B} K={K} L={L} H={Hd}{what}: "
            f"h~ max_abs_err {herr:.3g} (tol {tol:.3g}); rows with "
            f"identical picks {same.float().mean().item():.4f} (the rest"
            f" at near-ties < {tol:.3g}); score rel err {serr:.3g}{nv}")
    check(bool((got[4] < K).any()),
          f"beam_step {name} K={K}: the refill case never refilled")
    log(f"  {beam_step.plans[(Hd, B, K, dt, L, vp)][1]}")


def beam_kernel_checks(dev, results: dict, table, cfg=None) -> None:
    """beam_step and beam_loop against their plain versions at the beam
    path's shapes (B=512, K=5, T=50, L=24, cfg's decoder, by default the
    library's), float32 and bf16: without a trie, with the 88k lexicon's
    table, under length_normalize, and with a tiny lexicon where most
    beams dead-end (the beam_step plane then has no PAD, so rows run short
    of K valid candidates and refill)."""
    import torch

    from aocr_torch import vocab, weights
    from aocr_torch.models.decoder import DecoderState
    from aocr_torch.ops.cuda import beam_loop, beam_step, greedy_loop
    from aocr_torch.utils import trie

    g = torch.Generator().manual_seed(27)
    rand = lambda *s, lo=-1.0, hi=1.0: (torch.rand(*s, generator=g)
                                        * (hi - lo) + lo)
    cfg = cfg or base_config()
    B, L, T, K = B_SERVE, W_SERVE // 4 - 1, T_MAX, BEAM
    V, Hd, E = (cfg.target_vocab_size, cfg.decoder_num_hidden,
                cfg.target_embedding_size)
    nl, feed = cfg.decoder_num_layers, cfg.input_feed
    nofeed = "" if feed else ", no input feed"
    p, _ = numpy_model(cfg, 3)
    tp, _ = weights.from_numpy({"decoder": p["decoder"],
                                "projector": p["projector"]}, {}, dev)
    tiny = torch.from_numpy(trie.build_transition_table(
        ["zq", "zz", "qz"])).to(dev)
    for dt in (torch.float32, torch.bfloat16):
        name = "f32" if dt == torch.float32 else "bf16"
        f32 = dt == torch.float32
        tol = 1e-4 if f32 else 3e-2   # h~ and near-tie margins, as decode
        tables = greedy_loop.build_tables(tp["decoder"], tp["projector"], E,
                                          feed, dt)
        ctx = rand(L, B, Hd).to(dev, dt)
        # beam_step: one step of B x K beams, some frozen, at K=5 and at
        # K=10 (recognize's route for beams wider than beam_loop.MAX_K)
        for K in BEAM_STEP_K:
            beam_step_checks(name, dt, K, ctx, tables, table, tiny, results,
                             g, tol)
        # beam_loop: the whole search from one t=1 state
        st = DecoderState(attn=rand(B, Hd).to(dev),
                          cs=tuple(rand(B, Hd).to(dev) for _ in range(nl)),
                          hs=tuple(rand(B, Hd).to(dev) for _ in range(nl)))
        for what, tr, lennorm in (("", None, False),
                                  (", length_normalize", None, True),
                                  (", 88k trie", table, False),
                                  (", tiny lexicon (dead ends)", tiny,
                                   True)):
            err = check_beam_loop(name, nofeed + what, ctx, st, tables, tr,
                                  lennorm, tol, g, feed)
            results.setdefault(("beam_loop", name), []).append(err)


def beam_loop_args(ctx, st, tables, table, lennorm, g, feed=True):
    """fused_beam_loop's arguments (before trie_table) for a search of
    BEAM beams over T_MAX steps from the t=1 state st, with input feed or
    not: t=1 picks drawn from g (the trie's root children with a table),
    their scores sorted as a top-K's."""
    import torch

    cfg = base_config()
    B, dev = ctx.shape[1], ctx.device
    K, V = BEAM, cfg.target_vocab_size
    if table is None:
        tok0 = torch.randint(3, V, (B, K), generator=g, dtype=torch.int32)
        tok0, nodes0 = tok0.to(dev), None
    else:
        roots = (table[0] >= 0).nonzero().flatten()
        tok0 = roots[torch.randint(0, len(roots), (B, K), generator=g)
                     .to(dev)].to(torch.int32)
        nodes0 = table[0][tok0.long()].clamp(min=0).to(torch.int32)
    sc0 = (-3 * torch.rand(B, K, generator=g)).sort(1, descending=True)[0]
    return (ctx, st, tok0, sc0.to(dev), nodes0, tables,
            cfg.decoder_num_layers, feed, T_MAX, K, lennorm)


def check_beam_loop(name, what, ctx, st, tables, table, lennorm, tol, g,
                    feed=True):
    """beam_loop against its plain version from one t=1 state: histories
    part only at plain near-ties; scores (1e-5 relative in float32, 0.5
    in bf16), lengths and refill counts of the other rows agree.  Returns
    the rows' max score error."""
    import torch

    from aocr_torch import vocab
    from aocr_torch.ops.cuda import beam_loop

    L, B, H = ctx.shape
    K, T = BEAM, T_MAX
    args = beam_loop_args(ctx, st, tables, table, lennorm, g, feed)
    got = beam_loop.fused_beam_loop(*args, trie_table=table)
    want = beam_loop.fused_beam_loop_plain(*args, trie_table=table,
                                           return_margins=True)
    margin = want[-1]
    parted = beam_parting(name, what, got[:2], want[:2], margin, tol)
    same = ~((got[0] != want[0]) | (got[1] != want[1])).any(-1).any(0)
    f32 = tables["wa"].dtype == torch.float32
    rel = ((got[2] - want[2]).abs() / want[2].abs().clamp(min=1e-30))
    err = (got[2] - want[2]).abs()[same].max().item() if bool(
        same.any()) else 0.0
    if f32:
        check(rel[same].max().item() <= 1e-5 if bool(same.any()) else True,
              f"beam_loop {name}{what}: score rel err "
              f"{rel[same].max().item()}")
        check(bool((got[3] == want[3])[same].all()),
              f"beam_loop {name}{what}: lengths differ")
    else:
        check(err <= 0.5, f"beam_loop {name}{what}: score err {err}")
    if table is not None and f32 and parted == 0:
        check(int(got[4]) == int(want[4]) and int(got[5]) == int(want[5]),
              f"beam_loop {name}{what}: refills {got[4:6]} vs {want[4:6]}")
    live = ~((got[0][:-1] == vocab.PAD) | (got[0][:-1] == vocab.EOS)).all(-1)
    steps = live.sum().item() / B
    refills = (f", refills {int(got[4])} (plain {int(want[4])})"
               if table is not None else "")
    log(f"check beam_loop {name} B={B} K={K} T={T} L={L} H={H}{what}: rows "
        f"identical {same.float().mean().item():.4f} ({parted} part at "
        f"plain near-ties < {tol:.3g}); a row live {steps:.2f} of {T - 1} "
        f"beam steps on average; score "
        f"max_abs_err {err:.3g} (rel {rel[same].max().item() if bool(same.any()) else 0:.3g})"
        f"{refills}")
    return err


# ------------------------------------------------------------ phase 3b

def lexicon_prefixes(words) -> set:
    return {w[:i] for w in words for i in range(len(w) + 1)}


def beam_end_to_end(dev, seed: int, lexicon, base=None):
    """Drive recognize(beam_size=5) and the dictionary on base's model (by
    default the library's); returns (launch counts, the models, the
    requests)."""
    import numpy as np
    import torch

    from aocr_torch import weights
    from aocr_torch.api import AttentionOCR
    from aocr_torch.ops import cuda

    words, table = lexicon
    prefixes = lexicon_prefixes(words)
    base = base or base_config()
    tag = "" if base.input_feed else "no input feed "
    np_params, np_stats = numpy_model(base, seed)
    rs = np.random.RandomState(seed + 5)
    requests = [word_images(rs, B_SERVE, W_SERVE),
                [im for w in (100, 81, 121, 100, 81, 181, 100, 81)
                 for im in word_images(rs, 2, w)]]

    def model(dtype, route):
        cfg = base.replace(compute_dtype=dtype, pallas_beam=route,
                           pallas_greedy="tail" if route == "tail"
                           else "loop")
        return AttentionOCR(cfg, *weights.from_numpy(np_params, np_stats),
                            device=dev)

    models = {(dt, r): model(dt, r) for dt in ("bfloat16", "float32")
              for r in ("loop", "tail")}

    def drive(m):
        """beam-5 on each request, then greedy and beam-5 under the
        lexicon: {(mode, request index): (words, scores)}"""
        out = {}
        for i, req in enumerate(requests):
            out[("beam5", i)] = m.recognize(req, beam_size=BEAM)
        m.set_dictionary_table(table)
        for i, req in enumerate(requests):
            out[("dict_greedy", i)] = m.recognize(req, beam_size=1)
            out[("dict_beam5", i)] = m.recognize(req, beam_size=BEAM)
        m.clear_dictionary()
        return out

    cuda.reset_launch_counts()
    outs = {k: drive(m) for k, m in models.items()}
    torch.cuda.synchronize()
    counts = cuda.launch_counts()
    log(f"{tag}beam path launch counts: {counts}")
    for k in ("conv1_pool", "lstm_fwd", "decode_step", "greedy_loop",
              "beam_step", "beam_loop"):
        check(counts[k] > 0, f"kernel {k} never launched on the {tag}beam "
                             "path")

    for (dt, route), res in outs.items():
        for (mode, i), (ws, sc) in res.items():
            check(len(ws) == len(requests[i]) and sc.shape == (len(ws),),
                  "recognize returned the wrong number of results")
            check(bool(np.isfinite(sc).all()) and bool((sc <= 0).all()),
                  f"{dt} {route} {mode}: bad scores")
            if mode.startswith("dict"):
                check(all(w in prefixes for w in ws),
                      f"{dt} {route} {mode}: a transcript off the lexicon")
    with plain_route():
        plain = {k: drive(m) for k, m in models.items()}
    for (dt, route), res in outs.items():
        for mode in ("beam5", "dict_greedy", "dict_beam5"):
            got = [w for i in range(len(requests)) for w in res[(mode, i)][0]]
            want = [w for i in range(len(requests))
                    for w in plain[(dt, route)][(mode, i)][0]]
            agree = float(np.mean([a == b for a, b in zip(got, want)]))
            lens = [len(w) for w in got]
            in_lex = float(np.mean([w in set(words) for w in got]))
            log(f"e2e {tag}{dt} {route} {mode}: {len(got)} transcripts, "
                f"{len(set(got))} distinct, mean length {np.mean(lens):.2f}"
                + (f", in the lexicon {in_lex:.4f}" if mode != "beam5"
                   else "")
                + f"; agreement with the plain route on the card "
                f"{agree:.4f}")
            if dt == "float32":
                check(got == want, f"{tag}float32 {route} {mode}: kernel "
                                   "and plain routes disagree")
                dsc = max(np.abs(res[(mode, i)][1]
                                 - plain[(dt, route)][(mode, i)][1]).max()
                          for i in range(len(requests)))
                check(dsc <= 1e-3, f"float32 {route} {mode}: score gap "
                                   f"{dsc}")
    # a reference on a small input: the port on the CPU (plain versions)
    small = requests[0][:4]
    ref = AttentionOCR(models[("float32", "loop")].cfg,
                       *weights.from_numpy(np_params, np_stats), device="cpu")
    for dictionary in (False, True):
        if dictionary:
            ref.set_dictionary_table(table)
        want_w, want_s = ref.recognize(small, beam_size=BEAM)
        for route in ("loop", "tail"):
            m = models[("float32", route)]
            if dictionary:
                m.set_dictionary_table(table)
            got_w, got_s = m.recognize(small, beam_size=BEAM)
            m.clear_dictionary()
            check(got_w == want_w, f"{tag}float32 {route} beam-5 "
                                   f"dictionary={dictionary}: card and CPU "
                                   "disagree")
            check(bool(np.allclose(got_s, want_s, rtol=1e-4, atol=1e-3)),
                  f"float32 {route} beam-5: card and CPU scores differ")
        log(f"e2e {tag}float32 beam-5{' dictionary' if dictionary else ''}"
            f" card == CPU on 4 images: {want_w}")
    return counts, models, requests


def beam10_end_to_end(dev, models, requests):
    """Drive recognize(beam_size=10) on the B=512 request, bf16 and
    float32: wider than beam_loop.MAX_K, so the default route runs the
    plain LSTM stack and one beam_step launch a step.  float32 transcripts
    must equal the plain route's; returns the launch counts."""
    import numpy as np
    import torch

    from aocr_torch.ops import cuda
    from aocr_torch.ops.cuda import beam_loop

    K = BEAM_STEP_K[1]
    batch = requests[0]
    mods = {dt: models[(dt, "loop")] for dt in ("bfloat16", "float32")}
    tag = "" if mods["float32"].cfg.input_feed else "no input feed "
    check(K > beam_loop.MAX_K, "beam-10 would not take beam_step's route")
    cuda.reset_launch_counts()
    outs = {dt: m.recognize(batch, beam_size=K) for dt, m in mods.items()}
    torch.cuda.synchronize()
    counts = cuda.launch_counts()
    log(f"{tag}beam-{K} path launch counts: {counts}")
    check(counts["beam_step"] > 0 and counts["beam_loop"] == 0,
          f"beam-{K} recognize did not run through beam_step alone")
    with plain_route():
        plain = {dt: m.recognize(batch, beam_size=K)
                 for dt, m in mods.items()}
    for dt, (ws, sc) in outs.items():
        check(len(ws) == len(batch) and bool(np.isfinite(sc).all())
              and bool((sc <= 0).all()), f"{dt} beam-{K}: bad results")
        agree = float(np.mean([a == b for a, b in zip(ws, plain[dt][0])]))
        log(f"e2e {tag}{dt} beam-{K} B={len(batch)}: {len(set(ws))} distinct "
            f"transcripts, mean length {np.mean([len(w) for w in ws]):.2f}; "
            f"agreement with the plain route on the card {agree:.4f}")
        if dt == "float32":
            check(ws == plain[dt][0], f"{tag}float32 beam-{K}: kernel and "
                                      "plain routes disagree")
            gap = float(np.abs(sc - plain[dt][1]).max())
            check(gap <= 1e-3, f"float32 beam-{K}: score gap {gap}")
    return counts


def live_steps(m, batch) -> float:
    """Mean beam steps a row of `batch` stays live in m's beam-5 search
    (the whole-loop kernel's histories, read through its module), which
    tells an early-exit regime from a full one."""
    from aocr_torch import vocab
    from aocr_torch.ops.cuda import beam_loop

    seen, kernel = [], beam_loop.fused_beam_loop

    def recorded(*a, **k):
        out = kernel(*a, **k)
        seen.append(out[0])
        return out

    beam_loop.fused_beam_loop = recorded
    try:
        m.recognize(batch, beam_size=BEAM)
    finally:
        beam_loop.fused_beam_loop = kernel
    hist = seen[0]
    live = ~((hist[:-1] == vocab.PAD) | (hist[:-1] == vocab.EOS)).all(-1)
    return live.sum().item() / hist.shape[1]


def beam_timings(dev, models, requests, lexicon, card: str):
    """beam_step against its plain version (CUDA events) and its bound at
    B=512, K=5 and K=10; beam-5, dictionary beam-5 and beam-10 images/s at
    B=512, W=100, T=50 (host clock, median of 5); a profile of beam-5 and
    of beam-10.  Returns
    ({(kernel, dtype): (ms, plain_ms)}, {(kernel, dtype): bound},
    {label: images/s})."""
    import numpy as np
    import torch

    from aocr_torch.ops.cuda import beam_step, greedy_loop

    words, table_np = lexicon
    g = torch.Generator().manual_seed(29)
    rand = lambda *s: torch.rand(*s, generator=g) * 2 - 1
    cfg = base_config()
    B, L, T, K = B_SERVE, W_SERVE // 4 - 1, T_MAX, BEAM
    V, Hd, E = (cfg.target_vocab_size, cfg.decoder_num_hidden,
                cfg.target_embedding_size)
    nl = cfg.decoder_num_layers
    ms, bounds, rates = {}, {}, {}
    for dt in (torch.float32, torch.bfloat16):
        name = "f32" if dt == torch.float32 else "bf16"
        m = models[("float32" if dt == torch.float32 else "bfloat16",
                    "loop")]
        tables = greedy_loop.build_tables(
            m.params["decoder"], m.params["projector"], E, True, dt)
        ctx = rand(L, B, Hd).to(dev, dt)
        for Ks in BEAM_STEP_K:
            h = rand(B, Ks * Hd).to(dev, dt)
            prev = torch.full((B, Ks), 5, dtype=torch.int32, device=dev)
            scores = (-torch.arange(Ks, dtype=torch.float32, device=dev)
                      ).expand(B, Ks).contiguous()
            sargs = (ctx, h, prev, scores, tables["wa"], tables["wc"],
                     tables["pw"], tables["pb"], Ks, V)
            k1, k2, p1, p2 = time_pair(
                lambda: beam_step.fused_beam_tail(*sargs),
                lambda: beam_step.fused_beam_tail_plain(*sargs), 20)
            key = ("beam_step", name) if Ks == BEAM else (
                "beam_step", name, Ks)
            ms[key] = (min(k1, k2), min(p1, p2))
            log(f"time beam_step {name} (B={B}, K={Ks}): kernel {k1:.4f} / "
                f"{k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms")
            out = beam_step.fused_beam_tail(*sargs)
            b = bounds[key] = bound(
                B * Ks * step_flops(Hd, L, V, nl, True, gates=False),
                tensor_bytes(sargs, out), name)
            log(f"bound beam_step {name} K={Ks}: {b[0]:.4f} ms ({b[1]}; "
                f"kernel {ms[key][0] / b[0]:.1f}x it)")

    # end to end, bf16, loop route, B=512
    m = models[("bfloat16", "loop")]
    batch = requests[0]
    for label, table in (("beam-5", None), ("dict-beam-5", table_np)):
        if table is not None:
            m.set_dictionary_table(table)
        steps = live_steps(m, batch)
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            ws, _ = m.recognize(batch, beam_size=K)
            times.append(time.perf_counter() - t0)
        med = float(np.median(times))
        rates[label] = len(batch) / med
        lens = [len(w) for w in ws]
        lex = ""
        if table is not None:
            lex = (f"; in the lexicon "
                   f"{np.mean([w in set(words) for w in ws]):.4f}")
        log(f"recognize {label} bf16 loop B={len(batch)} W={W_SERVE} "
            f"T={T_MAX}: {rates[label]:.1f} images/s (median of 5: "
            f"{med * 1e3:.2f} ms; {[round(t * 1e3, 2) for t in times]}; "
            f"mean transcript length {np.mean(lens):.2f}{lex}; a row stays "
            f"live {steps:.2f} of {T_MAX - 1} beam steps on average, "
            f"random weights) on {card}")
        if table is None:
            profile(f"recognize beam-5 bf16 loop B={len(batch)}",
                    lambda: m.recognize(batch, beam_size=K))
        m.clear_dictionary()
    # beam-10: beam_step's route (wider than beam_loop.MAX_K)
    K10 = BEAM_STEP_K[1]
    m.recognize(batch, beam_size=K10)
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        ws, _ = m.recognize(batch, beam_size=K10)
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    rates[f"beam-{K10}"] = len(batch) / med
    log(f"recognize beam-{K10} bf16 B={len(batch)} W={W_SERVE} T={T_MAX}: "
        f"{rates[f'beam-{K10}']:.1f} images/s (median of 5: "
        f"{med * 1e3:.2f} ms; {[round(t * 1e3, 2) for t in times]}; mean "
        f"transcript length {np.mean([len(w) for w in ws]):.2f}) on {card}")
    profile(f"recognize beam-{K10} bf16 B={len(batch)}",
            lambda: m.recognize(batch, beam_size=K10))
    mt = models[("bfloat16", "tail")]
    mt.recognize(batch, beam_size=K)
    t0 = time.perf_counter()
    mt.recognize(batch, beam_size=K)
    el = time.perf_counter() - t0
    log(f"recognize beam-5 bf16 tail B={len(batch)}: "
        f"{len(batch) / el:.1f} images/s ({el * 1e3:.2f} ms, one run)")
    return ms, bounds, rates


# ------------------------------------------------------------ phase 4

def cudnn_lstm(dev, dt, L: int, B: int, D: int, H: int, train: bool):
    """One cuDNN LSTM direction (nn.LSTM, input D, hidden H) on (L, B, D)
    inputs in dt: the library yardstick of lstm_fwd and lstm_bwd.  It also
    runs the input projection the port hoists out of its scan.  Returns
    (forward fn, backward fn or None)."""
    import torch

    lstm = torch.nn.LSTM(D, H).to(dev, dt)
    lstm.flatten_parameters()
    x = torch.rand(L, B, D, device=dev, dtype=dt).requires_grad_(train)
    if not train:
        def fwd():
            with torch.no_grad():
                return lstm(x)
        return fwd, None
    y, _ = lstm(x)
    dy = torch.rand_like(y)
    params = [x] + list(lstm.parameters())
    return (lambda: lstm(x),
            lambda: torch.autograd.grad(y, params, dy, retain_graph=True))


def library_ms(what: str, fn, n: int):
    """CUDA-event ms of a library call, None (logged) where it does not
    run on this card for this dtype."""
    try:
        t = cuda_ms(fn, n)
    except RuntimeError as e:
        log(f"library {what}: not measured ({str(e).splitlines()[0]})")
        return None
    log(f"library {what}: {t:.4f} ms")
    return t


# lstm_fwd's timed shapes: the serving batches (collect=False) and the
# train step's (collect=True)
LSTM_TIMED = [(1, False), (8, False), (32, False), (B_SERVE, False),
              (B_TRAIN, True)]


def lstm_fwd_timings(dev, results: dict):
    """lstm_fwd (the thread-block-cluster design), L=24, H=512, both
    dtypes, at LSTM_TIMED: the kernel against its plain version (checked,
    then timed) and cuDNN's nn.LSTM (one direction, projection included,
    a training forward at collect=True) in turns plain, cuDNN, kernel,
    kernel, cuDNN, plain, each turn logged and the better kept; the input
    projection + the kernel, what cuDNN's call also computes; the bound;
    the launch plan.  Returns (ms, bounds, library): the main paths' shapes
    under ("lstm_fwd", dt) (B=512) and ("lstm_fwd_collect", dt) (B=400),
    every shape under ("lstm_fwd", dt, B, collect)."""
    import torch

    from aocr_torch.ops import lstm
    from aocr_torch.ops.cuda import lstm_fwd

    g = torch.Generator().manual_seed(23)
    rand = lambda *s: torch.rand(*s, generator=g) * 2 - 1
    cfg = base_config()
    L, He, D = W_SERVE // 4 - 1, cfg.encoder_num_hidden, cfg.cnn_feature_size
    ms, bounds, lib = {}, {}, {}
    for dt in (torch.float32, torch.bfloat16):
        name = "f32" if dt == torch.float32 else "bf16"
        tol = 1e-4 if dt == torch.float32 else 5e-2
        wh = (rand(He, 4 * He) * He ** -0.5).to(dev, dt)
        layer = {"wi": (rand(D, 4 * He) * D ** -0.5).to(dev),
                 "bi": (rand(4 * He) * D ** -0.5).to(dev),
                 "bh": (rand(4 * He) * He ** -0.5).to(dev)}
        for B, collect in LSTM_TIMED:
            x = rand(L, B, D).to(dev, dt)
            xp = lstm.proj_input(layer, x, dt)
            z = torch.zeros(B, He, device=dev)
            kern = lambda: lstm_fwd.lstm_fwd_scan(wh, xp, z, z, False,
                                                  collect)
            plain = lambda: lstm_fwd.lstm_fwd_scan_plain(wh, xp, z, z, False,
                                                         collect)
            flat = lambda o: (o[0], *o[1], *(o[2] if collect else ()))
            got, want = flat(kern()), flat(plain())
            err = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(got, want))
            what = f"lstm_fwd {name} B={B} collect={collect}"
            check(err <= tol, f"{what}: max err {err}")
            results.setdefault(("lstm_fwd", name), []).append(err)
            fwd, _ = cudnn_lstm(dev, dt, L, B, D, He, collect)
            n = 20
            p1 = cuda_ms(plain, 3, 1)
            l1 = library_ms(f"{what}: cuDNN turn 1", fwd, n)
            k1, k2 = cuda_ms(kern, n), cuda_ms(kern, n)
            l2 = library_ms(f"{what}: cuDNN turn 2", fwd, n)
            p2 = cuda_ms(plain, 3, 1)
            both = cuda_ms(lambda: lstm_fwd.lstm_fwd_scan(
                wh, lstm.proj_input(layer, x, dt), z, z, False, collect), n)
            bnd = bound(2.0 * L * B * He * 4 * He,
                        tensor_bytes((wh, xp, z, z), got), name)
            libs = [t for t in (l1, l2) if t is not None]
            key = ("lstm_fwd", name, B, collect)
            ms[key] = (min(k1, k2), min(p1, p2))
            bounds[key] = bnd
            lib[key] = min(libs) if libs else None
            log(f"time {what} L={L} H={He}: kernel {k1:.4f} / {k2:.4f} ms, "
                f"plain {p1:.4f} / {p2:.4f} ms, cuDNN "
                + " / ".join(f"{t:.4f}" for t in libs) + " ms (turns "
                f"plain, cuDNN, kernel, kernel, cuDNN, plain); projection + "
                f"kernel {both:.4f} ms (cuDNN's call includes the "
                f"projection); bound {bnd[0]:.4f} ms ({bnd[1]}); "
                f"max_abs_err {err:.3g} (tol {tol:.3g})")
        for k, main in (("lstm_fwd", (B_SERVE, False)),
                        ("lstm_fwd_collect", (B_TRAIN, True))):
            key = ("lstm_fwd", name, *main)
            ms[(k, name)], bounds[(k, name)] = ms[key], bounds[key]
            lib[(k, name)] = lib[key]
    for _plan, line in lstm_fwd.plans.values():
        log(line)
    return ms, bounds, lib


def timings(dev, models, requests, card: str, table):
    """Each recognition kernel but lstm_fwd (lstm_fwd_timings) against
    its plain version, its bound and its library call; recognize images/s;
    a profile.  Returns (ms,
    bounds, library) keyed by (kernel, dtype)."""
    import numpy as np
    import torch

    from aocr_torch.ops.cuda import conv1_pool, decode_step, greedy_loop

    g = torch.Generator().manual_seed(11)
    rand = lambda *s: torch.rand(*s, generator=g) * 2 - 1
    B, E = B_SERVE, base_config().target_embedding_size
    ms, bounds, lib = {}, {}, {}
    for dt in (torch.float32, torch.bfloat16):
        name = "f32" if dt == torch.float32 else "bf16"
        x = rand(B, 32, W_SERVE, 1).to(dev, dt)
        w, b = (rand(64, 1, 3, 3) / 3).to(dev), (rand(64) / 3).to(dev)
        pairs = {"conv1_pool": (lambda: conv1_pool.conv1_relu_pool(x, w, b),
                                lambda: conv1_pool.conv1_relu_pool_plain(
                                    x, w, b), 20)}
        m = models[("float32" if dt == torch.float32 else "bfloat16", "loop")]
        tables = greedy_loop.build_tables(
            m.params["decoder"], m.params["projector"], E, True, dt)
        conv_flops = 2.0 * 9 * 64 * B * 32 * W_SERVE
        bounds[("conv1_pool", name)] = bound(
            conv_flops, tensor_bytes((x, w, b),
                                     conv1_pool.conv1_relu_pool(x, w, b)),
            name)
        for k, (fk, fp, n) in pairs.items():
            k1, k2, p1, p2 = time_pair(fk, fp, n)
            ms[(k, name)] = (min(k1, k2), min(p1, p2))
            log(f"time {k} {name}: kernel {k1:.4f} / {k2:.4f} ms, plain "
                f"{p1:.4f} / {p2:.4f} ms; bound "
                f"{bounds[(k, name)][0]:.4f} ms ({bounds[(k, name)][1]})")
        decode_step_timings(dev, name, dt, tables, table, g, ms, bounds)

    m = models[("bfloat16", "loop")]
    batch = requests[3]
    m.recognize(batch)
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        words, _ = m.recognize(batch)
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    mean_len = float(np.mean([len(w) for w in words]))
    log(f"recognize bf16 loop B={len(batch)} W={W_SERVE} T={T_MAX}: "
        f"{len(batch) / med:.1f} images/s (median of 5: {med * 1e3:.2f} ms; "
        f"mean transcript length {mean_len:.2f}) on {card}")
    profile(f"recognize bf16 loop B={len(batch)}", lambda: m.recognize(batch))
    # the tail route (decode_step once a step) on its cluster plan and on
    # the first port's rows kernel, in turns; float32's loop route
    for dt, route, kroute in (("bfloat16", "tail", "auto"),
                              ("bfloat16", "tail", "rows"),
                              ("bfloat16", "tail", "auto"),
                              ("bfloat16", "tail", "rows"),
                              ("float32", "tail", "auto"),
                              ("float32", "tail", "rows"),
                              ("float32", "loop", "auto")):
        mm = models[(dt, route)]
        decode_step.ROUTE = kroute
        try:
            mm.recognize(batch)
            torch.cuda.synchronize()
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                mm.recognize(batch)
                times.append(time.perf_counter() - t0)
        finally:
            decode_step.ROUTE = "auto"
        med = float(np.median(times))
        what = f" (decode_step's {kroute} route)" if route == "tail" else ""
        log(f"recognize {dt} {route}{what} B={len(batch)}: "
            f"{len(batch) / med:.1f} images/s (median of 5: "
            f"{med * 1e3:.2f} ms; all 5: "
            f"{', '.join(f'{t * 1e3:.2f}' for t in times)}) on {card}")
        ms[("recognize", dt, route, kroute)] = med * 1e3
    decode_step.ROUTE = "rows"
    try:
        profile(f"recognize bf16 tail (rows route) B={len(batch)}",
                lambda: models[("bfloat16", "tail")].recognize(batch))
    finally:
        decode_step.ROUTE = "auto"
    profile(f"recognize bf16 tail B={len(batch)}",
            lambda: models[("bfloat16", "tail")].recognize(batch))
    return ms, bounds, lib


def decode_step_timings(dev, name, dt, tables, table, g, ms: dict,
                        bounds: dict) -> None:
    """decode_step at the recognition shape (L=24, the default decoder,
    every row live) at DECODE_TIMED: its cluster route with the weights
    packed once (a decode's call), the first port's rows route
    (decode_step.ROUTE = "rows") and the plain version, by CUDA events in
    turns (plain, cluster, rows, rows, cluster, plain), the bound and the
    plan; at B=512 also the call that packs the weights itself and the
    88k trie plane.  ms[("decode_step", name)] is B=512's (kernel, plain),
    ms[("decode_step", name, B)] each batch's, ms[("decode_step_rows",
    name, B)] the rows route's."""
    import torch

    from aocr_torch.ops.cuda import decode_step, greedy_loop

    rand = lambda *s: torch.rand(*s, generator=g) * 2 - 1
    cfg = base_config()
    L, Hd, nl = W_SERVE // 4 - 1, cfg.decoder_num_hidden, \
        cfg.decoder_num_layers
    V = cfg.target_vocab_size
    w = (tables["wa"], tables["wc"], tables["pw"], tables["pb"])

    def rows(fn):
        def call():
            decode_step.ROUTE = "rows"
            try:
                return fn()
            finally:
                decode_step.ROUTE = "auto"
        return call

    for B in DECODE_TIMED:
        ctx = rand(L, B, Hd).to(dev, dt)
        h = rand(B, Hd).to(dev, dt)
        prev = torch.full((B,), 5, dtype=torch.int32, device=dev)
        packed = decode_step.pack_weights(w[0], w[1], ctx, w[2], V)
        kern = lambda: decode_step.fused_decode_tail(h, ctx, prev, *w,
                                                     packed=packed)
        plain = lambda: decode_step.fused_decode_tail_plain(h, ctx, prev, *w)
        n = 20
        p1 = cuda_ms(plain, n // 2, 1)
        k1 = cuda_ms(kern, n)
        r1 = cuda_ms(rows(kern), n)
        r2 = cuda_ms(rows(kern), n)
        k2 = cuda_ms(kern, n)
        p2 = cuda_ms(plain, n // 2, 1)
        bounds[("decode_step", name, B)] = bound(
            B * step_flops(Hd, L, V, nl, True, gates=False),
            tensor_bytes((h, ctx, prev, w), kern()), name)
        ms[("decode_step", name, B)] = (min(k1, k2), min(p1, p2))
        ms[("decode_step_rows", name, B)] = min(r1, r2)
        bnd = bounds[("decode_step", name, B)]
        log(f"time decode_step {name} B={B}: kernel {k1:.4f} / {k2:.4f} ms "
            f"(cluster route, weights packed once), rows route {r1:.4f} / "
            f"{r2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms; bound "
            f"{bnd[0]:.4f} ms ({bnd[1]}); "
            f"{decode_step.plans[(Hd, B, 1, dt, L, w[2].shape[1])][1]}")
    ms[("decode_step", name)] = ms[("decode_step", name, B_SERVE)]
    bounds[("decode_step", name)] = bounds[("decode_step", name, B_SERVE)]
    args = (h, ctx, prev, *w)
    kc = cuda_ms(lambda: decode_step.fused_decode_tail(*args), 20)
    # the trie plane at inner nodes of the 88k lexicon
    inner = (table >= 0).any(1).nonzero().flatten()
    nodes = inner[torch.randint(0, len(inner), (B_SERVE,), generator=g)
                  .to(dev)].to(torch.int32)
    plane = greedy_loop.trie_valid(table, nodes, w[2].shape[1], pad_ok=True)
    kp = cuda_ms(lambda: decode_step.fused_decode_tail(
        *args, valid=plane, packed=packed), 20)
    log(f"time decode_step {name} B={B_SERVE}: {kc:.4f} ms a call that packs "
        f"the weights itself; with the 88k trie plane {kp:.4f} ms")
    ms[("decode_step_call", name)] = kc
    ms[("decode_step_trie", name)] = kp

# greedy_loop's timed batches: the serving latencies and the serving batch
GREEDY_TIMED = (1, 8, 32, B_SERVE)


def greedy_loop_timings(dev, models, results: dict, table):
    """greedy_loop (the thread-block-cluster design) at the recognition
    shape (L=24, the default decoder, T=50, random weights so that every
    row runs all 50 steps) at GREEDY_TIMED, both dtypes: check_loop
    without and with the 88k trie, then the kernel against its plain
    version in turns, the bound and the launch plan; at B=512 also the
    88k-trie decode and the one whose rows all emit EOS at step 1.
    Returns (ms, bounds) keyed by ("greedy_loop", dtype) (B=512) and
    ("greedy_loop", dtype, B)."""
    import torch

    from aocr_torch import vocab
    from aocr_torch.ops.cuda import greedy_loop

    g = torch.Generator().manual_seed(13)
    rand = lambda *s: torch.rand(*s, generator=g) * 2 - 1
    cfg = base_config()
    L, T, Hd, E = (W_SERVE // 4 - 1, T_MAX, cfg.decoder_num_hidden,
                   cfg.target_embedding_size)
    nl, V = cfg.decoder_num_layers, cfg.target_vocab_size
    ms, bounds = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        name = "f32" if dt == torch.float32 else "bf16"
        tol = 1e-4 if dt == torch.float32 else 3e-2
        m = models[("float32" if dt == torch.float32 else "bfloat16", "loop")]
        tables = greedy_loop.build_tables(
            m.params["decoder"], m.params["projector"], E, True, dt)
        for B in GREEDY_TIMED:
            ctx = rand(L, B, Hd).to(dev, dt)
            c0, h0 = rand(B, Hd).to(dev), rand(B, Hd).to(dev)
            args = (ctx, c0, h0, nl, True, T)
            err = check_loop(name, tables, args, tol, f" (timed B={B})")
            results.setdefault(("greedy_loop", name), []).append(err)
            err = check_loop(name, tables, args, tol,
                             f" (timed B={B}), 88k trie", trie_table=table)
            results[("greedy_loop", name)].append(err)
            loop_args = (ctx, c0, h0, tables, nl, True, T)
            lab, lab_sc = greedy_loop.fused_greedy_loop(*loop_args)
            steps = int((lab != vocab.PAD).sum(1).max().item())
            ended = (lab == vocab.EOS).cumsum(1) > 0
            row_steps = int((~torch.cat([torch.zeros_like(ended[:, :1]),
                                         ended[:, :-1]], 1)).sum().item())
            bnd = bound(row_steps * step_flops(Hd, L, V, nl, True),
                        tensor_bytes(loop_args[:4], lab, lab_sc), name)
            n = 3 if B == B_SERVE else 6
            k1, k2, p1, p2 = time_pair(
                lambda: greedy_loop.fused_greedy_loop(*loop_args),
                lambda: greedy_loop.fused_greedy_loop_plain(*loop_args), n)
            ms[("greedy_loop", name, B)] = (min(k1, k2), min(p1, p2))
            bounds[("greedy_loop", name, B)] = bnd
            log(f"time greedy_loop {name} B={B} L={L} H={Hd} T={T}: kernel "
                f"{k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms "
                f"({steps} of {T} steps run); bound {bnd[0]:.4f} ms "
                f"({bnd[1]})")
        B = B_SERVE
        ms[("greedy_loop", name)] = ms[("greedy_loop", name, B)]
        bounds[("greedy_loop", name)] = bounds[("greedy_loop", name, B)]
        kt = cuda_ms(lambda: greedy_loop.fused_greedy_loop(
            *loop_args, trie_table=table), 5)
        lab_t, _ = greedy_loop.fused_greedy_loop(*loop_args,
                                                 trie_table=table)
        ms[("greedy_loop_trie", name)] = kt
        log(f"time greedy_loop {name} B={B} with the 88k trie: kernel "
            f"{kt:.4f} ms ({int((lab_t != 0).sum(1).max().item())} of {T} "
            f"steps run)")
        eos = eos_tables(tables, (ctx, c0, h0, nl, True, T), 1.0)
        ke = cuda_ms(lambda: greedy_loop.fused_greedy_loop(
            ctx, c0, h0, eos, nl, True, T), 10)
        ms[("greedy_loop_eos", name)] = ke
        log(f"time greedy_loop {name} B={B}, every row EOS at step 1 (each "
            f"tile's early exit): kernel {ke:.4f} ms")
    for _plan, line in greedy_loop.plans.values():
        log(line)
    return ms, bounds


BEAM_TIMED = (1, 8, 32, B_SERVE)


def beam_loop_timings(dev, models, results: dict, table):
    """beam_loop (the thread-block-cluster design) at the beam path's
    shape (K=5, L=24, the default decoder, T=50, random weights, so rows
    stay live nearly all 49 steps) at BEAM_TIMED, both dtypes:
    check_beam_loop, then the kernel against its plain version in turns,
    the bound and the launch plan; at B=512 also the 88k-trie search and
    the one whose beams all pick EOS at the first step.  Returns (ms,
    bounds) keyed by ("beam_loop", dtype) (B=512) and ("beam_loop",
    dtype, B)."""
    import torch

    from aocr_torch import vocab
    from aocr_torch.models.decoder import DecoderState
    from aocr_torch.ops.cuda import beam_loop, greedy_loop

    g = torch.Generator().manual_seed(31)
    rand = lambda *s: torch.rand(*s, generator=g) * 2 - 1
    cfg = base_config()
    L, T, Hd, E = (W_SERVE // 4 - 1, T_MAX, cfg.decoder_num_hidden,
                   cfg.target_embedding_size)
    nl, V, K = cfg.decoder_num_layers, cfg.target_vocab_size, BEAM
    ms, bounds = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        name = "f32" if dt == torch.float32 else "bf16"
        tol = 1e-4 if dt == torch.float32 else 3e-2
        m = models[("float32" if dt == torch.float32 else "bfloat16", "loop")]
        tables = greedy_loop.build_tables(
            m.params["decoder"], m.params["projector"], E, True, dt)
        for B in BEAM_TIMED:
            ctx = rand(L, B, Hd).to(dev, dt)
            st = DecoderState(attn=rand(B, Hd).to(dev),
                              cs=tuple(rand(B, Hd).to(dev) for _ in range(nl)),
                              hs=tuple(rand(B, Hd).to(dev) for _ in range(nl)))
            err = check_beam_loop(name, f" (timed B={B})", ctx, st, tables,
                                  None, False, tol, g)
            results.setdefault(("beam_loop", name), []).append(err)
            args = beam_loop_args(ctx, st, tables, None, False, g)
            out = beam_loop.fused_beam_loop(*args)
            hist = out[0]
            live = ~((hist[:-1] == vocab.PAD) |
                     (hist[:-1] == vocab.EOS)).all(-1)
            row_steps = int(live.sum().item())
            bnd = bound(row_steps * K * step_flops(Hd, L, V, nl, True),
                        tensor_bytes(args, out), name)
            k1, k2, p1, p2 = time_pair(
                lambda: beam_loop.fused_beam_loop(*args),
                lambda: beam_loop.fused_beam_loop_plain(*args),
                3 if B == B_SERVE else 6)
            ms[("beam_loop", name, B)] = (min(k1, k2), min(p1, p2))
            bounds[("beam_loop", name, B)] = bnd
            log(f"time beam_loop {name} B={B} K={K} L={L} H={Hd} T={T}: "
                f"kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / "
                f"{p2:.4f} ms (a row live {row_steps / B:.2f} of {T - 1} "
                f"steps); bound {bnd[0]:.4f} ms ({bnd[1]}; kernel "
                f"{min(k1, k2) / bnd[0]:.1f}x it)")
        ms[("beam_loop", name)] = ms[("beam_loop", name, B)]
        bounds[("beam_loop", name)] = bounds[("beam_loop", name, B)]
        targs = beam_loop_args(ctx, st, tables, table, False, g)
        kt = cuda_ms(lambda: beam_loop.fused_beam_loop(
            *targs, trie_table=table), 3)
        hist = beam_loop.fused_beam_loop(*targs, trie_table=table)[0]
        steps = int((hist != vocab.PAD).any(-1).any(-1).sum().item())
        ms[("beam_loop_trie", name)] = kt
        log(f"time beam_loop {name} B={B} with the 88k trie: kernel "
            f"{kt:.4f} ms ({steps} of {T} steps emit)")
        eos = list(args)
        eos[5] = dict(tables, pb=tables["pb"].clone())
        eos[5]["pb"][vocab.EOS] += 1e4
        ke = cuda_ms(lambda: beam_loop.fused_beam_loop(*eos), 10)
        first = beam_loop.fused_beam_loop(*eos)[0][1]
        check(bool((first == vocab.EOS).all()),
              f"beam_loop {name}: the all-EOS case did not end at step 1")
        ms[("beam_loop_eos", name)] = ke
        log(f"time beam_loop {name} B={B}, every beam EOS at its first "
            f"step (each tile's early exit): kernel {ke:.4f} ms")
    for _plan, line in beam_loop.plans.values():
        log(line)
    return ms, bounds


# tests/test_transcript_parity.py's first fixture: its words and the
# decoys of its lexicon
FIXTURE_WORDS = ["ab", "cd", "e1", "fg"]
FIXTURE_DECOYS = ["abc", "cde", "ef", "fgh", "hi", "klm", "mno", "pqr",
                  "stu", "vwx", "yz", "a1", "b2", "c3", "qq", "zz", "xray",
                  "yolk"]


def trained_fixture(dev, seed: int = 0, steps: int = 300,
                    input_feed: bool = True):
    """tests/test_transcript_parity.py's tiny fixture (H=128, 32x32
    crops of FIXTURE_WORDS rendered by aocr_torch.demo.render_word, SGD
    at 0.1), with or without input feed, trained with the port's
    make_train_step on `dev` (float32, plain route) until its greedy and
    beam-5 decodes read back every word; returns (cfg, params,
    batch_stats, images, targets_eval, steps run), or None if `steps` do
    not get there."""
    import numpy as np
    import torch

    from aocr_torch import decode, eval as eval_lib, train_step, vocab
    from aocr_torch.config import Config
    from aocr_torch.demo import render_word
    from aocr_torch.models import model

    cfg = Config(batch_size=4, input_feed=input_feed, encoder_num_hidden=64,
                 target_embedding_size=8, max_decoder_l=8, image_width=32,
                 learning_rate=0.1, use_pallas=False, seed=seed).validate()
    imgs = np.stack([render_word(w, 32, 32) for w in FIXTURE_WORDS])[..., None]
    targets, targets_eval, _ = vocab.encode_batch(FIXTURE_WORDS)
    params, stats = model.init(cfg, torch.Generator().manual_seed(seed), dev)
    opt = train_step.init_opt_state(params, cfg)
    step = train_step.make_train_step(cfg)
    im = torch.from_numpy(imgs.astype(np.float32)).to(dev)
    tg = torch.as_tensor(targets, device=dev)
    te = torch.as_tensor(targets_eval, device=dev)
    for i in range(steps):
        out = step(params, stats, opt, im, tg, te, 0.1)
        params, stats, opt = out.params, out.batch_stats, out.opt_state
        if (i + 1) % 25 == 0 and all(
                bool(eval_lib.exact_match(decode.beam_decode(
                    params, stats, im, cfg, K, cfg.max_decoder_l)[0],
                    te).all()) for K in (1, 5)):
            return cfg, params, stats, im, te, i + 1
    return None


def fixture_transcripts(dev, seed: int = 0, input_feed: bool = True):
    """bf16 transcripts of the trained fixture (with or without input
    feed) on the card: greedy on the loop and tail routes (greedy_loop,
    decode_step) and beam-5 on both (beam_loop, beam_step), without and
    with a trie of its words and decoys, each against the plain route
    (use_pallas=False) and the words.  Returns [(what, ok)]."""
    import numpy as np
    import torch

    from aocr_torch import decode, vocab
    from aocr_torch.ops import cuda
    from aocr_torch.utils import trie

    fx = trained_fixture(dev, seed, input_feed=input_feed)
    tag = f"seed={seed}" + ("" if input_feed else ", no input feed")
    if fx is None:
        return [(f"trained fixture {tag}: no exact match in 300 steps",
                 False)]
    cfg, params, stats, im, te, steps = fx
    log(f"trained fixture {tag}: exact match after {steps} steps")
    table = torch.from_numpy(trie.build_transition_table(
        FIXTURE_WORDS + FIXTURE_DECOYS)).to(dev)
    kernels = {(1, "loop"): "greedy_loop", (1, "tail"): "decode_step",
               (5, "loop"): "beam_loop", (5, "tail"): "beam_step"}
    out = []
    for tt in (None, table):
        for K in (1, 5):
            def run(**kw):
                c = cfg.replace(compute_dtype="bfloat16", **kw)
                if K == 1:
                    return decode.greedy_decode(params, stats, im, c,
                                                c.max_decoder_l,
                                                trie_table=tt)
                return decode.beam_decode(params, stats, im, c, K,
                                          c.max_decoder_l, trie_table=tt)

            want, want_sc = run(use_pallas=False)
            words = [vocab.decode(r) for r in want.cpu().numpy()]
            what = (f"trained fixture bf16 {'greedy' if K == 1 else 'beam-5'}"
                    f"{', trie' if tt is not None else ''}"
                    f"{'' if input_feed else ', no input feed'}")
            out.append((f"{what}: plain route reads {words}",
                        words == FIXTURE_WORDS))
            for route in ("loop", "tail"):
                k = kernels[(K, route)]
                n = cuda.launch_counts()[k]
                lab, sc = run(use_pallas=True, pallas_greedy=route,
                              pallas_beam=route)
                torch.cuda.synchronize()
                same = torch.equal(lab.cpu(), want.cpu())
                gap = float((sc - want_sc).abs().max().item())
                out.append((f"{what}, {route} route ({k}, "
                            f"{cuda.launch_counts()[k] - n} launches): "
                            f"transcripts identical to the plain route's "
                            f"{same}, score gap {gap:.3g}",
                            same and cuda.launch_counts()[k] > n
                            and gap <= 2e-2 and bool(np.isfinite(gap))))
    return out


def profile(label: str, fn) -> None:
    """Where one call of fn spends its time: device time by kernel
    (torch.profiler / CUPTI) against the host wall clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(k[1] for k in kernels)
    if not kernels:
        log(f"profile {label}: device time not measured (no CUDA events)")
        return
    log(f"profile {label}: device busy {busy:.2f} ms of {wall_ms:.2f} ms "
        f"wall ({busy / wall_ms:.1%}, profiled)")
    for name, ms, n in sorted(kernels, key=lambda k: -k[1])[:12]:
        log(f"  {ms:9.3f} ms  x{n:<4d} {name[:90]}")


# ------------------------------------------------------------ training

def train_config(dtype: str, small: bool = False, base=None):
    """base's model (by default the library's) at full width in training
    (SGD at the default rate); small: a narrow encoder and decoder for
    the CPU reference."""
    cfg = (base or base_config()).replace(compute_dtype=dtype,
                                          batch_size=B_TRAIN)
    if small:
        cfg = cfg.replace(encoder_num_hidden=32, target_embedding_size=8)
    return cfg


def train_batch(rs, n: int):
    """n word images (W=100) and random 10-letter transcripts: (images
    (n, 32, 100, 1), words, targets (n, 11), targets_eval (n, 11))."""
    import numpy as np

    from aocr_torch import vocab

    letters = "abcdefghijklmnopqrstuvwxyz0123456789"
    words = ["".join(rs.choice(list(letters), WORD_LEN)) for _ in range(n)]
    targets, targets_eval, _ = vocab.encode_batch(words)
    return (word_images(rs, n, W_SERVE)[..., None], words, targets,
            targets_eval)


def rel_err(got, want) -> float:
    """max|got - want| / max|want|"""
    import torch

    got, want = torch.as_tensor(got).float().cpu(), \
        torch.as_tensor(want).float().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def errs(got, want):
    """(max abs error, max of rel_err) over matching tensors."""
    return (max(float((a.float() - b.float()).abs().max())
                for a, b in zip(got, want)),
            max(rel_err(a, b) for a, b in zip(got, want)))


def bf16_steps(got, want) -> float:
    """max |got - want| in bfloat16 steps (ulps) of the larger magnitude
    of the two; equal values, zeros included, count 0."""
    import torch

    got, want = got.float(), want.float()
    m = torch.maximum(got.abs(), want.abs())
    ulp = torch.exp2(torch.floor(torch.log2(m.clamp(min=1e-30))) - 7)
    return float(((got - want).abs() / ulp).max())


def pool_input(g, shape, dev, dt):
    """relu(z), NCHW in channels_last memory as convs 2-7 leave it, for z
    of a few levels: equal maxima inside windows, zeros, and the first two
    rows of every image below zero (whole windows of zeros)."""
    import torch

    z = (torch.rand(*shape, generator=g) * 4 - 2).round() / 2
    z[:, :, :2] = -1.0
    return torch.relu(z).to(dev, dt).contiguous(
        memory_format=torch.channels_last)


def dx_check(name, dt, x, w, b, dy, what, results) -> None:
    """conv1_pool_dx's 16 taps a cell against its plain version: bit for
    bit (max_abs_err 0; the kernel sums in the plain version's order),
    and within the first port's tolerances (float32 1e-5 of the scale,
    bf16 one step)."""
    import torch

    from aocr_torch.ops.cuda import conv1_pool_dx

    got = conv1_pool_dx.conv1_relu_pool_dx16(x, w, b, dy)
    want = conv1_pool_dx.conv1_relu_pool_dx16_plain(x, w, b, dy)
    err = float((got.float() - want.float()).abs().max())
    results.setdefault(("conv1_pool_dx", name), []).append(err)
    check(torch.equal(got, want), f"conv1_pool_dx {name}{what}: not "
                                  f"bit-identical (max err {err})")
    if dt == torch.float32:
        rel = rel_err(got, want)
        check(rel <= 1e-5, f"conv1_pool_dx {name}{what}: max err {rel} of "
                           "the scale")
        tail = f"{rel:.3g} of the plain version's max abs (tol 1e-5)"
    else:
        steps = bf16_steps(got, want)
        check(steps <= 1.0, f"conv1_pool_dx {name}{what}: {steps} bf16 "
                            "steps off")
        tail = f"at most {steps:.3g} bf16 steps off (tol 1)"
    plan = conv1_pool_dx.checked_plan(*x.shape[:3], x.dtype)
    log(f"check conv1_pool_dx {name}{what}: max_abs_err {err:.3g} (tol 0: "
        f"bit for bit), {tail}; {plan}")


def train_kernel_checks(dev, results: dict) -> None:
    """The five training kernel rows against their plain versions at the
    train step's shapes (B=400, L=24, T=11, H_enc=512, H_dec=1024).  Each
    check holds max|kernel - plain| <= tol * max|plain|; the kernels'
    residual inputs come from the plain forward."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from aocr_torch.ops.cuda import (conv1_pool_bwd, lstm_bwd, lstm_fwd,
                                     pool_bwd)

    g = torch.Generator().manual_seed(17)
    rand = lambda *s, lo=-1.0, hi=1.0: (torch.rand(*s, generator=g)
                                        * (hi - lo) + lo)
    cfg = base_config()
    B, L = B_TRAIN, W_SERVE // 4 - 1
    He = cfg.encoder_num_hidden
    rs = np.random.RandomState(18)
    words = (word_images(rs, B, W_SERVE)[..., None] - 128.0) / 128.0

    record = lambda *a: record_rel(results, *a)

    for dt in (torch.float32, torch.bfloat16):
        name = "f32" if dt == torch.float32 else "bf16"
        f32 = dt == torch.float32
        # conv1 backward: word crops (white background: many tied pool
        # windows) and uniform noise; dy as an NCHW conv2 backward leaves
        # it.  The routing is bit-identical, so only summation order
        # differs: 1e-4 of the scale.
        w = rand(64, 1, 3, 3, lo=-1 / 3, hi=1 / 3).to(dev)
        b = rand(64, lo=-1 / 3, hi=1 / 3).to(dev)
        for kind, x in (("word crops", torch.from_numpy(words)),
                        ("noise", rand(B, 32, W_SERVE, 1))):
            x = x.to(dev, dt)
            dy = rand(B, 64, 16, W_SERVE // 2).to(dev, dt).permute(0, 2, 3, 1)
            got = conv1_pool_bwd.conv1_relu_pool_bwd(x, w, b, dy)
            again = conv1_pool_bwd.conv1_relu_pool_bwd(x, w, b, dy)
            check(all(torch.equal(a, c) for a, c in zip(got, again)),
                  f"conv1_pool_bwd {name} ({kind}): two calls differ")
            want = conv1_pool_bwd.conv1_relu_pool_bwd_plain(x, w, b, dy)
            record("conv1_pool_bwd", name, got, want, 1e-4,
                   f" B={B} ({kind}; two calls bit-identical)")
            dx_check(name, dt, x, w, b, dy, f" B={B} ({kind})", results)
        # the image cotangent also on a ragged batch (B=37: runs that end
        # inside a warp's pair of cells) and at W=36 with ties
        for B_, W_, kind in ((37, W_SERVE, "noise"), (B, 36, "ties")):
            x = rand(B_, 32, W_, 1)
            if kind == "ties":
                x = (x * 2).round() / 2
            dy = rand(B_, 64, 16, W_ // 2).to(dev, dt).permute(0, 2, 3, 1)
            dx_check(name, dt, x.to(dev, dt), w, b, dy,
                     f" B={B_} W={W_} ({kind})", results)
        # the fused ReLU + max-pool backward at the three pools' shapes:
        # bit-identical to its plain version and to autograd
        for shape, window in POOLS:
            y = pool_input(g, shape, dev, dt)
            dy = rand(shape[0], shape[1], shape[2] // window[0],
                      shape[3] // window[1]).to(dev, dt)
            got = pool_bwd.relu_pool_bwd(y, dy, window)
            want = pool_bwd.relu_pool_bwd_plain(y, dy, window)
            yy = y.detach().requires_grad_()
            (ref,) = torch.autograd.grad(F.max_pool2d(torch.relu(yy), window),
                                         yy, dy)
            err = float((got.float() - want.float()).abs().max())
            err_ag = float((got.float() - ref.float()).abs().max())
            check(err == 0 and err_ag == 0,
                  f"pool_bwd {name} {shape}: differs from its plain version "
                  f"({err}) or from autograd ({err_ag})")
            results.setdefault(("pool_bwd", name), []).append(
                max(err, err_ag))
            zeros = float((y == 0).float().mean())
            log(f"check pool_bwd {name} {tuple(shape)} window {window}: "
                f"max_abs_err {err} vs plain, {err_ag} vs autograd of "
                f"max_pool2d(relu) (tol 0); y == 0 for {zeros:.3f}")
        # encoder: one direction, H=512, L=24, both directions
        tol = 1e-4 if f32 else 3e-2
        wh = rand(He, 4 * He, lo=-He ** -0.5, hi=He ** -0.5).to(dev, dt)
        xp = rand(L, B, 4 * He).to(dev, dt)
        z = torch.zeros(B, He, device=dev)
        for reverse in (False, True):
            got = lstm_fwd.lstm_fwd_scan(wh, xp, z, z, reverse, collect=True)
            want = lstm_fwd.lstm_fwd_scan_plain(wh, xp, z, z, reverse,
                                                collect=True)
            flat = lambda o: (o[0], *o[1], *o[2])
            record("lstm_fwd", name, flat(got), flat(want), tol,
                   f" collect=True B={B} L={L} H={He} reverse={reverse}")
            hs, _, (ifog, cs) = want
            dhs = (rand(L, B, He) * 0.1).to(dev)
            dcf, dhf = (rand(B, He) * 0.1).to(dev), (rand(B, He) * 0.1).to(dev)
            args = (wh, dhs, ifog, cs, z, dcf, dhf, reverse)
            record("lstm_bwd", name, lstm_bwd.lstm_bwd_scan(*args),
                   lstm_bwd.lstm_bwd_scan_plain(*args), tol,
                   f" B={B} L={L} H={He} reverse={reverse}")
            # a ragged batch: three clusters' tiles, the last part full
            Br = TF_RAGGED
            cut = lambda t: t[..., :Br, :].contiguous()
            args = (wh, cut(dhs), cut(ifog), cut(cs), z[:Br], dcf[:Br],
                    dhf[:Br], reverse)
            record("lstm_bwd", name, lstm_bwd.lstm_bwd_scan(*args),
                   lstm_bwd.lstm_bwd_scan_plain(*args), tol,
                   f" B={Br} L={L} H={He} reverse={reverse}")
    tf_kernel_checks(dev, results, cfg, g)
    torch.cuda.synchronize()


def record_rel(results: dict, name, dt, got, want, tol, what) -> None:
    """Check max|got - want| <= tol * max|want| over matching tensors and
    keep the error in results[(name, dt)]."""
    err, rel = errs(got, want)
    check(rel <= tol, f"{name} {dt}{what}: max err {rel} of the scale")
    results.setdefault((name, dt), []).append(err)
    log(f"check {name} {dt}{what}: max_abs_err {err:.3g}, {rel:.3g} of "
        f"the plain version's max abs (tol {tol:.3g})")


def tf_kernel_checks(dev, results: dict, cfg, g) -> None:
    """tf_fwd and tf_bwd against their plain versions at the train step's
    shapes (B=400, L=24, T=11) and at the ragged B=37, float32 and bf16,
    on cfg's decoder (layer 0's weights two segments with input feed, one
    without) at the init law; the backward's residuals from the plain
    forward.  Each holds max|kernel - plain| <= tol * max|plain|."""
    import torch

    from aocr_torch.ops.cuda import tf_bwd, tf_fwd

    rand = lambda *s, lo=-1.0, hi=1.0: (torch.rand(*s, generator=g)
                                        * (hi - lo) + lo)
    B, L, T = B_TRAIN, W_SERVE // 4 - 1, WORD_LEN + 1
    Hd, nl, feed = cfg.decoder_num_hidden, cfg.decoder_num_layers, \
        cfg.input_feed
    k0 = 2 * Hd if feed else Hd
    what = "" if feed else " no input feed"
    record = lambda *a: record_rel(results, *a)
    for dt in (torch.float32, torch.bfloat16):
        name = "f32" if dt == torch.float32 else "bf16"
        tol = 1e-4 if dt == torch.float32 else 3e-2
        u = lambda bound, *s: rand(*s, lo=-bound, hi=bound)
        wfh0 = u(Hd ** -0.5, k0, 4 * Hd).to(dev, dt)
        rest = [(u(Hd ** -0.5, 2 * Hd, 4 * Hd).to(dev, dt),
                 u(Hd ** -0.5, 4 * Hd).to(dev), u(Hd ** -0.5, 4 * Hd).to(dev))
                for _ in range(nl - 1)]
        wa = u(Hd ** -0.5, Hd, Hd).to(dev, dt)
        wc = u((2 * Hd) ** -0.5, 2 * Hd, Hd).to(dev, dt)
        ctx = rand(L, B, Hd).to(dev, dt)
        xpd = rand(T, B, 4 * Hd).to(dev, dt)
        c0, h0 = rand(B, Hd).to(dev), rand(B, Hd).to(dev)
        # the whole batch, then a ragged one: three tiles, the last part
        # full
        for Bc in (B, TF_RAGGED):
            cut = lambda x: x[..., :Bc, :].contiguous()
            fargs = (cut(ctx), wfh0, rest, wa, wc, cut(xpd), cut(c0),
                     cut(h0), feed, True)
            want = tf_fwd.decoder_fwd_scan_plain(*fargs)
            record("tf_fwd", name, tf_fwd.decoder_fwd_scan(*fargs), want,
                   tol, f" B={Bc} T={T} L={L} H={Hd}{what}")
            htl, _, ifog, cs, alpha, _ = want
            bargs = (fargs[0], wfh0, [r[0] for r in rest], wc, wa,
                     (rand(T, Bc, Hd) * 0.1).to(dev), htl, alpha, ifog, cs,
                     fargs[6], feed)
            record("tf_bwd", name, tf_bwd.decoder_bwd_scan(*bargs),
                   tf_bwd.decoder_bwd_scan_plain(*bargs), tol,
                   f" B={Bc} T={T} L={L} H={Hd}{what}")
    torch.cuda.synchronize()


def run_steps(cfg, np_params, np_stats, batch, dev, n: int, make=None):
    """n train steps on a fixed batch from the numpy weights, step i under
    the step key (cfg.seed, i) (read only with cfg.augment); returns the
    TrainOutput of each.  make: the step's maker (default
    train_step.make_train_step)."""
    from aocr_torch import augment, train_step, weights

    params, stats = weights.from_numpy(np_params, np_stats, dev)
    opt = train_step.init_opt_state(params, cfg)
    step = (make or train_step.make_train_step)(cfg)
    images, _words, targets, targets_eval = batch
    outs = []
    for i in range(n):
        out = step(params, stats, opt, images, targets, targets_eval,
                   cfg.learning_rate, augment.step_key(cfg.seed, i))
        params, stats, opt = out.params, out.batch_stats, out.opt_state
        outs.append(out)
    return outs


def step_agreement(got, want):
    """(loss_sum relative error, max grad-norm relative error, max
    |param difference|) of two steps' outputs."""
    from aocr_torch.optim import leaves

    loss = rel_err(got.loss_sum, want.loss_sum)
    norms = max(rel_err(got.grad_norms[k], want.grad_norms[k])
                for k in want.grad_norms)
    params = max(float((a.cpu() - b.cpu()).abs().max())
                 for a, b in zip(leaves(got.params), leaves(want.params)))
    return loss, norms, params


def train_end_to_end(dev, seed: int):
    """Drive make_train_step; returns (launch counts, the bf16 config,
    the numpy weights, the batch)."""
    import numpy as np
    import torch

    from aocr_torch import weights
    from aocr_torch.api import AttentionOCR
    from aocr_torch.ops import cuda
    from aocr_torch.ops.cuda import lstm_fwd
    from aocr_torch.optim import leaves

    np_params, np_stats = numpy_model(base_config(), seed)
    batch = train_batch(np.random.RandomState(seed + 2), B_TRAIN)
    cfgs = {dt: train_config(dt) for dt in ("bfloat16", "float32")}
    cuda.reset_launch_counts()
    runs = {dt: run_steps(cfg, np_params, np_stats, batch, dev, TRAIN_STEPS)
            for dt, cfg in cfgs.items()}
    torch.cuda.synchronize()
    counts = cuda.launch_counts()
    counts["lstm_fwd_collect"] = lstm_fwd.launches_collect
    log(f"train path launch counts: {counts}")
    for k in ("conv1_pool", "conv1_pool_bwd", "lstm_fwd_collect", "lstm_bwd",
              "tf_fwd", "tf_bwd"):
        check(counts[k] > 0, f"kernel {k} never launched on the train path")

    for dt, outs in runs.items():
        losses = [float(o.loss_sum) for o in outs]
        check(all(np.isfinite(losses)), f"{dt}: non-finite loss")
        for o in outs:
            check(all(bool(torch.isfinite(x).all()) for x in leaves(o.params)),
                  f"{dt}: non-finite params")
        check(losses[-1] < losses[0], f"{dt}: loss_sum did not fall over "
                                      f"{TRAIN_STEPS} steps: {losses}")
        norms = {k: round(float(v), 4) for k, v in outs[0].grad_norms.items()}
        log(f"train {dt} B={B_TRAIN} T={WORD_LEN + 1}: loss_sum over "
            f"{TRAIN_STEPS} steps {[round(x, 2) for x in losses]}; step-1 "
            f"grad norms {norms}")
    # step 1 against the plain route on the card (cfg.use_pallas=False)
    tols = (1e-5, 1e-4, 1e-4)
    for dt, cfg in cfgs.items():
        plain = run_steps(cfg.replace(use_pallas=False), np_params, np_stats,
                          batch, dev, 1)[0]
        loss, norms, params = step_agreement(runs[dt][0], plain)
        log(f"train {dt} step 1, kernel route vs plain route on the card: "
            f"loss_sum rel err {loss:.3g}, grad norm rel err {norms:.3g}, "
            f"param max abs err {params:.3g}"
            + (f" (tol {tols})" if dt == "float32" else " (reported)"))
        if dt == "float32":
            check(loss <= tols[0] and norms <= tols[1] and params <= tols[2],
                  "float32 train step: kernel and plain routes disagree")
    # a reference on a small input: the port on the CPU (plain versions)
    small = train_config("float32", small=True)
    sp, ss = numpy_model(small, seed + 3)
    sb = train_batch(np.random.RandomState(seed + 4), 8)
    got = run_steps(small, sp, ss, sb, dev, 1)[0]
    want = run_steps(small, sp, ss, sb, torch.device("cpu"), 1)[0]
    loss, norms, params = step_agreement(got, want)
    log(f"train float32 small (H_enc=32, B=8), card vs CPU: loss_sum rel err "
        f"{loss:.3g}, grad norm rel err {norms:.3g}, param max abs err "
        f"{params:.3g} (tol {tols})")
    check(loss <= tols[0] and norms <= tols[1] and params <= tols[2],
          "float32 train step: card and CPU disagree")
    # score: teacher-forced gold log-probs of the transcripts
    cfg = cfgs["bfloat16"]
    ocr = AttentionOCR(cfg, *weights.from_numpy(np_params, np_stats),
                       device=dev)
    images, words = batch[0][:32], batch[1][:32]
    gold = ocr.score(images, words)
    check(gold.shape == (len(words),) and bool(np.isfinite(gold).all())
          and bool((gold <= 0).all()), f"score: {gold}")
    log(f"score bf16 on {len(words)} crops: gold log-prob mean "
        f"{gold.mean():.3f} "
        f"(per token {gold.mean() / (WORD_LEN + 1):.3f}; uniform would be "
        f"{-math.log(cfg.target_vocab_size):.3f})")
    return counts, cfg, (np_params, np_stats), batch


def train_timings(dev, cfg, np_model, batch, card: str):
    """Each training kernel against its plain version (CUDA events), its
    bound and its library call, the bf16 train step's ms and images/s
    (median of 5 after warm-up), and one profile of a step.  Returns (ms,
    bounds, library)."""
    import numpy as np
    import torch

    from aocr_torch import train_step, weights
    from aocr_torch.ops.cuda import (conv1_pool_bwd, conv1_pool_dx,
                                     greedy_loop, lstm_bwd, lstm_fwd,
                                     pool_bwd, tf_bwd, tf_fwd)

    g = torch.Generator().manual_seed(19)
    rand = lambda *s: torch.rand(*s, generator=g) * 2 - 1
    B, L, T = B_TRAIN, W_SERVE // 4 - 1, WORD_LEN + 1
    He, Hd = cfg.encoder_num_hidden, cfg.decoder_num_hidden
    ms, bounds, lib = {}, {}, {}
    for dt in (torch.float32, torch.bfloat16):
        name = "f32" if dt == torch.float32 else "bf16"
        x = rand(B, 32, W_SERVE, 1).to(dev, dt)
        w, b = (rand(64, 1, 3, 3) / 3).to(dev), (rand(64) / 3).to(dev)
        dy = rand(B, 16, W_SERVE // 2, 64).to(dev, dt)
        wh = (rand(He, 4 * He) * He ** -0.5).to(dev, dt)
        xp = rand(L, B, 4 * He).to(dev, dt)
        z = torch.zeros(B, He, device=dev)
        hs, _, (ifog, cs) = lstm_fwd.lstm_fwd_scan_plain(wh, xp, z, z, False,
                                                         collect=True)
        dhs = (rand(L, B, He) * 0.1).to(dev)
        u = lambda bound, *s: rand(*s) * bound
        wfh0 = u(Hd ** -0.5, 2 * Hd, 4 * Hd).to(dev, dt)
        rest = [(u(Hd ** -0.5, 2 * Hd, 4 * Hd).to(dev, dt),
                 u(Hd ** -0.5, 4 * Hd).to(dev), u(Hd ** -0.5, 4 * Hd).to(dev))]
        wa = u(Hd ** -0.5, Hd, Hd).to(dev, dt)
        wc = u((2 * Hd) ** -0.5, 2 * Hd, Hd).to(dev, dt)
        ctx = rand(L, B, Hd).to(dev, dt)
        xpd = rand(T, B, 4 * Hd).to(dev, dt)
        c0, h0 = rand(B, Hd).to(dev), rand(B, Hd).to(dev)
        fargs = (ctx, wfh0, rest, wa, wc, xpd, c0, h0, True, True)
        htl, _, difog, dcs, alpha, _ = tf_fwd.decoder_fwd_scan_plain(*fargs)
        bargs = (ctx, wfh0, [rest[0][0]], wc, wa,
                 (rand(T, B, Hd) * 0.1).to(dev), htl, alpha, difog, dcs, c0,
                 True)
        largs = (wh, dhs, ifog, cs, z, z, z, False)
        pairs = {
            "conv1_pool_bwd": (
                lambda: conv1_pool_bwd.conv1_relu_pool_bwd(x, w, b, dy),
                lambda: conv1_pool_bwd.conv1_relu_pool_bwd_plain(x, w, b, dy),
                20),
            "lstm_bwd": (lambda: lstm_bwd.lstm_bwd_scan(*largs),
                         lambda: lstm_bwd.lstm_bwd_scan_plain(*largs), 10),
            "tf_fwd": (lambda: tf_fwd.decoder_fwd_scan(*fargs),
                       lambda: tf_fwd.decoder_fwd_scan_plain(*fargs), 3),
            "tf_bwd": (lambda: tf_bwd.decoder_bwd_scan(*bargs),
                       lambda: tf_bwd.decoder_bwd_scan_plain(*bargs), 3),
            "conv1_pool_dx": (
                lambda: conv1_pool_dx.conv1_relu_pool_dx16(x, w, b, dy),
                lambda: conv1_pool_dx.conv1_relu_pool_dx16_plain(x, w, b,
                                                                 dy), 20),
        }
        conv_flops = 2.0 * 9 * 64 * B * 32 * W_SERVE
        tf_flops = T * B * step_flops(Hd, L, cfg.target_vocab_size, 2, True,
                                      proj=False)
        work = {  # (operations, the call's inputs and outputs)
            "conv1_pool_bwd": (2 * conv_flops, (x, w, b, dy)),
            "lstm_bwd": (2.0 * L * B * 4 * He * He, largs),
            "tf_fwd": (tf_flops, fargs),
            "tf_bwd": (tf_flops + 4.0 * T * B * L * Hd, bargs),
            # the routing's 4 x 9 taps and the winner's 9 tap products, a
            # cell and channel
            "conv1_pool_dx": (2.0 * 45 * B * 16 * (W_SERVE // 2) * 64,
                              (x, w, b, dy))}
        for k, (fk, fp, n) in pairs.items():
            k1, k2, p1, p2 = time_pair(fk, fp, n)
            ms[(k, name)] = (min(k1, k2), min(p1, p2))
            flops, ins = work[k]
            bounds[(k, name)] = bound(flops, tensor_bytes(ins, fk()), name)
            log(f"time {k} {name} (training shapes): kernel {k1:.4f} / "
                f"{k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms; bound "
                f"{bounds[(k, name)][0]:.4f} ms ({bounds[(k, name)][1]})")
        # tf_fwd without residuals (score's and eval_loss_step's call)
        tol = 1e-4 if dt == torch.float32 else 3e-2
        for Bq in TF_TIMED:
            qargs = (rand(L, Bq, Hd).to(dev, dt), wfh0, rest, wa, wc,
                     rand(T, Bq, 4 * Hd).to(dev, dt), rand(Bq, Hd).to(dev),
                     rand(Bq, Hd).to(dev), True, False)
            got = tf_fwd.decoder_fwd_scan(*qargs)
            rel = rel_err(got, tf_fwd.decoder_fwd_scan_plain(*qargs))
            check(rel <= tol, f"tf_fwd {name} collect=False B={Bq}: max "
                              f"err {rel} of the scale")
            k1, k2, p1, p2 = time_pair(
                lambda: tf_fwd.decoder_fwd_scan(*qargs),
                lambda: tf_fwd.decoder_fwd_scan_plain(*qargs),
                3 if Bq == B else 10)
            ms[("tf_fwd_score", name, Bq)] = (min(k1, k2), min(p1, p2))
            bnd = bound(T * Bq * step_flops(Hd, L, cfg.target_vocab_size, 2,
                                            True, proj=False),
                        tensor_bytes(qargs, got), name)
            bounds[("tf_fwd_score", name, Bq)] = bnd
            log(f"time tf_fwd {name} collect=False (score) B={Bq} T={T}: "
                f"kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} "
                f"ms; bound {bnd[0]:.4f} ms ({bnd[1]}); max err {rel:.3g} "
                f"of the plain scale (tol {tol:g})")
        # the weight packing each call of the two kernels does first
        pf = tf_fwd.checked_plan(Hd, B, dt, L, 2)
        pb = tf_bwd.checked_plan(Hd, B, dt, L, 2)
        tables = {"wfh0": wfh0, "wx": [rest[0][0]], "wa": wa, "wc": wc}
        packs = (cuda_ms(lambda: greedy_loop.pack_weights(tables, pf, 2,
                                                          True), 10),
                 cuda_ms(lambda: tf_bwd.pack_weights(wfh0, [rest[0][0]], wc,
                                                     wa, pb, True), 10))
        ms[("tf_pack", name)] = packs
        log(f"time the weight packing {name} (B={B}): tf_fwd's "
            f"(greedy_loop.pack_weights) {packs[0]:.4f} ms, tf_bwd's "
            f"(tf_bwd.pack_weights) {packs[1]:.4f} ms, each inside the "
            f"kernel's time above")
        pool_timings(dev, dt, name, g, ms, bounds, lib)
        _fwd, bwd = cudnn_lstm(dev, dt, L, B, cfg.cnn_feature_size, He,
                               True)
        lib[("lstm_bwd", name)] = library_ms(
            f"lstm_bwd {name}: cuDNN nn.LSTM backward (dx and the weight "
            f"gradients too), B={B} L={L} H={He}", bwd, 10)

    for mod in (tf_fwd, tf_bwd, lstm_bwd, conv1_pool_bwd):
        for _plan, line in mod.plans.values():
            log(line)
    params, stats = weights.from_numpy(*np_model, dev)
    opt = train_step.init_opt_state(params, cfg)
    step = train_step.make_train_step(cfg)
    images, _w, targets, targets_eval = batch
    images = torch.from_numpy(images).to(dev)
    targets = torch.from_numpy(targets).to(dev)
    targets_eval = torch.from_numpy(targets_eval).to(dev)
    run = lambda: step(params, stats, opt, images, targets, targets_eval,
                       cfg.learning_rate, None)
    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        out = run()
        float(out.loss_sum)
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    ms[("train_step", "bf16")] = med * 1e3
    log(f"train step bf16 B={B} T={T} W={W_SERVE}: {med * 1e3:.2f} ms "
        f"(median of 5: {[round(t * 1e3, 2) for t in times]}), "
        f"{B / med:.1f} images/s on {card}")
    profile(f"train step bf16 B={B}", lambda: float(run().loss_sum))
    # pool_bwd.ENABLE A/B: the fused pool backward against torch.relu +
    # F.max_pool2d under autograd, turns on, off, off, on, on, off
    turns = {True: [], False: []}
    for on in (True, False, False, True, True, False):
        pool_bwd.ENABLE = on
        run()
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            float(run().loss_sum)
            times.append((time.perf_counter() - t0) * 1e3)
        turns[on].append(float(np.median(times)))
    pool_bwd.ENABLE = True
    ms[("enable_ab", "bf16")] = (min(turns[True]), min(turns[False]))
    log(f"pool_bwd.ENABLE A/B, bf16 train step B={B}: on "
        f"{[round(t, 3) for t in turns[True]]} ms, off "
        f"{[round(t, 3) for t in turns[False]]} ms (median of 5 a turn, "
        f"turns on/off/off/on/on/off) on {card}")
    return ms, bounds, lib


def pool_timings(dev, dt, name: str, g, ms: dict, bounds: dict,
                 lib: dict) -> None:
    """pool_bwd at the three pools' shapes against its plain version, its
    bound and the two PyTorch calls of the unfused backward
    (max_pool2d_with_indices_backward, then threshold_backward); the
    entries hold the sums over the three, one train step's launches."""
    import torch
    import torch.nn.functional as F

    from aocr_torch.ops.cuda import pool_bwd

    tot = {"k": 0.0, "p": 0.0, "b": 0.0, "l": 0.0}
    for shape, window in POOLS:
        y = pool_input(g, shape, dev, dt)
        dy = (torch.rand(shape[0], shape[1], shape[2] // window[0],
                         shape[3] // window[1], generator=g)
              .to(dev, dt).contiguous(memory_format=torch.channels_last))
        _, idx = F.max_pool2d(y, window, return_indices=True)
        aten = torch.ops.aten

        def unfused():
            gy = aten.max_pool2d_with_indices_backward(
                dy, y, list(window), list(window), [0, 0], [1, 1], False,
                idx)
            return aten.threshold_backward(gy, y, 0)

        k1, k2, p1, p2 = time_pair(
            lambda: pool_bwd.relu_pool_bwd(y, dy, window),
            lambda: pool_bwd.relu_pool_bwd_plain(y, dy, window), 20)
        lt = library_ms(f"pool_bwd {name} {tuple(shape)}: "
                        "max_pool2d_with_indices_backward + "
                        "threshold_backward (two calls)", unfused, 20)
        b = bound(2.0 * y.numel(), tensor_bytes(
            y, dy, pool_bwd.relu_pool_bwd(y, dy, window)), name)
        log(f"time pool_bwd {name} {tuple(shape)} window {window}: kernel "
            f"{k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms; bound "
            f"{b[0]:.4f} ms ({b[1]})")
        tot["k"] += min(k1, k2)
        tot["p"] += min(p1, p2)
        tot["b"] += b[0]
        tot["l"] = None if lt is None or tot["l"] is None else tot["l"] + lt
    ms[("pool_bwd", name)] = (tot["k"], tot["p"])
    bounds[("pool_bwd", name)] = (tot["b"], "bytes")
    lib[("pool_bwd", name)] = tot["l"]
    log(f"time pool_bwd {name}, the three pools of a step: kernel "
        f"{tot['k']:.4f} ms, plain {tot['p']:.4f} ms, bound {tot['b']:.4f} "
        f"ms (bytes), library {tot['l']} ms")


# ------------------------------------------------------------ image gradient

def image_gradient(dev, seed: int) -> dict:
    """d(features)/d(images) through cnn.apply(train=True) at B=400 on
    32x100 noise crops, float32, from the numpy weights: the kernel route
    (conv1_pool forward, conv1_pool_dx and pool_bwd backward) against the
    plain route (use_kernel=False: F.conv2d, torch.relu, F.max_pool2d
    under autograd) on the card.  A pool decision that flips at a float32
    near-tie moves single pixels, so the gradient is held as a whole
    (relative L2 error 1e-4) and element by element on all but 0.1%
    (1e-5 of the scale).  Returns the kernel route's launch counts."""
    import numpy as np
    import torch

    from aocr_torch import weights
    from aocr_torch.models import cnn
    from aocr_torch.ops import cuda

    p, s = weights.from_numpy(*numpy_model(base_config(), seed), dev)
    rs = np.random.RandomState(seed + 8)
    images = torch.from_numpy(rs.uniform(0, 255, (B_TRAIN, 32, W_SERVE, 1))
                              .astype(np.float32)).to(dev)
    r = torch.from_numpy(rs.uniform(-1, 1, (B_TRAIN, W_SERVE // 4 - 1, 512))
                         .astype(np.float32)).to(dev)

    def grad(kernel):
        im = images.clone().requires_grad_()
        feats, _ = cnn.apply(p["cnn"], s, im, torch.float32,
                             use_kernel=kernel, train=True)
        return torch.autograd.grad((feats * r).sum(), im)[0]

    cuda.reset_launch_counts()
    got = grad(True)
    torch.cuda.synchronize()
    counts = cuda.launch_counts()
    log(f"image-gradient path launch counts: {counts}")
    for k, n in (("conv1_pool", 1), ("conv1_pool_dx", 1), ("pool_bwd", 3)):
        check(counts[k] == n, f"image gradient: {k} launched {counts[k]} "
                              f"times, not {n}")
    want = grad(False)
    scale = float(want.abs().max())
    err = (got - want).abs()
    l2 = float(err.norm() / want.norm())
    within = float((err <= 1e-5 * scale).float().mean())
    check(bool(torch.isfinite(got).all()) and scale > 0,
          "image gradient: non-finite or zero")
    check(l2 <= 1e-4 and within >= 0.999,
          f"image gradient f32: kernel and plain routes disagree (L2 rel "
          f"{l2}, share within 1e-5 of the scale {within})")
    log(f"image gradient f32 B={B_TRAIN} 32x{W_SERVE}, kernel vs plain route "
        f"on the card: L2 rel err {l2:.3g} (tol 1e-4), max_abs_err "
        f"{float(err.max()):.3g} of scale {scale:.3g}, share within 1e-5 "
        f"of the scale {within:.6f} (tol 0.999)")
    return counts


# ------------------------------------------------------------ CLI trainer

def write_dataset(root: str, seed: int, sizes=None, widths=None):
    """sizes[0] train and sizes[1] validation (N_TRAIN and N_VAL where not
    given) .npy crops with random
    10-letter words (train.txt, val.txt) and dict.txt, the validation
    words and 1,000 others, under root.  The crops are word_images at
    32x100, or with `widths` each split's i-th word rendered
    (aocr_torch.demo.render_word) at widths[i % len(widths)].  Returns
    the lexicon."""
    import numpy as np

    from aocr_torch import demo

    rs = np.random.RandomState(seed + 9)
    letters = list("abcdefghijklmnopqrstuvwxyz0123456789")
    word = lambda: "".join(rs.choice(letters, WORD_LEN))
    out = {}
    for split, n in zip(("train", "val"), sizes or (N_TRAIN, N_VAL)):
        os.makedirs(os.path.join(root, split))
        words = [word() for _ in range(n)]
        imgs = (word_images(rs, n, W_SERVE) if widths is None else
                [demo.render_word(w, 32, widths[i % len(widths)])
                 for i, w in enumerate(words)])
        lines = []
        for i, (w, img) in enumerate(zip(words, imgs)):
            np.save(os.path.join(root, split, f"{i}.npy"), img)
            lines.append(f"{split}/{i}.npy {w}")
        with open(os.path.join(root, f"{split}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        out[split] = words
    lexicon = sorted(set(out["val"]) | {word() for _ in range(1000)})
    with open(os.path.join(root, "dict.txt"), "w") as f:
        f.write("\n".join(lexicon) + "\n")
    return lexicon


def trainer_argv(root: str, tag: str, seed: int, *args,
                 input_feed: bool = True):
    """aocr_torch.train's argv for the data under root, the log at
    root/<tag>.log and the checkpoints in root/<tag>, -input_feed unless
    input_feed is False (the CLI's default decoder), then args."""
    return ["-data_base_dir", root, "-data_path", "train.txt",
            "-val_data_path", "val.txt",
            "-log_path", os.path.join(root, f"{tag}.log"),
            "-model_dir", os.path.join(root, tag),
            *(("-input_feed",) if input_feed else ()),
            "-max_decoder_l", str(T_MAX), "-batch_size", str(B_TRAIN),
            "-seed", str(seed), *args]


def run_trainer(root: str, tag: str, seed: int, *args,
                input_feed: bool = True):
    """aocr_torch.train.main on the card with the data under root and
    args (trainer_argv), its stdout kept out of this log; returns (its
    log messages, the launch counts of the run, seconds)."""
    import io

    import torch

    from aocr_torch import train
    from aocr_torch.ops import cuda
    from aocr_torch.ops.cuda import lstm_fwd

    log_path = os.path.join(root, f"{tag}.log")
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        train.main(trainer_argv(root, tag, seed, *args,
                                input_feed=input_feed))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = cuda.launch_counts()
    counts["lstm_fwd_collect"] = lstm_fwd.launches_collect
    with open(log_path) as f:
        msgs = [line.split(" ", 2)[2] for line in f.read().splitlines()]
    log(f"trainer {tag} ({' '.join(args)}): {secs:.1f} s; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    return msgs, counts, secs


def step_perplexities(msgs):
    """The per-step perplexity lines of a train run (the first is nan)."""
    return [float(m) for m in msgs
            if m == "nan" or m.replace(".", "", 1).isdigit()]


def window_perplexities_ok(msgs) -> bool:
    """Every 'training perplexity' line of a run is finite and above 1."""
    vals = [float(m.rsplit("= ", 1)[1]) for m in msgs
            if "training perplexity" in m]
    return bool(vals) and all(math.isfinite(v) and v > 1 for v in vals)


def perplexity_rel_err(a, b) -> float:
    """max relative difference of two runs' step perplexities; a nan (a
    step logged before any loss was summed) must be nan in both."""
    if len(a) != len(b):
        return float("inf")
    err = 0.0
    for x, y in zip(a, b):
        if math.isnan(x) or math.isnan(y):
            if not (math.isnan(x) and math.isnan(y)):
                return float("inf")
            continue
        err = max(err, abs(x - y) / abs(y))
    return err


def last_value(msgs, key: str) -> float:
    """The number after '= ' on the last message holding key."""
    hits = [m for m in msgs if key in m]
    check(bool(hits), f"trainer: no '{key}' line")
    return float(hits[-1].rsplit("= ", 1)[1].split(",")[0]) if hits else \
        float("nan")


def read_results(path: str):
    with open(path) as f:
        return [line.rstrip("\n").split("\t") for line in f]


def visualize(data_root: str, out: str, rows) -> None:
    """python -m aocr_torch.visualizer.generate_html on a -visualize run's
    results.txt: index.html has one <li> a row, and every .npy crop is
    rendered to a PNG."""
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "aocr_torch.visualizer.generate_html",
         "--output_dir", out, "--data_base_dir", data_root],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    secs = time.perf_counter() - t0
    check(run.returncode == 0, f"generate_html failed: {run.stderr[-2000:]}")
    if run.returncode:
        return
    with open(os.path.join(out, "website", "index.html")) as f:
        items = f.read().count("<li ")
    images = os.listdir(os.path.join(out, "website", "images"))
    pngs = sum(f.endswith(".png") for f in images)
    crops = len({r[0] for r in rows})
    check(items == len(rows) and pngs == crops == len(images),
          f"generate_html: {items} items for {len(rows)} rows, {pngs} PNGs "
          f"of {len(images)} images for {crops} crops")
    log(f"visualizer: index.html with {items} items for {len(rows)} rows "
        f"of results.txt, {pngs} PNGs rendered from {crops} .npy crops "
        f"({secs:.1f} s)")


@contextlib.contextmanager
def row_margins():
    """On the plain route, each decoded row's smallest step margin
    (recorded_margins' gaps): one (B,) tensor a decode, in the order of
    the decodes (decode.greedy_from_context or beam_from_context,
    outermost call)."""
    import torch

    from aocr_torch import decode

    out, depth = [], [0]
    fns = {n: getattr(decode, n)
           for n in ("greedy_from_context", "beam_from_context")}

    def wrap(f, steps):
        def recorded(*a, **kw):
            depth[0] += 1
            n0 = len(steps)
            try:
                return f(*a, **kw)
            finally:
                depth[0] -= 1
                if depth[0] == 0:
                    out.append(torch.stack(steps[n0:]).min(0).values)
        return recorded

    with recorded_margins() as steps:
        for n, f in fns.items():
            setattr(decode, n, wrap(f, steps))
        try:
            yield out
        finally:
            for n, f in fns.items():
                setattr(decode, n, f)


def trainer_runs_vs_plain(run, final, tag: str, train_args):
    """A float32 train run of train_args with the kernels (<tag>k) and one
    with -no_use_pallas (<tag>p).  Returns (their step perplexities'
    largest relative difference, their final params' largest absolute
    difference); the callers that hold them to a tolerance check it."""
    import numpy as np

    from aocr_torch.optim import leaves

    runs = {}
    for t, extra in ((tag + "k", ()), (tag + "p", ("-no_use_pallas",))):
        msgs, _c, _ = run(t, *train_args, *extra)
        runs[t] = (step_perplexities(msgs), final(t))
    (pk, ck), (pp, cp) = runs[tag + "k"], runs[tag + "p"]
    check(len(pk) > 0, f"trainer {tag}: no step perplexities")
    perr = perplexity_rel_err(pk, pp)
    werr = max(float(np.abs(a - b).max()) for a, b in
               zip(leaves(ck["params"]), leaves(cp["params"])))
    log(f"trainer {tag}, kernels vs -no_use_pallas on the card, {len(pk)} "
        f"steps: step perplexity rel err {perr:.3g}, final params "
        f"max_abs_err {werr:.3g}")
    return perr, werr


def trainer_test_vs_plain(run, root: str, tag: str, test_args) -> float:
    """Test runs of test_args on <tag>k's checkpoint with the kernels and
    with -no_use_pallas: every row's transcript equal but at a plain
    near-tie (the row's smallest step margin on the plain route below
    NEAR_TIE, or its two scores within it).  The test data must fill
    whole batches (a row a result).  Returns the share of identical
    transcripts."""
    import numpy as np
    import torch

    res, near = {}, np.zeros(0)
    for t, extra in ((f"test_{tag}k", ()),
                     (f"test_{tag}p", ("-no_use_pallas",))):
        out = os.path.join(root, f"res_{t}")
        with (row_margins() if extra else contextlib.nullcontext([])) as m:
            run(t, "-phase", "test", "-load_model", "-model_dir",
                os.path.join(root, tag + "k"), *test_args, "-visualize",
                "-output_dir", out, "-steps_per_checkpoint", "1000", *extra)
        res[t] = read_results(os.path.join(out, "results.txt"))
        if extra:
            near = torch.cat(m).cpu().numpy()
    got, want = res[f"test_{tag}k"], res[f"test_{tag}p"]
    check([r[:2] for r in got] == [r[:2] for r in want]
          and len(near) == len(want),
          f"trainer {tag} test: rows differ in path or gold, or "
          f"{len(near)} margins for {len(want)} rows")
    parted = [i for i, (a, b) in enumerate(zip(got, want)) if a[2] != b[2]]
    for i in parted:
        ok = (i < len(near) and near[i] < NEAR_TIE) or \
            abs(float(got[i][3]) - float(want[i][3])) < NEAR_TIE
        check(ok, f"trainer {tag} test: row {i} parts without a near-tie "
                  f"(plain margin {near[i] if i < len(near) else None}, "
                  f"scores {got[i][3]} / {want[i][3]})")
    same = 1.0 - len(parted) / max(len(got), 1)
    log(f"trainer {tag} test ({' '.join(test_args)}), kernels vs "
        f"-no_use_pallas: transcripts identical for {same:.4f} of "
        f"{len(got)} rows (the rest at plain near-ties < {NEAR_TIE}); "
        f"{len(set(r[2] for r in got))} distinct transcripts, mean length "
        f"{np.mean([len(r[2]) for r in got]):.2f}")
    return same


def hold_trainer_runs(tag: str, perr: float, werr: float) -> None:
    """A float32 trainer's kernel and plain runs (trainer_runs_vs_plain)
    within 1e-5 relative in step perplexity and 1e-4 in final params."""
    check(perr <= 1e-5 and werr <= 1e-4,
          f"trainer {tag}: kernels vs plain route: perplexity rel err "
          f"{perr} (tol 1e-5), params max abs err {werr} (tol 1e-4)")


def trainer_phase(dev, seed: int, card: str):
    """python -m aocr_torch.train at the default model's full width on
    N_TRAIN + N_VAL crops written from seed: bf16 train (one epoch: 2
    full steps and a 200-row partial one, a checkpoint and a one-batch
    validation every 2 steps), a -load_model resume of two epochs, a
    beam-5 test (its results.txt rendered by python -m
    aocr_torch.visualizer.generate_html) and a beam-5 dictionary test;
    then a float32 train run and a float32 beam-5 test with the kernels
    and with -no_use_pallas.  Returns (the launch counts of all runs,
    their readings)."""
    import shutil
    import tempfile

    import numpy as np

    from aocr_torch import checkpoint
    from aocr_torch.optim import leaves

    root = tempfile.mkdtemp(prefix="aocr_trainer_")
    total: dict = {}
    readings = {}

    def run(tag, *args):
        msgs, counts, secs = run_trainer(root, tag, seed, *args)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        return msgs, counts, secs

    def final(tag):
        return checkpoint.load(checkpoint.final_path(os.path.join(root, tag)))

    try:
        t0 = time.perf_counter()
        lexicon = write_dataset(root, seed)
        log(f"trainer data: {N_TRAIN} + {N_VAL} crops and a {len(lexicon)}"
            f"-word lexicon written in {time.perf_counter() - t0:.1f} s")
        train_args = ("-phase", "train", "-steps_per_checkpoint", "2",
                      "-num_batches_val", "1")
        bf16 = ("-compute_dtype", "bfloat16")
        # 1. bf16 train, one epoch: 3 steps
        msgs, c, _ = run("bf16", *train_args, *bf16, "-num_epochs", "1")
        ck = final("bf16")
        check(ck["global_step"] == 3, f"trainer bf16: global_step "
                                      f"{ck['global_step']}, not 3")
        for name in ("model-2", "model-3", "final-model"):
            check(os.path.exists(os.path.join(root, "bf16", name)),
                  f"trainer bf16: no checkpoint {name}")
        ppl = step_perplexities(msgs)
        check(len(ppl) == 3 and window_perplexities_ok(msgs),
              f"trainer bf16: step perplexities {ppl}")
        for k, n in (("pool_bwd", 9), ("conv1_pool_bwd", 3), ("tf_bwd", 3),
                     ("lstm_bwd", 6), ("lstm_fwd_collect", 6),
                     ("greedy_loop", 2), ("tf_fwd", 5)):
            check(c[k] == n, f"trainer bf16 train: {k} launched {c[k]} "
                             f"times, not {n}")
        check(c["conv1_pool_dx"] == 0, "trainer: conv1_pool_dx in training")
        readings["bf16 train"] = (ppl, last_value(msgs, "Val Accuracy"))
        # 1b. the same epoch with -device_preprocess, then with -augment
        for tag, flag in (("devpre", "-device_preprocess"),
                          ("augment", "-augment")):
            msgs, c, secs = run(tag, *train_args, *bf16, "-num_epochs", "1",
                                flag)
            ck_f = final(tag)
            ppl_f = step_perplexities(msgs)
            check(ck_f["global_step"] == 3 and len(ppl_f) == 3
                  and window_perplexities_ok(msgs),
                  f"trainer {flag}: global_step {ck_f['global_step']}, "
                  f"step perplexities {ppl_f}")
            for k, n in (("pool_bwd", 9), ("conv1_pool_bwd", 3),
                         ("tf_bwd", 3), ("lstm_bwd", 6)):
                check(c[k] == n, f"trainer {flag}: {k} launched {c[k]} "
                                 f"times, not {n}")
            diff = max(float(np.abs(a - b).max()) for a, b in
                       zip(leaves(ck_f["params"]), leaves(ck["params"])))
            log(f"trainer bf16 {flag}: step perplexities "
                f"{[round(x, 3) for x in ppl_f]}, {secs:.1f} s; final "
                f"params {diff:.3g} from the run without it (max abs)")
            readings[tag] = ppl_f
        # 2. resume for two epochs: steps 4-9
        msgs, c, _ = run("resume", *train_args, *bf16, "-num_epochs", "2",
                         "-load_model", "-model_dir",
                         os.path.join(root, "bf16"))
        check(any("Loading model from" in m for m in msgs),
              "trainer resume: no checkpoint loaded")
        check(final("bf16")["global_step"] == 9,
              f"trainer resume: global_step {final('bf16')['global_step']}")
        check(c["pool_bwd"] == 18, f"trainer resume: pool_bwd launched "
                                   f"{c['pool_bwd']} times, not 18")
        thr = [m for m in msgs if m.startswith("Throughput")]
        ppl = step_perplexities(msgs)
        check(len(ppl) == 6 and window_perplexities_ok(msgs),
              f"trainer resume: step perplexities {ppl}")
        readings["throughput"] = thr
        log(f"trainer bf16 B={B_TRAIN} resume: step perplexities "
            f"{[round(x, 3) for x in ppl]}; {thr} on {card}")
        # 3. and 4. beam-5 tests, without and with the dictionary
        prefixes = lexicon_prefixes(lexicon)
        for tag, extra in (("test", ()),
                           ("test_dict", ("-use_dictionary",
                                          "-dictionary_path",
                                          os.path.join(root, "dict.txt")))):
            out = os.path.join(root, f"res_{tag}")
            msgs, c, secs = run(tag, "-phase", "test", "-load_model",
                                "-model_dir", os.path.join(root, "bf16"),
                                *bf16, "-data_path", "val.txt",
                                "-beam_size", str(BEAM), "-visualize",
                                "-output_dir", out,
                                "-steps_per_checkpoint", "1000", *extra)
            acc = last_value(msgs, "Number of samples")
            cer = last_value(msgs, "Character error rate")
            rows = read_results(os.path.join(out, "results.txt"))
            check(len(rows) == N_VAL, f"trainer {tag}: {len(rows)} rows")
            check(abs(acc - np.mean([r[1] == r[2] for r in rows])) < 1e-6
                  and 0.0 <= cer <= 1.0,
                  f"trainer {tag}: accuracy {acc}, CER {cer}")
            check(c["beam_loop"] == 1 and c["tf_fwd"] == 1
                  and c["conv1_pool"] == 1,
                  f"trainer {tag}: launches {c}")
            if extra:
                check(all(r[2] in prefixes for r in rows),
                      f"trainer {tag}: a transcript off the lexicon")
            else:
                visualize(root, out, rows)
            log(f"trainer {tag} bf16 beam-5 B={N_VAL}: accuracy {acc:f}, "
                f"CER {cer:f}, {len(set(r[2] for r in rows))} distinct "
                f"transcripts, {secs:.2f} s with set-up")
            readings[tag] = (acc, cer)
        # 5. and 6. float32 train and beam-5 test, kernels against
        # -no_use_pallas
        hold_trainer_runs("f32", *trainer_runs_vs_plain(
            run, final, "f32", (*train_args, "-num_epochs", "1")))
        readings["f32 test identical"] = trainer_test_vs_plain(
            run, root, "f32", ("-data_path", "val.txt", "-beam_size",
                               str(BEAM)))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return total, readings


# ------------------------------------------------------------ phase 6

# the serving waves: 64 clients posting 8 requests each, then 512 at once
SERVE_CLIENTS, SERVE_EACH = 64, 8
# a float32 transcript may part from the direct decode's only where the
# plain route's best candidates were this close at some step
NEAR_TIE = 1e-4
VOCAB_CHARS = frozenset("0123456789abcdefghijklmnopqrstuvwxyz")


def http(url: str, body=None, timeout: float = 300.0):
    """(status, decoded JSON) of a GET (body None) or a POST.  A connection
    the server drops or resets raises: that is a serving fault."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body,
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def png(img) -> bytes:
    """A (H, W) image in [0, 255] as PNG bytes (uint8 gray)."""
    import numpy as np
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.asarray(img).astype(np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


def start_server(**kw):
    """aocr_torch.serve.serve(**kw) on a thread; returns (base URL, httpd,
    recognizer, thread) once it listens, or raises if the thread died."""
    import threading

    from aocr_torch import serve

    ready, box = threading.Event(), []
    t = threading.Thread(target=serve.serve, daemon=True, kwargs=dict(
        host="127.0.0.1", port=0, ready_event=ready, server_box=box, **kw))
    t.start()
    while not ready.wait(1.0):
        if not t.is_alive():
            raise RuntimeError("the server thread died before listening")
    httpd, rec = box[0]
    return f"http://127.0.0.1:{httpd.server_address[1]}", httpd, rec, t


def stop_server(httpd, thread) -> None:
    httpd.shutdown()  # serve() then closes its recognizer and socket
    thread.join(60)
    check(not thread.is_alive(), "serve: the server thread did not stop")


def post_concurrently(url: str, jobs, clients: int):
    """jobs: [(query, body)]; `clients` threads post them, thread c the
    jobs c, c + clients, ... one after another, all starting together.
    Returns ([(status, payload, seconds)] in job order, wall seconds)."""
    import threading

    out = [None] * len(jobs)
    start = threading.Barrier(clients + 1)

    def client(c):
        start.wait()
        for i in range(c, len(jobs), clients):
            t0 = time.perf_counter()
            status, payload = http(url + jobs[i][0], jobs[i][1])
            out[i] = (status, payload, time.perf_counter() - t0)

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(clients)]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "serve: a client hung")
    return out, wall


@contextlib.contextmanager
def recorded_margins():
    """On the plain route, each decode step's smallest gap among the best
    candidates of each row: greedy's top two (decode_step.freeze_and_pick)
    and beam's K + 1 (decode._apply_trie_and_topk).  Yields the list of
    (B,) tensors the steps append."""
    import torch

    from aocr_torch import decode
    from aocr_torch.ops.cuda import beam_step, decode_step

    margins = []
    pick, topk = decode_step.freeze_and_pick, decode._apply_trie_and_topk

    def pick_recorded(logp, prev, valid=None):
        out = pick(logp, prev, valid)
        margins.append(beam_step.topk_margin(out[2], 1))
        return out

    def topk_recorded(total, valid, K):
        t = total if valid is None else torch.where(
            valid, total, torch.full_like(total, beam_step.NEG))
        margins.append(beam_step.topk_margin(t, K))
        return topk(total, valid, K)

    decode_step.freeze_and_pick = pick_recorded
    decode._apply_trie_and_topk = topk_recorded
    try:
        yield margins
    finally:
        decode_step.freeze_and_pick = pick
        decode._apply_trie_and_topk = topk


def plain_margins(ocr, images, beam: int):
    """(B,) the smallest step margin of each row of a recognize of images
    by ocr's weights on the plain route (the near-tie rule's reference),
    in input order (recognize decodes a group a width)."""
    import numpy as np

    from aocr_torch.api import AttentionOCR

    plain = AttentionOCR(ocr.cfg.replace(use_pallas=False), ocr.params,
                         ocr.batch_stats, device=ocr.device)
    with row_margins() as m:
        plain.recognize(images, beam_size=beam)
    out = np.empty(sum(len(x) for x in m), np.float32)
    for (idx, _x), rows in zip(plain._prepare_groups(images), m):
        out[idx] = rows.cpu().numpy()
    return out


def parted(tag: str, got, want, margins) -> int:
    """Check that every transcript in got equals want's but at a plain
    near-tie; returns how many parted there."""
    n = 0
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            n += 1
            check(margins[i] < NEAR_TIE,
                  f"{tag}: row {i} served {a!r}, direct {b!r}, plain margin "
                  f"{margins[i]:.3g}")
    return n


def add_counts(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def timed_batcher(rec) -> list:
    """Wrap the server's model so each recognize the batcher runs appends
    (rows, beam, seconds) to the returned list."""
    busy = []
    inner = rec.ocr.recognize

    def timed(images, beam_size=None):
        t0 = time.perf_counter()
        try:
            return inner(images, beam_size=beam_size)
        finally:
            busy.append((len(images), beam_size,
                         time.perf_counter() - t0))

    rec.ocr.recognize = timed
    return busy


def serve_one_dtype(dev, dt: str, model_dir: str, bodies, ingest,
                    card: str, total: dict, readings: dict) -> None:
    """bf16 or float32: a fresh server for each wave (so /stats reads that
    wave alone), the last one also through a /recognize_batch, its error
    answers and its drain; the launch counts of the traffic (warmups
    excluded) go into total."""
    import base64

    import numpy as np
    import torch

    from aocr_torch.api import AttentionOCR
    from aocr_torch.config import Config
    from aocr_torch.ops import cuda

    cfg = Config(compute_dtype=dt)
    n = len(bodies)
    waves = [  # beam-5 on a quarter of the requests, other rows each wave
        (f"{SERVE_CLIENTS} clients x {n // SERVE_CLIENTS}",
         [(f"?beam_size={BEAM}" if i % 4 == 0 else "", bodies[i])
          for i in range(n)], SERVE_CLIENTS),
        (f"{n} clients x 1", [(f"?beam_size={BEAM}" if i % 4 == 1 else "",
                               bodies[i]) for i in range(n)], n)]
    batch_body = json.dumps({"images": [base64.b64encode(b).decode()
                                        for b in bodies]}).encode()
    counts: dict = {}
    answers, rps = {}, {}
    for w, (name, jobs, clients) in enumerate(waves):
        last = w == len(waves) - 1
        t0 = time.perf_counter()
        base, httpd, rec, thread = start_server(
            model_dir=model_dir, max_batch=B_SERVE, warmup_beams=(BEAM,),
            cfg=cfg)
        log(f"serve {dt}: listening after {time.perf_counter() - t0:.1f} s"
            f" (load and warmup of ladder {rec.ladder} x beams 1, {BEAM}); "
            f"model on {rec.ocr.device}")
        check(rec.ocr.device.type == "cuda", f"serve {dt}: the model is on "
                                             f"{rec.ocr.device}")
        busy = timed_batcher(rec)
        cuda.reset_launch_counts()
        out, wall = post_concurrently(f"{base}/recognize", jobs, clients)
        answers[name] = (jobs, out)
        rps[name] = n / wall
        s = http(f"{base}/stats")[1]
        lat = sorted(o[2] for o in out if o is not None)
        pick = lambda q: lat[min(int(q * len(lat)), len(lat) - 1)]  # noqa
        rows = s["batched_rows"] + s["padded_rows"]
        log(f"serve {dt} {name} requests: {n / wall:.1f} requests/s "
            f"({wall:.3f} s); /stats p50 {s['latency_s']['p50']} s, p99 "
            f"{s['latency_s']['p99']} s; client p50 {pick(0.5):.4f} s, p99 "
            f"{pick(0.99):.4f} s; {s['batches']} batches, "
            f"{s['batched_rows'] / s['batches']:.1f} rows a batch, "
            f"padded_rows {s['padded_rows']} ({s['padded_rows'] / rows:.1%} "
            f"of the decoded rows); the batcher in recognize "
            f"{sum(c[2] for c in busy):.3f} s of the {wall:.3f} s (greedy at "
            f"{sorted(c[0] for c in busy if c[1] == 1)}, beam-{BEAM} at "
            f"{sorted(c[0] for c in busy if c[1] == BEAM)} rows) on {card}")
        readings[("serve", dt, name)] = s
        sent = n
        if last:
            t0 = time.perf_counter()
            status, payload = http(f"{base}/recognize_batch", batch_body)
            batch_s = time.perf_counter() - t0
            check(status == 200 and len(payload.get("results", [])) == n,
                  f"serve {dt}: /recognize_batch answered {status}")
            profile(f"serve {dt}: one /recognize_batch of {n} greedy PNGs",
                    lambda: http(f"{base}/recognize_batch", batch_body))
            sent += 2 * n
        torch.cuda.synchronize()
        add_counts(counts, cuda.launch_counts())
        s = http(f"{base}/stats")[1]
        check(s["requests"] == sent,
              f"serve {dt}: /stats counted {s['requests']} of {sent}")
        check(s["errors"] == 0 and s["timeouts"] == 0
              and s["rejected"] == 0, f"serve {dt}: /stats {s}")
        if last:
            # the error answers over HTTP, then the drain
            check(http(f"{base}/healthz") == (200, {"status": "ok",
                                                     "model_params": True}),
                  f"serve {dt}: /healthz")
            bad = http(f"{base}/recognize", b"not an image")
            check(bad == (400, {"error": "cannot decode image"}),
                  f"serve {dt}: undecodable body answered {bad}")
            cold = http(f"{base}/recognize?beam_size=3", bodies[0])
            check(cold[0] == 400 and cold[1].get("allowed") == [1, BEAM],
                  f"serve {dt}: an unwarmed beam answered {cold}")
            check(http(f"{base}/nowhere")[0] == 404, f"serve {dt}: no 404")
            check(rec.drain(timeout_s=60.0),
                  f"serve {dt}: the queue did not drain")
            late = http(f"{base}/recognize", bodies[0])
            check(late == (503, {"error": "server draining"}),
                  f"serve {dt}: a submit after drain answered {late}")
            log(f"serve {dt}: /healthz 200, undecodable body 400, beam 3 "
                f"(not warmed) 400, unknown path 404, after drain 503")
        stop_server(httpd, thread)
    add_counts(total, counts)
    log(f"serve {dt} traffic launch counts: {counts}")
    for k in ("conv1_pool", "lstm_fwd", "greedy_loop", "beam_loop"):
        check(counts[k] > 0, f"kernel {k} never launched on the serving "
                             f"path ({dt})")

    # the direct recognize of the images the handler decoded, its time
    # against the /recognize_batch's
    ref = AttentionOCR.load(model_dir, cfg=cfg, device=dev)
    direct = {1: ref.recognize(ingest), BEAM: ref.recognize(
        ingest, beam_size=BEAM)}
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        ref.recognize(ingest)
        times.append(time.perf_counter() - t0)
    direct_s = float(np.median(times))
    log(f"serve {dt}: /recognize_batch of {n} PNGs {n / batch_s:.1f} "
        f"images/s ({batch_s * 1e3:.1f} ms, HTTP, base64, PNG decode and "
        f"the batcher included); a direct recognize of the same {n} "
        f"decoded images {n / direct_s:.1f} images/s ({direct_s * 1e3:.1f} "
        f"ms, median of 3) on {card}")
    readings[f"serve {dt}"] = {"rps": rps, "batch_ips": n / batch_s,
                                "direct_ips": n / direct_s}

    # every answer: 200, a text of the vocabulary, a finite score; float32
    # texts equal to the direct decode's but at plain near-ties
    margins = ({K: plain_margins(ref, ingest, K) for K in (1, BEAM)}
               if dt == "float32" else None)
    served = {1: [], BEAM: []}
    for name, (jobs, out) in answers.items():
        for i, ((query, _b), o) in enumerate(zip(jobs, out)):
            K = BEAM if query else 1
            ok = (o is not None and o[0] == 200
                  and set(o[1].get("text", "?")) <= VOCAB_CHARS
                  and math.isfinite(o[1].get("score", float("nan"))))
            check(ok, f"serve {dt} {name}: request {i} answered {o}")
            if ok:
                served[K].append((i, o[1]["text"]))
    results = payload.get("results", [])
    for r in results:
        check(set(r.get("text", "?")) <= VOCAB_CHARS
              and math.isfinite(r.get("score", float("nan"))),
              f"serve {dt}: /recognize_batch result {r}")
    for K, got in served.items():
        idx = [i for i, _ in got]
        want = [direct[K][0][i] for i in idx]
        if dt == "float32":
            p = parted(f"serve float32 beam {K}", [t for _i, t in got],
                       want, margins[K][idx])
            log(f"serve float32 beam-{K}: {len(got)} served transcripts, "
                f"{p} parted from the direct recognize at plain near-ties "
                f"(< {NEAR_TIE:g}), the rest equal")
        else:
            same = float(np.mean([a == b for (_i, a), b in zip(got, want)]))
            log(f"serve {dt} beam-{K}: {len(got)} served transcripts, "
                f"agreement with the direct recognize {same:.4f} "
                f"(reported)")
    if dt == "float32":
        p = parted("serve float32 /recognize_batch",
                   [r.get("text") for r in results], direct[1][0],
                   margins[1])
        log(f"serve float32 /recognize_batch: {p} of {n} parted at plain "
            f"near-ties")


def serving_phase(dev, seed: int, lexicon, card: str):
    """aocr_torch.serve at the default model's full width (depth uncut,
    numpy weights from seed, saved with the port's save): a bf16 and a
    float32 server (max_batch 512, beam-5 warmed), each through 64
    clients x 8 PNG requests and 512 at once (a quarter beam-5), a
    /recognize_batch of 512, its error answers and drain; then a bf16
    server under -dictionary (the 88k lexicon) without warmup; and the
    decoder-weight packing's share of a recognize at the ladder's small
    sizes.  Returns (the launch counts of the traffic, readings)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from aocr_torch import data, demo, weights
    from aocr_torch.api import AttentionOCR
    from aocr_torch.config import Config
    from aocr_torch.models import model as model_lib
    from aocr_torch.ops import cuda
    from aocr_torch.ops.cuda import greedy_loop

    log("serve: PNG posts over HTTP (PIL decodes on the card's host)")
    base = base_config()
    np_params, np_stats = numpy_model(base, seed)
    rs = np.random.RandomState(seed + 11)
    letters = list("abcdefghijklmnopqrstuvwxyz0123456789")
    words = ["".join(rs.choice(letters, rs.randint(2, 11)))
             for _ in range(B_SERVE)]
    bodies = [png(demo.render_word(w)) for w in words]
    root = tempfile.mkdtemp(prefix="aocr_serve_")
    total: dict = {}
    readings: dict = {}
    try:
        model_dir = os.path.join(root, "model")
        AttentionOCR(base, *weights.from_numpy(np_params, np_stats),
                     device=dev).save(model_dir)
        # what the handler decodes from each body
        t0 = time.perf_counter()
        ingest = [data.load_and_preprocess(b, base) for b in bodies]
        log(f"serve: the host decode of {len(bodies)} PNG bodies "
            f"(data.load_and_preprocess, one thread) "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        check(all(im is not None and im.shape == (32, W_SERVE)
                  for im in ingest), "serve: the PNGs do not decode")
        for dt in ("bfloat16", "float32"):
            serve_one_dtype(dev, dt, model_dir, bodies, ingest, card,
                            total, readings)

        # -dictionary over the 88k lexicon, -no_warmup
        lex_words, _table = lexicon
        prefixes = lexicon_prefixes(lex_words)
        path = os.path.join(root, "lexicon.txt")
        with open(path, "w") as f:
            f.write("\n".join(lex_words) + "\n")
        cfg = Config(compute_dtype="bfloat16")
        t0 = time.perf_counter()
        base_url, httpd, rec, thread = start_server(
            model_dir=model_dir, max_batch=B_SERVE, warmup=False,
            warmup_beams=(BEAM,), cfg=cfg, dictionary_path=path)
        up = time.perf_counter() - t0
        cuda.reset_launch_counts()
        t0 = time.perf_counter()
        first = http(f"{base_url}/recognize", bodies[0])
        first_s = time.perf_counter() - t0
        check(first[0] == 200 and first_s < rec.request_timeout_s,
              f"serve -no_warmup: the first request answered {first[0]} "
              f"after {first_s:.1f} s")
        jobs = [(f"?beam_size={BEAM}" if i % 2 else "", bodies[i])
                for i in range(SERVE_CLIENTS)]
        out, wall = post_concurrently(f"{base_url}/recognize", jobs,
                                      SERVE_CLIENTS)
        torch.cuda.synchronize()
        counts = cuda.launch_counts()
        add_counts(total, counts)
        for k in ("greedy_loop", "beam_loop"):
            check(counts[k] > 0, f"kernel {k} never launched on the "
                                 "dictionary serving path")
        texts = [o[1].get("text") for o in out if o and o[0] == 200]
        check(len(texts) == len(jobs) and first[1].get("text") in prefixes
              and all(t in prefixes for t in texts),
              "serve -dictionary: a transcript off the lexicon or an error")
        in_lex = float(np.mean([t in set(lex_words) for t in texts]))
        log(f"serve -dictionary bf16 ({len(lex_words)} words, -no_warmup): "
            f"listening after {up:.1f} s (the DAWG built), the first "
            f"request in {first_s:.2f} s (timeout "
            f"{rec.request_timeout_s:g} s), then {len(jobs)} concurrent "
            f"greedy and beam-5 requests in {wall:.3f} s, all on the "
            f"lexicon's prefixes ({in_lex:.3f} whole words); launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        stop_server(httpd, thread)

        # greedy_loop.build_tables packs the decoder weights at every
        # recognize (ROADMAP R5): its share at the ladder's small sizes
        for dt in ("bfloat16", "float32"):
            cfg = Config(compute_dtype=dt)
            ocr = AttentionOCR.load(model_dir, cfg=cfg, device=dev)
            cd = model_lib.compute_dtype(ocr.cfg)
            pack = lambda: greedy_loop.build_tables(  # noqa: E731
                ocr.params["decoder"], ocr.params["projector"],
                ocr.cfg.target_embedding_size, ocr.cfg.input_feed, cd)
            pack()
            torch.cuda.synchronize()
            pt = []
            for _ in range(5):
                t0 = time.perf_counter()
                pack()
                torch.cuda.synchronize()
                pt.append(time.perf_counter() - t0)
            pack_ms = float(np.median(pt)) * 1e3
            parts = []
            for B in (1, 8, 32):
                ocr.recognize(ingest[:B])
                rt = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    ocr.recognize(ingest[:B])
                    rt.append(time.perf_counter() - t0)
                rec_ms = float(np.median(rt)) * 1e3
                parts.append(f"B={B} recognize {rec_ms:.2f} ms, packing "
                             f"{pack_ms / rec_ms:.1%}")
                readings[("pack", dt, B)] = (pack_ms, rec_ms)
            log(f"serve {dt}: greedy_loop.build_tables {pack_ms:.3f} ms a "
                f"call (median of 5); " + "; ".join(parts) + f" on {card}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"serving path launch counts: {total}")
    return total, readings


# The decode steps of the export phase's host-loop programs (the plain
# route, beam_step's and decode_step's): tracing unrolls the loop, ~100
# nodes a step, and a 50-step beam-10 program took 105 s to trace on the
# H100 machine's host; the whole-loop kernels' programs decode all T_MAX.
T_EXPORT_HOST = 12
# the kernel artifacts of the export phase: (name, compute dtype, the
# cfg's routes, beam size, the 88k lexicon, the kernel of the route,
# decode steps: None for T_MAX)
EXPORT_ROUTES = (
    ("greedy f32", "float32", "loop", 1, False, "greedy_loop", None),
    ("greedy bf16", "bfloat16", "loop", 1, False, "greedy_loop", None),
    ("dict beam-5 bf16", "bfloat16", "loop", BEAM, True, "beam_loop",
     None),
    (f"beam-{BEAM_STEP_K[1]} bf16", "bfloat16", "loop", BEAM_STEP_K[1],
     False, "beam_step", T_EXPORT_HOST),
    ("greedy tail f32", "float32", "tail", 1, False, "decode_step",
     T_EXPORT_HOST))


def export_plain_cpu(seed: int, path: str, out: str) -> None:
    """The export phase's plain artifact, traced on the CPU in a process
    of its own (spawn) while the parent traces the kernel artifacts on
    the card: greedy, float32, use_pallas=False, from the --seed weights.
    T_EXPORT_HOST steps.  Writes its trace seconds to out, or its
    traceback to out + ".err"."""
    try:
        sys.path.insert(0, ROOT)
        from aocr_torch import export, weights
        from aocr_torch.api import AttentionOCR

        base = base_config().replace(use_pallas=False)
        ocr = AttentionOCR(base, *weights.from_numpy(*numpy_model(base, seed)),
                           device="cpu")
        t0 = time.perf_counter()
        export.export_recognizer(ocr, path, max_len=T_EXPORT_HOST,
                                 device="cpu")
        with open(out, "w") as f:
            json.dump({"trace_s": time.perf_counter() - t0}, f)
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def export_phase(dev, seed: int, lexicon, card: str):
    """aocr_torch.export at the default model's full width (depth uncut,
    numpy weights from seed), B=512 crops of 32 x 100, T=50 (the
    host-loop programs T_EXPORT_HOST): (a) a plain
    greedy artifact traced on the CPU (in a spawned process, meanwhile)
    and loaded on the card, against the live float32 recognize with
    use_pallas=False (transcripts equal, scores rtol 1e-5); (b) kernel
    artifacts traced on the card on each route of EXPORT_ROUTES, each
    held to the live recognize of its model (transcripts equal, scores
    rtol 1e-5, whether bit-equal reported), the launches of its
    recognize counted from 0 (its route's kernels must launch, and a
    tail-route decode must pack decode_step's weights once); (c) a
    weight-only update_weights with perturbed weights against the live
    model holding them; (d) a /recognize_batch of 64 PNGs through
    serve(artifact=...) against a direct call of the artifact; (e) each
    artifact's size, trace and load seconds, and the artifact's and the
    live recognize's ms (median of 5 after a warm-up, host clock).
    Returns (the launch counts of the artifacts' recognizes and the
    served wave, readings)."""
    import base64
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from aocr_torch import data, export, weights
    from aocr_torch.api import AttentionOCR
    from aocr_torch.ops import cuda
    from aocr_torch.ops.cuda import decode_step

    log("export: .aocrx artifacts of torch.export programs")
    base = base_config()
    np_params, np_stats = numpy_model(base, seed)
    words, table_np = lexicon
    rs = np.random.RandomState(seed + 13)
    batch = word_images(rs, B_SERVE, W_SERVE)
    root = tempfile.mkdtemp(prefix="aocr_export_")
    total: dict = {}
    readings: dict = {}

    def model(dt, route="loop", params=np_params, **kw):
        cfg = base.replace(compute_dtype=dt, pallas_greedy=route,
                           pallas_beam=route, **kw)
        return AttentionOCR(cfg, *weights.from_numpy(params, np_stats),
                            device=dev)

    def ms(fn, n: int = 5) -> float:
        fn()
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts)) * 1e3

    def held(tag, got, want, tol=1e-5):
        """got and want (words, scores): transcripts equal and scores
        within tol relative; returns (rows differing, max |score gap|)."""
        diff = sum(a != b for a, b in zip(got[0], want[0]))
        gap = float(np.abs(got[1] - want[1]).max())
        check(len(got[0]) == len(want[0]) and diff == 0,
              f"export {tag}: {diff} transcripts differ from the live "
              "recognize")
        check(bool(np.allclose(got[1], want[1], rtol=tol, atol=0)),
              f"export {tag}: score gap {gap} past rtol {tol}")
        return diff, gap

    def reading(tag, path, trace_s, load_s, art_ms, live_ms, gap, T):
        mb = os.path.getsize(path) / 1e6
        readings[tag] = {"mb": mb, "trace_s": trace_s, "load_s": load_s,
                         "ms": art_ms, "live_ms": live_ms, "gap": gap,
                         "T": T}
        log(f"export {tag}: artifact {mb:.1f} MB, traced in {trace_s:.1f} s,"
            f" loaded in {load_s:.1f} s; recognize B={B_SERVE} T={T} "
            f"{art_ms:.2f} ms against the live {live_ms:.2f} ms (median of "
            f"5 after a "
            f"warm-up, host clock); scores "
            + ("bit-equal" if gap == 0 else f"within {gap:.3g}")
            + f" on {card}")

    plain_path = os.path.join(root, "plain.aocrx")
    child = mp.get_context("spawn").Process(
        target=export_plain_cpu,
        args=(seed, plain_path, os.path.join(root, "plain.json")))
    child.start()
    try:
        # (b) the kernel artifacts, traced on the card
        paths = {}
        for name, dt, route, K, dictionary, kernel, T in EXPORT_ROUTES:
            T = T or T_MAX
            m = model(dt, route)
            if dictionary:
                m.set_dictionary_table(table_np)
            path = paths[name] = os.path.join(root, f"{len(paths)}.aocrx")
            t0 = time.perf_counter()
            export.export_recognizer(m, path, beam_size=K, max_len=T,
                                     use_pallas=True, device=dev)
            trace_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            rec = export.ExportedRecognizer.load(path, dev)
            load_s = time.perf_counter() - t0
            rec.recognize(batch[:8])  # the kernels' plans for a batch of 8
            cuda.reset_launch_counts()
            packs = decode_step.packs
            got = rec.recognize(batch)
            torch.cuda.synchronize()
            counts = cuda.launch_counts()
            add_counts(total, counts)
            log(f"export {name} artifact recognize launch counts: {counts}")
            for k in ("conv1_pool", "lstm_fwd", kernel):
                check(counts[k] > 0, f"export {name}: kernel {k} never "
                                     "launched by the artifact")
            if kernel == "decode_step":
                check(decode_step.packs - packs == 1,
                      f"export {name}: decode_step's weights packed "
                      f"{decode_step.packs - packs} times in one decode")
            want = m.recognize(batch, beam_size=K, max_len=T)
            _diff, gap = held(name, got, want)
            if dictionary:
                prefixes = lexicon_prefixes(words)
                check(all(w in prefixes for w in got[0]),
                      f"export {name}: a transcript off the lexicon")
            reading(name, path, trace_s, load_s,
                    ms(lambda: rec.recognize(batch)),
                    ms(lambda: m.recognize(batch, beam_size=K, max_len=T)),
                    gap, T)
            if name == "greedy bf16":
                src, src_rec, src_got = path, rec, got
            del rec, m

        # (c) a weight-only update of the bf16 greedy kernel artifact
        perturbed = {**np_params, "projector": {
            "w": np_params["projector"]["w"] * 1.25,
            "b": np_params["projector"]["b"]}}
        m2 = model("bfloat16", params=perturbed)
        upd = os.path.join(root, "updated.aocrx")
        t0 = time.perf_counter()
        export.update_weights(src, m2, upd)
        upd_s = time.perf_counter() - t0
        got = export.ExportedRecognizer.load(upd, dev).recognize(batch)
        _diff, gap = held("update_weights", got, m2.recognize(batch))
        moved = sum(a != b for a, b in zip(got[0], src_got[0]))
        check(not np.array_equal(got[1], src_got[1]),
              "export update_weights: the scores did not move")
        log(f"export update_weights: written in {upd_s:.1f} s; {moved} of "
            f"{B_SERVE} transcripts moved with the perturbed projector; "
            f"equal to the live model holding those weights (scores "
            + ("bit-equal" if gap == 0 else f"within {gap:.3g}") + ")")

        # (d) one wave through serve(artifact=...)
        bodies = [png(img) for img in batch[:64]]
        cfg = src_rec.preprocess_config()
        ingest = np.stack([data.load_and_preprocess(b, cfg) for b in bodies])
        want = src_rec.recognize(ingest)
        cuda.reset_launch_counts()
        url, httpd, srv, thread = start_server(
            artifact=src, device=dev, max_batch=64, warmup=False)
        try:
            body = json.dumps({"images": [base64.b64encode(b).decode()
                                          for b in bodies]}).encode()
            status, payload = http(f"{url}/recognize_batch", body)
            wrong_beam = http(f"{url}/recognize?beam_size={BEAM}",
                              bodies[0])[0]
        finally:
            stop_server(httpd, thread)
        torch.cuda.synchronize()
        add_counts(total, cuda.launch_counts())
        texts = [r.get("text") for r in payload.get("results", [])]
        check(status == 200 and texts == want[0],
              f"export serve: /recognize_batch answered {status}, "
              f"{sum(a != b for a, b in zip(texts, want[0]))} texts differ "
              "from the direct call")
        check(wrong_beam == 400, f"export serve: beam {BEAM} answered "
                                 f"{wrong_beam}, not 400")
        log(f"export serve(artifact=...): /recognize_batch of 64 PNGs "
            f"{status}, texts equal to the direct call "
            f"{texts == want[0]}; beam {BEAM} refused {wrong_beam}")

        # (a) the plain artifact traced on the CPU, served on the card
        child.join(600)
        check(child.exitcode == 0, "export: the CPU trace failed: "
              + (open(os.path.join(root, "plain.json.err")).read()[-2000:]
                 if os.path.exists(os.path.join(root, "plain.json.err"))
                 else f"exit code {child.exitcode}"))
        if child.exitcode == 0:
            with open(os.path.join(root, "plain.json")) as f:
                trace_s = json.load(f)["trace_s"]
            t0 = time.perf_counter()
            rec = export.ExportedRecognizer.load(plain_path, dev)
            load_s = time.perf_counter() - t0
            live = model("float32", use_pallas=False)
            cuda.reset_launch_counts()
            got = rec.recognize(batch)
            torch.cuda.synchronize()
            counts = cuda.launch_counts()
            check(not any(counts.values()),
                  f"export plain: the plain artifact launched {counts}")
            _diff, gap = held("plain (traced on the CPU)", got,
                              live.recognize(batch, max_len=T_EXPORT_HOST))
            reading("plain greedy f32 (traced on the CPU)", plain_path,
                    trace_s, load_s, ms(lambda: rec.recognize(batch)),
                    ms(lambda: live.recognize(batch,
                                              max_len=T_EXPORT_HOST)), gap,
                    T_EXPORT_HOST)
    finally:
        if child.is_alive():
            child.kill()
        child.join(30)
        shutil.rmtree(root, ignore_errors=True)
    log(f"export path launch counts: {total}")
    return total, readings


def device_preprocess_phase(dev, seed: int, card: str):
    """recognize on B=512 .npy paths (RGB uint8 crops, 32 x 100) with
    device_preprocess and without, bf16 and float32: the images agree
    within 1e-3 on [0, 255], and float32 transcripts equal but at plain
    near-ties; preprocess_varsize on the card against the CPU on a
    mixed-size batch.  Returns the path's launch counts."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from aocr_torch import data, preprocess, weights
    from aocr_torch.api import AttentionOCR
    from aocr_torch.ops import cuda

    base = base_config()
    np_params, np_stats = numpy_model(base, seed)
    rs = np.random.RandomState(seed + 13)
    gray = word_images(rs, B_SERVE, W_SERVE)
    rgb = np.stack([gray, gray * 0.9 + 12, gray * 0.8 + 30],
                   -1).clip(0, 255).astype(np.uint8)
    root = tempfile.mkdtemp(prefix="aocr_devpre_")
    try:
        paths = []
        for i, img in enumerate(rgb):
            paths.append(os.path.join(root, f"{i}.npy"))
            np.save(paths[-1], img)
        host_imgs = np.stack(data.images_to_arrays(paths, base))
        buf, sizes = data.pack_raw([data.load_raw(p, base)[0]
                                    for p in paths])
        dev_imgs = preprocess.preprocess_varsize(buf, sizes, 32, W_SERVE,
                                                 dev).cpu().numpy()
        err = float(np.abs(dev_imgs - host_imgs).max())
        check(err <= 1e-3, f"device preprocess: images {err} from the host "
                           "path's")
        sizes_mixed = [(48, 160), (31, 99), (17, 333), (64, 200), (5, 3)]
        mixed = [rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
                 for h, w in sizes_mixed]
        mbuf, msizes = data.pack_raw(mixed)
        on_card = preprocess.preprocess_varsize(mbuf, msizes, 32, 77,
                                                dev).cpu()
        on_cpu = preprocess.preprocess_varsize(mbuf, msizes, 32, 77, "cpu")
        merr = float((on_card - on_cpu).abs().max())
        check(merr <= 1e-3, f"device preprocess: card and CPU {merr} apart "
                            "on a mixed-size batch")
        log(f"device preprocess B={B_SERVE} RGB 32x{W_SERVE}: images "
            f"{err:.3g} from the host path's (tol 1e-3); a mixed-size "
            f"batch (1 to 333 px wide) on the card {merr:.3g} from the "
            f"CPU's")

        models = {}
        for dt in ("bfloat16", "float32"):
            for devpre in (False, True):
                cfg = base.replace(compute_dtype=dt,
                                   device_preprocess=devpre)
                models[(dt, devpre)] = AttentionOCR(
                    cfg, *weights.from_numpy(np_params, np_stats),
                    device=dev)
        # the host-preprocess runs first, outside the counted window
        outs = {k: m.recognize(paths) for k, m in models.items() if not k[1]}
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        outs.update({k: m.recognize(paths) for k, m in models.items()
                     if k[1]})
        torch.cuda.synchronize()
        counts = cuda.launch_counts()
        for k in ("conv1_pool", "lstm_fwd", "greedy_loop"):
            check(counts[k] > 0, f"kernel {k} never launched on the "
                                 "device-preprocess path")
        for dt in ("bfloat16", "float32"):
            (hw, hs), (dw, ds) = outs[(dt, False)], outs[(dt, True)]
            check(bool(np.isfinite(ds).all()) and len(dw) == B_SERVE,
                  f"device preprocess {dt}: bad results")
            if dt == "float32":
                margins = plain_margins(models[(dt, False)], host_imgs, 1)
                p = parted("device preprocess float32", dw, hw, margins)
                log(f"device preprocess float32: {p} of {B_SERVE} "
                    "transcripts parted from the host path's at plain "
                    f"near-ties (< {NEAR_TIE:g}), the rest equal")
            else:
                same = float(np.mean([a == b for a, b in zip(dw, hw)]))
                log(f"device preprocess bf16: agreement with the host path "
                    f"{same:.4f} (reported)")
            ms = {}
            for devpre in (False, True, True, False):
                t0 = time.perf_counter()
                models[(dt, devpre)].recognize(paths)
                ms.setdefault(devpre, []).append(
                    (time.perf_counter() - t0) * 1e3)
            log(f"device preprocess {dt} recognize B={B_SERVE} .npy paths: "
                f"device preprocess {min(ms[True]):.2f} ms, host "
                f"preprocess {min(ms[False]):.2f} ms (better of two turns, "
                f"host clock, decode included) on {card}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"device-preprocess path launch counts: {counts}")
    return counts


def augment_phase(dev, tcfg, np_model, batch, card: str):
    """The bf16 train step at B=400 with cfg.augment: 5 steps twice from
    the same weights and step keys (the same step-1 loss), finite and not
    the unaugmented step's; the step's ms with and without augment, in
    turns.  Returns the path's launch counts."""
    import numpy as np
    import torch

    from aocr_torch import augment, train_step, weights
    from aocr_torch.ops import cuda
    from aocr_torch.ops.cuda import lstm_fwd

    cfg = tcfg.replace(augment=True)
    cuda.reset_launch_counts()
    runs = [run_steps(cfg, *np_model, batch, dev, TRAIN_STEPS)
            for _ in range(2)]
    torch.cuda.synchronize()
    counts = cuda.launch_counts()
    counts["lstm_fwd_collect"] = lstm_fwd.launches_collect
    for k in ("conv1_pool", "conv1_pool_bwd", "lstm_fwd_collect", "lstm_bwd",
              "tf_fwd", "tf_bwd", "pool_bwd"):
        check(counts[k] > 0, f"kernel {k} never launched on the augmented "
                             "train path")
    losses = [[float(o.loss_sum) for o in r] for r in runs]
    plain = float(run_steps(tcfg, *np_model, batch, dev, 1)[0].loss_sum)
    check(all(math.isfinite(x) for x in losses[0] + losses[1]),
          f"augment: non-finite loss {losses}")
    check(losses[0][0] == losses[1][0], f"augment: the same key gave "
                                        f"{losses[0][0]} and {losses[1][0]}")
    check(losses[0][0] != plain, "augment: the augmented loss is the plain "
                                 "step's")
    drift = max(abs(a - b) / abs(b) for a, b in zip(*losses))
    log(f"augment bf16 B={B_TRAIN}: loss_sum over {TRAIN_STEPS} steps "
        f"{[round(x, 3) for x in losses[0]]} (unaugmented step 1 "
        f"{plain:.3f}); a second run from the same keys: step 1 equal, "
        f"largest relative difference over the steps {drift:.3g}")

    params, stats = weights.from_numpy(*np_model, dev)
    images, _w, targets, targets_eval = batch
    images = torch.from_numpy(images).to(dev)
    targets = torch.from_numpy(targets).to(dev)
    targets_eval = torch.from_numpy(targets_eval).to(dev)
    opt = train_step.init_opt_state(params, tcfg)
    steps = {on: train_step.make_train_step(tcfg.replace(augment=on))
             for on in (False, True)}
    key = augment.step_key(tcfg.seed, 0)
    turns = {False: [], True: []}
    for on in (False, True, True, False):
        run = lambda: float(steps[on](  # noqa: E731
            params, stats, opt, images, targets, targets_eval,
            tcfg.learning_rate, key).loss_sum)
        run()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            run()
            times.append((time.perf_counter() - t0) * 1e3)
        turns[on].append(float(np.median(times)))
    log(f"augment: bf16 train step B={B_TRAIN} with augment "
        f"{[round(t, 2) for t in turns[True]]} ms, without "
        f"{[round(t, 2) for t in turns[False]]} ms (median of 5 a turn, "
        f"turns off/on/on/off) on {card}")
    u_ms = cuda_ms(lambda: augment.augment_batch(key, images), 10)
    log(f"augment: augment_batch alone at B={B_TRAIN} 32x{W_SERVE}: "
        f"{u_ms:.3f} ms (CUDA events) on {card}")
    log(f"augmented train path launch counts: {counts}")
    return counts


# ------------------------------------------------------------ main

# ------------------------------------------------------------ phase 7

def t7_reference_tree(np_params, np_stats, cfg):
    """The reference's checkpoint object tree (its model.lua:724:
    {{cnn, encoder_fw, encoder_bw, decoder, output_projector}, config,
    global_step, optim_state}) holding numpy weights of the port's
    checkpoint layout in torch-native layouts (conv OIHW, nn.Linear (out,
    in), fused [i|f|o|g] gates, the -prealloc name tags): the tree
    tests/torch_fixture.py builds, without the JAX package it imports."""
    import numpy as np

    from aocr_torch.models.cnn import CONV_DEFS
    from aocr_torch.t7 import TorchObject

    def obj(cls, **fields):
        return TorchObject(cls, fields)

    def linear(w, b=None, cls="nn.Linear", name=None):
        fields = {"weight": np.ascontiguousarray(w.T)}
        if b is not None:
            fields["bias"] = b
        if name:
            fields["name"] = name
        return TorchObject(cls, fields)

    mods = [obj("nn.AddConstant", constant_scalar=-128.0),
            obj("nn.MulConstant", constant_scalar=1.0 / 128)]
    for name, i, o, kh, kw, pad, bn in CONV_DEFS:
        c = np_params["cnn"][name]
        p = 1 if pad == "SAME" else 0
        mods.append(obj("cudnn.SpatialConvolution",
                        weight=np.ascontiguousarray(
                            c["w"].transpose(3, 2, 0, 1)),
                        bias=c["b"], nInputPlane=i, nOutputPlane=o, kH=kh,
                        kW=kw, dH=1, dW=1, padH=p, padW=p, train=False))
        if bn:
            b, st = np_params["cnn"][name + "_bn"], np_stats[name + "_bn"]
            mods.append(obj("nn.SpatialBatchNormalization",
                            weight=b["scale"], bias=b["bias"],
                            running_mean=st["mean"], running_var=st["var"],
                            eps=1e-5, momentum=0.1, affine=True,
                            train=False))
        mods.append(obj("cudnn.ReLU", inplace=True))
    cnn = obj("nn.Sequential",
              modules=mods + [obj("nn.View"), obj("nn.Transpose")])

    def lstm(layers, tag, lookup=None, attn=None):
        mods = []
        if lookup is not None:
            mods += [obj("nn.Identity"), obj("nn.LookupTable", weight=lookup),
                     obj("nn.JoinTable", dimension=2)]
        for li, lw in enumerate(layers, start=1):
            mods += [linear(lw["wi"], lw["bi"], name=f"{tag}_L{li}_i2h-reuse"),
                     linear(lw["wh"], lw["bh"], name=f"{tag}_L{li}_h2h-reuse"),
                     obj("nn.CAddTable"), obj("nn.Reshape"),
                     obj("nn.SplitTable")]
            mods += [obj("nn.Sigmoid") for _ in range(3)] + [obj("nn.Tanh")]
        if attn is not None:
            mods.append(obj("nn.gModule", name="decoder_attn", modules=[
                obj("nn.Identity"),
                linear(attn["w_a"], cls="nn.LinearNoBias"),
                obj("nn.MM"), obj("nn.Sum"), obj("nn.SoftMax"),
                obj("nn.Replicate"), obj("nn.MM"), obj("nn.Sum"),
                obj("nn.JoinTable"),
                linear(attn["w_c"], cls="nn.LinearNoBias"),
                obj("nn.Tanh")]))
        return obj("nn.gModule", modules=mods)

    dec = np_params["decoder"]
    groups = [cnn,
              lstm(np_params["encoder_fw"]["layers"], "encoder-fw"),
              lstm(np_params["encoder_bw"]["layers"], "encoder-bw"),
              lstm(dec["layers"], "decoder", lookup=dec["embedding"],
                   attn=dec),
              obj("nn.Sequential", modules=[
                  linear(np_params["projector"]["w"],
                         np_params["projector"]["b"]),
                  obj("nn.LogSoftMax")])]
    config = {"dropout": 0.0,
              "encoder_num_hidden": cfg.encoder_num_hidden,
              "encoder_num_layers": cfg.encoder_num_layers,
              "decoder_num_layers": cfg.decoder_num_layers,
              "target_vocab_size": cfg.target_vocab_size,
              "target_embedding_size": cfg.target_embedding_size,
              "input_feed": cfg.input_feed,
              "max_encoder_l": cfg.max_encoder_l,
              "max_decoder_l": cfg.max_decoder_l, "batch_size": 64,
              "prealloc": True}
    optim_state = {"learningRate": 0.5, 1: {"evalCounter": 1234.0}}
    return [groups, config, 1234.0, optim_state]


def import_phase(dev, seed: int, card: str):
    """The reference's Torch7 checkpoint of the default model at full
    width, from --seed numpy weights: written by aocr_torch.t7 with 8-byte
    and with 4-byte longs, imported by `python -m aocr_torch.torch_import`
    into model dirs, loaded on the card: params bit-equal to the weights
    the direct model gets, greedy and beam-5 transcripts at B=512 equal to
    the direct model's in bf16 and float32.  Returns (the launch counts of
    the imported models' recognize, readings)."""
    import numpy as np
    import torch

    from aocr_torch import t7, torch_import, weights
    from aocr_torch.api import AttentionOCR
    from aocr_torch.config import STRUCT_FIELDS
    from aocr_torch.ops import cuda
    from aocr_torch.optim import leaves

    base = base_config()
    np_params, np_stats = numpy_model(base, seed)
    batch = word_images(np.random.RandomState(seed + 11), B_SERVE, W_SERVE)
    want_p, want_s = weights.from_numpy(np_params, np_stats, dev)
    direct = {}
    for dt in ("bfloat16", "float32"):
        ocr = AttentionOCR(base.replace(compute_dtype=dt),
                           *weights.from_numpy(np_params, np_stats),
                           device=dev)
        direct[dt] = {K: ocr.recognize(batch, beam_size=K) for K in (1, BEAM)}
    root = tempfile.mkdtemp(prefix="aocr_t7_")
    readings = {}
    try:
        tree = t7_reference_tree(np_params, np_stats, base)
        cuda.reset_launch_counts()
        for ls in (8, 4):
            path = os.path.join(root, f"reference_long{ls}.t7")
            t0 = time.perf_counter()
            t7.save(path, tree, long_size=ls)
            write_s = time.perf_counter() - t0
            mb = os.path.getsize(path) / 2 ** 20
            t0 = time.perf_counter()
            torch_import.import_checkpoint(path, long_size=ls)
            map_s = time.perf_counter() - t0
            mdir = os.path.join(root, f"model{ls}")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "aocr_torch.torch_import", path, mdir,
                 "--long_size", str(ls), "--summary"], cwd=ROOT,
                capture_output=True, text=True, timeout=600)
            cli_s = time.perf_counter() - t0
            check(proc.returncode == 0 and "global_step: 1234" in proc.stdout,
                  f"torch_import --long_size {ls}: rc {proc.returncode}: "
                  f"{proc.stdout[-500:]} {proc.stderr[-2000:]}")
            log(f"t7 import, {ls}-byte longs: stream {mb:.1f} MB written in "
                f"{write_s:.2f} s; import_checkpoint {map_s:.2f} s; python "
                f"-m aocr_torch.torch_import {cli_s:.2f} s (with the "
                f"interpreter's start); on {card}")
            readings[ls] = {"mb": mb, "import_s": map_s, "cli_s": cli_s}
            for dt in ("bfloat16", "float32"):
                ocr = AttentionOCR.load(mdir, cfg=base.replace(
                    compute_dtype=dt), device=dev)
                same = all(torch.equal(a, b) for a, b in zip(
                    leaves(ocr.params), leaves(want_p))) and all(
                    torch.equal(a, b) for a, b in zip(
                        leaves(ocr.batch_stats), leaves(want_s)))
                check(same, f"t7 import long{ls} {dt}: params not bit-equal "
                            "to the mapped weights")
                check(all(getattr(ocr.cfg, k) == getattr(base, k)
                          for k in STRUCT_FIELDS)
                      and ocr.global_step == 1234,
                      f"t7 import long{ls}: config or global_step differ")
                for K in (1, BEAM):
                    words, scores = ocr.recognize(batch, beam_size=K)
                    w0, s0 = direct[dt][K]
                    check(words == w0 and np.array_equal(scores, s0),
                          f"t7 import long{ls} {dt} beam {K}: transcripts "
                          "differ from the direct model's")
                log(f"t7 import long{ls} {dt}: params bit-equal {same}; "
                    f"greedy and beam-{BEAM} B={B_SERVE} transcripts equal "
                    f"the direct model's")
        torch.cuda.synchronize()
        counts = cuda.launch_counts()
        for k in ("conv1_pool", "lstm_fwd", "greedy_loop", "beam_loop"):
            check(counts[k] > 0, f"kernel {k} never launched on the import "
                                 "path")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return counts, readings


# ------------------------------------------------------------ phase 8

# the world-size-2 tail step: 300 real rows of 400 (rank 0 holds 200,
# rank 1 100); the DP eval: 500 real rows padded to 512
DP_TAIL_REAL, DP_EVAL_REAL = 300, 500
DP_STEPS = 3  # full steps before the masked tail


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_counts():
    from aocr_torch.ops import cuda
    from aocr_torch.ops.cuda import lstm_fwd

    import torch

    torch.cuda.synchronize()
    counts = cuda.launch_counts()
    counts["lstm_fwd_collect"] = lstm_fwd.launches_collect
    return counts


DP_STEP_KERNELS = ("conv1_pool", "conv1_pool_bwd", "lstm_fwd_collect",
                   "lstm_bwd", "tf_fwd", "tf_bwd", "pool_bwd")
DP_EVAL_KERNELS = ("conv1_pool", "lstm_fwd", "tf_fwd", "beam_loop")


def step_ms(step, args, n: int = 5):
    """Host-clock ms of n calls of step(*args) (each synchronized), after
    one warm-up: the list."""
    import torch

    step(*args)
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        step(*args)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def dp_world1_phase(dev, seed: int, card: str):
    """make_dp_train_step at world size 1 over NCCL (a group this phase
    creates and destroys): 5 steps at B=400, T=11, bf16 and float32, each
    held to make_train_step on the same batch from the same state
    (float32 params 1e-4 abs, loss 1e-5 rel; bf16 reported); the two
    5-step trajectories run apart, and two one-card trajectories, are
    reported (float32 steps on the card are not bitwise repeatable, and
    the training problem amplifies a difference from step to step); and
    both steps' host-clock ms (median of 2x5, in turns): what the
    collectives cost on one card.  Returns (launch counts of the DP
    steps, {dtype: (dp ms, one-card ms)})."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from aocr_torch import augment, train_step, weights
    from aocr_torch.ops import cuda
    from aocr_torch.parallel import data_parallel

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        inputs = dp_step_inputs(seed)
        schedule = dp_schedule(inputs, TRAIN_STEPS, False)
        cuda.reset_launch_counts()
        records, finals = {}, {}
        for dt in ("bfloat16", "float32"):
            cfg = train_config(dt)
            records[dt] = []
            finals[dt] = dp_run_steps(
                cfg, data_parallel.make_dp_train_step(cfg), inputs, schedule,
                dev, record=records[dt])
        counts = dp_counts()
        log(f"dp step world size 1 ({dist.get_backend()}) launch counts: "
            f"{counts}")
        for k in DP_STEP_KERNELS:
            check(counts[k] > 0, f"kernel {k} never launched on the DP step "
                                 "at world size 1")
        ms = {}
        for dt in records:
            cfg = train_config(dt)
            loss, perr, _ok = one_process_errors(cfg, inputs, schedule, dev,
                                                 records[dt])
            records[dt] = None  # the recorded states' memory
            one = [dp_run_steps(cfg, train_step.make_train_step(cfg), inputs,
                                schedule, dev) for _ in (0, 1)]
            apart = max_abs_diff(finals[dt][1], one[0][1])
            again = max_abs_diff(one[0][1], one[1][1])
            log(f"dp step world size 1 {dt}, each of {TRAIN_STEPS} steps vs "
                f"make_train_step from the same state: loss_sum rel err "
                f"{loss:.3g}, params max abs err {perr:.3g}"
                + (" (tol 1e-5, 1e-4)" if dt == "float32" else
                   " (reported)")
                + f"; the {TRAIN_STEPS}-step trajectories run apart differ "
                f"by {apart:.3g}, two one-card runs by {again:.3g}")
            if dt == "float32":
                check(loss <= 1e-5 and perr <= 1e-4, "dp step world size 1: "
                      "float32 disagrees with make_train_step")
            params, stats = weights.from_numpy(*inputs[0], dev)
            opt = train_step.init_opt_state(params, cfg)
            images, _w, t, te = inputs[1]
            images = torch.from_numpy(images).to(dev)
            t, te = torch.from_numpy(t).to(dev), torch.from_numpy(te).to(dev)
            args = (params, stats, opt, images, t, te, cfg.learning_rate,
                    augment.step_key(cfg.seed, 0))
            single = train_step.make_train_step(cfg)
            dstep = data_parallel.make_dp_train_step(cfg)
            a1 = step_ms(single, args)
            d1 = step_ms(dstep, args)
            d2 = step_ms(dstep, args)
            a2 = step_ms(single, args)
            ms[dt] = (float(np.median(d1 + d2)), float(np.median(a1 + a2)))
            log(f"dp step world size 1 {dt} B={B_TRAIN}: "
                f"{ms[dt][0]:.2f} ms against make_train_step's "
                f"{ms[dt][1]:.2f} ms (host clock, median of 2x5 in turns) "
                f"on {card}")
    finally:
        dist.destroy_process_group()
    return counts, ms


def gloo_cuda_probe(dev) -> dict:
    """Which collectives a gloo group runs on CUDA tensors: {name: "ok" or
    the error's first line}."""
    import torch
    import torch.distributed as dist

    out = {}
    n = dist.get_world_size()
    for name, fn in (
            ("all_reduce sum", lambda t: dist.all_reduce(t)),
            ("all_reduce min", lambda t: dist.all_reduce(
                t, op=dist.ReduceOp.MIN)),
            ("all_gather", lambda t: dist.all_gather(
                [torch.empty_like(t) for _ in range(n)], t)),
            ("broadcast", lambda t: dist.broadcast(t, 0))):
        try:
            fn(torch.ones(4, device=dev))
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:  # the probe's result, reported
            out[name] = str(e).splitlines()[0][:200]
    return out


def dp_step_inputs(seed: int):
    """The DP phases' weights and batches: (np weights, the B=400 batch,
    the tail's targets and mask)."""
    import numpy as np

    from aocr_torch import vocab

    np_model = numpy_model(base_config(), seed)
    batch = train_batch(np.random.RandomState(seed + 2), B_TRAIN)
    tail_t, tail_te = batch[2].copy(), batch[3].copy()
    tail_t[DP_TAIL_REAL:] = vocab.PAD
    tail_te[DP_TAIL_REAL:] = vocab.PAD
    mask = (np.arange(B_TRAIN) < DP_TAIL_REAL).astype(np.float32)
    return np_model, batch, tail_t, tail_te, mask


def dp_eval_inputs(seed: int):
    """500 crops and their 10-letter words, targets padded to T_MAX, the
    batch padded to 512 rows: (images, targets, targets_eval, mask)."""
    import numpy as np

    from aocr_torch import vocab
    from aocr_torch.parallel import eval_parallel

    images, words, _t, _te = train_batch(np.random.RandomState(seed + 13),
                                         DP_EVAL_REAL)
    t, te, _ = vocab.encode_batch(words, pad_to=T_MAX)
    real, im, t, te = eval_parallel.pad_rows(2, images, t, te,
                                             total_rows=B_SERVE)
    return im, t, te, (np.arange(B_SERVE) < real).astype(np.float32)


def dp_schedule(inputs, n_full: int, tail: bool):
    """The steps' (targets, targets_eval, row mask or None): n_full full
    steps on the B=400 batch, then, with tail, the masked tail step."""
    _np_model, batch, tail_t, tail_te, mask = inputs
    return ([(batch[2], batch[3], None)] * n_full
            + ([(tail_t, tail_te, mask)] if tail else []))


def dp_run_steps(cfg, step, inputs, schedule, dev, loc=None, record=None):
    """The schedule's steps from the numpy weights, each batch array passed
    through loc (this rank's rows; None: one process on the whole batch,
    a masked step then told its real row count); with a record list, each
    step's (state before it, output) is appended.  Returns (losses, numpy
    params, numpy stats)."""
    import torch

    from aocr_torch import augment, train_step, weights

    np_model, batch = inputs[0], inputs[1]
    params, stats = weights.from_numpy(*np_model, dev)
    opt = train_step.init_opt_state(params, cfg)
    whole = loc is None
    loc = loc or (lambda a: a)
    images = torch.from_numpy(loc(batch[0])).to(dev)
    losses = []
    for i, (t, te, mask) in enumerate(schedule):
        extra = {} if mask is None else {
            "row_mask": torch.from_numpy(loc(mask)).to(dev)}
        if whole and mask is not None:
            extra["real_bs"] = float(mask.sum())
        out = step(params, stats, opt, images,
                   torch.from_numpy(loc(t)).to(dev),
                   torch.from_numpy(loc(te)).to(dev), cfg.learning_rate,
                   augment.step_key(cfg.seed, i), **extra)
        if record is not None:
            record.append(((params, stats, opt), out))
        params, stats, opt = out.params, out.batch_stats, out.opt_state
        losses.append(float(out.loss_sum))
    p, s = weights.to_numpy(params, stats)
    return losses, p, s


def one_process_errors(cfg, inputs, schedule, dev, record):
    """Each recorded step against make_train_step on the whole batch from
    the same state: (max loss_sum rel err, max |param or BN statistic
    difference|, every one within rtol 1e-3 atol 2e-4)."""
    import torch

    from aocr_torch import augment, train_step
    from aocr_torch.optim import leaves

    step = train_step.make_train_step(cfg)
    images = torch.from_numpy(inputs[1][0]).to(dev)
    loss_err, perr, ok = 0.0, 0.0, True
    for i, (((p, s, o), got), (t, te, mask)) in enumerate(zip(record,
                                                              schedule)):
        extra = {} if mask is None else {
            "row_mask": torch.from_numpy(mask).to(dev),
            "real_bs": float(mask.sum())}
        want = step(p, s, o, images, torch.from_numpy(t).to(dev),
                    torch.from_numpy(te).to(dev), cfg.learning_rate,
                    augment.step_key(cfg.seed, i), **extra)
        loss_err = max(loss_err, rel_err(got.loss_sum, want.loss_sum))
        for a, b in zip(leaves(got.params) + leaves(got.batch_stats),
                        leaves(want.params) + leaves(want.batch_stats)):
            d = (a - b).abs()
            perr = max(perr, float(d.max()))
            ok = ok and bool((d <= 2e-4 + 1e-3 * b.abs()).all())
    return loss_err, perr, ok


# the DP trainer's run: one float32 epoch (2 full steps and a 200-row
# tail), a checkpoint and a one-batch validation every 2 steps
DP_TRAIN_ARGS = ("-phase", "train", "-num_epochs", "1",
                 "-steps_per_checkpoint", "2", "-num_batches_val", "1")


def dp_rank(rank: int, world: int, root: str, seed: int,
            device: str) -> None:
    """One rank of the world-size-2 phases on `device`, in a gloo group over
    a file store under root (NCCL refuses two ranks on one device): the
    gloo probe, the DP step (float32 and bf16; rank 0 then holds each
    step to make_train_step on the whole batch from the same state), the
    DP eval (float32 beam-5) and the CLI trainer at -num_shards 2.
    Writes its results to root/rank<r>.pkl, or its traceback to
    root/rank<r>.err."""
    try:
        sys.path.insert(0, ROOT)
        import torch
        import torch.distributed as dist

        from aocr_torch import train, train_step, weights
        from aocr_torch.ops import cuda
        from aocr_torch.parallel import data_parallel, eval_parallel, mesh

        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group("gloo", init_method=f"file://{root}/store",
                                rank=rank, world_size=world)
        out = {"probe": gloo_cuda_probe(dev)}
        inputs = dp_step_inputs(seed)
        schedule = dp_schedule(inputs, DP_STEPS, True)
        records = {}
        cuda.reset_launch_counts()
        for dt in ("float32", "bfloat16"):
            cfg = train_config(dt)
            records[dt] = [] if rank == 0 else None
            out[dt] = dp_run_steps(cfg, data_parallel.make_dp_train_step(cfg),
                                   inputs, schedule, dev, mesh.local_rows,
                                   records[dt])
        out["step_counts"] = dp_counts()
        # the step's host-clock ms in this rank, bf16, full batch (both
        # ranks share the card; gloo all-reduces through the host)
        cfg = train_config("bfloat16")
        params, stats = weights.from_numpy(*inputs[0], dev)
        b = inputs[1]
        out["step_ms"] = step_ms(data_parallel.make_dp_train_step(cfg), (
            params, stats, train_step.init_opt_state(params, cfg),
            torch.from_numpy(mesh.local_rows(b[0])).to(dev),
            torch.from_numpy(mesh.local_rows(b[2])).to(dev),
            torch.from_numpy(mesh.local_rows(b[3])).to(dev),
            cfg.learning_rate, None))
        if rank == 0:
            out["errors"] = {dt: one_process_errors(
                train_config(dt), inputs, schedule, dev, rec)
                for dt, rec in records.items()}
        del records
        im, t, te, mask = (mesh.local_rows(a) for a in dp_eval_inputs(seed))
        cfg = base_config().replace(beam_size=BEAM)
        params, stats = weights.from_numpy(*inputs[0], dev)
        step = eval_parallel.make_dp_eval_step(cfg)
        cuda.reset_launch_counts()
        ev = step(params, stats, torch.from_numpy(im).to(dev), t, te, None,
                  torch.from_numpy(mask))
        out["eval_counts"] = dp_counts()
        out["eval"] = {k: v.cpu().numpy() for k, v in ev._asdict().items()}
        cuda.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            train.main(trainer_argv(root, f"dp_rank{rank}", seed,
                                    *DP_TRAIN_ARGS, "-num_shards",
                                    str(world)), device=dev)
        out["trainer_s"] = time.perf_counter() - t0
        out["trainer_counts"] = dp_counts()
        dist.barrier()
        with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.destroy_process_group()
    except Exception:
        with open(os.path.join(root, f"rank{rank}.err"), "w") as f:
            f.write(f"rank {rank}:\n{traceback.format_exc()}")
        os._exit(1)


def run_spawned(target, world: int, args, root: str, timeout: float,
                what: str):
    """`world` processes (torch.multiprocessing, spawn) running
    target(rank, *args), joined within timeout and killed past it: the
    ranks' pickled results from root/rank<r>.pkl, or None after a failed
    check with the ranks' tracebacks."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, *args))
             for r in range(world)]
    t0 = time.perf_counter()
    for p_ in procs:
        p_.start()
    deadline = time.monotonic() + timeout
    while any(p_.is_alive() for p_ in procs):
        if (any(p_.exitcode not in (None, 0) for p_ in procs)
                or time.monotonic() > deadline):
            break
        time.sleep(0.2)
    for p_ in procs:
        if p_.is_alive():
            p_.kill()
        p_.join(30)
    errs_ = [open(os.path.join(root, f)).read()
             for f in sorted(os.listdir(root)) if f.endswith(".err")]
    codes = [p_.exitcode for p_ in procs]
    log(f"{what}: ranks exited {codes} after "
        f"{time.perf_counter() - t0:.1f} s")
    check(not errs_ and codes == [0] * world,
          f"{what} failed: " + "\n".join(errs_)[-3000:])
    if errs_ or codes != [0] * world:
        return None
    ranks = []
    for r in range(world):
        with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


def dp_world2_phase(dev, seed: int, card: str):
    """World size 2 on one card: two processes (torch.multiprocessing,
    spawn) over a gloo group, the kernels built once by this process
    before the spawn.  Against this process's one-process runs: the DP
    step (3 full steps and a masked tail with 200 and 100 real rows;
    float32 params rtol 1e-3 atol 2e-4 and loss rtol 1e-5, bf16 reported;
    params bit-equal across the ranks), the DP eval (beam-5, 500 rows
    padded to 512: labels, accuracy and cer_sum exact, float32 nll 1e-5
    rel) and the CLI trainer at -num_shards 2 against -num_shards 1 (step
    perplexities within perplexity_rel_err 1e-5, float32; only rank 0
    writes the log and checkpoints).  Returns {path: [rank 0 counts, rank
    1 counts]}."""
    import numpy as np
    import torch

    from aocr_torch import eval as eval_lib
    from aocr_torch import train_step, weights

    root = tempfile.mkdtemp(prefix="aocr_dp_")
    try:
        write_dataset(root, seed)
        ranks = run_spawned(dp_rank, 2, (2, root, seed, str(dev)), root,
                            600, "dp world size 2")
        if ranks is None:
            return {}
        log(f"gloo collectives on CUDA tensors: {ranks[0]['probe']}")
        for r, r_ in enumerate(ranks):
            log(f"dp step world size 2 bf16 B={B_TRAIN // 2} a rank, rank "
                f"{r}: {np.median(r_['step_ms']):.2f} ms (host clock, median "
                f"of 5; both ranks on one card, gloo) on {card}")
        # (b) the DP step: each step against one process on the whole
        # batch from the same state (rank 0 measured it), the runs apart
        # reported
        inputs = dp_step_inputs(seed)
        schedule = dp_schedule(inputs, DP_STEPS, True)
        for dt in ("float32", "bfloat16"):
            cfg = train_config(dt)
            want = dp_run_steps(cfg, train_step.make_train_step(cfg), inputs,
                                schedule, dev)
            (l0, p0, s0), (l1, p1, s1) = ranks[0][dt], ranks[1][dt]
            same = all(np.array_equal(a, b) for a, b in zip(
                _np_leaves(p0) + _np_leaves(s0),
                _np_leaves(p1) + _np_leaves(s1))) and l0 == l1
            loss, perr, ok = ranks[0]["errors"][dt]
            apart = max_abs_diff(p0, want[1])
            r0 = min(B_TRAIN // 2, DP_TAIL_REAL)
            log(f"dp step world size 2 {dt} (gloo, one card), {DP_STEPS} "
                f"full steps + a tail of {r0} and {DP_TAIL_REAL - r0} real "
                f"rows, each step vs one process at B={B_TRAIN} from the "
                f"same state: loss rel err {loss:.3g}, params and BN "
                f"statistics max abs err {perr:.3g}, within rtol 1e-3 atol "
                f"2e-4: {ok}; ranks bit-equal: {same}"
                + ("" if dt == "float32" else " (reported)")
                + f"; run apart: losses {[round(x, 3) for x in l0]} vs "
                f"{[round(x, 3) for x in want[0]]}, params differ by "
                f"{apart:.3g}")
            check(same, f"dp step world size 2 {dt}: ranks differ")
            if dt == "float32":
                check(loss <= 1e-5 and ok, "dp step world size 2 float32: "
                      "disagrees with one process")
        # (c) the DP eval against one process on the 500 real rows
        im, t, te, mask = dp_eval_inputs(seed)
        cfg = base_config().replace(beam_size=BEAM)
        params, stats = weights.from_numpy(*inputs[0], dev)
        (labels, _sc, _rf), nll, _gold = train_step.eval_decode_step(
            params, stats, im[:DP_EVAL_REAL], t[:DP_EVAL_REAL],
            te[:DP_EVAL_REAL], cfg, beam_size=BEAM, max_len=T_MAX,
            return_refills=True)
        gold = torch.from_numpy(te[:DP_EVAL_REAL]).to(dev)
        acc = int(eval_lib.exact_match(labels, gold).sum())
        cer = float(eval_lib.char_error_rate(labels, gold).double().sum()
                    .float())
        ev0, ev1 = ranks[0]["eval"], ranks[1]["eval"]
        lab_ok = np.array_equal(ev0["labels"][:DP_EVAL_REAL],
                                labels.cpu().numpy())
        nll_err = abs(float(ev0["nll"]) - float(nll)) / abs(float(nll))
        same = all(np.array_equal(ev0[k], ev1[k]) for k in ev0)
        log(f"dp eval world size 2, beam-{BEAM} float32, {DP_EVAL_REAL} rows "
            f"padded to {B_SERVE}: labels equal {lab_ok}, accuracy "
            f"{int(ev0['accuracy'])} vs {acc}, cer_sum "
            f"{float(ev0['cer_sum']):.6f} vs {cer:.6f}, nll rel err "
            f"{nll_err:.3g}; ranks equal {same}")
        check(lab_ok and int(ev0["accuracy"]) == acc
              and float(ev0["cer_sum"]) == cer and nll_err <= 1e-5 and same,
              "dp eval world size 2 disagrees with one process")
        # (d) the CLI trainer, -num_shards 2 against -num_shards 1
        msgs, _c, secs = run_trainer(root, "one", seed, *DP_TRAIN_ARGS)
        with open(os.path.join(root, "dp_rank0.log")) as f:
            dmsgs = [line.split(" ", 2)[2] for line in f.read().splitlines()]
        a, b = step_perplexities(dmsgs), step_perplexities(msgs)
        perr = perplexity_rel_err(a, b)
        files0 = sorted(os.listdir(os.path.join(root, "dp_rank0")))
        files1 = [f for f in os.listdir(root) if f.startswith("dp_rank1")]
        log(f"dp trainer -num_shards 2 (gloo, one card), float32 one epoch: "
            f"step perplexities {[round(x, 4) for x in a]} vs -num_shards "
            f"1's {[round(x, 4) for x in b]}: rel err {perr:.3g} (tol 1e-5); "
            f"{ranks[0]['trainer_s']:.1f} s against {secs:.1f} s; rank 0 "
            f"wrote {files0}, rank 1 {files1}")
        check(len(a) == 3 and perr <= 1e-5, "dp trainer: step perplexities "
              "differ from -num_shards 1")
        check(files1 == [] and {"model-2", "model-3", "final-model"}
              <= set(files0) and bool(dmsgs),
              "dp trainer: only rank 0 may write the log and checkpoints")
        out = {}
        for key, kernels in (("step_counts", DP_STEP_KERNELS),
                             ("eval_counts", DP_EVAL_KERNELS),
                             ("trainer_counts", DP_STEP_KERNELS)):
            out[key] = [r_[key] for r_ in ranks]
            for r, c in enumerate(out[key]):
                for k in kernels:
                    check(c[k] > 0, f"kernel {k} never launched in rank {r} "
                                    f"on the dp path {key}")
            log(f"dp world size 2 {key}: rank 0 {out[key][0]}, rank 1 "
                f"{out[key][1]}")
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def max_abs_diff(a, b) -> float:
    """max |a - b| over two numpy trees of one structure (nan if any
    leaf is)."""
    import numpy as np

    return float(np.max([np.abs(x - y).max() for x, y in
                         zip(_np_leaves(a), _np_leaves(b))]))


def _np_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _np_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _np_leaves(v)]
    return [tree]


# ------------------------------------------------------------ phase 4k

# the training options' steps: 3 from one --seed state, each option's
# step also held to its counterpart from the same state
OPT_STEPS = 3
OPT_DROPOUT = 0.3
# the train step's gates (train_end_to_end): loss rel, norms rel, params
TRAIN_TOLS = (1e-5, 1e-4, 1e-4)


def held_steps(cfg, other, np_model, batch, dev, n: int, record=None):
    """n steps of cfg from the numpy weights; each step's state also
    stepped by `other` (a config) under the same key: (the outputs of
    cfg, the outputs of other, each a list)."""
    import torch

    from aocr_torch import augment, train_step, weights

    params, stats = weights.from_numpy(*np_model, dev)
    opt = train_step.init_opt_state(params, cfg)
    step, ostep = (train_step.make_train_step(c) for c in (cfg, other))
    images, _w, targets, targets_eval = batch
    images = torch.from_numpy(images).to(dev)
    targets = torch.from_numpy(targets).to(dev)
    targets_eval = torch.from_numpy(targets_eval).to(dev)
    outs, others = [], []
    for i in range(n):
        args = (params, stats, opt, images, targets, targets_eval,
                cfg.learning_rate, augment.step_key(cfg.seed, i))
        out = step(*args)
        others.append(ostep(*args))
        outs.append(out)
        params, stats, opt = out.params, out.batch_stats, out.opt_state
    return outs, others


def worst(pairs):
    """The largest step_agreement terms over (got, want) pairs."""
    errs_ = [step_agreement(a, b) for a, b in pairs]
    return tuple(max(e[i] for e in errs_) for i in range(3))


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms (float32 steps on the card are
    otherwise not bitwise repeatable)."""
    import torch

    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = was


def peak_mib(cfg, np_model, batch, dev) -> float:
    """torch.cuda.max_memory_allocated of one train step (MiB), counted
    from the memory the step's inputs already hold."""
    import torch

    from aocr_torch import augment, train_step, weights

    params, stats = weights.from_numpy(*np_model, dev)
    opt = train_step.init_opt_state(params, cfg)
    images, _w, targets, targets_eval = (
        torch.from_numpy(a).to(dev) if not isinstance(a, list) else a
        for a in batch)
    step = train_step.make_train_step(cfg)
    args = (params, stats, opt, images, targets, targets_eval,
            cfg.learning_rate, augment.step_key(cfg.seed, 0))
    step(*args)  # warm-up: workspaces and caches
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = step(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak / 2 ** 20


def options_phase(dev, tcfg, np_model, batch, card: str):
    """The training options at B=400, T=11 from the --seed weights, bf16
    and float32, OPT_STEPS steps each:
    - dropout 0.3: each (step, site) keep rate of the port's draws within
      0.7 +- 0.005; bf16 params bit-equal for the same key twice, not for
      another key; remat + dropout against dropout alone, float32, each
      step from the same state (params 1e-6 abs, deterministic cuDNN);
    - remat against no remat, float32, each step from the same state
      (the train step's gates); the bf16 step's peak memory with and
      without remat at B=400 and B=1600;
    - the simple attention, float32: the kernel route held to the plain
      route (use_pallas=False) with the train step's gates;
    - -fused_encoder_proj: the float32 step against the unfused step
      (the train step's gates), bf16 greedy and beam-5 transcripts at
      B=512 equal to the unfused model's, the bf16 step's ms fused and
      unfused;
    - each option's bf16 step ms beside the default step's (host clock,
      median of 5).
    The teacher-forced kernels must launch only on the fused-projection
    step; the CNN and encoder kernels on every option's.  Returns (the
    launch counts of the option steps, in all and by option)."""
    import numpy as np
    import torch

    from aocr_torch import augment, train_step, weights
    from aocr_torch.api import AttentionOCR
    from aocr_torch.ops import cuda, dropout
    from aocr_torch.optim import leaves

    f32 = tcfg.replace(compute_dtype="float32")
    options = {"dropout": dict(dropout=OPT_DROPOUT), "remat": dict(remat=True),
               "simple": dict(simple_attention=True),
               "fused": dict(fused_encoder_proj=True)}
    counts, total = {}, {k: 0 for k in cuda.KERNELS + ("lstm_fwd_collect",)}
    outs = {}
    for name, kw in options.items():
        cuda.reset_launch_counts()
        for dt, base in (("bf16", tcfg), ("f32", f32)):
            outs[(name, dt)] = run_steps(base.replace(**kw), *np_model, batch,
                                         dev, OPT_STEPS)
        counts[name] = dp_counts()
        add_counts(total, counts[name])
        tf = counts[name]["tf_fwd"] + counts[name]["tf_bwd"]
        for k in ("conv1_pool", "conv1_pool_bwd", "lstm_fwd_collect",
                  "lstm_bwd", "pool_bwd"):
            check(counts[name][k] > 0, f"kernel {k} never launched on the "
                                       f"{name} train step")
        check(tf > 0 if name == "fused" else tf == 0,
              f"{name} train step: the teacher-forced kernels launched "
              f"{tf} times")
        log(f"options {name} launch counts ({OPT_STEPS} steps bf16 + "
            f"float32): {counts[name]}")
        for dt in ("bf16", "f32"):
            losses = [float(o.loss_sum) for o in outs[(name, dt)]]
            check(all(math.isfinite(x) for x in losses),
                  f"options {name} {dt}: loss {losses}")
    readings = {}
    # dropout: the draws' keep rate, repeatability and keys
    rows = torch.arange(B_TRAIN, device=dev)
    keep = dropout.masks(augment.step_key(tcfg.seed, 0), rows, WORD_LEN + 1,
                         tcfg.decoder_num_layers, tcfg.decoder_num_hidden,
                         OPT_DROPOUT).float().mean((2, 3))
    lo, hi = float(keep.min()), float(keep.max())
    check(abs(lo - 0.7) <= 0.005 and abs(hi - 0.7) <= 0.005,
          f"dropout keep rate per (step, site) in [{lo}, {hi}]")
    dcfg = tcfg.replace(dropout=OPT_DROPOUT)
    again = run_steps(dcfg, *np_model, batch, dev, 1)[0]
    first = outs[("dropout", "bf16")][0]
    same = all(torch.equal(a, b) for a, b in zip(leaves(again.params),
                                                 leaves(first.params)))
    other = run_steps(dcfg.replace(seed=tcfg.seed + 1), *np_model, batch,
                      dev, 1)[0]
    moved = max(float((a - b).abs().max()) for a, b in zip(
        leaves(other.params), leaves(first.params)))
    check(same, "dropout bf16: the same key gave other params")
    check(moved > 0, "dropout bf16: another key gave the same params")
    with deterministic_cudnn():
        d32, r32 = held_steps(f32.replace(dropout=OPT_DROPOUT),
                              f32.replace(dropout=OPT_DROPOUT, remat=True),
                              np_model, batch, dev, OPT_STEPS)
        _l, _n, rd_err = worst(zip(r32, d32))
        m32, n32 = held_steps(f32, f32.replace(remat=True), np_model, batch,
                              dev, OPT_STEPS)
        rl, rn, rp = worst(zip(n32, m32))
    check(rd_err <= 1e-6, f"remat + dropout vs dropout, float32: params "
                          f"differ by {rd_err}")
    check(rl <= TRAIN_TOLS[0] and rp <= 1e-4,
          f"remat vs no remat, float32: loss rel {rl}, params {rp}")
    log(f"options dropout {OPT_DROPOUT} B={B_TRAIN}: keep rate per (step, "
        f"site) {lo:.5f}..{hi:.5f} over {B_TRAIN}x"
        f"{tcfg.decoder_num_hidden} draws each (band 0.7 +- 0.005); bf16 "
        f"params for one key twice bit-equal {same}, another key moves "
        f"them by {moved:.3g}; float32 remat + dropout vs dropout, each of "
        f"{OPT_STEPS} steps from the same state: params max abs err "
        f"{rd_err:.3g} (tol 1e-6)")
    log(f"options remat float32, each of {OPT_STEPS} steps vs no remat from "
        f"the same state: loss rel err {rl:.3g}, grad norm rel err "
        f"{rn:.3g}, params max abs err {rp:.3g} (tol 1e-5, -, 1e-4)")
    # simple attention: the kernel route against the plain route
    scfg = f32.replace(simple_attention=True)
    sk, sp = held_steps(scfg, scfg.replace(use_pallas=False), np_model,
                        batch, dev, 1)
    sl, sn, spar = worst(zip(sk, sp))
    check(sl <= TRAIN_TOLS[0] and sn <= TRAIN_TOLS[1]
          and spar <= TRAIN_TOLS[2],
          f"simple attention float32: kernels vs plain route: {sl}, {sn}, "
          f"{spar}")
    log(f"options simple attention float32 step, kernel route vs plain "
        f"route on the card: loss rel err {sl:.3g}, grad norm rel err "
        f"{sn:.3g}, params max abs err {spar:.3g} (tol {TRAIN_TOLS})")
    # fused projection: the float32 step against the unfused step
    fk, fu = held_steps(f32.replace(fused_encoder_proj=True), f32, np_model,
                        batch, dev, 1)
    fl, fn, fpar = worst(zip(fk, fu))
    check(fl <= TRAIN_TOLS[0] and fn <= TRAIN_TOLS[1]
          and fpar <= TRAIN_TOLS[2],
          f"fused projection float32 step vs unfused: {fl}, {fn}, {fpar}")
    log(f"options -fused_encoder_proj float32 step vs unfused: loss rel err "
        f"{fl:.3g}, grad norm rel err {fn:.3g}, params max abs err "
        f"{fpar:.3g} (tol {TRAIN_TOLS})")
    # ... its bf16 transcripts at B=512, greedy and beam-5
    rs = np.random.RandomState(tcfg.seed + 17)
    crops = word_images(rs, B_SERVE, W_SERVE)
    cuda.reset_launch_counts()
    texts = {}
    for fused in (False, True):
        cfg = base_config().replace(compute_dtype="bfloat16",
                                    fused_encoder_proj=fused)
        ocr = AttentionOCR(cfg, *weights.from_numpy(*np_model), device=dev)
        for beam in (1, BEAM):
            texts[(fused, beam)] = ocr.recognize(list(crops),
                                                 beam_size=beam)[0]
    counts["fused recognize"] = dp_counts()
    add_counts(total, counts["fused recognize"])
    for beam in (1, BEAM):
        a, b = texts[(True, beam)], texts[(False, beam)]
        same_rows = sum(x == y for x, y in zip(a, b))
        check(same_rows == len(b), f"fused projection bf16 beam-{beam}: "
                                   f"{len(b) - same_rows} transcripts differ")
        log(f"options -fused_encoder_proj bf16 recognize B={B_SERVE} "
            f"beam-{beam}: {same_rows} of {len(b)} transcripts equal the "
            f"unfused model's")
    # peak memory with and without remat, bf16
    for B in (B_TRAIN, 4 * B_TRAIN):
        big = tuple(np.concatenate([a] * (B // B_TRAIN)) if not
                    isinstance(a, list) else a * (B // B_TRAIN)
                    for a in batch)
        for name, cfg in (("default", tcfg), ("per-step", tcfg.replace(
                decoder_custom_vjp=False)), ("remat", tcfg.replace(
                    remat=True))):
            readings[("peak", name, B)] = peak_mib(cfg.replace(batch_size=B),
                                                   np_model, big, dev)
        log(f"options remat bf16 B={B}: the step's peak memory above its "
            f"inputs (torch.cuda.max_memory_allocated) default route "
            f"{readings[('peak', 'default', B)]:.0f} MiB, per-step decoder "
            f"without remat {readings[('peak', 'per-step', B)]:.0f} MiB, "
            f"with remat {readings[('peak', 'remat', B)]:.0f} MiB on {card}")
    # each option's bf16 step ms beside the default's, and the fused
    # projection's A/B in turns
    params, stats = weights.from_numpy(*np_model, dev)
    images, _w, t, te = (torch.from_numpy(a).to(dev)
                         if not isinstance(a, list) else a for a in batch)

    def ms_of(cfg):
        return step_ms(train_step.make_train_step(cfg), (
            params, stats, train_step.init_opt_state(params, cfg), images,
            t, te, cfg.learning_rate, augment.step_key(cfg.seed, 0)))

    order = [("default", {}), *options.items()]
    runs_ = {n: [] for n, _ in order}
    for n, kw in order + order[::-1]:
        runs_[n] += ms_of(tcfg.replace(**kw))
    for n in runs_:
        readings[("ms", n)] = float(np.median(runs_[n]))
    log(f"options bf16 train step B={B_TRAIN}: " + ", ".join(
        f"{n} {readings[('ms', n)]:.2f} ms" for n in runs_)
        + f" (host clock, median of 2x5, the options in turns, then in the "
        f"reverse order) on {card}")
    turns = {True: [], False: []}
    for fused in (True, False, False, True):
        turns[fused].append(float(np.median(ms_of(
            tcfg.replace(fused_encoder_proj=fused)))))
    log(f"options -fused_encoder_proj A/B, bf16 train step B={B_TRAIN}: "
        f"fused {turns[True]} ms, unfused {turns[False]} ms (host clock, "
        f"median of 5 a turn, turns fused/unfused/unfused/fused) on {card}")
    return total, counts

# ------------------------------------------------------------ phase 4l

# the tensor-parallel grids on the one card: (data, model) and processes
TP_GRIDS = ((1, 2), (2, 2))
TP_STEP_KERNELS = ("conv1_pool", "conv1_pool_bwd", "lstm_fwd_collect",
                   "lstm_bwd", "pool_bwd")


def tp_run_steps(cfg, grid, inputs, schedule, dev, record=None):
    """The schedule's make_tp_train_step steps at this rank's place on the
    grid from the numpy weights (its shards; its data shard's rows).  With
    a record list, each step's (whole state before it, the output with
    the params gathered) is appended (every rank takes part in the
    gathers).  Returns (losses, grad norms, gathered numpy params and
    stats, this rank's final shards as numpy leaves)."""
    import torch

    from aocr_torch import augment, train, train_step, weights
    from aocr_torch.optim import leaves
    from aocr_torch.parallel import mesh, tensor_parallel as tpl

    np_model, batch = inputs[0], inputs[1]
    whole, stats = weights.from_numpy(*np_model, dev)
    params = tpl.shard_params(whole, grid)
    del whole
    opt = train_step.init_opt_state(params, cfg)
    step = tpl.make_tp_train_step(cfg, grid)
    loc = lambda a: mesh.local_rows(a, grid.data_group)  # noqa: E731
    images = torch.from_numpy(loc(batch[0])).to(dev)
    gather = lambda tree: tpl.gather_params(tree, grid)  # noqa: E731
    losses, norms = [], []
    for i, (t, te, mask) in enumerate(schedule):
        extra = {} if mask is None else {
            "row_mask": torch.from_numpy(loc(mask)).to(dev)}
        before = None if record is None else (
            gather(params), stats, train._map_opt_state(opt, gather))
        out = step(params, stats, opt, images,
                   torch.from_numpy(loc(t)).to(dev),
                   torch.from_numpy(loc(te)).to(dev), cfg.learning_rate,
                   augment.step_key(cfg.seed, i), **extra)
        if record is not None:
            record.append((before, out._replace(params=gather(out.params))))
        params, stats, opt = out.params, out.batch_stats, out.opt_state
        losses.append(float(out.loss_sum))
        norms.append({k: float(v) for k, v in out.grad_norms.items()})
    p, s = weights.to_numpy(gather(params), stats)
    local = [x.detach().cpu().numpy() for x in leaves(params)]
    return losses, norms, p, s, local


def tp_one_process_errors(cfg, inputs, schedule, dev, record):
    """Each recorded TP step against make_train_step on the whole batch
    from the same state: (max loss_sum rel err, {group: max grad-norm rel
    err}, max |param difference|, every param within rtol 1e-3 atol
    3e-4)."""
    import torch

    from aocr_torch import augment, train_step
    from aocr_torch.optim import leaves

    step = train_step.make_train_step(cfg)
    images = torch.from_numpy(inputs[1][0]).to(dev)
    loss_err = perr = 0.0
    norm_err = {}
    ok = True
    for i, (((p, s, o), got), (t, te, mask)) in enumerate(zip(record,
                                                              schedule)):
        extra = {} if mask is None else {
            "row_mask": torch.from_numpy(mask).to(dev),
            "real_bs": float(mask.sum())}
        want = step(p, s, o, images, torch.from_numpy(t).to(dev),
                    torch.from_numpy(te).to(dev), cfg.learning_rate,
                    augment.step_key(cfg.seed, i), **extra)
        loss_err = max(loss_err, rel_err(got.loss_sum, want.loss_sum))
        for k in want.grad_norms:
            norm_err[k] = max(norm_err.get(k, 0.0), rel_err(
                got.grad_norms[k], want.grad_norms[k]))
        for a, b in zip(leaves(got.params), leaves(want.params)):
            d = (a - b).abs()
            perr = max(perr, float(d.max()))
            ok = ok and bool((d <= 3e-4 + 1e-3 * b.abs()).all())
    return loss_err, norm_err, perr, ok


def tp_dp_errors(cfg, grid, inputs, schedule, dev, record):
    """Each recorded TP step against make_dp_train_step over the grid's
    data group from the same state (the whole params on every rank: the
    same rows a rank and the same sync-BN, no model axis); every rank
    takes part.  Returns (max loss_sum rel err, {group: max grad-norm rel
    err})."""
    import torch

    from aocr_torch import augment
    from aocr_torch.parallel import data_parallel, mesh

    step = data_parallel.make_dp_train_step(cfg, grid.data_group)
    loc = lambda a: mesh.local_rows(a, grid.data_group)  # noqa: E731
    images = torch.from_numpy(loc(inputs[1][0])).to(dev)
    loss_err, norm_err = 0.0, {}
    for i, (((p, s, o), got), (t, te, mask)) in enumerate(zip(record,
                                                              schedule)):
        extra = {} if mask is None else {
            "row_mask": torch.from_numpy(loc(mask)).to(dev)}
        want = step(p, s, o, images, torch.from_numpy(loc(t)).to(dev),
                    torch.from_numpy(loc(te)).to(dev), cfg.learning_rate,
                    augment.step_key(cfg.seed, i), **extra)
        loss_err = max(loss_err, rel_err(got.loss_sum, want.loss_sum))
        for k in want.grad_norms:
            norm_err[k] = max(norm_err.get(k, 0.0), rel_err(
                got.grad_norms[k], want.grad_norms[k]))
    return loss_err, norm_err


def tp_rank(rank: int, nd: int, nm: int, root: str, seed: int,
            device: str) -> None:
    """One rank of a (nd, nm) grid on `device` in a gloo group over a file
    store under root: the TP step (3 full steps and the masked tail,
    float32 recorded, rank 0 holding each step to make_train_step from
    the same state; bf16 reported) and its host-clock ms; at (1, 2) a
    float32 step with dropout against the one-process dropout step; at
    (2, 2) the eval (aocr's flat data mesh over the 4 ranks on the
    gathered params, beam-5) and the CLI trainer at -num_shards 2
    -num_model_shards 2, then its checkpoint resumed by a Trainer of the
    grid and gathered whole.  Writes root/rank<r>.pkl or root/rank<r>.err."""
    try:
        sys.path.insert(0, ROOT)
        import torch
        import torch.distributed as dist

        from aocr_torch import train, train_step, weights
        from aocr_torch.config import parse_args
        from aocr_torch.ops import cuda
        from aocr_torch.parallel import eval_parallel, mesh
        from aocr_torch.parallel import tensor_parallel as tpl

        dev = torch.device(device)
        torch.cuda.set_device(dev)
        dist.init_process_group("gloo", init_method=f"file://{root}/store",
                                rank=rank, world_size=nd * nm)
        grid = mesh.make_grid(nd, nm)
        out = {"grid": (grid.d, grid.m)}
        inputs = dp_step_inputs(seed)
        schedule = dp_schedule(inputs, DP_STEPS, True)
        cuda.reset_launch_counts()
        record = []
        out["float32"] = tp_run_steps(train_config("float32"), grid, inputs,
                                      schedule, dev, record)
        out["bfloat16"] = tp_run_steps(train_config("bfloat16"), grid,
                                       inputs, schedule, dev)
        drop = []
        if nd == 1:
            out["dropout"] = tp_run_steps(
                train_config("float32").replace(dropout=OPT_DROPOUT), grid,
                inputs, schedule[:1], dev, drop)
        out["step_counts"] = dp_counts()
        if nd > 1:
            out["dp_errors"] = tp_dp_errors(train_config("float32"), grid,
                                            inputs, schedule, dev, record)
        if rank == 0:
            out["errors"] = tp_one_process_errors(
                train_config("float32"), inputs, schedule, dev, record)
            if drop:
                out["dropout_errors"] = tp_one_process_errors(
                    train_config("float32").replace(dropout=OPT_DROPOUT),
                    inputs, schedule[:1], dev, drop)
        del record, drop
        cfg = train_config("float32")
        params, stats = weights.from_numpy(*inputs[0], dev)
        shards = tpl.shard_params(params, grid)
        b = inputs[1]
        loc = lambda a: mesh.local_rows(a, grid.data_group)  # noqa: E731
        out["step_ms"] = step_ms(tpl.make_tp_train_step(cfg, grid), (
            shards, stats, train_step.init_opt_state(shards, cfg),
            torch.from_numpy(loc(b[0])).to(dev),
            torch.from_numpy(loc(b[2])).to(dev),
            torch.from_numpy(loc(b[3])).to(dev), cfg.learning_rate, None))
        if nd == 2:
            # the eval: the flat data mesh of every rank, gathered params
            im, t, te, mask = (mesh.local_rows(a)
                               for a in dp_eval_inputs(seed))
            ecfg = base_config().replace(beam_size=BEAM)
            cuda.reset_launch_counts()
            ev = eval_parallel.make_dp_eval_step(ecfg)(
                tpl.gather_params(shards, grid), stats,
                torch.from_numpy(im).to(dev), t, te, None,
                torch.from_numpy(mask))
            out["eval_counts"] = dp_counts()
            out["eval"] = {k: v.cpu().numpy() for k, v in
                           ev._asdict().items()}
            flags = ("-num_shards", str(nd), "-num_model_shards", str(nm))
            cuda.reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                train.main(trainer_argv(root, f"tp_rank{rank}", seed,
                                        *DP_TRAIN_ARGS, *flags), device=dev)
            out["trainer_s"] = time.perf_counter() - t0
            out["trainer_counts"] = dp_counts()
            dist.barrier()
            # rank 0's checkpoint, resumed by every rank and gathered
            tr = train.Trainer(parse_args(trainer_argv(
                root, "tp_rank0", seed, "-load_model", *flags)),
                train._Quiet(), dev)
            whole = tr._whole_params()
            if rank == 0:
                out["resumed"] = weights.to_numpy(whole, tr.batch_stats)
        dist.barrier()
        with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.destroy_process_group()
    except Exception:
        with open(os.path.join(root, f"rank{rank}.err"), "w") as f:
            f.write(f"rank {rank}:\n{traceback.format_exc()}")
        os._exit(1)


def _np_by_path(tree, path=()) -> dict:
    """{path: leaf} of a nested dict/list."""
    if isinstance(tree, dict):
        return {k_: v_ for k, v in tree.items()
                for k_, v_ in _np_by_path(v, path + (k,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k_: v_ for i, v in enumerate(tree)
                for k_, v_ in _np_by_path(v, path + (i,)).items()}
    return {path: tree}


def tp_phase(dev, seed: int, card: str):
    """DP x TP on the one card over gloo, all ranks on cuda:0: the (1, 2)
    grid in 2 processes and the (2, 2) grid in 4, the kernels built
    once by this process before the spawns.  Float32 at global B=400,
    T=11: 3 full steps and a masked tail (data shards of 200 and 100
    real rows at (2, 2)), each step held by rank 0 to make_train_step on
    the whole batch from the same state (loss rtol 1e-4, gathered params
    rtol 1e-3 atol 3e-4 -- tests/test_tensor_parallel.py's tolerances --
    and, at (1, 2), per-group grad norms rtol 1e-5; at (2, 2) the norms
    move with sync-BN's sums over the data shards, so there they are
    reported against one process and held, rtol 1e-5, to the DP step over
    the same data group from the same state); every rank's gathered state the
    same, replicated leaves bit-equal on every rank and each shard
    across its data ranks; bf16 reported; at (1, 2) a dropout-0.3 step
    against the one-process dropout step; the TP step's host-clock ms
    (gloo through the host, both or all four ranks on one card: no
    scaling figure).  At (2, 2) the eval on the gathered params over all
    4 ranks (beam-5, 500 rows padded to 512) against one process, and
    the CLI trainer at -num_shards 2 -num_model_shards 2 against
    -num_shards 1 (step perplexities rtol 1e-5, float32; only rank 0
    writes), whose checkpoint loads in one process and gives the
    transcripts of the params the grid gathers on resuming it.  The
    step's CNN and encoder kernels launch in every rank, the
    teacher-forced training kernels in none.  Returns {path: [counts of
    each rank]}."""
    import numpy as np
    import torch

    from aocr_torch import checkpoint
    from aocr_torch import eval as eval_lib
    from aocr_torch import train_step, weights
    from aocr_torch.api import AttentionOCR
    from aocr_torch.optim import leaves
    from aocr_torch.parallel import tensor_parallel as tpl

    inputs = dp_step_inputs(seed)
    schedule = dp_schedule(inputs, DP_STEPS, True)
    specs = leaves(tpl.param_specs(weights.from_numpy(*inputs[0])[0]))
    paths = {}
    for nd, nm in TP_GRIDS:
        tag = f"{nd}x{nm}"
        root = tempfile.mkdtemp(prefix="aocr_tp_")
        try:
            if nd == 2:
                write_dataset(root, seed)
            ranks = run_spawned(tp_rank, nd * nm,
                                (nd, nm, root, seed, str(dev)), root, 900,
                                f"tp {tag}")
            if ranks is None:
                continue
            check([r_["grid"] for r_ in ranks]
                  == [divmod(r, nm) for r in range(nd * nm)],
                  f"tp {tag}: grid places {[r_['grid'] for r_ in ranks]}")
            loss, norms, perr, ok = ranks[0]["errors"]
            norm = max(norms.values())
            fmt = lambda d: ", ".join(  # noqa: E731
                f"{k} {v:.3g}" for k, v in d.items())
            log(f"tp step {tag} float32 (gloo, one card), {DP_STEPS} full "
                f"steps + a tail of {DP_TAIL_REAL} real rows, each step vs "
                f"one process at B={B_TRAIN} from the same state: loss rel "
                f"err {loss:.3g} (tol 1e-4), gathered params max abs err "
                f"{perr:.3g}, within rtol 1e-3 atol 3e-4: {ok}; grad norm "
                f"rel err by group {fmt(norms)}"
                + (" (tol 1e-5)" if nd == 1 else ""))
            check(loss <= 1e-4 and ok and (nd > 1 or norm <= 1e-5),
                  f"tp step {tag} float32 disagrees with one process")
            if nd > 1:
                # with a data axis the norms move with sync-BN's sums over
                # the data shards: the model axis's own part is held to the
                # DP step over the same data group
                dls = [r_["dp_errors"] for r_ in ranks]
                dnorm = max(max(d[1].values()) for d in dls)
                dloss = max(d[0] for d in dls)
                log(f"tp step {tag} float32, each step vs make_dp_train_step "
                    f"over the same data group from the same state (sync-BN "
                    f"over {nd} data shards, no model axis), every rank: "
                    f"loss rel err {dloss:.3g} (tol 1e-4), grad norm rel err "
                    f"{dnorm:.3g} (tol 1e-5); rank 0 by group "
                    f"{fmt(dls[0][1])}")
                check(dloss <= 1e-4 and dnorm <= 1e-5,
                      f"tp step {tag} float32 disagrees with the DP step "
                      f"over its data group")
            for dt in ("float32", "bfloat16"):
                outs = [r_[dt] for r_ in ranks]
                same = all(o[0] == outs[0][0] and all(
                    np.array_equal(a, b) for a, b in zip(
                        _np_leaves(o[2]), _np_leaves(outs[0][2])))
                    for o in outs)
                rep = all(np.array_equal(o[4][i], (
                    outs[r % nm] if spec is not None else outs[0])[4][i])
                    for r, o in enumerate(outs)
                    for i, spec in enumerate(specs))
                check(same and rep, f"tp {tag} {dt}: ranks differ (gathered "
                                    f"state equal {same}, replicated leaves "
                                    f"and shards equal {rep})")
                want = dp_run_steps(train_config(dt),
                                    train_step.make_train_step(
                                        train_config(dt)),
                                    inputs, schedule, dev)
                log(f"tp step {tag} {dt}: ranks' gathered state equal "
                    f"{same}, replicated leaves bit-equal on every rank and "
                    f"each shard across its data ranks {rep}; run apart: "
                    f"losses {[round(x, 3) for x in outs[0][0]]} vs one "
                    f"process {[round(x, 3) for x in want[0]]}, params "
                    f"differ by {max_abs_diff(outs[0][2], want[1]):.3g}"
                    + (" (reported)" if dt == "bfloat16" else ""))
            for r, r_ in enumerate(ranks):
                log(f"tp step {tag} float32 global B={B_TRAIN}, rank {r}: "
                    f"{np.median(r_['step_ms']):.2f} ms (host clock, median "
                    f"of 5; gloo through the host, {nd * nm} ranks on one "
                    f"card: not a scaling figure) on {card}")
            if "dropout_errors" in ranks[0]:
                loss, norms, perr, ok = ranks[0]["dropout_errors"]
                norm = max(norms.values())
                log(f"tp step {tag} float32 dropout {OPT_DROPOUT} vs the "
                    f"one-process dropout step: loss rel err {loss:.3g}, "
                    f"grad norm rel err {norm:.3g}, params max abs err "
                    f"{perr:.3g}, within rtol 1e-3 atol 3e-4: {ok}")
                check(loss <= 1e-4 and norm <= 1e-5 and ok,
                      f"tp {tag} dropout step disagrees with one process")
            keys = [("step_counts", TP_STEP_KERNELS)]
            if nd == 2:
                keys += [("eval_counts", DP_EVAL_KERNELS),
                         ("trainer_counts", TP_STEP_KERNELS)]
            for key, kernels in keys:
                counts = [r_[key] for r_ in ranks]
                paths[f"tp {key[:-7]} {tag}"] = counts
                for r, c in enumerate(counts):
                    for k in kernels:
                        check(c[k] > 0, f"kernel {k} never launched in rank "
                                        f"{r} on the tp {tag} {key}")
                    if key != "eval_counts":
                        check(c["tf_bwd"] == 0 and (
                            key != "step_counts" or c["tf_fwd"] == 0),
                              f"tp {tag} {key}: the teacher-forced kernels "
                              f"launched in rank {r}: {c}")
                log(f"tp {tag} {key}: " + "; ".join(
                    f"rank {r} {c}" for r, c in enumerate(counts)))
            if nd != 2:
                continue
            # the eval against one process on the 500 real rows
            im, t, te, _mask = dp_eval_inputs(seed)
            cfg = base_config().replace(beam_size=BEAM)
            params, stats = weights.from_numpy(*inputs[0], dev)
            (labels, _sc, _rf), nll, _gold = train_step.eval_decode_step(
                params, stats, im[:DP_EVAL_REAL], t[:DP_EVAL_REAL],
                te[:DP_EVAL_REAL], cfg, beam_size=BEAM, max_len=T_MAX,
                return_refills=True)
            gold = torch.from_numpy(te[:DP_EVAL_REAL]).to(dev)
            acc = int(eval_lib.exact_match(labels, gold).sum())
            cer = float(eval_lib.char_error_rate(labels, gold).double().sum()
                        .float())
            evs = [r_["eval"] for r_ in ranks]
            lab_ok = np.array_equal(evs[0]["labels"][:DP_EVAL_REAL],
                                    labels.cpu().numpy())
            nll_err = abs(float(evs[0]["nll"]) - float(nll)) / abs(float(nll))
            same = all(np.array_equal(e[k], evs[0][k]) for e in evs
                       for k in evs[0])
            log(f"tp eval {tag} (the flat data mesh of 4 ranks, gathered "
                f"params), beam-{BEAM} float32, {DP_EVAL_REAL} rows padded "
                f"to {B_SERVE}: labels equal {lab_ok}, accuracy "
                f"{int(evs[0]['accuracy'])} vs {acc}, cer_sum "
                f"{float(evs[0]['cer_sum']):.6f} vs {cer:.6f}, nll rel err "
                f"{nll_err:.3g}; ranks equal {same}")
            check(lab_ok and int(evs[0]["accuracy"]) == acc
                  and float(evs[0]["cer_sum"]) == cer and nll_err <= 1e-5
                  and same, f"tp eval {tag} disagrees with one process")
            # the CLI trainer against -num_shards 1
            msgs, _c, secs = run_trainer(root, "one", seed, *DP_TRAIN_ARGS)
            with open(os.path.join(root, "tp_rank0.log")) as f:
                tmsgs = [line.split(" ", 2)[2]
                         for line in f.read().splitlines()]
            a, b = step_perplexities(tmsgs), step_perplexities(msgs)
            perr = perplexity_rel_err(a, b)
            files0 = sorted(os.listdir(os.path.join(root, "tp_rank0")))
            others = [f for f in os.listdir(root) if f.startswith(
                ("tp_rank1", "tp_rank2", "tp_rank3"))]
            mesh_line = any("DP x TP training over a 2x2 (data, model) mesh"
                            in m for m in tmsgs)
            eval_line = any("Sharded evaluation over 4 devices" in m
                            for m in tmsgs)
            log(f"tp trainer -num_shards 2 -num_model_shards 2 (gloo, one "
                f"card), float32 one epoch: step perplexities "
                f"{[round(x, 4) for x in a]} vs -num_shards 1's "
                f"{[round(x, 4) for x in b]}: rel err {perr:.3g} (tol "
                f"1e-5); {ranks[0]['trainer_s']:.1f} s against {secs:.1f} "
                f"s; the mesh line {mesh_line}, the eval line {eval_line}; "
                f"rank 0 wrote {files0}, ranks 1-3 {others}")
            check(len(a) == 3 and perr <= 1e-5 and mesh_line and eval_line,
                  "tp trainer: step perplexities or log lines differ")
            check(others == [] and {"model-2", "model-3", "final-model"}
                  <= set(files0), "tp trainer: only rank 0 may write the "
                                  "log and checkpoints")
            # its checkpoint in one process against the params the grid
            # gathered on resuming it
            ckpt = checkpoint.try_load_final(os.path.join(root, "tp_rank0"))
            rp, rs_ = ranks[0]["resumed"]
            a_, b_ = _np_by_path(ckpt["params"]), _np_by_path(rp)
            bits = a_.keys() == b_.keys() and all(
                np.array_equal(a_[k], b_[k]) for k in a_)
            one = AttentionOCR.load(os.path.join(root, "tp_rank0"),
                                    device=dev)
            grid_ocr = AttentionOCR(one.cfg, *weights.from_numpy(rp, rs_),
                                    device=dev)
            crops = word_images(np.random.RandomState(seed + 19), B_SERVE,
                                W_SERVE)
            w1, _ = one.recognize(crops, beam_size=1)
            w2, _ = grid_ocr.recognize(crops, beam_size=1)
            check(bits and w1 == w2, f"tp trainer checkpoint: params "
                                     f"bit-equal {bits}, transcripts equal "
                                     f"{w1 == w2}")
            log(f"tp trainer checkpoint loaded in one process: params "
                f"bit-equal to the grid's gathered resume {bits}, greedy "
                f"transcripts at B={B_SERVE} equal {w1 == w2}")
        finally:
            shutil.rmtree(root, ignore_errors=True)
    return paths


# ------------------------------------------------------------ phase 9

def shard_phase(dev, seed: int, card: str):
    """AttentionOCR.shard(devices=[cuda:0, cuda:0]) (one thread a shard)
    on B=512 and on a mixed-width list, greedy and beam-5, bf16 and
    float32: float32 transcripts identical to the unsharded model's, bf16
    reported; shard(2) without devices raises on a one-card machine; a
    bf16 server at -num_shards 0 (every local device: one here) answers a
    wave of 64 posts.  No scaling figure: two shards on one card measure
    nothing a user with two cards would see.  Returns the launch counts
    of the sharded recognize and the server."""
    import numpy as np
    import torch

    from aocr_torch import weights
    from aocr_torch.api import AttentionOCR
    from aocr_torch.ops import cuda

    base = base_config()
    np_params, np_stats = numpy_model(base, seed)
    rs = np.random.RandomState(seed + 17)
    requests = [word_images(rs, B_SERVE, W_SERVE),
                [im for w in (100, 81, 121, 100, 81, 181, 100)
                 for im in word_images(rs, 3, w)]]
    ocrs = {dt: AttentionOCR(base.replace(compute_dtype=dt),
                             *weights.from_numpy(np_params, np_stats),
                             device=dev) for dt in ("bfloat16", "float32")}
    want = {(dt, K): [o.recognize(r, beam_size=K) for r in requests]
            for dt, o in ocrs.items() for K in (1, BEAM)}
    cuda.reset_launch_counts()
    got = {}
    for dt, o in ocrs.items():
        o.shard(devices=[dev, dev])
        check(o.num_shards == 2, "shard: num_shards is not 2")
        for K in (1, BEAM):
            got[(dt, K)] = [o.recognize(r, beam_size=K) for r in requests]
        o.unshard()
    for (dt, K), res in got.items():
        gw = [w for words, _ in res for w in words]
        ww = [w for words, _ in want[(dt, K)] for w in words]
        agree = float(np.mean([a == b for a, b in zip(gw, ww)]))
        log(f"shard over [cuda:0, cuda:0] {dt} beam {K}: {len(gw)} "
            f"transcripts, agreement with unshard() {agree:.4f}"
            + ("" if dt == "float32" else " (reported)"))
        if dt == "float32":
            check(gw == ww, f"shard float32 beam {K}: transcripts differ "
                            "from unshard()'s")
    try:
        ocrs["float32"].shard(2)
        raised = False
    except ValueError as e:
        raised = "need 2x1 devices, have 1" in str(e)
    check(raised == (torch.cuda.device_count() == 1),
          "shard(2) on a one-card machine did not raise")
    root = tempfile.mkdtemp(prefix="aocr_shard_")
    try:
        ocrs["bfloat16"].save(root)
        url, httpd, rec, thread = start_server(
            model_dir=root, max_batch=64, cfg=base.replace(
                compute_dtype="bfloat16"), warmup=False, num_shards=0,
            device=dev)
        try:
            check(rec.ocr.num_shards == torch.cuda.device_count(),
                  f"serve -num_shards 0: {rec.ocr.num_shards} shards")
            imgs = word_images(rs, 64, W_SERVE)
            res, wall = post_concurrently(
                f"{url}/recognize", [("", png(im)) for im in imgs], 64)
            ok = all(r[0] == 200 and np.isfinite(r[1]["score"])
                     for r in res)
            check(ok, "serve -num_shards 0: a post failed")
            log(f"serve bf16 -num_shards 0 ({rec.ocr.num_shards} shard on "
                f"this machine): 64 posts answered in {wall:.2f} s")
        finally:
            stop_server(httpd, thread)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    counts = dp_counts()
    for k in ("conv1_pool", "lstm_fwd", "greedy_loop", "beam_loop"):
        check(counts[k] > 0, f"kernel {k} never launched on the shard path")
    log(f"shard path launch counts: {counts}")
    return counts



# ------------------------------------------------------------ phase 5

def held_route_steps(cfg, np_model, batch, dev, n: int, tag: str):
    """n train steps of cfg from np_model on batch, each step's state
    also stepped by the plain route (use_pallas=False; held_steps): every
    step held to it (TRAIN_TOLS), a trajectory compared step by step from
    one state, since float32 runs on the card part by more than the
    routes do (cuDNN).  Returns (the kernel steps' launch counts, their
    outputs)."""
    import torch

    from aocr_torch.ops import cuda
    from aocr_torch.ops.cuda import lstm_fwd

    cuda.reset_launch_counts()
    outs, plain = held_steps(cfg, cfg.replace(use_pallas=False), np_model,
                             batch, dev, n)
    torch.cuda.synchronize()
    counts = cuda.launch_counts()
    counts["lstm_fwd_collect"] = lstm_fwd.launches_collect
    for i, (a, b) in enumerate(zip(outs, plain)):
        e = step_agreement(a, b)
        check(all(x <= t for x, t in zip(e, TRAIN_TOLS)),
              f"{tag} step {i + 1}: kernel and plain routes disagree {e}")
        log(f"{tag} step {i + 1}, kernel route vs the plain route from the "
            f"same state: loss_sum rel err {e[0]:.3g}, grad norm rel err "
            f"{e[1]:.3g}, param max abs err {e[2]:.3g} (tol {TRAIN_TOLS}); "
            f"loss_sum {float(a.loss_sum):.2f}")
    return counts, outs


def held_train_steps(dev, seed: int, base) -> dict:
    """TRAIN_STEPS float32 make_train_step steps (SGD) of base's model at
    B=400, T=11 from the --seed weights, held to the plain route's
    (held_route_steps); the loss falls.  Returns the launch counts."""
    import numpy as np

    tag = "" if base.input_feed else "no input feed "
    cfg = train_config("float32", base=base)
    batch = train_batch(np.random.RandomState(seed + 2), B_TRAIN)
    counts, outs = held_route_steps(cfg, numpy_model(cfg, seed), batch, dev,
                                    TRAIN_STEPS,
                                    f"train {tag}float32 B={B_TRAIN}")
    log(f"{tag}train path launch counts (the kernel steps; the plain "
        f"steps launch none): {counts}")
    for k in ("conv1_pool", "conv1_pool_bwd", "lstm_fwd_collect", "lstm_bwd",
              "tf_fwd", "tf_bwd", "pool_bwd"):
        check(counts[k] > 0, f"kernel {k} never launched on the {tag}train "
                             "path")
    losses = [float(o.loss_sum) for o in outs]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{tag}float32 train: loss_sum {losses}")
    return counts


def no_feed_trainer(dev, seed: int) -> dict:
    """python -m aocr_torch.train without -input_feed (the CLI's default
    decoder) on write_dataset's N_TRAIN + N_VAL crops: float32, one epoch
    (3 steps) with the kernels and with -no_use_pallas, then a greedy
    test of the kernel run's checkpoint both ways (trainer_runs_vs_plain
    held by hold_trainer_runs, trainer_test_vs_plain).  Returns the runs'
    launch counts."""
    import shutil
    import tempfile

    from aocr_torch import checkpoint

    root = tempfile.mkdtemp(prefix="aocr_nofeed_")
    total: dict = {}

    def run(tag, *args):
        out = run_trainer(root, tag, seed, *args, input_feed=False)
        add_counts(total, out[1])
        return out

    def final(tag):
        return checkpoint.load(checkpoint.final_path(os.path.join(root, tag)))

    try:
        write_dataset(root, seed)
        hold_trainer_runs("nofeed", *trainer_runs_vs_plain(
            run, final, "nofeed",
            ("-phase", "train", "-steps_per_checkpoint", "2",
             "-num_batches_val", "1", "-num_epochs", "1")))
        trainer_test_vs_plain(run, root, "nofeed", ("-data_path", "val.txt"))
        check(final("nofeedk")["config"]["input_feed"] is False,
              "trainer nofeed: the checkpoint has input feed")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for k in ("conv1_pool", "conv1_pool_bwd", "lstm_bwd", "tf_fwd", "tf_bwd",
              "pool_bwd", "greedy_loop"):
        check(total.get(k, 0) > 0,
              f"kernel {k} never launched by the no-input-feed CLI trainer")
    return total


def no_input_feed_phase(dev, seed: int, lexicon, results: dict) -> dict:
    """The CLI trainer's default decoder, without input feed (cli_config),
    at full width on the card: the decoder kernels against their plain
    versions at the main paths' shapes with the input-feed checks'
    tolerances (greedy_loop B=512 T=50 with and without the 88k trie,
    decode_step at B=1 and 512, beam_step at K=5 and 10, beam_loop at
    K=5, tf_fwd and tf_bwd at B=400 and 37); the trained fixture's bf16
    transcripts on every kernel route; recognize (greedy at B=1, 8, 32,
    512 and a mixed list, beam-5, dictionary beam-5, beam-10) with
    float32 transcripts equal to the plain route's; TRAIN_STEPS float32
    train steps held to the plain route's step by step; the CLI trainer
    without -input_feed.  Returns {path: launch counts}."""
    import torch

    words, table_np = lexicon
    table = torch.from_numpy(table_np).to(dev)
    cfg = cli_config()
    log("no input feed: the CLI trainer's default decoder at full width")
    g = torch.Generator().manual_seed(37)
    decoder_kernel_checks(dev, results, table, cfg, g, (1, B_SERVE),
                          ("auto",))
    beam_kernel_checks(dev, results, table, cfg)
    tf_kernel_checks(dev, results, cfg, g)
    for what, ok in fixture_transcripts(dev, input_feed=False):
        log(f"check {what}")
        check(ok, what)
    paths = {}
    paths["recognize"], _m, _r = end_to_end(dev, seed, cfg)
    paths["beam"], bmodels, brequests = beam_end_to_end(dev, seed, lexicon,
                                                        cfg)
    paths["beam-10"] = beam10_end_to_end(dev, bmodels, brequests)
    paths["train step"] = held_train_steps(dev, seed, cfg)
    paths["CLI trainer"] = no_feed_trainer(dev, seed)
    return {f"no input feed {k}": v for k, v in paths.items()}


# the width ladder at 32 px tall (data.width_ladder): contexts of L = W/4
# - 1 = 3 ... 79 steps
LADDER = (16, 24, 36, 54, 81, 121, 181, 271, 320)
# requests a ladder width (bounds the phase's run time)
B_LADDER = 64
# the keep-aspect trainer's crops a width (one batch of each), train and
# validation
B_ASPECT = 32


def ladder_recognize(dev, cfg, np_model, reqs, mixed) -> dict:
    """recognize on cfg's keep-aspect model at each ladder width (reqs:
    {W: B_LADDER images}) and on the mixed list of every width, greedy and
    beam-5, float32 and bf16, on the default routes (the loop kernels at
    every L) and the plain route: float32 transcripts equal, scores within
    1e-3; bf16 agreement reported.  Returns the launch counts."""
    import numpy as np
    import torch

    from aocr_torch import decode, weights
    from aocr_torch.api import AttentionOCR
    from aocr_torch.ops import cuda

    models = {dt: AttentionOCR(cfg.replace(compute_dtype=dt),
                               *weights.from_numpy(*np_model), device=dev)
              for dt in ("bfloat16", "float32")}
    for dt, m in models.items():
        for W in LADDER:
            L = W // 4 - 1
            for B in (B_LADDER, B_SERVE):
                H = m.cfg.decoder_num_hidden
                check(decode.greedy_route(m.cfg, B, L, H) == "loop"
                      and decode.beam_route(m.cfg, B, L, H, BEAM) == "loop",
                      f"keep-aspect {dt} W={W}: a decode off the loop "
                      "kernels")

    def drive(m):
        out = {}
        for K in (1, BEAM):
            for W in LADDER:
                out[(W, K)] = m.recognize(reqs[W], beam_size=K)
            out[("mixed", K)] = m.recognize(mixed, beam_size=K)
        return out

    cuda.reset_launch_counts()
    outs = {dt: drive(m) for dt, m in models.items()}
    torch.cuda.synchronize()
    counts = cuda.launch_counts()
    log(f"keep-aspect recognize path launch counts: {counts}")
    for k in ("conv1_pool", "lstm_fwd", "greedy_loop", "beam_loop"):
        check(counts[k] > 0, f"kernel {k} never launched on the keep-aspect "
                             "recognize path")
    with plain_route():
        plain = {dt: drive(m) for dt, m in models.items()}
    for dt, res in outs.items():
        for (W, K), (ws, sc) in res.items():
            want = plain[dt][(W, K)]
            n = len(reqs[W]) if W != "mixed" else len(mixed)
            check(len(ws) == n and bool(np.isfinite(sc).all())
                  and bool((sc <= 0).all()),
                  f"keep-aspect {dt} W={W} beam {K}: bad results")
            agree = float(np.mean([a == b for a, b in zip(ws, want[0])]))
            if dt == "float32":
                gap = float(np.abs(sc - want[1]).max())
                check(ws == want[0] and gap <= 1e-3,
                      f"keep-aspect float32 W={W} beam {K}: kernel and "
                      f"plain routes disagree (agreement {agree}, score gap "
                      f"{gap})")
            ctx = "3-79" if W == "mixed" else W // 4 - 1
            mode = "greedy" if K == 1 else f"beam-{K}"
            log(f"e2e keep-aspect {dt} W={W} (L={ctx}) B={n} {mode}: "
                f"{len(set(ws))} distinct transcripts, mean length "
                f"{np.mean([len(w) for w in ws]):.2f}; agreement with the "
                f"plain route on the card {agree:.4f}")
    return counts


def aspect_loop_checks(dev, results: dict, table, cfg) -> None:
    """greedy_loop and beam_loop (K=5) of cfg's decoder against their
    plain versions at the ladder's shortest and longest contexts (W=16,
    L=3; W=320, L=79), B=512, T=50, float32 and bf16, without a trie and
    under the 88k trie, with the tolerances of the L=24 checks.  Random
    contexts, states and (beam_loop) t=1 picks keep most searches live
    for all T steps, where the ladder models' random-weight searches end
    at EOS at once (ladder_recognize's transcripts are empty)."""
    import torch

    from aocr_torch import weights
    from aocr_torch.models.decoder import DecoderState
    from aocr_torch.ops.cuda import greedy_loop

    g = torch.Generator().manual_seed(41)
    rand = lambda *s, lo=-1.0, hi=1.0: (torch.rand(*s, generator=g)
                                        * (hi - lo) + lo)
    B, T = B_SERVE, T_MAX
    Hd, E, nl, feed = (cfg.decoder_num_hidden, cfg.target_embedding_size,
                       cfg.decoder_num_layers, cfg.input_feed)
    nofeed = "" if feed else ", no input feed"
    p, _ = numpy_model(cfg, 3)
    tp, _ = weights.from_numpy({"decoder": p["decoder"],
                                "projector": p["projector"]}, {}, dev)
    for dt in (torch.float32, torch.bfloat16):
        name = "f32" if dt == torch.float32 else "bf16"
        tol = 1e-4 if dt == torch.float32 else 3e-2
        tables = greedy_loop.build_tables(tp["decoder"], tp["projector"], E,
                                          feed, dt)
        for W in (LADDER[0], LADDER[-1]):
            ctx = rand(W // 4 - 1, B, Hd).to(dev, dt)
            loop_args = (ctx, rand(B, Hd).to(dev), rand(B, Hd).to(dev), nl,
                         feed, T)
            st = DecoderState(attn=rand(B, Hd).to(dev),
                              cs=tuple(rand(B, Hd).to(dev)
                                       for _ in range(nl)),
                              hs=tuple(rand(B, Hd).to(dev)
                                       for _ in range(nl)))
            for what, tr in (("", None), (", 88k trie", table)):
                what = f"{nofeed}, keep-aspect W={W}{what}"
                results.setdefault(("greedy_loop", name), []).append(
                    check_loop(name, tables, loop_args, tol, what,
                               trie_table=tr))
                results.setdefault(("beam_loop", name), []).append(
                    check_beam_loop(name, what, ctx, st, tables, tr, False,
                                    tol, g, feed))


def aspect_held_steps(dev, seed: int, cfg) -> dict:
    """At each ladder width, 2 float32 Adadelta train steps of cfg's
    keep-aspect model at B_ASPECT (words rendered at the width) from the
    --seed weights, held to the plain route's (held_route_steps) under
    cuDNN's deterministic algorithms.  Returns the launch counts."""
    import numpy as np

    from aocr_torch import demo, vocab

    cfg = cfg.replace(compute_dtype="float32", optimizer="adadelta",
                      batch_size=B_ASPECT)
    np_model = numpy_model(cfg, seed)
    rs = np.random.RandomState(seed + 25)
    letters = list("abcdefghijklmnopqrstuvwxyz0123456789")
    total: dict = {}
    for W in LADDER:
        words = ["".join(rs.choice(letters, WORD_LEN))
                 for _ in range(B_ASPECT)]
        targets, targets_eval, _ = vocab.encode_batch(words)
        images = np.stack([demo.render_word(w, 32, W)
                           for w in words])[..., None]
        with deterministic_cudnn():
            counts, _ = held_route_steps(
                cfg, np_model, (images, words, targets, targets_eval), dev,
                2, f"train keep-aspect adadelta float32 W={W} (L={W // 4 - 1})"
                   f" B={B_ASPECT}")
        add_counts(total, counts)
    return total


def aspect_trainer(dev, seed: int) -> dict:
    """python -m aocr_torch.train -keep_aspect_ratio -snap_width_ladder
    -optimizer adadelta without -input_feed (queue 6's C2, C3 and C4 in
    one run) on write_dataset's words rendered at the ladder widths,
    B_ASPECT crops a width: float32, one epoch of a step a width bucket
    with the kernels and with -no_use_pallas under cuDNN's deterministic
    algorithms (trainer_runs_vs_plain), then a beam-5 test of the kernel
    run's checkpoint both ways (trainer_test_vs_plain).  The two runs'
    perplexity and params differences are stated, not held: over the
    epoch Adadelta's normalized steps grow the routes' 1e-7 step
    differences as much as a 1e-7 change of the initial params grows on
    the plain route alone (tools/keep_aspect_drift_torch.py, PERF.md);
    each step is held to the plain route's from one state at every width
    by aspect_held_steps.  Returns the launch counts."""
    import shutil
    import tempfile

    from aocr_torch import checkpoint

    root = tempfile.mkdtemp(prefix="aocr_aspect_")
    total: dict = {}

    def run(tag, *args):
        out = run_trainer(root, tag, seed, *args, input_feed=False)
        add_counts(total, out[1])
        return out

    def final(tag):
        return checkpoint.load(checkpoint.final_path(os.path.join(root, tag)))

    n = B_ASPECT * len(LADDER)
    aspect = ("-keep_aspect_ratio", "-snap_width_ladder",
              "-batch_size", str(B_ASPECT))
    try:
        write_dataset(root, seed, (n, n), LADDER)
        with deterministic_cudnn():
            trainer_runs_vs_plain(
                run, final, "aspect",
                ("-phase", "train", *aspect, "-optimizer", "adadelta",
                 "-num_epochs", "1", "-steps_per_checkpoint", "100",
                 "-num_batches_val", "1"))
            trainer_test_vs_plain(
                run, root, "aspect",
                ("-data_path", "val.txt", *aspect, "-beam_size", str(BEAM)))
        ck = final("aspectk")
        got = {k: ck["config"][k]
               for k in ("keep_aspect_ratio", "optimizer", "input_feed")}
        check(ck["global_step"] == len(LADDER)
              and got == {"keep_aspect_ratio": True,
                          "optimizer": "adadelta", "input_feed": False},
              f"trainer aspect: global_step {ck['global_step']}, {got}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for k in ("conv1_pool", "conv1_pool_bwd", "lstm_bwd", "tf_fwd", "tf_bwd",
              "pool_bwd", "beam_loop"):
        check(total.get(k, 0) > 0,
              f"kernel {k} never launched by the keep-aspect CLI trainer")
    return total


def aspect_wave(dev, url: str, bodies, want, margins, tag: str) -> None:
    """post the bodies through 32 clients to url's /recognize (greedy):
    every answer 200, texts equal to `want` but at plain near-ties
    (margins), then /stats' padded rows logged."""
    out, wall = post_concurrently(f"{url}/recognize",
                                  [("", b) for b in bodies], 32)
    check(all(o is not None and o[0] == 200 for o in out),
          f"{tag}: a request failed")
    texts = [o[1].get("text") for o in out]
    n = parted(tag, texts, want, margins)
    s = http(f"{url}/stats")[1]
    rows = s["batched_rows"] + s["padded_rows"]
    log(f"{tag}: {len(bodies)} requests of widths 20-300 in {wall:.3f} s; "
        f"texts equal to the direct recognize but {n} at plain near-ties; "
        f"{s['batches']} batches, padded_rows {s['padded_rows']} "
        f"({s['padded_rows'] / max(rows, 1):.1%} of the decoded rows)")


def aspect_serve_export(dev, cfg, np_model, reqs, card: str):
    """A float32 keep-aspect model (cfg) served and exported: (a) a server
    (max_batch 64) and one wave of 256 PNG posts of widths between the
    ladder's steps (preprocessed by aspect, snapped up the ladder),
    against a direct recognize of the same preprocessed images; (b)
    export_recognizer(use_pallas=True) as a multi-width .aocrx (a program
    a ladder width) whose recognize at each width is bit-equal to the
    live route's; (c) serve(artifact=...) and one wave.  Returns (the
    served waves' and the artifact recognizes' launch counts)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from aocr_torch import data, demo, export, weights
    from aocr_torch.api import AttentionOCR
    from aocr_torch.ops import cuda

    cfg = cfg.replace(compute_dtype="float32")
    ocr = AttentionOCR(cfg, *weights.from_numpy(*np_model), device=dev)
    rs = np.random.RandomState(31)
    letters = list("abcdefghijklmnopqrstuvwxyz0123456789")
    widths = (20, 30, 45, 70, 100, 150, 200, 250, 300)
    bodies = [png(demo.render_word("".join(rs.choice(letters,
                                                     rs.randint(2, 11))),
                                   32, widths[i % len(widths)]))
              for i in range(256)]
    ingest = [data.load_and_preprocess(b, cfg) for b in bodies]
    check(sorted({im.shape[1] for im in ingest}) == list(LADDER[1:]),
          f"keep-aspect serve: preprocessed widths "
          f"{sorted({im.shape[1] for im in ingest})}")
    want = ocr.recognize(ingest)[0]
    margins = plain_margins(ocr, ingest, 1)
    root = tempfile.mkdtemp(prefix="aocr_aspect_serve_")
    total: dict = {}
    try:
        model_dir = os.path.join(root, "model")
        ocr.save(model_dir)
        url, httpd, rec, thread = start_server(
            model_dir=model_dir, max_batch=64, warmup=False, device=dev)
        try:
            check(rec.width_ladder == list(LADDER),
                  f"keep-aspect serve: width ladder {rec.width_ladder}")
            cuda.reset_launch_counts()
            aspect_wave(dev, url, bodies, want, margins,
                        "keep-aspect serve float32")
            torch.cuda.synchronize()
            add_counts(total, cuda.launch_counts())
        finally:
            stop_server(httpd, thread)

        path = os.path.join(root, "aspect.aocrx")
        t0 = time.perf_counter()
        export.export_recognizer(ocr, path, use_pallas=True, device=dev)
        trace_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        art = export.ExportedRecognizer.load(path, dev)
        load_s = time.perf_counter() - t0
        check(list(art.widths) == list(LADDER),
              f"keep-aspect export: widths {art.widths}")
        cuda.reset_launch_counts()
        diff = []
        for W in LADDER:
            got, live = art.recognize(reqs[W]), ocr.recognize(reqs[W])
            same = got[0] == live[0] and np.array_equal(got[1], live[1])
            check(same, f"keep-aspect export W={W}: the artifact is not "
                        "bit-equal to the live recognize")
            if not same:
                diff.append(W)
        torch.cuda.synchronize()
        counts = cuda.launch_counts()
        add_counts(total, counts)
        for k in ("conv1_pool", "lstm_fwd", "greedy_loop"):
            check(counts[k] > 0, f"keep-aspect export: kernel {k} never "
                                 "launched by the artifact")
        log(f"keep-aspect export: {len(LADDER)} programs (W {LADDER}), "
            f"{os.path.getsize(path) / 1e6:.1f} MB, traced in {trace_s:.1f} s"
            f", loaded in {load_s:.1f} s; recognize bit-equal to the live "
            f"route at {len(LADDER) - len(diff)} of {len(LADDER)} widths; "
            f"launches {counts} on {card}")

        ingest_a = [data.load_and_preprocess(b, art.preprocess_config())
                    for b in bodies]
        check(all(np.array_equal(a, b) for a, b in zip(ingest_a, ingest)),
              "keep-aspect export: the artifact preprocesses otherwise")
        want_a = art.recognize(ingest_a)[0]
        url, httpd, rec, thread = start_server(
            artifact=path, device=dev, max_batch=64, warmup=False)
        try:
            cuda.reset_launch_counts()
            aspect_wave(dev, url, bodies, want_a, margins,
                        "keep-aspect serve -artifact")
            torch.cuda.synchronize()
            add_counts(total, cuda.launch_counts())
        finally:
            stop_server(httpd, thread)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return total


def keep_aspect_phase(dev, seed: int, lexicon, results: dict,
                      card: str) -> dict:
    """-keep_aspect_ratio over the whole width ladder (LADDER, L = 3 ...
    79) on the CLI's default decoder (no input feed) at full width: the
    loop kernels against their plain versions at L=3 and L=79
    (aspect_loop_checks), ladder_recognize (B_LADDER images a width and a B=512 list of every
    width), Adadelta train steps at every width held to the plain
    route's (aspect_held_steps), the keep-aspect Adadelta CLI trainer and
    beam-5 test (aspect_trainer), serving and a multi-width artifact
    (aspect_serve_export).  Returns {path: launch counts}."""
    import numpy as np
    import torch

    from aocr_torch import data

    cfg = cli_config().replace(keep_aspect_ratio=True,
                               snap_width_ladder=True)
    check(data.width_ladder(cfg) == list(LADDER),
          f"the width ladder is {data.width_ladder(cfg)}")
    log(f"keep-aspect: widths {LADDER}, no input feed")
    aspect_loop_checks(dev, results,
                       torch.from_numpy(lexicon[1]).to(dev), cfg)
    np_model = numpy_model(cfg, seed)
    rs = np.random.RandomState(seed + 21)
    reqs = {W: word_images(rs, B_LADDER, W) for W in LADDER}
    # B=512 of every width: 56 or 57 a width
    mixed = [im for i, W in enumerate(LADDER)
             for im in word_images(rs, (B_SERVE + i) // len(LADDER), W)]
    check(len(mixed) == B_SERVE, f"the mixed list holds {len(mixed)}")
    return {"keep-aspect recognize": ladder_recognize(dev, cfg, np_model,
                                                      reqs, mixed),
            "keep-aspect train steps": aspect_held_steps(dev, seed, cfg),
            "keep-aspect CLI trainer": aspect_trainer(dev, seed),
            "keep-aspect serve and export": aspect_serve_export(
                dev, cfg, np_model, reqs, card)}


# the demo's reduced run in chip_smoke (aocr_torch.demo: DEMO_WORDS words,
# DEMO_EPOCHS epochs, batch 256; ~70 s on an H100) and the greedy exact
# match it must reach.  The demo's full default run (120 epochs) reads
# back every word, greedy and dictionary beam-5 (1.0000 on an H100 at
# 700 W in 201.5 s; PERF.md); at 30 epochs two runs read 0.5150 and
# 0.4324 greedy (the training mid-climb, float32 runs not repeatable
# bitwise), its validation accuracy near 0.8 by epoch 40, so the floor
# sits well under the reduced run
DEMO_WORDS, DEMO_EPOCHS, DEMO_FLOOR = 2000, 40, 0.3


def demo_phase(dev, card: str) -> dict:
    """python -m aocr_torch.demo at a reduced size (DEMO_WORDS words,
    DEMO_EPOCHS epochs, in-process on the card): every stage runs; the
    artifact's transcripts match the live model's on every replayed
    image; the greedy exact match reaches DEMO_FLOOR (0.3, where the full
    default run reads back every word: the constants' comment).  Returns
    the launch counts."""
    import shutil
    import tempfile

    import torch

    from aocr_torch import demo
    from aocr_torch.ops import cuda
    from aocr_torch.ops.cuda import lstm_fwd

    root = tempfile.mkdtemp(prefix="aocr_demo_")
    cuda.reset_launch_counts()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            res = demo.main(["--workdir", root, "--words", str(DEMO_WORDS),
                             "--epochs", str(DEMO_EPOCHS)], device=dev)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.synchronize()
    counts = cuda.launch_counts()
    counts["lstm_fwd_collect"] = lstm_fwd.launches_collect
    check(res["artifact_matches"] == res["replayed"] > 0,
          f"demo: the artifact matches the live model on "
          f"{res['artifact_matches']} of {res['replayed']} images")
    check(res["greedy_exact_match"] >= DEMO_FLOOR,
          f"demo: greedy exact match {res['greedy_exact_match']} below "
          f"{DEMO_FLOOR}")
    for k in ("conv1_pool", "lstm_fwd", "lstm_fwd_collect", "tf_fwd",
              "tf_bwd", "greedy_loop", "beam_loop"):
        check(counts[k] > 0, f"kernel {k} never launched by the demo")
    log(f"demo ({DEMO_WORDS} words, {DEMO_EPOCHS} epochs): greedy exact "
        f"match {res['greedy_exact_match']:.4f} (floor {DEMO_FLOOR}), "
        f"dictionary beam-5 {res['dict_exact_match']:.4f}; artifact "
        f"{res['artifact_matches']}/{res['replayed']} equal to the live "
        f"model; {res['seconds']:.1f} s on {card}; launches {counts}")
    return counts


def ptxas_summary(text: str, kernel: str) -> list:
    """'<instance>: <registers>, <spills>' for each instance of a kernel in
    the build's -Xptxas=-v output (empty where nvcc printed none)."""
    out, name, spills = [], None, ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if kernel in line else None
        elif name and "spill" in line:
            spills = line.strip()
        elif name and "Used" in line and "registers" in line:
            regs = line.split("Used", 1)[1].split(",")[0].strip()
            out.append(f"{name}: {regs}, {spills}")
            name = None
    return out



def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(ROOT, "aocr_torch", "csrc")):
        print("chip_smoke.py: run it from a checkout of the repo "
              "(aocr_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    from aocr_torch.ops import cuda

    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        lib = cuda.build(verbose=True)
    print(out.getvalue(), end="", flush=True)
    cuda.library()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s -> "
        f"{os.path.relpath(lib, ROOT)}")
    for kernel in ("lstm_fwd_kernel", "greedy_cluster_kernel",
                   "beam_cluster_kernel", "tf_fwd_cluster_kernel",
                   "tf_bwd_cluster_kernel", "lstm_bwd_cluster_kernel",
                   "conv1_pool_bwd_kernel", "conv1_pool_bf16_kernel",
                   "conv1_pool_f32_kernel", "step_cluster_kernel",
                   "conv1_pool_dx_kernel"):
        for line in ptxas_summary(out.getvalue(), kernel):
            log(f"ptxas {line}")

    t0 = time.perf_counter()
    words, table_np = synthetic_lexicon()
    table = torch.from_numpy(table_np).to(dev)
    log(f"synthetic lexicon: {len(words)} words -> {table.shape[0]} DAWG "
        f"nodes, {table.numel() * 4 / 2 ** 20:.1f} MiB int32 on the card "
        f"({time.perf_counter() - t0:.1f} s to build)")

    secs: dict = {}

    def timed(name, fn, *a):
        """fn(*a), its wall seconds logged and kept in secs."""
        t0 = time.perf_counter()
        try:
            return fn(*a)
        finally:
            secs[name] = time.perf_counter() - t0
            log(f"phase {name}: {secs[name]:.1f} s")

    lexicon = (words, table_np)
    results: dict = {}
    timed("kernel checks", kernel_checks, dev, results, table)
    timed("beam kernel checks", beam_kernel_checks, dev, results, table)
    timed("train kernel checks", train_kernel_checks, dev, results)
    for what, ok in timed("trained fixture", fixture_transcripts, dev):
        log(f"check {what}")
        check(ok, what)
    # the paths, each driven with the counts set to 0 just before it and
    # read just after
    counts, models, requests = timed("recognize", end_to_end, dev,
                                     args.seed)
    bcounts, bmodels, brequests = timed("beam", beam_end_to_end, dev,
                                        args.seed, lexicon)
    b10counts = timed("beam-10", beam10_end_to_end, dev, bmodels, brequests)
    tcounts, tcfg, np_model, batch = timed("train step", train_end_to_end,
                                           dev, args.seed)
    gcounts = timed("image gradient", image_gradient, dev, args.seed)
    ccounts, readings = timed("CLI trainer", trainer_phase, dev, args.seed,
                              card)
    scounts, sreadings = timed("serve", serving_phase, dev, args.seed,
                               lexicon, card)
    ecounts, ereadings = timed("export", export_phase, dev, args.seed,
                               lexicon, card)
    dcounts = timed("device preprocess", device_preprocess_phase, dev,
                    args.seed, card)
    acounts = timed("augment", augment_phase, dev, tcfg, np_model, batch,
                    card)
    icounts, ireadings = timed("torch import", import_phase, dev, args.seed,
                               card)
    w1counts, w1ms = timed("dp world 1", dp_world1_phase, dev, args.seed,
                           card)
    w2 = timed("dp world 2", dp_world2_phase, dev, args.seed, card)
    none = {k: 0 for k in cuda.KERNELS + ("lstm_fwd_collect",)}
    w2 = {k: w2.get(k, [none, none]) for k in ("step_counts", "eval_counts",
                                              "trainer_counts")}
    shcounts = timed("shard", shard_phase, dev, args.seed, card)
    ocounts, oby = timed("training options", options_phase, dev, tcfg,
                         np_model, batch, card)
    tpcounts = timed("tp", tp_phase, dev, args.seed, card)
    # the CLI's default decoder (no input feed), the width
    # ladder under -keep_aspect_ratio, the demo
    nfcounts = timed("no input feed", no_input_feed_phase, dev, args.seed,
                     lexicon, results)
    kacounts = timed("keep aspect", keep_aspect_phase, dev, args.seed,
                     lexicon, results, card)
    decounts = timed("demo", demo_phase, dev, card)
    from aocr_torch import decode

    log("decode routes, as each shape's first decode logged them: "
        + "; ".join(f"{w} {k}: {r}" for (w, k), r in decode.routes.items()))
    t0 = time.perf_counter()
    ms, bounds, lib = timings(dev, models, requests, card, table)
    gms, gbounds = greedy_loop_timings(dev, models, results, table)
    ms.update(gms)
    bounds.update(gbounds)
    blms, blbounds = beam_loop_timings(dev, bmodels, results, table)
    ms.update(blms)
    bounds.update(blbounds)
    bms, bbounds, rates = beam_timings(dev, bmodels, brequests,
                                       (words, table_np), card)
    ms.update(bms)
    bounds.update(bbounds)
    tms, tbounds, tlib = train_timings(dev, tcfg, np_model, batch, card)
    ms.update(tms)
    bounds.update(tbounds)
    lib.update(tlib)
    lms, lbounds, llib = lstm_fwd_timings(dev, results)
    ms.update(lms)
    bounds.update(lbounds)
    lib.update(llib)
    secs["timings"] = time.perf_counter() - t0
    log("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                      for k, v in secs.items()))

    from aocr_torch.ops.cuda import lstm_bwd

    check("jax" not in sys.modules, "jax was imported")
    check(not any(k == "aocr" or k.startswith("aocr.") for k in sys.modules),
          "a module of the JAX package was imported")
    # each kernel's figures in the dtype of its main path
    main_dtype = {"conv1_pool": "bf16", "lstm_fwd": "bf16",
                  "decode_step": "f32", "greedy_loop": "bf16",
                  "conv1_pool_bwd": "bf16", "lstm_bwd": "bf16",
                  "tf_fwd": "bf16", "tf_bwd": "bf16", "beam_step": "bf16",
                  "beam_loop": "bf16", "conv1_pool_dx": "f32",
                  "pool_bwd": "bf16"}
    replaces = {"conv1_pool": "aocr/ops/pallas/conv1_pool.py:244",
                "lstm_fwd": "aocr/ops/pallas/lstm_fwd.py:158",
                "decode_step": "aocr/ops/pallas/decode_step.py:199",
                "greedy_loop": "aocr/ops/pallas/greedy_loop.py:362",
                "conv1_pool_bwd": "aocr/ops/pallas/conv1_pool.py:266",
                "lstm_bwd": "aocr/ops/pallas/lstm_bwd.py:131",
                "tf_fwd": "aocr/ops/pallas/tf_fwd.py:252",
                "tf_bwd": "aocr/ops/pallas/tf_bwd.py:276",
                "beam_step": "aocr/ops/pallas/beam_step.py:185",
                "beam_loop": "aocr/ops/pallas/beam_loop.py:514",
                "conv1_pool_dx": "aocr/ops/pallas/conv1_pool.py:287",
                "pool_bwd": "aocr/ops/pallas/pool_bwd.py:117"}
    # the paths' runs, each counted from 0 just before it and read just
    # after it
    paths = {"recognize": counts, "beam": bcounts, "beam-10": b10counts,
             "train step": tcounts, "image gradient": gcounts,
             "CLI trainer": ccounts, "serve": scounts, "export": ecounts,
             "device preprocess": dcounts, "augment": acounts,
             "torch import": icounts, "dp step world 1": w1counts,
             "shard": shcounts, "training options": ocounts}
    for key, name in (("step_counts", "dp step"), ("eval_counts", "dp eval"),
                      ("trainer_counts", "dp CLI trainer")):
        for r in (0, 1):
            paths[f"{name} world 2 rank {r}"] = w2[key][r]
    for key, ranks in tpcounts.items():
        for r, c_ in enumerate(ranks):
            paths[f"{key} rank {r}"] = c_
    paths.update(nfcounts)
    paths.update(kacounts)
    paths["demo"] = decounts
    for p_ in (*nfcounts, *kacounts, "demo"):
        check(sum(paths[p_].get(k, 0) for k in cuda.KERNELS) > 0,
              f"the path {p_!r} launched no kernel")
    kernels = []
    for k in cuda.KERNELS:
        d = main_dtype[k]
        entry = {
            "name": k, "route": "cuda", "source": f"aocr_torch/csrc/{k}.cu",
            "replaces": replaces[k],
            "launches": sum(c_.get(k, 0) for c_ in paths.values()),
            "max_abs_err": max(results[(k, d)]), "dtype": d,
            "ms": ms[(k, d)][0], "plain_ms": ms[(k, d)][1],
            "bound_ms": bounds[(k, d)][0], "bound_by": bounds[(k, d)][1],
            "library_ms": lib.get((k, d)),
            "launches_by_path": {p_: c_.get(k, 0)
                                 for p_, c_ in paths.items()},
            # the DP step and eval at world size 2, each rank's launches
            "launches_dp": {"step": [c_[k] for c_ in w2["step_counts"]],
                            "eval": [c_[k] for c_ in w2["eval_counts"]]},
            # DP x TP (gloo, one card): each rank's launches a path
            "launches_tp": {key[3:]: [c_[k] for c_ in ranks]
                            for key, ranks in tpcounts.items()},
            # the training options' steps (bf16 and float32, 3 each)
            "launches_options": {o_: c_[k] for o_, c_ in oby.items()}}
        if k == "lstm_fwd":
            c = sum(c_.get("lstm_fwd_collect", 0) for c_ in paths.values())
            entry["redesigned"] = ("thread-block clusters, the Wh slice in "
                                   "shared memory, bf16 mma.sync")
            entry["modes"] = {
                "collect=False": {"launches": entry["launches"] - c},
                "collect=True": {
                    "launches": c,
                    "ms": ms[("lstm_fwd_collect", d)][0],
                    "plain_ms": ms[("lstm_fwd_collect", d)][1],
                    "bound_ms": bounds[("lstm_fwd_collect", d)][0],
                    "bound_by": bounds[("lstm_fwd_collect", d)][1],
                    "library_ms": lib.get(("lstm_fwd_collect", d))}}
        if k == "greedy_loop":
            entry["redesigned"] = ("thread-block clusters, the weight "
                                   "slices streamed, bf16 mma.sync")
            entry["batches"] = {
                str(B): {"ms": ms[(k, d, B)][0], "plain_ms": ms[(k, d, B)][1],
                         "bound_ms": bounds[(k, d, B)][0],
                         "f32_ms": ms[(k, "f32", B)][0],
                         "f32_plain_ms": ms[(k, "f32", B)][1]}
                for B in GREEDY_TIMED}
            entry["trie_88k_ms"] = ms[("greedy_loop_trie", d)]
            entry["all_eos_ms"] = ms[("greedy_loop_eos", d)]
        if k == "beam_loop":
            entry["redesigned"] = ("thread-block clusters on greedy_loop's "
                                   "design, the parent reorder as a "
                                   "permutation of each block's rows")
            entry["batches"] = {
                str(B): {"ms": ms[(k, d, B)][0], "plain_ms": ms[(k, d, B)][1],
                         "bound_ms": bounds[(k, d, B)][0],
                         "f32_ms": ms[(k, "f32", B)][0],
                         "f32_plain_ms": ms[(k, "f32", B)][1]}
                for B in BEAM_TIMED}
            entry["trie_88k_ms"] = ms[("beam_loop_trie", d)]
            entry["all_eos_ms"] = ms[("beam_loop_eos", d)]
        if k in ("tf_fwd", "tf_bwd"):
            entry["redesigned"] = ("thread-block clusters on greedy_loop's "
                                   "design" + (", the products split by "
                                   "output columns of the transposed "
                                   "weights" if k == "tf_bwd" else ""))
            entry["f32_ms"], entry["f32_plain_ms"] = ms[(k, "f32")]
            entry["pack_ms"] = ms[("tf_pack", d)][k == "tf_bwd"]
        if k == "tf_fwd":
            entry["score_batches"] = {
                str(B): {"ms": ms[("tf_fwd_score", d, B)][0],
                         "plain_ms": ms[("tf_fwd_score", d, B)][1],
                         "bound_ms": bounds[("tf_fwd_score", d, B)][0],
                         "f32_ms": ms[("tf_fwd_score", "f32", B)][0],
                         "f32_plain_ms": ms[("tf_fwd_score", "f32", B)][1]}
                for B in TF_TIMED}
        if k == "lstm_bwd":
            entry["redesigned"] = ("bf16: thread-block clusters, the Wh "
                                   "slice in shared memory, bf16 mma.sync, "
                                   "the product split by the contraction "
                                   "and its partials summed through L2; "
                                   "float32: the first port's rows route")
            # the plan's route at the train step's encoder, by dtype
            entry["routes"] = {
                dt_: lstm_bwd.ROUTE_NAMES[lstm_bwd.plans[
                    (tcfg.encoder_num_hidden, B_TRAIN, t_)][0].route]
                for dt_, t_ in (("bf16", torch.bfloat16),
                                ("f32", torch.float32))}
            entry["f32_ms"], entry["f32_plain_ms"] = ms[(k, "f32")]
        if k == "conv1_pool_bwd":
            entry["redesigned"] = ("the card's blocks on equal runs of "
                                   "cells, 4 channels a thread, the "
                                   "partials summed in a fixed tree in the "
                                   "same launch")
            entry["f32_ms"], entry["f32_plain_ms"] = ms[(k, "f32")]
        if k == "conv1_pool":
            entry["redesigned"] = ("bf16: each cell's 16-tap patch times "
                                   "W16 on the tensor cores (mma.sync "
                                   "m16n8k16); float32: the first port's "
                                   "arithmetic, 4 channels a thread; the "
                                   "card's blocks on runs of cells")
            entry["f32_ms"], entry["f32_plain_ms"] = ms[(k, "f32")]
        if k == "beam_step":
            entry["redesigned"] = ("thread-block clusters on beam_loop's "
                                   "design, tiles of whole batch rows with "
                                   "all K beams; the rows route where no "
                                   "plan fits")
            def bkey(K, d_):
                return ("beam_step", d_) if K == BEAM else (
                    "beam_step", d_, K)

            entry["beams"] = {
                str(K): {"ms": ms[bkey(K, d)][0],
                         "plain_ms": ms[bkey(K, d)][1],
                         "bound_ms": bounds[bkey(K, d)][0],
                         "f32_ms": ms[bkey(K, "f32")][0],
                         "f32_plain_ms": ms[bkey(K, "f32")][1]}
                for K in BEAM_STEP_K}
            entry["beam10_launches"] = b10counts[k]
        if k == "decode_step":
            entry["redesigned"] = ("thread-block clusters: beam_step's "
                                   "cluster step at K=1 with the greedy "
                                   "argmax, the weights packed once a "
                                   "decode; the rows route where no plan "
                                   "fits")
            entry["batches"] = {
                str(B): {"ms": ms[(k, d, B)][0], "plain_ms": ms[(k, d, B)][1],
                         "rows_route_ms": ms[("decode_step_rows", d, B)],
                         "bound_ms": bounds[(k, d, B)][0],
                         "bf16_ms": ms[(k, "bf16", B)][0],
                         "bf16_plain_ms": ms[(k, "bf16", B)][1],
                         "bf16_rows_route_ms": ms[("decode_step_rows",
                                                   "bf16", B)],
                         "bf16_bound_ms": bounds[(k, "bf16", B)][0]}
                for B in DECODE_TIMED}
            entry["trie_88k_ms"] = ms[("decode_step_trie", d)]
            entry["packing_call_ms"] = ms[("decode_step_call", d)]
        if k == "conv1_pool_dx":
            entry["redesigned"] = ("the card's blocks on equal runs of "
                                   "cells (conv1_pool_bwd's plan), 16 lanes "
                                   "a cell, 4 channels a lane, the taps "
                                   "from a table by winning position, the "
                                   "channels' sum in one fixed tree, bit "
                                   "for bit the plain version's")
            entry["bf16_ms"], entry["bf16_plain_ms"] = ms[(k, "bf16")]
        if k == "pool_bwd":
            entry["per"] = "one train step: the three pools, summed"
            entry["library"] = ("max_pool2d_with_indices_backward + "
                                "threshold_backward (two calls)")
        kernels.append(entry)
    log(f"end to end, bf16, B={B_SERVE}, W={W_SERVE}, T={T_MAX}: beam-5 "
        f"{rates['beam-5']:.1f} images/s, dictionary beam-5 "
        f"{rates['dict-beam-5']:.1f} images/s, beam-{BEAM_STEP_K[1]} "
        f"{rates[f'beam-{BEAM_STEP_K[1]}']:.1f} images/s on {card}")
    for dt in ("bfloat16", "float32"):
        r = sreadings[f"serve {dt}"]
        log(f"serve {dt}: " + ", ".join(
            f"{v:.1f} requests/s at {w}" for w, v in r["rps"].items())
            + f"; /recognize_batch {r['batch_ips']:.1f} images/s against a "
            f"direct recognize's {r['direct_ips']:.1f} on {card}")
    for tag, r in ereadings.items():
        log(f"export {tag}: {r['mb']:.1f} MB, trace {r['trace_s']:.1f} s, "
            f"load {r['load_s']:.1f} s, recognize B={B_SERVE} T={r['T']} "
            f"{r['ms']:.2f} ms against the live {r['live_ms']:.2f} ms on "
            f"{card}")
    for dt, (dms, ams) in w1ms.items():
        log(f"dp step world size 1 (NCCL) {dt} B={B_TRAIN}: {dms:.2f} ms "
            f"against make_train_step's {ams:.2f} ms on {card}")
    for ls, r in ireadings.items():
        log(f"t7 import {ls}-byte longs: {r['mb']:.1f} MB stream, "
            f"import_checkpoint {r['import_s']:.2f} s, the CLI "
            f"{r['cli_s']:.2f} s on {card}")
    on, off = ms[("enable_ab", "bf16")]
    log(f"bf16 train step B={B_TRAIN}: make_train_step "
        f"{ms[('train_step', 'bf16')]:.2f} ms; pool_bwd.ENABLE on {on:.2f} "
        f"ms, off {off:.2f} ms (best turns); CLI trainer "
        f"{readings['throughput']} on {card}")
    if FAILURES:
        print(f"chip_smoke.py: {len(FAILURES)} check(s) failed:\n  "
              + "\n  ".join(FAILURES), file=sys.stderr)
        return 1
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
