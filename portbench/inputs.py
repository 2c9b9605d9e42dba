"""Inputs and weights made from the seed: the same seed gives the same
images, labels and weights, on both sides of a comparison.

Frozen copies of chip_smoke.py's `numpy_model` init laws, `word_images`
and `synthetic_lexicon`'s word-length law, with two changes: the weights
are drawn on the device by one `torch.Generator` in two calls (one
uniform, one normal) and cut into leaves, and the host draws use numpy's
`Generator` (any whole seed, wider than 32 bits).
"""

from __future__ import annotations

import math

import numpy as np
import torch

# name, in_c, out_c, kh, kw, padding, bn (the reference network's CNN,
# SURVEY.md "Config"; the port's models/cnn.py holds the same table)
CONV_DEFS = (
    ("conv1", 1, 64, 3, 3, "SAME", False),
    ("conv2", 64, 128, 3, 3, "SAME", False),
    ("conv3", 128, 256, 3, 3, "SAME", True),
    ("conv4", 256, 256, 3, 3, "SAME", False),
    ("conv5", 256, 512, 3, 3, "SAME", True),
    ("conv6", 512, 512, 3, 3, "SAME", False),
    ("conv7", 512, 512, 2, 2, "VALID", True),
)
PAD, GO, EOS = 0, 1, 2
TOKENS = {"PAD": PAD, "GO": GO, "EOS": EOS}
CHARS = "0123456789abcdefghijklmnopqrstuvwxyz"  # ids 3..38
# The projector's bias of each token a traffic mix names `never_emitted`.
# A trained model never emits PAD or GO: neither is ever a target (PAD
# targets carry no loss), so training drives both logits far down; with
# them out, every transcript is a plain reading of the tokens emitted.
# Recognition mixes also hold EOS out, so that every row decodes to the
# cap whatever the seed: the early exit's worst case, the same work on
# every seed.
NEVER_EMITTED_BIAS = -30.0


def host_rng(seed: int, stream: int) -> np.random.Generator:
    """numpy draws of one seed, one stream for each use."""
    return np.random.Generator(np.random.PCG64([stream, seed]))


def _leaves(cfg: dict):
    """(path, shape, bound, gain) of every uniform-law leaf, in a fixed
    order: the reference's init laws (uniform +-1/sqrt(fan_in)), with a
    gain of 2 on the conv weights and the projector so that transcripts
    depend on the image.  The recurrent weights keep the plain law: with
    larger gains the random decoder turns chaotic."""
    out = []
    for name, i, o, kh, kw, _pad, _bn in CONV_DEFS:
        b = 1.0 / math.sqrt(i * kh * kw)
        out.append((("cnn", name, "w"), (kh, kw, i, o), b, 2.0))
        out.append((("cnn", name, "b"), (o,), b, 1.0))
    He, Hd = cfg["encoder_num_hidden"], 2 * cfg["encoder_num_hidden"]
    E, V = cfg["target_embedding_size"], cfg["target_vocab_size"]

    def layer(prefix, i, h):
        return [(prefix + ("wi",), (i, 4 * h), 1 / math.sqrt(i), 1.0),
                (prefix + ("bi",), (4 * h,), 1 / math.sqrt(i), 1.0),
                (prefix + ("wh",), (h, 4 * h), 1 / math.sqrt(h), 1.0),
                (prefix + ("bh",), (4 * h,), 1 / math.sqrt(h), 1.0)]

    for d in ("encoder_fw", "encoder_bw"):
        for k in range(cfg["encoder_num_layers"]):
            out += layer((d, "layers", k), 512 if k == 0 else He, He)
    for k in range(cfg["decoder_num_layers"]):
        i = (E + Hd * bool(cfg["input_feed"])) if k == 0 else Hd
        out += layer(("decoder", "layers", k), i, Hd)
    out.append((("decoder", "w_a"), (Hd, Hd), 1 / math.sqrt(Hd), 1.0))
    out.append((("decoder", "w_c"), (2 * Hd, Hd), 1 / math.sqrt(2 * Hd), 1.0))
    out.append((("projector", "w"), (Hd, V), 1 / math.sqrt(Hd), 2.0))
    out.append((("projector", "b"), (V,), 1 / math.sqrt(Hd), 1.0))
    return out


def _put(tree: dict, path, value) -> None:
    for k in path[:-1]:
        if isinstance(k, int):
            while len(tree) <= k:
                tree.append({})
            tree = tree[k]
        else:
            tree = tree.setdefault(k, [] if k == "layers" else {})
    tree[path[-1]] = value


def make_weights(cfg: dict, seed: int, device, never_emitted=()) -> tuple:
    """(params, batch_stats) in the reference layout (conv weights (kh, kw,
    I, O)), float32 tensors on `device`, from `seed`; the projector's bias
    of the tokens named in never_emitted at NEVER_EMITTED_BIAS."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    leaves = _leaves(cfg)
    total = sum(math.prod(s) for _p, s, _b, _g in leaves)
    u = torch.rand(total, generator=gen, device=device)
    V, E = cfg["target_vocab_size"], cfg["target_embedding_size"]
    emb = torch.randn(V, E, generator=gen, device=device)
    params: dict = {"decoder": {"embedding": emb}}
    off = 0
    for path, shape, bound, gain in leaves:
        n = math.prod(shape)
        _put(params, path, (u[off:off + n].view(shape) * 2 - 1) * (bound * gain))
        off += n
    params["projector"]["b"][[TOKENS[t] for t in never_emitted]] = \
        NEVER_EMITTED_BIAS
    stats = {}
    for name, _i, o, _kh, _kw, _pad, bn in CONV_DEFS:
        if bn:
            params["cnn"][name + "_bn"] = {
                "scale": torch.ones(o, device=device),
                "bias": torch.zeros(o, device=device)}
            stats[name + "_bn"] = {"mean": torch.zeros(o, device=device),
                                   "var": torch.ones(o, device=device)}
    return params, stats


def clone_tree(tree):
    """A copy of a nested dict/list of tensors."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone_tree(v) for v in tree]
    return tree.clone()


def word_images(rng: np.random.Generator, n: int, width: int,
                height: int = 32) -> np.ndarray:
    """n (height, width) float32 images in [0, 255]: dark vertical strokes
    of random position, width and ink on white, a different layout each."""
    imgs = np.full((n, height, width), 255.0, np.float32)
    for img in imgs:
        for _ in range(rng.integers(2, 9)):
            x = rng.integers(0, width - 3)
            w = rng.integers(1, 4)
            y0, y1 = sorted(rng.integers(4, height - 3, 2))
            img[y0:y1 + 2, x:x + w] = rng.uniform(0, 90)
    return imgs


def word_lengths(rng: np.random.Generator, n: int, law: dict) -> np.ndarray:
    """n word lengths by the synthetic lexicon's law: int(gamma(shape,
    scale)) clipped to [min, max]."""
    g = rng.gamma(law["shape"], law["scale"], n).astype(np.int64)
    return np.clip(g, law["min"], law["max"])


def words(rng: np.random.Generator, n: int, law: dict) -> list:
    """n random lowercase words, lengths by word_lengths."""
    letters = np.array(list(CHARS[10:]))
    return ["".join(rng.choice(letters, size=int(k)))
            for k in word_lengths(rng, n, law)]


def encode_batch(labels) -> tuple:
    """(targets, targets_eval) int64 (B, T): [GO, c1..cn] and [c1..cn,
    EOS], PAD after, T the longest label + 1 (the trainer's padding)."""
    ids = [[CHARS.index(c) + 3 for c in s] for s in labels]
    T = max(len(s) for s in ids) + 1
    tg = np.full((len(ids), T), PAD, np.int64)
    te = np.full((len(ids), T), PAD, np.int64)
    for i, s in enumerate(ids):
        tg[i, :len(s) + 1] = [GO] + s
        te[i, :len(s) + 1] = s + [EOS]
    return tg, te
