"""im2markup's inputs and weights made from the seed: the same seed gives
the same images and weights on both sides of a comparison.

Weights: the init laws of models/im2markup.py (uniform +-1/sqrt(fan_in)
for convs, LSTMs, attention and projector; normal(0, 1) for the
embedding and the row start tables, Torch's LookupTable), with inputs.py's
gain of 2 on the conv weights and the projector, drawn on the device by
one `torch.Generator` in two calls (one uniform, one normal) and cut into
leaves; conv weights in PyTorch's (O, I, k, k) layout, which the
reference takes as it is.  Images: typeset-formula crops, dark glyph
boxes of random size and ink along one to three baselines, with fraction
bars, on white.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import inputs

SPECIALS = 4  # PAD, GO, EOS, UNK


def token_names(V: int) -> list:
    """The names of ids 4..V-1: the synthetic vocabulary (im2markup's
    LaTeX vocabulary file is not in this repository)."""
    return [f"s{i}" for i in range(SPECIALS, V)]


def _uniform_leaves(cfg: dict, spec: dict):
    """(path, shape, bound, gain) of every uniform-law leaf, in order."""
    out = []
    for name, i, o, k, _pad, _bn, _pool in spec["convs"]:
        b = 1.0 / math.sqrt(i * k * k)
        out.append((("cnn", name, "w"), (o, i, k, k), b, 2.0))
        out.append((("cnn", name, "b"), (o,), b, 1.0))
    He, Hd = cfg["encoder_num_hidden"], 2 * cfg["encoder_num_hidden"]
    E, V = cfg["target_embedding_size"], cfg["target_vocab_size"]
    D = spec["convs"][-1][2]

    def layer(prefix, i, h):
        return [(prefix + ("wi",), (i, 4 * h), 1 / math.sqrt(i), 1.0),
                (prefix + ("bi",), (4 * h,), 1 / math.sqrt(i), 1.0),
                (prefix + ("wh",), (h, 4 * h), 1 / math.sqrt(h), 1.0),
                (prefix + ("bh",), (4 * h,), 1 / math.sqrt(h), 1.0)]

    for d in ("encoder_fw", "encoder_bw"):
        for k in range(cfg["encoder_num_layers"]):
            out += layer((d, "layers", k), D if k == 0 else He, He)
    for k in range(cfg["decoder_num_layers"]):
        i = (E + Hd * bool(cfg["input_feed"])) if k == 0 else Hd
        out += layer(("decoder", "layers", k), i, Hd)
    out.append((("decoder", "w_a"), (Hd, Hd), 1 / math.sqrt(Hd), 1.0))
    out.append((("decoder", "w_c"), (2 * Hd, Hd), 1 / math.sqrt(2 * Hd), 1.0))
    out.append((("projector", "w"), (Hd, V), 1 / math.sqrt(Hd), 2.0))
    out.append((("projector", "b"), (V,), 1 / math.sqrt(Hd), 1.0))
    return out


def _normal_leaves(cfg: dict, spec: dict):
    nl, He = cfg["encoder_num_layers"], cfg["encoder_num_hidden"]
    out = [(("decoder", "embedding"),
            (cfg["target_vocab_size"], cfg["target_embedding_size"]))]
    for d in ("encoder_fw", "encoder_bw"):
        for s in ("c", "h"):
            out.append(((d, "rows", s), (nl, spec["max_rows"], He)))
    return out


def make_weights(cfg_file: dict, seed: int, device, never_emitted=()):
    """(params, batch_stats), float32 tensors on `device`, from `seed`, for
    the configuration file's `config` and `spec`; the projector's bias of
    the tokens named in never_emitted at inputs.NEVER_EMITTED_BIAS."""
    cfg, spec = cfg_file["config"], cfg_file["spec"]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    uni, nor = _uniform_leaves(cfg, spec), _normal_leaves(cfg, spec)
    u = torch.rand(sum(math.prod(s) for _p, s, _b, _g in uni),
                   generator=gen, device=device)
    z = torch.randn(sum(math.prod(s) for _p, s in nor), generator=gen,
                    device=device)
    params: dict = {}
    off = 0
    for path, shape, bound, gain in uni:
        n = math.prod(shape)
        inputs._put(params, path,
                    (u[off:off + n].view(shape) * 2 - 1) * (bound * gain))
        off += n
    off = 0
    for path, shape in nor:
        n = math.prod(shape)
        inputs._put(params, path, z[off:off + n].view(shape).clone())
        off += n
    params["projector"]["b"][[inputs.TOKENS[t] for t in never_emitted]] = \
        inputs.NEVER_EMITTED_BIAS
    stats = {}
    for name, _i, o, _k, _pad, bn, _pool in spec["convs"]:
        if bn:
            params["cnn"][name + "_bn"] = {
                "scale": torch.ones(o, device=device),
                "bias": torch.zeros(o, device=device)}
            stats[name + "_bn"] = {"mean": torch.zeros(o, device=device),
                                   "var": torch.ones(o, device=device)}
    return params, stats


def formula_images(rng: np.random.Generator, n: int, height: int,
                   width: int) -> np.ndarray:
    """n (height, width) float32 images in [0, 255]: one to three lines of
    dark glyph boxes (random width, height and ink), some fraction bars,
    on white; a different layout each."""
    imgs = np.full((n, height, width), 255.0, np.float32)
    for img in imgs:
        lines = int(rng.integers(1, 4))
        for base in np.sort(rng.integers(height // 5, height - 4, lines)):
            g = int(rng.integers(8, 40))
            xs = np.sort(rng.integers(0, width - 8, g))
            ws = rng.integers(2, 9, g)
            hs = rng.integers(4, min(24, base) + 1, g)
            ink = rng.uniform(0, 90, g)
            for x, w, h, v in zip(xs, ws, hs, ink):
                img[base - h:base, x:x + w] = v
            if rng.random() < 0.5:
                x0, x1 = np.sort(rng.integers(0, width, 2))
                img[max(base - 28, 0):max(base - 27, 1), x0:x1 + 1] = 0.0
    return imgs
