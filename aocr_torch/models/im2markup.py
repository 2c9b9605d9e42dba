"""im2markup on the port's pieces: the image-to-LaTeX model of Deng,
Kanervisto, Ling and Rush, "Image-to-Markup Generation with
Coarse-to-Fine Attention" (ICML 2017, arXiv:1609.04938), code at
https://github.com/harvardnlp/im2markup, in its standard-attention form.

    from aocr_torch.models import im2markup
    ocr = AttentionOCR.create(im2markup.config(compute_dtype="bfloat16"),
                              spec=im2markup.Spec())
    texts, scores = ocr.recognize(images)   # stacked (B, 160, 500) array

`Config` says what the two networks share (encoder_num_hidden 256 a
direction, one encoder layer, one decoder layer of 2 x 256 with input
feed, embedding 80, vocabulary, decode cap 150, 160 x 500 images,
compute dtype); `Spec` says what `Config` cannot:

- the CNN: six 3x3 convs (64, 128, 256, 256, 512, 512), pad 1, ReLU,
  eval BatchNorm after convs 3, 5 and 6, max-pools 2x2, 2x2, then 2x1
  (height) after conv 4 and 1x2 (width) after conv 5, floor division
  (src/model/cnn.lua); 160 x 500 leaves a 20 x 62 x 512 map, L = 1,240;
- the row encoder: a bidirectional LSTM run over each row of the map,
  each direction starting row r from a trainable (c, h) of its own, the
  r-th entry of a table of `max_rows` (the paper's positional embedding;
  model.lua's pos_embedding_fw / _bw); the context at (r, w) is [h_fw;
  h_bw], positions row-major;
- the decoder's start: zeros, not the encoder's finals (model.lua);
- the token vocabulary: `vocab_size` ids, PAD, GO, EOS and UNK first;
  a transcript is the tokens before the first EOS, PAD and GO dropped,
  joined by spaces.

The decoder, its attention (seq2seq-attn's general form, which the code
uses; the paper writes an additive one), the projector and every decode
route are the Attention-OCR model's (`decode.beam_decode` with
`encode=` this model's `encode`).  The CNN runs cuDNN convs, `BiasAddFn`
and the eval BatchNorm of models/cnn.py, and conv1 through the
`conv1_pool` kernel; the rows through the `lstm_fwd` kernel.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from aocr_torch import vocab
from aocr_torch.config import Config
from aocr_torch.models import cnn, decoder, encoder, head, model
from aocr_torch.ops import lstm
from aocr_torch.ops.cuda import conv1_pool
from aocr_torch.utils.tracing import span

# name, in_c, out_c, kernel, padding, bn, max-pool (h, w) after the ReLU
# or None (src/model/cnn.lua; Torch's SpatialMaxPooling(kW, kH) reversed)
CONV_DEFS = (
    ("conv1", 1, 64, 3, 1, False, (2, 2)),
    ("conv2", 64, 128, 3, 1, False, (2, 2)),
    ("conv3", 128, 256, 3, 1, True, None),
    ("conv4", 256, 256, 3, 1, False, (2, 1)),
    ("conv5", 256, 512, 3, 1, True, (1, 2)),
    ("conv6", 512, 512, 3, 1, True, None),
)
SPECIALS = ("<pad>", "<go>", "<eos>", "<unk>")
# the published settings that Config holds (src/train.lua's options and
# the README's training command)
PUBLISHED = dict(encoder_num_hidden=256, encoder_num_layers=1,
                 decoder_num_layers=1, target_embedding_size=80,
                 input_feed=True, max_decoder_l=150, image_height=160,
                 image_width=500, target_vocab_size=503)

CNN_SPAN = "aocr_torch.im2markup.cnn"
ROWS_SPAN = "aocr_torch.im2markup.rows"

# positions attended: the context length times each decoded row's steps
# (to its EOS or PAD, or the cap), summed over recognize calls
attended_positions = 0
_attended_lock = threading.Lock()


def attended_count() -> int:
    return attended_positions


def reset_attended_count() -> None:
    global attended_positions
    with _attended_lock:
        attended_positions = 0


def config(**kw) -> Config:
    """The port's Config at im2markup's published settings, `kw` over
    them (compute_dtype, a vocabulary size, ...)."""
    return Config(**{**PUBLISHED, **kw})


@dataclass(frozen=True)
class Spec:
    """What Config cannot say of im2markup (module docstring).  tokens:
    the names of ids 4.. (vocab_size - 4 of them), or () for t4, t5, ..."""
    convs: Tuple[tuple, ...] = CONV_DEFS
    max_rows: int = 20
    vocab_size: int = 503
    tokens: Tuple[str, ...] = ()

    def __post_init__(self):
        # tuples throughout, as a spec read back from JSON has lists
        object.__setattr__(self, "convs", tuple(
            (n, i, o, k, pad, bn, tuple(pool) if pool else None)
            for n, i, o, k, pad, bn, pool in self.convs))
        object.__setattr__(self, "tokens", tuple(self.tokens))
        if self.tokens and len(self.tokens) != self.vocab_size - len(SPECIALS):
            raise ValueError(f"{len(self.tokens)} token names for a "
                             f"vocabulary of {self.vocab_size}")

    def check(self, cfg: Config) -> None:
        if cfg.target_vocab_size != self.vocab_size:
            raise ValueError(f"Config's target_vocab_size "
                             f"{cfg.target_vocab_size} is not the spec's "
                             f"vocab_size {self.vocab_size}")
        if cfg.cnn_feature_size != self.convs[-1][2]:
            raise ValueError(f"Config's cnn_feature_size "
                             f"{cfg.cnn_feature_size} is not the last conv's "
                             f"{self.convs[-1][2]} channels")

    def feature_shape(self, height: int, width: int) -> Tuple[int, int]:
        """The CNN's (rows, columns) for an image of height x width."""
        h, w = height, width
        for _n, _i, _o, k, pad, _bn, pool in self.convs:
            h, w = h + 2 * pad - k + 1, w + 2 * pad - k + 1
            if pool:
                h, w = h // pool[0], w // pool[1]
        return h, w

    def context_length(self, height: int, width: int) -> int:
        h, w = self.feature_shape(height, width)
        return h * w

    def names(self) -> np.ndarray:
        """The token names by id."""
        rest = self.tokens or tuple(f"t{i}" for i in range(len(SPECIALS),
                                                          self.vocab_size))
        return np.array(SPECIALS + rest)

    def decode_batch(self, labels) -> List[str]:
        """(B, T) ids -> each row's tokens before its first EOS, PAD and GO
        dropped, joined by spaces; ValueError on an id outside the
        vocabulary before the EOS."""
        a = np.asarray(labels)
        if a.ndim != 2:
            raise ValueError(f"labels must be 2-D (B, T), got shape {a.shape}")
        a = a.astype(np.int64)
        live = vocab.live_mask(a)
        bad = live & ((a < 0) | (a >= self.vocab_size))
        if bad.any():
            r, c = np.argwhere(bad)[0]
            raise ValueError(f"id {int(a[r, c])} is not a vocabulary id")
        keep = live & (a > vocab.GO)
        names = self.names()
        return [" ".join(names[row[k]].tolist()) for row, k in zip(a, keep)]


def count_attended(labels, L: int) -> None:
    """Add L x the decoded steps of each row of labels (B, T): to its
    first EOS or PAD (that step included), or T."""
    global attended_positions
    a = np.asarray(labels)
    stop = (a == vocab.EOS) | (a == vocab.PAD)
    steps = np.where(stop.any(1), stop.argmax(1) + 1, a.shape[1])
    with _attended_lock:
        attended_positions += int(L) * int(steps.sum())


def init(cfg: Config, spec: Spec, gen: torch.Generator, device="cpu"
         ) -> Tuple[dict, dict]:
    """Random (params, batch_stats) from `gen`: convs and LSTMs
    uniform(+-1/sqrt(fan_in)), BatchNorm scale 1 and shift 0, the row
    start table and the embedding normal(0, 1) (Torch's LookupTable), the
    decoder and projector as the Attention-OCR model's."""
    spec.check(cfg)
    cp, stats = {}, {}
    for name, i, o, k, _pad, bn, _pool in spec.convs:
        b = 1.0 / math.sqrt(i * k * k)
        cp[name] = {"w": ((torch.rand(o, i, k, k, generator=gen) * 2 - 1)
                          * b).to(device),
                    "b": ((torch.rand(o, generator=gen) * 2 - 1) * b
                          ).to(device)}
        if bn:
            cp[name + "_bn"] = {"scale": torch.ones(o, device=device),
                                "bias": torch.zeros(o, device=device)}
            stats[name + "_bn"] = {"mean": torch.zeros(o, device=device),
                                   "var": torch.ones(o, device=device)}
    He, nl = cfg.encoder_num_hidden, cfg.encoder_num_layers
    params = {"cnn": cp}
    for d in ("encoder_fw", "encoder_bw"):
        params[d] = encoder.init_params(gen, cfg.cnn_feature_size, He, nl,
                                        device)
        params[d]["rows"] = {
            s: torch.randn(nl, spec.max_rows, He, generator=gen).to(device)
            for s in ("c", "h")}
    params["decoder"] = decoder.init_params(
        gen, cfg.target_vocab_size, cfg.target_embedding_size,
        cfg.decoder_num_hidden, cfg.decoder_num_layers, cfg.input_feed,
        device)
    params["projector"] = head.init_params(gen, cfg.decoder_num_hidden,
                                           cfg.target_vocab_size, device)
    return params, stats


def _conv1_pool_applies(idx: int, conv: tuple) -> bool:
    """Whether the `conv1_pool` kernel computes this conv: the first, a
    1-channel 3x3 pad-1 conv to 64 channels, no BatchNorm, a 2x2 pool."""
    _n, i, o, k, pad, bn, pool = conv
    return (idx == 0 and (i, o, k, pad) == (1, conv1_pool.C1, 3, 1)
            and not bn and tuple(pool or ()) == (2, 2))


def features(p: dict, batch_stats: dict, images: torch.Tensor, spec: Spec,
             cd: torch.dtype, use_kernel: bool) -> torch.Tensor:
    """images (B, H, W, 1) float32 in [0, 255] -> the map (B, C, Hf, Wf)
    in the compute dtype, eval BatchNorm."""
    x = ((images - 128.0) / 128.0).to(cd)
    for idx, conv in enumerate(spec.convs):
        name, _i, _o, _k, pad, bn, pool = conv
        if use_kernel and _conv1_pool_applies(idx, conv):
            x = cnn.Conv1PoolFn.apply(x, p[name]["w"], p[name]["b"]
                                      ).permute(0, 3, 1, 2)
            continue
        if idx == 0:
            x = x.permute(0, 3, 1, 2)
        x = F.conv2d(x, p[name]["w"].to(cd), padding=pad)
        x = cnn.BiasAddFn.apply(x, p[name]["b"])
        if bn:
            x = cnn._bn_eval(x, p[name + "_bn"], batch_stats[name + "_bn"])
        x = torch.relu(x)
        if pool:
            x = F.max_pool2d(x, tuple(pool))
    return x


def rows(enc_fw: dict, enc_bw: dict, x: torch.Tensor, cd: torch.dtype,
         use_kernel: bool) -> torch.Tensor:
    """The row encoder over the map x (B, C, Hf, Wf): B x Hf sequences of
    Wf steps, each direction's layer k starting row r from its rows
    table's entry (k, r).  Returns the context (B, Hf x Wf, 2He), a view
    of a position-major (L, B, 2He) buffer, as encoder.apply's."""
    B, C, Hf, Wf = x.shape
    seqs = x.permute(0, 2, 3, 1).reshape(B * Hf, Wf, C)
    outs = []
    for params, reverse in ((enc_fw, False), (enc_bw, True)):
        if Hf > params["rows"]["c"].shape[1]:
            raise ValueError(f"im2markup: {Hf} feature rows, but the row "
                             f"encoder starts {params['rows']['c'].shape[1]}")
        hs = seqs
        for k, layer in enumerate(params["layers"]):
            # sequence b * Hf + r is row r of image b
            c0 = params["rows"]["c"][k, :Hf].repeat(B, 1)
            h0 = params["rows"]["h"][k, :Hf].repeat(B, 1)
            hs, _ = lstm.unidirectional_scan(layer, hs, c0, h0, reverse, cd,
                                             use_kernel)
        outs.append(hs.transpose(0, 1))  # scan-major (Wf, B * Hf, He)
    ctx = torch.cat(outs, dim=-1)
    ctx = ctx.view(Wf, B, Hf, -1).permute(2, 0, 1, 3).reshape(Hf * Wf, B, -1)
    return ctx.transpose(0, 1)


def encode(params: dict, batch_stats: dict, images: torch.Tensor,
           cfg: Config, spec: Spec):
    """images (B, H, W[, 1]) -> (context (B, L, 2He), dec_init (c0, h0)
    zeros (B, 2He) float32), the signature of model.encode; under a
    profiler the spans aocr_torch.im2markup.cnn and .rows."""
    cd = model.compute_dtype(cfg)
    if images.dim() == 3:
        images = images[..., None]
    with span(CNN_SPAN):
        x = features(params["cnn"], batch_stats, images, spec, cd,
                     cfg.use_pallas)
    with span(ROWS_SPAN):
        context = rows(params["encoder_fw"], params["encoder_bw"], x, cd,
                       cfg.use_pallas)
    z = torch.zeros((context.shape[0], cfg.decoder_num_hidden),
                    dtype=torch.float32, device=context.device)
    return context, (z, z)
