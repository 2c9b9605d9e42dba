"""Operations and bytes of the network's parts, from shapes, and the
H100's peaks: the yardstick that the roofline and MFU readers divide by.

Frozen from chip_smoke.py (`PEAK_FLOPS`, `PEAK_BYTES`, `bound`,
`step_flops`), with `step_flops` repaired: decoder layer 0 reads the
embedding too, so its input is E + H (+ H with input feed) wide.  A
kernel given the embedding's projection as a table (greedy_loop,
beam_loop, tf_fwd's hoisted xp) does not compute it, so its count takes
`embed=False`.  Operations are 2 per multiply-add.  Work that depends on
the data is counted for what these inputs need: a row's steps up to its
EOS (or T), never the most a kernel could run.  Bytes count each input
read once and each output written once, at the narrowest dtype a tensor
could have, so that a bound is never too high.
"""

from __future__ import annotations

from .inputs import CONV_DEFS

# NVIDIA's H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
ITEM = {"bfloat16": 2, "float32": 4}


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: the larger of the operations
    over the dtype's peak and the bytes over 3.35 TB/s."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)


def step_flops(H: int, L: int, V: int, E: int, nl: int, input_feed: bool,
               embed: bool = True, proj: bool = True) -> float:
    """One decoder row step: the LSTM stack's gate products (layer 0 over
    [emb; h~; h] or [emb; h], the others over [x; h]), q = W_a h, the
    scores and context vector over L, W_c [ctx; h], and the projector."""
    k0 = (E if embed else 0) + (H if input_feed else 0) + H
    f = 2 * 4 * H * (k0 + (nl - 1) * 2 * H)
    f += 2 * H * H + 4 * L * H + 2 * 2 * H * H
    if proj:
        f += 2 * H * V
    return float(f)


def cnn_flops(width: int, height: int = 32) -> float:
    """One image through the 7 convs (pools after convs 1, 2, 4, 6)."""
    pools = {0: (2, 2), 1: (2, 2), 3: (2, 1), 5: (2, 1)}
    h, w, f = height, width, 0.0
    for idx, (_n, i, o, kh, kw, pad, _bn) in enumerate(CONV_DEFS):
        if pad == "VALID":
            h, w = h - kh + 1, w - kw + 1
        f += 2.0 * kh * kw * i * o * h * w
        ph, pw = pools.get(idx, (1, 1))
        h, w = h // ph, w // pw
    return f


def context_length(width: int) -> int:
    return width // 4 - 1


def encoder_flops(L: int, D: int, He: int, layers: int = 1) -> float:
    """One image through both directions of the bidirectional LSTM."""
    f = 0.0
    for k in range(layers):
        f += 2 * L * 2.0 * 4 * He * ((D if k == 0 else He) + He)
    return f


def dims(cfg: dict, width: int) -> dict:
    He = cfg["encoder_num_hidden"]
    return {"H": 2 * He, "He": He, "L": context_length(width),
            "V": cfg["target_vocab_size"], "E": cfg["target_embedding_size"],
            "nl": cfg["decoder_num_layers"], "input_feed": cfg["input_feed"],
            "enc_layers": cfg["encoder_num_layers"]}


def forward_flops(cfg: dict, width: int, row_steps) -> float:
    """The model's forward pass over len(row_steps) images, row i taking
    row_steps[i] decoder steps (beam rows: beams x steps)."""
    d = dims(cfg, width)
    per_image = cnn_flops(width) + encoder_flops(d["L"], 512, d["He"],
                                                 d["enc_layers"])
    sf = step_flops(d["H"], d["L"], d["V"], d["E"], d["nl"], d["input_feed"])
    return len(row_steps) * per_image + sf * float(sum(row_steps))


def loop_flops(cfg: dict, width: int, beam_steps: float) -> float:
    """greedy_loop or beam_loop: beam_steps row steps (all beams counted)
    of the decoder step with the projector, the embedding from a table."""
    d = dims(cfg, width)
    return beam_steps * step_flops(d["H"], d["L"], d["V"], d["E"], d["nl"],
                                   d["input_feed"], embed=False)


def loop_bytes(cfg: dict, width: int, B: int, K: int, T: int,
               dtype: str) -> float:
    """greedy_loop (K=1) or beam_loop: the context, the decoder's and the
    projector's weights, the start state in; labels (and parents) and
    scores out."""
    d = dims(cfg, width)
    H, V, nl, c = d["H"], d["V"], d["nl"], ITEM[dtype]
    k0 = (H if d["input_feed"] else 0) + H
    w = V * 4 * H + k0 * 4 * H + (nl - 1) * 2 * H * 4 * H + 3 * H * H + H * V
    ins = d["L"] * B * H * c + w * c + 2 * B * H * 4
    outs = B * K * T * 4 * (1 if K == 1 else 2) + B * K * 4
    return float(ins + outs)


def tf_flops(cfg: dict, width: int, needed_steps: float) -> float:
    """tf_fwd, or tf_bwd (the transposed products of the same step):
    needed_steps row steps of the decoder step without the projector and
    without the embedding's product (hoisted into xp)."""
    d = dims(cfg, width)
    return needed_steps * step_flops(d["H"], d["L"], d["V"], d["E"], d["nl"],
                                     d["input_feed"], embed=False, proj=False)


def tf_bytes(cfg: dict, width: int, B: int, T: int, dtype: str) -> float:
    """tf_fwd's (and, as a floor, tf_bwd's) traffic: xp, the context and
    the weights in; the residual stacks (h~, each layer's h, c and four
    gates) out."""
    d = dims(cfg, width)
    H, nl, c = d["H"], d["nl"], ITEM[dtype]
    k0 = (H if d["input_feed"] else 0) + H
    w = k0 * 4 * H + (nl - 1) * 2 * H * 4 * H + 3 * H * H
    ins = T * B * 4 * H * c + d["L"] * B * H * c + w * c
    outs = T * B * H * c * (1 + nl * 6)
    return float(ins + outs)


def lstm_bwd_flops(L: int, B: int, He: int) -> float:
    """One direction's backward recurrence: dgates (4He) times Wh^T a row
    step."""
    return 2.0 * L * B * 4 * He * He


def lstm_bwd_bytes(L: int, B: int, He: int, dtype: str) -> float:
    """Wh, the h cotangents, the stored gates and cells in; the gate
    cotangents out."""
    c = ITEM[dtype]
    return float(He * 4 * He * c + L * B * He * 4 + L * B * 4 * He * c
                 + L * B * He * 4 + L * B * 4 * He * 4)
