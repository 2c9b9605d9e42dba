"""The plain reference of im2markup (Deng, Kanervisto, Ling and Rush,
"Image-to-Markup Generation with Coarse-to-Fine Attention", ICML 2017;
https://github.com/harvardnlp/im2markup), standard attention, in plain
float32 PyTorch: no kernel, no cache, no batching tricks, and nothing of
the program imported.  Every public function runs with TF32 off
(cuBLAS's and cuDNN's), restored after.

The network, as src/model/cnn.lua and model.lua have it: (x - 128) / 128;
3x3 convs, pad 1, each followed by BatchNorm (eval: running statistics)
where the layer list says, a ReLU and the max-pool it names, floor
division; each row r of the map read left to right and right to left by
an LSTM (gates [i|f|o|g]) that starts from the r-th (c, h) of its
direction's table; the context at (r, w) is [h_fw; h_bw], positions
row-major; a decoder from zeros, layer 0 fed [emb(token); h~] (input
feed), attention in seq2seq-attn's general form (scores = context W_a h,
which the code uses; the paper writes an additive form), h~ = tanh(W_c
[ctx; h]), log-softmax over the projector.  Greedy decoding freezes a row
after EOS (or PAD): PAD at no cost.  Beam search keeps that freeze, stops
a batch row when all its beams are frozen and returns the best beam by
raw score.

Weights in the program's layout (conv weights (O, I, k, k)); the layer
list as `convs`, (name, in, out, k, pad, bn, pool (h, w) or None).  `q`
rounds a product's operands: float32 as they are by default; a control
passes a lower precision's rounding.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

PAD, GO, EOS = 0, 1, 2
BN_EPS = 1e-5


def f32(x: torch.Tensor) -> torch.Tensor:
    return x.float()


def no_tf32(fn):
    @functools.wraps(fn)
    def run(*args, **kw):
        mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
        saved = (mm.allow_tf32, dnn.allow_tf32)
        mm.allow_tf32 = dnn.allow_tf32 = False
        try:
            return fn(*args, **kw)
        finally:
            mm.allow_tf32, dnn.allow_tf32 = saved
    return run


def cnn(p: dict, stats: dict, images: torch.Tensor, convs, q=f32):
    """images (B, H, W) in [0, 255] -> the map (B, C, Hf, Wf)."""
    x = ((images.float() - 128.0) / 128.0)[:, None]
    for name, _i, _o, _k, pad, bn, pool in convs:
        x = F.conv2d(q(x), q(p[name]["w"]), padding=pad) \
            + p[name]["b"][:, None, None]
        if bn:
            g, st = p[name + "_bn"], stats[name + "_bn"]
            x = ((x - st["mean"][:, None, None])
                 * torch.rsqrt(st["var"] + BN_EPS)[:, None, None]
                 * g["scale"][:, None, None] + g["bias"][:, None, None])
        x = torch.relu(x)
        if pool:
            x = F.max_pool2d(x, tuple(pool))
    return x


def lstm_cell(gates, c):
    i, f, o, g = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return c, torch.sigmoid(o) * torch.tanh(c)


def lstm_layer(layer: dict, xs, c, h, reverse: bool, q=f32):
    """xs (N, W, D) from the start (c, h) (N, H) -> hs (N, W, H)."""
    W = xs.shape[1]
    hs = [None] * W
    for t in (range(W - 1, -1, -1) if reverse else range(W)):
        gates = (q(xs[:, t]) @ q(layer["wi"]) + layer["bi"]
                 + q(h) @ q(layer["wh"]) + layer["bh"])
        c, h = lstm_cell(gates, c)
        hs[t] = h
    return torch.stack(hs, 1)


def row_encoder(enc: dict, x: torch.Tensor, reverse: bool, q=f32):
    """One direction over every row of the map x (B, C, Hf, Wf), row r
    from its table entry: (B, Hf, Wf, He)."""
    B, _C, Hf, _Wf = x.shape
    out = []
    for r in range(Hf):
        hs = x[:, :, r].transpose(1, 2)  # (B, Wf, C)
        for k, layer in enumerate(enc["layers"]):
            c0 = enc["rows"]["c"][k, r].expand(B, -1)
            h0 = enc["rows"]["h"][k, r].expand(B, -1)
            hs = lstm_layer(layer, hs, c0, h0, reverse, q)
        out.append(hs)
    return torch.stack(out, 1)


@no_tf32
def encode(params: dict, stats: dict, images: torch.Tensor, convs, q=f32):
    """images (B, H, W) -> context (B, Hf * Wf, 2He)."""
    x = cnn(params["cnn"], stats, images, convs, q)
    fw = row_encoder(params["encoder_fw"], x, False, q)
    bw = row_encoder(params["encoder_bw"], x, True, q)
    ctx = torch.cat([fw, bw], -1)
    return ctx.reshape(ctx.shape[0], -1, ctx.shape[-1])


class Decoder:
    """The decoder's state over rows, from zeros: h~ and each layer's (c,
    h)."""

    def __init__(self, params: dict, rows: int, input_feed: bool, q=f32,
                 device=None):
        self.p, self.input_feed, self.q = params, input_feed, q
        d = params["decoder"]
        z = torch.zeros(rows, d["w_a"].shape[0], device=device)
        self.attn = z
        self.cs = [z] * len(d["layers"])
        self.hs = [z] * len(d["layers"])

    def step(self, tokens, context):
        """Feed tokens (R,), attend over context (R, L, H): log-probs (R,
        V), and the state moves on."""
        d, q = self.p["decoder"], self.q
        x = d["embedding"][tokens.long()]
        if self.input_feed:
            x = torch.cat([x, self.attn], -1)
        for k, layer in enumerate(d["layers"]):
            gates = (q(x) @ q(layer["wi"]) + layer["bi"]
                     + q(self.hs[k]) @ q(layer["wh"]) + layer["bh"])
            self.cs[k], self.hs[k] = lstm_cell(gates, self.cs[k])
            x = self.hs[k]
        query = q(x) @ q(d["w_a"])
        scores = (q(context) @ q(query)[:, :, None])[:, :, 0]
        alpha = torch.softmax(scores, -1)
        ctx = (q(alpha)[:, None] @ q(context))[:, 0]
        self.attn = torch.tanh(q(torch.cat([ctx, x], -1)) @ q(d["w_c"]))
        proj = self.p["projector"]
        return torch.log_softmax(q(self.attn) @ q(proj["w"]) + proj["b"],
                                 -1)

    def take(self, rows):
        self.attn = self.attn[rows]
        self.cs = [c[rows] for c in self.cs]
        self.hs = [h[rows] for h in self.hs]


@no_tf32
def teacher_forced(params: dict, context, tokens_in, input_feed: bool,
                   q=f32):
    """Log-probs (B, T, V) of each step fed tokens_in (B, T)."""
    dec = Decoder(params, context.shape[0], input_feed, q, context.device)
    return torch.stack([dec.step(tokens_in[:, t], context)
                        for t in range(tokens_in.shape[1])], 1)


@no_tf32
def greedy(params: dict, context, input_feed: bool, T: int, q=f32,
           wrong_at=None):
    """(tokens (B, T) int64, PAD after EOS; scores (B,)).  wrong_at (B,),
    a fault: the step at which each row takes its runner-up, with its own
    log-prob."""
    B, dev = context.shape[0], context.device
    dec = Decoder(params, B, input_feed, q, dev)
    prev = torch.full((B,), GO, dtype=torch.long, device=dev)
    toks = torch.full((B, T), PAD, dtype=torch.long, device=dev)
    scores = torch.zeros(B, device=dev)
    for t in range(T):
        frozen = (prev == PAD) | (prev == EOS)
        if t > 0 and bool(frozen.all()):
            break
        lp = dec.step(prev, context)
        lp[:, PAD] = torch.where(frozen, 0.0, lp[:, PAD])
        best, tok = lp.max(-1)
        if wrong_at is not None:
            top2, tok2 = lp.topk(2, -1)
            wrong = wrong_at == t
            best = torch.where(wrong, top2[:, 1], best)
            tok = torch.where(wrong, tok2[:, 1], tok)
        tok = torch.where(frozen, PAD, tok)
        scores = scores + torch.where(frozen, 0.0, best)
        toks[:, t] = prev = tok
    return toks, scores


@no_tf32
def beam(params: dict, context, input_feed: bool, T: int, K: int, q=f32):
    """Beam search: (best tokens (B, T) int64, best scores (B,))."""
    B, dev = context.shape[0], context.device
    V = params["projector"]["b"].shape[0]
    dec = Decoder(params, B, input_feed, q, dev)
    lp = dec.step(torch.full((B,), GO, dtype=torch.long, device=dev), context)
    scores, toks = torch.sort(lp, dim=-1, descending=True, stable=True)
    scores, prev = scores[:, :K].contiguous(), toks[:, :K].contiguous()
    dec.take(torch.arange(B, device=dev).repeat_interleave(K))
    ctx_k = context.repeat_interleave(K, 0)
    tok_hist, par_hist = [prev], [torch.arange(K, device=dev).expand(B, K)]
    ident = torch.arange(K, device=dev).expand(B, K)
    for _t in range(1, T):
        frozen = (prev == PAD) | (prev == EOS)
        if bool(frozen.all()):
            break
        lp = dec.step(prev.reshape(-1), ctx_k).view(B, K, V)
        lp[..., PAD] = torch.where(frozen, 0.0, lp[..., PAD])
        total = (scores[:, :, None] + lp).reshape(B, K * V)
        new, raw = torch.sort(total, dim=-1, descending=True, stable=True)
        new, raw = new[:, :K], raw[:, :K]
        live = ~frozen.all(1, keepdim=True)
        scores = torch.where(live, new, scores)
        parents = torch.where(live, raw // V, ident)
        prev = torch.where(live, raw % V, PAD)
        dec.take((torch.arange(B, device=dev)[:, None] * K
                  + parents).reshape(-1))
        tok_hist.append(prev)
        par_hist.append(parents)
    best = scores.argmax(1)
    idx, rows = best, torch.arange(B, device=dev)
    out = torch.full((B, T), PAD, dtype=torch.long, device=dev)
    for t in range(len(tok_hist) - 1, -1, -1):
        out[:, t] = tok_hist[t][rows, idx]
        idx = par_hist[t][rows, idx]
    return out, scores[rows, best]
