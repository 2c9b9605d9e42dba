"""The plain reference: the attention-OCR network of da03/Attention-OCR
(SURVEY.md "Config") in plain PyTorch, float32, no kernels, no batching
tricks.  It imports nothing of the program and takes only what the
benchmark made: the weights in the reference layout (conv weights (kh,
kw, I, O)) and the images, labels and tokens.

Every product (conv, matmul, the attention's contractions) goes through
`Precision.q`, which leaves float32 as it is; the control of a cell runs
the same code with its operands rounded to the precision below the one
the configuration states (`control_precision`).

The network: (x - 128) / 128; 7 convs with ReLU, BatchNorm after convs
3, 5 and 7, max-pools after convs 1, 2 (2x2) and 4, 6 (2x1), conv7 2x2
VALID, so (B, 512, 1, L) with L = W/4 - 1; a bidirectional LSTM (gates
[i|f|o|g]) whose final states start decoder layer 0; an attention LSTM
decoder: layer 0 reads [emb(token); h~ (input feed)], Luong "general"
attention on the top layer, h~ = tanh(W_c [ctx; h_top]); log-softmax
over the projector.  Greedy decoding freezes a row after EOS (or PAD):
PAD at no cost; beam search keeps that freeze and stops a batch row when
all its beams are frozen; the best beam by raw score.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

PAD, GO, EOS = 0, 1, 2
BN_EPS = 1e-5
POOL_AFTER = {0: (2, 2), 1: (2, 2), 3: (2, 1), 5: (2, 1)}
CONVS = ("conv1", "conv2", "conv3", "conv4", "conv5", "conv6", "conv7")


class Precision:
    """How a product's operands are rounded: "float32" (as they are),
    "tf32" (10-bit mantissa, as the tensor cores' TF32 mode), "fp8"
    (float8 e4m3 with one scale a tensor)."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "tf32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """x rounded; under autograd the rounding passes the gradient
        through unchanged."""
        x = x.float()
        if self.name == "float32":
            return x
        with torch.no_grad():
            if self.name == "tf32":
                i = x.contiguous().view(torch.int32)
                r = ((i + 0x1000) & ~0x1FFF).view(torch.float32)
            else:
                s = x.abs().amax().clamp(min=1e-30) / 448.0
                r = (x / s).to(torch.float8_e4m3fn).float() * s
        return x + (r - x).detach() if x.requires_grad else r

    def mm(self, a, b):
        return torch.matmul(self.q(a), self.q(b))


F32 = Precision()


@contextlib.contextmanager
def products(pr: Precision = F32):
    """cuBLAS and cuDNN set to pr's own products while the reference
    runs, whatever the process had set: TF32 on for the TF32 control
    alone, off for float32 and below; restored after."""
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (mm.allow_tf32, dnn.allow_tf32)
    mm.allow_tf32 = dnn.allow_tf32 = pr.name == "tf32"
    try:
        yield
    finally:
        mm.allow_tf32, dnn.allow_tf32 = saved


def control_precision(dtype: str) -> str:
    """The precision below the configuration's: TF32 below float32 with
    TF32 off (the program's policy), fp8 below bfloat16."""
    return {"float32": "tf32", "bfloat16": "fp8"}[dtype]


def cnn(p: dict, stats: dict, images: torch.Tensor, pr=F32, train=False):
    """images (B, H, W) in [0, 255] -> features (B, L, 512); with
    train=True BatchNorm on the batch's moments (biased variance)."""
    x = ((images.float() - 128.0) / 128.0)[:, None]
    for idx, name in enumerate(CONVS):
        w = p[name]["w"].permute(3, 2, 0, 1)
        pad = 0 if name == "conv7" else 1
        x = F.conv2d(pr.q(x), pr.q(w), padding=pad) \
            + p[name]["b"][:, None, None]
        bn = p.get(name + "_bn")
        if bn is not None:
            if train:
                mean = x.mean((0, 2, 3))
                var = x.var((0, 2, 3), unbiased=False)
            else:
                mean, var = stats[name + "_bn"]["mean"], stats[name + "_bn"]["var"]
            x = ((x - mean[:, None, None]) * torch.rsqrt(var + BN_EPS)[:, None, None]
                 * bn["scale"][:, None, None] + bn["bias"][:, None, None])
        x = torch.relu(x)
        if idx in POOL_AFTER:
            x = F.max_pool2d(x, POOL_AFTER[idx])
    return x[:, :, 0].transpose(1, 2)


def lstm_cell(gates, c):
    i, f, o, g = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return c, torch.sigmoid(o) * torch.tanh(c)


def lstm_layer(layer: dict, xs: torch.Tensor, reverse: bool, pr=F32):
    """xs (B, L, D) -> (hs (B, L, H), final (c, h)), zero start."""
    B, L, _ = xs.shape
    H = layer["wh"].shape[0]
    xp = pr.mm(xs, layer["wi"]) + layer["bi"] + layer["bh"]
    c = h = xs.new_zeros(B, H)
    hs = [None] * L
    for t in (range(L - 1, -1, -1) if reverse else range(L)):
        c, h = lstm_cell(xp[:, t] + pr.mm(h, layer["wh"]), c)
        hs[t] = h
    return torch.stack(hs, 1), (c, h)


def encode(params, stats, images, pr=F32, train=False):
    """-> context (B, L, 2He), (c0, h0) each (B, 2He)."""
    x = cnn(params["cnn"], stats, images, pr, train)
    outs = []
    for d, rev in (("encoder_fw", False), ("encoder_bw", True)):
        hs = x
        for layer in params[d]["layers"]:
            hs, fin = lstm_layer(layer, hs, rev, pr)
        outs.append((hs, fin))
    (hf, (cf, hff)), (hb, (cb, hbb)) = outs
    return (torch.cat([hf, hb], -1),
            (torch.cat([cf, cb], -1), torch.cat([hff, hbb], -1)))


class Decoder:
    """The decoder's state over rows: attn (h~), each layer's (c, h)."""

    def __init__(self, params, dec_init, input_feed: bool, pr=F32):
        self.p, self.input_feed, self.pr = params, input_feed, pr
        c0, h0 = dec_init
        n = len(params["decoder"]["layers"])
        z = torch.zeros_like(c0)
        self.attn = z
        self.cs = [c0] + [z] * (n - 1)
        self.hs = [h0] + [z] * (n - 1)

    def step(self, tokens, context):
        """Feed tokens (R,), attend over context (R, L, H): log-probs (R,
        V), and the state moves on."""
        d, pr = self.p["decoder"], self.pr
        x = d["embedding"][tokens.long()]
        if self.input_feed:
            x = torch.cat([x, self.attn], -1)
        for k, layer in enumerate(d["layers"]):
            w = torch.cat([layer["wi"], layer["wh"]], 0)
            gates = pr.mm(torch.cat([x, self.hs[k]], -1), w) \
                + layer["bi"] + layer["bh"]
            self.cs[k], self.hs[k] = lstm_cell(gates, self.cs[k])
            x = self.hs[k]
        q = pr.mm(x, d["w_a"])
        scores = torch.matmul(pr.q(context), pr.q(q)[:, :, None])[:, :, 0]
        alpha = torch.softmax(scores, -1)
        ctx = torch.matmul(pr.q(alpha)[:, None], pr.q(context))[:, 0]
        self.attn = torch.tanh(pr.mm(torch.cat([ctx, x], -1), d["w_c"]))
        proj = self.p["projector"]
        return torch.log_softmax(pr.mm(self.attn, proj["w"]) + proj["b"], -1)

    def take(self, rows):
        self.attn = self.attn[rows]
        self.cs = [c[rows] for c in self.cs]
        self.hs = [h[rows] for h in self.hs]


def teacher_forced(params, context, dec_init, tokens_in, input_feed,
                   pr=F32):
    """Log-probs (B, T, V) of each step fed tokens_in (B, T)."""
    dec = Decoder(params, dec_init, input_feed, pr)
    return torch.stack([dec.step(tokens_in[:, t], context)
                        for t in range(tokens_in.shape[1])], 1)


def greedy(params, context, dec_init, input_feed, T, pr=F32, wrong_at=None):
    """(tokens (B, T) int64, PAD after EOS; scores (B,)).  wrong_at (B,),
    a fault: the step at which each row takes its runner-up, with its
    own log-prob."""
    B = context.shape[0]
    dec = Decoder(params, dec_init, input_feed, pr)
    prev = torch.full((B,), GO, dtype=torch.long, device=context.device)
    toks = torch.full((B, T), PAD, dtype=torch.long, device=context.device)
    scores = torch.zeros(B, device=context.device)
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


def beam(params, context, dec_init, input_feed, T, K, pr=F32, rank=0):
    """Beam search: (best tokens (B, T) int64, best scores (B,)).  rank >
    0, a fault: the beam of that rank by score is returned instead."""
    B, L, H = context.shape
    dev = context.device
    V = params["projector"]["b"].shape[0]
    dec = Decoder(params, dec_init, input_feed, pr)
    lp = dec.step(torch.full((B,), GO, dtype=torch.long, device=dev), context)
    scores, toks = torch.sort(lp, dim=-1, descending=True, stable=True)
    scores, prev = scores[:, :K].contiguous(), toks[:, :K].contiguous()
    dec.take(torch.arange(B, device=dev).repeat_interleave(K))
    ctx_k = context.repeat_interleave(K, 0)
    tok_hist, par_hist = [prev], [torch.arange(K, device=dev).expand(B, K)]
    ident = torch.arange(K, device=dev).expand(B, K)
    for t in range(1, T):
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
        dec.take((torch.arange(B, device=dev)[:, None] * K + parents).reshape(-1))
        tok_hist.append(prev)
        par_hist.append(parents)
    best = scores.argmax(1) if rank == 0 else torch.sort(
        scores, dim=1, descending=True, stable=True).indices[:, rank]
    idx = best
    rows = torch.arange(B, device=dev)
    out = torch.full((B, T), PAD, dtype=torch.long, device=dev)
    for t in range(len(tok_hist) - 1, -1, -1):
        out[:, t] = tok_hist[t][rows, idx]
        idx = par_hist[t][rows, idx]
    return out, scores[rows, best]


def train_step(params, stats, images, targets, targets_eval, lr,
               input_feed, pr=F32, clip=5.0):
    """One SGD step of the CLI trainer: train-mode forward, the token-sum
    NLL over non-PAD targets divided by the batch, gradients clipped at
    norm 5 per group (cnn, encoder_fw, encoder_bw, decoder, projector),
    p - lr g.  Returns (loss_sum, clipped grads, new params), trees of
    params' structure."""
    flat, paths = [], []

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, path + (i,)) for i, v in enumerate(t)]
        leaf = t.detach().clone().requires_grad_()
        flat.append(leaf)
        paths.append(path)
        return leaf

    p = walk(params, ())
    with torch.enable_grad():
        context, dec_init = encode(p, stats, images, pr, train=True)
        lp = teacher_forced(p, context, dec_init, targets, input_feed, pr)
        picked = lp.gather(-1, targets_eval[..., None])[..., 0]
        nll = -(picked * (targets_eval != PAD)).sum()
        grads = torch.autograd.grad(nll / images.shape[0], flat,
                                    allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(flat, grads)]
    for group in ("cnn", "encoder_fw", "encoder_bw", "decoder", "projector"):
        idx = [i for i, path in enumerate(paths) if path[0] == group]
        n = torch.sqrt(sum(grads[i].square().sum() for i in idx))
        scale = torch.where(n > clip, clip / n, torch.ones_like(n))
        for i in idx:
            grads[i] = grads[i] * scale
    new = [x.detach() - lr * g for x, g in zip(flat, grads)]
    return (nll.detach(), dict(zip(paths, grads)), dict(zip(paths, new)))
