"""Input-feeding attention LSTM decoder, one step at a time (counterpart of
aocr/models/decoder.py: DecoderState, init_state, lstm_stack, attention,
step).

Layer 1 takes [emb ; h~_prev] (input feed); the stacked layers use fused
[i|f|o|g] gates; attention is Luong "general" on the top hidden state,
h~ = tanh(W_c [ctx ; h_top]) with bias-free W_a and W_c.  The XLA-route
numerics are kept: q and alpha are rounded to the compute dtype before
their contractions (the fused kernels keep them in float32).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from aocr_torch.models.encoder import init_lstm_layer
from aocr_torch.ops import lstm
from aocr_torch.ops.mm import matmul


class DecoderState(NamedTuple):
    attn: torch.Tensor             # (B, H) h~ of the previous step
    cs: Tuple[torch.Tensor, ...]   # per-layer cell states (B, H)
    hs: Tuple[torch.Tensor, ...]   # per-layer hidden states (B, H)


def init_params(gen: torch.Generator, vocab_size: int, embedding_size: int,
                num_hidden: int, num_layers: int, input_feed: bool,
                device="cpu") -> dict:
    embedding = torch.randn(vocab_size, embedding_size,
                            generator=gen).to(device)
    layers = [init_lstm_layer(
        gen, (embedding_size + (num_hidden if input_feed else 0))
        if i == 0 else num_hidden, num_hidden, device)
        for i in range(num_layers)]
    ba = 1.0 / math.sqrt(num_hidden)
    bc = 1.0 / math.sqrt(2 * num_hidden)
    u = lambda b, *s: ((torch.rand(*s, generator=gen) * 2 - 1) * b).to(device)
    return {"embedding": embedding, "layers": layers,
            "w_a": u(ba, num_hidden, num_hidden),
            "w_c": u(bc, 2 * num_hidden, num_hidden)}


def prepare(params: dict, cd: torch.dtype) -> dict:
    """Cast the loop-invariant weights to the compute dtype once per decode
    (XLA hoists the same casts and concats out of its decode loop)."""
    return {
        "embedding": params["embedding"],
        "layers": [{"w": torch.cat([l["wi"], l["wh"]], dim=0).to(cd),
                    "bi": l["bi"], "bh": l["bh"]} for l in params["layers"]],
        "w_a": params["w_a"].to(cd), "w_c": params["w_c"].to(cd),
    }


def init_state(dec_init, num_layers: int) -> DecoderState:
    """Layer 1 from the encoder finals; other layers and input feed zero."""
    c0, h0 = dec_init
    zeros = torch.zeros_like(c0)
    return DecoderState(attn=zeros,
                        cs=(c0,) + (zeros,) * (num_layers - 1),
                        hs=(h0,) + (zeros,) * (num_layers - 1))


def lstm_stack(prep: dict, state: DecoderState, tokens: torch.Tensor, *,
               input_feed: bool):
    """Embedding + input-feed concat + stacked LSTM layers: everything of a
    step before attention.  prep from `prepare`.  Returns (cs, hs, h_top)."""
    x = prep["embedding"][tokens.long()]
    if input_feed:
        x = torch.cat([x, state.attn.to(x.dtype)], dim=-1)
    cs, hs = [], []
    for i, layer in enumerate(prep["layers"]):
        c, h = lstm.lstm_step(layer["w"], layer["bi"], layer["bh"], x,
                              state.cs[i], state.hs[i])
        cs.append(c)
        hs.append(h)
        x = h
    return tuple(cs), tuple(hs), hs[-1]


def attention(prep: dict, h_top: torch.Tensor, context: torch.Tensor,
              simple: bool = False) -> torch.Tensor:
    """Luong-general attention over context (B, L, H); returns h~ (B, H)
    float32.  simple=True is the reference's additive variant
    h~ = ctx + h_top."""
    cd = prep["w_a"].dtype
    ctx_cd = context.to(cd)
    query = matmul(h_top.to(cd), prep["w_a"])
    scores = torch.einsum("blh,bh->bl", ctx_cd.float(),
                          query.to(cd).float())
    alpha = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bl,blh->bh", alpha.to(cd).float(), ctx_cd.float())
    if simple:
        return ctx + h_top.float()
    cat = torch.cat([ctx, h_top.float()], dim=-1)
    return torch.tanh(matmul(cat.to(cd), prep["w_c"]))


def step(prep: dict, state: DecoderState, tokens: torch.Tensor,
         context: torch.Tensor, *, input_feed: bool, simple: bool = False):
    """One decode step from token ids: (new_state, h~ (B, H))."""
    cs, hs, h_top = lstm_stack(prep, state, tokens, input_feed=input_feed)
    h_tilde = attention(prep, h_top, context, simple)
    return DecoderState(attn=h_tilde, cs=cs, hs=hs), h_tilde
