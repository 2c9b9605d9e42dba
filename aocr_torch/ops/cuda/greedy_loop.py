"""The whole greedy decode in one kernel (csrc/greedy_loop.cu).

Replaces `aocr/ops/pallas/greedy_loop.py::fused_greedy_loop` and ports its
`build_tables`.  Every step of every row: the emb_gates row of the
previous token, the LSTM layers with input feed, the attention tail of
decode_step, the PAD/EOS freeze, the optional trie constraint, the
argmax, the score sum and the token history; each block of rows stops
once all its rows are frozen.

The trie is the (N, V) int32 transition table (utils/trie.py), read by
node id in device memory: at t=0 only the root's children are valid and
PAD is not; later PAD always is; PAD keeps a row's node and any other
token steps it, clamped at 0 (greedy_loop.py:153-187).
"""

from __future__ import annotations

from typing import Optional

import torch

from aocr_torch import vocab
from aocr_torch.ops import cuda, lstm
from aocr_torch.ops.cuda import decode_step
from aocr_torch.ops.mm import matmul

launches = 0


def build_tables(dec_params: dict, proj: dict, embedding_size: int,
                 input_feed: bool, cd: torch.dtype) -> dict:
    """Loop-invariant weight tables, once per decode.

    eg (V, 4H): embedding @ Wi0[:E] + bi0 + bh0 rounded to the compute
    dtype (the reference's rounding: it differs from lstm_step's fused
    route); wfh0: [Wi0[E:]; Wh0] (input feed) or Wh0; wx (nl-1, 2H, 4H)
    and bx (nl-1, 4H) for the other layers; W_a, W_c and the padded
    projector in the compute dtype."""
    layers = dec_params["layers"]
    layer0 = layers[0]
    E = embedding_size
    eg = (matmul(dec_params["embedding"].to(cd), layer0["wi"][:E].to(cd))
          + layer0["bi"] + layer0["bh"]).to(cd)
    if input_feed:
        wfh0 = torch.cat([layer0["wi"][E:], layer0["wh"]], dim=0).to(cd)
    else:
        wfh0 = layer0["wh"].to(cd)
    H = layer0["wh"].shape[0]
    dev = eg.device
    wx = torch.stack([torch.cat([l["wi"], l["wh"]], dim=0) for l in
                      layers[1:]]).to(cd) if len(layers) > 1 else \
        torch.empty((0, 2 * H, 4 * H), dtype=cd, device=dev)
    bx = torch.stack([l["bi"] + l["bh"] for l in layers[1:]]) \
        if len(layers) > 1 else torch.empty((0, 4 * H), device=dev)
    pw, pb = decode_step.pad_projector(proj["w"], proj["b"])
    return {"eg": eg.contiguous(), "wfh0": wfh0.contiguous(),
            "wx": wx.contiguous(), "bx": bx.float().contiguous(),
            "wa": dec_params["w_a"].to(cd).contiguous(),
            "wc": dec_params["w_c"].to(cd).contiguous(),
            "pw": pw.to(cd).contiguous(), "pb": pb}


def trie_valid(trie_table: torch.Tensor, nodes: torch.Tensor, vp: int,
               pad_ok: bool) -> torch.Tensor:
    """The (..., vp) float32 0/1 validity plane of the trie rows of `nodes`
    (any shape): 1 where the node has a child for the token, PAD set to 1
    with pad_ok, the columns past V 0."""
    ok = trie_table[nodes.long()] >= 0
    if pad_ok:
        ok[..., vocab.PAD] = True
    V = trie_table.shape[1]
    plane = torch.zeros(ok.shape[:-1] + (vp,), dtype=torch.float32,
                        device=ok.device)
    plane[..., :V] = ok.float()
    return plane


def trie_step(trie_table: torch.Tensor, nodes: torch.Tensor,
              toks: torch.Tensor) -> torch.Tensor:
    """The trie node after emitting toks at nodes, clamped at the root (0)
    where the table has no edge or the token is past V."""
    V = trie_table.shape[1]
    stepped = trie_table[nodes.long(), toks.long().clamp(max=V - 1)]
    return torch.where(toks < V, stepped, 0).clamp(min=0).to(torch.int32)


def fused_greedy_loop_plain(context_lbh, c0, h0, tables, num_layers: int,
                            input_feed: bool, T: int,
                            return_margins: bool = False,
                            trie_table: Optional[torch.Tensor] = None):
    """Plain PyTorch version; same arguments and results as
    fused_greedy_loop.  With return_margins it also returns (B, T) float32
    gaps between the best and second-best log-prob of each step (inf
    where the row was not decoded), which tells a near-tie from a fault
    when two versions disagree."""
    L, B, H = context_lbh.shape
    cd = tables["wa"].dtype
    dev = context_lbh.device
    Vp = tables["pw"].shape[1]
    nodes = torch.zeros((B,), dtype=torch.int32, device=dev)
    attn = torch.zeros((B, H), dtype=torch.float32, device=dev)
    cs = [c0.float()] + [torch.zeros_like(attn)] * (num_layers - 1)
    hs = [h0.float()] + [torch.zeros_like(attn)] * (num_layers - 1)
    prev = torch.full((B,), vocab.GO, dtype=torch.int32, device=dev)
    labels = torch.full((B, T), vocab.PAD, dtype=torch.int32, device=dev)
    score = torch.zeros((B,), dtype=torch.float32, device=dev)
    margins = torch.full((B, T), float("inf"), device=dev)
    for t in range(T):
        frozen = (prev == vocab.PAD) | (prev == vocab.EOS)
        if bool(frozen.all()):
            break
        ah = torch.cat([attn, hs[0]], dim=-1) if input_feed else hs[0]
        gates = tables["eg"][prev.long()].float() + matmul(ah.to(cd),
                                                           tables["wfh0"])
        cs[0], hs[0] = lstm.gate_math(gates, cs[0])
        x = hs[0]
        for l in range(1, num_layers):
            g = matmul(torch.cat([x, hs[l]], dim=-1).to(cd),
                       tables["wx"][l - 1]) + tables["bx"][l - 1]
            cs[l], hs[l] = lstm.gate_math(g, cs[l])
            x = hs[l]
        attn, logp = decode_step.attention_logp_tail(
            x, context_lbh, tables["wa"], tables["wc"], tables["pw"],
            tables["pb"], cd)
        valid = (None if trie_table is None else
                 trie_valid(trie_table, nodes, Vp, pad_ok=t > 0))
        tok, delta, logp = decode_step.freeze_and_pick(logp, prev, valid)
        if trie_table is not None:
            stepped = trie_step(trie_table, nodes, tok)
            nodes = stepped if t == 0 else torch.where(
                tok == vocab.PAD, nodes, stepped)
        if return_margins:
            top2 = logp.topk(2, dim=-1).values
            margins[:, t] = top2[:, 0] - top2[:, 1]
        score = score + delta
        prev = tok
        labels[:, t] = tok
    if return_margins:
        return labels, score, margins
    return labels, score


def fused_greedy_loop(context_lbh: torch.Tensor, c0: torch.Tensor,
                      h0: torch.Tensor, tables: dict, num_layers: int,
                      input_feed: bool, T: int,
                      trie_table: Optional[torch.Tensor] = None):
    """Run the whole greedy decode.

    context_lbh (L, B, H) scan-major in the compute dtype; c0, h0 (B, H)
    float32 layer-1 state from the encoder finals; tables from
    build_tables; trie_table an optional (N, V) int32 transition table.
    Returns (labels (B, T) int32, PAD after EOS, and scores (B,) float32,
    cumulative log-probs after the freeze).  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    global launches
    if context_lbh.device.type == "cpu":
        return fused_greedy_loop_plain(context_lbh, c0, h0, tables,
                                       num_layers, input_feed, T,
                                       trie_table=trie_table)
    if context_lbh.device.type != "cuda":
        raise ValueError(f"fused_greedy_loop: unsupported device "
                         f"{context_lbh.device}")
    L, B, H = context_lbh.shape
    cd, dev = tables["wa"].dtype, context_lbh.device
    Vp = tables["pw"].shape[1]
    V = tables["eg"].shape[0]
    G = 4 * H
    if H % 4 or Vp % 4 or T < 1:
        raise ValueError(f"fused_greedy_loop: H={H}, Vp={Vp}, T={T}")
    cuda.check(context_lbh, "context_lbh", (L, B, H), cd, dev)
    cuda.check(c0, "c0", (B, H), torch.float32, dev)
    cuda.check(h0, "h0", (B, H), torch.float32, dev)
    cuda.check(tables["eg"], "eg", (V, G), cd, dev)
    cuda.check(tables["wfh0"], "wfh0", (2 * H if input_feed else H, G), cd,
               dev)
    cuda.check(tables["wx"], "wx", (num_layers - 1, 2 * H, G), cd, dev)
    cuda.check(tables["bx"], "bx", (num_layers - 1, G), torch.float32, dev)
    cuda.check(tables["wa"], "wa", (H, H), cd, dev)
    cuda.check(tables["wc"], "wc", (2 * H, H), cd, dev)
    cuda.check(tables["pw"], "pw", (H, Vp), cd, dev)
    cuda.check(tables["pb"], "pb", (Vp,), torch.float32, dev)
    if trie_table is not None:
        cuda.check(trie_table, "trie_table", (None, V), torch.int32, dev)
    labels = torch.empty((B, T), dtype=torch.int32, device=dev)
    scores = torch.empty((B,), dtype=torch.float32, device=dev)
    state = torch.empty((B, 2 * num_layers + 1, H), dtype=torch.float32,
                        device=dev)
    t = tables
    cuda.launch("greedy_loop", cd, dev, context_lbh.data_ptr(),
                c0.data_ptr(), h0.data_ptr(), t["eg"].data_ptr(),
                t["wfh0"].data_ptr(), t["wx"].data_ptr(), t["bx"].data_ptr(),
                t["wa"].data_ptr(), t["wc"].data_ptr(), t["pw"].data_ptr(),
                t["pb"].data_ptr(), cuda.ptr(trie_table), labels.data_ptr(),
                scores.data_ptr(), state.data_ptr(), L, B, H, Vp, V, T,
                num_layers, int(input_feed))
    launches += 1
    return labels, scores
