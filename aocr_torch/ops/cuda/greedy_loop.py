"""The whole greedy decode in one kernel (csrc/greedy_loop.cu).

Replaces `aocr/ops/pallas/greedy_loop.py::fused_greedy_loop` and ports its
`build_tables`.  Every step of every row: the emb_gates row of the
previous token, the LSTM layers with input feed, the attention tail of
decode_step, the PAD/EOS freeze, the optional trie constraint, the
argmax, the score sum and the token history; each tile of rows stops
once all its rows are frozen.

The kernel runs on thread-block clusters (`plan` below,
csrc/decoder_cluster.cuh): a cluster of up to 16 SMs owns a tile of bt
batch rows for all T steps; each SM owns H/cs hidden units of every layer
(their four gate columns) and the same columns of W_a and W_c, streams
its slices of the weights (packed by block at each call, `pack_weights`)
from L2 every step by bulk (TMA) copies (~2.6 MB a step in bf16 at the
default decoder, H=1024, 2 layers, input feed), and multiplies them with
the tile's rows on the tensor cores in bf16 (mma.sync, float32 sums) or on
the CUDA cores in float32.  The attention, the log-softmax and the argmax
are split by rows instead, except the attention over a context too long
to stage a row of in shared memory (im2markup's 1,240 positions): there
the SMs split it by positions (and, as their registers need, rows), each
streaming its slice of the context once a step with an online softmax,
and combine their partial context vectors through L2 (`split`).  The SMs
exchange h, q, the context vector, h~, the partial logits and the tokens
through L2, nl + 4 cluster barriers a step (nl + 5 with the split).  So
each weight element read serves bt rows (4 in the previous design, which
streamed every weight through one block a 4-row tile and took as long at
B=4 as at B=512).  On an H100 a step is a chain of
dependent phases, none near a roofline: at B=512 in bf16 the mma products
are a third of it, the epilogues, the stream's waits and the attention
most of the rest; float32 is bound by its FMA loop (PERF.md).

The trie is the (N, V) int32 transition table (utils/trie.py), read by
node id in device memory: at t=0 only the root's children are valid and
PAD is not; later PAD always is; PAD keeps a row's node and any other
token steps it, clamped at 0 (greedy_loop.py:153-187).
"""

from __future__ import annotations

import logging
from typing import NamedTuple, Optional, Tuple

import torch

from aocr_torch import vocab
from aocr_torch.ops import cuda, lstm
from aocr_torch.ops.cuda import decode_step
from aocr_torch.ops.mm import matmul
from aocr_torch.utils.tracing import PACK, span

launches = 0
launches_split = 0  # the launches whose attention was split by positions

# csrc/decoder_cluster.cuh's constants
THREADS = 256
WARPS = THREADS // 32
SMEM_MAX = 232448  # the H100's shared memory a block, bytes
MAX_CLUSTER = 16  # a non-portable cluster size on the H100
TILES = 5  # (16-row, 8-unit) mma tiles a warp, bf16
MAX_UNITS = 512  # units a block
ALIGN = 256  # bytes, scratch regions
BARS = 64  # bytes of mbarriers a block
# (kc, stages) in the order the plan tries them, with the cell states in
# shared memory, then without
CHUNKS = ((128, 3), (64, 4), (128, 2), (64, 3), (32, 4), (32, 3), (16, 4),
          (16, 3), (64, 2), (32, 2), (16, 2))
FMA_RT = (1, 4, 10)  # float32 rows a thread: the kernel's instances
# a step's cost in batch rows of its per-row part: (bf16, float32)
STREAM_ROWS = (40, 10)
FIXED_ROWS = (10, 2)

# launch plans held against the kernel's, by shape key: (Plan, the line
# logged for it); the attention's position slices (`split`) held so too
plans: dict = {}
splits: dict = {}
_log = logging.getLogger(__name__)


class Plan(NamedTuple):
    """How the kernel splits a decode (csrc/decoder_cluster.cuh `dc_plan`,
    which this mirrors field for field)."""
    cs: int  # blocks (SMs) in a cluster
    units: int  # hidden units a block, a multiple of 8
    bt: int  # batch rows a cluster
    rt: int  # float32: rows a thread; bf16: 16-row m-tiles (bt / 16)
    kc: int  # rows of a streamed chunk
    stages: int  # chunks in the ring
    cres: int  # 1: the cell states live in shared memory (else in L2)
    smem: int  # dynamic shared memory bytes a block
    clusters: int  # ceil(B / bt), one batch tile each

    def unit_range(self, s: int, H: int) -> range:
        """The hidden units block s of a cluster owns (maybe none)."""
        return range(s * self.units, min((s + 1) * self.units, H))

    def row_range(self, c: int, B: int) -> range:
        """The batch rows cluster c owns."""
        return range(c * self.bt, min((c + 1) * self.bt, B))

    def owned_rows(self, c: int, s: int, B: int) -> range:
        """The batch rows whose attention and argmax block s of cluster c
        computes (the row-split phases)."""
        R = -(-self.bt // self.cs)
        first = c * self.bt + s * R
        return range(first, min(first + R, c * self.bt + self.bt, B))


def _round_up(a: int, m: int) -> int:
    return (a + m - 1) // m * m


def _cluster(H: int):
    cs = 1
    while cs < MAX_CLUSTER and cs * 8 < H:
        cs *= 2
    return cs, _round_up(-(-H // cs), 8)


def warp_tiles(w: int, G8: int, MT: int) -> int:
    """The mma tiles warp w holds with G8 unit groups of 8 and MT m-tiles
    (csrc/decoder_cluster.cuh `dc_warp_tiles`)."""
    if G8 >= WARPS:
        return (G8 - w + WARPS - 1) // WARPS * MT
    wpg, sl = WARPS // G8, w // G8
    if w >= G8 * wpg or sl >= MT:
        return 0
    return (MT - sl + wpg - 1) // wpg


def ring_bytes(p: Plan, esz: int, nq: int = 4) -> int:
    """Bytes of a plan's ring (csrc/decoder_cluster.cuh `dc_geom`): stages
    of a bt x (kc + 16 bytes) left-operand chunk and a kc x (nq U + 16
    bytes) weight chunk, nq the widest product's column blocks."""
    lda, ldw = p.kc + 16 // esz, nq * p.units + 16 // esz
    return p.stages * (p.bt * lda + p.kc * ldw) * esz


def _smem(p: Plan, esz: int, H: int, L: int, Vp: int, nl: int) -> int:
    ldh, R, ring = p.units + 8, -(-p.bt // p.cs), ring_bytes(p, esz)
    if R * (H + L + Vp) * 4 > ring or p.bt * 4 * p.units * 4 > ring:
        return 0
    cells = p.bt * nl * p.units * 4 if p.cres else 0
    return (ring + p.bt * ldh * 4 + cells
            + _round_up(p.bt * 4 + 2 * R * 4, 8) + BARS)


def tile(opt: int, U: int, f32: bool) -> Optional[tuple]:
    """(bt, rt) of tile option opt (csrc/decoder_cluster.cuh `dc_tile`):
    bf16 16 x rt rows (rt = opt + 1) with at most TILES mma tiles a warp,
    float32 (THREADS // (U/2)) x rt rows, rt in FMA_RT; None where the
    option does not exist."""
    if f32:
        if opt >= len(FMA_RT):
            return None
        return THREADS // (U // 2) * FMA_RT[opt], FMA_RT[opt]
    if warp_tiles(0, U // 8, opt + 1) > TILES:
        return None
    return 16 * (opt + 1), opt + 1


def fit(p, H: int, smem):
    """p with the first (cres, kc, stages) of CHUNKS, the cell states in
    shared memory first, whose shared memory smem(p) (0 where an overlay
    does not fit) fits a block, and that smem; None where none does
    (csrc/decoder_cluster.cuh `dc_fit`).  Chunks of 128 rows are skipped
    where H (rounded to 16) is less."""
    for cres, (kc, stages) in ((c, k) for c in (1, 0) for k in CHUNKS):
        if kc > 64 and kc > _round_up(H, 16):
            continue
        q = p._replace(kc=kc, stages=stages, cres=cres)
        n = smem(q)
        if 0 < n <= SMEM_MAX:
            return q._replace(smem=n)
    return None


def plan_fit(H: int, B: int, dtype: torch.dtype, active: int,
             smem) -> Optional[Plan]:
    """The cluster kernels' launch plan for hidden size H, batch B and the
    compute dtype, whose shared memory smem(p) gives (0 where an overlay
    does not fit), and the clusters of the plan's size the card runs at
    once (`active`: 7 of 16 blocks on an H100 SXM); None where no plan fits
    (csrc/decoder_cluster.cuh `dc_plan_fit`).

    The cluster is the smallest power of two that gives each block 8 of
    the H units or more, up to 16 (U a block, a multiple of 8, at most
    MAX_UNITS; the last blocks may own fewer, or none, and are masked).
    Of the tiles (`tile`), the one that costs least, waves x (max(bt,
    STREAM_ROWS) + FIXED_ROWS) with waves = ceil(clusters / active), the
    smaller on a tie, with `fit`'s chunks."""
    esz = torch.empty((), dtype=dtype).element_size()
    f32 = int(esz == 4)
    cs, U = _cluster(H)
    if U > MAX_UNITS or active < 1:
        return None
    best, out, prev_bt = None, None, 0
    for opt in range(TILES):
        t = tile(opt, U, f32)
        if t is None:
            continue
        bt, rt = t
        if prev_bt >= B:
            break
        prev_bt = bt
        p = fit(Plan(cs, U, bt, rt, 0, 0, 0, 0, -(-B // bt)), H, smem)
        if p is None:
            continue
        waves = -(-p.clusters // active)
        cost = waves * (max(bt, STREAM_ROWS[f32]) + FIXED_ROWS[f32])
        if best is not None and cost >= best:
            continue
        best, out = cost, p
    return out


# the split attention's stages (a position of a row group's rows each): up
# to SPLIT_STAGES, after SPLIT_BARS bytes of their mbarriers in the ring
# (two a stage)
SPLIT_STAGES = 16
SPLIT_BARS = 16 * SPLIT_STAGES
# its registers: q and the context vector of SPLIT_RW tile rows a warp, of
# SPLIT_KM runs of 4 columns a lane (csrc/greedy_loop.cu GL_SPLIT_RW, _KM)
SPLIT_RW, SPLIT_KM = 3, 4


def split_stages(ring: int, slot: int) -> int:
    """The split attention's stages of `slot` bytes in a ring of `ring`
    bytes (csrc/greedy_loop.cu `gl_split_stages`)."""
    return min(SPLIT_STAGES, (ring - SPLIT_BARS) // slot)


def split_rows(p: Plan, slices: int) -> int:
    """The tile rows of a row group of plan p split into `slices` position
    slices (`gl_split_rows`)."""
    return -(-p.bt // (p.cs // slices))


def split(p: Plan, esz: int, H: int, L: int, Vp: int) -> int:
    """The attention's position slices for plan p (csrc/greedy_loop.cu
    `gl_split`), 0 for the row split: 0 where one tile row's context (L x
    H) fits the ring beside the row split's q rows, scores and logits,
    where H passes 128 SPLIT_KM or a context row is no multiple of 16
    bytes, or where no row group fits; else cs over the fewest row groups
    (a power of two up to cs) whose rows the warps hold (SPLIT_RW a warp),
    with two stages or more (`split_stages`)."""
    ring, R, most = ring_bytes(p, esz), -(-p.bt // p.cs), WARPS * SPLIT_RW
    if (ring - _round_up(R * (H + L + Vp) * 4, 16) >= L * H * esz
            or H > 128 * SPLIT_KM or H * esz % 16):
        return 0
    ng = 1
    while ng < p.cs and -(-p.bt // ng) > most:
        ng *= 2
    rg = -(-p.bt // ng)
    if rg > most or split_stages(ring, rg * H * esz) < 2:
        return 0
    return p.cs // ng


def plan(H: int, B: int, dtype: torch.dtype, L: int, Vp: int,
         num_layers: int, active: int) -> Optional[Plan]:
    """The kernel's launch plan (csrc/decoder_cluster.cuh `dc_plan`) for
    the context length L, the padded vocabulary Vp and the decoder's
    layers: `plan_fit` with the ring, float tile, cells and row-split
    scratch of `_smem`."""
    esz = torch.empty((), dtype=dtype).element_size()
    return plan_fit(H, B, dtype, active,
                    lambda q: _smem(q, esz, H, L, Vp, num_layers))


def scratch_bytes(p: Plan, dtype: torch.dtype, H: int, num_layers: int,
                  V: int) -> int:
    """Bytes of the kernel's zeroed scratch (csrc/decoder_cluster.cuh
    `dc_scratch`): the exchange planes in the compute dtype (h~ and each
    layer's h by step parity, the context vector; chunk-major, each
    clusters x (hs / kc) chunks of bt x (kc + 16 bytes)), q, the cell
    states, the partial logits and the tokens, each region aligned to
    ALIGN bytes."""
    esz = torch.empty((), dtype=dtype).element_size()
    bp, hs = p.clusters * p.bt, _round_up(H, p.kc)
    plane = p.clusters * (hs // p.kc) * p.bt * (p.kc + 16 // esz)
    sizes = ((3 + 2 * num_layers) * plane * esz, bp * hs * 4,
             bp * num_layers * H * 4, p.clusters * p.cs * p.bt * V * 4,
             bp * 4)
    return sum(_round_up(n, ALIGN) for n in sizes)


def split_bytes(p: Plan, H: int, slices: int) -> int:
    """Bytes of the split attention's partials (`slices` position slices),
    after `scratch_bytes` in the kernel's scratch (csrc/greedy_loop.cu):
    each block's context vectors and (max, sum), clusters x cs x rows of a
    group x (H + 2) floats; 0 for the row split."""
    return (p.clusters * p.cs * split_rows(p, slices) * (H + 2) * 4
            if slices else 0)


def packed(p: Plan, H: int, like: torch.Tensor, lead, nq: int) -> torch.Tensor:
    """A zeroed buffer of packed weight slices: (*lead, hs, nq*U + 16
    bytes) in like's dtype and device, hs = H rounded up to kc."""
    return like.new_zeros((*lead, _round_up(H, p.kc),
                           nq * p.units + 16 // like.element_size()))


def pack_into(dst: torch.Tensor, w: torch.Tensor, H: int, p: Plan) -> None:
    """Copy the blocks' slices of w (nseg*H, nq*H; any strides, e.g. a
    transpose) into dst (cs, nseg, >= H rows, >= nq*U columns; a view of a
    `packed` buffer): dst[s, g, k, i*U + u] = w[g*H + k, i*H + s*U + u]
    for the units s*U + u < H (csrc/decoder_cluster.cuh's DcSeg: a block's
    slice of segment g is contiguous, kc rows a chunk).  One strided copy,
    and a padded copy of w first where the cluster's units pass H."""
    cs, U = p.cs, p.units
    nseg, nq = w.shape[0] // H, w.shape[1] // H
    x = w.view(nseg, H, nq, H)
    if cs * U != H:
        x = torch.nn.functional.pad(x, (0, cs * U - H))
    dst[:, :, :H, :nq * U].view(cs, nseg, H, nq, U).copy_(
        x.view(nseg, H, nq, cs, U).permute(3, 0, 1, 2, 4))


def pack_weights(tables: dict, p: Plan, num_layers: int,
                 input_feed: bool) -> dict:
    """The kernel's weight operands, each block's slices contiguous, kc
    rows a chunk (`pack_into`): w0 (cs, nseg0, hs, 4U + pad) layer 0's
    rows for [attn; h0] (input feed) or h0; wl (nl-1, cs, 2, hs, 4U + pad)
    layer l's rows for its own last h_l, then for h_{l-1}; wq (cs, hs, 2U
    + pad) [W_a | W_c[H:]]; wc (cs, hs, U + pad) W_c[:H].  Rebuilt at each
    call from the build_tables operands, in ten copies."""
    wa, wc = tables["wa"], tables["wc"]
    H = wa.shape[0]
    w0 = packed(p, H, wa, (p.cs, 2 if input_feed else 1), 4)
    pack_into(w0, tables["wfh0"], H, p)
    wl = packed(p, H, wa, (num_layers - 1, p.cs, 2), 4)
    for l, w in enumerate(tables["wx"]):
        pack_into(wl[l, :, :1], w[H:], H, p)
        pack_into(wl[l, :, 1:], w[:H], H, p)
    wq = packed(p, H, wa, (p.cs, 1), 2)
    pack_into(wq[..., :p.units], wa, H, p)
    pack_into(wq[..., p.units:], wc[H:], H, p)
    wcx = packed(p, H, wa, (p.cs, 1), 1)
    pack_into(wcx, wc[:H], H, p)
    return {"w0": w0, "wl": wl, "wq": wq[:, 0], "wc": wcx[:, 0]}


def plan_line(kernel: str, what: str, p: Plan, active: int) -> str:
    """A cluster plan of greedy_loop, tf_fwd or tf_bwd in words, as the
    logs print it ("<kernel> plan <what>: ...")."""
    return (f"{kernel} plan {what}: cluster {p.cs} x {p.units} units, "
            f"bt={p.bt} (rt={p.rt}), {p.clusters} clusters, {active} "
            f"at once ({-(-p.clusters // active)} waves); chunks of "
            f"{p.kc} rows, {p.stages} stages; state in "
            f"{'shared memory' if p.cres else 'L2'}; smem {p.smem} B")


def checked_plan(H: int, B: int, cd: torch.dtype, L: int, Vp: int,
                 nl: int) -> Tuple[Plan, int]:
    """The launch's plan and its attention's position slices (`split`):
    ValueError where no plan fits; on a shape's first launch the plan
    held against the kernel's own (`cuda.held_plan`), and the slices
    against the kernel's (RuntimeError where they differ); a split is logged
    and named in the shape's plan line."""
    if plan(H, B, cd, L, Vp, nl, 1) is None:
        raise ValueError(f"fused_greedy_loop: no kernel plan fits H={H}, "
                         f"B={B}, L={L}, Vp={Vp}, {nl} layers in {cd}")
    key, f32 = (H, B, cd, L, Vp, nl), int(cd == torch.float32)
    lib = cuda.library()
    p = cuda.held_plan(
        "greedy_loop", key,
        lambda out: lib.aocr_greedy_loop_plan(H, B, f32, L, Vp, nl, out), 10,
        lambda active: plan(H, B, cd, L, Vp, nl, active),
        lambda p, active: plan_line("greedy_loop", f"H={H} B={B} L={L} {cd}",
                                    p, active), plans)
    if key not in splits:
        slices = split(p, 4 if f32 else 2, H, L, Vp)
        got = lib.aocr_greedy_loop_split(H, B, f32, L, Vp, nl)
        if got != slices:
            raise RuntimeError(f"greedy_loop split mismatch at H={H} B={B} "
                               f"L={L} {cd}: kernel {got}, wrapper {slices}")
        if slices:
            line = (f"{plans[key][1]}; attention split by positions: {slices} "
                    f"slices x {p.cs // slices} row groups of "
                    f"{split_rows(p, slices)} rows")
            plans[key] = (p, line)
            _log.info(line)
        splits[key] = slices
    return p, splits[key]


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
    cumulative log-probs after the freeze).  Runs the custom op
    aocr_torch::fused_greedy_loop (`op`, the tables as its flat
    arguments): CPU tensors take the plain version; CUDA tensors launch
    the kernel, or raise ValueError where no plan fits the shape.  The
    projector's columns past V must be pad_projector's zeros: the kernel
    gives them b_p alone."""
    if context_lbh.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_greedy_loop: unsupported device "
                         f"{context_lbh.device}")
    t = tables
    return op(context_lbh, c0, h0, t["eg"], t["wfh0"], t["wx"], t["bx"],
              t["wa"], t["wc"], t["pw"], t["pb"], trie_table, num_layers,
              input_feed, T)


@torch.library.custom_op("aocr_torch::fused_greedy_loop", mutates_args=())
def op(context_lbh: torch.Tensor, c0: torch.Tensor, h0: torch.Tensor,
       eg: torch.Tensor, wfh0: torch.Tensor, wx: torch.Tensor,
       bx: torch.Tensor, wa: torch.Tensor, wc: torch.Tensor,
       pw: torch.Tensor, pb: torch.Tensor,
       trie_table: Optional[torch.Tensor], num_layers: int,
       input_feed: bool, T: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """fused_greedy_loop as a custom op, so that torch.export traces the
    decode as one node; the plan, the weight packing and the scratch are
    sized here, from the real batch."""
    global launches, launches_split
    t = {"eg": eg, "wfh0": wfh0, "wx": wx, "bx": bx, "wa": wa, "wc": wc,
         "pw": pw, "pb": pb}
    if context_lbh.device.type == "cpu":
        return fused_greedy_loop_plain(context_lbh, c0, h0, t, num_layers,
                                       input_feed, T, trie_table=trie_table)
    L, B, H = context_lbh.shape
    cd, dev = wa.dtype, context_lbh.device
    Vp = pw.shape[1]
    V = eg.shape[0]
    G = 4 * H
    if H % 4 or Vp % 4 or T < 1 or num_layers < 1:
        raise ValueError(f"fused_greedy_loop: H={H}, Vp={Vp}, T={T}, "
                         f"num_layers={num_layers}")
    p, slices = checked_plan(H, B, cd, L, Vp, num_layers)
    cuda.check(context_lbh, "context_lbh", (L, B, H), cd, dev)
    cuda.check(c0, "c0", (B, H), torch.float32, dev)
    cuda.check(h0, "h0", (B, H), torch.float32, dev)
    cuda.check(eg, "eg", (V, G), cd, dev)
    cuda.check(wfh0, "wfh0", (2 * H if input_feed else H, G), cd, dev)
    cuda.check(wx, "wx", (num_layers - 1, 2 * H, G), cd, dev)
    cuda.check(bx, "bx", (num_layers - 1, G), torch.float32, dev)
    cuda.check(wa, "wa", (H, H), cd, dev)
    cuda.check(wc, "wc", (2 * H, H), cd, dev)
    cuda.check(pw, "pw", (H, Vp), cd, dev)
    cuda.check(pb, "pb", (Vp,), torch.float32, dev)
    if trie_table is not None:
        cuda.check(trie_table, "trie_table", (None, V), torch.int32, dev)
    labels = torch.empty((B, T), dtype=torch.int32, device=dev)
    scores = torch.empty((B,), dtype=torch.float32, device=dev)
    scratch = torch.zeros((scratch_bytes(p, cd, H, num_layers, V)
                           + split_bytes(p, H, slices),), dtype=torch.uint8,
                          device=dev)
    with span(PACK):
        w = pack_weights(t, p, num_layers, input_feed)
    cuda.launch("greedy_loop", cd, dev, context_lbh.data_ptr(),
                c0.data_ptr(), h0.data_ptr(), eg.data_ptr(),
                w["w0"].data_ptr(), w["wl"].data_ptr(), bx.data_ptr(),
                w["wq"].data_ptr(), w["wc"].data_ptr(), pw.data_ptr(),
                pb.data_ptr(), cuda.ptr(trie_table), labels.data_ptr(),
                scores.data_ptr(), scratch.data_ptr(), L, B, H, Vp, V, T,
                num_layers, int(input_feed))
    launches += 1
    launches_split += bool(slices)
    return labels, scores


@op.register_fake
def _(context_lbh, c0, h0, eg, wfh0, wx, bx, wa, wc, pw, pb, trie_table,
      num_layers, input_feed, T):
    B = context_lbh.shape[1]
    return (context_lbh.new_empty((B, T), dtype=torch.int32),
            context_lbh.new_empty((B,), dtype=torch.float32))
