"""One beam-search step after the LSTM stack in one kernel
(csrc/beam_step.cu).

Replaces `aocr/ops/pallas/beam_step.py::fused_beam_tail`: per beam, the
grouped attention over its batch row's one context row and the projector
with log-softmax (decode_step's attention tail), the PAD/EOS freeze, the
beam's score added, the optional trie plane, then the top-K over the K x V
candidates of each batch row in lax.top_k's order (ties to the first
index of the k-major flattening) with the reference's refill: fewer than K
valid candidates duplicate the best one (model.lua:421-436).

The (B*K, H) top hidden state is row-major identical to (B, K*H), so the
kernel takes K*H-wide rows and returns h~ in the same packed layout.

The kernel runs beam_loop's step after its LSTM stack on thread-block
clusters (csrc/decoder_cluster.cuh, `plan` below): a cluster of up to 16
SMs owns a tile of nb whole batch rows with all K beams; each SM streams
its column slices of W_a and W_c (greedy_loop's packing, at each call)
and multiplies them with the tile's beam rows on the tensor cores in
bf16 or the CUDA cores in float32; the attention and log-softmax are
split by beam rows, the top-K by batch rows (the candidates through L2
where a SM's beam rows are not whole batch rows).  A shape that no plan
takes (K past the largest tile, the row-split scratch past a block's
shared memory, H past 16 blocks of greedy_loop.MAX_UNITS) takes the
first port's kernel, one block a batch row (the rows route), logged once
per shape.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from aocr_torch.ops import cuda
from aocr_torch.ops.cuda import decode_step, greedy_loop
from aocr_torch.utils.tracing import PACK, span

launches = 0

# A candidate the trie forbids scores NEG; a top-K pick at or below half
# of it is no valid candidate (aocr/decode.py::_apply_trie_and_topk).
NEG = -1e30

# launch plans held against the kernel's, by shape key: (Plan or None for
# the rows route, the line logged for it)
plans: dict = {}


class Plan(NamedTuple):
    """How a beam kernel splits its batch rows (csrc/beam_step.cu
    `bs_plan` and csrc/beam_loop.cu `bl_plan`, which this mirrors field
    for field): greedy_loop.Plan's fields, and nb."""
    cs: int  # blocks (SMs) in a cluster
    units: int  # hidden units a block, a multiple of 8
    bt: int  # beam rows a cluster (its tile; nb * K of them real)
    rt: int  # float32: rows a thread; bf16: 16-row m-tiles (bt / 16)
    kc: int  # rows of a streamed chunk
    stages: int  # chunks in the ring
    cres: int  # beam_loop: 1 where the cell states live in shared memory
    smem: int  # dynamic shared memory bytes a block
    clusters: int  # ceil(B / nb), one tile each
    nb: int  # batch rows a tile, with all K beams: bt // K

    def unit_range(self, s: int, H: int) -> range:
        """The hidden units block s of a cluster owns (maybe none)."""
        return range(s * self.units, min((s + 1) * self.units, H))

    def batch_rows(self, c: int, B: int) -> range:
        """The batch rows cluster c owns."""
        return range(c * self.nb, min((c + 1) * self.nb, B))

    def owned_batch_rows(self, c: int, s: int, B: int) -> range:
        """The batch rows whose K beams' attention, top-K and bookkeeping
        block s of cluster c computes (the row-split phases)."""
        Rb = -(-self.nb // self.cs)
        first = c * self.nb + s * Rb
        return range(first, min(first + Rb, (c + 1) * self.nb, B))


# a wave's cost past its rows' products, in rows (bf16, float32):
# csrc/beam_step.cu's BS_FIXED_ROWS
FIXED_ROWS = (40, 20)


def beam_plan_fit(H: int, B: int, K: int, dtype: torch.dtype, active: int,
                  fixed: tuple, smem) -> Optional[Plan]:
    """The beam kernels' plan (csrc/decoder_cluster.cuh `dc_beam_plan`) for
    hidden size H, batch B, beam width K and the compute dtype, whose
    shared memory smem(p) gives (0 where an overlay does not fit), and the
    clusters the card runs at once (`active`); None where none fits.

    The cluster and units are greedy_loop's.  Of greedy_loop's tiles
    (`greedy_loop.tile`) that hold a batch row's K beams, with nb = bt // K
    batch rows a tile and clusters = ceil(B / nb), the one that costs
    least, waves x (max(nb * K, STREAM_ROWS) + fixed[dtype is float32]),
    waves = ceil(clusters / active), the smaller on a tie, with
    `greedy_loop.fit`'s chunks."""
    esz = torch.empty((), dtype=dtype).element_size()
    f32 = int(esz == 4)
    cs, U = greedy_loop._cluster(H)
    if U > greedy_loop.MAX_UNITS or active < 1 or K < 1:
        return None
    best, out, prev_nb = None, None, 0
    for opt in range(greedy_loop.TILES):
        t = greedy_loop.tile(opt, U, f32)
        if t is None or t[0] < K:
            continue
        bt, rt = t
        nb = bt // K
        if prev_nb >= B:
            break
        prev_nb = nb
        p = greedy_loop.fit(Plan(cs, U, bt, rt, 0, 0, 0, 0, -(-B // nb), nb),
                            H, smem)
        if p is None:
            continue
        waves = -(-p.clusters // active)
        cost = waves * (max(nb * K, greedy_loop.STREAM_ROWS[f32])
                        + fixed[f32])
        if best is not None and cost >= best:
            continue
        best, out = cost, p
    return out


def _rowsplit(p: Plan, K: int, H: int, L: int, Vp: int) -> int:
    """Bytes of a tile's row-split scratch (csrc/beam_step.cu
    `bs_rowsplit`): R = ceil(bt / cs) own beam rows of q, scores and
    logits (H + L + Vp floats), then, over them, the scored candidates of
    Rb = ceil(nb / cs) own batch rows (K x Vp floats each)."""
    R, Rb = -(-p.bt // p.cs), -(-p.nb // p.cs)
    return greedy_loop._round_up(max(R * (H + L + Vp), Rb * K * Vp) * 4, 16)


def _smem(p: Plan, esz: int, K: int, H: int, L: int, Vp: int) -> int:
    """csrc/beam_step.cu `bs_smem`: a region that holds the ring (stages
    for products of two column blocks) or the row-split scratch, whichever
    is larger, the float tile and the mbarriers."""
    ring = greedy_loop.ring_bytes(p, esz, nq=2)
    return (max(ring, _rowsplit(p, K, H, L, Vp)) + p.bt * (p.units + 8) * 4
            + greedy_loop.BARS)


def plan(H: int, B: int, K: int, dtype: torch.dtype, L: int, Vp: int,
         active: int) -> Optional[Plan]:
    """The kernel's cluster plan for hidden size H, batch B, beam width K,
    the compute dtype, the context length L, the padded vocabulary Vp and
    the clusters of the plan's size the card runs at once (`active`):
    `beam_plan_fit` with `_smem`; None (the rows route) where no plan
    fits: K past the largest tile, the row-split scratch of a tile's own
    beam rows past a block's shared memory, or more than
    greedy_loop.MAX_UNITS units a block.  A wave's fixed cost is
    FIXED_ROWS, not greedy_loop's: beam_step's attention, projector and
    top-K weigh more against its two products than a whole decoder step's
    do."""
    esz = torch.empty((), dtype=dtype).element_size()
    return beam_plan_fit(H, B, K, dtype, active, FIXED_ROWS,
                         lambda q: _smem(q, esz, K, H, L, Vp))


# beam rows a block of the rows route (csrc/beam_step.cu BEAM_BT)
ROWS_BT = 8


def fits(H: int, B: int, K: int, dtype: torch.dtype, L: int, Vp: int,
         V: int) -> bool:
    """Whether a launch runs the shape: H a multiple of 4, 1 <= K <= V,
    and its cluster plan, or else a rows-route block (ROWS_BT beam rows,
    then the K x V candidates and 4 words a beam) within a block's shared
    memory."""
    return H % 4 == 0 and 1 <= K <= V and (
        plan(H, B, K, dtype, L, Vp, 1) is not None
        or decode_step.rows_smem(H, L, Vp, ROWS_BT, K * V + 4 * K)
        <= greedy_loop.SMEM_MAX)


def scratch_bytes(p: Plan, dtype: torch.dtype, H: int, V: int) -> int:
    """Bytes of the cluster route's scratch (csrc/beam_step.cu
    `bs_scratch`): two exchange planes in the compute dtype (the tile's h
    rows and the context vector), q, the partial logits and the scored
    candidates, each region aligned to greedy_loop.ALIGN bytes.  The
    kernel writes every byte it reads."""
    esz = torch.empty((), dtype=dtype).element_size()
    hs = greedy_loop._round_up(H, p.kc)
    plane = p.clusters * (hs // p.kc) * p.bt * (p.kc + 16 // esz)
    sizes = (2 * plane * esz, p.clusters * p.bt * hs * 4,
             p.clusters * p.cs * p.bt * V * 4, p.clusters * p.bt * V * 4)
    return sum(greedy_loop._round_up(n, greedy_loop.ALIGN) for n in sizes)


def plan_line(kernel: str, p: Optional[Plan], active: int, H: int, B: int,
              K: int, cd: torch.dtype, L: int, Vp: int, rows: str) -> str:
    """The route of a launch of `kernel` (this one, or decode_step, the
    same cluster step at K = 1) in words, as the logs print it: its
    cluster plan, or the rows route (p None; `rows` says what that
    runs)."""
    what = f"{kernel} plan H={H} B={B} K={K} L={L} Vp={Vp} {cd}"
    if p is None:
        return (f"{what}: the rows route (no cluster plan at H={H}, "
                f"{active} clusters at once), {rows}")
    return (f"{what}: cluster {p.cs} x {p.units} units, bt={p.bt} "
            f"rows (rt={p.rt}) = {p.nb} batch rows x {K} beams, "
            f"{p.clusters} clusters, {active} at once "
            f"({-(-p.clusters // active)} waves); chunks of {p.kc} "
            f"rows, {p.stages} stages; smem {p.smem} B")


def checked_plan(H: int, B: int, K: int, cd: torch.dtype, L: int,
                 Vp: int) -> Optional[Plan]:
    """The launch's route: its cluster plan, or None for the rows route
    (K past the largest tile, for one), held against the kernel's own
    (`aocr_beam_step_plan`, all 0 for the rows route) on a shape's first
    launch and logged (`cuda.held_plan`)."""
    return cuda.held_plan(
        "beam_step", (H, B, K, cd, L, Vp),
        lambda out: cuda.library().aocr_beam_step_plan(
            H, B, K, int(cd == torch.float32), L, Vp, out), 11,
        lambda active: plan(H, B, K, cd, L, Vp, active),
        lambda p, active: plan_line("beam_step", p, active, H, B, K, cd, L,
                                    Vp, "one block a batch row"),
        plans, rows=True)


def packed_weights(w_a: torch.Tensor, w_c: torch.Tensor, p: Plan) -> dict:
    """The cluster route's weight operands for the plan's geometry,
    greedy_loop.pack_weights' wq ([W_a | W_c[H:]]) and wc (W_c[:H]), in
    three strided copies."""
    H = w_a.shape[0]
    wq = greedy_loop.packed(p, H, w_a, (p.cs, 1), 2)
    greedy_loop.pack_into(wq[..., :p.units], w_a, H, p)
    greedy_loop.pack_into(wq[..., p.units:], w_c[H:], H, p)
    wcx = greedy_loop.packed(p, H, w_a, (p.cs, 1), 1)
    greedy_loop.pack_into(wcx, w_c[:H], H, p)
    return {"wq": wq[:, 0], "wc": wcx[:, 0]}


def topk_refill(total: torch.Tensor, K: int, refill: bool):
    """The top-K of each row of total (B, C), in lax.top_k's order:
    descending, ties to the lowest index.  With refill, picks <= NEG / 2
    take the first pick's score and index.  Returns (scores (B, K)
    float32, indices (B, K) int64, valid picks (B,) int32 or None)."""
    scores, idx = torch.sort(total, dim=-1, descending=True, stable=True)
    scores, idx = scores[:, :K].contiguous(), idx[:, :K].contiguous()
    if not refill:
        return scores, idx, None
    bad = scores <= NEG * 0.5
    nvalid = (K - bad.sum(dim=1)).to(torch.int32)
    scores = torch.where(bad, scores[:, :1], scores)
    idx = torch.where(bad, idx[:, :1], idx)
    return scores, idx, nvalid


def beam_totals(context_lbh, h_top_packed, prev_tokens, scores, w_a, w_c,
                pw_padded, pb_padded, K: int, V: int,
                valid: Optional[torch.Tensor] = None):
    """The plain step before the top-K: (h_tilde (B, K*H) float32, the
    scored candidates (B, K*V) float32, NEG where the plane forbids).
    Beam k's attention and projector are decode_step's on the batch rows'
    context, as the TPU kernel computes them."""
    cd = w_a.dtype
    B = prev_tokens.shape[0]
    H, vp = w_a.shape[0], pw_padded.shape[1]
    h = h_top_packed.to(cd).reshape(B, K, H)
    hts, totals = [], []
    for k in range(K):
        ht, logp = decode_step.attention_logp_tail(
            h[:, k], context_lbh, w_a, w_c, pw_padded, pb_padded, cd)
        hts.append(ht)
        tot = scores[:, k:k + 1] + decode_step.freeze_logp(
            logp[:, :V], prev_tokens[:, k])
        if valid is not None:
            ok = valid.reshape(B, K, vp)[:, k, :V] > 0
            tot = torch.where(ok, tot, torch.full_like(tot, NEG))
        totals.append(tot)
    return torch.cat(hts, dim=1), torch.cat(totals, dim=1)


def topk_margin(total: torch.Tensor, K: int) -> torch.Tensor:
    """The smallest gap between neighbours among the K+1 best valid
    candidates of each row (B,): a near-tie below it may order two
    versions of the top-K differently."""
    top = total.topk(min(K + 1, total.shape[1]), dim=-1).values
    gaps = top[:, :-1] - top[:, 1:]
    return torch.where(top[:, 1:] > NEG * 0.5, gaps,
                       torch.full_like(gaps, float("inf"))).min(dim=-1).values


def fused_beam_tail_plain(context_lbh, h_top_packed, prev_tokens, scores,
                          w_a, w_c, pw_padded, pb_padded, K: int, V: int,
                          valid: Optional[torch.Tensor] = None):
    """Plain PyTorch version; same arguments and results as
    fused_beam_tail."""
    htld, total = beam_totals(context_lbh, h_top_packed, prev_tokens, scores,
                              w_a, w_c, pw_padded, pb_padded, K, V, valid)
    new_scores, idx, nvalid = topk_refill(total, K, valid is not None)
    out = (htld, new_scores, (idx // V).to(torch.int32),
           (idx % V).to(torch.int32))
    return out + (nvalid,) if valid is not None else out


def fused_beam_tail(context_lbh: torch.Tensor, h_top_packed: torch.Tensor,
                    prev_tokens: torch.Tensor, scores: torch.Tensor,
                    w_a: torch.Tensor, w_c: torch.Tensor,
                    pw_padded: torch.Tensor, pb_padded: torch.Tensor, K: int,
                    V: int, valid: Optional[torch.Tensor] = None):
    """context_lbh (L, B, H) scan-major, compute dtype; h_top_packed
    (B, K*H); prev_tokens (B, K) int32; scores (B, K) float32; w_a, w_c,
    pw_padded (H, Vp) in the compute dtype, pb_padded (Vp,) float32
    (decode_step.pad_projector); valid an optional (B, K*Vp) float32 0/1
    trie plane.

    Returns (h_tilde (B, K*H) float32, new_scores (B, K) float32, parents
    (B, K) int32, tokens (B, K) int32), and with `valid` the valid-
    candidate count (B,) int32.  Runs the custom op
    aocr_torch::fused_beam_tail (`op`): CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if context_lbh.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_beam_tail: unsupported device "
                         f"{context_lbh.device}")
    out = op(context_lbh, h_top_packed, prev_tokens, scores, w_a, w_c,
             pw_padded, pb_padded, K, V, valid)
    return out if valid is not None else out[:4]


@torch.library.custom_op("aocr_torch::fused_beam_tail", mutates_args=())
def op(context_lbh: torch.Tensor, h_top_packed: torch.Tensor,
       prev_tokens: torch.Tensor, scores: torch.Tensor, w_a: torch.Tensor,
       w_c: torch.Tensor, pw_padded: torch.Tensor, pb_padded: torch.Tensor,
       K: int, V: int, valid: Optional[torch.Tensor]
       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                  torch.Tensor]:
    """fused_beam_tail as a custom op: (h_tilde, new_scores, parents,
    tokens, nvalid), nvalid zeros without a plane.  The plan, the weight
    packing and the scratch are sized here, from the real batch, so that
    torch.export traces the step as one node."""
    global launches
    if context_lbh.device.type == "cpu":
        out = fused_beam_tail_plain(context_lbh, h_top_packed, prev_tokens,
                                    scores, w_a, w_c, pw_padded, pb_padded,
                                    K, V, valid)
        if valid is None:
            out += (torch.zeros((prev_tokens.shape[0],), dtype=torch.int32),)
        return out
    L, B, H = context_lbh.shape
    Vp = pw_padded.shape[1]
    cd, dev = w_a.dtype, context_lbh.device
    if H % 4 or Vp % 4 or not 1 <= K <= V <= Vp:
        raise ValueError(f"fused_beam_tail: H={H}, Vp={Vp}, K={K}, V={V}")
    h = h_top_packed.to(cd).contiguous()
    cuda.check(context_lbh, "context_lbh", (L, B, H), cd, dev)
    cuda.check(h, "h_top_packed", (B, K * H), cd, dev)
    cuda.check(prev_tokens, "prev_tokens", (B, K), torch.int32, dev)
    cuda.check(scores, "scores", (B, K), torch.float32, dev)
    cuda.check(w_a, "w_a", (H, H), cd, dev)
    cuda.check(w_c, "w_c", (2 * H, H), cd, dev)
    cuda.check(pw_padded, "pw_padded", (H, Vp), cd, dev)
    cuda.check(pb_padded, "pb_padded", (Vp,), torch.float32, dev)
    if valid is not None:
        cuda.check(valid, "valid", (B, K * Vp), torch.float32, dev)
    p = checked_plan(H, B, K, cd, L, Vp)
    if p is None and not fits(H, B, K, cd, L, Vp, V):
        raise ValueError(f"fused_beam_tail: no route fits H={H}, B={B}, "
                         f"K={K}, L={L}, Vp={Vp} in {cd}")
    h_tilde = torch.empty((B, K * H), dtype=torch.float32, device=dev)
    new_scores = torch.empty((B, K), dtype=torch.float32, device=dev)
    parents = torch.empty((B, K), dtype=torch.int32, device=dev)
    tokens = torch.empty((B, K), dtype=torch.int32, device=dev)
    nvalid = (torch.empty if valid is not None else torch.zeros)(
        (B,), dtype=torch.int32, device=dev)
    w = scratch = None
    if p is not None:
        cuda.check_aligned(context_lbh=context_lbh)
        with span(PACK):
            w = packed_weights(w_a, w_c, p)
        scratch = torch.empty((scratch_bytes(p, cd, H, V),),
                              dtype=torch.uint8, device=dev)
    cuda.launch("beam_step", cd, dev, context_lbh.data_ptr(), h.data_ptr(),
                prev_tokens.data_ptr(), scores.data_ptr(), w_a.data_ptr(),
                w_c.data_ptr(), cuda.ptr(w and w["wq"]),
                cuda.ptr(w and w["wc"]), pw_padded.data_ptr(),
                pb_padded.data_ptr(), cuda.ptr(valid), h_tilde.data_ptr(),
                new_scores.data_ptr(), parents.data_ptr(), tokens.data_ptr(),
                cuda.ptr(nvalid if valid is not None else None),
                cuda.ptr(scratch),
                L, B, H, Vp, V, K, p.nb if p is not None else 0)
    launches += 1
    return h_tilde, new_scores, parents, tokens, nvalid


@op.register_fake
def _(context_lbh, h_top_packed, prev_tokens, scores, w_a, w_c, pw_padded,
      pb_padded, K, V, valid):
    L, B, H = context_lbh.shape
    f32, i32 = torch.float32, torch.int32
    return (context_lbh.new_empty((B, K * H), dtype=f32),
            context_lbh.new_empty((B, K), dtype=f32),
            context_lbh.new_empty((B, K), dtype=i32),
            context_lbh.new_empty((B, K), dtype=i32),
            context_lbh.new_empty((B,), dtype=i32))
