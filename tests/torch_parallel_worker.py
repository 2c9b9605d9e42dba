"""Spawned ranks for the port's data- and tensor-parallel tests on the
CPU.

`run_group(jobs)` starts a gloo group of two processes, or `world` (torch
multiprocessing, spawn, a file store in a temporary directory), runs the
jobs in order in every rank and returns each rank's results.  The ranks
import torch and aocr_torch only; the JAX package stays in the test
process that compares.  A rank that raises stops the group at once, and
a group that outlives its timeout is killed: both fail the caller with
the rank's traceback, never a hang.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time
import traceback

import numpy as np


def run_group(jobs, world: int = 2, timeout: float = 120.0) -> list:
    """Run [(name, fn_name, kwargs), ...] in each of `world` ranks; returns
    [{name: result} for each rank]."""
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="aocr_dp_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, tmp, jobs),
                         daemon=True) for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while any(p.is_alive() for p in procs):
            bad = [p for p in procs if p.exitcode not in (None, 0)]
            if bad or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
        errors = [open(os.path.join(tmp, f)).read()
                  for f in sorted(os.listdir(tmp)) if f.endswith(".err")]
        if errors:
            raise AssertionError("a rank failed:\n" + "\n".join(errors))
        codes = [p.exitcode for p in procs]
        if codes != [0] * world:
            raise AssertionError(f"the group did not finish within "
                                 f"{timeout} s (exit codes {codes})")
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(rank: int, world: int, tmp: str, jobs) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(2)
    try:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                                rank=rank, world_size=world)
        out = {}
        for name, fn, kw in jobs:
            out[name] = globals()[fn](**kw)
        dist.barrier()
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.destroy_process_group()
    except Exception:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(f"rank {rank}:\n{traceback.format_exc()}")
        os._exit(1)


def _np(t):
    return t.detach().float().cpu().numpy()


def batchnorm(x, scale, bias, mean, var, dy, row_mask=None,
              dtype="float32"):
    """cnn._bn_train on this rank's rows of x (B, C, H, W), synchronized
    over the group; the backward of sum(y * dy).  Returns this rank's y
    and dx, the scale and bias gradients (this rank's), the new running
    statistics."""
    import torch
    import torch.distributed as dist

    from aocr_torch.models import cnn
    from aocr_torch.parallel import mesh

    cd = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    g = dist.group.WORLD
    xs = torch.from_numpy(mesh.local_rows(x, g)).to(cd).requires_grad_()
    p = {"scale": torch.from_numpy(scale).requires_grad_(),
         "bias": torch.from_numpy(bias).requires_grad_()}
    s = {"mean": torch.from_numpy(mean), "var": torch.from_numpy(var)}
    mask = (None if row_mask is None
            else torch.from_numpy(mesh.local_rows(row_mask, g)))
    y, new = cnn._bn_train(xs, p, s, mask, group=g)
    (y.float() * torch.from_numpy(mesh.local_rows(dy, g))).sum().backward()
    return {"y": _np(y), "dx": _np(xs.grad), "dscale": _np(p["scale"].grad),
            "dbias": _np(p["bias"].grad), "mean": _np(new["mean"]),
            "var": _np(new["var"])}


def dp_step(cfg_kw, params, stats, images, targets, targets_eval, lr=0.1,
            row_mask=None, steps=1, key=None):
    """`steps` make_dp_train_step steps on this rank's rows of the global
    batch, from numpy weights in aocr's layout.  Returns the numpy params
    and batch stats, loss_sum and grad norms of each step."""
    import torch

    from aocr_torch import train_step, weights
    from aocr_torch.config import Config
    from aocr_torch.parallel import data_parallel, mesh

    cfg = Config(**cfg_kw).validate()
    tp, ts = weights.from_numpy(params, stats)
    opt = train_step.init_opt_state(tp, cfg)
    step = data_parallel.make_dp_train_step(cfg)
    im, tg, te = mesh.shard_batch(None, images, targets, targets_eval)
    extra = {}
    if row_mask is not None:
        extra["row_mask"] = torch.from_numpy(mesh.local_rows(row_mask))
    losses, norms = [], []
    for _ in range(steps):
        out = step(tp, ts, opt, im, tg, te, lr, key, **extra)
        tp, ts, opt = out.params, out.batch_stats, out.opt_state
        losses.append(float(out.loss_sum))
        norms.append({k: float(v) for k, v in out.grad_norms.items()})
    p_np, s_np = weights.to_numpy(tp, ts)
    return {"params": p_np, "stats": s_np, "losses": losses, "norms": norms}


def dp_eval(cfg_kw, params, stats, images, targets, targets_eval, row_mask,
            trie=None):
    """make_dp_eval_step on this rank's rows; EvalOut as numpy."""
    import torch

    from aocr_torch import weights
    from aocr_torch.config import Config
    from aocr_torch.parallel import eval_parallel, mesh

    cfg = Config(**cfg_kw).validate()
    tp, ts = weights.from_numpy(params, stats)
    step = eval_parallel.make_dp_eval_step(cfg, use_trie=trie is not None)
    im, tg, te, mk = mesh.shard_batch(None, images, targets, targets_eval,
                                      row_mask)
    out = step(tp, ts, im, tg, te,
               None if trie is None else torch.from_numpy(trie),
               torch.from_numpy(mk))
    return {k: np.asarray(v.cpu().numpy()) for k, v in out._asdict().items()}


def trainer(root: str, argv):
    """aocr_torch.train.main(argv, device="cpu") from root/rank<r>."""
    import contextlib
    import io

    import torch.distributed as dist

    from aocr_torch import train

    cwd = os.getcwd()
    os.chdir(os.path.join(root, f"rank{dist.get_rank()}"))
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            train.main(list(argv), device="cpu")
    finally:
        os.chdir(cwd)
    return None


def tp_step(cfg_kw, params, stats, images, targets, targets_eval, num_data,
            num_model, lr=0.1, row_mask=None, steps=1, key=None):
    """`steps` make_tp_train_step steps at this rank's place on a
    (num_data, num_model) grid of the world: the params sharded
    (tensor_parallel.shard_params), the rows of its data shard.  Returns
    the gathered numpy params, the batch stats, each step's loss_sum and
    grad norms, this rank's shards (numpy leaves in the params' order)
    and whether gather_params(shard_params(x)) is x."""
    import torch

    from aocr_torch import optim, train_step, weights
    from aocr_torch.config import Config
    from aocr_torch.parallel import mesh, tensor_parallel

    cfg = Config(**cfg_kw).validate()
    grid = mesh.make_grid(num_data, num_model)
    whole, ts = weights.from_numpy(params, stats)
    tp = tensor_parallel.shard_params(whole, grid)
    back = tensor_parallel.gather_params(tp, grid)
    roundtrip = all(torch.equal(a, b) for a, b in zip(optim.leaves(back),
                                                      optim.leaves(whole)))
    opt = train_step.init_opt_state(tp, cfg)
    step = tensor_parallel.make_tp_train_step(cfg, grid)
    g = grid.data_group
    im, tg, te = mesh.shard_batch(g, images, targets, targets_eval)
    extra = {}
    if row_mask is not None:
        extra["row_mask"] = torch.from_numpy(mesh.local_rows(row_mask, g))
    losses, norms = [], []
    for _ in range(steps):
        out = step(tp, ts, opt, im, tg, te, lr, key, **extra)
        tp, ts, opt = out.params, out.batch_stats, out.opt_state
        losses.append(float(out.loss_sum))
        norms.append({k: float(v) for k, v in out.grad_norms.items()})
    p_np, s_np = weights.to_numpy(tensor_parallel.gather_params(tp, grid),
                                  ts)
    return {"params": p_np, "stats": s_np, "losses": losses, "norms": norms,
            "local": [_np(x) for x in optim.leaves(tp)],
            "grid": (grid.d, grid.m), "roundtrip": roundtrip}
