"""The CLI entry point and train/eval loops (counterpart of
aocr/train.py), on one device or data-parallel over several:

    python -m aocr_torch.train -phase train -data_path train.txt \\
        -val_data_path val.txt -model_dir train/ [flags of aocr.train]
    python -m aocr_torch.train -phase test -load_model -model_dir train/ \\
        -data_path test.txt -beam_size 5 [-use_dictionary] [-visualize]
    torchrun --nproc_per_node N -m aocr_torch.train -num_shards N ...

- `-phase train`: epoch loop over shuffled width-bucketed batches; the
  running perplexity exp(loss / num_nonzeros) each step, from the sums
  before it (one step's loss stays in flight while the next runs); every
  `steps_per_checkpoint` steps a throughput line, a checkpoint
  (`model-<step>`, atomically published as `final-model`), a validation
  sweep (beam decode and teacher-forced loss) and the LR decay by
  `lr_decay` when the validation loss rose (floored at
  learning_rate_min); at each epoch's end a checkpoint and a sweep.
  A partial batch is padded to `batch_size` with PAD targets and a row
  mask (`train_step.make_train_step`'s real_bs and row_mask).
- `-phase test`: one pass of beam decoding (`beam_size`, optionally the
  dictionary trie), exact-match accuracy, CER, and with `-visualize` a
  `results.txt` of path, gold, prediction, score and gold score.
- `-load_model`: resume from `<model_dir>/final-model`, written by
  either package (npz v2), with global_step, the learning rate and the
  optimizer state; structure fields come from the checkpoint, geometry
  too unless the command line sets it.

The trainer runs on the CUDA device unless the caller names another
(`main(argv, device="cpu")`, as the tests do); without CUDA the default
raises.  `-augment` draws each step's augmentation from (`-seed`, the
global step), so a resumed run replays the same augmentations;
`-device_preprocess` decodes on the host and resizes on the device.

Data parallelism (`-num_shards N`) runs one process per device in a
torch.distributed group of N: the group the trainer finds, else one
initialized from torchrun's environment with the device's default
backend (NCCL on CUDA); each process takes the device of its
LOCAL_RANK unless the caller names one.  Without `-multihost` every
rank reads the same global batches (the one-device run's data order)
and trains on its rows (parallel.data_parallel); with `-multihost` each
rank reads its slice of the manifest, feeds fixed local rows and keeps
in lockstep with the others (parallel.multihost).  Evaluation shards
the same way (parallel.eval_parallel).  Only rank 0 logs, saves
checkpoints and writes results.txt.  Tensor parallelism
(`-num_model_shards > 1`) is not ported and raises NotImplementedError
naming its ROADMAP queue 1 entry by title.
"""

from __future__ import annotations

import math
import os
import sys
import time
from dataclasses import asdict
from functools import partial
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from aocr_torch import augment, checkpoint, data, devices, \
    eval as eval_lib, optim, preprocess, train_step, vocab, weights
from aocr_torch.parallel import (data_parallel, eval_parallel,
                                 mesh as mesh_lib, multihost)
from aocr_torch.config import (GEOMETRY_FIELDS, STRUCT_FIELDS, Config,
                               parse_args)
from aocr_torch.models import model
from aocr_torch.utils import native, trie as trie_lib
from aocr_torch.utils.logging_util import Logger


class ValDrivenLR:
    """Validation-driven learning-rate schedule (reference
    src/train.lua:87-89,164-168): start at max(initial, floor); multiply by
    `decay` whenever validation loss fails to improve, floored at `minimum`.
    Raw val-loss *sums* are compared, exactly as the reference does."""

    def __init__(self, initial: float, minimum: float, decay: float):
        self.lr = max(initial, minimum)
        self.minimum = minimum
        self.decay = decay
        self.prev_val_loss: Optional[float] = None

    def update(self, val_loss: float) -> bool:
        """Record a validation result; returns True if the LR decayed."""
        decayed = False
        if (self.prev_val_loss is not None
                and val_loss > self.prev_val_loss
                and self.lr > self.minimum):
            self.lr = max(self.lr * self.decay, self.minimum)
            decayed = True
        self.prev_val_loss = val_loss
        return decayed


# the ROADMAP item of the option not ported yet
TENSOR_PARALLEL = "ROADMAP queue 1: Tensor parallel"


def _check_parallel(cfg: Config) -> None:
    """Raise for the parallel options this trainer refuses (before any
    process group or checkpoint is touched)."""
    if cfg.num_model_shards > 1:
        raise NotImplementedError(
            f"-num_model_shards > 1 is not ported: {TENSOR_PARALLEL}")
    if cfg.multihost:
        if cfg.num_shards <= 1:
            raise ValueError("-multihost requires -num_shards > 1 (the "
                             "data axis spans every host's devices)")
        if cfg.keep_aspect_ratio:
            raise ValueError("-multihost requires fixed-width batches "
                             "(keep_aspect_ratio=False)")
        if cfg.device_preprocess:
            raise ValueError("-multihost and -device_preprocess do not "
                             "compose yet (each host's rows are assembled "
                             "from host-side pixel batches)")
        if cfg.visualize:
            raise ValueError("-visualize is per-host; run -phase test "
                             "-visualize single-process on the published "
                             "checkpoint instead")


def _parallel(cfg: Config) -> bool:
    return cfg.num_shards > 1 or cfg.multihost


def _device(cfg: Config, device) -> torch.device:
    """The device of this process: the named one, else under -num_shards
    the CUDA device of torchrun's LOCAL_RANK, else the CUDA device."""
    if device is None and _parallel(cfg):
        device = f"cuda:{multihost.local_rank()}"
    return devices.resolve(device)


def _join_group(cfg: Config, device: torch.device) -> None:
    """The process group of -num_shards N: the one found, else one from
    torchrun's environment (NCCL on CUDA, gloo on the CPU).  Its size
    must be N."""
    multihost.initialize(device=device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    n = mesh_lib.world()
    if n != cfg.num_shards:
        raise ValueError(
            f"-num_shards {cfg.num_shards} but the process group has {n} "
            f"processes: launch one process per device (torchrun "
            f"--nproc_per_node {cfg.num_shards})")
    if cfg.batch_size % n:
        raise ValueError(f"batch_size {cfg.batch_size} not divisible by "
                         f"num_shards {n}")


class _Quiet:
    """The log of a rank other than 0: it writes nothing."""

    def info(self, msg: str) -> None:
        pass

    def shutdown(self) -> None:
        pass


def _host_later(x: torch.Tensor):
    """A scalar's value, to read later without waiting for work queued
    after it: a pinned copy and an event on CUDA, the tensor itself on
    the CPU.  _read gives the float."""
    if x.device.type != "cuda":
        return x
    host = torch.empty((), dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _read(pending) -> float:
    if isinstance(pending, tuple):
        host, done = pending
        done.synchronize()
        return float(host)
    return float(pending)


class Trainer:
    def __init__(self, cfg: Config, log: Logger, device=None):
        _check_parallel(cfg)
        self.log = log
        self.device = _device(cfg, device)
        self.group = None
        if _parallel(cfg):
            _join_group(cfg, self.device)
            self.group = dist.group.WORLD
        ckpt = None
        if cfg.load_model:
            ckpt = checkpoint.try_load_final(
                cfg.model_dir, allow_pickle=cfg.allow_pickle_ckpt)
            if ckpt is None:
                log.info("No final-model found; creating fresh parameters")
        if ckpt is not None:
            log.info(f"Loading model from "
                     f"{checkpoint.final_path(cfg.model_dir)}")
            saved = ckpt["config"]
            # structure from the checkpoint; geometry too unless the
            # command line set it (aocr/train.py:85-100)
            overrides = cfg.geometry_overrides()
            fields = list(STRUCT_FIELDS) + [
                k for k in GEOMETRY_FIELDS if k not in overrides]
            cfg = cfg.replace(**{k: saved[k] for k in fields if k in saved})
            self.params, self.batch_stats = weights.from_numpy(
                ckpt["params"], ckpt["batch_stats"], self.device)
            self.global_step = ckpt["global_step"]
            self.optim_meta = dict(ckpt["optim_state"])
        else:
            log.info("Creating model with fresh parameters")
            gen = torch.Generator().manual_seed(cfg.seed)
            self.params, self.batch_stats = model.init(cfg, gen, self.device)
            self.global_step = 0
            self.optim_meta = {"learning_rate": cfg.learning_rate,
                               "eval_counter": 0}
        self.cfg = cfg.validate()
        self.opt_state = self._restore_opt_state()
        if self.group is None:
            self._train_step = train_step.make_train_step(self.cfg)
        else:
            self._train_step = data_parallel.make_dp_train_step(
                self.cfg, self.group)
            log.info(f"Data-parallel training over {mesh_lib.world()} "
                     f"processes ({dist.get_backend()}, one gradient "
                     f"all-reduce a step)")
        for k, v in sorted(asdict(self.cfg).items()):
            log.info(f"{k}: {v}")
        log.info(f"Number of parameters: {model.num_params(self.params)}")
        self.trie_table = None
        if self.cfg.use_dictionary:
            log.info(f"Load dictionary from {self.cfg.dictionary_path}")
            self.trie_table = torch.from_numpy(trie_lib.load_dictionary(
                self.cfg.dictionary_path, self.cfg.allow_digit_prefix
            )).to(self.device)
        self._eval_step = None
        if self.group is not None:
            self._eval_step = eval_parallel.make_dp_eval_step(
                self.cfg, self.group, use_trie=self.trie_table is not None)
            log.info(f"Sharded evaluation over {mesh_lib.world()} processes "
                     f"(beam decode + gold pass per rank)")
        # -multihost: each process feeds local_bs rows a step, in lockstep
        # with the others (parallel/multihost.py)
        self._lockstep = self.cfg.multihost
        if self._lockstep:
            rank, pc = multihost.process_info()
            self._count_group = multihost.count_group()
            self.local_bs = multihost.local_batch_size(self.cfg.batch_size,
                                                       pc)
            self._global_rows = self.local_bs * pc
            log.info(f"Multi-host lockstep: process {rank}/{pc}, "
                     f"{self.local_bs} rows/host/step")
        else:
            self.local_bs = self._global_rows = self.cfg.batch_size
        self.visualize_file = None

    def _restore_opt_state(self):
        """The optimizer state from optim_meta (a checkpoint's, written by
        either package), else a fresh one."""
        meta = self.optim_meta
        if self.cfg.optimizer == "adadelta":
            saved = meta.get("adadelta")
            if saved is None:
                return optim.adadelta_init(self.params)
            return weights.opt_state_from_numpy(saved, self.device)
        buf, saved_buf = None, None
        if self.cfg.momentum > 0:
            saved_buf = meta.get("momentum_buf")
            buf = (weights.tree_map(self.params,
                                    lambda _p, x: torch.zeros_like(x))
                   if saved_buf is None else None)
        state = weights.opt_state_from_numpy({
            "eval_counter": meta.get("eval_counter", 0),
            "momentum_buf": saved_buf,
            # old checkpoints without the key: the buffer-presence rule
            # (aocr/train.py:136-146)
            "buf_fresh": meta.get("buf_fresh", saved_buf is None)},
            self.device)
        return state if buf is None else state._replace(momentum_buf=buf)

    # ------------------------------------------------------------ steps

    def _images(self, batch: data.Batch) -> torch.Tensor:
        """The batch's pixels on the device: a copy of host-preprocessed
        images, or raw pixels resized there (-device_preprocess)."""
        if batch.raw is not None:
            return preprocess.preprocess_varsize(
                batch.raw, batch.sizes, self.cfg.image_height, batch.out_w,
                self.device)
        return torch.from_numpy(batch.images).to(self.device)

    def step_train(self, batch: data.Batch, lr: float, valid_rows=None,
                   all_full=None):
        """One optimizer step.  Returns the token-sum NLL as a pending
        read (_read gives its float), so the caller can queue the next
        step before it waits.  A batch short of batch_size (an epoch's
        tail) is padded with copies of its last image and PAD targets,
        and a row mask keeps them out of the BatchNorm moments and the
        loss normalization (aocr/train.py:324-344).

        Data-parallel: the batch is padded to a multiple of the ranks
        (-multihost: to the fixed local rows) and each rank steps on its
        rows.  valid_rows is the number of real leading rows (lockstep
        dummies: 0); all_full says whether every process's batch is full
        (None: decide locally).  The masked or unmasked step must be the
        same choice on every rank, or their collectives mismatch
        (aocr/train.py:267-320)."""
        tg, te = batch.targets, batch.targets_eval
        extra = {}
        if self.group is not None:
            valid = batch.rows if valid_rows is None else valid_rows
            n = mesh_lib.world()
            want = (self.local_bs if self._lockstep
                    else batch.rows + (-batch.rows) % n)
            im = batch.images if batch.raw is None else self._images(batch)
            _, im, tg, te = eval_parallel.pad_rows(n, im, tg, te,
                                                   total_rows=want)
            mask = (np.arange(want) < valid).astype(np.float32)
            if not self._lockstep:  # every rank holds the global batch
                im, tg, te, mask = mesh_lib.shard_batch(self.group, im, tg,
                                                        te, mask)
            if valid < want or all_full is False:
                extra = {"row_mask": torch.from_numpy(mask)}
            im = torch.as_tensor(im).to(self.device)
        elif batch.rows < self.cfg.batch_size:
            im = self._images(batch)
            want, real = self.cfg.batch_size, batch.rows
            pad = want - real
            im = torch.cat([im, im[-1:].expand(pad, *im.shape[1:])], 0)
            ztg = np.full((pad, tg.shape[1]), vocab.PAD, tg.dtype)
            tg = np.concatenate([tg, ztg], 0)
            te = np.concatenate([te, ztg], 0)
            extra = {"real_bs": float(real), "row_mask": torch.from_numpy(
                (np.arange(want) < real).astype(np.float32))}
        else:
            im = self._images(batch)
        dev = self.device
        out = self._train_step(
            self.params, self.batch_stats, self.opt_state, im,
            torch.from_numpy(tg).to(dev), torch.from_numpy(te).to(dev), lr,
            augment.step_key(self.cfg.seed, self.global_step), **extra)
        self.params = out.params
        self.batch_stats = out.batch_stats
        self.opt_state = out.opt_state
        if self.cfg.log_norms:
            # reference optim_sgd.lua:49 prints per-group param/grad norms
            for i, g in enumerate(optim.GROUPS):
                if g in out.grad_norms:
                    pn = float(optim.group_norm(self.params[g]))
                    gn = float(out.grad_norms[g])
                    self.log.info(f"i: {i + 1}, param norm: {pn:f}, grad "
                                  f"norm: {gn:f}")
        return _host_later(out.loss_sum)

    def step_eval(self, batch: data.Batch, valid_rows=None):
        """Beam decode and the gold pass from one encode.  Returns
        (loss_sum, accuracy, cer_sum); data-parallel, over every rank's
        rows, valid_rows marking the real leading ones (lockstep dummies
        pass 0)."""
        cfg = self.cfg
        B, T = batch.rows, cfg.max_decoder_l
        # the reference pads eval targets to max_decoder_l and decodes
        # max_decoder_l steps (model.lua:266-274)
        pad = lambda a: np.pad(a, ((0, 0), (0, T - a.shape[1])),
                               constant_values=vocab.PAD)
        targets, targets_eval = pad(batch.targets), pad(batch.targets_eval)
        use_trie = self.trie_table is not None
        if self._eval_step is not None:
            return self._step_eval_dp(batch, targets, targets_eval,
                                      B if valid_rows is None else valid_rows)
        out, nll, gold_scores = train_step.eval_decode_step(
            self.params, self.batch_stats, self._images(batch), targets,
            targets_eval, cfg, beam_size=cfg.beam_size, max_len=T,
            trie_table=self.trie_table, return_refills=use_trie)
        labels = out[0].cpu().numpy()
        refills, min_valid = ((int(x) for x in out[2]) if use_trie
                              else (0, 0))
        word_err, preds, golds = eval_lib.eval_word_err_rate(labels,
                                                             targets_eval)
        accuracy = B - word_err
        # CER on the decoded strings, natively when the library is built
        # (aocr/train.py:433-452)
        width = max(max((len(p) for p in preds), default=0),
                    max((len(g) for g in golds), default=0)) + 1
        dists = native.edit_distance_batch(
            vocab.encode_batch(preds, pad_to=width)[1],
            vocab.encode_batch(golds, pad_to=width)[1], vocab.EOS)
        if dists is None:
            dists = np.array([eval_lib.levenshtein(p, g)
                              for p, g in zip(preds, golds)])
        glens = np.maximum([len(g) for g in golds], 1)
        cer_sum = float(np.minimum(1.0, dists / glens).sum())
        if self.visualize_file is not None:
            self._write_visualize_rows(batch.img_paths, preds, golds,
                                       out[1].float().cpu().numpy(),
                                       gold_scores.float().cpu().numpy())
        self._log_refills(refills, min_valid)
        return float(nll), accuracy, cer_sum

    def _step_eval_dp(self, batch: data.Batch, targets, targets_eval,
                      valid_rows: int):
        """step_eval over the process group (aocr/train.py:368-402): the
        batch padded to a multiple of the ranks (-multihost: to the fixed
        local rows), each rank decoding its rows; accuracy and CER come
        back summed over the real rows, labels gathered for -visualize."""
        n = mesh_lib.world()
        im = batch.images if batch.raw is None else self._images(batch)
        real_b, im, tg, te = eval_parallel.pad_rows(
            n, im, targets, targets_eval,
            total_rows=self.local_bs if self._lockstep else None)
        real_b = min(real_b, valid_rows)
        mask = (np.arange(im.shape[0]) < real_b).astype(np.float32)
        if not self._lockstep:  # every rank holds the global batch
            im, tg, te, mask = mesh_lib.shard_batch(self.group, im, tg, te,
                                                    mask)
        out = self._eval_step(self.params, self.batch_stats,
                              torch.as_tensor(im).to(self.device), tg, te,
                              self.trie_table, torch.from_numpy(mask))
        if self.visualize_file is not None:
            _, preds, golds = eval_lib.eval_word_err_rate(
                out.labels.cpu().numpy()[:real_b], targets_eval[:real_b])
            self._write_visualize_rows(
                batch.img_paths, preds, golds,
                out.scores.cpu().numpy()[:real_b],
                out.gold_scores.cpu().numpy()[:real_b])
        self._log_refills(int(out.refills), int(out.min_valid))
        return float(out.nll), int(out.accuracy), float(out.cer_sum)

    def _write_visualize_rows(self, paths, preds, golds, scores,
                              gold_scores) -> None:
        for i, path in enumerate(paths[:len(preds)]):
            self.visualize_file.write(
                f"{path}\t{golds[i]}\t{preds[i]}\t{scores[i]:f}"
                f"\t{gold_scores[i]:f}\n")
        self.visualize_file.flush()

    def _log_refills(self, refills: int, min_valid: int) -> None:
        if self.trie_table is not None and refills:
            # the reference's per-row 'valid beam size' warnings
            # (model.lua:421,480), one line a batch
            self.log.info(f"Warning: valid beam size: {min_valid} "
                          f"({refills} refilled row-steps in batch)")

    # ------------------------------------------------------ batch stream

    def _dummy_batch(self) -> data.Batch:
        """An all-masked filler batch: processes whose epoch ended keep
        issuing the same collectives until every process is done."""
        cfg = self.cfg
        B, T = self.local_bs, cfg.max_decoder_l
        im = np.zeros((B, cfg.image_height, cfg.image_width, 1), np.float32)
        tg = np.full((B, T), vocab.PAD, np.int32)
        return data.Batch(im, tg, tg.copy(), 0, ["<dummy>"] * B)

    def _batches(self, gen):
        """Yield (batch, valid_rows, global_nnz, global_rows), prefetched;
        lockstep-synchronized across processes under -multihost."""
        it = data.prefetched(gen, self.cfg.prefetch)
        if self._lockstep:
            sync = partial(multihost.sync_counts, group=self._count_group)
            for b, real, g_nnz, g_rows in multihost.lockstep(
                    it, self._dummy_batch,
                    lambda bb: (bb.num_nonzeros, bb.rows), sync):
                yield b, (b.rows if real else 0), g_nnz, g_rows
        else:
            for b in it:
                yield b, b.rows, b.num_nonzeros, b.rows

    # ------------------------------------------------------- validation

    def validate(self, val_data: data.DataGen) -> tuple:
        if self._lockstep:
            return self._validate_lockstep(val_data)
        cfg = self.cfg
        self.log.info(f"Evaluating model on {cfg.num_batches_val} batches "
                      f"of validation data")
        val_loss = val_nnz = val_acc = val_samples = 0
        b = 1
        empty_sweeps = 0
        while b <= cfg.num_batches_val:
            if b % 100 == 0:
                self.log.info(str(b))
            batch = val_data.next_batch(cfg.batch_size)
            if batch is None:
                val_data.shuffle()
                if math.isinf(cfg.num_batches_val):
                    break
                empty_sweeps += 1
                if empty_sweeps >= 2 and val_samples == 0:
                    self.log.info("Warning: validation data produced no "
                                  "batches")
                    break
                continue
            empty_sweeps = 0
            loss, acc, _cer = self.step_eval(batch)
            val_loss += loss
            val_nnz += batch.num_nonzeros
            val_acc += acc
            val_samples += batch.rows
            b += 1
        return val_loss, val_nnz, val_acc, val_samples

    def _validate_lockstep(self, val_data: data.DataGen) -> tuple:
        """-multihost validation: one pass over the sharded manifest,
        capped at num_batches_val, with lockstep dummies; counts are
        global."""
        cfg = self.cfg
        self.log.info(f"Evaluating model on {cfg.num_batches_val} batches "
                      f"of validation data")
        val_loss = val_nnz = val_acc = val_samples = 0
        b = 0
        for batch, valid, g_nnz, g_rows in self._batches(
                val_data.epoch(self.local_bs)):
            if b >= cfg.num_batches_val:
                break  # b advances in lockstep: every rank breaks together
            loss, acc, _cer = self.step_eval(batch, valid)
            val_loss += loss  # summed over the group: equal on every rank
            val_nnz += g_nnz
            val_acc += acc
            val_samples += g_rows
            b += 1
        return val_loss, val_nnz, val_acc, val_samples

    def _save(self) -> None:
        """An npz-v2 checkpoint that either package resumes: the
        reference's parameter layout, optimizer state and meta.  Only
        rank 0 writes: the state is the same on every rank."""
        if multihost.process_info()[0] != 0:
            return
        state = weights.opt_state_to_numpy(self.opt_state)
        if isinstance(self.opt_state, optim.SGDState):
            self.optim_meta["eval_counter"] = int(state["eval_counter"])
            if state["momentum_buf"] is not None:
                self.optim_meta["momentum_buf"] = state["momentum_buf"]
                self.optim_meta["buf_fresh"] = bool(state["buf_fresh"])
        else:
            self.optim_meta["adadelta"] = state
        params, stats = weights.to_numpy(self.params, self.batch_stats)
        path = checkpoint.save(self.cfg.model_dir, params, stats,
                               asdict(self.cfg), self.global_step,
                               self.optim_meta)
        self.log.info(f"Model saved to {path}")

    # ------------------------------------------------------------ loops

    def _profiler(self):
        """A torch.profiler session tracing the CPU and, on CUDA, the
        device; its trace goes to <output_dir>/profile."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def _stop_profile(self, prof) -> None:
        prof.stop()
        trace_dir = os.path.join(self.cfg.output_dir, "profile")
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, f"trace-{self.global_step}.json")
        prof.export_chrome_trace(path)
        self.log.info(f"Profiler trace stopped -> {path}")

    def run_train(self, train_data: data.DataGen, val_data: data.DataGen):
        cfg, log = self.cfg, self.log
        sched = ValDrivenLR(
            self.optim_meta.get("learning_rate", cfg.learning_rate),
            cfg.learning_rate_min, cfg.lr_decay)
        self.optim_meta["learning_rate"] = sched.lr
        log.info(f"Lr: {sched.lr:f}")
        loss = num_nonzeros = 0

        def decay_lr(val_loss):
            if sched.update(val_loss):
                self.optim_meta["learning_rate"] = sched.lr
                log.info(f"Decay lr, current Lr: {sched.lr:f}")

        prof, profile_started_at = None, None
        steps_in_window = window_images = 0
        window_t0 = time.perf_counter()
        # one-deep pipeline of (pending loss, num_nonzeros): the perplexity
        # line uses the sums through step t-1 (the reference logs before
        # accumulating, train.lua:103) while step t runs
        inflight = []

        def drain(limit=0):
            nonlocal loss, num_nonzeros
            while len(inflight) > limit:
                pending, nnz = inflight.pop(0)
                loss += _read(pending)
                num_nonzeros += nnz

        for epoch in range(1, cfg.num_epochs + 1):
            train_data.shuffle()
            for batch, valid, g_nnz, g_rows in self._batches(
                    train_data.epoch(self.local_bs)):
                if cfg.profile and profile_started_at is None:
                    prof = self._profiler()
                    prof.start()
                    profile_started_at = self.global_step
                    log.info("Profiler trace started")
                step_loss = self.step_train(
                    batch, sched.lr, valid,
                    all_full=(g_rows == self._global_rows
                              if self._lockstep else None))
                inflight.append((step_loss, g_nnz))
                steps_in_window += 1
                window_images += g_rows
                if (prof is not None and self.global_step
                        - profile_started_at >= cfg.profile_steps):
                    self._stop_profile(prof)
                    prof = None
                drain(limit=1)
                ppl = (math.exp(min(loss / num_nonzeros, 700))
                       if num_nonzeros else float("nan"))
                log.info(f"{ppl:f}")
                self.global_step += 1
                if self.global_step % cfg.steps_per_checkpoint == 0:
                    drain()
                    ppl = (math.exp(min(loss / num_nonzeros, 700))
                           if num_nonzeros else float("nan"))
                    dt = time.perf_counter() - window_t0
                    log.info(f"Throughput: {steps_in_window / dt:.2f} "
                             f"steps/s, {window_images / dt:.0f} images/s")
                    steps_in_window = window_images = 0
                    log.info(f"Step {self.global_step} - training "
                             f"perplexity = {ppl:f}")
                    log.info("Saving model")
                    self._save()
                    loss = num_nonzeros = 0
                    val_loss, val_nnz, val_acc, val_n = self.validate(
                        val_data)
                    log.info(
                        f"Step {self.global_step} - Val Accuracy = "
                        f"{val_acc / max(val_n, 1):f}, loss = "
                        f"{math.exp(min(val_loss / max(val_nnz, 1), 700)):f}")
                    decay_lr(val_loss)
                    # the next window times training steps only
                    window_t0 = time.perf_counter()
            drain()
            self._save()
            val_loss, val_nnz, val_acc, val_n = self.validate(val_data)
            log.info(
                f"Epoch: {epoch}, Step {self.global_step} - Val Accuracy = "
                f"{val_acc / max(val_n, 1):f}, loss = "
                f"{math.exp(min(val_loss / max(val_nnz, 1), 700)):f}")
            decay_lr(val_loss)
        if prof is not None:
            self._stop_profile(prof)

    def run_test(self, test_data: data.DataGen) -> float:
        cfg, log = self.cfg, self.log
        if cfg.visualize and multihost.process_info()[0] == 0:
            os.makedirs(cfg.output_dir, exist_ok=True)
            self.visualize_file = open(
                os.path.join(cfg.output_dir, "results.txt"), "w")
        num_samples = accuracy = 0
        cer = 0.0
        self.global_step = 0
        for batch, valid, _g_nnz, g_rows in self._batches(
                test_data.epoch(self.local_bs)):
            _, acc, cer_sum = self.step_eval(batch, valid)
            accuracy += acc
            cer += cer_sum
            num_samples += g_rows
            self.global_step += 1
            if self.global_step % cfg.steps_per_checkpoint == 0:
                log.info(f"Number of samples {num_samples} - Accuracy = "
                         f"{accuracy / num_samples:f}")
        log.info(f"Epoch: 1 Number of samples {num_samples} - Accuracy = "
                 f"{accuracy / max(num_samples, 1):f}")
        log.info(f"Character error rate (normalized edit distance) = "
                 f"{cer / max(num_samples, 1):f}")
        if self.visualize_file is not None:
            self.visualize_file.close()
            self.visualize_file = None
        return accuracy / max(num_samples, 1)


def main(argv=None, device=None) -> None:
    """The CLI: parse argv (default sys.argv[1:]) as aocr.train does and
    run the phase on `device` (default: the CUDA device)."""
    cfg = parse_args(argv)
    _check_parallel(cfg)
    dev = _device(cfg, device)
    if _parallel(cfg):
        _join_group(cfg, dev)
    rank = multihost.process_info()[0]
    log = Logger(cfg.log_path) if rank == 0 else _Quiet()
    log.info("Command Line Arguments:")
    log.info(" ".join(argv if argv is not None else sys.argv[1:]))
    log.info("End Command Line Arguments")
    log.info(f"Torch device: {dev}"
             + (f" ({torch.cuda.get_device_name(dev)})"
                if dev.type == "cuda" else ""))

    log.info("Building model")
    trainer = Trainer(cfg, log, dev)
    cfg = trainer.cfg

    log.info(f"Data base dir {cfg.data_base_dir}")
    log.info(f"Load training data from {cfg.data_path}")
    train_data = data.DataGen(cfg.data_base_dir, cfg.data_path, cfg,
                              log=log.info)
    log.info(f"Training data loaded from {cfg.data_path}")
    if cfg.multihost:
        train_data.shard(*multihost.process_info())
        log.info(f"Manifest sharded: {train_data.size()} rows on process "
                 f"{rank}")
    if cfg.phase == "train":
        log.info(f"Load validation data from {cfg.val_data_path}")
        val_data = data.DataGen(cfg.data_base_dir, cfg.val_data_path, cfg,
                                log=log.info)
        log.info(f"Validation data loaded from {cfg.val_data_path}")
        if cfg.multihost:
            val_data.shard(*multihost.process_info())
        trainer.run_train(train_data, val_data)
    else:
        trainer.run_test(train_data)
    log.shutdown()


if __name__ == "__main__":
    main()
