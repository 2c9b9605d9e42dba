"""Data parallelism for the port (counterpart of aocr/parallel): one
process per device over a torch.distributed process group, the group
standing for aocr's mesh data axis (rank = shard).

- `mesh`: the group's size and this rank's rows of a global batch, the
  collectives the steps use, the device lists `AttentionOCR.shard`
  splits over;
- `data_parallel.make_dp_train_step`: the train step on this rank's rows,
  sync-BN, one gradient all-reduce before the optimizer;
- `eval_parallel.make_dp_eval_step`: beam or greedy decode, the gold
  pass and the metrics on this rank's rows, reduced and gathered;
- `multihost`: torchrun initialization, per-host row counts, lockstep
  batches across hosts.

Tensor parallelism (aocr/parallel/tensor_parallel.py) is not ported.
"""
