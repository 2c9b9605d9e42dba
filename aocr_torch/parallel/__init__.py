"""Data and tensor parallelism for the port (counterpart of
aocr/parallel): one process per device over a torch.distributed process
group, the group standing for aocr's mesh data axis (rank = shard), or a
(data, model) grid of groups.

- `mesh`: the group's size and this rank's rows of a global batch, the
  collectives the steps use, the device lists `AttentionOCR.shard`
  splits over, the (data, model) `Grid`;
- `data_parallel.make_dp_train_step`: the train step on this rank's rows,
  sync-BN, one gradient all-reduce before the optimizer;
- `tensor_parallel.make_tp_train_step`: DP x TP, the decoder's and the
  projector's weights sharded over the model axis;
- `eval_parallel.make_dp_eval_step`: beam or greedy decode, the gold
  pass and the metrics on this rank's rows, reduced and gathered;
- `multihost`: torchrun initialization, per-host row counts, lockstep
  batches across hosts.
"""
