"""The whole model: CNN -> bi-LSTM encoder -> attention decoder -> head
(counterpart of aocr/models/model.py: init, encode, forward_loss,
loss_from_context, num_params).

Parameters are the reference's five groups {cnn, encoder_fw, encoder_bw,
decoder, projector} as nested dicts of tensors; the BatchNorm running
statistics travel separately in `batch_stats`.  Conv weights are stored
(O, I, kh, kw), PyTorch's layout; aocr_torch.weights converts to and from
the reference's (kh, kw, I, O).
"""

from __future__ import annotations

from typing import Tuple

import torch

from aocr_torch.config import Config
from aocr_torch import loss as loss_lib
from aocr_torch.models import cnn, decoder, encoder, head


def compute_dtype(cfg: Config) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def init(cfg: Config, gen: torch.Generator, device="cpu"
         ) -> Tuple[dict, dict]:
    """Random (params, batch_stats) with the reference's init laws, drawn
    from `gen` (not the JAX package's random stream)."""
    params = {
        "cnn": cnn.init_params(gen, device),
        "encoder_fw": encoder.init_params(
            gen, cfg.cnn_feature_size, cfg.encoder_num_hidden,
            cfg.encoder_num_layers, device),
        "encoder_bw": encoder.init_params(
            gen, cfg.cnn_feature_size, cfg.encoder_num_hidden,
            cfg.encoder_num_layers, device),
        "decoder": decoder.init_params(
            gen, cfg.target_vocab_size, cfg.target_embedding_size,
            cfg.decoder_num_hidden, cfg.decoder_num_layers, cfg.input_feed,
            device),
        "projector": head.init_params(gen, cfg.decoder_num_hidden,
                                      cfg.target_vocab_size, device),
    }
    return params, cnn.init_batch_stats(device)


def encode(params: dict, batch_stats: dict, images: torch.Tensor,
           cfg: Config, train: bool = False, row_mask=None, group=None):
    """images (B, 32, W, 1) -> (context (B, L, 2H), dec_init (c0, h0)), and
    with train=True also the new batch_stats (train-mode BatchNorm over
    the rows row_mask (B,) marks, when given; synchronized over the
    process group `group`, when given).

    With cfg.use_pallas the kernels run (on CUDA tensors); use_pallas=False
    is the plain route throughout."""
    cd = compute_dtype(cfg)
    out = cnn.apply(params["cnn"], batch_stats, images, cd,
                    use_kernel=cfg.use_pallas, train=train,
                    row_mask=row_mask, group=group)
    features, new_stats = out if train else (out, None)
    context, dec_init = encoder.apply(params["encoder_fw"],
                                      params["encoder_bw"], features, cd,
                                      use_kernel=cfg.use_pallas)
    return (context, dec_init, new_stats) if train else (context, dec_init)


def forward_loss(params: dict, batch_stats: dict, images: torch.Tensor,
                 targets: torch.Tensor, targets_eval: torch.Tensor,
                 cfg: Config, train: bool = False, row_mask=None,
                 group=None):
    """Teacher-forced forward pass: (token-sum NLL, new batch_stats,
    log_probs (B, T, V) float32).  In eval mode batch_stats come back
    unchanged; row_mask and group as in encode."""
    if train:
        context, dec_init, new_stats = encode(params, batch_stats, images,
                                              cfg, train=True,
                                              row_mask=row_mask,
                                              group=group)
    else:
        (context, dec_init), new_stats = encode(params, batch_stats, images,
                                                cfg), batch_stats
    nll, log_probs = loss_from_context(params, context, dec_init, targets,
                                       targets_eval, cfg, train)
    return nll, new_stats, log_probs


def loss_from_context(params: dict, context: torch.Tensor, dec_init,
                      targets: torch.Tensor, targets_eval: torch.Tensor,
                      cfg: Config, train: bool = False):
    """Teacher-forced decode + loss from an encoder context: (token-sum
    NLL, log_probs)."""
    cd = compute_dtype(cfg)
    h_tildes = decoder.teacher_forced(
        params["decoder"], dec_init, targets, context,
        input_feed=cfg.input_feed, compute_dtype=cd, dropout=cfg.dropout,
        train=train, remat=cfg.remat, simple=cfg.simple_attention,
        custom_grad=cfg.decoder_custom_vjp, use_kernel=cfg.use_pallas)
    log_probs = head.apply(params["projector"], h_tildes, cd)
    return loss_lib.nll_sum(log_probs, targets_eval), log_probs


def num_params(params: dict) -> int:
    def count(tree):
        if isinstance(tree, dict):
            return sum(count(v) for v in tree.values())
        if isinstance(tree, (list, tuple)):
            return sum(count(v) for v in tree)
        return tree.numel()

    return count(params)
