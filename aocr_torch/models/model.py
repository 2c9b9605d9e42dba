"""The whole model: CNN -> bi-LSTM encoder -> attention decoder -> head
(counterpart of aocr/models/model.py: init, encode, num_params).

Parameters are the reference's five groups {cnn, encoder_fw, encoder_bw,
decoder, projector} as nested dicts of tensors; the BatchNorm running
statistics travel separately in `batch_stats`.  Conv weights are stored
(O, I, kh, kw), PyTorch's layout; aocr_torch.weights converts to and from
the reference's (kh, kw, I, O).
"""

from __future__ import annotations

from typing import Tuple

import torch

from aocr.config import Config
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
           cfg: Config):
    """images (B, 32, W, 1) -> (context (B, L, 2H), dec_init (c0, h0)).

    With cfg.use_pallas the conv1 and encoder kernels run (on CUDA
    tensors); use_pallas=False is the plain route throughout."""
    cd = compute_dtype(cfg)
    features = cnn.apply(params["cnn"], batch_stats, images, cd,
                         use_kernel=cfg.use_pallas)
    return encoder.apply(params["encoder_fw"], params["encoder_bw"],
                         features, cd, use_kernel=cfg.use_pallas)


def num_params(params: dict) -> int:
    def count(tree):
        if isinstance(tree, dict):
            return sum(count(v) for v in tree.values())
        if isinstance(tree, (list, tuple)):
            return sum(count(v) for v in tree)
        return tree.numel()

    return count(params)
