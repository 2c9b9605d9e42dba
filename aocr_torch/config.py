"""Configuration for the tpu-attention-ocr framework: the port's own copy
of aocr/config.py.  Every field, default, GEOMETRY_FIELDS and
STRUCT_FIELDS stay as they are there, so checkpoints cross between the
packages both ways (tests/test_torch_port_trie.py holds the two equal).
The `use_pallas`/`pallas_*` switches select the port's CUDA kernels.

Mirrors the reference CLI surface (flag-for-flag) declared in
`reference src/train.lua:15-65`, plus TPU-specific extensions
(dtype policy, mesh shape, Pallas toggles).  The reference parses flags with
`torch.CmdLine`; here a frozen dataclass is the single source of truth and
`build_arg_parser` derives an argparse CLI from it.  Single-dash long options
(`-phase train`) are accepted for drop-in compatibility as well as
conventional `--phase train`.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class Config:
    # --- Input and Output (reference src/train.lua:21-26) ---
    data_base_dir: str = "data"
    data_path: str = "train.txt"
    val_data_path: str = "val.txt"
    model_dir: str = "train"
    log_path: str = "log.txt"
    output_dir: str = "results"

    # --- Display / decoding (reference src/train.lua:29-34) ---
    steps_per_checkpoint: int = 1000
    num_batches_val: float = math.inf
    beam_size: int = 1
    use_dictionary: bool = False
    allow_digit_prefix: bool = False
    dictionary_path: str = "dictionary.txt"

    # --- Optimization (reference src/train.lua:40-44) ---
    num_epochs: int = 1000
    batch_size: int = 400
    learning_rate: float = 0.1
    learning_rate_min: float = 0.001
    lr_decay: float = 0.5

    # --- Network (reference src/train.lua:47-53) ---
    dropout: float = 0.0
    target_embedding_size: int = 20
    # Feed h~ of the previous step into decoder layer 0 beside the token
    # embedding (the reference's -input_feed).  Off, the CLI trainer's
    # default, layer 0's weights hold one segment instead of two; the
    # decoder kernels take either (the library's AttentionOCR.create and
    # chip_smoke.py's main paths set it, its no-input-feed phase not).
    input_feed: bool = False
    encoder_num_hidden: int = 512
    encoder_num_layers: int = 1
    decoder_num_layers: int = 2
    target_vocab_size: int = 39  # 1 PAD + 1 GO + 1 EOS + 10 digits + 26 letters
    # The reference's additive attention-combination variant
    # (src/model/LSTM.lua:152-160: h~ = ctx + h instead of
    # tanh(W_c [ctx; h])).  Its own code always passes simple=0
    # (src/model/LSTM.lua:113), so this defaults off; the flag exists so
    # the dead variant is reachable rather than unimplemented.
    simple_attention: bool = False

    # --- Other (reference src/train.lua:56-63) ---
    phase: str = "test"
    gpu_id: int = 1  # kept for CLI parity; device selection is JAX's job
    load_model: bool = False
    visualize: bool = False
    seed: int = 910820
    max_decoder_l: int = 50
    max_encoder_l: int = 80
    # `-prealloc` in the reference enables buffer preallocation/sharing between
    # timestep clones (src/utils/memory.lua).  XLA owns buffers under jit; the
    # equivalent lever is input buffer donation on the train step, so the flag
    # maps to donate_argnums.
    prealloc: bool = False

    # Optimizer selection: the reference ships both but hard-wires SGD and
    # leaves its (buggy) Adadelta call site commented out
    # (src/model/model.lua:699-700); here it's a flag.
    optimizer: str = "sgd"  # "sgd" | "adadelta"
    # SGD hyper surface (reference src/optim/optim_sgd.lua:28-33,54-91:
    # learningRateDecay / weightDecay / momentum / dampening / nesterov —
    # supported by the reference optimizer but never set by its CLI; exposed
    # as flags here).  dampening < 0 means "default to momentum", the
    # reference's `config.dampening or mom` rule.
    momentum: float = 0.0
    weight_decay: float = 0.0
    dampening: float = -1.0
    nesterov: bool = False
    sgd_learning_rate_decay: float = 0.0

    # Allow loading legacy v1 (pickle) checkpoints.  Off by default:
    # unpickling executes code embedded in the file; v2 checkpoints are
    # plain npz archives and always load.
    allow_pickle_ckpt: bool = False

    # --- Observability (SURVEY.md section 5 rebuild hooks) ---
    # Capture a jax.profiler trace of training steps into
    # <output_dir>/profile (viewable with TensorBoard / xprof).
    profile: bool = False
    profile_steps: int = 10
    # Log per-group parameter/gradient norms every step (the reference's
    # SGD prints these unconditionally, src/optim/optim_sgd.lua:49).
    log_norms: bool = False

    # --- TPU-native extensions (no reference equivalent) ---
    # Compute dtype for convs/matmuls; params always float32.
    compute_dtype: str = "float32"  # or "bfloat16"
    # The decoder's CUDA kernels (aocr_torch/ops/cuda; the names keep the
    # reference's "pallas").  -no_use_pallas runs every decode on the
    # plain PyTorch route; kernel wrappers given CPU tensors run their
    # plain versions either way.
    use_pallas: bool = True
    # Which greedy kernel use_pallas selects (aocr_torch/decode.py):
    # "auto" runs the whole decode as one greedy_loop launch where its
    # cluster plan fits the shape, else the per-step decode_step tail,
    # else the plain route; "loop"/"tail" force one for A/B measurement
    # and warn where it has no plan.
    pallas_greedy: str = "auto"  # "auto" | "loop" | "tail"
    # Which beam kernel use_pallas selects: "auto" runs the search after
    # its t=1 step as one beam_loop launch where its plan fits (beams up
    # to beam_loop.MAX_K), else a beam_step launch a step (any batch:
    # the reference's B>=512 gate is a TPU measurement), else the plain
    # route; "loop"/"tail" force one and warn where it has no plan.
    pallas_beam: str = "auto"  # "auto" | "loop" | "tail"
    # Cache decoded images in RAM after first touch (the reference caches
    # unconditionally, data_gen.lua:80; disable for datasets larger than
    # host memory).
    cache_images: bool = True
    # Background data prefetch depth (batches prepared ahead while the
    # device computes); 0 disables the prefetch thread.
    prefetch: int = 2
    # Device-side preprocessing: the host only *decodes* images (JPEG/PNG
    # -> raw RGB bytes); luminance, aspect resize, and normalization run
    # as one jitted XLA program per batch (aocr.preprocess).  Lifts the
    # ~10x host-resize bottleneck on cold-cache datasets (docs/
    # performance.md "Host-side data path").
    device_preprocess: bool = False
    # Image-decode thread pool size (PIL releases the GIL during decode,
    # so decodes parallelize); 0 decodes inline on the batching thread.
    decode_workers: int = 8
    # Length-normalized beam selection: pick the final beam by
    # score / emitted-length instead of raw cumulative log-prob (the
    # reference uses raw scores; this is the BASELINE config-3 variant).
    length_normalize: bool = False
    # Rematerialize the decoder scan body in the backward pass
    # (jax.checkpoint): trades recompute FLOPs for activation HBM — lets
    # batch size scale beyond what stored per-step activations allow.
    remat: bool = False
    # Custom-VJP teacher-forced decoder scan (decoder._tf_core): weight
    # gradients hoisted out of the backward loop + the backward recurrence
    # as one Pallas kernel on TPU/bf16 (ops/pallas/tf_bwd.py).
    # Gradient-parity-tested against autodiff; -no_decoder_custom_vjp
    # reverts to the plain autodiff scan.
    decoder_custom_vjp: bool = True
    # Fuse the encoder fw+bw layer-0 input projections into one
    # (L*B, D) @ (D, 8H) matmul (lstm.bidirectional_scan), in both the
    # forward and the backward pass.  Same math as the per-direction
    # scans (parity-tested); default off until chip-A/B'd
    # (docs/performance.md "Known headroom").
    fused_encoder_proj: bool = False
    # Number of data-parallel shards (devices along the "data" mesh axis).
    num_shards: int = 1
    # Number of tensor-parallel shards (devices along the "model" mesh
    # axis): shards the wide decoder matmuls + projector via GSPMD.
    # Composes with num_shards (DP x TP needs num_shards*num_model_shards
    # devices).
    num_model_shards: int = 1
    # Multi-host (pod) training: call jax.distributed.initialize, shard the
    # manifest per process, and run the lockstep data path (fixed batch
    # shapes + dummy-batch epoch drain).  See aocr/parallel/multihost.py.
    multihost: bool = False
    # On-device training-time augmentation (aocr/augment.py): random
    # affine jitter + brightness/contrast + Gaussian noise applied inside
    # the jitted train step, keyed per GLOBAL row index so data-parallel
    # training augments bit-identically to single-device.  The reference
    # has no augmentation (its data layer only decodes/resizes,
    # src/data/data_gen.lua).
    augment: bool = False
    # Scales every augmentation magnitude (0 disables geometrically but
    # still runs the resample; prefer -no_augment to switch off).
    augment_strength: float = 1.0
    # Pad every batch's targets to max_decoder_l instead of the batch max:
    # ONE jitted train program instead of one per distinct target length.
    # Costs decoder steps on short batches; wins whenever compiles are
    # expensive relative to training (cold caches, short runs) or when a
    # bounded program count matters.  Implied by -multihost.
    pad_targets: bool = False
    # Image geometry (reference hard-codes 32-tall, width 100:
    # src/data/data_gen.lua:16,78). keep_aspect_ratio=False reproduces the
    # hard-coded width-100 behavior; True uses the clamped aspect-ratio
    # width (16 ... 320 at 32 tall, so contexts of L = W/4 - 1 = 3 ... 79
    # steps; the decoder kernels plan for each L, and the server and a
    # multi-width .aocrx pad up to data.width_ladder's steps).
    image_height: int = 32
    image_width: int = 100
    keep_aspect_ratio: bool = False
    max_aspect_ratio: float = 10.0
    min_aspect_ratio: float = 0.5
    # Under -keep_aspect_ratio, round each preprocessed width UP to the
    # shared geometric width ladder (data.width_ladder — the same steps
    # serving and multi-width .aocrx export use).  Natural word widths are
    # near-unique (a 3k-word corpus spans ~180 distinct widths), and each
    # distinct width is a separately compiled program for train AND eval;
    # snapping bounds that to the <=9 ladder steps for <=1.5x horizontal
    # padding.  Off by default: exact widths reproduce the un-snapped
    # aspect behavior and serve single-width corpora with zero padding.
    snap_width_ladder: bool = False

    # Geometry fields (GEOMETRY_FIELDS) the caller EXPLICITLY set — even to
    # their default values.  Checkpoint loading keeps the checkpoint's
    # geometry unless a field was explicitly overridden (reference
    # model.lua:75-77 CLI-override semantics); without this record an
    # explicit `-image_width 100` (the default) would be indistinguishable
    # from "not passed" and silently lose to the checkpoint.  parse_args
    # fills it from argv; API callers use cfg.with_explicit_geometry(...)
    # or rely on the changed-from-default heuristic.
    explicit_geometry: tuple = ()

    # --- Derived (reference src/model/model.lua:84,88) ---
    cnn_feature_size: int = field(default=512)

    def __post_init__(self):
        # keep hashability when constructed from JSON dicts (lists)
        if not isinstance(self.explicit_geometry, tuple):
            object.__setattr__(self, "explicit_geometry",
                               tuple(self.explicit_geometry))

    def with_explicit_geometry(self, *names: str) -> "Config":
        """Mark geometry fields as explicitly set so checkpoint loading
        honors their current values even when they equal the defaults."""
        for n in names:
            assert n in GEOMETRY_FIELDS, f"{n} is not a geometry field"
        return self.replace(
            explicit_geometry=tuple(sorted(set(self.explicit_geometry)
                                           | set(names)))
        )

    def geometry_overrides(self) -> set:
        """Geometry fields whose caller-supplied values must win over a
        checkpoint's: explicitly marked, or changed from the defaults."""
        defaults = Config()
        return set(self.explicit_geometry) | {
            k for k in GEOMETRY_FIELDS
            if getattr(self, k) != getattr(defaults, k)
        }

    @property
    def decoder_num_hidden(self) -> int:
        return 2 * self.encoder_num_hidden

    def validate(self) -> "Config":
        assert self.phase in ("train", "test"), "phase must be train or test"
        assert self.encoder_num_layers >= 1
        assert self.decoder_num_layers >= 1
        assert self.target_vocab_size >= 4
        assert self.compute_dtype in ("float32", "bfloat16")
        assert self.optimizer in ("sgd", "adadelta")
        assert self.pallas_greedy in ("auto", "loop", "tail")
        assert self.pallas_beam in ("auto", "loop", "tail")
        assert self.augment_strength >= 0, "augment_strength must be >= 0"
        # Reference assert (optim_sgd.lua:35): Nesterov momentum requires a
        # momentum and zero dampening.
        effective_damp = self.momentum if self.dampening < 0 else self.dampening
        assert not self.nesterov or (self.momentum > 0
                                     and effective_damp == 0.0), (
            "Nesterov momentum requires a momentum and zero dampening"
        )
        assert not (self.snap_width_ladder and self.device_preprocess), (
            "-snap_width_ladder pads on the host after the aspect resize; "
            "-device_preprocess resizes on-device and does not snap yet"
        )
        return self

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


# Config fields that define the trained model's STRUCTURE: they are saved
# in every checkpoint and always restored on load (the reference restores
# them from the serialized modules, model.lua:63-77).  Owned here, next to
# the dataclass, so the inference path (aocr.api) does not have to import
# the training stack for them.
STRUCT_FIELDS = (
    "dropout", "encoder_num_hidden", "encoder_num_layers",
    "decoder_num_layers", "target_vocab_size", "target_embedding_size",
    "input_feed", "cnn_feature_size", "simple_attention",
)

# Sequence bounds / image geometry: restored from the checkpoint unless
# explicitly overridden (reference model.lua:75-77 lets the CLI override).
GEOMETRY_FIELDS = (
    "max_decoder_l", "max_encoder_l", "image_height", "image_width",
    "keep_aspect_ratio", "max_aspect_ratio", "min_aspect_ratio",
    "snap_width_ladder",
)

def build_arg_parser() -> argparse.ArgumentParser:
    """Derive an argparse CLI from the Config dataclass fields.

    argparse treats `-phase` (single dash, multi-char) as a regular long
    option, so both the reference's Lua-style flags and GNU-style `--phase`
    work.
    """
    p = argparse.ArgumentParser(
        prog="aocr",
        description="TPU-native attention OCR (reference-compatible CLI)",
    )
    for f in dataclasses.fields(Config):
        name = f.name
        if name in ("cnn_feature_size", "explicit_geometry"):
            continue
        opts = [f"-{name}", f"--{name}"]
        if isinstance(f.default, bool):
            # EVERY boolean gets both spellings: -<name> / -no_<name>.
            # Default-on flags need -no_<name> to disable (v0.1 scripts'
            # affirmative -use_pallas stays a valid no-op); default-off
            # flags need it because a checkpoint can restore the field
            # True (e.g. keep_aspect_ratio rides GEOMETRY_FIELDS) and the
            # CLI must be able to override it off (model.lua:75-77).
            # Registration order makes the first action own the default.
            if f.default:
                p.add_argument(
                    f"-no_{name}", f"--no_{name}", dest=name,
                    action="store_false", default=f.default,
                )
                p.add_argument(*opts, dest=name, action="store_true")
            else:
                p.add_argument(*opts, action="store_true", default=f.default)
                p.add_argument(
                    f"-no_{name}", f"--no_{name}", dest=name,
                    action="store_false",
                )
        elif f.type in ("float", float) or isinstance(f.default, float):
            p.add_argument(*opts, type=float, default=f.default)
        elif f.type in ("int", int) or isinstance(f.default, int):
            p.add_argument(*opts, type=int, default=f.default)
        else:
            p.add_argument(*opts, type=str, default=f.default)
    return p


def parse_args(argv: Optional[list] = None) -> Config:
    import sys

    ns = build_arg_parser().parse_args(argv)
    kw = {k: v for k, v in vars(ns).items()}
    # Record which geometry flags were explicitly present on the command
    # line (even set to their defaults) so checkpoint loading lets them
    # override the checkpoint's geometry, exactly like the reference CLI
    # (model.lua:75-77).
    tokens = list(sys.argv[1:] if argv is None else argv)
    explicit = []
    for name in GEOMETRY_FIELDS:
        spellings = {f"-{name}", f"--{name}",
                     f"-no_{name}", f"--no_{name}"}
        if any(t.split("=", 1)[0] in spellings for t in tokens):
            explicit.append(name)
    kw["explicit_geometry"] = tuple(explicit)
    return Config(**kw).validate()


def config_from_dict(d: dict) -> Config:
    names = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in d.items() if k in names})
