"""Import the reference's Torch7 checkpoints (the port's counterpart of
aocr/torch_import.py and tools/import_torch.py; numpy and the port's own
modules only).

    python -m aocr_torch.torch_import <checkpoint.t7> <model_dir> \
        [--summary] [--long_size 4]

The reference saves `{ {cnn, encoder_fw, encoder_bw, decoder,
output_projector}, config, global_step, optim_state }` (its
src/model/model.lua:724): five serialized nn/nngraph module trees.  This
module deserializes that stream (aocr_torch.t7) and maps the weights onto
the {cnn, encoder_fw, encoder_bw, decoder, projector} tree in the npz-v2
checkpoint layout that both packages load (conv weights HWIO, as
aocr_torch.weights.from_numpy expects):

- conv weights (nOut, nIn, kH, kW) -> NHWC HWIO (kh, kw, in, out)
- BatchNorm weight/bias/running_mean/running_var -> scale/bias/mean/var
  (legacy `running_std` converted: var = 1/std^2 - eps)
- fused-gate LSTM: i2h nn.Linear(in, 4H) / h2h nn.Linear(H, 4H)
  (the reference's src/model/LSTM.lua:79-87) -> wi/wh transposed to
  (in, 4H) column layout + bi/bh; the [i|f|o|g] gate order
  (LSTM.lua:90-105) is the port's gate order, so the 4H axis maps
  through unchanged
- LookupTable.weight -> decoder embedding (V, E)
- attention LinearNoBias(H, H) -> w_a^T, LinearNoBias(2H, H) -> w_c^T
  (LSTM.lua:131,155; the [context ; h_top] concat order is the
  decoder's)
- output projector nn.Linear(H, V) -> head {w^T, b}

Module identification: containers expose an ordered `modules` list
(nn.Sequential stores it; nngraph's gModule collects node modules in
topological order).  Within an LSTM layer, i2h/h2h are matched by the
`name`/`prealloc` tags (the reference's src/utils/memory.lua:62-63,
present when the checkpoint was trained with -prealloc) and fall back to
creation order (i2h before h2h, LSTM.lua:79-87); the two attention
projections are unambiguous by shape.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Tuple

import numpy as np

from aocr_torch import t7
from aocr_torch.models.cnn import CONV_DEFS
from aocr_torch.t7 import TorchObject

PARAM_CLASSES = {
    "nn.Linear",
    "nn.LinearNoBias",
    "nn.LookupTable",
    "nn.SpatialConvolution",
    "cudnn.SpatialConvolution",
    "nn.SpatialBatchNormalization",
    "cudnn.SpatialBatchNormalization",
}


def _f32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def iter_leaf_modules(obj: Any) -> Iterator[TorchObject]:
    """Yield parameterized leaf modules in container order (depth-first
    through `modules` lists; falls back to nngraph forwardnodes)."""
    if not isinstance(obj, TorchObject):
        return
    mods = obj.get("modules")
    if not mods and obj.get("forwardnodes"):
        mods = []
        for node in obj["forwardnodes"]:
            data = node.get("data") if isinstance(node, TorchObject) else None
            m = data.get("module") if isinstance(data, TorchObject) else None
            if m is None and isinstance(data, dict):
                m = data.get("module")
            if m is not None:
                mods.append(m)
    if mods:
        for m in mods:
            yield from iter_leaf_modules(m)
    elif obj.torch_typename in PARAM_CLASSES:
        yield obj


def _conv_weight(m: TorchObject) -> np.ndarray:
    w = _f32(m["weight"])
    if w.ndim == 2:  # flattened (nOut, nIn*kH*kW) view
        w = w.reshape(int(m["nOutputPlane"]), int(m["nInputPlane"]),
                      int(m["kH"]), int(m["kW"]))
    return w.transpose(2, 3, 1, 0)  # OIHW -> HWIO


def _bn_stats(m: TorchObject) -> Tuple[dict, dict]:
    scale = _f32(m["weight"])
    bias = _f32(m["bias"])
    mean = _f32(m["running_mean"])
    if "running_var" in m:
        var = _f32(m["running_var"])
    else:  # ancient torch stored running_std = 1/sqrt(var + eps)
        eps = float(m.get("eps", 1e-5))
        std = _f32(m["running_std"])
        var = 1.0 / np.square(std) - eps
    return {"scale": scale, "bias": bias}, {"mean": mean, "var": var}


def map_cnn(cnn_obj: TorchObject) -> Tuple[dict, dict]:
    """nn.Sequential conv stack -> (cnn params, batch_stats)."""
    convs = [m for m in iter_leaf_modules(cnn_obj)
             if m.torch_typename.endswith("SpatialConvolution")]
    bns = [m for m in iter_leaf_modules(cnn_obj)
           if m.torch_typename.endswith("SpatialBatchNormalization")]
    assert len(convs) == len(CONV_DEFS), (
        f"expected {len(CONV_DEFS)} convs, found {len(convs)}"
    )
    params: Dict[str, dict] = {}
    stats: Dict[str, dict] = {}
    bn_it = iter(bns)
    for (name, in_c, out_c, kh, kw, _pad, bn), m in zip(CONV_DEFS, convs):
        w = _conv_weight(m)
        assert w.shape == (kh, kw, in_c, out_c), (
            f"{name}: torch conv shape {w.shape} != {(kh, kw, in_c, out_c)}"
        )
        params[name] = {"w": w, "b": _f32(m["bias"])}
        if bn:
            p, s = _bn_stats(next(bn_it))
            params[name + "_bn"] = p
            stats[name + "_bn"] = s
    return params, stats


def _pair_lstm_linears(linears: List[TorchObject], num_hidden: int,
                       where: str) -> List[Tuple[TorchObject, TorchObject]]:
    """Group a gModule's nn.Linear leaves into per-layer (i2h, h2h) pairs.

    Uses the usePrealloc name tags when present; otherwise creation order
    (i2h first).  Shapes are asserted either way: every weight must be
    (4H, in)."""
    assert len(linears) % 2 == 0, f"{where}: odd linear count {len(linears)}"
    pairs = []
    for li in range(0, len(linears), 2):
        a, b = linears[li], linears[li + 1]
        na = str(a.get("name") or a.get("prealloc") or "")
        nb = str(b.get("name") or b.get("prealloc") or "")
        if "h2h" in na and "i2h" in nb:
            a, b = b, a  # tagged: order-proof
        wa, wb = _f32(a["weight"]), _f32(b["weight"])
        assert wa.shape[0] == 4 * num_hidden == wb.shape[0], (
            f"{where} layer {li // 2 + 1}: gate shapes {wa.shape}/{wb.shape}"
        )
        assert wb.shape[1] == num_hidden, (
            f"{where} layer {li // 2 + 1}: h2h in-dim {wb.shape[1]} != "
            f"{num_hidden} — i2h/h2h order differs from LSTM.lua:79-87; "
            "re-export with -prealloc so modules carry name tags"
        )
        pairs.append((a, b))
    return pairs


def _lstm_layer(i2h: TorchObject, h2h: TorchObject) -> dict:
    return {
        "wi": _f32(i2h["weight"]).T.copy(),  # (in, 4H)
        "bi": _f32(i2h["bias"]),
        "wh": _f32(h2h["weight"]).T.copy(),  # (H, 4H)
        "bh": _f32(h2h["bias"]),
    }


def map_encoder(enc_obj: TorchObject, num_hidden: int, where: str) -> dict:
    leaves = list(iter_leaf_modules(enc_obj))
    linears = [m for m in leaves if m.torch_typename == "nn.Linear"]
    pairs = _pair_lstm_linears(linears, num_hidden, where)
    return {"layers": [_lstm_layer(a, b) for a, b in pairs]}


def map_decoder(dec_obj: TorchObject, num_hidden: int) -> dict:
    leaves = list(iter_leaf_modules(dec_obj))
    lookups = [m for m in leaves if m.torch_typename == "nn.LookupTable"]
    assert len(lookups) == 1, f"expected 1 LookupTable, got {len(lookups)}"
    linears = [m for m in leaves if m.torch_typename == "nn.Linear"]
    nobias = [m for m in leaves if m.torch_typename == "nn.LinearNoBias"]
    assert len(nobias) == 2, (
        f"expected 2 attention projections, got {len(nobias)}"
    )
    # w_a: (H, H); w_c: (H, 2H) — unambiguous by input width
    w_a_m = [m for m in nobias
             if _f32(m["weight"]).shape[1] == num_hidden]
    w_c_m = [m for m in nobias
             if _f32(m["weight"]).shape[1] == 2 * num_hidden]
    assert len(w_a_m) == 1 and len(w_c_m) == 1, "ambiguous attention shapes"
    pairs = _pair_lstm_linears(linears, num_hidden, "decoder")
    return {
        "embedding": _f32(lookups[0]["weight"]),
        "layers": [_lstm_layer(a, b) for a, b in pairs],
        "w_a": _f32(w_a_m[0]["weight"]).T.copy(),
        "w_c": _f32(w_c_m[0]["weight"]).T.copy(),
    }


def map_projector(proj_obj: TorchObject) -> dict:
    linears = [m for m in iter_leaf_modules(proj_obj)
               if m.torch_typename == "nn.Linear"]
    assert len(linears) == 1, f"expected 1 projector Linear, got {len(linears)}"
    return {"w": _f32(linears[0]["weight"]).T.copy(),
            "b": _f32(linears[0]["bias"])}


_CONFIG_KEYS = {
    # Lua config table keys (model.lua:116-142) -> Config field names
    "dropout": "dropout",
    "encoder_num_hidden": "encoder_num_hidden",
    "encoder_num_layers": "encoder_num_layers",
    "decoder_num_layers": "decoder_num_layers",
    "target_vocab_size": "target_vocab_size",
    "target_embedding_size": "target_embedding_size",
    "input_feed": "input_feed",
    "max_encoder_l": "max_encoder_l",
    "max_decoder_l": "max_decoder_l",
    "batch_size": "batch_size",
    "prealloc": "prealloc",
}
_INT_KEYS = {"encoder_num_hidden", "encoder_num_layers", "decoder_num_layers",
             "target_vocab_size", "target_embedding_size", "max_encoder_l",
             "max_decoder_l", "batch_size"}


def import_checkpoint(path: str, long_size: int = 8) -> Dict[str, Any]:
    """Read a reference torch.save checkpoint -> this framework's payload
    {params, batch_stats, config, global_step, optim_state} (numpy trees,
    the tree aocr_torch.checkpoint.load returns).  long_size=4 reads
    checkpoints written by 32-bit torch builds."""
    payload = t7.load(path, long_size=long_size)
    assert isinstance(payload, list) and len(payload) == 4, (
        f"unexpected checkpoint layout: {type(payload)}"
    )
    modules, lua_config, global_step, optim_state = payload
    assert isinstance(modules, list) and len(modules) == 5, (
        "expected {cnn, encoder_fw, encoder_bw, decoder, projector}"
    )
    cnn_obj, enc_fw, enc_bw, dec, proj = modules
    cfg: Dict[str, Any] = {}
    if isinstance(lua_config, dict):
        for lua_key, our_key in _CONFIG_KEYS.items():
            if lua_key in lua_config:
                v = lua_config[lua_key]
                cfg[our_key] = int(v) if our_key in _INT_KEYS else v
    enc_h = int(cfg.get("encoder_num_hidden", 512))
    dec_h = 2 * enc_h
    cnn_params, cnn_stats = map_cnn(cnn_obj)
    params = {
        "cnn": cnn_params,
        "encoder_fw": map_encoder(enc_fw, enc_h, "encoder_fw"),
        "encoder_bw": map_encoder(enc_bw, enc_h, "encoder_bw"),
        "decoder": map_decoder(dec, dec_h),
        "projector": map_projector(proj),
    }
    opt = {}
    if isinstance(optim_state, dict):
        if "learningRate" in optim_state:
            opt["learning_rate"] = float(optim_state["learningRate"])
        # The reference's sgd_list keeps a state table PER PARAM GROUP
        # (optim_state[1..5].evalCounter, optim_sgd.lua:45,94), advanced
        # in lockstep — the counter never lives at the top level (that
        # spelling is kept as a fallback for hand-built states).
        group1 = optim_state.get(1)
        if isinstance(group1, dict) and "evalCounter" in group1:
            opt["eval_counter"] = int(group1["evalCounter"])
        elif "evalCounter" in optim_state:
            opt["eval_counter"] = int(optim_state["evalCounter"])
    return {
        "params": params,
        "batch_stats": cnn_stats,
        "config": cfg,
        "global_step": int(global_step or 0),
        "optim_state": opt,
    }


def count_leaves(tree) -> int:
    """The number of array elements in a nested dict/list of arrays."""
    if isinstance(tree, dict):
        return sum(count_leaves(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(count_leaves(v) for v in tree)
    return int(np.asarray(tree).size)


def _cli(argv=None) -> int:
    """`python -m aocr_torch.torch_import`: tools/import_torch.py's
    surface (positional t7_path and model_dir, --summary, --long_size)."""
    import argparse

    p = argparse.ArgumentParser(
        prog="aocr_torch.torch_import",
        description="Convert a reference Torch7 checkpoint into a native "
                    "v2 checkpoint directory")
    p.add_argument("t7_path", help="reference torch.save checkpoint")
    p.add_argument("model_dir", help="output model dir (final-model written)")
    p.add_argument("--summary", action="store_true",
                   help="print per-group parameter counts after import")
    p.add_argument("--long_size", type=int, default=8, choices=(4, 8),
                   help="C long width of the writing platform (4 for "
                        "32-bit torch builds)")
    args = p.parse_args(argv)
    payload = import_checkpoint(args.t7_path, long_size=args.long_size)
    out = _save(payload, args.model_dir)
    print(f"Imported {args.t7_path} -> {out}")
    if args.summary:
        for group, tree in payload["params"].items():
            print(f"  {group}: {count_leaves(tree)} params")
        print(f"  global_step: {payload['global_step']}")
        print(f"  config: {payload['config']}")
    return 0


def _save(payload: Dict[str, Any], model_dir: str) -> str:
    from dataclasses import asdict

    from aocr_torch import checkpoint
    from aocr_torch.config import config_from_dict

    cfg = config_from_dict(payload["config"])
    return checkpoint.save(
        model_dir,
        payload["params"],
        payload["batch_stats"],
        asdict(cfg),
        payload["global_step"],
        payload["optim_state"] or {"learning_rate": cfg.learning_rate},
    )


def import_to_model_dir(t7_path: str, model_dir: str,
                        long_size: int = 8) -> str:
    """Convert a torch checkpoint into a native v2 checkpoint published as
    <model_dir>/final-model (usable with -load_model / AttentionOCR.load
    of either package)."""
    return _save(import_checkpoint(t7_path, long_size=long_size), model_dir)


if __name__ == "__main__":
    import sys

    sys.exit(_cli())
