"""Checkpoint save/load with atomic publish and resume (the port's own copy
of aocr/checkpoint.py: an npz-v2 file written by either package loads in
the other).

Parity with the reference checkpointing
(`reference src/model/model.lua:720-725`, `src/train.lua:116-128`):
the checkpoint carries {params, batch_stats, config, global_step, optim
state (incl. learning rate)}; every `steps_per_checkpoint` a step-named
checkpoint `model-<step>` is written and atomically published as
`final-model` via a tmp-file + rename (the reference's cp + mv,
train.lua:127-128).  On resume, the learning rate is restored from optimizer
state and clamped to learning_rate_min (train.lua:87-89), and
max_encoder_l / max_decoder_l / batch_size may be overridden by the CLI
(model.lua:75-77).

Format v2: a standard `.npz` zip archive — every pytree leaf is one named
array member and a single JSON `__meta__` member carries the config,
global_step, tree structure, and non-array optimizer scalars.  Loading never
unpickles (np.load with allow_pickle=False), so a checkpoint file cannot
execute code — the torch.load / raw-pickle hazard the reference (and format
v1) had.  v1 pickles remain readable for one version behind an explicit
opt-in flag.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np

FORMAT_VERSION = 2
FINAL_NAME = "final-model"

_LEAF_TAG = "__npz__"


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]):
    """Recursively flatten dict/list/tuple pytrees of arrays + scalars.

    Returns a JSON-able skeleton mirroring the tree where each array leaf is
    {"__npz__": <member name>} and plain scalars/strings stay inline."""
    if isinstance(tree, dict):
        return {k: _flatten(v, f"{prefix}/{k}", out) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_flatten(v, f"{prefix}/{i}", out) for i, v in enumerate(tree)]
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    arr = np.asarray(tree)  # jax.Array / np scalar / ndarray
    if arr.dtype == object:
        raise TypeError(f"non-array checkpoint leaf at {prefix}: {tree!r}")
    if prefix in out:
        # '/'-joined names can collide (a key containing '/', or a
        # numeric-string dict key vs a list index); silent last-writer-wins
        # would corrupt one tensor on load
        raise ValueError(f"checkpoint member name collision: {prefix}")
    out[prefix] = arr
    return {_LEAF_TAG: prefix}


def _unflatten(skel, arrays) -> Any:
    if isinstance(skel, dict):
        if set(skel.keys()) == {_LEAF_TAG}:
            return arrays[skel[_LEAF_TAG]]
        return {k: _unflatten(v, arrays) for k, v in skel.items()}
    if isinstance(skel, list):
        return [_unflatten(v, arrays) for v in skel]
    return skel


def _write_npz(path: str, payload: Dict[str, Any]) -> None:
    arrays: Dict[str, np.ndarray] = {}
    skeleton = {
        k: _flatten(payload[k], k, arrays)
        for k in ("params", "batch_stats", "optim_state")
    }
    meta = {
        "version": FORMAT_VERSION,
        "config": payload["config"],
        "global_step": payload["global_step"],
        "skeleton": skeleton,
    }
    # np.savez writes <name>.npy members; add the JSON meta as a plain
    # member through the same zip (STORED: arrays dominate, keep it simple).
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED, allowZip64=True) as z:
        z.writestr("__meta__.json", json.dumps(meta))
        for name, arr in arrays.items():
            buf = io.BytesIO()
            np.lib.format.write_array(buf, np.ascontiguousarray(arr),
                                      allow_pickle=False)
            z.writestr(name + ".npy", buf.getvalue())


def _read_npz(path: str) -> Dict[str, Any]:
    with zipfile.ZipFile(path, "r") as z:
        meta = json.loads(z.read("__meta__.json").decode())
        arrays = {}
        for info in z.infolist():
            if info.filename.endswith(".npy"):
                buf = io.BytesIO(z.read(info))
                arrays[info.filename[:-4]] = np.lib.format.read_array(
                    buf, allow_pickle=False
                )
    payload = {
        "version": meta["version"],
        "config": meta["config"],
        "global_step": meta["global_step"],
    }
    for k, skel in meta["skeleton"].items():
        payload[k] = _unflatten(skel, arrays)
    return payload


def save(
    model_dir: str,
    params: dict,
    batch_stats: dict,
    config_dict: Dict[str, Any],
    global_step: int,
    optim_state: Dict[str, Any],
    publish_final: bool = True,
) -> str:
    os.makedirs(model_dir, exist_ok=True)
    payload = {
        "params": params,
        "batch_stats": batch_stats,
        "config": dict(config_dict),
        "global_step": int(global_step),
        "optim_state": dict(optim_state),
    }
    path = os.path.join(model_dir, f"model-{global_step}")
    tmp = path + ".tmp"
    _write_npz(tmp, payload)
    os.replace(tmp, path)
    if publish_final:
        final_tmp = os.path.join(model_dir, f".{FINAL_NAME}.tmp")
        # model-<step> is immutable once written, so publishing is a hard
        # link + atomic rename (O(1) instead of re-copying hundreds of MB
        # per checkpoint); fall back to a copy where links aren't possible
        try:
            if os.path.exists(final_tmp):
                os.unlink(final_tmp)
            os.link(path, final_tmp)
        except OSError:
            shutil.copyfile(path, final_tmp)  # bounded-buffer copy
        os.replace(final_tmp, os.path.join(model_dir, FINAL_NAME))
    return path


def _is_zip(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(4) == b"PK\x03\x04"


def load(path: str, allow_pickle: bool = False) -> Dict[str, Any]:
    """Load a checkpoint.  v2 (npz) loads without any unpickling; legacy v1
    pickles require allow_pickle=True (unpickling executes code from the
    file — only enable for checkpoints you wrote yourself)."""
    if _is_zip(path):
        payload = _read_npz(path)
        # file-content validation must raise unconditionally (asserts
        # vanish under python -O)
        if payload.get("version") != FORMAT_VERSION:
            raise ValueError(
                f"unsupported checkpoint version {payload.get('version')}")
        return payload
    if not allow_pickle:
        raise ValueError(
            f"{path} is a legacy v1 pickle checkpoint; pass "
            "allow_pickle=True (or --allow_pickle_ckpt on the CLI) to load "
            "it — unpickling executes code embedded in the file."
        )
    import pickle

    with open(path, "rb") as f:
        payload = pickle.load(f)
    if payload.get("version") != 1:
        raise ValueError(
            f"unsupported checkpoint version {payload.get('version')}")
    return payload


def final_path(model_dir: str) -> str:
    return os.path.join(model_dir, FINAL_NAME)


def try_load_final(model_dir: str,
                   allow_pickle: bool = False) -> Optional[Dict[str, Any]]:
    p = final_path(model_dir)
    return load(p, allow_pickle=allow_pickle) if os.path.exists(p) else None
