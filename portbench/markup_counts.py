"""Operations and bytes of im2markup's parts, from shapes, by counts.py's
rules: 2 operations a multiply-add; work that depends on the data counted
for what these inputs need (a row's decoder steps up to its EOS, or T);
bytes at the narrowest dtype a tensor could have.

One departure from counts.loop_bytes, where the context is read once a
call: here each live row's context (L x H) is counted once a step.  At
L = 1,240 a call's context is 256 x 1,240 x 512 x 2 B = 325 MB, six
times the H100's 50 MB L2, so no schedule of greedy_loop can keep it on
the chip across the steps, and each step has to read it from memory.

A traced call `c` (drivers/markup.py's layer_info) has B, T, the image
height `Hi` and width `W`, and `row_steps`.
"""

from __future__ import annotations

from . import counts


def cnn(convs, height: int, width: int):
    """(operations of one image through the convs, the map's (rows,
    columns))."""
    h, w, f = height, width, 0.0
    for _n, i, o, k, pad, _bn, pool in convs:
        h, w = h + 2 * pad - k + 1, w + 2 * pad - k + 1
        f += 2.0 * k * k * i * o * h * w
        if pool:
            h, w = h // pool[0], w // pool[1]
    return f, (h, w)


def rows_flops(Hf: int, Wf: int, D: int, He: int, layers: int) -> float:
    """One image through both directions of the row encoder: Hf rows of Wf
    steps, the input and recurrent products of each layer."""
    return sum(2 * Hf * Wf * 2.0 * 4 * He * ((D if k == 0 else He) + He)
               for k in range(layers))


def dims(cfg_file: dict, c: dict) -> dict:
    cfg, convs = cfg_file["config"], cfg_file["spec"]["convs"]
    per_image, (Hf, Wf) = cnn(convs, c["Hi"], c["W"])
    He = cfg["encoder_num_hidden"]
    return {"cnn": per_image, "Hf": Hf, "Wf": Wf, "L": Hf * Wf, "He": He,
            "H": 2 * He, "D": convs[-1][2], "V": cfg["target_vocab_size"],
            "E": cfg["target_embedding_size"],
            "nl": cfg["decoder_num_layers"], "input_feed": cfg["input_feed"],
            "enc_layers": cfg["encoder_num_layers"]}


def forward_flops(cfg_file: dict, c: dict) -> float:
    """The model's forward pass over a call's B images: CNN, row encoder
    and each row's decoder steps."""
    d = dims(cfg_file, c)
    per_image = d["cnn"] + rows_flops(d["Hf"], d["Wf"], d["D"], d["He"],
                                      d["enc_layers"])
    sf = counts.step_flops(d["H"], d["L"], d["V"], d["E"], d["nl"],
                           d["input_feed"])
    return c["B"] * per_image + sf * float(sum(c["row_steps"]))


def loop_flops(cfg_file: dict, c: dict) -> float:
    """greedy_loop: each row's steps of the decoder step with the
    projector, the embedding from a table."""
    d = dims(cfg_file, c)
    return float(sum(c["row_steps"])) * counts.step_flops(
        d["H"], d["L"], d["V"], d["E"], d["nl"], d["input_feed"],
        embed=False)


def loop_bytes(cfg_file: dict, c: dict, dtype: str) -> float:
    """greedy_loop: each live row's context once a step, the decoder's
    and the projector's weights and the start state once; labels and
    scores out."""
    d = dims(cfg_file, c)
    H, V, nl, item = d["H"], d["V"], d["nl"], counts.ITEM[dtype]
    k0 = (H if d["input_feed"] else 0) + H
    w = V * 4 * H + k0 * 4 * H + (nl - 1) * 2 * H * 4 * H + 3 * H * H + H * V
    context = float(sum(c["row_steps"])) * d["L"] * H * item
    return context + w * item + 2 * c["B"] * H * 4 + c["B"] * (c["T"] + 1) * 4
