"""The cell's weights, made from the seed on the device.

One ``torch.Generator`` on the device, one draw per leaf of the
period-stacked tree (a dozen calls for a whole model), in the dtype the
configuration states: the nested dict the port's training steps read
(``embed``, ``stack`` or ``enc``/``dec``/``cross``, the norms, ``head``
when untied), with the port's shapes and scales. The reference gets the
same tree, made again from the same seed: it never reads weights the
program has held.
"""
from __future__ import annotations

import torch

VOCAB_ALIGN = 256
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def vocab_padded(model: dict) -> int:
    v = int(model["vocab"])
    return -(-v // VOCAB_ALIGN) * VOCAB_ALIGN


def _attention(n, model):
    d, h, kv, dh = (model[k] for k in ("d_model", "n_heads", "n_kv_heads",
                                       "d_head"))
    return {"wq": ((n, d, h * dh), d ** -0.5),
            "wk": ((n, d, kv * dh), d ** -0.5),
            "wv": ((n, d, kv * dh), d ** -0.5),
            "wo": ((n, h * dh, d), (h * dh) ** -0.5)}


def _stack(model):
    n, d, f = model["n_layers"], model["d_model"], model["d_ff"]
    return {"l0": {"ln1": ((n, d), 0.0), "mixer": _attention(n, model),
                   "ln2": ((n, d), 0.0),
                   "ffn": {"w_in": ((n, d, f), d ** -0.5),
                           "w_out": ((n, f, d), f ** -0.5)}}}


def layout(model: dict) -> dict:
    """The tree of ``(shape, scale)`` leaves, scale 0 for a zero leaf (the
    norms, whose weights scale by ``1 + w``)."""
    d, vp = model["d_model"], vocab_padded(model)
    if model["family"] == "encdec":
        n = model["n_layers"]
        return {"embed": ((vp, d), 1.0), "enc": _stack(model),
                "dec": _stack(model),
                "cross": {"ln": ((n, d), 0.0), "attn": _attention(n, model)},
                "enc_norm": ((d,), 0.0), "dec_norm": ((d,), 0.0)}
    tree = {"embed": ((vp, d), 1.0), "stack": _stack(model),
            "final_norm": ((d,), 0.0)}
    if not model.get("tie_embeddings", False):
        tree["head"] = ((vp, d), d ** -0.5)
    return tree


def make_params(model: dict, seed: int, device) -> dict:
    """The weights of ``seed``: normal draws times each leaf's scale, in
    the configuration's dtype, drawn leaf by leaf in the tree's order."""
    dt = DTYPES[model["dtype"]]
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))

    def make(node):
        if isinstance(node, dict):
            return {k: make(v) for k, v in node.items()}
        shape, scale = node
        if scale == 0.0:
            return torch.zeros(shape, dtype=dt, device=device)
        return torch.randn(shape, generator=gen, dtype=dt,
                           device=device).mul_(scale)
    return make(layout(model))


def leaf_items(tree, prefix=""):
    """``[(path, tensor)]`` of a nested dict, in its order."""
    out = []
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out += leaf_items(v, path + ".")
        else:
            out.append((path, v))
    return out

