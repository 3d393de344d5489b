"""Carry TransformerLM weights between the flax layout and this package's.

flax keeps `DenseGeneral` kernels per head — query/key/value
(d_model, heads, head_dim), out (heads, head_dim, d_model) — and `Dense`
kernels as (in, out); this package keeps every projection as a torch weight
[out, in].  Biases keep their flax shapes ([heads, head_dim] for
query/key/value).  Norm `scale` is the torch `weight`; `wte/embedding` and
`wpe` carry over as they are.  Both directions are explicit so each layout
change is visible.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_QKV = ("query", "key", "value")


def params_from_flax(params) -> Dict[str, torch.Tensor]:
    """flax TransformerLM params (nested dict of arrays) -> state_dict for
    `models.transformer.TransformerLM`."""
    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    sd = {"wte.weight": t(params["wte"]["embedding"])}
    if "wpe" in params:
        sd["wpe"] = t(params["wpe"])
    sd.update(_norm_from_flax(params["ln_f"], "ln_f", t))
    i = 0
    while f"block_{i}" in params:
        blk, pre = params[f"block_{i}"], f"blocks.{i}."
        for name in _QKV:
            kernel = np.asarray(blk["attn"][name]["kernel"])  # (d, H, D)
            sd[pre + f"attn.{name}.weight"] = t(
                kernel.reshape(kernel.shape[0], -1).T)
            sd[pre + f"attn.{name}.bias"] = t(blk["attn"][name]["bias"])
        out = np.asarray(blk["attn"]["out"]["kernel"])  # (H, D, d)
        sd[pre + "attn.out.weight"] = t(out.reshape(-1, out.shape[-1]).T)
        sd[pre + "attn.out.bias"] = t(blk["attn"]["out"]["bias"])
        for name, dense in blk["mlp"].items():
            sd[pre + f"mlp.{name}.weight"] = t(np.asarray(dense["kernel"]).T)
            if "bias" in dense:
                sd[pre + f"mlp.{name}.bias"] = t(dense["bias"])
        sd.update(_norm_from_flax(blk["ln1"], pre + "ln1", t))
        sd.update(_norm_from_flax(blk["ln2"], pre + "ln2", t))
        i += 1
    return sd


def _norm_from_flax(norm, prefix, t):
    out = {prefix + ".weight": t(norm["scale"])}
    if "bias" in norm:
        out[prefix + ".bias"] = t(norm["bias"])
    return out


def params_to_flax(state_dict):
    """The inverse of `params_from_flax`: a TransformerLM state_dict ->
    flax-layout nested dict of float32 numpy arrays."""
    sd = {k: v.detach().cpu().float().numpy() for k, v in state_dict.items()}
    params = {"wte": {"embedding": sd["wte.weight"]},
              "ln_f": _norm_to_flax(sd, "ln_f")}
    if "wpe" in sd:
        params["wpe"] = sd["wpe"]
    i = 0
    while f"blocks.{i}.ln1.weight" in sd:
        pre = f"blocks.{i}."
        attn = {}
        for name in _QKV:
            w = sd[pre + f"attn.{name}.weight"]  # [H*D, d]
            bias = sd[pre + f"attn.{name}.bias"]  # [H, D]
            attn[name] = {"kernel": w.T.reshape(w.shape[1], *bias.shape),
                          "bias": bias}
        heads, head_dim = attn["query"]["bias"].shape
        w = sd[pre + "attn.out.weight"]  # [d, H*D]
        attn["out"] = {"kernel": w.T.reshape(heads, head_dim, w.shape[0]),
                       "bias": sd[pre + "attn.out.bias"]}
        mlp = {}
        for name in ("wg", "wi", "wo"):
            if pre + f"mlp.{name}.weight" in sd:
                mlp[name] = {"kernel": sd[pre + f"mlp.{name}.weight"].T}
                if pre + f"mlp.{name}.bias" in sd:
                    mlp[name]["bias"] = sd[pre + f"mlp.{name}.bias"]
        params[f"block_{i}"] = {"attn": attn, "mlp": mlp,
                                "ln1": _norm_to_flax(sd, pre + "ln1"),
                                "ln2": _norm_to_flax(sd, pre + "ln2")}
        i += 1
    return params


def _norm_to_flax(sd, prefix):
    out = {"scale": sd[prefix + ".weight"]}
    if prefix + ".bias" in sd:
        out["bias"] = sd[prefix + ".bias"]
    return out
