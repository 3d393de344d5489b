"""Carry model weights between the flax layout and this package's:
TransformerLM, ViT and BertEncoder parameters, and ResNet's parameters with
its BatchNorm `batch_stats`.

flax keeps `DenseGeneral` kernels per head — query/key/value
(d_model, heads, head_dim), out (heads, head_dim, d_model) — and `Dense`
kernels as (in, out); this package keeps every projection as a torch weight
[out, in].  Biases keep their flax shapes ([heads, head_dim] for
query/key/value).  Norm `scale` is the torch `weight`; `wte/embedding` and
`wpe` carry over as they are.  Conv kernels go from flax's HWIO to torch's
OIHW; BatchNorm `scale`/`bias` are the module's `weight`/`bias` and its
`mean`/`var` statistics the `running_mean`/`running_var` buffers.  Both
directions are explicit so each layout change is visible.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_QKV = ("query", "key", "value")


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def params_from_flax(params) -> Dict[str, torch.Tensor]:
    """flax TransformerLM params (nested dict of arrays) -> state_dict for
    `models.transformer.TransformerLM`."""
    sd = {"wte.weight": _t(params["wte"]["embedding"])}
    if "wpe" in params:
        sd["wpe"] = _t(params["wpe"])
    sd.update(_norm_from_flax(params["ln_f"], "ln_f"))
    sd.update(_blocks_from_flax(params))
    return sd


def _blocks_from_flax(params) -> Dict[str, torch.Tensor]:
    """The encoder/decoder stack `block_{i}` -> `blocks.{i}.*`."""
    sd = {}
    i = 0
    while f"block_{i}" in params:
        blk, pre = params[f"block_{i}"], f"blocks.{i}."
        for name in _QKV:
            kernel = np.asarray(blk["attn"][name]["kernel"])  # (d, H, D)
            sd[pre + f"attn.{name}.weight"] = _t(
                kernel.reshape(kernel.shape[0], -1).T)
            sd[pre + f"attn.{name}.bias"] = _t(blk["attn"][name]["bias"])
        out = np.asarray(blk["attn"]["out"]["kernel"])  # (H, D, d)
        sd[pre + "attn.out.weight"] = _t(out.reshape(-1, out.shape[-1]).T)
        sd[pre + "attn.out.bias"] = _t(blk["attn"]["out"]["bias"])
        for name, dense in blk["mlp"].items():
            sd.update(_dense_from_flax(dense, pre + f"mlp.{name}"))
        sd.update(_norm_from_flax(blk["ln1"], pre + "ln1"))
        sd.update(_norm_from_flax(blk["ln2"], pre + "ln2"))
        i += 1
    return sd


def _dense_from_flax(dense, prefix):
    out = {prefix + ".weight": _t(np.asarray(dense["kernel"]).T)}
    if "bias" in dense:
        out[prefix + ".bias"] = _t(dense["bias"])
    return out


def _norm_from_flax(norm, prefix):
    out = {prefix + ".weight": _t(norm["scale"])}
    if "bias" in norm:
        out[prefix + ".bias"] = _t(norm["bias"])
    return out


def _host(state_dict):
    return {k: v.detach().cpu().float().numpy()
            for k, v in state_dict.items()}


def params_to_flax(state_dict):
    """The inverse of `params_from_flax`: a TransformerLM state_dict ->
    flax-layout nested dict of float32 numpy arrays."""
    sd = _host(state_dict)
    params = {"wte": {"embedding": sd["wte.weight"]},
              "ln_f": _norm_to_flax(sd, "ln_f")}
    if "wpe" in sd:
        params["wpe"] = sd["wpe"]
    params.update(_blocks_to_flax(sd))
    return params


def _blocks_to_flax(sd):
    params = {}
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
        mlp = {name: _dense_to_flax(sd, pre + f"mlp.{name}")
               for name in ("wg", "wi", "wo")
               if pre + f"mlp.{name}.weight" in sd}
        params[f"block_{i}"] = {"attn": attn, "mlp": mlp,
                                "ln1": _norm_to_flax(sd, pre + "ln1"),
                                "ln2": _norm_to_flax(sd, pre + "ln2")}
        i += 1
    return params


def _dense_to_flax(sd, prefix):
    out = {"kernel": sd[prefix + ".weight"].T}
    if prefix + ".bias" in sd:
        out["bias"] = sd[prefix + ".bias"]
    return out


def _norm_to_flax(sd, prefix):
    out = {"scale": sd[prefix + ".weight"]}
    if prefix + ".bias" in sd:
        out["bias"] = sd[prefix + ".bias"]
    return out


# ---------------------------------------------------------------------------
# ViT and BertEncoder: the shared blocks plus their own embeddings and heads


def vit_from_flax(params) -> Dict[str, torch.Tensor]:
    """flax ViT params -> state_dict for `models.vit.ViT`."""
    kernel = np.asarray(params["patch_embed"]["kernel"])  # (p, p, 3, d)
    sd = {"patch_embed.weight": _t(kernel.transpose(3, 2, 0, 1)),
          "patch_embed.bias": _t(params["patch_embed"]["bias"]),
          "cls_token": _t(params["cls_token"]),
          "pos_emb": _t(params["pos_emb"])}
    sd.update(_norm_from_flax(params["ln_f"], "ln_f"))
    sd.update(_dense_from_flax(params["head"], "head"))
    sd.update(_blocks_from_flax(params))
    return sd


def vit_to_flax(state_dict):
    sd = _host(state_dict)
    params = {"patch_embed": {
        "kernel": sd["patch_embed.weight"].transpose(2, 3, 1, 0),
        "bias": sd["patch_embed.bias"]},
        "cls_token": sd["cls_token"], "pos_emb": sd["pos_emb"],
        "ln_f": _norm_to_flax(sd, "ln_f"),
        "head": _dense_to_flax(sd, "head")}
    params.update(_blocks_to_flax(sd))
    return params


def bert_from_flax(params) -> Dict[str, torch.Tensor]:
    """flax BertEncoder params -> state_dict for
    `models.transformer.BertEncoder`."""
    sd = {"tok_emb.weight": _t(params["tok_emb"]["embedding"]),
          "type_emb.weight": _t(params["type_emb"]["embedding"]),
          "pos_emb": _t(params["pos_emb"])}
    for name in ("emb_ln", "ln_f"):
        sd.update(_norm_from_flax(params[name], name))
    for name in ("pooler", "classifier"):
        sd.update(_dense_from_flax(params[name], name))
    sd.update(_blocks_from_flax(params))
    return sd


def bert_to_flax(state_dict):
    sd = _host(state_dict)
    params = {"tok_emb": {"embedding": sd["tok_emb.weight"]},
              "type_emb": {"embedding": sd["type_emb.weight"]},
              "pos_emb": sd["pos_emb"]}
    for name in ("emb_ln", "ln_f"):
        params[name] = _norm_to_flax(sd, name)
    for name in ("pooler", "classifier"):
        params[name] = _dense_to_flax(sd, name)
    params.update(_blocks_to_flax(sd))
    return params


# ---------------------------------------------------------------------------
# ResNet: parameters and batch_stats

_BN_PARAMS = (("scale", "weight"), ("bias", "bias"))
_BN_STATS = (("mean", "running_mean"), ("var", "running_var"))


def _flax_blocks(params):
    """flax's auto-named blocks in order: ResNetBlock_i or
    BottleneckBlock_i."""
    for cls in ("ResNetBlock", "BottleneckBlock"):
        names = [f"{cls}_{i}" for i in range(len(params))
                 if f"{cls}_{i}" in params]
        if names:
            return names
    return []


def _resnet_layers(flax_blocks, count_convs):
    """(flax path, torch prefix, kind) of every conv and norm."""
    out = [(("conv_init",), "conv_init", "conv"),
           (("bn_init",), "bn_init", "norm")]
    for i, name in enumerate(flax_blocks):
        pre = f"blocks.{i}."
        for j in range(count_convs(name)):
            out.append(((name, f"Conv_{j}"), pre + f"convs.{j}", "conv"))
            out.append(((name, f"BatchNorm_{j}"), pre + f"norms.{j}", "norm"))
        out.append(((name, "conv_proj"), pre + "conv_proj", "conv"))
        out.append(((name, "norm_proj"), pre + "norm_proj", "norm"))
    return out


def _get(tree, path):
    for key in path:
        if key not in tree:
            return None
        tree = tree[key]
    return tree


def resnet_from_flax(params, batch_stats) -> Dict[str, torch.Tensor]:
    """flax ResNet {"params", "batch_stats"} -> state_dict for
    `models.resnet.ResNet` (parameters and running-statistics buffers)."""
    sd = {}
    blocks = _flax_blocks(params)
    for path, prefix, kind in _resnet_layers(
            blocks, lambda name: sum(k.startswith("Conv_")
                                     for k in params[name])):
        layer = _get(params, path)
        if layer is None:
            continue
        if kind == "conv":  # HWIO -> OIHW
            sd[prefix + ".weight"] = _t(
                np.asarray(layer["kernel"]).transpose(3, 2, 0, 1))
            continue
        stats = _get(batch_stats, path)
        for theirs, ours in _BN_PARAMS:
            sd[f"{prefix}.{ours}"] = _t(layer[theirs])
        for theirs, ours in _BN_STATS:
            sd[f"{prefix}.{ours}"] = _t(stats[theirs])
    sd.update(_dense_from_flax(params["Dense_0"], "head"))
    return sd


def resnet_to_flax(state_dict, block_cls: str):
    """The inverse of `resnet_from_flax`: (params, batch_stats) in the flax
    layout; `block_cls` names the flax block ("ResNetBlock" or
    "BottleneckBlock")."""
    sd = _host(state_dict)
    count = 0
    while f"blocks.{count}.convs.0.weight" in sd:
        count += 1
    blocks = [f"{block_cls}_{i}" for i in range(count)]
    torch_index = {name: i for i, name in enumerate(blocks)}

    def count_convs(name):
        pre = f"blocks.{torch_index[name]}.convs."
        return sum(k.startswith(pre) for k in sd)

    params, batch_stats = {}, {}

    def put(tree, path, value):
        for key in path[:-1]:
            tree = tree.setdefault(key, {})
        tree[path[-1]] = value

    for path, prefix, kind in _resnet_layers(blocks, count_convs):
        if prefix + ".weight" not in sd:
            continue
        if kind == "conv":
            put(params, path, {"kernel": sd[prefix + ".weight"]
                               .transpose(2, 3, 1, 0)})
            continue
        put(params, path, {theirs: sd[f"{prefix}.{ours}"]
                           for theirs, ours in _BN_PARAMS})
        put(batch_stats, path, {theirs: sd[f"{prefix}.{ours}"]
                                for theirs, ours in _BN_STATS})
    params["Dense_0"] = _dense_to_flax(sd, "head")
    return params, batch_stats
