"""Carry model weights between the flax layout and this package's:
TransformerLM (with its mixture-of-experts blocks and its decode cache,
`cache_from_flax`), one pp rank's share of the pipelined LM's
stage-stacked params (`pipeline_from_flax`, `pipeline_to_flax`), ViT and
BertEncoder parameters, ResNet's parameters with its BatchNorm
`batch_stats`, and the MNIST models' (`mnist_from_flax`, `mnist_to_flax`:
the parameter server's wire carries the flax ones).

flax keeps `DenseGeneral` kernels per head — query/key/value
(d_model, heads, head_dim), out (heads, head_dim, d_model) — and `Dense`
kernels as (in, out); this package keeps every projection as a torch weight
[out, in].  Biases keep their flax shapes ([heads, head_dim] for
query/key/value).  Norm `scale` is the torch `weight`; `wte/embedding` and
`wpe` carry over as they are.  Conv kernels go from flax's HWIO to torch's
OIHW; BatchNorm `scale`/`bias` are the module's `weight`/`bias` and its
`mean`/`var` statistics the `running_mean`/`running_var` buffers.  Both
directions are explicit so each layout change is visible.

`flax_param_map` names, for each port parameter, its flax path and shape
and where each flax dim lies in the port's tensor: the map the sharding
rules (`parallel/tp_rules.py`, written on flax paths and shapes) and the
ZeRO plan (`train/zero.py`) are carried over by.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

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
        for name, dense in blk.get("mlp", {}).items():
            sd.update(_dense_from_flax(dense, pre + f"mlp.{name}"))
        if "moe" in blk:
            moe = blk["moe"]
            sd.update(_dense_from_flax(moe["router"], pre + "moe.router"))
            sd[pre + "moe.wi"] = _t(moe["wi"])
            sd[pre + "moe.wo"] = _t(moe["wo"])
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
        block = {"attn": attn, "ln1": _norm_to_flax(sd, pre + "ln1"),
                 "ln2": _norm_to_flax(sd, pre + "ln2")}
        if pre + "moe.wi" in sd:
            block["moe"] = {"router": _dense_to_flax(sd, pre + "moe.router"),
                            "wi": sd[pre + "moe.wi"],
                            "wo": sd[pre + "moe.wo"]}
        else:
            block["mlp"] = {name: _dense_to_flax(sd, pre + f"mlp.{name}")
                            for name in ("wg", "wi", "wo")
                            if pre + f"mlp.{name}.weight" in sd}
        params[f"block_{i}"] = block
        i += 1
    return params


def _stage_index(rank: int, v: int, j: int, virtual_stages: int):
    """The index into a stage-stacked flax leaf of layer j of rank `rank`'s
    chunk v: [P, L, ...] leaves, or [P, V, L, ...] interleaved."""
    return (rank, j) if virtual_stages == 1 else (rank, v, j)


def pipeline_from_flax(params, mesh_rank: int, num_stages: int,
                       virtual_stages: int = 1) -> Dict[str, torch.Tensor]:
    """The JAX `PipelinedTransformerLM`'s params (`stages` leaves stacked
    [P, L, ...], or [P, V, L, ...] with chunk g = v·P + r) -> the state_dict
    of `models.pipeline_lm.PipelinedTransformerLM` for pp rank
    `mesh_rank`: its chunks' blocks (local block v·L + j) and the head."""
    stages = params["stages"]
    shape = np.asarray(stages["ln1"]["scale"]).shape
    if shape[0] != num_stages or (virtual_stages > 1
                                  and shape[1] != virtual_stages):
        raise ValueError(f"stage-stacked leaves {shape} do not hold "
                         f"{num_stages} stages x {virtual_stages} chunks")
    lpc = shape[1 if virtual_stages == 1 else 2]
    blocks = {}
    for v in range(virtual_stages):
        for j in range(lpc):
            at = _stage_index(mesh_rank, v, j, virtual_stages)
            blocks[f"block_{v * lpc + j}"] = _tree_map(
                lambda a: np.asarray(a)[at], stages)
    sd = {"wte": _t(params["wte"]), "ln_f_scale": _t(params["ln_f_scale"])}
    for name in ("wpe", "ln_f_bias"):
        if name in params:
            sd[name] = _t(params[name])
    sd.update(_blocks_from_flax(blocks))
    return sd


def pipeline_to_flax(state_dicts, virtual_stages: int = 1):
    """The inverse of `pipeline_from_flax` over every rank: the state_dicts
    (or gradients under the same names) of pp ranks 0..P-1 -> the JAX
    params, `stages` stacked as `init` stacks them; the head from rank 0's."""
    ranks = [_blocks_to_flax(_host(sd)) for sd in state_dicts]
    lpc = len(ranks[0]) // virtual_stages

    def stack(*leaves):
        per_rank = np.stack(leaves).reshape(
            len(ranks), virtual_stages, lpc, *leaves[0].shape)
        return per_rank[:, 0] if virtual_stages == 1 else per_rank

    head = _host({k: v for k, v in state_dicts[0].items()
                  if not k.startswith("blocks.")})
    return {**head, "stages": _tree_map(
        stack, *[r[f"block_{k}"] for r in ranks for k in range(len(r))])}


def _tree_map(fn, *trees):
    """fn over the leaves of nested dicts of one structure."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


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


# ---------------------------------------------------------------------------
# each port parameter's flax path, flax shape and dim map


@dataclass(frozen=True)
class FlaxParam:
    """A port parameter `name` as the flax param at `path` of `shape`;
    `dims[i]` is the port dim that holds flax dim i whole, or None where
    none does (head_dim inside the port's [heads * head_dim] when heads
    > 1)."""

    name: str
    path: Tuple[str, ...]
    shape: Tuple[int, ...]
    dims: Tuple[Optional[int], ...]


def _same(name, path, shape):
    return FlaxParam(name, path, tuple(shape), tuple(range(len(shape))))


def _kernel(name, path, cin, cout):
    """A Dense kernel (in, out) against the port's weight [out, in]."""
    return FlaxParam(name, path, (cin, cout), (1, 0))


def _conv(name, path, weight_shape):
    """A conv kernel HWIO against the port's OIHW weight."""
    o, i, h, w = weight_shape
    return FlaxParam(name, path, (h, w, i, o), (2, 3, 1, 0))


def _norm_map(prefix, path, features, bias=True):
    out = [_same(f"{prefix}.weight", path + ("scale",), (features,))]
    if bias:
        out.append(_same(f"{prefix}.bias", path + ("bias",), (features,)))
    return out


def _blocks_map(cfg, count) -> List[FlaxParam]:
    d, f = cfg.d_model, cfg.d_ff
    head_dim = d // cfg.num_heads
    kv = cfg.num_kv_heads or cfg.num_heads
    norm_bias = cfg.norm == "layernorm"
    out = []
    for i in range(count):
        pre, blk = f"blocks.{i}.", (f"block_{i}",)
        for name, heads in (("query", cfg.num_heads), ("key", kv),
                            ("value", kv)):
            path = blk + ("attn", name)
            # (d, H, D) against [H * D, d]: D is whole only when H is 1
            out.append(FlaxParam(f"{pre}attn.{name}.weight",
                                 path + ("kernel",), (d, heads, head_dim),
                                 (1, 0, 0 if heads == 1 else None)))
            out.append(_same(f"{pre}attn.{name}.bias", path + ("bias",),
                             (heads, head_dim)))
        path = blk + ("attn", "out")
        # (H, D, d) against [d, H * D]
        out.append(FlaxParam(f"{pre}attn.out.weight", path + ("kernel",),
                             (cfg.num_heads, head_dim, d),
                             (1, 1 if cfg.num_heads == 1 else None, 0)))
        out.append(_same(f"{pre}attn.out.bias", path + ("bias",), (d,)))
        if cfg.moe_num_experts and (i + 1) % cfg.moe_every == 0:
            e, path = cfg.moe_num_experts, blk + ("moe",)
            out += [_kernel(f"{pre}moe.router.weight",
                            path + ("router", "kernel"), d, e),
                    _same(f"{pre}moe.router.bias", path + ("router", "bias"),
                          (e,)),
                    _same(f"{pre}moe.wi", path + ("wi",), (e, d, f)),
                    _same(f"{pre}moe.wo", path + ("wo",), (e, f, d))]
            mlp = ()
        elif cfg.mlp == "swiglu":
            mlp = (("wg", d, f), ("wi", d, f), ("wo", f, d))
        else:
            mlp = (("wi", d, f), ("wo", f, d))
        for name, cin, cout in mlp:
            path = blk + ("mlp", name)
            out.append(_kernel(f"{pre}mlp.{name}.weight", path + ("kernel",),
                               cin, cout))
            if cfg.mlp != "swiglu":
                out.append(_same(f"{pre}mlp.{name}.bias", path + ("bias",),
                                 (cout,)))
        out += _norm_map(pre + "ln1", blk + ("ln1",), d, norm_bias)
        out += _norm_map(pre + "ln2", blk + ("ln2",), d, norm_bias)
    return out


def _linear_map(name, path, linear):
    return [_kernel(f"{name}.weight", path + ("kernel",), linear.in_features,
                    linear.out_features),
            _same(f"{name}.bias", path + ("bias",), (linear.out_features,))]


def flax_param_map(model) -> List[FlaxParam]:
    """Every parameter of a TransformerLM, BertEncoder, ViT or ResNet as
    its flax param, in the order of the flax params' flattening (paths
    sorted).  Shapes are the whole model's, read from its config and its
    modules' sizes, so the map is the same before and after sharding."""
    from .resnet import BatchNorm, BottleneckBlock, ResNet
    from .transformer import BertEncoder, TransformerLM
    from .vit import ViT

    if isinstance(model, TransformerLM):
        cfg = model.cfg
        d = cfg.d_model
        out = [_same("wte.weight", ("wte", "embedding"),
                     (cfg.vocab_size, d))]
        if model.wpe is not None:
            out.append(_same("wpe", ("wpe",), (cfg.max_len, d)))
        out += _norm_map("ln_f", ("ln_f",), d, cfg.norm == "layernorm")
        out += _blocks_map(cfg, cfg.num_layers)
    elif isinstance(model, BertEncoder):
        cfg = model.cfg
        d = cfg.d_model
        out = [_same("tok_emb.weight", ("tok_emb", "embedding"),
                     (cfg.vocab_size, d)),
               _same("type_emb.weight", ("type_emb", "embedding"),
                     (cfg.type_vocab_size, d)),
               _same("pos_emb", ("pos_emb",), (cfg.max_len, d))]
        out += _norm_map("emb_ln", ("emb_ln",), d, cfg.norm == "layernorm")
        out += _norm_map("ln_f", ("ln_f",), d, cfg.norm == "layernorm")
        out += _linear_map("pooler", ("pooler",), model.pooler)
        out += _linear_map("classifier", ("classifier",), model.classifier)
        out += _blocks_map(cfg, cfg.num_layers)
    elif isinstance(model, ViT):
        cfg = model.cfg
        conv = model.patch_embed
        out = [_conv("patch_embed.weight", ("patch_embed", "kernel"),
                     (conv.out_channels, conv.in_channels,
                      *conv.kernel_size)),
               _same("patch_embed.bias", ("patch_embed", "bias"),
                     (conv.out_channels,)),
               _same("cls_token", ("cls_token",), (1, 1, cfg.d_model)),
               _same("pos_emb", ("pos_emb",), tuple(model.pos_emb.shape))]
        out += _norm_map("ln_f", ("ln_f",), cfg.d_model,
                         cfg.norm == "layernorm")
        out += _linear_map("head", ("head",), model.head)
        out += _blocks_map(cfg, cfg.num_layers)
    elif isinstance(model, ResNet):
        cls = ("BottleneckBlock" if isinstance(model.blocks[0],
                                               BottleneckBlock)
               else "ResNetBlock")
        blocks = [f"{cls}_{i}" for i in range(len(model.blocks))]
        modules = dict(model.named_modules())
        out = []
        for path, prefix, kind in _resnet_layers(
                blocks, lambda name: len(
                    model.blocks[blocks.index(name)].convs)):
            module = modules.get(prefix)
            if module is None:
                continue
            if kind == "conv":
                out.append(_conv(prefix + ".weight", path + ("kernel",),
                                 tuple(module.weight.shape)))
            else:
                assert isinstance(module, BatchNorm)
                out += _norm_map(prefix, path, module.weight.shape[0])
        out += _linear_map("head", ("Dense_0",), model.head)
    else:
        raise TypeError(f"no flax map for {type(model).__name__}")
    return sorted(out, key=lambda e: e.path)


def cache_from_flax(cache):
    """A JAX decode cache (the 'cache' collection as numpy leaves:
    `block_i/attn/{cached_key, cached_value, cached_key_scale,
    cached_value_scale, cached_pos1, cache_index}` and the model's
    `wpe_index`) -> `models.transformer.DecodeCache` on the CPU."""
    from .transformer import DecodeCache, LayerCache

    def tensor(x):
        return None if x is None else torch.from_numpy(np.array(x))

    layers = []
    i = 0
    while f"block_{i}" in cache:
        attn = cache[f"block_{i}"]["attn"]
        layers.append(LayerCache(
            **{name: tensor(attn.get(name)) for name in (
                "cached_key", "cached_value", "cached_key_scale",
                "cached_value_scale", "cached_pos1")},
            cache_index=int(np.asarray(attn["cache_index"]))))
        i += 1
    return DecodeCache(layers, int(np.asarray(cache.get("wpe_index", 0))))


def mnist_from_flax(params) -> Dict[str, torch.Tensor]:
    """flax MnistMLP / MnistCNN params ({"Dense_0": {"kernel", "bias"},
    "Conv_0": ...}) -> state_dict of `models.mnist` (`dense_0.weight`, ...).
    Dense kernels go from flax's [in, out] to [out, in], conv kernels from
    HWIO to OIHW."""
    sd = {}
    for layer, leaves in params.items():
        kind, index = layer.split("_")
        kernel = np.asarray(leaves["kernel"])
        weight = kernel.T if kind == "Dense" else kernel.transpose(3, 2, 0, 1)
        sd[f"{kind.lower()}_{index}.weight"] = _t(weight)
        sd[f"{kind.lower()}_{index}.bias"] = _t(leaves["bias"])
    return sd


def mnist_to_flax(tensors) -> Dict[str, Dict[str, np.ndarray]]:
    """The inverse of `mnist_from_flax` for any {port name: tensor} of the
    MNIST models (the state_dict, or the parameters' gradients): f32 numpy
    arrays under the flax names and layouts."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for name, t in tensors.items():
        layer, field = name.split(".")
        kind, index = layer.split("_")
        a = np.array(t.detach().cpu(), dtype=np.float32)
        if field == "weight":
            a = np.ascontiguousarray(
                a.T if kind == "dense" else a.transpose(2, 3, 1, 0))
        out.setdefault(f"{kind.capitalize()}_{index}", {})[
            "kernel" if field == "weight" else "bias"] = a
    return out
