"""Autoregressive generation with a KV cache.

The counterpart of `tf_operator_tpu/models/generate.py`: one prefill call
over the prompt fills every layer's cache (`TransformerLM.init_cache`,
`SelfAttention._decode_attend`), then each new token is one T=1 call that
writes the cache in place, where the JAX package donates it to a jitted
step.  Greedy decoding at temperature 0; otherwise categorical sampling at
the temperature from the caller's `torch.Generator`, optionally restricted
to the `top_k` most likely tokens.  Decode attention runs the plain torch
path, as the JAX decode twin runs with `use_flash=False`.

Under tensor parallelism (`parallel/shard.py`) each rank's layers hold
their own query and KV heads, so the cache holds this rank's KV heads (the
JAX package's kv-head split of the cache), and the vocab-sharded readout
gives each rank a slice of the logits: they are gathered over the tp group
before sampling, so every rank draws the same token.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def _full_logits(model, logits):
    """[B, V] logits from this rank's vocab slice (under tp) or as they
    are."""
    tp = getattr(model, "vocab_tp", None)
    if tp is None:
        return logits
    parts = [torch.empty_like(logits) for _ in range(tp.size)]
    dist.all_gather(parts, logits.contiguous(), group=tp.group)
    return torch.cat(parts, dim=-1)


def _sampler(temperature: float, top_k: int,
             generator: Optional[torch.Generator]):
    def sample(logits):
        if temperature == 0.0:
            return logits.argmax(-1)
        logits = logits.float()
        if top_k:
            kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
            logits = torch.where(logits >= kth, logits, float("-inf"))
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    return sample


def generate(model, prompt, max_new_tokens: int, temperature: float = 0.0,
             top_k: int = 0, generator: Optional[torch.Generator] = None):
    """Generate `max_new_tokens` continuations of `prompt` [B, P] (ints)
    with `model` (a TransformerLM, any config).

    Returns [B, P + max_new_tokens] (int64) on the model's device.
    Temperature 0 decodes greedily; otherwise `generator` (on the model's
    device) draws categorical samples at the temperature, from the `top_k`
    most likely tokens (0 = all)."""
    cfg = model.cfg
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if temperature < 0.0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if top_k < 0 or top_k > cfg.vocab_size:
        raise ValueError(
            f"top_k must be in [0, vocab_size {cfg.vocab_size}], got {top_k}")
    device = model.wte.weight.device
    prompt = torch.as_tensor(prompt, device=device).long()
    batch, prompt_len = prompt.shape
    if prompt_len + max_new_tokens > cfg.max_len:
        raise ValueError(
            f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens}) "
            f"exceeds max_len {cfg.max_len}")
    if temperature > 0.0 and generator is None:
        raise ValueError("sampling (temperature > 0) needs an rng: pass a "
                         "torch.Generator as generator=")

    sample = _sampler(float(temperature), int(top_k), generator)
    with torch.no_grad():
        cache = model.init_cache(batch, device)
        tok = sample(_full_logits(model, model(prompt, cache=cache)[:, -1]))
        out = [tok]
        for _ in range(1, max_new_tokens):
            logits = model(tok[:, None], cache=cache)[:, -1]
            tok = sample(_full_logits(model, logits))
            out.append(tok)
    return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)
