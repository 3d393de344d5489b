"""Data pipeline: synthetic, learnable digit, token and image streams and
the copy to the device.

`synthetic_mnist`, `synthetic_tokens` and `synthetic_images` are copies of
the generators in `tf_operator_tpu/train/data.py` (the port imports
nothing of the JAX package): the same seed yields the same stream, bit for
bit.
"""
from __future__ import annotations

import collections
from typing import Dict, Iterator

import numpy as np
import torch


def synthetic_mnist(batch_size: int,
                    seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """28x28 'digits': class-dependent stripe/checker patterns + noise."""
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:28, 0:28]
    templates = np.stack(
        [np.sin(xs * (c + 1) * 0.35 + ys * (9 - c) * 0.15) for c in range(10)]
    ).astype(np.float32)
    while True:
        labels = rng.randint(0, 10, size=batch_size)
        images = templates[labels] + rng.randn(batch_size, 28, 28).astype(np.float32) * 0.3
        yield {"x": images.reshape(batch_size, 784), "label": labels.astype(np.int32)}


def synthetic_tokens(batch_size: int, seq_len: int, vocab_size: int = 32000,
                     seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Markov-ish token streams with learnable bigram structure."""
    rng = np.random.RandomState(seed)
    next_tok = (np.arange(vocab_size) * 31 + 7) % vocab_size
    while True:
        start = rng.randint(0, vocab_size, size=batch_size)
        toks = np.empty((batch_size, seq_len), dtype=np.int32)
        toks[:, 0] = start
        for t in range(1, seq_len):
            noise = rng.rand(batch_size) < 0.1
            toks[:, t] = np.where(
                noise, rng.randint(0, vocab_size, size=batch_size), next_tok[toks[:, t - 1]]
            )
        yield {"tokens": toks}


def synthetic_images(batch_size: int, image_size: int = 224,
                     num_classes: int = 1000,
                     seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """ImageNet-shaped class-conditional images (for ResNet benchmarking)."""
    rng = np.random.RandomState(seed)
    freq = (np.arange(num_classes) % 13 + 1).astype(np.float32)
    ys = np.linspace(0, np.pi * 2, image_size, dtype=np.float32)
    while True:
        labels = rng.randint(0, num_classes, size=batch_size)
        base = np.sin(ys[None, :, None] * freq[labels][:, None, None])
        images = (
            base[..., None]
            + rng.randn(batch_size, image_size, image_size, 3).astype(np.float32) * 0.5
        )
        yield {"x": images.astype(np.float32), "label": labels.astype(np.int32)}


def prefetch_to_device(it: Iterator, device: torch.device,
                       size: int = 2) -> Iterator:
    """Keep up to `size` batches in flight to `device` ahead of the
    consumer.  On a CUDA device each array is copied from pinned host memory
    with `non_blocking=True`, so the copy of batch N+1 overlaps step N."""
    device = torch.device(device)
    cuda = device.type == "cuda"

    def place(batch):
        out = {}
        for key, value in batch.items():
            x = torch.from_numpy(np.asarray(value))
            if cuda:
                x = x.pin_memory().to(device, non_blocking=True)
            out[key] = x
        return out

    queue = collections.deque()
    for batch in it:
        queue.append(place(batch))
        if len(queue) > size:
            yield queue.popleft()
    while queue:
        yield queue.popleft()
