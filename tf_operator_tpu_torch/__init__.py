"""tf_operator_tpu_torch — the training runtime of tf_operator_tpu, ported to
PyTorch and CUDA for an NVIDIA H100.

The JAX package `tf_operator_tpu` stays the reference; this package imports
nothing of it (nor jax, flax, optax or orbax) and keeps its own copy of what
it needs.  Layout mirrors the reference so each counterpart is easy to find:

  api/        — the topology env names the runner reads
  ops/        — flash attention: hand-written Hopper kernels (csrc/) + plain versions
  models/     — Transformer LM, BERT encoder, ViT, ResNet, and the flax converter
  parallel/   — the mesh over ranks, collectives, ring/Ulysses, and the tp /
                fsdp / ZeRO layouts of the parameters
  train/      — losses/steps, AdamW/SGD recipes, train state, the ZeRO plan,
                data (and the native image loader's binding), checkpoints
  workloads/  — the pod-side entry points (lm, resnet, vit, bert)
"""
