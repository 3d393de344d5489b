"""Meshes over ranks, the differentiable collectives, sequence
parallelism (ring attention, Ulysses), and the parameters' layouts over
tp, fsdp and (ZeRO) dp (`tp_rules`, `shard`)."""
