"""Meshes over ranks, the differentiable collectives, and sequence
parallelism (ring attention, Ulysses)."""
