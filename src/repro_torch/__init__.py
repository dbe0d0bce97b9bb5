"""PyTorch/CUDA port of the CascadeInfer reproduction.

A second package beside the JAX reference ``repro``: the same module
layout and names where that helps a reader find the counterpart, its own
copies of the framework-free modules, and hand-written Hopper kernels in
place of the Pallas ones. It imports neither ``jax`` nor ``repro``.
Entry points run on the card unless the caller asks for the CPU.
"""
