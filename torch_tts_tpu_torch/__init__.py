"""VITS2 inference and training step, and Tacotron-2 inference, in PyTorch
and CUDA, ported from the JAX package `torch_tts_tpu`, with hand-written
Hopper kernels under `csrc/`.

Imports torch, never jax, and nothing of the JAX package: the pure-Python
parts it needs (text frontend, configs) are its own copies.
"""

__version__ = "0.1.0"
