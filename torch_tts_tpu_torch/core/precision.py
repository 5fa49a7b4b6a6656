"""The card's fp32 settings for the package's command-line tools.

PyTorch runs a float32 convolution or RNN through cuDNN in TF32 by default
(`torch.backends.cudnn.allow_tf32` is True), which keeps about three
decimal digits of each product. The port holds its outputs to the JAX
package's in fp32, so every CLI calls `fp32_cudnn()` first thing in its
`main`. The legacy flags are the only API used: on torch 2.13, setting the
newer `torch.backends.cudnn.conv.fp32_precision` makes a later read of the
legacy flag raise, so nothing in the package reads or sets the newer one.
TF32 stays an opt-in that needs a measured A/B.
"""

from __future__ import annotations

import torch


def fp32_cudnn() -> None:
    """Turn TF32 off for cuDNN's convolutions and RNNs, and keep float32
    matrix products in full float32 (PyTorch's own default)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
