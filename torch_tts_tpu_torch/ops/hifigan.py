"""HiFi-GAN generator with ResBlock1 banks (port of `Generator` and
`ResBlock1`, `torch_tts_tpu/ops/hifigan.py`), [B, C, T] layout.

conv_pre -> per stage [lrelu -> weight-normed transposed conv -> mean of
the stage's ResBlock1 bank] -> lrelu(0.01) -> conv_post -> tanh. With
`fuse_mrf`, a stage's bank runs through `kernels/mrf_fused.py` when the
decode is unmasked, the stage has at most 128 channels (the same gate as
the JAX package; the TPU lane-packing path has no counterpart here) and no
gradient is needed: the kernel has no backward, so a training forward runs
the plain convolutions. A
given `x_mask` is threaded through every layer so a padded batch decodes
as the exact-length sequences would.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from torch_tts_tpu_torch.kernels.mrf_fused import dilated_offsets, mrf_fused
from torch_tts_tpu_torch.ops.layers import Conv1d, ConvTranspose1d, leaky_relu


def _get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


class ResBlock1(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Tuple[int, ...] = (1, 3, 5)):
        super().__init__()
        self.channels = channels
        self.kernel_size = kernel_size
        self.dilation = tuple(dilation)
        self.convs1 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, padding=_get_padding(kernel_size, d),
                   dilation=d, weight_norm=True) for d in self.dilation)
        self.convs2 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, padding=_get_padding(kernel_size, 1),
                   weight_norm=True) for _ in self.dilation)

    def forward(self, x: torch.Tensor, x_mask: Optional[torch.Tensor] = None):
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = leaky_relu(x)
            if x_mask is not None:
                xt = xt * x_mask
            xt = leaky_relu(c1(xt))
            if x_mask is not None:
                xt = xt * x_mask
            x = c2(xt) + x
        return x * x_mask if x_mask is not None else x

    def kernels(self):
        """The block's convs in `mrf_fused`'s form: per iteration
        ((offsets1, w1 [k*C, C], b1), (offsets2, w2, b2))."""
        k, C = self.kernel_size, self.channels

        def flat(conv):  # [out, in, k] -> [k*in, out], tap-major rows
            return conv.effective_weight().permute(2, 1, 0).reshape(k * C, C).contiguous()

        return tuple(
            ((dilated_offsets(k, d), flat(c1), c1.bias), (dilated_offsets(k, 1), flat(c2), c2.bias))
            for d, c1, c2 in zip(self.dilation, self.convs1, self.convs2))


class Generator(nn.Module):
    def __init__(self, initial_channel: int, resblock: str = "1",
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 3,
                 upsample_rates: Sequence[int] = (8, 8, 2, 2),
                 upsample_initial_channel: int = 512,
                 upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4),
                 fuse_mrf: bool = False):
        super().__init__()
        if resblock != "1":
            raise NotImplementedError("only ResBlock1 generators are ported")
        self.num_kernels = len(resblock_kernel_sizes)
        self.upsample_rates = tuple(upsample_rates)
        self.fuse_mrf = fuse_mrf
        self.conv_pre = Conv1d(initial_channel, upsample_initial_channel, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        ch = upsample_initial_channel
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            ch = upsample_initial_channel // (2 ** (i + 1))
            self.ups.append(ConvTranspose1d(2 * ch, ch, k, stride=u, padding=(k - u) // 2))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                self.resblocks.append(ResBlock1(ch, rk, tuple(rd)))
        self.conv_post = Conv1d(ch, 1, 7, padding=3, bias=False)

    def forward(self, x: torch.Tensor, x_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, C_in, T] latent frames -> [B, 1, T * prod(upsample_rates)]."""
        mask = x_mask
        if mask is not None:
            x = x * mask
        x = self.conv_pre(x)
        if mask is not None:
            x = x * mask
        nk = self.num_kernels
        for i, (up, u) in enumerate(zip(self.ups, self.upsample_rates)):
            x = leaky_relu(x)
            if mask is not None:
                x = x * mask
            x = up(x)
            if mask is not None:
                mask = torch.repeat_interleave(mask, u, dim=2)
                x = x * mask
            bank = self.resblocks[i * nk:(i + 1) * nk]
            needs_grad = torch.is_grad_enabled() and (
                x.requires_grad or any(p.requires_grad for p in bank.parameters()))
            if self.fuse_mrf and mask is None and x.shape[1] <= 128 and not needs_grad:
                blocks = tuple(block.kernels() for block in bank)
                # the kernel works in [B, T, C]; copy back to a contiguous
                # [B, C, T] so the next convolutions take cuDNN's usual layout
                x = mrf_fused(x.transpose(1, 2).contiguous(), blocks).transpose(1, 2).contiguous()
            else:
                xs = None
                for block in bank:
                    b_out = block(x, mask)
                    xs = b_out if xs is None else xs + b_out
                x = xs / nk
        x = leaky_relu(x, 0.01)
        if mask is not None:
            x = x * mask
        return torch.tanh(self.conv_post(x))
