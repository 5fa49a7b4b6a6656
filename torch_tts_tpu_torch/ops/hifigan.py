"""HiFi-GAN generator with ResBlock1 or ResBlock2 banks (port of
`Generator`, `ResBlock1` and `ResBlock2`, `torch_tts_tpu/ops/hifigan.py`),
[B, C, T] layout.

conv_pre -> per stage [lrelu -> weight-normed transposed conv -> mean of
the stage's bank of resblocks] -> lrelu(0.01) -> conv_post -> tanh.
`run_bank` runs one stage's bank for this decoder and the MB-iSTFT one
(`ops/mb_istft.py`): with `fuse_mrf`, a ResBlock1 bank runs through
`kernels/mrf_fused.py` when the decode is unmasked, the stage has a width
and taps the kernel takes (`mrf_fused.supports`; the JAX gate, whose TPU
lane-packing path has no counterpart here), the bank is not int8 and no
gradient is needed: the kernel has no backward, so a training forward runs
the plain convolutions. The kernel computes a ResBlock1 bank, so a
ResBlock2 bank always runs its plain convolutions (JAX `hifigan.py`:
`res_cls is ResBlock1`). A given `x_mask` is threaded through every layer
so a padded batch decodes as the exact-length sequences would. With
`gin_channels`, a 1x1 `cond` conv adds the speaker embedding after
`conv_pre`.

`quant_int8` is the JAX package's int8 decoder (W8A8, inference only,
`ops/quant.py`), with its per-stage policy (`int8_stages`): conv_pre is
int8; `cond` and conv_post stay fp; with `pack_narrow` (the config's
`pack_narrow_convs`), a stage narrower than 128 channels on the subpixel
geometry, and every bank from it on, stays fp (on the TPU those run
lane-packed); without it every stage is int8. An int8 stage runs its
transposed conv and every conv of its bank through the int8 kernels,
never `mrf_fused`. A stage that stays fp keeps the rule above, so on the
card its ResBlock1 bank takes `mrf_fused` where JAX's int8 model runs its
plain (packed) convolutions: the same function, within the MRF kernel's
tolerance.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from torch_tts_tpu_torch.kernels import mrf_fused as mrf_kernel
from torch_tts_tpu_torch.kernels.mrf_fused import dilated_offsets, mrf_fused
from torch_tts_tpu_torch.ops.layers import Conv1d, ConvTranspose1d, leaky_relu


def _get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


class ResBlock1(nn.Module):
    """Per dilation: lrelu -> dilated conv -> lrelu -> conv, added
    residually; `quant="int8"` makes every conv int8."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Tuple[int, ...] = (1, 3, 5), quant: Optional[str] = None):
        super().__init__()
        self.channels = channels
        self.kernel_size = kernel_size
        self.dilation = tuple(dilation)
        self.quant = quant
        self.convs1 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, padding=_get_padding(kernel_size, d),
                   dilation=d, weight_norm=True, quant=quant) for d in self.dilation)
        self.convs2 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, padding=_get_padding(kernel_size, 1),
                   weight_norm=True, quant=quant) for _ in self.dilation)

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


class ResBlock2(nn.Module):
    """Per dilation: lrelu -> dilated conv, added residually (one conv per
    dilation, `convs.{j}`); `quant="int8"` makes every conv int8."""

    def __init__(self, channels: int, kernel_size: int = 3, dilation: Tuple[int, ...] = (1, 3),
                 quant: Optional[str] = None):
        super().__init__()
        self.channels = channels
        self.quant = quant
        self.convs = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, padding=_get_padding(kernel_size, d),
                   dilation=d, weight_norm=True, quant=quant) for d in dilation)

    def forward(self, x: torch.Tensor, x_mask: Optional[torch.Tensor] = None):
        for c in self.convs:
            xt = leaky_relu(x)
            if x_mask is not None:
                xt = xt * x_mask
            x = c(xt) + x
        return x * x_mask if x_mask is not None else x


def make_bank(resblock: str, channels: int, kernel_sizes: Sequence[int],
              dilation_sizes: Sequence[Sequence[int]], quant: Optional[str] = None):
    """One stage's bank: a ResBlock1 (resblock "1") or ResBlock2 (else, as
    the JAX package) per kernel size, int8 with `quant="int8"`."""
    cls = ResBlock1 if resblock == "1" else ResBlock2
    return [cls(channels, k, tuple(d), quant=quant) for k, d in zip(kernel_sizes, dilation_sizes)]


def int8_stages(upsample_initial_channel: int, upsample_rates: Sequence[int],
                upsample_kernel_sizes: Sequence[int], pack_narrow: bool):
    """JAX `Generator(quant_int8=True)`'s policy: per stage, (whether its
    transposed conv is int8, whether its bank is int8). With pack_narrow, a
    stage of ch < 128 channels on the subpixel geometry is packed on the TPU
    and stays fp, and so does every bank once the packing factor P exceeds
    1 (after a packed stage P is max(1, min(P * u, 128 // ch)))."""
    P, out = 1, []
    for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
        ch = upsample_initial_channel // (2 ** (i + 1))
        # the subpixel geometry k - u - 2 * padding == 0, padding (k - u) // 2
        pack_stage = pack_narrow and ch < 128 and (k - u) % 2 == 0
        if pack_stage:
            P = max(1, min(P * u, 128 // ch))
        out.append((not pack_stage, P == 1))
    return out


def run_bank(bank, x: torch.Tensor, mask: Optional[torch.Tensor], fuse_mrf: bool,
             max_taps: int) -> torch.Tensor:
    """The mean of a stage's resblocks on x [B, C, T]: through `mrf_fused`
    when `fuse_mrf` is on, the bank is ResBlock1's and not int8, the decode
    unmasked, no gradient needed and the kernel takes C and max_taps; else
    the blocks' own convolutions (int8 ones for an int8 bank)."""
    needs_grad = torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for p in bank.parameters()))
    if (fuse_mrf and isinstance(bank[0], ResBlock1) and bank[0].quant is None
            and mask is None and not needs_grad
            and mrf_kernel.supports(x.shape[1], max_taps)):
        blocks = tuple(block.kernels() for block in bank)
        # the kernel works in [B, T, C]; copy back to a contiguous [B, C, T]
        # so the next convolutions take cuDNN's usual layout
        return mrf_fused(x.transpose(1, 2).contiguous(), blocks).transpose(1, 2).contiguous()
    xs = None
    for block in bank:
        b_out = block(x, mask)
        xs = b_out if xs is None else xs + b_out
    return xs / len(bank)


class Generator(nn.Module):
    def __init__(self, initial_channel: int, resblock: str = "1",
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 3,
                 upsample_rates: Sequence[int] = (8, 8, 2, 2),
                 upsample_initial_channel: int = 512,
                 upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4),
                 fuse_mrf: bool = False, gin_channels: int = 0, quant_int8: bool = False,
                 pack_narrow: bool = False):
        super().__init__()
        self.num_kernels = len(resblock_kernel_sizes)
        self.upsample_rates = tuple(upsample_rates)
        self.fuse_mrf = fuse_mrf
        # the most taps of any conv in a bank (dilation does not add taps)
        self.max_taps = max(resblock_kernel_sizes)
        q8 = "int8" if quant_int8 else None
        self.conv_pre = Conv1d(initial_channel, upsample_initial_channel, 7, padding=3, quant=q8)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        ch = upsample_initial_channel
        stages = int8_stages(upsample_initial_channel, upsample_rates, upsample_kernel_sizes,
                             pack_narrow)
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            ch = upsample_initial_channel // (2 ** (i + 1))
            up_q8, bank_q8 = (q8 if on else None for on in stages[i])
            self.ups.append(ConvTranspose1d(2 * ch, ch, k, stride=u, padding=(k - u) // 2,
                                            quant=up_q8))
            self.resblocks.extend(make_bank(resblock, ch, resblock_kernel_sizes,
                                            resblock_dilation_sizes, quant=bank_q8))
        self.conv_post = Conv1d(ch, 1, 7, padding=3, bias=False)
        if gin_channels > 0:
            self.cond = Conv1d(gin_channels, upsample_initial_channel, 1)

    def forward(self, x: torch.Tensor, x_mask: Optional[torch.Tensor] = None,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, C_in, T] latent frames, g [B, gin, 1] or None -> [B, 1, T *
        prod(upsample_rates)]."""
        mask = x_mask
        if mask is not None:
            x = x * mask
        x = self.conv_pre(x)
        if g is not None:
            x = x + self.cond(g)
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
            x = run_bank(self.resblocks[i * nk:(i + 1) * nk], x, mask, self.fuse_mrf,
                         self.max_taps)
        x = leaky_relu(x, 0.01)
        if mask is not None:
            x = x * mask
        return torch.tanh(self.conv_post(x))
