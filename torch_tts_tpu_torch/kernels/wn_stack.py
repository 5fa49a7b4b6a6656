"""Fused WaveNet (WN) gated conv stack, forward and backward.

Replaces the TPU kernels of `torch_tts_tpu/kernels/wn_stack.py`: the
forward (`wn_group` -> `_wn_group_pallas` -> `_wn_fwd_kernel`) and the
backward (`_wn_group_pallas_bwd` -> `_wn_bwd_kernel`), with the CUDA kernels
of `torch_tts_tpu_torch/csrc/wn_stack.cu`, keeping their contract: x
[B, T, H], mask [B, T, 1], gl [B, L, 2H] per-layer conditioning or None,
w_in [L, k, H, 2H] effective conv kernels, b_in [L, 2H], w_rs [L, H, 2H] 1x1
res/skip kernels whose final layer has a zero residual half, b_rs [L, 2H];
fp32. A group returns (x_out, skip * mask); `wn_stack` chains groups of at
most four layers and returns the skip sum, as the JAX version does.

On the card `wn_group` is a `torch.autograd.Function`. In the forward it
launches the forward kernel; when a gradient is wanted, the kernel also
writes each layer's input and pre-activation, which the backward kernel
(`wn_group_backward`) reads as it walks the layers in reverse. The plain
version of the backward is autograd through `wn_group_plain`
(`wn_group_backward_plain`). No gradient is taken with respect to the mask:
a mask that requires one raises.

On the H100 a flow's WN (H=192, k=5, L=4, 1024 frames) is about 3.6 GFLOP
per batch item forward and twice that backward. The forward runs all layers
of a group on one time tile in shared memory, in fp32 FMAs; `pick_tile`
trades halo recompute against filling the SMs. The backward's four
products per layer run on the tensor cores in 3xTF32 (fp32-level error,
`mrf_fused.split_tf32` is the split), deterministic split-K by batch item;
see the .cu file.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. `wn_group.launches` and `wn_group_backward.launches`
count kernel launches (one per wrapper call).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from torch_tts_tpu_torch.kernels import build

SUPPORTED_HIDDEN = (192,)  # every shipped config
TILES = (64, 32, 16)


def pick_tile(B: int, T: int, n_sm: int) -> int:
    """The largest tile that still gives at least half as many CTAs as the
    card has SMs (fewer, larger tiles recompute less halo; too few leave
    SMs idle); the smallest tile when none does."""
    for tile in TILES:
        if B * -(-T // tile) >= n_sm // 2:
            return tile
    return TILES[-1]


def wn_group_plain(x, mask, gl, w_in, b_in, w_rs, b_rs) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of one layer group, same contract as `wn_group`."""
    L, k, H = w_in.shape[0], w_in.shape[1], x.shape[-1]
    xc, m = x.transpose(1, 2).contiguous(), mask.transpose(1, 2)
    skip = torch.zeros_like(xc)
    for i in range(L):
        x_in = F.conv1d(xc, w_in[i].permute(2, 1, 0), b_in[i], padding=(k - 1) // 2)
        if gl is not None:
            x_in = x_in + gl[:, i, :, None]
        acts = torch.tanh(x_in[:, :H]) * torch.sigmoid(x_in[:, H:])
        rs = F.conv1d(acts, w_rs[i].t()[:, :, None], b_rs[i])
        xc = (xc + rs[:, :H]) * m
        skip = skip + rs[:, H:]
    return xc.transpose(1, 2), (skip * m).transpose(1, 2)


def wn_group_backward_plain(x, mask, gl, w_in, b_in, w_rs, b_rs, d_xo, d_sk):
    """Plain version of the backward: autograd through `wn_group_plain` ->
    (d_x, d_gl or None, d_w_in, d_b_in, d_w_rs, d_b_rs)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (x, gl, w_in, b_in, w_rs, b_rs)
               if t is not None]
        if gl is None:
            ins.insert(1, None)
        out = wn_group_plain(ins[0], mask, *ins[1:])
        wanted = [t for t in ins if t is not None]
        grads = list(torch.autograd.grad(out, wanted, (d_xo, d_sk)))
    if gl is None:
        grads.insert(1, None)
    return tuple(grads)


def _check_cuda_args(x, mask, gl, w_in, b_in, w_rs, b_rs):
    if x.dim() != 3 or w_in.dim() != 4:
        raise ValueError("wn_group: x must be [B, T, H] and w_in [L, k, H, 2H]")
    B, T, H = x.shape
    L, k = w_in.shape[:2]
    if H not in SUPPORTED_HIDDEN or k % 2 == 0 or k > 15:
        raise ValueError(f"wn_group: H={H} (supported {SUPPORTED_HIDDEN}), k={k} (odd, <= 15)")
    shapes = {"x": (x, (B, T, H)), "mask": (mask, (B, T, 1)), "gl": (gl, (B, L, 2 * H)),
              "w_in": (w_in, (L, k, H, 2 * H)), "b_in": (b_in, (L, 2 * H)),
              "w_rs": (w_rs, (L, H, 2 * H)), "b_rs": (b_rs, (L, 2 * H))}
    for name, (t, shape) in shapes.items():
        if t is None and name == "gl":
            continue
        if (t.device != x.device or t.dtype != torch.float32 or tuple(t.shape) != shape
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"wn_group: {name} must be a contiguous, 16-byte aligned fp32 "
                             f"{shape} tensor on {x.device}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _forward_cuda(x, mask, gl, w_in, b_in, w_rs, b_rs, save: bool):
    """Forward kernel -> (x_out, skip, saved); saved is (x_i [L, B, T, H],
    x_in [L, B, T, 2H]) when `save`, else None."""
    B, T, H = x.shape
    L, k = w_in.shape[:2]
    tile = pick_tile(B, T, torch.cuda.get_device_properties(x.device).multi_processor_count)
    x_out, skip = torch.empty_like(x), torch.empty_like(x)
    saved = None
    if save:
        saved = (x.new_empty(L, B, T, H), x.new_empty(L, B, T, 2 * H))
    lib = build.load_library()
    with torch.cuda.device(x.device):
        code = lib.tts_wn_group_forward(
            x.data_ptr(), mask.data_ptr(), None if gl is None else gl.data_ptr(),
            w_in.data_ptr(), b_in.data_ptr(), w_rs.data_ptr(), b_rs.data_ptr(),
            x_out.data_ptr(), skip.data_ptr(),
            None if saved is None else saved[0].data_ptr(),
            None if saved is None else saved[1].data_ptr(),
            B, T, H, L, k, tile, _stream(x))
    build.check_cuda_error(code, "wn_group")
    wn_group.launches += 1
    return x_out, skip, saved


def backward_workspace(B: int, T: int, H: int, k: int) -> int:
    """Floats of scratch the backward kernel takes (tts_wn_group_backward):
    d_x between layers [B, T, H], d_xin [B, T, 2H], acts [B, T, H] and the
    per-item partial weight gradients."""
    return B * T * 4 * H + B * (k * H + 1) * 2 * H + B * (H + 1) * 2 * H


def wn_group_backward(x, mask, gl, w_in, b_in, w_rs, b_rs, d_xo, d_sk, saved=None):
    """Gradients of one group -> (d_x, d_gl or None, d_w_in, d_b_in, d_w_rs,
    d_b_rs), the contract of the JAX `_wn_group_pallas_bwd`. On the card
    `saved` is what the saving forward wrote; without it that forward runs
    first."""
    if x.device.type == "cpu":
        return wn_group_backward_plain(x, mask, gl, w_in, b_in, w_rs, b_rs, d_xo, d_sk)
    if x.device.type != "cuda":
        raise ValueError(f"wn_group_backward: unsupported device {x.device}")
    _check_cuda_args(x, mask, gl, w_in, b_in, w_rs, b_rs)
    d_xo, d_sk = d_xo.contiguous(), d_sk.contiguous()
    for name, t in (("d_xo", d_xo), ("d_sk", d_sk)):
        if t.shape != x.shape or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"wn_group_backward: {name} must be fp32 {tuple(x.shape)} on {x.device}")
    if saved is None:
        saved = _forward_cuda(x, mask, gl, w_in, b_in, w_rs, b_rs, save=True)[2]
    B, T, H = x.shape
    L, k = w_in.shape[:2]
    d_x = torch.empty_like(x)
    d_gl = None if gl is None else torch.empty_like(gl)
    d_w_in, d_b_in = torch.empty_like(w_in), torch.empty_like(b_in)
    d_w_rs, d_b_rs = torch.empty_like(w_rs), torch.empty_like(b_rs)
    work = x.new_empty(backward_workspace(B, T, H, k))
    lib = build.load_library()
    with torch.cuda.device(x.device):
        code = lib.tts_wn_group_backward(
            mask.data_ptr(), w_in.data_ptr(), w_rs.data_ptr(), saved[0].data_ptr(),
            saved[1].data_ptr(), d_xo.data_ptr(), d_sk.data_ptr(), d_x.data_ptr(),
            None if d_gl is None else d_gl.data_ptr(), d_w_in.data_ptr(), d_b_in.data_ptr(),
            d_w_rs.data_ptr(), d_b_rs.data_ptr(), work.data_ptr(), B, T, H, L, k, _stream(x))
    build.check_cuda_error(code, "wn_group_backward")
    wn_group_backward.launches += 1
    return d_x, d_gl, d_w_in, d_b_in, d_w_rs, d_b_rs


wn_group_backward.launches = 0


class _WNGroupFunction(torch.autograd.Function):
    """The forward kernel with its saves, and the backward kernel."""

    @staticmethod
    def forward(ctx, x, mask, gl, w_in, b_in, w_rs, b_rs):
        x_out, skip, saved = _forward_cuda(x, mask, gl, w_in, b_in, w_rs, b_rs, save=True)
        ctx.has_gl = gl is not None
        ctx.save_for_backward(x, mask, gl if gl is not None else x.new_empty(0), w_in, b_in,
                              w_rs, b_rs, *saved)
        return x_out, skip

    @staticmethod
    def backward(ctx, d_xo, d_sk):
        x, mask, gl, w_in, b_in, w_rs, b_rs, save_x, save_xin = ctx.saved_tensors
        d_x, d_gl, d_w_in, d_b_in, d_w_rs, d_b_rs = wn_group_backward(
            x, mask, gl if ctx.has_gl else None, w_in, b_in, w_rs, b_rs, d_xo, d_sk,
            saved=(save_x, save_xin))
        return d_x, None, d_gl, d_w_in, d_b_in, d_w_rs, d_b_rs


def wn_group(x, mask, gl, w_in, b_in, w_rs, b_rs):
    """One WN layer group -> (x_out [B, T, H], skip * mask [B, T, H]), in
    time tiles that `pick_tile` chooses for the card; differentiable."""
    if x.device.type == "cpu":
        return wn_group_plain(x, mask, gl, w_in, b_in, w_rs, b_rs)
    if x.device.type != "cuda":
        raise ValueError(f"wn_group: unsupported device {x.device}")
    _check_cuda_args(x, mask, gl, w_in, b_in, w_rs, b_rs)
    if torch.is_grad_enabled():
        if mask.requires_grad:
            raise RuntimeError("wn_group: the backward kernel gives no gradient for the mask")
        if any(t is not None and t.requires_grad for t in (x, gl, w_in, b_in, w_rs, b_rs)):
            return _WNGroupFunction.apply(x, mask, gl, w_in, b_in, w_rs, b_rs)
    return _forward_cuda(x, mask, gl, w_in, b_in, w_rs, b_rs, save=False)[:2]


wn_group.launches = 0


def wn_stack(x, mask, gl: Optional[torch.Tensor], w_in, b_in, w_rs, b_rs,
             group: int = 4) -> torch.Tensor:
    """Full WN stack -> skip sum [B, T, H] (the WN's `output * x_mask`),
    as chained groups of at most `group` layers."""
    L = w_in.shape[0]
    skip = None
    for s in range(0, L, group):
        e = min(s + group, L)
        gls = None if gl is None else gl[:, s:e].contiguous()
        x, sk = wn_group(x, mask, gls, w_in[s:e].contiguous(), b_in[s:e].contiguous(),
                         w_rs[s:e].contiguous(), b_rs[s:e].contiguous())
        skip = sk if skip is None else skip + sk
    return skip
