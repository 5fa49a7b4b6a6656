"""Fused WaveNet (WN) gated conv stack, forward and backward.

Replaces the TPU kernels of `torch_tts_tpu/kernels/wn_stack.py`: the
forward (`wn_group` -> `_wn_group_pallas` -> `_wn_fwd_kernel`) and the
backward (`_wn_group_pallas_bwd` -> `_wn_bwd_kernel`), with the CUDA kernels
of `torch_tts_tpu_torch/csrc/wn_stack.cu` (fp32) and
`torch_tts_tpu_torch/csrc/wn_stack_bf16.cu` (bf16), keeping their contract: x
[B, T, H], mask [B, T, 1], gl [B, L, 2H] per-layer conditioning or None,
w_in [L, k, H, 2H] effective conv kernels, b_in [L, 2H], w_rs [L, H, 2H] 1x1
res/skip kernels whose final layer has a zero residual half, b_rs [L, 2H];
fp32, or bf16 (bf16 training), all of one dtype. A group returns (x_out,
skip * mask) in that dtype; `wn_stack` chains groups of at most four layers
and returns the skip sum, as the JAX version does. `wn_stack` computes in
x's dtype, as the Pallas kernel does (its products promote the weights to
an fp32 x, its outputs take x's dtype): it casts the mask, gl and the
weights to x's dtype, so an fp32 x with bf16 weights (the flows' WN under
bf16 training, whose x the fp32 attention promotes) runs the fp32 kernels.

On the card `wn_group` is a `torch.autograd.Function`. In the forward it
launches the forward kernel; when a gradient is wanted, the kernel also
writes each layer's input and pre-activation, which the backward kernel
(`wn_group_backward`) reads as it walks the layers in reverse. The plain
version of the backward is autograd through `wn_group_plain`
(`wn_group_backward_plain`). No gradient is taken with respect to the mask:
a mask that requires one raises.

On the H100 a flow's WN (H=192, k=5, L=4, 1024 frames) is about 3.6 GFLOP
per batch item forward and twice that backward. Both run their products
on the tensor cores in 3xTF32 (fp32-level error; `mrf_fused.split_tf32`
is the split). The forward runs all layers of a group on a 64-row time
tile in shared memory, its 2H columns split over a cluster of CTAs that
trade each layer's acts and x through distributed shared memory, the
weights split into hi and lo once a call (a workspace of
`split_weights_floats`) and brought in by TMA; `plan_forward` picks the
cluster size from the grid and the card's cluster occupancy. The backward is split-K by batch item, deterministic; see
the .cu file.

The bf16 variants (`tts_wn_group_forward_bf16`, `tts_wn_group_backward_bf16`,
`csrc/wn_stack_bf16.cu`) are kernels of their own, built for bf16: operands
brought into shared memory by TMA and multiplied by `wgmma` bf16 with fp32
accumulation, a producer warp feeding two consumer warpgroups. The forward
holds 128-row windows (`plan_forward_bf16`: 3-CTA clusters, the x window
and acts in bf16); the backward runs its products as tiled GEMMs over
tensor maps. The gate, the residual x and the skip sums are fp32 inside the
group, x_out, skip and the gradients bf16. Saves: x_i in bf16 (only the
tensor cores read it), x_in in fp32 (`save_dtypes`); the backward keeps
acts, d_xin and the masked cotangents in bf16 and d_x between layers in
fp32 (`backward_buffers`). Bounds at the posterior encoder's training shape (B=8,
T=1000, H=192, L=4, k=5) at bf16's 989 TFLOP/s: forward with saves 0.029
ms, backward 0.057 ms. The plain versions run in bf16 as the JAX
`wn_group_ref` does (every op rounded to bf16); the gradients come back in
each input's dtype, as the Pallas backward's outputs do.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. Where no gradient is wanted (inference, and what
`torch.export` records), `wn_group` is the operator `tts::wn_group`
(`build.OPS`), the forward without saves; training keeps
`_WNGroupFunction`. `wn_group.launches` and `wn_group_backward.launches`
count the calls that launch their fp32 kernels, `.launches_bf16` their
bf16 variants' (one per wrapper call; the fp32 forward launches the
weights' split and the group kernel, the bf16 backward 2 L + 2 kernels).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from torch_tts_tpu_torch.kernels import build

SUPPORTED_HIDDEN = (192,)  # every shipped config
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)  # one dtype for every tensor of a call
MAX_TAPS = 15  # the largest (odd) conv kernel the forward's shared memory takes
SMEM_BYTES = 232448  # per-block dynamic shared memory limit on Hopper
WINDOW = 64  # rows of x a forward CTA holds: one m64 tile of the products
FORWARD_CLUSTERS = (3, 4)  # the forward's cluster sizes: CTAs that split the 2H columns
WINDOW_BF16 = 128  # rows of the bf16 forward's window: two m64 warpgroups
CLUSTER_BF16 = 3  # the bf16 forward's cluster: 64 channels a CTA, one swizzle atom


@dataclasses.dataclass(frozen=True)
class ForwardPlan:
    cluster: int  # CTAs that split the 2H columns
    frames: int   # frames a tile owns: window - 2 L (k - 1) / 2, the rest is halo
    tiles: int    # time tiles over the batch
    window: int = WINDOW  # rows a CTA holds

    @property
    def ctas(self) -> int:
        return self.tiles * self.cluster

    @property
    def halo_share(self) -> float:
        return 1.0 - self.frames / self.window


def forward_smem_bytes(cluster: int, k: int, H: int = 192) -> int:
    """Shared memory of the forward kernel's CTA (csrc/wn_stack.cu
    FwdShape::smem_bytes): a two-slot ring of 32-deep hi / lo weight
    chunks, the x window's hi and lo parts with (k - 1) / 2 pad rows a side,
    acts, the mask and the ring's two barriers."""
    return 4 * (2 * 2 * 32 * (2 * H // cluster) + 2 * (WINDOW + k - 1) * (H + 4)
                + WINDOW * (H + 4) + WINDOW) + 16


def plan_forward(B: int, T: int, k: int, L: int, H: int = 192, one_wave: int = 0) -> ForwardPlan:
    """The forward's time tiles and cluster size. `one_wave`: how many
    4-CTA clusters the card holds at once (`clusters_at_once`). When every
    tile fits in that one wave, the 4-CTA split is taken (each CTA does 3/4
    of a 3-CTA CTA's products); over several waves the 3-CTA split, whose
    wider products are the more efficient; on the H100 each was the faster
    on its side (chip_smoke.py times both). Where the 3-CTA CTA does not
    fit in shared memory (k >= 13) the 4-CTA one is taken."""
    frames = WINDOW - 2 * L * ((k - 1) // 2)
    if frames < 1:
        raise ValueError(f"wn_group: a halo of L (k - 1) / 2 = {L * ((k - 1) // 2)} frames a "
                         f"side leaves no frames in a {WINDOW}-row window")
    tiles = B * -(-T // frames)
    narrow = tiles <= one_wave or forward_smem_bytes(3, k, H) > SMEM_BYTES
    return ForwardPlan(4 if narrow else 3, frames, tiles)


def plan_forward_bf16(B: int, T: int, k: int, L: int) -> ForwardPlan:
    """The bf16 forward's time tiles: 128-row windows (a halo share of 12.5%
    at k=5, L=4), always in 3-CTA clusters; a halo that leaves no frames
    raises."""
    frames = WINDOW_BF16 - 2 * L * ((k - 1) // 2)
    if frames < 1:
        raise ValueError(f"wn_group: a halo of L (k - 1) / 2 = {L * ((k - 1) // 2)} frames a "
                         f"side leaves no frames in a {WINDOW_BF16}-row window")
    return ForwardPlan(CLUSTER_BF16, frames, B * -(-T // frames), WINDOW_BF16)


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


def supports(H: int, k: int, dtype: torch.dtype = torch.float32) -> bool:
    """Whether the kernels take a stack of H hidden channels and k taps in
    `dtype` (fp32 or bf16): the rule a model checks before it sends a WN to
    `wn_stack`."""
    return H in SUPPORTED_HIDDEN and k % 2 == 1 and k <= MAX_TAPS and dtype in SUPPORTED_DTYPES


def _check_cuda_args(x, mask, gl, w_in, b_in, w_rs, b_rs):
    if x.dim() != 3 or w_in.dim() != 4:
        raise ValueError("wn_group: x must be [B, T, H] and w_in [L, k, H, 2H]")
    B, T, H = x.shape
    L, k = w_in.shape[:2]
    if not supports(H, k, x.dtype):
        raise ValueError(f"wn_group: H={H} (supported {SUPPORTED_HIDDEN}), "
                         f"k={k} (odd, <= {MAX_TAPS}), dtype {x.dtype} (fp32 or bf16)")
    shapes = {"x": (x, (B, T, H)), "mask": (mask, (B, T, 1)), "gl": (gl, (B, L, 2 * H)),
              "w_in": (w_in, (L, k, H, 2 * H)), "b_in": (b_in, (L, 2 * H)),
              "w_rs": (w_rs, (L, H, 2 * H)), "b_rs": (b_rs, (L, 2 * H))}
    for name, (t, shape) in shapes.items():
        if t is None and name == "gl":
            continue
        if (t.device != x.device or t.dtype != x.dtype or tuple(t.shape) != shape
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"wn_group: {name} must be a contiguous, 16-byte aligned "
                             f"{x.dtype} {shape} tensor on {x.device}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=None)
def clusters_at_once(cluster: int, k: int, device_index: int) -> int:
    """How many clusters of `cluster` fp32 forward CTAs for k taps the card
    `device_index` holds at once (cudaOccupancyMaxActiveClusters)."""
    lib = build.load_library()
    n = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        build.check_cuda_error(lib.tts_wn_forward_max_clusters(cluster, k, ctypes.byref(n)),
                               "wn_group (cluster occupancy)")
    return n.value


def split_weights_floats(L: int, k: int, H: int) -> int:
    """Floats of the fp32 forward's workspace: w_in and w_rs split into TF32
    hi and lo parts, in the order the kernel's ring takes them."""
    return 2 * L * (k + 1) * H * 2 * H


def save_dtypes(dtype: torch.dtype) -> Tuple[torch.dtype, torch.dtype]:
    """The dtypes of the saving forward's (x_i, x_in) for tensors of
    `dtype`: fp32 for fp32; for bf16, x_i in bf16 (only the backward's
    tensor cores read it, as bf16) and x_in in fp32 (the gate derivative
    is taken from it)."""
    return (dtype, torch.float32)


def _forward_cuda(x, mask, gl, w_in, b_in, w_rs, b_rs, save: bool, plan: Optional[ForwardPlan] = None):
    """Forward kernels -> (x_out, skip, saved); saved is (x_i [L, B, T, H],
    x_in [L, B, T, 2H]) in `save_dtypes(x.dtype)` when `save`, else None.
    fp32: the weights' split, then the group, in `plan` (by default
    `plan_forward`'s for this card); bf16: the group alone, whose only plan
    is `plan_forward_bf16`'s."""
    B, T, H = x.shape
    L, k = w_in.shape[:2]
    bf16 = x.dtype == torch.bfloat16
    if bf16 and plan is not None and plan != plan_forward_bf16(B, T, k, L):
        raise ValueError(f"wn_group: the bf16 forward runs {plan_forward_bf16(B, T, k, L)} only")
    if plan is None and not bf16:
        index = x.device.index if x.device.index is not None else torch.cuda.current_device()
        plan = plan_forward(B, T, k, L, H, one_wave=clusters_at_once(4, k, index))
    x_out, skip = torch.empty_like(x), torch.empty_like(x)
    saved = None
    if save:
        dx, din = save_dtypes(x.dtype)
        saved = (x.new_empty(L, B, T, H, dtype=dx), x.new_empty(L, B, T, 2 * H, dtype=din))
    ptrs = (x.data_ptr(), mask.data_ptr(), None if gl is None else gl.data_ptr(),
            w_in.data_ptr(), b_in.data_ptr(), w_rs.data_ptr(), b_rs.data_ptr(),
            x_out.data_ptr(), skip.data_ptr(),
            None if saved is None else saved[0].data_ptr(),
            None if saved is None else saved[1].data_ptr())
    lib = build.load_library()
    with torch.cuda.device(x.device):
        if bf16:
            code = lib.tts_wn_group_forward_bf16(*ptrs, B, T, H, L, k, _stream(x))
        else:
            wsplit = x.new_empty(split_weights_floats(L, k, H))
            code = lib.tts_wn_group_forward(*ptrs, wsplit.data_ptr(), B, T, H, L, k,
                                            plan.cluster, _stream(x))
    build.check_cuda_error(code, "wn_group")
    build.count_launch(wn_group, attr="launches_bf16" if bf16 else "launches")
    return x_out, skip, saved


def backward_buffers(B: int, T: int, H: int, k: int,
                     dtype: torch.dtype = torch.float32) -> Tuple[Tuple[str, torch.dtype, tuple], ...]:
    """The backward kernel's scratch, in the order it lies in the workspace:
    (name, dtype, shape). fp32: d_x between layers, d_xin, acts and the
    per-item partial weight gradients; bf16: d_x between layers in fp32
    (updated in place), two sets of partials (a layer's are reduced while
    the next layer's are formed), then d_xin, acts, d_x m for this layer
    and the next and d_sk m: the operands only the tensor cores read, in
    bf16."""
    R, f32, bf = B * T, torch.float32, torch.bfloat16
    if dtype == torch.float32:
        return (("d_x", f32, (R, H)), ("d_xin", f32, (R, 2 * H)), ("acts", f32, (R, H)),
                ("part_in", f32, (B, k * H + 1, 2 * H)), ("part_rs", f32, (B, H + 1, 2 * H)))
    return (("d_x", f32, (R, H)), ("part_in", f32, (2, B, k * H + 1, 2 * H)),
            ("part_rs", f32, (2, B, H + 1, 2 * H)), ("d_xin", bf, (R, 2 * H)),
            ("acts", bf, (R, H)), ("d_x_m", bf, (2, R, H)), ("d_sk_m", bf, (R, H)))


def backward_workspace(B: int, T: int, H: int, k: int, dtype: torch.dtype = torch.float32) -> int:
    """Floats of scratch the backward kernel takes (`backward_buffers`):
    B T 4H + B (k H + 1) 2H + B (H + 1) 2H in fp32; the bf16 variant's
    operands take half the room and its second set of partials one more
    B (k H + 1) 2H + B (H + 1) 2H."""
    n = 0
    for _, dt, shape in backward_buffers(B, T, H, k, dtype):
        n += math.prod(shape) * (4 if dt == torch.float32 else 2)
    return n // 4


def wn_group_backward(x, mask, gl, w_in, b_in, w_rs, b_rs, d_xo, d_sk, saved=None):
    """Gradients of one group -> (d_x, d_gl or None, d_w_in, d_b_in, d_w_rs,
    d_b_rs), the contract of the JAX `_wn_group_pallas_bwd`. On the card
    `saved` is what the saving forward wrote (x_i, x_in in `save_dtypes`);
    without it that forward runs first."""
    if x.device.type == "cpu":
        return wn_group_backward_plain(x, mask, gl, w_in, b_in, w_rs, b_rs, d_xo, d_sk)
    if x.device.type != "cuda":
        raise ValueError(f"wn_group_backward: unsupported device {x.device}")
    _check_cuda_args(x, mask, gl, w_in, b_in, w_rs, b_rs)
    d_xo, d_sk = d_xo.contiguous(), d_sk.contiguous()
    for name, t in (("d_xo", d_xo), ("d_sk", d_sk)):
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"wn_group_backward: {name} must be {x.dtype} {tuple(x.shape)} "
                             f"on {x.device}")
    if saved is None:
        saved = _forward_cuda(x, mask, gl, w_in, b_in, w_rs, b_rs, save=True)[2]
    if (saved[0].dtype, saved[1].dtype) != save_dtypes(x.dtype):
        raise ValueError(f"wn_group_backward: saves of {x.dtype} tensors are "
                         f"{save_dtypes(x.dtype)}, not {(saved[0].dtype, saved[1].dtype)}")
    B, T, H = x.shape
    L, k = w_in.shape[:2]
    d_x = torch.empty_like(x)
    d_gl = None if gl is None else torch.empty_like(gl)
    d_w_in, d_b_in = torch.empty_like(w_in), torch.empty_like(b_in)
    d_w_rs, d_b_rs = torch.empty_like(w_rs), torch.empty_like(b_rs)
    work = x.new_empty(backward_workspace(B, T, H, k, x.dtype), dtype=torch.float32)
    lib = build.load_library()
    with torch.cuda.device(x.device):
        entry = (lib.tts_wn_group_backward_bf16 if x.dtype == torch.bfloat16
                 else lib.tts_wn_group_backward)
        code = entry(
            mask.data_ptr(), w_in.data_ptr(), w_rs.data_ptr(), saved[0].data_ptr(),
            saved[1].data_ptr(), d_xo.data_ptr(), d_sk.data_ptr(), d_x.data_ptr(),
            None if d_gl is None else d_gl.data_ptr(), d_w_in.data_ptr(), d_b_in.data_ptr(),
            d_w_rs.data_ptr(), d_b_rs.data_ptr(), work.data_ptr(), B, T, H, L, k, _stream(x))
    build.check_cuda_error(code, "wn_group_backward")
    build.count_launch(wn_group_backward,
                       attr="launches_bf16" if x.dtype == torch.bfloat16 else "launches")
    return d_x, d_gl, d_w_in, d_b_in, d_w_rs, d_b_rs


wn_group_backward.launches = wn_group_backward.launches_bf16 = 0


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
    the time tiles and clusters that `plan_forward` chooses for the card;
    differentiable. Where no gradient is wanted, the operator
    `tts::wn_group` (the forward without saves); where one is, a CPU tensor
    takes `wn_group_plain` under autograd and a CUDA tensor
    `_WNGroupFunction` (the saving forward and the backward kernel)."""
    build.check_device(x, "wn_group")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, mask, gl, w_in, b_in, w_rs, b_rs)):
        if x.device.type == "cpu":
            return wn_group_plain(x, mask, gl, w_in, b_in, w_rs, b_rs)
        _check_cuda_args(x, mask, gl, w_in, b_in, w_rs, b_rs)
        if mask.requires_grad:
            raise RuntimeError("wn_group: the backward kernel gives no gradient for the mask")
        return _WNGroupFunction.apply(x, mask, gl, w_in, b_in, w_rs, b_rs)
    return torch.ops.tts.wn_group(x, mask, gl, w_in, b_in, w_rs, b_rs)


def _wn_group_cpu(x, mask, gl, w_in, b_in, w_rs, b_rs):
    return tuple(t.contiguous() for t in wn_group_plain(x, mask, gl, w_in, b_in, w_rs, b_rs))


def _wn_group_fake(x, mask, gl, w_in, b_in, w_rs, b_rs):
    return (torch.empty_like(x, memory_format=torch.contiguous_format),
            torch.empty_like(x, memory_format=torch.contiguous_format))


def _wn_group_cuda(x, mask, gl, w_in, b_in, w_rs, b_rs):
    """`tts::wn_group` on CUDA tensors: the forward kernel without saves."""
    _check_cuda_args(x, mask, gl, w_in, b_in, w_rs, b_rs)
    return _forward_cuda(x, mask, gl, w_in, b_in, w_rs, b_rs, save=False)[:2]


wn_group.launches = wn_group.launches_bf16 = 0
build.define_op("wn_group", _wn_group_cpu, _wn_group_cuda, _wn_group_fake)


def wn_stack(x, mask, gl: Optional[torch.Tensor], w_in, b_in, w_rs, b_rs,
             group: int = 4) -> torch.Tensor:
    """Full WN stack -> skip sum [B, T, H] (the WN's `output * x_mask`),
    as chained groups of at most `group` layers, in x's dtype: the mask, gl
    and the weights are cast to it (differentiably)."""
    mask, gl, w_in, b_in, w_rs, b_rs = (None if t is None else t.to(x.dtype)
                                        for t in (mask, gl, w_in, b_in, w_rs, b_rs))
    L = w_in.shape[0]
    skip = None
    for s in range(0, L, group):
        e = min(s + group, L)
        gls = None if gl is None else gl[:, s:e].contiguous()
        x, sk = wn_group(x, mask, gls, w_in[s:e].contiguous(), b_in[s:e].contiguous(),
                         w_rs[s:e].contiguous(), b_rs[s:e].contiguous())
        skip = sk if skip is None else skip + sk
    return skip
