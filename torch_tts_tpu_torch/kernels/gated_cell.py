"""LLTM gated recurrent cell with an analytic backward.

Replaces the TPU kernel `torch_tts_tpu/kernels/gated_cell.py`
(`_lltm_fwd_pallas` -> `_fwd_kernel`) with the CUDA kernel
`torch_tts_tpu_torch/csrc/gated_cell.cu`, keeping its contract: x [B, I],
weights [3H, H + I], bias [3H], old_h and old_cell [B, H], of any real
dtype, each cast to fp32 as the JAX wrapper casts (`kernel_args`) ->
fp32 (new_h, new_cell) [B, H]; the kernel also writes the raw gates
[B, 3H], which the backward reads. The cell is the twin of the PyTorch extension
tutorial's LLTM: the gate product, then sigmoid input and output gates, an
ELU candidate (exp(min(z, 0)) - 1, as the TPU kernel writes it), the cell
update and tanh.

`lltm_ref` is the plain version (autograd differentiates it). `lltm` is a
`torch.autograd.Function` whose forward launches the kernel on the card
and runs `lltm_forward_plain` on the CPU, and whose backward is the JAX
package's analytic chain (`_lltm_vjp_bwd`) in torch ops; that chain runs
outside any Pallas kernel in JAX, so its products go to torch.matmul here.

On the H100 the cell at the tutorial's size (B=16, I=32, H=128) is about
2 MFLOP and 0.3 MB: the kernel is bound by its launch and one round trip
to memory (see the .cu file).

Dispatch: a CPU tensor takes the plain forward; a CUDA tensor launches the
kernel or raises. `lltm.launches` counts kernel launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from torch_tts_tpu_torch.kernels import build


def _elu(z: torch.Tensor) -> torch.Tensor:
    return torch.where(z > 0, z, torch.exp(torch.clamp(z, max=0.0)) - 1.0)


def _cell(gates: torch.Tensor, old_cell: torch.Tensor, H: int):
    input_gate = torch.sigmoid(gates[:, :H])
    output_gate = torch.sigmoid(gates[:, H:2 * H])
    candidate = _elu(gates[:, 2 * H:])
    new_cell = old_cell + candidate * input_gate
    return torch.tanh(new_cell) * output_gate, new_cell


def lltm_forward_plain(x, weights, bias, old_h, old_cell):
    """The kernel's contract in plain torch -> (new_h, new_cell, gates)."""
    gates = torch.cat([old_h, x], dim=1) @ weights.t() + bias
    return (*_cell(gates, old_cell, old_h.shape[1]), gates)


def lltm_ref(x, weights, bias, old_h, old_cell) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: x [B, I], weights [3H, H+I], bias [3H], old_h and
    old_cell [B, H] -> (new_h, new_cell)."""
    return lltm_forward_plain(x, weights, bias, old_h, old_cell)[:2]


def kernel_args(x, weights, bias, old_h, old_cell):
    """The kernel's checks on its arguments, then the tensors it takes: each
    input cast to a contiguous fp32 tensor (any real dtype, as the JAX
    wrapper casts every input to fp32 before its kernel; a copy only where
    needed); raises ValueError on complex input, a device other than x's or
    a wrong shape."""
    args = (x, weights, bias, old_h, old_cell)
    if any(t.is_complex() or t.dtype == torch.bool for t in args):
        raise ValueError("lltm: the kernel takes real inputs")
    if x.dim() != 2 or old_h.dim() != 2:
        raise ValueError("lltm: x [B, I] and old_h [B, H]")
    B, I = x.shape
    H = old_h.shape[1]
    shapes = ((B, I), (3 * H, H + I), (3 * H,), (B, H), (B, H))
    for t, shape in zip(args, shapes):
        if t.device != x.device or tuple(t.shape) != shape:
            raise ValueError(f"lltm: inputs on {x.device}, x [B, I], weights [3H, H+I], "
                             f"bias [3H], old_h and old_cell [B, H]")
    return tuple(t.to(torch.float32).contiguous() for t in args)


def _launch(x, weights, bias, old_h, old_cell):
    """The kernel on the tensors of `kernel_args` -> (new_h, new_cell, gates)."""
    B, I = x.shape
    H = old_h.shape[1]
    new_h, new_cell, gates = torch.empty_like(old_h), torch.empty_like(old_h), x.new_empty(B, 3 * H)
    lib = build.load_library()
    with torch.cuda.device(x.device):
        code = lib.tts_lltm_forward(
            x.data_ptr(), weights.data_ptr(), bias.data_ptr(), old_h.data_ptr(),
            old_cell.data_ptr(), new_h.data_ptr(), new_cell.data_ptr(), gates.data_ptr(), B, I, H,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check_cuda_error(code, "lltm")
    lltm.launches += 1
    return new_h, new_cell, gates


def _lltm_forward_cuda(x, weights, bias, old_h, old_cell):
    """The kernel on any real inputs on the card -> fp32 (new_h, new_cell,
    gates), as the TPU kernel gives."""
    return _launch(*kernel_args(x, weights, bias, old_h, old_cell))


def launch_floor(B: int, I: int, H: int, device) -> None:
    """An empty kernel launched as the LLTM kernel is at this shape (grid,
    cluster, block and shared memory): the least device time of a launch,
    a yardstick for the kernel's; it does not count as a launch."""
    lib = build.load_library()
    device = torch.device(device)
    with torch.cuda.device(device):
        code = lib.tts_lltm_launch_floor(B, I, H, torch.cuda.current_stream(device).cuda_stream)
    build.check_cuda_error(code, "lltm launch floor")


class _LLTMFunction(torch.autograd.Function):
    """The forward kernel (plain forward on the CPU) and the analytic
    backward of `_lltm_vjp_bwd`. Autograd casts each gradient to its
    input's dtype, as the JAX `custom_vjp` returns them."""

    @staticmethod
    def forward(ctx, x, weights, bias, old_h, old_cell):
        if x.device.type == "cpu":
            new_h, new_cell, gates = lltm_forward_plain(x, weights, bias, old_h, old_cell)
        else:  # the backward runs on what the kernel took, in fp32
            x, weights, bias, old_h, old_cell = kernel_args(x, weights, bias, old_h, old_cell)
            new_h, new_cell, gates = _launch(x, weights, bias, old_h, old_cell)
        ctx.save_for_backward(torch.cat([old_h, x], dim=1), gates, new_cell, weights)
        return new_h, new_cell

    @staticmethod
    def backward(ctx, grad_h, grad_cell):
        X, gates, new_cell, weights = ctx.saved_tensors
        H = new_cell.shape[1]
        ig_z, og_z, cand_z = gates[:, :H], gates[:, H:2 * H], gates[:, 2 * H:]
        input_gate, output_gate = torch.sigmoid(ig_z), torch.sigmoid(og_z)
        tanh_new_cell = torch.tanh(new_cell)

        d_output_gate = tanh_new_cell * grad_h
        d_new_cell = (1.0 - tanh_new_cell ** 2) * (output_gate * grad_h) + grad_cell
        d_gates = torch.cat([
            (_elu(cand_z) * d_new_cell) * (input_gate * (1 - input_gate)),
            d_output_gate * (output_gate * (1 - output_gate)),
            (input_gate * d_new_cell) * torch.where(cand_z > 0, 1.0, torch.exp(cand_z)),
        ], dim=1)
        need = ctx.needs_input_grad
        d_weights = d_gates.t() @ X if need[1] else None
        d_bias = d_gates.sum(dim=0) if need[2] else None
        d_X = d_gates @ weights if need[0] or need[3] else None
        d_input = d_X[:, H:] if need[0] else None
        d_old_h = d_X[:, :H] if need[3] else None
        return d_input, d_weights, d_bias, d_old_h, d_new_cell if need[4] else None


def lltm(x, weights, bias, old_h, old_cell) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused cell with the analytic backward; same contract as `lltm_ref`."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lltm: unsupported device {x.device}")
    return _LLTMFunction.apply(x, weights, bias, old_h, old_cell)


lltm.launches = 0
