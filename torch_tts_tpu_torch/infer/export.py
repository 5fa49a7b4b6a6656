"""Model export: VITS2 inference as a `torch.export` program (port of
`torch_tts_tpu/infer/export.py`).

The JAX package serializes jitted inference as StableHLO with the
reference's ONNX signature; the port records the same computation with
`torch.export.export` and saves it with `torch.export.save` (a `.pt2` file):

    (text [1, T] int32, text_lengths [1] int32, scales [3] fp32 = (noise,
     length, noise_w)[, sid [1] int32 when multi-speaker])
      -> (audio [1, max_frames * hop, 1] fp32, y_lengths [1] int32)

Shapes are static, as in JAX: T = max_text_len (pad the ids, the lengths
say how many count) and max_frames fixed at export. The scales are inputs
of the program, not constants. Its noise comes from torch's default
generator of the device (`models/vits2/model.DEFAULT_RNG`), in `infer`'s
order (the SDP's, then the prior's): after the same `torch.manual_seed`,
the program and `model.infer(..., generator=DEFAULT_RNG)` draw the same
noise.

The kernels on the path (the MRF bank, the WN groups, the int8 quantizer
and conv) are recorded as `tts::` operators (`kernels/build.OPS`); a
program exported on the card runs them as kernels, one exported on the
CPU as their plain versions. `load_exported` registers them before it
loads. The JAX package's `savedmodel` format (a TensorFlow artifact) is not
ported.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class _InferProgram(nn.Module):
    """The exported signature around `SynthesizerTrn.infer_body`."""

    def __init__(self, model, max_frames: int):
        super().__init__()
        self.model = model
        self.max_frames = max_frames

    def forward(self, text, text_lengths, scales, sid=None):
        from torch_tts_tpu_torch.models.vits2.model import DEFAULT_RNG

        audio, _, _, _, y_lengths = self.model.infer_body(
            text, text_lengths, sid=sid, noise_scale=scales[0], length_scale=scales[1],
            noise_scale_w=scales[2], max_frames=self.max_frames, generator=DEFAULT_RNG)
        return audio, y_lengths


def export_program(module: nn.Module, args, path: Optional[str] = None):
    """`torch.export.export(module, args)` under no_grad (the kernels have
    no backward, and the program is for inference), saved to `path` when
    given -> the ExportedProgram."""
    with torch.no_grad():
        program = torch.export.export(module, tuple(args))
    if path:
        torch.export.save(program, path)
    return program


def export_vits2_infer(model, max_text_len: int = 512, max_frames: int = 1000,
                       multispeaker: bool = False, path: Optional[str] = None, device="cuda"):
    """Export `model` (a SynthesizerTrn, moved to `device` in eval mode) as
    the program of the module docstring -> the ExportedProgram (also saved
    to `path` when given)."""
    device = torch.device(device)
    model = model.to(device).eval()
    args = [torch.zeros(1, max_text_len, dtype=torch.int32, device=device),
            torch.full((1,), max_text_len, dtype=torch.int32, device=device),
            torch.tensor([0.667, 1.0, 0.8], dtype=torch.float32, device=device)]
    if multispeaker:
        args.append(torch.zeros(1, dtype=torch.int32, device=device))
    return export_program(_InferProgram(model, max_frames), args, path)


def load_exported(path: str):
    """A saved program (`export_vits2_infer`, `infer/vocoder.export_vocoder`)
    -> a callable module taking the signature's tensors, its weights
    needing no gradient. The `tts::` operators are registered first, by
    importing their kernel modules."""
    from torch_tts_tpu_torch.kernels import int8_conv, mrf_fused, wn_stack  # noqa: F401

    return torch.export.load(path).module().requires_grad_(False)
