"""Streaming (chunked) waveform decoding for a low time to first audio (port
of `torch_tts_tpu/infer/streaming.py`).

VITS2's decoder is feed-forward and local: every output sample depends on a
bounded neighbourhood of latent frames. So the waveform can be produced
chunk by chunk, and the first audio returned after decoding one window of
`chunk_frames + 2 * context_frames` frames instead of the whole utterance.

Exactness: each chunk is decoded from a window of fixed size W = chunk +
2 * context, clamped inside [0, T] (shifted inward at the edges, never
zero-padded: conv biases make a processed zero frame nonzero, so a zero
halo would change the kept frames), then trimmed to the chunk's own frames.
With `context_frames` covering the decoder's receptive-field half-width,
the concatenated chunks equal the whole decode within float reassociation
(tests/test_torch_streaming.py holds them within 2e-5). At T <= W the whole
sequence is decoded at once.

Inputs are channels-last, as the JAX API's: latents [B, T, C], the mask
[B, T, 1], g [B, 1, gin] (what `SynthesizerTrn.infer_latents` returns);
each yielded chunk is [B, n, 1] audio on the model's device.

The same holds for the MB-iSTFT decoder (`ops/mb_istft.py`), whose trunk
spans fewer frames than HiFi-GAN's and whose iSTFT and PQMF head reach
under one frame. Its stream equals the whole masked decode too; `infer`
(as the JAX package's) differs from that in an utterance's last n_fft / 2
* subbands + 31 samples when it decodes the exact length (an utterance of
at least 128 frames in a longer max_frames: the masked frames past the end
give conv_post's bias as log-magnitudes, which the iSTFT and the PQMF
carry back across the end).

With the int8 decoder (`quantize_decoder`) each window quantizes its
activations with its own per-tensor scales, so neither equality above
holds: a stream then equals the JAX package's stream of the same windows
(and an unmasked window still equals its all-ones masked decode), not the
whole decode.

The decoder's ResBlock1 banks take the MRF kernel only when the decode is
unmasked (`ops/hifigan.py`). A window whose mask is all ones decodes to the
same values without it, so when the caller passes the host's `lengths` (the
frames of each row, which `Synthesizer.stream` has fetched already), every
window that ends at or before the shortest length is decoded unmasked; only
the windows that reach past an utterance's end carry the mask.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple

import torch


def windows(T: int, chunk: int, context: int) -> Iterator[Tuple[int, int, int]]:
    """(start, lo, n_keep) in frames for each chunk of a T-frame stream: the
    window [start, start + chunk + 2 * context) clamped inside [0, T], and
    its frames [lo, lo + n_keep) that the chunk keeps."""
    W = chunk + 2 * context
    for i in range(-(-T // chunk)):
        start = min(max(i * chunk - context, 0), T - W)
        yield start, i * chunk - start, min(chunk, T - i * chunk)


def _channels_first(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.transpose(1, 2).contiguous()


class _WindowedStream:
    """The fixed-window loop both decoders share; `_window(x, mask, g)`
    decodes one window [B, C, W] (mask [B, 1, W] or None: unmasked) to
    [B, 1, W * factor]."""

    def __init__(self, model, chunk_frames: int, context_frames: int):
        self.model = model
        self.chunk = chunk_frames
        self.ctx = context_frames

    @torch.inference_mode()
    def stream(self, z: torch.Tensor, g: Optional[torch.Tensor] = None,
               x_mask: Optional[torch.Tensor] = None,
               lengths: Optional[Sequence[int]] = None) -> Iterator[torch.Tensor]:
        """z [B, T, C] -> [B, n, 1] audio chunks whose concatenation, T *
        factor samples long, equals (with the fp decoder; module docstring)
        the whole masked decode with the samples
        where x_mask is 0 zeroed (`infer`'s exact-length semantics). Without
        x_mask every frame is valid. `lengths` (host ints, one a row) lets
        windows that end within every row decode unmasked."""
        B, T, _ = z.shape
        zc = z.transpose(1, 2)  # [B, C, T], a strided view: windows are made contiguous
        mc = None if x_mask is None else x_mask.transpose(1, 2)
        gc = _channels_first(g)
        full = T if mc is None else (min(int(n) for n in lengths) if lengths is not None else 0)
        W = self.chunk + 2 * self.ctx
        if T <= W:
            yield self._decode(zc.contiguous(), None if full >= T else mc.contiguous(), gc)
            return
        factor = None
        for start, lo, n_keep in windows(T, self.chunk, self.ctx):
            zwin = zc[:, :, start:start + W].contiguous()
            mwin = None if start + W <= full else mc[:, :, start:start + W].contiguous()
            audio = self._decode(zwin, mwin, gc)
            if factor is None:
                assert audio.shape[1] % W == 0
                factor = audio.shape[1] // W
            yield audio[:, lo * factor:(lo + n_keep) * factor]

    def _decode(self, x, mask, g) -> torch.Tensor:
        audio = self._window(x, mask, g)  # [B, 1, W * factor]
        if mask is not None:
            audio = audio * torch.repeat_interleave(mask, audio.shape[2] // x.shape[2], dim=2)
        return audio.transpose(1, 2)

    def decode(self, z: torch.Tensor, g: Optional[torch.Tensor] = None,
               x_mask: Optional[torch.Tensor] = None,
               lengths: Optional[Sequence[int]] = None) -> torch.Tensor:
        """The whole stream, concatenated: [B, T * factor, 1]."""
        return torch.cat(list(self.stream(z, g, x_mask, lengths)), dim=1)


class StreamingDecoder(_WindowedStream):
    """Chunked decoding through `model.dec` (HiFi-GAN or MB-iSTFT).

    chunk_frames: latent frames decoded per emitted chunk.
    context_frames: the halo on each side of a chunk; it must cover the
        decoder's receptive-field half-width in frames (32 is ample:
        HiFi-GAN's MRF stack spans fewer than 30 frames, the MB-iSTFT
        trunk fewer and its iSTFT and PQMF under one).
    """

    def __init__(self, model, chunk_frames: int = 64, context_frames: int = 32):
        super().__init__(model, chunk_frames, context_frames)

    def _window(self, x, mask, g):
        return self.model.dec(x, x_mask=mask, g=g)


class StreamingFlowDecoder(_WindowedStream):
    """Chunked flow reverse and decode: streams the flow too, so the time to
    first audio pays flow(window) + dec(window) instead of flow(T) +
    dec(window). Only for conv-local flows (the plain couplings,
    `use_transformer_flows=False`); the transformer flows attend over the
    whole sequence, so no finite window reproduces them, and construction
    raises ValueError on them unless `allow_nonlocal_flow=True` (then the
    output is approximate).

    `context_frames` must cover the flow's receptive-field half-width plus
    the decoder's; the default 64 is ample (4 couplings of WN(4 layers, k 5,
    dilation 1) reach about 32 frames, the MRF stack fewer than 30). Takes
    the pre-flow latents z_p [B, T, C] of `SynthesizerTrn.infer_pre_flow`.
    """

    def __init__(self, model, chunk_frames: int = 64, context_frames: int = 64,
                 allow_nonlocal_flow: bool = False):
        cfgm = model.cfg
        if cfgm.use_transformer_flows and not allow_nonlocal_flow:
            raise ValueError(
                "StreamingFlowDecoder requires a conv-local flow "
                "(use_transformer_flows=False); transformer flow type "
                f"'{cfgm.transformer_flow_type}' attends globally. Use "
                "StreamingDecoder, or pass allow_nonlocal_flow=True to "
                "accept approximate output.")
        super().__init__(model, chunk_frames, context_frames)

    def _window(self, x, mask, g):
        flow_mask = mask if mask is not None else x.new_ones(x.shape[0], 1, x.shape[2])
        z = self.model.flow(x, flow_mask, g=g, reverse=True)
        if mask is not None:
            z = z * mask
        return self.model.dec(z, x_mask=mask, g=g)
