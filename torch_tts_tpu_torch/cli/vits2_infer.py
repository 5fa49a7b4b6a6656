"""VITS2 inference CLI: text -> 16-bit WAV (port of
`torch_tts_tpu/cli/vits2_infer.py`).

`-m` takes a reference-format state dict (`.pth`, bare or {"model": ...}),
such as `tts-convert-checkpoint --to-torch` writes from a JAX run dir, or
a run directory of this package's trainer (its latest `ckpt_<step>.pt`;
`--average-last K` averages the last K). `--sid` picks the speaker of a
multi-speaker model. Text goes through `torch_tts_tpu_torch.text`
(cleaners from the config, blanks interspersed when `add_blank`).

Serving flags, through `infer/serving.py`'s `Synthesizer`:
`--text-file` synthesizes one text a line, batched within length buckets,
into out_000.wav, ...; `--long` splits an arbitrarily long `--text` at
sentence, then clause, then word boundaries, synthesizes the pieces and
joins them with `--pause-ms` of silence. `--stream-chunk FRAMES` streams
the decoder in chunks of that many frames (`infer/streaming.py`), prints
each chunk's time, and writes the same audio as the whole decode.

Usage:
  python -m torch_tts_tpu_torch.cli.vits2_infer -c configs/vits2-ljspeech.yaml \\
      -m G.pth --text "speech synthesis is neat" -o out.wav
  python -m torch_tts_tpu_torch.cli.vits2_infer -c configs/vits2-multispeaker.yaml \\
      -m runs/vctk --sid 3 --text "speech synthesis is neat" -o out.wav
"""

from __future__ import annotations

import argparse
import functools
import wave
from typing import List, Optional, Sequence

import numpy as np
import torch

from torch_tts_tpu_torch.text import intersperse, symbols, text_to_sequence
from torch_tts_tpu_torch.core.config import VITS2Config, load_vits2_config
from torch_tts_tpu_torch.core.precision import fp32_cudnn
from torch_tts_tpu_torch.models.vits2.model import SynthesizerTrn


def load_model(cfg: VITS2Config, checkpoint: str, device, average_last: int = 1) -> SynthesizerTrn:
    """SynthesizerTrn for `cfg` with the state dict in `checkpoint` (a file,
    or a run directory's latest checkpoint or the average of its last
    `average_last`) loaded strictly, on `device`, in eval mode."""
    from torch_tts_tpu_torch.infer.serving import load_generator_state

    sd = load_generator_state(checkpoint, average_last)
    if sd is None:
        raise SystemExit(f"no checkpoint in {checkpoint}")
    model = SynthesizerTrn(len(symbols), cfg.posterior_channels, cfg.model, cfg.segment_frames)
    model.load_state_dict(sd, strict=True)
    return model.to(device).eval()


def text_ids(text: str, cfg: VITS2Config) -> List[int]:
    ids = text_to_sequence(text, list(cfg.data.text_cleaners))
    return intersperse(ids, 0) if cfg.data.add_blank else ids


def synthesize(model: SynthesizerTrn, ids: Sequence[int], hop_length: int, *,
               noise_scale: float, noise_scale_w: float, length_scale: float,
               max_frames: int, generator: torch.Generator,
               sid: Optional[int] = None) -> np.ndarray:
    """One utterance (of speaker `sid`, or unconditioned) -> float
    waveform, trimmed to its length."""
    device = next(model.parameters()).device
    x = torch.tensor([list(ids)], dtype=torch.int64, device=device)
    x_lengths = torch.tensor([len(ids)], dtype=torch.int64, device=device)
    sids = None if sid is None else torch.tensor([sid], dtype=torch.int64, device=device)
    audio, _, _, _, y_lengths = model.infer(
        x, x_lengths, sid=sids, noise_scale=noise_scale, noise_scale_w=noise_scale_w,
        length_scale=length_scale, max_frames=max_frames, generator=generator)
    n = int(y_lengths[0]) * hop_length
    return audio[0, :n, 0].float().cpu().numpy()


def write_wav(path: str, audio: np.ndarray, sampling_rate: int):
    pcm = (np.clip(audio, -1, 1) * 32767).astype("<i2")
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sampling_rate)
        f.writeframes(pcm.tobytes())


def stream_latents(model: SynthesizerTrn, ids: Sequence[int], hop_length: int, chunk: int, *,
                   noise_scale: float, noise_scale_w: float, length_scale: float,
                   max_frames: int, generator: torch.Generator,
                   sid: Optional[int] = None) -> np.ndarray:
    """One utterance through `infer_latents` and the StreamingDecoder in
    chunks of `chunk` frames, each chunk's time printed -> float waveform,
    trimmed to its length."""
    import time

    from torch_tts_tpu_torch.infer.streaming import StreamingDecoder

    device = next(model.parameters()).device
    t0 = time.perf_counter()
    x = torch.tensor([list(ids)], dtype=torch.int64, device=device)
    x_lengths = torch.tensor([len(ids)], dtype=torch.int64, device=device)
    sids = None if sid is None else torch.tensor([sid], dtype=torch.int64, device=device)
    z, g, y_mask, y_lengths = model.infer_latents(
        x, x_lengths, sid=sids, noise_scale=noise_scale, noise_scale_w=noise_scale_w,
        length_scale=length_scale, max_frames=max_frames, generator=generator)
    n_frames = int(y_lengths[0])
    pieces = []
    for i, piece in enumerate(StreamingDecoder(model, chunk_frames=chunk).stream(
            z, g, y_mask, lengths=[n_frames])):
        pieces.append(piece[0, :, 0].float().cpu().numpy())
        print(f"chunk {i}: +{len(pieces[-1])} samples at t={time.perf_counter() - t0:.3f}s")
    return np.concatenate(pieces)[:n_frames * hop_length]


def main(argv: Optional[Sequence[str]] = None):
    fp32_cudnn()
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-c", "--config", required=True, help="YAML or JSON VITS2 config")
    p.add_argument("-m", "--model", required=True,
                   help="reference-format state dict (.pth) or a trainer run directory")
    p.add_argument("--text", default=None)
    p.add_argument("--text-file", default=None,
                   help="file with one text per line; batch-synthesizes them through the "
                        "bucketed serving API into <output stem>_000.wav, ...")
    p.add_argument("-o", "--output", default="out.wav")
    p.add_argument("--sid", type=int, default=None, help="speaker id (multi-speaker models)")
    p.add_argument("--noise-scale", type=float, default=0.667)
    p.add_argument("--noise-scale-w", type=float, default=0.8)
    p.add_argument("--length-scale", type=float, default=1.0)
    p.add_argument("--max-frames", type=int, default=1000)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--average-last", type=int, default=1, metavar="K",
                   help="load the uniform average of the last K checkpoints (run dirs only)")
    p.add_argument("--long", action="store_true",
                   help="long-form mode: --text may be arbitrarily long; it is split at "
                        "sentence/clause boundaries, the pieces are synthesized through the "
                        "serving API and joined (see --pause-ms)")
    p.add_argument("--pause-ms", type=float, default=0.0,
                   help="silence inserted between long-form pieces")
    p.add_argument("--stream-chunk", type=int, default=0, metavar="FRAMES",
                   help="stream the decoder in FRAMES-sized chunks (infer/streaming.py), "
                        "printing each chunk's time; the audio equals the whole decode's")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = load_vits2_config(args.config)
    device = torch.device(args.device)
    scales = dict(noise_scale=args.noise_scale, noise_scale_w=args.noise_scale_w,
                  length_scale=args.length_scale)
    sr = cfg.audio.sampling_rate
    if args.text_file or args.long:
        from torch_tts_tpu_torch.infer.serving import Synthesizer

        if not args.text_file and not args.text:
            p.error("--text or --text-file is required")
        synth = Synthesizer.from_run_dir(args.config, args.model,
                                         average_last=args.average_last, device=device)
        if args.text_file:
            with open(args.text_file) as f:
                texts = [line.strip() for line in f if line.strip()]
            results = synth.synthesize(
                texts, sid=[args.sid] * len(texts) if args.sid is not None else None,
                seed=args.seed, **scales)
            stem = args.output[:-4] if args.output.endswith(".wav") else args.output
            for i, r in enumerate(results):
                path = f"{stem}_{i:03d}.wav"
                write_wav(path, r.audio, r.sample_rate)
                print(f"wrote {path}: {len(r.audio) / r.sample_rate:.2f}s")
            return [r.audio for r in results]
        r = synth.synthesize_long(args.text, pause_ms=args.pause_ms, sid=args.sid,
                                  seed=args.seed, **scales)
        write_wav(args.output, r.audio, sr)
        print(f"wrote {args.output}: {len(r.audio) / sr:.2f}s")
        return r.audio
    if not args.text:
        p.error("--text or --text-file is required")

    model = load_model(cfg, args.model, device, args.average_last)
    run = synthesize if args.stream_chunk <= 0 else functools.partial(
        stream_latents, chunk=args.stream_chunk)
    audio = run(model, text_ids(args.text, cfg), cfg.audio.hop_length,
                max_frames=args.max_frames, sid=args.sid,
                generator=torch.Generator(device=device).manual_seed(args.seed), **scales)
    write_wav(args.output, audio, sr)
    print(f"wrote {args.output}: {len(audio) / sr:.2f}s")
    return audio


if __name__ == "__main__":
    main()
