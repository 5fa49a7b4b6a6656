"""Time the MRF bank and the STFT+log-mel kernels of torch_tts_tpu_torch on
one NVIDIA GPU, through their public entry points only, so the same script
times an older checkout of the package too (run it from that checkout's
root with this file's path).

- MRF bank (`mrf_fused` against `mrf_plain`, cuDNN with TF32 off): per
  stage of one B=1, 1024-frame LJSpeech decode (C=128/64/32 over 65,536 /
  131,072 / 262,144 frames, kernel sizes 3/7/11, dilations 1/3/5), median
  over CUDA events after warm-up.
- STFT+log-mel (`mel_spectrogram_fused` against the torch.stft mel of
  `audio/mel.py`) at 8 x 8192 and 8 x 220,500 samples (n_fft 1024, hop
  256, 80 mels): device busy per call from torch.profiler (the reflect pad
  included), over 20 calls.

Prints one line per measurement with the card's name and power limit, then
a JSON line of the numbers.

Usage:
    python scripts/profile_torch_kernels.py
"""

import json
import os
import statistics
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.getcwd())

from torch_tts_tpu_torch.audio import mel as melmod  # noqa: E402
from torch_tts_tpu_torch.kernels import stft  # noqa: E402
from torch_tts_tpu_torch.kernels.mrf_fused import dilated_offsets, mrf_fused, mrf_plain  # noqa: E402

MRF_SHAPES = ((128, 65536), (64, 131072), (32, 262144))
MEL_ARGS = (1024, 80, 22050, 256, 1024)
MEL_SHAPES = ((8, 8192), (8, 220500))


def cuda_ms(fn, warmup=2, reps=10):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def busy_ms(fn, calls=20):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == cuda) / 1e3 / calls


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_kernels: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0].strip()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    res = {"card": card}

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    for C, T in MRF_SHAPES:
        blocks = tuple(
            tuple(tuple((dilated_offsets(k, dd), randn(k * C, C, scale=0.5 / (k * C) ** 0.5),
                         randn(C, scale=0.1)) for dd in (d, 1)) for d in (1, 3, 5))
            for k in (3, 7, 11))
        x = randn(1, T, C)
        err = float((mrf_fused(x, blocks) - mrf_plain(x, blocks)).abs().max())
        t_k, t_p = cuda_ms(lambda: mrf_fused(x, blocks)), cuda_ms(lambda: mrf_plain(x, blocks))
        print(f"mrf_fused C={C} T={T}: kernel {t_k:.3f} ms, plain {t_p:.3f} ms, "
              f"max |kernel - plain| {err:.2e} [{card}]", flush=True)
        res[f"mrf_C{C}"] = dict(kernel_ms=t_k, plain_ms=t_p, max_abs_err=err)

    for B, L in MEL_SHAPES:
        y = randn(B, L, scale=0.3)
        err = float((stft.mel_spectrogram_fused(y, *MEL_ARGS)
                     - stft.mel_spectrogram_plain(y, *MEL_ARGS)).abs().max())
        t_k = busy_ms(lambda: stft.mel_spectrogram_fused(y, *MEL_ARGS))
        t_l = busy_ms(lambda: melmod.mel_spectrogram(y, *MEL_ARGS))
        print(f"mel_spectrogram_fused {B}x{L}: device busy kernel {t_k:.4f} ms, torch.stft mel "
              f"{t_l:.4f} ms, max |kernel - plain| {err:.2e} [{card}]", flush=True)
        res[f"mel_{B}x{L}"] = dict(kernel_busy_ms=t_k, library_busy_ms=t_l, max_abs_err=err)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
