"""Profile the PyTorch port's VITS2 `infer` on one GPU, kernel path vs plain.

Full LJSpeech width, seeded random weights, T_x=256, max_frames=1024, at
B=1 and B=8, TF32 off. For each path: three warm-up calls, then one call
under torch.profiler; prints the host time of that call, the device busy
time (sum of device self time), the number of device kernels, and the top
device kernels by self time. The kernel path is `fuse_mrf=True` with
`TTS_FUSED_WN=1`; the plain path turns both off.

Usage (on the GPU machine, from the repository root):
    python scripts/profile_torch_infer.py
"""

import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch
from torch.profiler import ProfilerActivity, profile

from torch_tts_tpu_torch.text import symbols
from torch_tts_tpu_torch.core.config import VITS2Config
from torch_tts_tpu_torch.models.vits2 import build_synthesizer


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_infer: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    base = VITS2Config()
    cfg = dataclasses.replace(base, model=dataclasses.replace(base.model, fuse_mrf=True))
    dev = torch.device("cuda")
    model = build_synthesizer(cfg, len(symbols), seed=0, device=dev)

    def run(B):
        g = torch.Generator().manual_seed(100 + B)
        x = torch.randint(1, len(symbols), (B, 256), generator=g).to(dev)
        lengths = torch.tensor([256 * (8 - i) // 8 for i in range(B)]).to(dev)
        return model.infer(x, lengths, noise_scale=0.667, noise_scale_w=0.8, max_frames=1024,
                           generator=torch.Generator(device=dev).manual_seed(B))

    cuda = torch.autograd.DeviceType.CUDA
    for B in (1, 8):
        for path in ("kernel", "plain"):
            model.dec.fuse_mrf = path == "kernel"
            os.environ["TTS_FUSED_WN"] = "1" if path == "kernel" else "0"
            for _ in range(3):
                run(B)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                run(B)
                torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            ka = prof.key_averages()
            busy = sum(e.self_device_time_total for e in ka if e.device_type == cuda) / 1e3
            n = sum(e.count for e in ka if e.device_type == cuda)
            print(f"=== B={B} {path}: host {wall:.1f} ms for the profiled call, device busy "
                  f"{busy:.1f} ms, {n} device kernels")
            top = sorted((e for e in ka if e.device_type == cuda),
                         key=lambda e: -e.self_device_time_total)[:8]
            for e in top:
                print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")


if __name__ == "__main__":
    main()
