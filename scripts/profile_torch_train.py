"""Profile one VITS2 `ddp` train step of the PyTorch port on one GPU,
kernel path vs plain path.

Full-width `VITS2Config()` (fuse_mrf=False, as the JAX train step), seeded
random G and MPD, the JAX train bench's batch (B=8, T_x=192, T_y=1000, 80
mel bins, wav x0.1), TF32 off. For each path: two warm-up steps, then one
step under torch.profiler; prints the host time of that step, the device
busy time (sum of device self time), the number of device kernels, the
time in the port's own kernels, and the top device kernels by self time.
The kernel path is `TTS_FUSED_WN=1` with the MAS kernel; the plain path
runs the layerwise WN (cuDNN) and MAS's plain version.

Usage (on the GPU machine, from the repository root):
    python scripts/profile_torch_train.py
"""

import os
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch
from torch.profiler import ProfilerActivity, profile

from torch_tts_tpu_torch.core.config import VITS2Config
from torch_tts_tpu_torch.kernels import mas
from torch_tts_tpu_torch.models.vits2 import build_synthesizer
from torch_tts_tpu_torch.models.vits2 import model as model_module
from torch_tts_tpu_torch.text import symbols
from torch_tts_tpu_torch.train.vits2_train import build_mpd, create_train_state, train_step

OWN_KERNELS = ("mas_kernel", "wn_group_kernel", "gemm_kernel", "prep_drs_kernel",
               "reduce_parts_kernel")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_train: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = VITS2Config()
    B, T_x, T_y = 8, 192, 1000
    g = torch.Generator().manual_seed(0)
    batch = {"x": torch.randint(1, len(symbols), (B, T_x), generator=g),
             "x_lengths": torch.full((B,), T_x),
             "spec": torch.randn(B, T_y, cfg.posterior_channels, generator=g),
             "spec_lengths": torch.full((B,), T_y),
             "wav": torch.randn(B, T_y * cfg.audio.hop_length, 1, generator=g) * 0.1}
    batch = {k: v.to(dev) for k, v in batch.items()}
    state = create_train_state(cfg, build_synthesizer(cfg, len(symbols), seed=0, device=dev),
                               build_mpd(cfg, seed=1, device=dev))

    def step():
        return train_step(cfg, state, batch, generator=torch.Generator(device=dev).manual_seed(0))

    cuda = torch.autograd.DeviceType.CUDA
    for path in ("kernel", "plain"):
        os.environ["TTS_FUSED_WN"] = "1" if path == "kernel" else "0"
        model_module.maximum_path = (mas.maximum_path if path == "kernel"
                                     else mas.maximum_path_via_plain)
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        ka = [e for e in prof.key_averages() if e.device_type == cuda]
        busy = sum(e.self_device_time_total for e in ka) / 1e3
        own = sum(e.self_device_time_total for e in ka
                  if any(k in e.key for k in OWN_KERNELS)) / 1e3
        n = sum(e.count for e in ka)
        print(f"=== train step {path}: host {wall:.1f} ms for the profiled step, device busy "
              f"{busy:.1f} ms, {n} device kernels, port's own kernels {own:.1f} ms")
        for e in sorted(ka, key=lambda e: -e.self_device_time_total)[:12]:
            print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")


if __name__ == "__main__":
    main()
