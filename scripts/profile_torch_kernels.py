"""Time the MRF bank, STFT+log-mel, Taco2Prod step, WN group forward and
backward (fp32 and bf16), and MAS kernels of torch_tts_tpu_torch on one NVIDIA GPU, through
their public entry points only, so the same script times an older checkout
of the package too (run it from that checkout's root with this file's
path).

- MRF bank (`mrf_fused` against `mrf_plain`, cuDNN with TF32 off): per
  stage of one B=1, 1024-frame LJSpeech decode (C=128/64/32 over 65,536 /
  131,072 / 262,144 frames, kernel sizes 3/7/11, dilations 1/3/5), median
  over CUDA events after warm-up.
- STFT+log-mel (`mel_spectrogram_fused` against the torch.stft mel of
  `audio/mel.py`) at 8 x 8192 and 8 x 220,500 samples (n_fft 1024, hop
  256, 80 mels): device busy per call from torch.profiler (the reflect pad
  included), over 20 calls.
- Taco2Prod step (`taco_step.prepare_cuda` of the streamed entry's
  `pack_streamed` matrices, fp32 and bf16, and of the fused entry's
  weights): device time per step of 50 prepared launches back to back
  (median of 3), L=160, D_mel 80, P 256, Dc 512, r 1, PreNet masks on, at
  dim_rnn 1024 and 320, B=1 and B=8.
- WN group forward (`wn_group`, H=192, L=4, k=5): the inference variant
  at B=1 and B=8, T=1024 (the flows of a 1024-frame call), and the saving
  variant (inputs that require a gradient) at the train shape B=8,
  T=1000; median over CUDA events around the call (its allocations and
  every kernel it launches included).
- WN group backward (`wn_group_backward` from the saving forward's
  saves) at the train shape: B=8, T=1000, H=192, L=4, k=5, median over
  CUDA events.
- The bf16 WN kernels (bf16 training) at the same shape, with per-layer gl
  and ragged lengths: the saving forward and the backward, a call (median
  over CUDA events around it) and 20 calls back to back (median of 3),
  the fp32 kernels on the same values beside them; and the device time of
  each kernel that one bf16 backward and saving forward launch
  (torch.profiler over 20 calls).
- MAS (`maximum_path`) at the train shape [8, 1000, 192], random lengths:
  median over CUDA events around the call (the wrapper's masking
  included), and the device time of the kernel alone (torch.profiler,
  kernels named `mas_kernel`).

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
from torch_tts_tpu_torch.kernels import mas, stft, taco_step, wn_stack  # noqa: E402
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


def batched_ms(fn, n=50, batches=3):
    """Device time per call of fn() launched n times back to back."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def taco_launch(g, dev, B, H, entry, dtype):
    """A prepared step of seeded inputs at the LJSpeech widths (dim_rnn H)."""
    D_mel, P, Dc, r, L = 80, 256, 512, 1, 160

    def u(*shape, fan):
        return ((torch.rand(shape, generator=g) * 2 - 1) * fan ** -0.5).to(dev)

    wts = taco_step.TacoStepWeights(
        prenet_w1=u(D_mel, P, fan=D_mel), prenet_b1=u(P, fan=D_mel), prenet_w2=u(P, P, fan=P),
        prenet_b2=u(P, fan=P), att_w_ih=u(P + Dc, 4 * H, fan=H), att_w_hh=u(H, 4 * H, fan=H),
        att_b=u(4 * H, fan=H), query_w=u(H, Dc, fan=H), dec_w_ih=u(H + Dc, 4 * H, fan=H),
        dec_w_hh=u(H, 4 * H, fan=H), dec_b=u(4 * H, fan=H), mel_w=u(H + Dc, r * D_mel, fan=H + Dc),
        mel_b=u(r * D_mel, fan=H + Dc), stop_w=u(H + Dc, r, fan=H + Dc), stop_b=u(r, fan=H + Dc))
    w = torch.softmax(torch.randn(B, L, generator=g) * 3, dim=1).to(dev)
    state = taco_step.TacoStepState(w, *((torch.randn(B, n, generator=g) * 0.3).to(dev)
                                         for n in (Dc, H, H, H, H)))
    masks = tuple((torch.rand(B, P, generator=g) < 0.5).to(dev) for _ in range(2))
    y_in = (torch.randn(B, D_mel, generator=g) * 0.5).to(dev)
    memory = (torch.randn(B, L, Dc, generator=g) * 0.5).to(dev)
    weights = wts if entry == "fused" else taco_step.pack_streamed(wts, dtype)
    launch, _ = taco_step.prepare_cuda(y_in, state, memory, torch.ones(B, L, device=dev), masks,
                                       *taco_step.launch_args(weights), 0.1)
    return launch


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


def kernel_busy_ms(fn, name, calls=20):
    """Device time per call of the kernels whose name contains `name`."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == cuda and name in e.key) / 1e3 / calls


def kernel_split(fn, calls=20):
    """(kernel name, launches a call, device ms a call) of every kernel
    fn() launches, the largest first."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.key, e.count / calls, e.self_device_time_total / 1e3 / calls)
            for e in prof.key_averages() if e.device_type == cuda]
    return sorted(rows, key=lambda r: -r[2])


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

    with torch.no_grad():
        for entry, H, B, dtype in [("streamed", 1024, B, dt) for dt in (torch.float32, torch.bfloat16)
                                   for B in (1, 8)] + [("fused", 320, B, torch.float32) for B in (1, 8)]:
            t = batched_ms(taco_launch(g, dev, B, H, entry, dtype))
            name = f"taco_step_{entry} dim_rnn {H} B={B} {str(dtype).split('.')[-1]}"
            print(f"{name}: device time {t:.4f} ms a step [{card}]", flush=True)
            res[name] = t

    H, L, k = 192, 4, 5

    def wn_args(B, T):
        w_rs, b_rs = randn(L, H, 2 * H, scale=0.5 / H ** 0.5), randn(L, 2 * H, scale=0.1)
        w_rs[-1, :, :H], b_rs[-1, :H] = 0, 0
        return (randn(B, T, H), torch.ones(B, T, 1, device=dev), None,
                randn(L, k, H, 2 * H, scale=0.5 / (k * H) ** 0.5), randn(L, 2 * H, scale=0.1),
                w_rs, b_rs)

    with torch.no_grad():
        for B, T in ((1, 1024), (8, 1024)):
            args = wn_args(B, T)
            err = max(float((o - r).abs().max())
                      for o, r in zip(wn_stack.wn_group(*args), wn_stack.wn_group_plain(*args)))
            t = cuda_ms(lambda: wn_stack.wn_group(*args))
            print(f"wn_group B={B} T={T} H={H} L={L}: kernel {t:.4f} ms, max |kernel - plain| "
                  f"{err:.2e} [{card}]", flush=True)
            res[f"wn_group_B{B}_T{T}"] = t
    B, T = 8, 1000
    args = wn_args(B, T)
    train_args = [a.requires_grad_() if a is not None and i != 1 else a for i, a in enumerate(args)]
    with torch.enable_grad():
        t = cuda_ms(lambda: wn_stack.wn_group(*train_args))
    print(f"wn_group saving forward B={B} T={T} H={H} L={L}: kernel {t:.4f} ms [{card}]", flush=True)
    res["wn_group_save_B8_T1000"] = t
    d_xo, d_sk = randn(B, T, H), randn(B, T, H)
    saved = wn_stack._forward_cuda(*args, save=True)[2]
    t = cuda_ms(lambda: wn_stack.wn_group_backward(*args, d_xo, d_sk, saved=saved))
    print(f"wn_group_backward B={B} T={T} H={H} L={L}: kernel {t:.3f} ms [{card}]", flush=True)
    res["wn_group_backward"] = t

    lengths = torch.tensor([T - 37 * i for i in range(B)])
    mask32 = (torch.arange(T)[None, :] < lengths[:, None]).float()[:, :, None].to(dev)
    a32 = (args[0], mask32, randn(B, L, 2 * H), *args[3:])
    a16 = tuple(t.bfloat16().contiguous() for t in a32)
    a32 = tuple(t.float() for t in a16)  # the same values in both
    d16 = (d_xo.bfloat16(), d_sk.bfloat16())
    d32 = tuple(t.float() for t in d16)
    sv16, sv32 = (wn_stack._forward_cuda(*a, save=True)[2] for a in (a16, a32))
    calls = {"bf16 saving forward": lambda: wn_stack._forward_cuda(*a16, save=True),
             "fp32 saving forward": lambda: wn_stack._forward_cuda(*a32, save=True),
             "bf16 backward": lambda: wn_stack.wn_group_backward(*a16, *d16, saved=sv16),
             "fp32 backward": lambda: wn_stack.wn_group_backward(*a32, *d32, saved=sv32)}
    for name, fn in calls.items():
        t, t_b2b = cuda_ms(fn), batched_ms(fn, n=20)
        print(f"wn_group {name} B={B} T={T} gl: a call {t:.4f} ms, back to back {t_b2b:.4f} ms "
              f"[{card}]", flush=True)
        res[f"wn_group {name}"] = dict(call_ms=t, back_to_back_ms=t_b2b)
    for name in ("bf16 backward", "bf16 saving forward"):
        rows = kernel_split(calls[name])
        print(f"wn_group {name}: {sum(r[1] for r in rows):g} kernels, "
              f"{sum(r[2] for r in rows):.4f} ms of device time a call [{card}]", flush=True)
        for key, n, ms in rows:
            print(f"  {key[:90]}: {n:g} a call, {ms:.4f} ms", flush=True)
        res[f"wn_group {name} by kernel"] = rows

    B, T_y, T_x = 8, 1000, 192
    t_ys = torch.randint(T_y // 2, T_y + 1, (B,), generator=g)
    t_xs = torch.minimum(torch.randint(T_x // 2, T_x + 1, (B,), generator=g), t_ys)
    t_ys[0], t_xs[0] = T_y, T_x
    nc = randn(B, T_y, T_x, scale=3.0)
    mask = ((torch.arange(T_y)[None, :, None] < t_ys[:, None, None])
            & (torch.arange(T_x)[None, None, :] < t_xs[:, None, None])).float().to(dev)
    t = cuda_ms(lambda: mas.maximum_path(nc, mask))
    t_kernel = kernel_busy_ms(lambda: mas.maximum_path(nc, mask), "mas_kernel")
    print(f"maximum_path B={B} T_y={T_y} T_x={T_x}: call {t:.4f} ms, kernel (device) "
          f"{t_kernel:.4f} ms [{card}]", flush=True)
    res["maximum_path_call"], res["maximum_path_kernel"] = t, t_kernel
    print(json.dumps(res))


if __name__ == "__main__":
    main()
