#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (VITS2 inference and training step, Tacotron-2
inference, the bulk mel frontend, the LLTM cell) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):

1. The card: requires CUDA, prints `nvidia-smi`'s name and power limit.
2. Build: compiles torch_tts_tpu_torch/csrc/*.cu with nvcc, one process
   per source (timed); prints ptxas's registers and spills per kernel.
3. Kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the shapes the main paths give it, with TF32 off: max
   abs/rel error against the stated tolerance and each version's median
   time over CUDA events after warm-up. MAS must equal its plain version
   exactly (random lengths, and tied inputs); its times are device times
   (torch.profiler), and its chains' floor (T_y
   DP and backtrack rows timed by `mas.chain_probe`) is logged beside its
   bytes bound; the WN group forward with and without per-layer
   conditioning on ragged lengths, its plan, and its saving variant timed
   at the train shape; the WN group backward is held against autograd
   through the plain group, and two runs of it must give the same bits.
   The Taco2Prod step: the fused entry point with fp32
   matrices and the streamed one with fp32 and bf16 LSTM matrices (the
   plain step given the same bf16-rounded matrices in fp32), each at
   dim_rnn 320 and 1024 and B=1, 8 and 16 (two launches of 8 rows), PreNet
   masks on, and a 50-step rollout in which both take the plain path's
   previous frame. The STFT+mel
   kernel at the train step's y_hat shape (8 x 8192 samples) and the bulk
   shape (8 x 10 s at 22.05 kHz), n_fft 1024, hop 256, 80 mels, within
   MEL_ATOL of its plain version, beside the torch.stft mel
   (`audio/mel.py`, the library); its kernels-line times are device busy
   per call (torch.profiler, the three paths in turns), since the
   torch.stft mel's time between CUDA events is its host's. Then a dense
   U(0, 1) mel basis (every bin weighted), and the kernel against the
   torch.stft mel at 8 clips of MEL_AUTO_LENGTHS samples, the measurement
   behind `mel_spectrogram_auto`'s threshold. The LLTM cell forward within
   LLTM_ATOL of its plain version at the PyTorch extension tutorial's size
   (B=16, I=32, H=128) and at LLTM_LARGE (B=512, I=32, H=128 and B=64,
   I=256, H=1024), through bf16 inputs and a strided x (fp32 outputs), the
   same bits on a repeat run; its device time per launch read two ways,
   by torch.profiler and by CUDA events around replays of a CUDA graph of
   LLTM_GRAPH launches, beside an empty kernel launched the same way (the
   launch floor) and the gate product alone by `torch.addmm`. Bounds: the
   MRF bank, the WN group forward and backward and the LLTM gate product
   at 3xTF32's 165 TFLOP/s (the fp32 SIMT bound logged beside), the rest
   at fp32's 67 TFLOP/s or HBM3's 3.35 TB/s.
4. Inference: full-width LJSpeech SynthesizerTrn from the config defaults
   with seeded random weights and the port's kernel defaults (`fuse_mrf`
   on, `TTS_FUSED_WN` unset). Launch
   counters are zeroed, then three English sentences go through the CLI's
   `main()` (state dict written to a temp .pth) and the bench shapes
   (B=1 and B=8, T_x=256, max_frames=1024) through `infer`; audio must be
   finite with 0 < y_lengths <= max_frames and silence past each length,
   and both kernels must have launched. The same inputs and noise then run
   through the plain path (no launches), and the audio must agree. Call
   times at B=1 and B=8, plain and kernel in turns, and each path's device
   busy time per call.
5. Tacotron: full-width `TacotronConfig()` (LJSpeech) with seeded random
   weights. Counters zeroed, then the three sentences through the
   Tacotron CLI's `main()` (state dict in a temp .pth, --max-steps 400,
   Griffin-Lim 32 iterations) and one ragged B=8 batch through `infer`:
   finite mel and audio, 1 <= stop_lengths <= max_steps, attention rows
   summing to 1; then the batch twice as one B=16 decode; one
   `taco_step_streamed` launch per row group of at most 8 per step of every
   decode. The batch again through the plain path (the cell module, no
   launches): gated per step with the kernel path's frames as every
   step's input; free-running, the largest difference and whether the stop
   lengths agree are printed. Then decode times at B=1 and B=8, plain and
   kernel in turns, and a profiled decode on each path (device busy time).
6. Training: full-width `VITS2Config()` (the decoder's banks on their plain
   convolutions under autograd, as the JAX step), seeded G and MPD,
   `TTS_FUSED_WN=1`, the JAX train bench's batch
   shape (B=8, T_x=192, T_y=1000, 80 mel bins, wav x0.1). Counters zeroed,
   three `ddp` steps: finite losses, moved parameters, and MAS, WN forward
   and WN backward launched; then a valid monotonic MAS path. From one
   fresh state, one step on the kernel path and one on the plain path
   (layerwise WN, MAS's plain version) with the same noise: the loss terms
   must agree; the largest gradient difference is printed. Then step times,
   plain and kernel in turns.
7. Mel frontend: the JAX benchmark's "mel frontend throughput" config
   (8 clips x 10 s at 22.05 kHz, noise of std 0.3 from numpy seed 0)
   through `mel_spectrogram_auto` on the card. Counter zeroed; every call
   must launch the kernel once; log-mel [8, 861, 80], finite, within
   MEL_ATOL of the plain version and within the JAX kernel test's tolerance
   of the torch.stft mel; audio seconds per second of both paths, in turns.
8. LLTM: the extension tutorial's loop at B=16, I=32, H=128, x a strided
   view x_seq[:, t] of a [B, T, I] sequence, forward then
   (new_h.sum() + new_c.sum()).backward(), through `lltm` (the kernel and
   the analytic backward) and `lltm_ref` (autograd): outputs within
   LLTM_ATOL, the five gradients within GRAD_REL; one launch per kernel
   step; times of both, in turns.
9. Prints each phase's seconds, the kernels' JSON line, then the device
   line last.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

SENTENCES = (
    "The quick brown fox jumps over the lazy dog.",
    "Speech synthesis turns written text into natural sounding audio.",
    "Printing, in the only sense with which we are at present concerned, differs "
    "from most if not from all the arts and crafts represented in the exhibition.",
)
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-4  # fp32 vs fp32, different summation order
# WN backward: per gradient, max |kernel - plain| <= GRAD_REL * max |plain| +
# KERNEL_ATOL (sums over up to B*T = 8000 frames in another order)
GRAD_REL = 1e-4
AUDIO_ATOL = 1e-3  # kernel path vs plain path, audio in [-1, 1] after ~60 chained convs
# train step, kernel path vs plain path from one state and noise: each loss
# term within LOSS_RTOL * |plain| + LOSS_ATOL (fp32 through ~40 chained
# layers; a MAS tie broken the other way would move one frame)
LOSS_RTOL, LOSS_ATOL = 1e-3, 1e-3
MAX_FRAMES, T_X = 1024, 256
# the decoder's C=128/64/32 stages at B=1 and 1024 frames; the flows' WN
MRF_SHAPES = ((128, 65536), (64, 131072), (32, 262144))
WN_SHAPE = dict(H=192, L=4, k=5, T=MAX_FRAMES)
# the train step: the JAX package's train bench batch (scripts/bench_train.py)
TRAIN_B, TRAIN_TX, TRAIN_TY = 8, 192, 1000
TRAIN_STEPS = 3
# Tacotron: the LJSpeech decode length of the JAX CLI, memory length of the
# kernel phase (characters of a long LJSpeech sentence), the rollout, and
# the tolerance of the whole-decode comparison with the kernel path's frames
# as every step's input (fp32 state carried over 400 steps in two summation
# orders)
TACO_STEPS, TACO_L, TACO_ROLLOUT = 400, 160, 50
TACO_TF_ATOL = 1e-3
# the mel frontend: n_fft = win 1024, hop 256, 80 mels at 22.05 kHz; the
# train step's y_hat shape and the JAX benchmark's 8 clips of 10 s. Log-mel
# tolerances: kernel vs its plain version (the log turns a small mel value's
# relative error into an absolute one), and vs the torch.stft mel (the JAX
# package's test of its kernel against its rfft mel)
MEL_ARGS = (1024, 80, 22050, 256, 1024)
MEL_SHAPES = ((8, 8192), (8, 220500))
MEL_ATOL = 1e-3
MEL_STFT_RTOL, MEL_STFT_ATOL = 2e-3, 2e-4
# the LLTM cell at the PyTorch extension tutorial's size, and two large
# shapes (a batch of many row groups; a wide cell whose weights stream);
# outputs kernel vs plain; launches in the CUDA graph that times it
LLTM_B, LLTM_I, LLTM_H = 16, 32, 128
LLTM_LARGE = ((512, 32, 128), (64, 256, 1024))
LLTM_ATOL = 1e-5
LLTM_GRAPH = 100
# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3;
# and the rate that keeps fp32 accuracy on the tensor cores, 3xTF32 (three
# TF32 products a fp32 product) at a third of the 495 TFLOP/s TF32 peak,
# the bound of the kernels built on products (MRF bank, WN forward and
# backward, the LLTM gate product)
PEAK_FP32_FLOPS, PEAK_BYTES_PER_S = 67e12, 3.35e12
PEAK_3XTF32_FLOPS = 495e12 / 3
# mel_spectrogram_auto's threshold sweep: 8 clips of these many samples
MEL_AUTO_LENGTHS = (2048, 8192, 32768, 220500)


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_FP32_FLOPS):
    """(least time in ms the card could take, "operations" or "bytes")."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def product_bound(name: str, flops: float, nbytes: float, card: str):
    """The bound of a product-bound kernel at the 3xTF32 rate; the fp32 SIMT
    figure is logged beside it."""
    b = bound(flops, nbytes, PEAK_3XTF32_FLOPS)
    simt = bound(flops, nbytes)[0]
    log(f"  {name}: bound {b[0]:.4f} ms ({b[1]}, {flops / 1e9:.1f} GFLOP at 3xTF32's "
        f"{PEAK_3XTF32_FLOPS / 1e12:.0f} TFLOP/s); fp32 SIMT bound {simt:.4f} ms [{card}]")
    return b


def log(msg: str):
    print(msg, flush=True)


def cuda_ms(fn, warmup: int = 2, reps: int = 10) -> float:
    """Median device time of fn() in ms, CUDA events around each call."""
    import torch

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


def wall_ms(fn, warmup: int = 1, reps: int = 5) -> float:
    """Median host time of fn() + synchronize, in ms."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def compare(name: str, out, ref, atol: float = KERNEL_ATOL, rtol: float = KERNEL_RTOL) -> float:
    """Print and check max abs/rel error of out against ref."""
    import torch

    err = (out - ref).abs()
    max_abs = float(err.max())
    max_rel = float((err / (ref.abs() + KERNEL_ATOL)).max())
    ok = bool(torch.all(err <= atol + rtol * ref.abs()))
    log(f"  {name}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
        f"tolerance |d| <= {atol:g} + {rtol:g}*|ref| -> {'ok' if ok else 'FAIL'}")
    if not ok or not torch.isfinite(out).all():
        raise RuntimeError(f"{name}: kernel disagrees with its plain version")
    return max_abs


def grad_compare(name: str, out, ref) -> float:
    """Check one gradient against its plain version (GRAD_REL of its max)."""
    import torch

    err = float((out - ref).abs().max())
    tol = GRAD_REL * float(ref.abs().max()) + KERNEL_ATOL
    ok = err <= tol and bool(torch.isfinite(out).all())
    log(f"  {name}: max_abs_err={err:.3e} tolerance {tol:.3e} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{name}: kernel disagrees with its plain version")
    return err


def mas_inputs(g, device, B, T_y, T_x, ties):
    """Random lengths (item 0 full), neg_cent ~ 3 N(0, 1), rounded for ties."""
    import torch

    t_ys = torch.randint(T_y // 2, T_y + 1, (B,), generator=g)
    t_xs = torch.minimum(torch.randint(T_x // 2, T_x + 1, (B,), generator=g), t_ys)
    t_ys[0], t_xs[0] = T_y, T_x
    nc = torch.randn(B, T_y, T_x, generator=g) * 3
    if ties:
        nc = torch.round(nc)
    mask = ((torch.arange(T_y)[None, :, None] < t_ys[:, None, None])
            & (torch.arange(T_x)[None, None, :] < t_xs[:, None, None])).float()
    return nc.to(device), mask.to(device), t_ys.to(device), t_xs.to(device)


def kernel_phase(device, card: str):
    import torch

    from torch_tts_tpu_torch.kernels import mas, wn_stack
    from torch_tts_tpu_torch.kernels.mrf_fused import dilated_offsets, mrf_fused, mrf_plain
    from torch_tts_tpu_torch.kernels.wn_stack import wn_group, wn_group_plain

    g = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(device)

    res = {}
    log("kernel phase (TF32 off, median over CUDA events after warm-up; MRF and WN forward "
        "at the B=1 shapes of one 1024-frame call, MAS and WN backward at the train shapes):")
    errs, ms, plain_ms, flops, nbytes = [], 0.0, 0.0, 0.0, 0.0
    for C, T in MRF_SHAPES:
        blocks = tuple(
            tuple(tuple((dilated_offsets(k, dd), randn(k * C, C, scale=0.5 / (k * C) ** 0.5),
                         randn(C, scale=0.1)) for dd in (d, 1)) for d in (1, 3, 5))
            for k in (3, 7, 11))
        x = randn(1, T, C)
        errs.append(compare(f"mrf_fused C={C} T={T}", mrf_fused(x, blocks), mrf_plain(x, blocks)))
        t_k = cuda_ms(lambda: mrf_fused(x, blocks))
        t_p = cuda_ms(lambda: mrf_plain(x, blocks))
        log(f"  mrf_fused C={C} T={T}: kernel {t_k:.3f} ms, plain {t_p:.3f} ms [{card}]")
        ms, plain_ms = ms + t_k, plain_ms + t_p
        taps = sum(len(offs) for block in blocks for it in block for offs, _, _ in it)
        flops += 2.0 * T * C * C * taps
        nbytes += 4.0 * (2 * T * C + sum(w.numel() + b.numel() for block in blocks
                                          for it in block for _, w, b in it))
    log(f"  mrf_fused three stages: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms [{card}]")
    res["mrf_fused"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                            bound=product_bound("mrf_fused B=1 bank", flops, nbytes, card))

    errs = []
    H, L, k, T = WN_SHAPE["H"], WN_SHAPE["L"], WN_SHAPE["k"], WN_SHAPE["T"]

    def wn_args(B, T, lengths, with_gl=False):
        mask = (torch.arange(T)[None, :] < lengths[:, None]).float()[:, :, None].to(device)
        w_rs, b_rs = randn(L, H, 2 * H, scale=0.5 / H ** 0.5), randn(L, 2 * H, scale=0.1)
        w_rs[-1, :, :H], b_rs[-1, :H] = 0, 0
        return (randn(B, T, H), mask, randn(B, L, 2 * H) if with_gl else None,
                randn(L, k, H, 2 * H, scale=0.5 / (k * H) ** 0.5), randn(L, 2 * H, scale=0.1),
                w_rs, b_rs)

    def wn_flops(B, T):  # per layer: the k-tap conv and the 1x1, both H -> 2H
        return 2.0 * B * T * H * 2 * H * (k + 1) * L

    for B in (1, 8):
        lengths = torch.tensor([T - 37 * i for i in range(B)])
        args = wn_args(B, T, lengths)
        for name, a in (("", args), (" gl", wn_args(B, T, lengths, with_gl=True))):
            out, ref = wn_group(*a), wn_group_plain(*a)
            errs.append(max(compare(f"wn_group B={B}{name} {n}", o, r)
                            for n, o, r in zip(("x_out", "skip"), out, ref)))
        # the planner's choice, and each cluster size it could take, timed
        at_once = {c: wn_stack.clusters_at_once(c, k, device.index or 0)
                   for c in wn_stack.FORWARD_CLUSTERS}
        plan = wn_stack.plan_forward(B, T, k, L, H, one_wave=at_once[4])
        for c in wn_stack.FORWARD_CLUSTERS:
            p = dataclasses.replace(plan, cluster=c)
            t_c = cuda_ms(lambda: wn_stack._forward_cuda(*args, save=False, plan=p))
            log(f"  wn_group B={B} T={T}: {c}-CTA clusters{' (the plan)' * (c == plan.cluster)}: "
                f"{p.ctas} CTAs of {wn_stack.WINDOW} rows, {p.frames} frames owned (halo share "
                f"{p.halo_share:.2f}); the card holds {at_once[c]} such clusters at once; "
                f"kernel {t_c:.3f} ms [{card}]")
        t_k = cuda_ms(lambda: wn_group(*args))
        t_p = cuda_ms(lambda: wn_group_plain(*args))
        log(f"  wn_group B={B} T={T} H={H} L={L}: kernel {t_k:.3f} ms, plain {t_p:.3f} ms [{card}]")
        nbytes = 4.0 * (3 * B * T * H + B * T + L * (k + 2) * H * 2 * H)
        b = product_bound(f"wn_group B={B}", wn_flops(B, T), nbytes, card)
        if B == 1:
            res["wn_group"] = dict(ms=t_k, plain_ms=t_p, bound=b)
    res["wn_group"]["max_abs_err"] = max(errs)
    # the saving forward of the train step, beside the inference variant at its shape
    B, T = TRAIN_B, TRAIN_TY
    args = wn_args(B, T, torch.tensor([T] * B))
    t_s = cuda_ms(lambda: wn_stack._forward_cuda(*args, save=True))
    t_i = cuda_ms(lambda: wn_stack._forward_cuda(*args, save=False))
    log(f"  wn_group saving forward B={B} T={T} H={H} L={L}: kernel {t_s:.3f} ms, inference "
        f"variant {t_i:.3f} ms [{card}]")
    product_bound(f"wn_group saving forward B={B}", wn_flops(B, T),
                  4.0 * (3 * B * T * H + B * T + L * (k + 2) * H * 2 * H + L * B * T * 3 * H), card)

    # WN group backward: the flows' and enc_q's groups at the train batch,
    # then two ragged items with per-layer conditioning (all six gradients)
    errs = []
    names = ("d_x", "d_gl", "d_w_in", "d_b_in", "d_w_rs", "d_b_rs")
    for B, lengths, with_gl in ((TRAIN_B, [TRAIN_TY] * TRAIN_B, False),
                                (2, [TRAIN_TY, 613], True)):
        T = TRAIN_TY
        args = wn_args(B, T, torch.tensor(lengths), with_gl)
        d_xo, d_sk = randn(B, T, H), randn(B, T, H)
        saved = wn_stack._forward_cuda(*args, save=True)[2]
        got = wn_stack.wn_group_backward(*args, d_xo, d_sk, saved=saved)
        want = wn_stack.wn_group_backward_plain(*args, d_xo, d_sk)
        errs += [grad_compare(f"wn_group_backward B={B} {n}", a, b)
                 for n, a, b in zip(names, got, want) if b is not None]
        if B == TRAIN_B:
            again = wn_stack.wn_group_backward(*args, d_xo, d_sk, saved=saved)
            same = all(torch.equal(a, b) for a, b in zip(got, again) if a is not None)
            log(f"  wn_group_backward B={B}: two runs equal bit for bit -> {'ok' if same else 'FAIL'}")
            if not same:
                raise RuntimeError("wn_group_backward: two runs on the same inputs differ")
            t_k = cuda_ms(lambda: wn_stack.wn_group_backward(*args, d_xo, d_sk, saved=saved))
            with torch.enable_grad():
                ins = [a.detach().requires_grad_() for a in (args[0], *args[3:])]
                out = wn_group_plain(ins[0], args[1], None, *ins[1:])
                t_p = cuda_ms(lambda: torch.autograd.grad(out, ins, (d_xo, d_sk),
                                                          retain_graph=True))
            log(f"  wn_group_backward B={B} T={T} H={H} L={L}: kernel {t_k:.3f} ms, "
                f"plain (autograd of the plain group) {t_p:.3f} ms [{card}]")
            nbytes = 4.0 * (L * B * T * 3 * H + 3 * B * T * H + B * T
                            + 2 * L * (k + 1) * H * 2 * H + 2 * L * 2 * H)
            res["wn_group_backward"] = dict(ms=t_k, plain_ms=t_p, bound=product_bound(
                f"wn_group_backward B={B}", 2 * wn_flops(B, T), nbytes, card))
    res["wn_group_backward"]["max_abs_err"] = max(errs)

    # MAS at the train shape: exact equality, random lengths and ties
    B, T_y, T_x = TRAIN_B, TRAIN_TY, TRAIN_TX
    for ties in (False, True):
        nc, mask, t_ys, t_xs = mas_inputs(g, device, B, T_y, T_x, ties)
        masked = torch.where(mask > 0, nc, torch.full((), mas.MAX_NEG, device=device))
        path = mas.maximum_path(nc, mask)
        want = mas.maximum_path_plain(masked, t_ys, t_xs) * mask
        same = torch.equal(path, want)
        log(f"  maximum_path B={B} T_y={T_y} T_x={T_x} ties={ties}: kernel == plain "
            f"-> {'ok' if same else 'FAIL'}")
        if not same:
            raise RuntimeError("maximum_path: kernel path differs from the plain version")
    # device time (the call's host work exceeds the kernel's), and per call with the host
    t32 = (t_ys.int(), t_xs.int())
    t_k = profile_busy_ms(lambda: [mas._maximum_path_cuda(masked, *t32) for _ in range(20)]) / 20
    t_p = profile_busy_ms(lambda: mas.maximum_path_plain(masked, t_ys, t_xs))
    w_k = cuda_ms(lambda: mas._maximum_path_cuda(masked, *t32))
    w_p = cuda_ms(lambda: mas.maximum_path_plain(masked, t_ys, t_xs), warmup=1, reps=3)
    log(f"  maximum_path B={B} T_y={T_y} T_x={T_x}: device time kernel {t_k:.4f} ms, plain "
        f"{t_p:.3f} ms; per call with the host: kernel {w_k:.3f} ms, plain {w_p:.3f} ms [{card}]")
    cells = float((t_ys.long() * t_xs.long()).sum())  # the DP reads and updates these
    res["maximum_path"] = dict(max_abs_err=0.0, ms=t_k, plain_ms=t_p,
                               bound=bound(4 * cells, 4.0 * (cells + B * T_y * T_x + 2 * B)))
    # the chains' floor: T_y dependent DP rows, then T_y backtrack rows, one
    # item a CTA; per row from the chain probe's slope over rows already in
    # shared memory (its launch cancels out)
    rows = randn(32, T_x, scale=3.0)
    probe = [cuda_ms(lambda n=n: mas.chain_probe(rows, n)) for n in (4 * T_y, 8 * T_y)]
    per_row = (probe[1] - probe[0]) / (4 * T_y)
    log(f"  maximum_path B={B} T_y={T_y} T_x={T_x}: bound {res['maximum_path']['bound'][0]:.4f} ms "
        f"({res['maximum_path']['bound'][1]}); chain floor {T_y * per_row:.4f} ms ({T_y} DP and "
        f"backtrack rows at {per_row * 1e6:.1f} ns a row, chain_probe over {4 * T_y} and "
        f"{8 * T_y} rows: {probe[0]:.4f}, {probe[1]:.4f} ms) [{card}]")
    return res


def taco_inputs(g, device, B, L, H, ragged=True):
    """Seeded inputs and weights of one Taco2Prod step at the LJSpeech widths
    (D_mel 80, P 256, Dc 512, r 1) with dim_rnn (H, H), torch-default init
    scales; PreNet keep masks; the last item's memory half masked."""
    import torch

    from torch_tts_tpu_torch.kernels import taco_step as ts

    D_mel, P, Dc, r = 80, 256, 512, 1

    def u(*shape, fan):
        return ((torch.rand(shape, generator=g) * 2 - 1) * fan ** -0.5).to(device)

    def randn(*shape, scale):
        return (torch.randn(shape, generator=g) * scale).to(device)

    wts = ts.TacoStepWeights(
        prenet_w1=u(D_mel, P, fan=D_mel), prenet_b1=u(P, fan=D_mel), prenet_w2=u(P, P, fan=P),
        prenet_b2=u(P, fan=P), att_w_ih=u(P + Dc, 4 * H, fan=H), att_w_hh=u(H, 4 * H, fan=H),
        att_b=u(4 * H, fan=H), query_w=u(H, Dc, fan=H), dec_w_ih=u(H + Dc, 4 * H, fan=H),
        dec_w_hh=u(H, 4 * H, fan=H), dec_b=u(4 * H, fan=H), mel_w=u(H + Dc, r * D_mel, fan=H + Dc),
        mel_b=u(r * D_mel, fan=H + Dc), stop_w=u(H + Dc, r, fan=H + Dc), stop_b=u(r, fan=H + Dc))
    w = torch.softmax(torch.randn(B, L, generator=g) * 3, dim=1).to(device)
    state = ts.TacoStepState(w, randn(B, Dc, scale=0.3), *(randn(B, H, scale=0.3) for _ in range(4)))
    mmask = torch.ones(B, L, device=device)
    if ragged:
        mmask[-1, L // 2:] = 0
    masks = tuple((torch.rand(B, P, generator=g) < 0.5).to(device) for _ in range(2))
    return randn(B, D_mel, scale=0.5), state, randn(B, L, Dc, scale=0.5), mmask, wts, masks


def taco_step_bound(wts, B, L, big_bytes_per_weight=4):
    """(bound ms, "bytes"/"operations") of one step: every weight read once
    (the four LSTM matrices at the given width), memory, state, mask and
    outputs once; 2 B flops per weight, 4 B L Dc for the energies and the
    context."""
    big = sum(getattr(wts, f).numel() for f in ("att_w_ih", "att_w_hh", "dec_w_ih", "dec_w_hh"))
    small = sum(w.numel() for w in wts) - big
    Dc, H1, H2 = wts.query_w.shape[1], wts.att_w_hh.shape[0], wts.dec_w_hh.shape[0]
    P, D_mel, n_out = wts.prenet_w2.shape[0], wts.prenet_w1.shape[0], wts.mel_b.numel() + wts.stop_b.numel()
    io = 2 * (B * L + B * Dc + 2 * B * H1 + 2 * B * H2) + B * L + B * D_mel + 2 * B * P + B * n_out
    nbytes = big * big_bytes_per_weight + 4.0 * (small + B * L * Dc + io)
    return bound(2.0 * B * (big + small) + 4.0 * B * L * Dc, nbytes)


def batched_ms(fn, n: int = 50, batches: int = 3) -> float:
    """Device time per call in ms of fn() launched n times back to back
    between two CUDA events (median of `batches`); for a launch whose host
    cost is below its device time, so the queue never runs dry."""
    import torch

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


def step_errors(got, want):
    """(max abs error, within KERNEL_ATOL + KERNEL_RTOL |want|) over y, s and
    the new state of one step."""
    import torch

    err, ok = 0.0, True
    for a, b in zip(got[:2] + tuple(got[2]), want[:2] + tuple(want[2])):
        d = (a - b).abs()
        err = max(err, float(d.max()))
        ok = ok and bool(torch.all(d <= KERNEL_ATOL + KERNEL_RTOL * b.abs())) and bool(torch.isfinite(a).all())
    return err, ok


def taco_kernel_phase(device, card: str):
    """The Taco2Prod step's two entry points against the plain step."""
    import torch

    from torch_tts_tpu_torch.kernels import taco_step as ts

    g = torch.Generator().manual_seed(3)
    res = {}
    log(f"  taco_step: L={TACO_L}, D_mel 80, P 256, Dc 512, r 1, PreNet masks on")
    fused_launches = 0
    errs = {"taco_step_fused": [], "taco_step_streamed": []}
    # B=16: two launches of 8 rows
    cases = [("fused", H, B, torch.float32) for H in (320, 1024) for B in (1, 8, 16)]
    cases += [("streamed", H, B, dt) for H in (320, 1024) for dt in (torch.float32, torch.bfloat16)
              for B in (1, 8, 16)]
    for entry, H, B, dt in cases:
        y_in, state, memory, mmask, wts, masks = taco_inputs(g, device, B, TACO_L, H)
        if entry == "fused":
            kern = lambda: ts.taco_step_fused(y_in, state, memory, mmask, wts, prenet_masks=masks)  # noqa: E731
            plain = lambda: ts.taco_step_fused_via_plain(y_in, state, memory, mmask, wts,  # noqa: E731
                                                         prenet_masks=masks)
        else:
            # n_tile: the TPU kernel's DMA tile, which 4 H must divide (1280 and 4096)
            packed = ts.pack_streamed(wts, dt)
            kern = lambda: ts.taco_step_streamed(y_in, state, memory, mmask, packed, n_tile=128,  # noqa: E731
                                                 prenet_masks=masks)
            plain = lambda: ts.taco_step_streamed_via_plain(y_in, state, memory, mmask, packed,  # noqa: E731
                                                            n_tile=128, prenet_masks=masks)
        name = f"taco_step_{entry}"
        with torch.no_grad():
            before = ts.taco_step_fused.launches
            err, ok = step_errors(kern(), plain())
            fused_launches += ts.taco_step_fused.launches - before
            # the kernel's device time: launches prepared once, back to back;
            # the plain step's: its kernels' device time (it is host-bound)
            launch, _ = ts.prepare_cuda(y_in, state, memory, mmask, masks,
                                        *ts.launch_args(wts if entry == "fused" else packed), 0.1)
            t_k = batched_ms(launch)  # per step (all its row groups)
            t_p = profile_busy_ms(lambda: [plain() for _ in range(10)]) / 10
            call_k, call_p = cuda_ms(kern, warmup=3, reps=20), cuda_ms(plain, warmup=3, reps=20)
        b_ms, b_by = taco_step_bound(wts, B, TACO_L, 2 if dt == torch.bfloat16 else 4)
        tag = f"{name} B={B} dim_rnn {H} {str(dt).split('.')[-1]}"
        log(f"  {tag}: max_abs_err={err:.3e} tolerance |d| <= {KERNEL_ATOL:g} + {KERNEL_RTOL:g}*|ref| "
            f"-> {'ok' if ok else 'FAIL'}; device time: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}); per call with the host: kernel {call_k:.4f} ms, plain "
            f"{call_p:.4f} ms [{card}]")
        if not ok:
            raise RuntimeError(f"{tag}: kernel disagrees with its plain version")
        errs[name].append(err)
        # the kernels line: the fused entry at its TPU design size, the
        # streamed one at the CLI's shape (B=1, fp32)
        if (entry, H, B) == ("fused", 320, 1) or (entry, B, dt) == ("streamed", 1, torch.float32):
            res[name] = dict(ms=t_k, plain_ms=t_p, bound=(b_ms, b_by))

    # rollout: both sides take the plain path's previous frame
    B = 8
    y_in, state, memory, mmask, wts, _ = taco_inputs(g, device, B, TACO_L, 1024)
    packed = ts.pack_streamed(wts)
    sk = sp = state
    worst, ok = 0.0, True
    with torch.no_grad():
        for t in range(TACO_ROLLOUT):
            masks = tuple((torch.rand(B, 256, generator=g) < 0.5).to(device) for _ in range(2))
            got = ts.taco_step_streamed(y_in, sk, memory, mmask, packed, prenet_masks=masks)
            want = ts.taco_step_streamed_via_plain(y_in, sp, memory, mmask, packed, prenet_masks=masks)
            err, step_ok = step_errors(got, want)
            worst, ok = max(worst, err), ok and step_ok
            sk, sp, y_in = got[2], want[2], want[0]
    log(f"  taco_step_streamed {TACO_ROLLOUT}-step rollout B={B}, the plain frame as input: "
        f"max_abs_err={worst:.3e} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("taco_step_streamed: the rollout drifted from the plain steps")
    errs["taco_step_streamed"].append(worst)
    for name in res:
        res[name]["max_abs_err"] = max(errs[name])
    res["taco_step_fused"]["launches"] = fused_launches
    return res


def mel_bound(B: int, L: int, T: int, n_fft: int, n_mels: int):
    """(bound ms, by) of the log-mel function at its least work: per frame
    the window, a real FFT (split radix, 2 n log2 n - 4 n + 6 operations,
    Sorensen et al. 1987), 3 operations a bin for the squared magnitude and
    the mel product over F = n_fft / 2 + 1 bins; the waveform, window and
    mel basis read once, the log-mel written once."""
    F = n_fft // 2 + 1
    fft = 2 * n_fft * math.log2(n_fft) - 4 * n_fft + 6
    nbytes = 4.0 * (B * L + n_fft + F * n_mels + B * T * n_mels)
    return bound(B * T * (n_fft + fft + 3 * F + 2 * F * n_mels), nbytes)


def mel_dft_floor_ms(B: int, T: int, n_fft: int, n_mels: int) -> float:
    """fp32 peak time of the kernel's own formulation: the DFT as two
    products ([N, n_fft] @ [n_fft, F]) and the mel product."""
    F = n_fft // 2 + 1
    return bound(2.0 * B * T * F * (2 * n_fft + n_mels), 0.0)[0]


def busy_in_turns(paths, calls: int = 10):
    """Device busy ms per call of each path (torch.profiler over `calls`
    calls), measured in turns a b c c b a; the median of each path's two."""
    order = list(range(len(paths)))
    times = {i: [] for i in order}
    for i in order + order[::-1]:
        times[i].append(profile_busy_ms(lambda: [paths[i]() for _ in range(calls)]) / calls)
    return [statistics.median(times[i]) for i in order]


def mel_auto_sweep(device, card: str):
    """The kernel against the torch.stft mel at 8 clips of MEL_AUTO_LENGTHS
    samples: device busy per call (in turns) and per call with the host
    (CUDA events), for mel_spectrogram_auto's threshold."""
    import torch

    from torch_tts_tpu_torch.audio import mel as melmod
    from torch_tts_tpu_torch.kernels import stft

    g = torch.Generator().manual_seed(5)
    n_fft, _, _, hop, _ = MEL_ARGS
    for L in MEL_AUTO_LENGTHS:
        y = (torch.randn(8, L, generator=g) * 0.3).to(device)
        paths = (lambda: stft.mel_spectrogram_fused(y, *MEL_ARGS),
                 lambda: melmod.mel_spectrogram(y, *MEL_ARGS))
        busy = busy_in_turns(paths)
        call = [cuda_ms(fn, warmup=3, reps=20) for fn in paths]
        frames = 8 * (1 + L // hop)  # mel_spectrogram_auto's estimate
        log(f"  mel auto sweep 8x{L} ({frames} estimated frames): device busy kernel "
            f"{busy[0]:.4f} ms, torch.stft mel {busy[1]:.4f} ms; per call with the host kernel "
            f"{call[0]:.4f} ms, torch.stft mel {call[1]:.4f} ms [{card}]")


def lltm_inputs(g, device, B, I, H):
    """x, h, c ~ N(0, 1); weights and bias ~ U(-1/sqrt(H), 1/sqrt(H)), the
    tutorial's initialisation."""
    import torch

    stdv = H ** -0.5

    def u(*shape):
        return ((torch.rand(shape, generator=g) * 2 - 1) * stdv).to(device)

    return (torch.randn(B, I, generator=g).to(device), u(3 * H, H + I), u(3 * H),
            torch.randn(B, H, generator=g).to(device), torch.randn(B, H, generator=g).to(device))


def frontend_kernel_phase(device, card: str):
    """The STFT+mel kernel at the train step's and the bulk shape against
    its plain version."""
    import torch

    from torch_tts_tpu_torch.audio import mel as melmod
    from torch_tts_tpu_torch.kernels import stft

    g = torch.Generator().manual_seed(4)
    res, errs = {}, []
    n_fft, n_mels, _, hop, _ = MEL_ARGS
    for B, L in MEL_SHAPES:
        y = (torch.randn(B, L, generator=g) * 0.3).to(device)
        out = stft.mel_spectrogram_fused(y, *MEL_ARGS)
        ref = stft.mel_spectrogram_plain(y, *MEL_ARGS)
        err = (out - ref).abs().flatten()
        q = torch.quantile(err[:: max(1, err.numel() // 2 ** 20)], torch.tensor(
            [0.5, 0.99, 0.999], device=device)).tolist()
        log(f"  mel_spectrogram_fused {B}x{L}: |err| median {q[0]:.2e}, p99 {q[1]:.2e}, "
            f"p99.9 {q[2]:.2e}")
        errs.append(compare(f"mel_spectrogram_fused {B}x{L}", out, ref, atol=MEL_ATOL, rtol=0.0))
        paths = (lambda: stft.mel_spectrogram_fused(y, *MEL_ARGS),
                 lambda: stft.mel_spectrogram_plain(y, *MEL_ARGS),
                 lambda: melmod.mel_spectrogram(y, *MEL_ARGS))
        t_k, t_p, t_l = (cuda_ms(fn) for fn in paths)
        # device busy per call, the three paths in turns (the torch.stft mel is
        # a dozen launches, so its time between CUDA events can be the host's)
        busy = busy_in_turns(paths)
        T = out.shape[1]
        b_ms, b_by = mel_bound(B, L, T, n_fft, n_mels)
        log(f"  mel_spectrogram_fused {B}x{L} ({B * T} frames): CUDA events: kernel {t_k:.4f} "
            f"ms, plain {t_p:.4f} ms, torch.stft mel {t_l:.4f} ms; device busy per call: kernel "
            f"{busy[0]:.4f} ms, plain {busy[1]:.4f} ms, torch.stft mel {busy[2]:.4f} ms; bound "
            f"{b_ms:.5f} ms ({b_by}); the DFT as products at the fp32 peak "
            f"{mel_dft_floor_ms(B, T, n_fft, n_mels):.4f} ms [{card}]")
        # the kernels line: the bulk shape's (the last) device busy times
        res["mel_spectrogram_fused"] = dict(ms=busy[0], plain_ms=busy[1], library_ms=busy[2],
                                            bound=(b_ms, b_by))
    # a dense U(0, 1) basis: full bin ranges, bins 0 and n_fft / 2 weighted
    y = (torch.randn(*MEL_SHAPES[0], generator=g) * 0.3).to(device)
    window, twiddles, _, _ = stft._kernel_constants(n_fft, MEL_ARGS[2], n_mels, 0.0, None, device)
    basis = torch.rand(n_mels, n_fft // 2 + 1, generator=g)
    ranges = torch.from_numpy(stft._mel_ranges(basis.numpy())).to(device)
    basis = basis.to(device)
    errs.append(compare("mel_spectrogram_fused dense U(0, 1) basis",
                        stft._launch(y, n_fft, hop, window, twiddles, basis, ranges),
                        stft._log_mel_plain(y, n_fft, hop, basis.t()), atol=MEL_ATOL, rtol=0.0))
    mel_auto_sweep(device, card)
    res["mel_spectrogram_fused"]["max_abs_err"] = max(errs)
    return res


def graph_ms(fn, n: int = LLTM_GRAPH, replays: int = 5) -> float:
    """Device time per call of fn() in ms: CUDA events around replays of a
    CUDA graph that holds n calls (no host between launches); the median
    of `replays` replays. Used for measurement only."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    del graph
    return statistics.median(times)


def lltm_bound(B: int, I: int, H: int, card: str):
    """The cell's bound: the gate product at 3xTF32's rate; x, the weights,
    bias, h and c read once, new_h, new_c and the gates written once."""
    K = H + I
    return product_bound(f"lltm B={B} I={I} H={H}", 2.0 * B * K * 3 * H,
                         4.0 * (B * I + 3 * H * K + 3 * H + 2 * B * H + 2 * B * H + B * 3 * H), card)


def lltm_kernel_phase(device, card: str):
    """The LLTM forward kernel against its plain version: the tutorial's
    shape, LLTM_LARGE, bf16 and strided inputs, a repeat run's bits; device
    time by the profiler and over a CUDA graph, beside the launch floor
    and the gate product alone."""
    import torch

    from torch_tts_tpu_torch.kernels import gated_cell as gc

    g = torch.Generator().manual_seed(4)

    def check(what, args):
        got = gc._lltm_forward_cuda(*args)
        if any(t.dtype != torch.float32 for t in got):
            raise RuntimeError(f"lltm {what}: outputs are not fp32")
        errs = [compare(f"lltm {what} {n}", a, b, atol=LLTM_ATOL, rtol=0.0) for n, a, b in zip(
            ("new_h", "new_cell", "gates"), got, gc.lltm_forward_plain(*(t.float() for t in args)))]
        if not all(torch.equal(a, b) for a, b in zip(got, gc._lltm_forward_cuda(*args))):
            raise RuntimeError(f"lltm {what}: a repeat run gave other bits")
        return max(errs)

    def device_ms(fn):
        """(profiler busy ms, CUDA graph ms) per call."""
        return profile_busy_ms(lambda: [fn() for _ in range(20)]) / 20, graph_ms(fn)

    def measure(B, I, H):
        """Check and time the kernel at one shape -> (its inputs, stats)."""
        args = lltm_inputs(g, device, B, I, H)
        err = check(f"B={B} I={I} H={H}", args)
        k_prof, k_graph = device_ms(lambda: gc._lltm_forward_cuda(*args))
        p_prof = profile_busy_ms(lambda: [gc.lltm_ref(*args) for _ in range(20)]) / 20
        b_ms, b_by = lltm_bound(B, I, H, card)
        log(f"  lltm B={B} I={I} H={H}: device time per launch: kernel profiler {k_prof:.5f} "
            f"ms, CUDA graph of {LLTM_GRAPH} {k_graph:.5f} ms; plain profiler {p_prof:.5f} "
            f"ms; bound {b_ms:.5f} ms ({b_by}); same bits on a repeat run [{card}]")
        return args, dict(max_abs_err=err, ms=k_prof, plain_ms=p_prof, bound=(b_ms, b_by))

    B, I, H = LLTM_B, LLTM_I, LLTM_H
    with torch.no_grad():
        args, res = measure(B, I, H)
        for shape in LLTM_LARGE:
            measure(*shape)
        # what the TPU kernel takes: bf16 inputs, and x a strided view of a sequence
        seq = torch.randn(B, 3, I, generator=g).to(device)
        res["max_abs_err"] = max(res["max_abs_err"], check("bf16 inputs", [seq[:, 1].bfloat16()] + [
            a.bfloat16() for a in args[1:]]), check("strided x", [seq[:, 1]] + list(args[1:])))
        # yardsticks: an empty kernel launched the same way, and the gate product alone
        f_prof, f_graph = device_ms(lambda: gc.launch_floor(B, I, H, device))
        X = torch.cat([args[3], args[0]], dim=1)
        a_prof, a_graph = device_ms(lambda: torch.addmm(args[2], X, args[1].t()))
        call_k = cuda_ms(lambda: gc.lltm(*args), warmup=3, reps=20)
        call_p = cuda_ms(lambda: gc.lltm_ref(*args), warmup=3, reps=20)
    log(f"  lltm B={B} I={I} H={H} yardsticks per launch: empty kernel launched the same way "
        f"profiler {f_prof:.5f} ms, CUDA graph {f_graph:.5f} ms; the gate product alone "
        f"(torch.addmm) profiler {a_prof:.5f} ms, CUDA graph {a_graph:.5f} ms; per call with "
        f"the host: kernel {call_k:.4f} ms, plain {call_p:.4f} ms [{card}]")
    return {"lltm": res}


def mel_frontend_phase(device, card: str):
    """The JAX benchmark's mel frontend config through mel_spectrogram_auto."""
    import numpy as np
    import torch

    from torch_tts_tpu_torch.audio import mel as melmod
    from torch_tts_tpu_torch.kernels import stft

    clips, secs, sr = 8, 10, MEL_ARGS[2]
    rng = np.random.default_rng(0)
    y = torch.from_numpy((rng.standard_normal((clips, sr * secs)) * 0.3).astype(np.float32))
    y = y.to(device)
    calls = 0

    def kernel_path():
        nonlocal calls
        calls += 1
        return stft.mel_spectrogram_auto(y, *MEL_ARGS)

    stft.mel_spectrogram_fused.launches = 0
    out = kernel_path()
    torch.cuda.synchronize()
    if stft.mel_spectrogram_fused.launches != 1:
        raise RuntimeError("mel frontend: mel_spectrogram_auto did not launch the kernel")
    n_fft, n_mels, _, hop, _ = MEL_ARGS
    shape = (clips, 1 + (sr * secs + 2 * ((n_fft - hop) // 2) - n_fft) // hop, n_mels)
    if tuple(out.shape) != shape or not bool(torch.isfinite(out).all()):
        raise RuntimeError(f"mel frontend: log-mel {tuple(out.shape)}, want finite {shape}")
    err_plain = compare("mel frontend, kernel vs plain", out,
                        stft.mel_spectrogram_plain(y, *MEL_ARGS), atol=MEL_ATOL, rtol=0.0)
    compare("mel frontend, kernel vs torch.stft mel", out, melmod.mel_spectrogram(y, *MEL_ARGS),
            atol=MEL_STFT_ATOL, rtol=MEL_STFT_RTOL)
    times = {}
    for path in ("torch.stft", "kernel", "kernel", "torch.stft"):
        fn = kernel_path if path == "kernel" else lambda: melmod.mel_spectrogram(y, *MEL_ARGS)
        times.setdefault(path, []).append(wall_ms(fn))
    launches = stft.mel_spectrogram_fused.launches
    if launches != calls:
        raise RuntimeError(f"mel frontend: {launches} launches in {calls} calls")
    for path, ts in times.items():
        ms = statistics.median(ts)
        log(f"  mel frontend {clips} x {secs} s {path}: {ms:.3f} ms/call, "
            f"{clips * secs / (ms / 1e3):.1f} audio s/s [{card}]")
    log(f"  mel_spectrogram_fused launches {launches} in {calls} calls; max |kernel - plain| "
        f"{err_plain:.3e}")
    return {"mel_spectrogram_fused": launches}


def lltm_phase(device, card: str):
    """The extension tutorial's LLTM loop on both paths."""
    import torch

    from torch_tts_tpu_torch.kernels import gated_cell as gc

    B, I, H = LLTM_B, LLTM_I, LLTM_H
    g = torch.Generator().manual_seed(6)
    args = lltm_inputs(g, device, B, I, H)
    seq = torch.randn(B, 3, I, generator=g).to(device)
    kernel_steps = 0

    def step(path):
        """x = x_seq[:, 1], a strided view, as the tutorial's loop passes it."""
        nonlocal kernel_steps
        leaves = [seq.clone().requires_grad_()] + [a.detach().clone().requires_grad_()
                                                   for a in args[1:]]
        kernel_steps += path == "kernel"
        fn = gc.lltm if path == "kernel" else gc.lltm_ref
        new_h, new_c = fn(leaves[0][:, 1], *leaves[1:])
        (new_h.sum() + new_c.sum()).backward()
        return new_h, new_c, [a.grad for a in leaves]

    gc.lltm.launches = 0
    kh, kc, kgrads = step("kernel")
    torch.cuda.synchronize()
    if gc.lltm.launches != 1:
        raise RuntimeError("lltm: the kernel path did not launch the kernel")
    ph, pc, pgrads = step("plain")
    for name, a, b in (("new_h", kh, ph), ("new_cell", kc, pc)):
        err = float((a - b).detach().abs().max())
        log(f"  lltm {name}: max |kernel - plain| {err:.3e} (bound {LLTM_ATOL:g})")
        if not err <= LLTM_ATOL:
            raise RuntimeError(f"lltm: {name} disagrees with the plain path")
    for name, a, b in zip(("d_x_seq", "d_weights", "d_bias", "d_old_h", "d_old_cell"),
                          kgrads, pgrads):
        grad_compare(f"lltm {name}", a, b)
    times = {}
    for path in ("plain", "kernel", "kernel", "plain"):
        times.setdefault(path, []).append(wall_ms(lambda: step(path), warmup=3, reps=20))
    launches = gc.lltm.launches
    if launches != kernel_steps:
        raise RuntimeError(f"lltm: {launches} launches in {kernel_steps} kernel steps")
    for path, ts in times.items():
        log(f"  lltm B={B} I={I} H={H} forward + backward, {path}: "
            f"{statistics.median(ts):.4f} ms/step [{card}]")
    return {"lltm": launches}


def slice_phase(device, card: str, tmp: str):
    import torch

    from torch_tts_tpu_torch.text import symbols
    from torch_tts_tpu_torch.cli import vits2_infer
    from torch_tts_tpu_torch.core.config import VITS2Config
    from torch_tts_tpu_torch.kernels.mrf_fused import mrf_fused
    from torch_tts_tpu_torch.kernels.wn_stack import wn_group
    from torch_tts_tpu_torch.models.vits2 import build_synthesizer

    # the port's defaults: fuse_mrf on, TTS_FUSED_WN unset (fused on the card)
    base = VITS2Config()
    cfg = dataclasses.replace(
        base, data=dataclasses.replace(base.data, text_cleaners=("transliteration_cleaners",)))
    os.environ.pop("TTS_FUSED_WN", None)
    if not cfg.model.fuse_mrf:
        raise RuntimeError("the port's default config has fuse_mrf off")
    t0 = time.perf_counter()
    model = build_synthesizer(cfg, len(symbols), seed=0, device=device)
    # the flows' zero-initialised output convs would make the WN stacks'
    # outputs irrelevant to the audio; give them small seeded weights
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for flow in model.flow.flows[::2]:
            flow.post.weight.copy_(torch.randn(flow.post.weight.shape, generator=g) * 0.02)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"slice phase: SynthesizerTrn {n_params} params, seeded init "
        f"{time.perf_counter() - t0:.1f} s")

    ckpt, cfg_path = os.path.join(tmp, "G.pth"), os.path.join(tmp, "config.json")
    torch.save({"model": model.state_dict()}, ckpt)
    with open(cfg_path, "w") as f:
        json.dump({"model": dataclasses.asdict(cfg.model),
                   "data": {**dataclasses.asdict(cfg.data), **dataclasses.asdict(cfg.audio)}}, f)
    hop, sr = cfg.audio.hop_length, cfg.audio.sampling_rate

    def check(audio, y_lengths, what):
        if not torch.isfinite(audio).all():
            raise RuntimeError(f"{what}: non-finite audio")
        if not bool(((y_lengths > 0) & (y_lengths <= MAX_FRAMES)).all()):
            raise RuntimeError(f"{what}: y_lengths {y_lengths.tolist()} outside (0, {MAX_FRAMES}]")
        pos = torch.arange(audio.shape[1], device=audio.device)[None, :]
        tail = audio[:, :, 0] * (pos >= (y_lengths.to(torch.int64) * hop)[:, None])
        if bool(tail.abs().max() > 0):
            raise RuntimeError(f"{what}: audio past y_lengths*hop is not zero")

    def bench_inputs(B):
        g = torch.Generator().manual_seed(100 + B)
        x = torch.randint(1, len(symbols), (B, T_X), generator=g).to(device)
        lengths = torch.tensor([T_X * (8 - i) // 8 for i in range(B)]).to(device)
        return x, lengths

    def use_infer_path(path):
        """The kernel path is the defaults; the plain path is named."""
        model.dec.fuse_mrf = path == "kernel"
        if path == "kernel":
            os.environ.pop("TTS_FUSED_WN", None)
        else:
            os.environ["TTS_FUSED_WN"] = "0"

    def run(B, seed):
        x, lengths = bench_inputs(B)
        gen = torch.Generator(device=device).manual_seed(seed)
        return model.infer(x, lengths, noise_scale=0.667, noise_scale_w=0.8,
                           max_frames=MAX_FRAMES, generator=gen)

    # --- main path, kernels on
    mrf_fused.launches = 0
    wn_group.launches = 0
    for i, text in enumerate(SENTENCES):
        wav = os.path.join(tmp, f"request_{i}.wav")
        audio = vits2_infer.main(["-c", cfg_path, "-m", ckpt, "--text", text, "-o", wav,
                                  "--max-frames", str(MAX_FRAMES), "--seed", str(i),
                                  "--device", str(device)])
        if audio.size == 0 or not bool(torch.isfinite(torch.from_numpy(audio)).all()):
            raise RuntimeError(f"request {i}: empty or non-finite audio")
        if os.path.getsize(wav) != 44 + 2 * audio.size:
            raise RuntimeError(f"request {i}: WAV size does not match the audio")
    outs = {}
    for B in (1, 8):
        audio, attn, y_mask, aux, y_lengths = run(B, seed=B)
        check(audio, y_lengths, f"bench B={B}")
        outs[B] = (audio, y_lengths)
        log(f"  bench B={B}: audio {tuple(audio.shape)}, y_lengths {y_lengths.tolist()}")
    torch.cuda.synchronize()
    launches = {"mrf_fused": mrf_fused.launches, "wn_group": wn_group.launches}
    log(f"  launch counts on the main path (the port's defaults): {launches}")
    if not all(launches.values()):
        raise RuntimeError(f"a kernel of the main path did not launch: {launches}")

    # --- same inputs and noise through the plain path
    use_infer_path("plain")
    for B in (1, 8):
        audio, attn, y_mask, aux, y_lengths = run(B, seed=B)
        check(audio, y_lengths, f"plain B={B}")
        if not torch.equal(y_lengths, outs[B][1]):
            raise RuntimeError("plain path gave other durations")
        diff = float((audio - outs[B][0]).abs().max())
        log(f"  B={B}: max |audio_kernel - audio_plain| = {diff:.3e} (bound {AUDIO_ATOL:g})")
        if diff > AUDIO_ATOL:
            raise RuntimeError("kernel path and plain path audio disagree")
    if (mrf_fused.launches, wn_group.launches) != tuple(launches.values()):
        raise RuntimeError("the plain path launched a kernel")

    # --- end-to-end times, plain and kernel in turns
    audio_s = MAX_FRAMES * hop / sr
    for B in (1, 8):
        times = {}
        for path in ("plain", "kernel", "kernel", "plain"):
            use_infer_path(path)
            times.setdefault(path, []).append(wall_ms(lambda: run(B, seed=B)))
        for path, ts in times.items():
            ms = statistics.median(ts)
            use_infer_path(path)
            busy = profile_busy_ms(lambda: run(B, seed=B))
            log(f"  infer B={B} T_x={T_X} max_frames={MAX_FRAMES} {path}: {ms:.2f} ms/call, "
                f"{B * audio_s / (ms / 1e3):.1f}x real time; device busy {busy:.2f} ms/call [{card}]")
    use_infer_path("kernel")
    return launches


def profile_busy_ms(fn) -> float:
    """Device busy time of one fn() call in ms (torch.profiler, the sum of
    device self time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.self_device_time_total for e in prof.key_averages() if e.device_type == cuda) / 1e3


def tacotron_phase(device, card: str, tmp: str):
    import torch

    from torch_tts_tpu_torch.cli import tacotron_infer
    from torch_tts_tpu_torch.core.config import TacotronConfig
    from torch_tts_tpu_torch.kernels import taco_step as ts
    from torch_tts_tpu_torch.models.tacotron import build_tacotron

    cfg = TacotronConfig()
    t0 = time.perf_counter()
    model = build_tacotron(cfg, seed=0, device=device)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"tacotron phase: Tacotron-2 (Taco2Prod, dim_rnn {cfg.model.dim_rnn}) {n_params} params, "
        f"seeded init {time.perf_counter() - t0:.1f} s")
    ckpt, cfg_path = os.path.join(tmp, "tacotron.pth"), os.path.join(tmp, "tacotron.json")
    torch.save({"model": model.state_dict()}, ckpt)
    with open(cfg_path, "w") as f:
        json.dump({k: dataclasses.asdict(getattr(cfg, k)) for k in ("audio", "text", "model")}, f)
    S, B = TACO_STEPS, 8
    enc = tacotron_infer.text_encoder(cfg)
    texts = [SENTENCES[2][: 150 - 13 * i] for i in range(B)]
    ids = [enc.encode(t) for t in texts]
    x = torch.zeros(B, max(map(len, ids)), dtype=torch.int64)
    for i, row in enumerate(ids):
        x[i, : len(row)] = torch.tensor(row)
    x, lengths = x.to(device), torch.tensor([len(r) for r in ids], device=device)

    def run(path, b=B, seed=5, step_inputs=None):
        model.decoder.use_kernel = path == "kernel"
        gen = torch.Generator(device=device).manual_seed(seed)
        return model.infer(x[:b], lengths[:b], max_steps=S, generator=gen, step_inputs=step_inputs)

    def check(y_post, aux, what):
        if not bool(torch.isfinite(y_post).all()):
            raise RuntimeError(f"{what}: non-finite mel")
        stop = aux["stop_lengths"]
        if not bool(((stop >= 1) & (stop <= S)).all()):
            raise RuntimeError(f"{what}: stop_lengths {stop.tolist()} outside [1, {S}]")
        dev = float((aux["w"].sum(-1) - 1).abs().max())
        if dev > 1e-4:
            raise RuntimeError(f"{what}: attention rows sum to 1 +- {dev:.2e}")
        return dev

    # --- main path: the CLI and a batch, every step through the kernel
    ts.taco_step_streamed.launches = 0
    for i, text in enumerate(SENTENCES):
        wav_path = os.path.join(tmp, f"tacotron_{i}.wav")
        wav, mel = tacotron_infer.main([text, cfg_path, "-m", ckpt, "-o", wav_path, "--max-steps", str(S),
                                        "--griffin-lim-iters", "32", "--seed", str(i),
                                        "--device", str(device)])
        if wav.size == 0 or not bool(torch.isfinite(torch.from_numpy(wav)).all() & torch.isfinite(mel).all()):
            raise RuntimeError(f"tacotron request {i}: empty or non-finite audio or mel")
        if os.path.getsize(wav_path) != 44 + 2 * wav.size:
            raise RuntimeError(f"tacotron request {i}: WAV size does not match the audio")
    y_k, yp_k, s_k, aux_k = run("kernel")
    torch.cuda.synchronize()
    dev = check(yp_k, aux_k, "batch")
    # B=16 (the batch twice): each step is two launches of 8 rows
    model.decoder.use_kernel = True
    with torch.no_grad():
        y16, yp16, s16, aux16 = model.infer(x.repeat(2, 1), lengths.repeat(2), max_steps=S,
                                            generator=torch.Generator(device=device).manual_seed(6))
    torch.cuda.synchronize()
    check(yp16, aux16, "B=16 batch")
    launches = ts.taco_step_streamed.launches
    expected = S * (len(SENTENCES) + len(ts.row_groups(B)) + len(ts.row_groups(2 * B)))
    log(f"  B={B} batch, text lengths {lengths.tolist()}: stop_lengths {aux_k['stop_lengths'].tolist()}, "
        f"attention rows sum to 1 +- {dev:.2e}; B=16 batch: stop_lengths "
        f"{aux16['stop_lengths'].tolist()}; taco_step_streamed launches {launches} (expected "
        f"{S} x ({len(SENTENCES)} + {len(ts.row_groups(B))} + {len(ts.row_groups(2 * B))}), one per "
        "row group of at most 8 a step)")
    if launches != expected:
        raise RuntimeError("the decoder did not run every step through taco_step_streamed")

    # --- the plain path (the cell module), same inputs and masks
    r, D = cfg.model.r, cfg.audio.num_mels
    frames = torch.cat([torch.zeros(B, 1, D, device=device),
                        y_k.reshape(B, S, r, D)[:, :-1, -1]], 1)
    y_tf, yp_tf, s_tf, aux_tf = run("plain", step_inputs=frames)
    y_p, yp_p, s_p, aux_p = run("plain")
    torch.cuda.synchronize()
    check(yp_p, aux_p, "plain batch")
    if ts.taco_step_streamed.launches != launches:
        raise RuntimeError("the plain path launched the kernel")
    per_step = (y_tf - y_k).abs().reshape(B, S, -1).amax(dim=(0, 2))
    tf = max(float(per_step.max()), float((s_tf - s_k).abs().max()), float((aux_tf["w"] - aux_k["w"]).abs().max()))
    log(f"  plain path with the kernel path's frames as inputs: max |d| over y, s, w {tf:.3e} "
        f"(step 1 {float(per_step[0]):.3e}, step {S} {float(per_step[-1]):.3e}; bound {TACO_TF_ATOL:g})")
    if not tf <= TACO_TF_ATOL:
        raise RuntimeError("kernel path and plain path disagree step by step")
    same_stop = torch.equal(aux_p["stop_lengths"], aux_k["stop_lengths"])
    log(f"  free-running: max |mel_kernel - mel_plain| {float((yp_p - yp_k).abs().max()):.3e}, "
        f"stop lengths {'agree' if same_stop else 'differ'} (plain {aux_p['stop_lengths'].tolist()}; not gated)")

    # --- decode times, plain and kernel in turns; device busy per decode
    for b in (1, 8):
        times = {}
        for path in ("plain", "kernel", "kernel", "plain"):
            times.setdefault(path, []).append(wall_ms(lambda: run(path, b), warmup=1, reps=3))
        for path, tt in times.items():
            ms = statistics.median(tt)
            busy = profile_busy_ms(lambda: run(path, b))
            log(f"  tacotron decode B={b} {S} steps {path}: {ms:.1f} ms/call (turns "
                f"{', '.join(f'{t:.1f}' for t in tt)}), {ms / S * 1e3:.1f} us/step; device busy "
                f"{busy:.1f} ms/call, idle share {max(0.0, 1 - busy / ms):.2f} [{card}]")
    model.decoder.use_kernel = True
    del model
    torch.cuda.empty_cache()
    return {"taco_step_streamed": launches}


def check_mas_path(attn, x_lengths, y_lengths):
    """Each item's path is one-hot per frame inside its lengths, starts at
    token 0, ends at its last token and advances by 0 or 1 per frame."""
    import torch

    for b in range(attn.shape[0]):
        ty, tx = int(y_lengths[b]), int(x_lengths[b])
        p = attn[b, :ty, :tx]
        if not (bool((p.sum(1) == 1).all()) and float(attn[b].sum()) == ty):
            raise RuntimeError(f"MAS path of item {b} is not one-hot inside its lengths")
        idx = p.argmax(1)
        steps = idx[1:] - idx[:-1]
        if int(idx[0]) != 0 or int(idx[-1]) != tx - 1 or not bool(((steps == 0) | (steps == 1)).all()):
            raise RuntimeError(f"MAS path of item {b} is not monotonic from the first to the "
                               "last token")
    return True


def train_phase(device, card: str):
    import torch

    from torch_tts_tpu_torch.core.config import VITS2Config
    from torch_tts_tpu_torch.kernels import mas
    from torch_tts_tpu_torch.kernels.wn_stack import wn_group, wn_group_backward
    from torch_tts_tpu_torch.models.vits2 import build_synthesizer
    from torch_tts_tpu_torch.models.vits2 import model as model_module
    from torch_tts_tpu_torch.text import symbols
    from torch_tts_tpu_torch.train.vits2_train import build_mpd, create_train_state, train_step

    cfg = VITS2Config()
    hop = cfg.audio.hop_length
    B, T_x, T_y = TRAIN_B, TRAIN_TX, TRAIN_TY
    g = torch.Generator().manual_seed(0)
    batch = {"x": torch.randint(1, len(symbols), (B, T_x), generator=g),
             "x_lengths": torch.full((B,), T_x),
             "spec": torch.randn(B, T_y, cfg.posterior_channels, generator=g),
             "spec_lengths": torch.full((B,), T_y),
             "wav": torch.randn(B, T_y * hop, 1, generator=g) * 0.1}
    batch = {k: v.to(device) for k, v in batch.items()}

    def fresh_state():
        model = build_synthesizer(cfg, len(symbols), seed=0, device=device)
        # as in the inference phase: the flows' zero-initialised output convs
        # would give their WN stacks no gradient; small seeded weights instead
        gp = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for flow in model.flow.flows[::2]:
                flow.post.weight.copy_(torch.randn(flow.post.weight.shape, generator=gp) * 0.02)
        return create_train_state(cfg, model, build_mpd(cfg, seed=1, device=device))

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    def use_path(path):
        os.environ["TTS_FUSED_WN"] = "1" if path == "kernel" else "0"
        model_module.maximum_path = (mas.maximum_path if path == "kernel"
                                     else mas.maximum_path_via_plain)

    t0 = time.perf_counter()
    state = fresh_state()
    n_g = sum(p.numel() for p in state.opt_g.params)
    n_d = sum(p.numel() for p in state.opt_d.params)
    log(f"train phase: G {n_g} trained params, MPD {n_d} params, seeded init "
        f"{time.perf_counter() - t0:.1f} s; batch B={B} T_x={T_x} T_y={T_y} "
        f"wav {tuple(batch['wav'].shape)}, TTS_FUSED_WN=1 (plain path: 0); the decoder's banks on "
        f"their plain convolutions under autograd (fuse_mrf={cfg.model.fuse_mrf} applies when no "
        "gradient is needed)")
    before = [p.detach().clone() for p in state.opt_g.params + state.opt_d.params]

    # --- main path: three ddp steps through the kernels
    use_path("kernel")
    mas.maximum_path.launches = wn_group.launches = wn_group_backward.launches = 0
    history = []
    for i in range(TRAIN_STEPS):
        history.append(train_step(cfg, state, batch, generator=gen(i)))
    torch.cuda.synchronize()
    launches = {"maximum_path": mas.maximum_path.launches, "wn_group": wn_group.launches,
                "wn_group_backward": wn_group_backward.launches}
    log(f"  launch counts on the train path ({TRAIN_STEPS} steps): {launches}")
    for i, m in enumerate(history):
        log(f"  step {i}: " + ", ".join(f"{k}={v:.4f}" for k, v in m.items()))
        if m["nonfinite"] or not all(map(math.isfinite, m.values())):
            raise RuntimeError(f"step {i}: non-finite loss or gradient")
    if not all(launches.values()):
        raise RuntimeError(f"a kernel of the train path did not launch: {launches}")
    moved = [float((p.detach() - q).abs().max()) for p, q in
             zip(state.opt_g.params + state.opt_d.params, before)]
    log(f"  parameters moved: {sum(m > 0 for m in moved)} of {len(moved)} tensors, "
        f"largest change {max(moved):.3e}")
    if sum(m > 0 for m in moved) < 0.9 * len(moved):
        raise RuntimeError("the steps left most parameters where they were")
    with torch.no_grad():
        out = state.model(batch["x"], batch["x_lengths"], batch["spec"], batch["spec_lengths"],
                          mas_noise_scale=0.01, generator=gen(99))
    check_mas_path(out[2], batch["x_lengths"], batch["spec_lengths"])
    log("  MAS path: one frame per row, monotonic from the first to the last token -> ok")
    del state, out, before

    # --- one step from one fresh state on each path, the same noise; the
    # plain path twice, to show what its own run-to-run spread is
    results = {}
    for path in ("kernel", "plain", "plain again"):
        use_path(path.split()[0])
        st = fresh_state()
        names = [n for n, p in st.model.named_parameters()
                 if any(p is q for q in st.opt_g.params)]
        grads = {}
        step_fn = st.opt_g.step

        def record(gr, apply=True, _step=step_fn):
            grads["g"] = [x.clone() for x in gr]
            return _step(gr, apply)

        st.opt_g.step = record
        counts = (mas.maximum_path.launches, wn_group.launches, wn_group_backward.launches)
        results[path] = (train_step(cfg, st, batch, generator=gen(100)), grads["g"])
        torch.cuda.synchronize()
        moved_counts = counts != (mas.maximum_path.launches, wn_group.launches,
                                  wn_group_backward.launches)
        if moved_counts != (path == "kernel"):
            raise RuntimeError(f"the {path} path launched the kernels {'not ' * (path == 'kernel')}"
                               "as expected")
        del st
    (mk, gk), (mp, gp), (_, gp2) = (results[p] for p in ("kernel", "plain", "plain again"))
    for key in mk:
        d = abs(mk[key] - mp[key])
        log(f"  {key}: kernel {mk[key]:.6f} plain {mp[key]:.6f} |d|={d:.3e}")
        if key.startswith("loss") and d > LOSS_RTOL * abs(mp[key]) + LOSS_ATOL:
            raise RuntimeError(f"{key}: kernel path and plain path disagree")
    # per tensor |g - g_plain|; the relative figure only for tensors above
    # 1e-6 of the global norm (some, as the attention key biases, have an
    # analytic gradient of zero and differ by rounding alone)
    total = math.sqrt(sum(float(b.square().sum()) for b in gp))
    for what, other in (("kernel", gk), ("plain again", gp2)):
        diffs = sorted(((float((a - b).norm()), float(b.norm()), n)
                        for n, a, b in zip(names, other, gp)), reverse=True)
        rel = sorted(((d / nb, nb, n) for d, nb, n in diffs if nb > 1e-6 * total), reverse=True)
        log(f"  generator gradients, {what} vs plain: largest |g - g_plain| per tensor "
            + "; ".join(f"{n} {d:.3e} (|g_plain| {nb:.3e})" for d, nb, n in diffs[:3])
            + f"; global norm {total:.3e}; largest relative "
            + "; ".join(f"{n} {r:.3e} (|g_plain| {nb:.3e})" for r, nb, n in rel[:3]))
    del results, gk, gp, gp2

    # --- step time, plain and kernel in turns
    state = fresh_state()
    times = {}
    for path in ("plain", "kernel", "kernel", "plain"):
        use_path(path)
        times.setdefault(path, []).append(
            wall_ms(lambda: train_step(cfg, state, batch, generator=gen(7)), warmup=1, reps=2))
    for path, ts in times.items():
        log(f"  train step B={B} T_y={T_y} {path}: {statistics.median(ts):.1f} ms/step "
            f"(turns {', '.join(f'{t:.1f}' for t in ts)}) [{card}]")
    use_path("kernel")
    del state
    torch.cuda.empty_cache()
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0].strip()
    log(card)
    device = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        "TF32 off (cudnn.allow_tf32 = cuda.matmul.allow_tf32 = False)")

    from torch_tts_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.load_library()
    log(f"build: {time.perf_counter() - t0:.1f} s ({build.library_dir()})")
    with open(build.library_dir() / "nvcc.log") as f:
        entry = ""
        for line in f:
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line.strip()
            elif "registers" in line or "spill" in line:
                log(f"  ptxas {entry}: {line.strip()}")

    seconds = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        return out

    stats = timed("kernels", kernel_phase, device, card)
    stats.update(timed("taco kernels", taco_kernel_phase, device, card))
    stats.update(timed("frontend kernels", frontend_kernel_phase, device, card))
    stats.update(timed("lltm kernels", lltm_kernel_phase, device, card))
    with tempfile.TemporaryDirectory() as tmp:
        launches = timed("inference", slice_phase, device, card, tmp)
        launches.update(timed("tacotron", tacotron_phase, device, card, tmp))
    # wn_group: its count on the train path
    launches.update(timed("training", train_phase, device, card))
    launches.update(timed("mel frontend", mel_frontend_phase, device, card))
    launches.update(timed("lltm", lltm_phase, device, card))
    # the fused step is on no model path: its count is the kernel phase's
    launches["taco_step_fused"] = stats["taco_step_fused"]["launches"]

    sources = {"mrf_fused": ("torch_tts_tpu_torch/csrc/mrf_fused.cu",
                             "torch_tts_tpu/kernels/mrf_fused.py:150"),
               "wn_group": ("torch_tts_tpu_torch/csrc/wn_stack.cu",
                            "torch_tts_tpu/kernels/wn_stack.py:156"),
               "wn_group_backward": ("torch_tts_tpu_torch/csrc/wn_stack.cu",
                                     "torch_tts_tpu/kernels/wn_stack.py:330"),
               "maximum_path": ("torch_tts_tpu_torch/csrc/mas.cu",
                                "torch_tts_tpu/kernels/mas_pallas.py:77"),
               "taco_step_fused": ("torch_tts_tpu_torch/csrc/taco_step.cu",
                                   "torch_tts_tpu/kernels/taco_step.py:171"),
               "taco_step_streamed": ("torch_tts_tpu_torch/csrc/taco_step.cu",
                                      "torch_tts_tpu/kernels/taco_step.py:301"),
               "mel_spectrogram_fused": ("torch_tts_tpu_torch/csrc/stft_mel.cu",
                                         "torch_tts_tpu/kernels/stft.py:47"),
               "lltm": ("torch_tts_tpu_torch/csrc/gated_cell.cu",
                        "torch_tts_tpu/kernels/gated_cell.py:81")}
    # library_ms: the torch.stft mel's device busy time for the STFT+mel
    # kernel (whose ms and plain_ms are device busy times too); no single
    # PyTorch call computes any of the other functions
    kernels = [dict(name=n, route="cuda", source=src, replaces=rep, launches=launches[n],
                    max_abs_err=stats[n]["max_abs_err"], ms=stats[n]["ms"],
                    plain_ms=stats[n]["plain_ms"], bound_ms=stats[n]["bound"][0],
                    bound_by=stats[n]["bound"][1], library_ms=stats[n].get("library_ms"))
               for n, (src, rep) in sources.items()]
    log("phase seconds: " + ", ".join(f"{n} {t:.1f}" for n, t in seconds.items())
        + f"; total {time.perf_counter() - t0:.1f} s with the build")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    sys.stdout.flush()


if __name__ == "__main__":
    main()
