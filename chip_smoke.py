#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of VITS2 (inference and one training step)
on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):

1. The card: requires CUDA, prints `nvidia-smi`'s name and power limit.
2. Build: compiles torch_tts_tpu_torch/csrc/*.cu with nvcc, one process
   per source (timed).
3. Kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the shapes the main paths give it, with TF32 off: max
   abs/rel error against the stated tolerance and each version's median
   time over CUDA events after warm-up. MAS must equal its plain version
   exactly (random lengths, and tied inputs); the WN group backward is held
   against autograd through the plain group.
4. Inference: full-width LJSpeech SynthesizerTrn from the config defaults
   with seeded random weights, `fuse_mrf=True` and `TTS_FUSED_WN=1`. Launch
   counters are zeroed, then three English sentences go through the CLI's
   `main()` (state dict written to a temp .pth) and the bench shapes
   (B=1 and B=8, T_x=256, max_frames=1024) through `infer`; audio must be
   finite with 0 < y_lengths <= max_frames and silence past each length,
   and both kernels must have launched. The same inputs and noise then run
   through the plain path (no launches), and the audio must agree.
5. Training: full-width `VITS2Config()` (`fuse_mrf=False`, as the JAX
   step), seeded G and MPD, `TTS_FUSED_WN=1`, the JAX train bench's batch
   shape (B=8, T_x=192, T_y=1000, 80 mel bins, wav x0.1). Counters zeroed,
   three `ddp` steps: finite losses, moved parameters, and MAS, WN forward
   and WN backward launched; then a valid monotonic MAS path. From one
   fresh state, one step on the kernel path and one on the plain path
   (layerwise WN, MAS's plain version) with the same noise: the loss terms
   must agree; the largest gradient difference is printed. Then step times,
   plain and kernel in turns.
6. Prints the kernels' JSON line, then the device line last.
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
# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS, PEAK_BYTES_PER_S = 67e12, 3.35e12


def bound(flops: float, nbytes: float):
    """(least time in ms the card could take, "operations" or "bytes")."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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


def compare(name: str, out, ref) -> float:
    """Print and check max abs/rel error of out against ref."""
    import torch

    err = (out - ref).abs()
    max_abs = float(err.max())
    max_rel = float((err / (ref.abs() + KERNEL_ATOL)).max())
    ok = bool(torch.all(err <= KERNEL_ATOL + KERNEL_RTOL * ref.abs()))
    log(f"  {name}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
        f"tolerance |d| <= {KERNEL_ATOL:g} + {KERNEL_RTOL:g}*|ref| -> {'ok' if ok else 'FAIL'}")
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
    res["mrf_fused"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                            bound=bound(flops, nbytes))

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
        args = wn_args(B, T, torch.tensor([T - 37 * i for i in range(B)]))
        out, ref = wn_group(*args), wn_group_plain(*args)
        errs.append(max(compare(f"wn_group B={B} {n}", o, r)
                        for n, o, r in zip(("x_out", "skip"), out, ref)))
        t_k = cuda_ms(lambda: wn_group(*args))
        t_p = cuda_ms(lambda: wn_group_plain(*args))
        log(f"  wn_group B={B} T={T} H={H} L={L}: kernel {t_k:.3f} ms, plain {t_p:.3f} ms [{card}]")
        if B == 1:
            nbytes = 4.0 * (3 * B * T * H + B * T + L * (k + 2) * H * 2 * H)
            res["wn_group"] = dict(ms=t_k, plain_ms=t_p, bound=bound(wn_flops(B, T), nbytes))
    res["wn_group"]["max_abs_err"] = max(errs)

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
            res["wn_group_backward"] = dict(ms=t_k, plain_ms=t_p,
                                            bound=bound(2 * wn_flops(B, T), nbytes))
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
    t_k = cuda_ms(lambda: mas._maximum_path_cuda(masked, t_ys, t_xs))
    t_p = cuda_ms(lambda: mas.maximum_path_plain(masked, t_ys, t_xs), warmup=1, reps=3)
    log(f"  maximum_path B={B} T_y={T_y} T_x={T_x}: kernel {t_k:.3f} ms, plain {t_p:.3f} ms "
        f"[{card}]")
    cells = float((t_ys.long() * t_xs.long()).sum())  # the DP reads and updates these
    res["maximum_path"] = dict(max_abs_err=0.0, ms=t_k, plain_ms=t_p,
                               bound=bound(4 * cells, 4.0 * (cells + B * T_y * T_x + 2 * B)))
    return res


def slice_phase(device, card: str, tmp: str):
    import torch

    from torch_tts_tpu_torch.text import symbols
    from torch_tts_tpu_torch.cli import vits2_infer
    from torch_tts_tpu_torch.core.config import VITS2Config
    from torch_tts_tpu_torch.kernels.mrf_fused import mrf_fused
    from torch_tts_tpu_torch.kernels.wn_stack import wn_group
    from torch_tts_tpu_torch.models.vits2 import build_synthesizer

    base = VITS2Config()
    cfg = dataclasses.replace(
        base,
        model=dataclasses.replace(base.model, fuse_mrf=True),
        data=dataclasses.replace(base.data, text_cleaners=("transliteration_cleaners",)))
    os.environ["TTS_FUSED_WN"] = "1"
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
    log(f"  launch counts on the main path: {launches}")
    if not all(launches.values()):
        raise RuntimeError(f"a kernel of the main path did not launch: {launches}")

    # --- same inputs and noise through the plain path
    model.dec.fuse_mrf = False
    os.environ["TTS_FUSED_WN"] = "0"
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
            model.dec.fuse_mrf = path == "kernel"
            os.environ["TTS_FUSED_WN"] = "1" if path == "kernel" else "0"
            times.setdefault(path, []).append(wall_ms(lambda: run(B, seed=B)))
        for path, ts in times.items():
            ms = statistics.median(ts)
            log(f"  infer B={B} T_x={T_X} max_frames={MAX_FRAMES} {path}: {ms:.2f} ms/call, "
                f"{B * audio_s / (ms / 1e3):.1f}x real time [{card}]")
    model.dec.fuse_mrf = True
    os.environ["TTS_FUSED_WN"] = "1"
    return launches


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
        f"wav {tuple(batch['wav'].shape)}, TTS_FUSED_WN=1, fuse_mrf={cfg.model.fuse_mrf}")
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
        for line in f:
            if "registers" in line or "spill" in line:
                log("  ptxas: " + line.strip())

    stats = kernel_phase(device, card)
    with tempfile.TemporaryDirectory() as tmp:
        launches = slice_phase(device, card, tmp)
    launches.update(train_phase(device, card))  # wn_group: its count on the train path

    sources = {"mrf_fused": ("torch_tts_tpu_torch/csrc/mrf_fused.cu",
                             "torch_tts_tpu/kernels/mrf_fused.py:150"),
               "wn_group": ("torch_tts_tpu_torch/csrc/wn_stack.cu",
                            "torch_tts_tpu/kernels/wn_stack.py:156"),
               "wn_group_backward": ("torch_tts_tpu_torch/csrc/wn_stack.cu",
                                     "torch_tts_tpu/kernels/wn_stack.py:330"),
               "maximum_path": ("torch_tts_tpu_torch/csrc/mas.cu",
                                "torch_tts_tpu/kernels/mas_pallas.py:77")}
    # no single PyTorch call computes any of these functions: library_ms null
    kernels = [dict(name=n, route="cuda", source=src, replaces=rep, launches=launches[n],
                    max_abs_err=stats[n]["max_abs_err"], ms=stats[n]["ms"],
                    plain_ms=stats[n]["plain_ms"], bound_ms=stats[n]["bound"][0],
                    bound_by=stats[n]["bound"][1], library_ms=None)
               for n, (src, rep) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    sys.stdout.flush()


if __name__ == "__main__":
    main()
