"""Least time an NVIDIA H100 SXM could take for each TPU kernel's work.

For every `pl.pallas_call` site of the JAX package, at the shapes its main
path (or, off any path, its bench or test) gives it: the operations and
bytes of the function (each input read once, each output written once) and
the larger of operations / peak and bytes / 3.35 TB/s (HBM3), from
NVIDIA's data sheet. The peak is 67 TFLOP/s (fp32 outside the tensor cores)
for most rows; for the rows built on matrix products (1-3: the MRF bank, the
WN group forward and backward; 8: the LLTM gate product) it is the rate that
keeps fp32 accuracy on the tensor cores, 3xTF32 at a third of the 495
TFLOP/s TF32 peak (165 TFLOP/s), and their fp32 SIMT bound is printed
beside it. Pure arithmetic on shapes: runs
anywhere, needs no card. chip_smoke.py computes the same bound for the
ported kernels from its own run's inputs.

Usage:
    python scripts/kernel_bounds.py
"""

import math

PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
PEAK_3XTF32_FLOPS = 495e12 / 3
F32 = 4


def bound(flops, nbytes, peak_flops=PEAK_FLOPS):
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def mrf(B=1, stages=((128, 65536), (64, 131072), (32, 262144)), kernels=(3, 7, 11)):
    """The C<=128 ResBlock1 banks of one 1024-frame decode: per block three
    iterations of two convs (k taps each)."""
    taps = sum(2 * 3 * k for k in kernels)
    flops = sum(2.0 * B * T * C * C * taps for C, T in stages)
    nbytes = sum(F32 * (2 * B * T * C + taps * C * C + 2 * 3 * len(kernels) * C)
                 for C, T in stages)
    return flops, nbytes


def wn(B, T, H=192, L=4, k=5, backward=False):
    flops = 2.0 * B * T * H * 2 * H * (k + 1) * L
    weights = L * (k + 1) * H * 2 * H + 2 * L * 2 * H
    if not backward:
        return flops, F32 * (3 * B * T * H + B * T + weights)
    # saved layer inputs and pre-activations, two cotangents and d_x, the
    # mask, the weights and their gradients
    return 2 * flops, F32 * (L * B * T * 3 * H + 3 * B * T * H + B * T + 2 * weights)


def mas(B=8, T_y=1000, T_x=192):
    cells = B * T_y * T_x
    return 4.0 * cells, F32 * (2 * cells + 2 * B)


def stft_mel(B, L, n_fft=1024, hop=256, n_mels=80):
    """The log-mel function at its least work, as chip_smoke.py counts it:
    per frame the window, a real FFT (split radix, 2 n log2 n - 4 n + 6
    operations, Sorensen et al. 1987), 3 operations a bin for the squared
    magnitude and the mel product over F = n_fft / 2 + 1 bins; the
    waveform, window and mel basis read once, the log-mel written once. (The
    kernel's own formulation, the DFT as two products, does about twenty
    times these operations: 2 frames F (2 n_fft + n_mels).)"""
    F = n_fft // 2 + 1
    frames = B * (1 + (L + 2 * ((n_fft - hop) // 2) - n_fft) // hop)
    fft = 2 * n_fft * math.log2(n_fft) - 4 * n_fft + 6
    nbytes = F32 * (B * L + n_fft + F * n_mels + frames * n_mels)
    return frames * (n_fft + fft + 3 * F + 2 * F * n_mels), nbytes


def taco_step(B=1, D_mel=80, P=256, Dc=512, H1=1024, H2=1024, r=1, L_mem=160):
    """One eval-mode Taco2Prod decoder step: every weight read once; the
    LJSpeech config's r = 1, chip_smoke.py's memory of 160 characters."""
    weights = (D_mel * P + P * P + (P + Dc) * 4 * H1 + H1 * 4 * H1 + H1 * Dc
               + (H1 + Dc) * 4 * H2 + H2 * 4 * H2 + (H2 + Dc) * (r * D_mel + r))
    flops = 2.0 * B * weights + 4.0 * B * L_mem * Dc
    return flops, F32 * (weights + B * L_mem * Dc)


def lltm(B=16, I=32, H=128):
    """The cell's gate product and update; new_h, new_c and the gates written."""
    flops = 2.0 * B * (I + H) * 3 * H
    return flops, F32 * (B * I + (I + H) * 3 * H + 3 * H + 2 * B * H + 5 * B * H)


# (row, (operations, bytes), product-bound: the 3xTF32 rate applies)
ROWS = (
    ("1 mrf_fused, B=1 decode (C=128/64/32)", mrf(), True),
    ("1 mrf_fused, B=1 decode, C=128 stage", mrf(stages=((128, 65536),)), True),
    ("1 mrf_fused, B=1 decode, C=64 stage", mrf(stages=((64, 131072),)), True),
    ("1 mrf_fused, B=1 decode, C=32 stage", mrf(stages=((32, 262144),)), True),
    ("2 wn_group, B=1 T=1024 (inference flows)", wn(1, 1024), True),
    ("2 wn_group, B=8 T=1024 (inference flows)", wn(8, 1024), True),
    ("2 wn_group, B=8 T=1000 (train step)", wn(8, 1000), True),
    ("3 wn_group backward, B=8 T=1000 (train step)", wn(8, 1000, backward=True), True),
    ("4 maximum_path, [8, 1000, 192] (train step)", mas(), False),
    ("5 mel_spectrogram_fused, 8 x 8192 samples", stft_mel(8, 8192), False),
    ("5 mel_spectrogram_fused, 8 x 10 s at 22.05 kHz", stft_mel(8, 220500), False),
    ("6 taco_step_fused, B=1, dim_rnn 320 (the largest that fits)", taco_step(H1=320, H2=320), False),
    ("7 taco_step_streamed, B=1, LJSpeech dim_rnn 1024", taco_step(), False),
    ("8 _lltm_fwd_pallas, B=16 I=32 H=128 (the extension tutorial's LLTM)", lltm(), True),
    ("8 _lltm_fwd_pallas, B=512 I=32 H=128", lltm(512, 32, 128), True),
    ("8 _lltm_fwd_pallas, B=64 I=256 H=1024", lltm(64, 256, 1024), True),
)


def main():
    print(f"{'kernel and shape':68s} {'GFLOP':>10s} {'MB':>10s} {'bound ms':>10s}  by"
          f"          {'fp32 SIMT bound ms':>18s}")
    for name, (flops, nbytes), product_bound in ROWS:
        t, by = bound(flops, nbytes, PEAK_3XTF32_FLOPS if product_bound else PEAK_FLOPS)
        simt = f"{bound(flops, nbytes)[0]:18.5f}" if product_bound else ""
        print(f"{name:68s} {flops / 1e9:10.4f} {nbytes / 1e6:10.3f} {t:10.5f}  {by:10s} {simt}")


if __name__ == "__main__":
    main()
