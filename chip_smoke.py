#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (VITS2 inference, training step and trainer,
multi-speaker VITS2, serving, the MB-iSTFT decoder and the other flow
types, Tacotron-2 inference, serving with the HiFi-GAN vocoder and its
trainer, and training, the VAE style path and the other Tacotron
variants, the bulk mel frontend, the LLTM cell, the int8 decoder, bf16
VITS2 training, export) on one NVIDIA GPU.

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
   At the trainer's shapes (B=8, the buckets' 300 and 400 frames, text
   padded to TRAINER_TX = 381 ids): MAS equal to its plain version, with
   and without ties, and the WN group's saving forward and its backward
   through autograd against the plain group.
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
   must agree; the largest gradient difference is printed. The same for
   one `ddp` step with the duration discriminator V1 (every loss term,
   `loss/dur_disc` included). Then step times, plain and kernel in turns.
7. Trainer: a synthetic LJSpeech-layout corpus (TRAINER_CLIPS seeded clips
   of TRAINER_SECONDS, 16-bit PCM at 22,050 Hz, the text from SENTENCES;
   the (32, 300] and (300, 400] frame buckets) and the shipped LJSpeech
   config at full width as JSON (no PyYAML on the card), logging every
   step and evaluating and checkpointing once an epoch, through the train
   CLI's `main` with an in-process recorder for its writers (no
   tensorboardX on the card). Run 1, the shipped recipe (`ddp`): one
   epoch, then a second invocation resumes for a second epoch; the saved
   checkpoint must hold the state, and the restored step, parameters and
   optimizer moments must equal it bit for bit. Run 2: `lightning`,
   `dur_disc_2`, grad_accum 2, one epoch: every optimizer's parameters
   move, its update count is half the micro-steps, and no D or duration
   discriminator tensor moves more than that many Adam updates can; then
   a second epoch of run 2 with two steps traced by torch.profiler
   (`profile_steps`): kernels, device busy and idle share a step, and the
   host's time waiting on the card in synchronising calls. Every logged
   loss finite, no step skipped; MAS, the WN forward and
   backward and the MRF bank (evaluate()'s inference) must launch. Prints
   steps/s, step ms by bucket, batch loading ms, evaluate()'s seconds,
   the checkpoint's bytes and its host copy and write seconds, launches a
   step.
8. Multi-speaker: configs/vits2-multispeaker.yaml at full width
   (`multispeaker_config`: 109 speakers, gin_channels 256, the
   speaker-conditioned text encoder), seeded. `infer` at the bench shapes
   with distinct speaker ids (B=1 and B=8): every `wn_group` launch takes
   a per-layer gl (counted around `wn_stack._forward_cuda`), `mrf_fused`
   launches, the audio within AUDIO_ATOL of the plain path's with equal
   durations, and another speaker's audio differs by more than ten times
   that; `voice_conversion` at B=MS_VC_B, T_y=MS_VC_TY (full lengths, so an
   unmasked decode) against the plain path; three `ddp` steps at the train
   phase's batch with eight speaker ids (MAS, the WN forward with gl and
   the backward with its d_gl launched), the first of them against one
   step on the plain path from the same fresh state and noise: the loss
   terms within LOSS_RTOL / LOSS_ATOL, emb_g's gradient only on the
   batch's rows and within GRAD_REL of the plain path's; the trainer through the CLI on a synthetic corpus of
   MS_TRAINER_SPEAKERS speakers as an `audio|sid|text` filelist, one epoch
   and a resume checked bit for bit (emb_g included). Then fault 1's card
   check: a NARROW VITS2 (hidden 128, upsample_initial_channel 256) runs
   `infer` and one train step on the card's defaults (no WN launch, MRF on
   the stages it takes, MAS on its kernel) and matches the plain path.
   Host and device-busy times of each, the paths in turns.
9. Mel frontend: the JAX benchmark's "mel frontend throughput" config
   (8 clips x 10 s at 22.05 kHz, noise of std 0.3 from numpy seed 0)
   through `mel_spectrogram_auto` on the card. Counter zeroed; every call
   must launch the kernel once; log-mel [8, 861, 80], finite, within
   MEL_ATOL of the plain version and within the JAX kernel test's tolerance
   of the torch.stft mel; audio seconds per second of both paths, in turns.
10. LLTM: the extension tutorial's loop at B=16, I=32, H=128, x a strided
   view x_seq[:, t] of a [B, T, I] sequence, forward then
   (new_h.sum() + new_c.sum()).backward(), through `lltm` (the kernel and
   the analytic backward) and `lltm_ref` (autograd): outputs within
   LLTM_ATOL, the five gradients within GRAD_REL; one launch per kernel
   step; times of both, in turns.
11. MB-iSTFT (after the serving phase): configs/vits2-ljspeech-mbistft.yaml
   at full width (`mbistft_config`, held equal to the YAML by a CPU test),
   seeded. `infer` at the bench shapes, kernel path against plain path in
   turns: equal durations, audio within AUDIO_ATOL of the plain path's
   peak (no tanh), one mrf_fused launch (the trunk's C=128 bank) and one
   wn_group launch a flow per call; host and device-busy times beside the
   HiFi-GAN model's of phase 4. The MRF kernel with the trunk's C=128 bank
   at MB_MRF_SHAPE ([8, 16384, 128]) against its plain version, timed
   beside its bound; the iSTFT + PQMF head on the card against the CPU on
   inputs whose DC and Nyquist bins have imaginary parts. The inference
   CLI once; a Synthesizer's `synthesize` of four texts and one stream()
   in the (256, 1344) bucket, chunk 64, context 32, against `synthesize`
   on each path (all but the last MB_EDGE samples). Three `ddp` steps at
   the train phase's batch (MAS, WN forward and backward launched), the
   first against the plain path. Then each other transformer flow type
   and a ResBlock2 decoder at full width: `infer` B=1 against the plain
   path, the launches each must make (no MRF launch on ResBlock2 banks,
   no WN launch in `fft` flows).
12. Tacotron serving (after MB-iSTFT): full-width `TacotronConfig()`,
   seeded as phase 5, and the vocoder `cli/vocoder_train.py` builds for
   hop 256 (upsample (8, 8, 4), initial channel 256: banks of 128, 64 and
   32 channels). First the step kernel with the model's packed weights at
   the serving shapes and the MRF bank at the stream's window and the
   grid's largest cell against their plain versions. Then, counts zeroed:
   the vocoder trainer's CLI for TACO_VOCODER_STEPS GAN steps on a
   synthetic corpus (the trainer phase's writer), its artifact behind a
   `TacotronSynthesizer` (DEFAULT_TACO_BUCKETS, tiers 1, 2, 4): every
   (tier, bucket) cell of the two smallest buckets on the kernel and the
   plain path (equal stop lengths, audio within TACO_AUDIO_ATOL; host ms,
   device busy, the vocoder's busy); one `stream()` in the (128, 400)
   bucket at chunk 32, pad 48 (its chunked mel equal to the tier-1 batch
   decode's, its audio against postnet + vocoder over that mel trimmed at
   the stop and against the batch audio; time to first chunk); one
   Griffin-Lim dispatch; `tacotron_infer --vocoder`; the web UI with
   TACO_WEB_REQUESTS /tts_taco and one /tts_taco_stream at once. The
   launches must equal what the dispatches imply: one
   `taco_step_streamed` per decoder step and row group, one `mrf_fused`
   per MRF stage of each vocoder call.
13. Tacotron training (after Tacotron serving): the full-width
   `TacotronConfig()` (configs/tacotron-ljspeech.yaml) as JSON, a
   synthetic corpus of TACO_TRAIN_CLIPS clips (write_corpus), their mels
   by the port's `TacotronDataset` (no HDF5 cache: the card has no h5py)
   on the card's `AudioFrontend`, collated by `collate_tacotron`: text
   padded as the train CLI pads it, frames to TACO_TRAIN_FRAMES, batches of
   TACO_TRAIN_B, the first TACO_TRAIN_EVAL clips held out. Counts zeroed,
   `TacotronTrainer.train` for an epoch with evaluate(), a new trainer on
   the run directory (its state equal to the checkpoint bit for bit) for a
   second epoch, then `TacotronSynthesizer.from_run_dir` (the trainer's
   weights exactly) decodes one text: `taco_step_streamed` launches equal
   to what evaluate()'s and the decode's steps imply (the training
   forward runs the cell modules: the kernel draws no zoneout, noise or
   coin and has no backward). Then `eval_step` on the kernel against the
   plain path (`decoder.use_kernel = False`) with the same PreNet masks:
   w, y, y_post and the loss within TACO_EVAL_ATOL, exactly steps x
   ceil(B / 8) launches a teacher-forced forward; eval times; a train
   step at the batch's shape from a fresh model (host ms, then a profiled
   step's device busy time and operations, idle share); and
   TACO_LOSS_STEPS steps on the batch's first TACO_LOSS_FRAMES frames
   from another: a finite and falling loss.
14. int8 decoder (after MB-iSTFT): configs/vits2-ljspeech.yaml with
   `quantize_decoder: true` (`int8_config`; pack_narrow_convs as shipped,
   so conv_pre, up_0, up_1 and the C=256 and C=128 banks, 39 convs, are
   int8 and the C=64 and C=32 stages fp on the MRF kernel) and the
   MB-iSTFT config likewise (all 39 trunk convs int8), seeded. First the
   edge shapes of INT8_EDGES (C_in 80, 81 and 192, phases 8, 4, 3 and
   160, T_out off the tile with B > 1, the residual, slope and mask
   variants, each of the three tiles), the quantizer at values on and next
   to its rounding halves, and a CUDA graph of the quantizer and a
   residual conv replayed twice on new inputs: the kernels equal their
   plain versions bit for bit. At every conv of a B=1 and a B=8 `infer` of
   both decoders (recorded around `ops.quant.int8_conv1d_quantized`, with
   their pre-activation and residual) the quantizer kernel must equal its
   plain version (x_q and s_x) and the conv kernel its plain version bit
   for bit (so within INT8_CONV_RTOL of the peak); at the B=1 HiFi-GAN
   shapes each is timed beside its bound, its plain version, fp32 cuDNN
   `F.conv1d` and `torch._int_mm` on x_q unfolded (the kernels line gives
   one call at each kernel's dominant shape, and the infer's sums as
   `*_per_infer`). Then, counts zeroed, `infer` at B=1 and B=8 (MB-iSTFT
   B=1): int8 launches equal to the decoder calls times the int8 convs,
   `mrf_fused` one a fp stage of each unmasked decode; against the plain
   int8 path (`int8_plain_path`) within AUDIO_ATOL; against the fp32 model
   on the same weights: SNR, host and device-busy ms, in turns, and one
   quantizer kernel a conv kernel in the profiler.
15. bf16 training (after the trainer): the bf16 variants of the WN
   forward (with its saves) and backward at the train shape (B=8, T=1000)
   against their plain versions in bf16 within BF16_KERNEL_RTOL of the
   output's peak, and against the fp32 plain versions on the same bf16
   values within BF16_FP32_RTOL, the backward's bits twice, each timed
   beside its bound at bf16's 989 TFLOP/s. Then, counts zeroed, three
   `ddp` steps of the default config with `use_bf16`: exactly 4 bf16 WN
   groups (the posterior encoder), 4 fp32 ones (the flows, whose x the
   fp32 attention promotes, as in JAX) and one MAS a step, fp32 masters;
   a step on the kernels against the plain path (loss terms within
   BF16_LOSS_RTOL); a multi-speaker step (d_gl through the bf16 backward:
   emb_g's rows); the train CLI with `use_bf16` for an epoch and a resume
   for a second, checked bit for bit; then a bf16 and an fp32 step on the
   same weights and batch in turns: host ms, a profiled step's device
   busy ms, idle share, operations and largest kernels.
16. Tacotron variants (after Tacotron training): the LJSpeech config with
   style_dim_vae = TACO_STYLE_DIM, seeded, reference mels of eight seeded
   clips of TACO_REF_SECONDS through the port's frontend on the card.
   Counts zeroed, then `infer` of TACO_STEPS steps at B=1 and a ragged B=8
   with ragged references: one `taco_step_streamed` launch per step and
   row group; then the same decodes on the cell route with the kernel
   route's frames as each step's input, within TACO_TF_ATOL (the styled
   memory is checked to be non-zero past the shortest text); decode times
   and device busy with and without the style, in turns; a train step with
   the teacher mels as reference (the KL term > 0) and an eval_step (no
   reference, KL 0) at the training phase's shape; `tacotron_infer --ref
   --plot` as a process on the card (a WAV and a PNG). Then each of
   TACO_VARIANTS (the Tacotron-2 cell; the CBHG encoder, Tacotron-1 cell
   and MelPostnet2) at the config's widths: `infer` of TACO_VARIANT_STEPS
   at TACO_VARIANT_B on the card against the same model and masks on the
   CPU (given the card's frames step by step) within TACO_TF_ATOL, chunks
   of TACO_VARIANT_CHUNK against the whole decode, decode ms and device
   busy, one train step and eval_step (B = TACO_TRAIN_B, TACO_LOSS_FRAMES
   frames), one `TacotronSynthesizer` dispatch;
   no Taco2Prod kernel launch (these cells have no TPU kernel).
17. Export (after the int8 decoder): seeded full-width LJSpeech weights
   as a run dir (`ckpt_100.pt`) and a JSON config. `cli/vits2_infer.py`
   and `cli/export.py` (EXPORT_TEXT_LEN / EXPORT_FRAMES) run as processes,
   started together: the CLI's WAV must be what the in-process fp32
   `infer` gives within CLI_WAV_ATOL before its 16-bit rounding (and the
   same comparison against an in-process TF32 run says whether the check
   sees TF32). The `.pt2` program loaded back and run at B=1 (text padded
   to EXPORT_TEXT_LEN, noise from the default generator after one
   `torch.manual_seed`) against eager `infer(generator=DEFAULT_RNG)`: equal
   y_lengths, audio within EXPORT_ATOL, each `tts::` operator launched as
   many times. The same for the int8-decoder model's program, exported in
   this process (its quantizer and conv outputs recorded in both runs,
   bit for bit) and for `export_vocoder`'s program of the LJSpeech
   vocoder at VOCODER_EXPORT_FRAMES frames against `Vocoder.wave`. Host
   and device-busy ms of each program against eager, in turns; each
   operator's dispatch cost (`dispatch_us`) against its bare CUDA body.
18. Prints each phase's seconds, the kernels' JSON line (launches: the
   main paths', the trainer's, the bf16 path's, the multi-speaker path's,
   the serving path's, the MB-iSTFT path's, the int8 decoder's, the
   export path's and the Tacotron serving, training and variants paths';
   launches_by_path: each path's own; the bf16 WN variants as rows of
   their own, with their shape; `dispatch_us` on the four operators'
   rows), then the device line last.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
import shutil
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
# the trainer: a synthetic LJSpeech-layout corpus of this many clips of
# these lengths in seconds, which fill the (32, 300] and (300, 400] frame
# buckets; its batches' shapes: text padded to max_text_len * 2 + 1 ids
# (add_blank), frames to each bucket's upper boundary
TRAINER_CLIPS, TRAINER_SECONDS = 40, (1.5, 4.5)
TRAINER_TX, TRAINER_FRAMES = 2 * 190 + 1, (300, 400)
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
# the multi-speaker model: configs/vits2-multispeaker.yaml's changes to the
# LJSpeech defaults; its voice conversion shape; the trainer's synthetic
# corpus of that many clips over that many speakers
MULTISPEAKER = dict(n_speakers=109, gin_channels=256, use_spk_conditioned_encoder=True)
MS_VC_B, MS_VC_TY = 2, 400
MS_TRAINER_CLIPS, MS_TRAINER_SPEAKERS = 16, 4
# the MB-iSTFT model: configs/vits2-ljspeech-mbistft.yaml's changes to the
# LJSpeech defaults
MBISTFT = dict(upsample_rates=(4, 4), upsample_kernel_sizes=(16, 16), decoder_type="mb_istft",
               subbands=4, gen_istft_n_fft=16, gen_istft_hop_size=4, pack_narrow_convs=True)
# its audio has no tanh: kernel path against plain path within AUDIO_ATOL *
# max(1, max |plain|); the stream against synthesize within STREAM_ATOL times
# that, but for the last MB_EDGE samples (n_fft / 2 * subbands + the PQMF's
# taps / 2), where synthesize decodes the exact length and a stream the
# masked one; the iSTFT + PQMF head on the card against the CPU within
# MB_HEAD_RTOL of the peak; the MRF bank at the trunk's C=128 stage, B=8 at
# 1024 frames; the four other flow types, and the ResBlock2 decoder of
# HiFi-GAN's V2/V3 configs
MB_EDGE = 16 // 2 * 4 + 62 // 2
MB_HEAD_RTOL = 1e-5
MB_MRF_SHAPE = (8, 16 * MAX_FRAMES, 128)
MB_FLOW_TYPES = ("pre_conv2", "fft", "mono_layer_inter_residual", "mono_layer_post_residual")
RESBLOCK2 = dict(resblock="2", resblock_kernel_sizes=(3, 5, 7),
                 resblock_dilation_sizes=((1, 2), (2, 6), (3, 12)))
# the inference phase's host and device-busy ms per (model, B, path), printed
# beside the MB-iSTFT model's
INFER_TIMES = {}
# the int8 decoder: configs/vits2-ljspeech.yaml's (and the MB-iSTFT
# config's) changes for `quantize_decoder`; pack_narrow_convs as the YAML
# ships it. The int8 conv against its plain version within INT8_CONV_RTOL
# of the output's peak: the int32 sums are exact, the fp32 epilogue is the
# same operations in the same order (no fused multiply-add)
INT8 = dict(quantize_decoder=True, pack_narrow_convs=True)
INT8_CONV_RTOL = 1e-6
# the int8 kernels' edge shapes, each against the plain versions bit for bit:
# (C_in, T, B, C_out, taps, dilation, padding, phases, slope, masked,
# residual). C_in off the 32-channel granule, and conv_pre's 192 (a K tail
# in a 128-byte step); phases 8 and 4 (HiFi-GAN's and MB-iSTFT's up
# convs), 3 (126-column tiles) and 160 (above a tile: runs of 80 columns);
# T_out off the tile with B > 1 (item edges), odd T_out (scalar stores);
# the residual, slope and mask variants; each of the three tiles
INT8_EDGES = ((80, 100, 2, 96, 7, 1, (3, 3), 1, None, False, False),
              (81, 100, 2, 96, 7, 1, (3, 3), 1, None, False, False),
              (192, 77, 3, 512, 7, 1, (3, 3), 1, None, True, False),
              (512, 701, 2, 256, 3, 1, (1, 1), 8, 0.1, True, False),
              (256, 333, 3, 128, 5, 1, (2, 2), 4, 0.1, False, False),
              (128, 20001, 2, 128, 11, 5, (25, 25), 1, 0.1, True, True),
              (256, 4000, 2, 256, 3, 3, (3, 3), 1, 0.1, False, True),
              (64, 130, 2, 48, 5, 2, (4, 4), 3, 0.1, False, False),
              (32, 40, 2, 2, 3, 1, (1, 1), 160, None, False, False))
INT8_GRAPH_EDGE = 6  # the edge captured in a CUDA graph and replayed
# calls in the CUDA graph that times an int8 kernel (and fp32 cuDNN), and
# its plain version
INT8_GRAPH, INT8_GRAPH_PLAIN = 20, 3
# the int8 kernels' fields of the kernels line beyond the common ones
INT8_FIELDS = ("shape", "shape_calls", "calls_per_infer", "ms_per_infer", "plain_ms_per_infer",
               "bound_ms_per_infer", "fp32_conv_ms", "fp32_conv_ms_per_infer",
               "library_ms_per_infer")
# the bf16 WN kernels' fields beyond the common ones: the fp32 kernel's time
# on the same values, timed in turns with them, and the backward's device
# kernels a call
BF16_FIELDS = ("fp32_ms", "kernels_per_call")
# fault 1's card check: widths no shipped config has, which the WN kernels
# (hidden 128) and the MRF kernel (a 16-channel last stage) do not take
NARROW = dict(hidden_channels=128, upsample_initial_channel=256)
# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3;
# and the rate that keeps fp32 accuracy on the tensor cores, 3xTF32 (three
# TF32 products a fp32 product) at a third of the 495 TFLOP/s TF32 peak,
# the bound of the kernels built on products (MRF bank, WN forward and
# backward, the LLTM gate product)
PEAK_FP32_FLOPS, PEAK_BYTES_PER_S = 67e12, 3.35e12
PEAK_3XTF32_FLOPS = 495e12 / 3
# dense int8 tensor-core operations (the int8 conv's bound)
PEAK_INT8_OPS = 1979e12
PEAK_BF16_FLOPS = 989e12
# bf16 kernels: of the output's peak, against the plain version in bf16
# (it rounds every op; measured 6-9e-3 on the H100) and against the fp32
# plain version on the same bf16 values (measured 3-4e-3)
BF16_KERNEL_RTOL, BF16_FP32_RTOL = 2.0 ** -5, 2.0 ** -6
BF16_LOSS_RTOL = 5e-2  # the bf16 step's loss terms, kernel path against plain
# mel_spectrogram_auto's threshold sweep: 8 clips of these many samples
MEL_AUTO_LENGTHS = (2048, 8192, 32768, 220500)
# the serving path: the Synthesizer's buckets (None: serving.DEFAULT_BUCKETS)
# and its default tiers; texts that span the buckets, each of which the
# transliteration cleaners keep nearly as written (2 n + 1 ids with blanks);
# the batcher's load; the stream's chunk and context frames and its text
# (about 10 s in the (256, 1344) bucket); the long-form text's characters;
# the stream on the plain path against the bucketed decode on the plain path
SERVING_BUCKETS = None
SERVING_TEXTS = (
    "Hello there.", "The quick brown fox.", "Good morning to you.",
    SENTENCES[0], "Speech synthesis turns text into audio.",
    "Printing differs from most of the arts and crafts shown.",
    SENTENCES[1], SENTENCES[0] + " " + SENTENCES[1],
    "The batcher groups requests of one bucket and pads them to a batch tier of one, "
    "two or eight.",
    SENTENCES[2], SENTENCES[2] + " " + SENTENCES[0], SENTENCES[1] + " " + SENTENCES[2],
)
BATCHER_REQUESTS, BATCHER_THREADS, BATCHER_SID_REQUESTS = 32, 8, 2
STREAM_CHUNK, STREAM_CONTEXT = 64, 32
STREAM_TEXT = ("Streaming synthesis sends the first audio after one window of latent "
               "frames, not after the whole utterance.")
# the seeded weights give this text (215 ids) 4.39 s; a slower speaking rate
# brings it to about 10 s, still inside its bucket's 1344 frames
STREAM_LENGTH_SCALE = 2.7
LONG_CHARS = 1000
STREAM_ATOL = 2e-5
# the Tacotron serving path (`infer/taco_serving.py`): the vocoder trainer's
# GAN steps (batch, steps) on a synthetic corpus of TACO_VOCODER_CLIPS clips
# (the trainer phase's writer); the (tier, bucket) grid of the two smallest
# default buckets; the stream's chunk steps and pad frames in the (128, 400)
# bucket; requests at once on the web UI. Tolerances: kernel path against
# plain path (the step kernel and the MRF bank, decoded free-running over up
# to 200 steps) stop lengths equal and audio within TACO_AUDIO_ATOL of the
# peak; the stream against postnet + vocoder over the tier-1 batch decode's
# mel trimmed at the stop within TACO_AUDIO_ATOL of the peak, and against the
# batch audio but for the last TACO_EDGE_FRAMES frames (the postnet's and
# HiFi-GAN's reach past the stop: 10 + under 30 frames)
TACO_VOCODER_CLIPS, TACO_VOCODER_STEPS, TACO_VOCODER_BATCH = 8, 4, 4
TACO_GRID_BUCKETS = 2
TACO_STREAM_CHUNK, TACO_STREAM_PAD = 32, 48
TACO_STREAM_TEXT = SENTENCES[2][:110]
TACO_AUDIO_ATOL = 1e-3
TACO_EDGE_FRAMES = 48
TACO_WEB_REQUESTS = 4
# Tacotron training (`train/tacotron_train.py`): a synthetic corpus of
# TACO_TRAIN_CLIPS clips (write_corpus), the first TACO_TRAIN_EVAL held out
# for evaluate(); batches of TACO_TRAIN_B, text padded as the train CLI pads
# it, frames to TACO_TRAIN_FRAMES; the loss check's steps on one batch
# cut to its first TACO_LOSS_FRAMES frames (a step's host time follows its
# decoder steps: about 2.3 s at 400 on the H100's host);
# eval_step on the kernel against the plain path within TACO_EVAL_ATOL
# (w, y, y_post and the loss; fp32 over 400 steps, as TACO_TF_ATOL)
TACO_TRAIN_CLIPS, TACO_TRAIN_EVAL, TACO_TRAIN_B, TACO_TRAIN_FRAMES = 48, 16, 16, 400
TACO_LOSS_STEPS, TACO_LOSS_FRAMES = 20, 128
TACO_EVAL_ATOL = 1e-3
# export (`infer/export.py`, `cli/export.py`, `infer/vocoder.export_vocoder`):
# the JAX signature's static shapes; the CLI's WAV against the in-process
# fp32 `infer` within CLI_WAV_ATOL before its 16-bit rounding; exported
# programs against eager within EXPORT_ATOL (fp32, the same kernels in the
# same order); the vocoder's program at VOCODER_EXPORT_FRAMES mel frames;
# each operator's dispatch cost over DISPATCH_CALLS calls at small shapes
EXPORT_TEXT_LEN, EXPORT_FRAMES = 512, 1000
CLI_WAV_ATOL = EXPORT_ATOL = 1e-5
VOCODER_EXPORT_FRAMES = 400
DISPATCH_CALLS = 200
EXPORT_NOISE = (0.667, 1.0, 0.8)


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


def bf16_bound(name: str, flops: float, nbytes: float, card: str):
    """The bound of a bf16 kernel at the bf16 tensor-core rate."""
    b = bound(flops, nbytes, PEAK_BF16_FLOPS)
    log(f"  {name}: bound {b[0]:.4f} ms ({b[1]}, {flops / 1e9:.1f} GFLOP at bf16's "
        f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s, {nbytes / 1e6:.1f} MB) [{card}]")
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
    """Random lengths, neg_cent ~ 3 N(0, 1), rounded for ties. Item 0 has
    T_y frames and min(T_x, T_y) ids; no item has more ids than frames."""
    import torch

    x_max = min(T_x, T_y)
    t_ys = torch.randint(T_y // 2, T_y + 1, (B,), generator=g)
    t_xs = torch.minimum(torch.randint(x_max // 2, x_max + 1, (B,), generator=g), t_ys)
    t_ys[0], t_xs[0] = T_y, x_max
    nc = torch.randn(B, T_y, T_x, generator=g) * 3
    if ties:
        nc = torch.round(nc)
    mask = ((torch.arange(T_y)[None, :, None] < t_ys[:, None, None])
            & (torch.arange(T_x)[None, None, :] < t_xs[:, None, None])).float()
    return nc.to(device), mask.to(device), t_ys.to(device), t_xs.to(device)


def check_audio(audio, y_lengths, hop: int, what: str, max_frames: int = MAX_FRAMES):
    """Finite audio, 0 < y_lengths <= max_frames, and silence past each
    item's y_lengths * hop samples."""
    import torch

    if not torch.isfinite(audio).all():
        raise RuntimeError(f"{what}: non-finite audio")
    if not bool(((y_lengths > 0) & (y_lengths <= max_frames)).all()):
        raise RuntimeError(f"{what}: y_lengths {y_lengths.tolist()} outside (0, {max_frames}]")
    pos = torch.arange(audio.shape[1], device=audio.device)[None, :]
    tail = audio[:, :, 0] * (pos >= (y_lengths.to(torch.int64) * hop)[:, None])
    if bool(tail.abs().max() > 0):
        raise RuntimeError(f"{what}: audio past y_lengths*hop is not zero")


def bench_infer(model, B: int, device, seed=None, **kw):
    """`infer` at the bench shapes (T_X ids, lengths T_X (8 - i) / 8,
    MAX_FRAMES), noise from a generator seeded by `seed` (default B); kw
    goes to `infer` (sid)."""
    import torch

    from torch_tts_tpu_torch.text import symbols

    g = torch.Generator().manual_seed(100 + B)
    x = torch.randint(1, len(symbols), (B, T_X), generator=g).to(device)
    lengths = torch.tensor([T_X * (8 - i) // 8 for i in range(B)]).to(device)
    gen = torch.Generator(device=device).manual_seed(B if seed is None else seed)
    return model.infer(x, lengths, noise_scale=0.667, noise_scale_w=0.8, max_frames=MAX_FRAMES,
                       generator=gen, **kw)


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
    # the trainer's shapes: B=8 at the buckets' padded frames, text padded
    # to TRAINER_TX ids (not a multiple of 4: the kernel streams rows by
    # 4-byte copies); MAS exactly, and the WN group's saving forward and
    # its backward through autograd, as the train step runs them
    names = ("d_x", "d_w_in", "d_b_in", "d_w_rs", "d_b_rs")
    for T in TRAINER_FRAMES:
        for ties in (False, True):
            nc_t, mask_t, ty_t, tx_t = mas_inputs(g, device, B, T, TRAINER_TX, ties)
            masked_t = torch.where(mask_t > 0, nc_t, torch.full((), mas.MAX_NEG, device=device))
            same = torch.equal(mas.maximum_path(nc_t, mask_t),
                               mas.maximum_path_plain(masked_t, ty_t, tx_t) * mask_t)
            log(f"  maximum_path B={B} T_y={T} T_x={TRAINER_TX} ties={ties} (the trainer's "
                f"shape): kernel == plain -> {'ok' if same else 'FAIL'}")
            if not same:
                raise RuntimeError(f"maximum_path: kernel differs from the plain version at the "
                                   f"trainer's shape T_y={T}, T_x={TRAINER_TX}")
        lengths = torch.tensor([T - (T // 16) * i for i in range(B)])
        args = wn_args(B, T, lengths)
        d_xo, d_sk = randn(B, T, H), randn(B, T, H)
        with torch.enable_grad():
            ins = [a.detach().requires_grad_() for a in (args[0], *args[3:])]
            out = wn_group(ins[0], args[1], None, *ins[1:])
            got = torch.autograd.grad(out, ins, (d_xo, d_sk))
        out, want = [o.detach() for o in out], wn_group_plain(*args)
        res["wn_group"]["max_abs_err"] = max(
            [res["wn_group"]["max_abs_err"]]
            + [compare(f"wn_group saving forward B={B} T={T} (the trainer's shape) {n}", o, r)
               for n, o, r in zip(("x_out", "skip"), out, want)])
        want = wn_stack.wn_group_backward_plain(*args, d_xo, d_sk)
        res["wn_group_backward"]["max_abs_err"] = max(
            [res["wn_group_backward"]["max_abs_err"]]
            + [grad_compare(f"wn_group_backward B={B} T={T} (the trainer's shape, autograd) {n}",
                            a, b) for n, a, b in zip(names, got, want[:1] + want[2:])])

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

    from torch_tts_tpu_torch.cli import vits2_infer
    from torch_tts_tpu_torch.core.config import VITS2Config
    from torch_tts_tpu_torch.kernels.mrf_fused import mrf_fused
    from torch_tts_tpu_torch.kernels.wn_stack import wn_group

    # the port's defaults: fuse_mrf on, TTS_FUSED_WN unset (fused on the card)
    base = VITS2Config()
    cfg = dataclasses.replace(
        base, data=dataclasses.replace(base.data, text_cleaners=("transliteration_cleaners",)))
    os.environ.pop("TTS_FUSED_WN", None)
    if not cfg.model.fuse_mrf:
        raise RuntimeError("the port's default config has fuse_mrf off")
    t0 = time.perf_counter()
    model = seeded_synthesizer(cfg, device)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"slice phase: SynthesizerTrn {n_params} params, seeded init "
        f"{time.perf_counter() - t0:.1f} s")

    ckpt, cfg_path = os.path.join(tmp, "G.pth"), os.path.join(tmp, "config.json")
    torch.save({"model": model.state_dict()}, ckpt)
    with open(cfg_path, "w") as f:
        json.dump({"model": dataclasses.asdict(cfg.model),
                   "data": {**dataclasses.asdict(cfg.data), **dataclasses.asdict(cfg.audio)}}, f)
    hop, sr = cfg.audio.hop_length, cfg.audio.sampling_rate

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
        audio, attn, y_mask, aux, y_lengths = bench_infer(model, B, device)
        check_audio(audio, y_lengths, hop, f"bench B={B}")
        outs[B] = (audio, y_lengths)
        log(f"  bench B={B}: audio {tuple(audio.shape)}, y_lengths {y_lengths.tolist()}")
    torch.cuda.synchronize()
    launches = {"mrf_fused": mrf_fused.launches, "wn_group": wn_group.launches}
    log(f"  launch counts on the main path (the port's defaults): {launches}")
    if not all(launches.values()):
        raise RuntimeError(f"a kernel of the main path did not launch: {launches}")

    # --- same inputs and noise through the plain path
    use_model_path(model, "plain")
    for B in (1, 8):
        audio, attn, y_mask, aux, y_lengths = bench_infer(model, B, device)
        check_audio(audio, y_lengths, hop, f"plain B={B}")
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
            use_model_path(model, path)
            times.setdefault(path, []).append(wall_ms(lambda: bench_infer(model, B, device)))
        for path, ts in times.items():
            ms = statistics.median(ts)
            use_model_path(model, path)
            busy = profile_busy_ms(lambda: bench_infer(model, B, device))
            INFER_TIMES["HiFi-GAN", B, path] = (ms, busy)
            log(f"  infer B={B} T_x={T_X} max_frames={MAX_FRAMES} {path}: {ms:.2f} ms/call, "
                f"{B * audio_s / (ms / 1e3):.1f}x real time; device busy {busy:.2f} ms/call [{card}]")
    use_model_path(model, "kernel")
    return launches


def profile_busy_ms(fn, kernel: str = ""):
    """Device busy time of one fn() call in ms (torch.profiler, the sum of
    device self time); with `kernel`, (that time, the launches the profiler
    saw of device kernels whose name holds `kernel`)."""
    busy, seen = profile_kernels(fn, (kernel,) if kernel else ())
    return (busy, seen[kernel]) if kernel else busy


def profile_kernels(fn, names):
    """Device busy time of one fn() call in ms and, per name in `names`,
    the device operations (kernels, memsets, copies) the profiler saw whose
    name holds it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    evs = [e for e in prof.key_averages() if e.device_type == cuda]
    busy = sum(e.self_device_time_total for e in evs) / 1e3
    return busy, {n: sum(e.count for e in evs if n in e.key) for n in names}


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
    from torch_tts_tpu_torch.models.vits2 import model as model_module
    from torch_tts_tpu_torch.text import symbols
    from torch_tts_tpu_torch.train.vits2_train import (build_dur_disc, build_mpd,
                                                       create_train_state, train_step)

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

    def fresh_state(c=cfg):
        model = seeded_synthesizer(c, device)
        return create_train_state(c, model, build_mpd(c, seed=1, device=device),
                                  dur_disc=build_dur_disc(c, seed=2, device=device))

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

    # --- the duration discriminator's term (dur_disc_1, the ddp order): one
    # step from one fresh state on each path, the same noise
    dcfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, use_duration_discriminator=True, duration_discriminator_type="dur_disc_1"))
    dres = {}
    for path in ("kernel", "plain"):
        use_path(path)
        st = fresh_state(dcfg)
        dres[path] = train_step(dcfg, st, batch, generator=gen(101))
        del st
    for key in dres["kernel"]:
        mk, mp = dres["kernel"][key], dres["plain"][key]
        d = abs(mk - mp)
        log(f"  dur_disc_1 step {key}: kernel {mk:.6f} plain {mp:.6f} |d|={d:.3e}")
        if not (math.isfinite(mk) and math.isfinite(mp)) or (
                key.startswith("loss") and d > LOSS_RTOL * abs(mp) + LOSS_ATOL):
            raise RuntimeError(f"dur_disc_1 step {key}: kernel path and plain path disagree")
    if "loss/dur_disc" not in dres["kernel"]:
        raise RuntimeError("the dur_disc_1 step reported no loss/dur_disc")

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


def bf16_check(name: str, out, ref, rtol: float) -> float:
    """Check a bf16 kernel's output against a plain version, within rtol of
    the plain output's peak; -> max |d|."""
    import torch

    err = float((out.float() - ref.float()).abs().max())
    peak = float(ref.float().abs().max())
    ok = err <= rtol * peak and bool(torch.isfinite(out).all())
    log(f"  {name}: max_abs_err={err:.3e}, {err / peak:.2e} of the peak {peak:.3e}; tolerance "
        f"{rtol:.2e} of the peak -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{name}: the bf16 kernel disagrees with its plain version")
    return err


def bf16_kernel_checks(device, card: str):
    """The bf16 WN kernels at the train step's shape against their plain
    versions in bf16 (and the fp32 plain versions on the same bf16 values),
    timed beside their bounds at bf16's rate. -> the kernels' stats."""
    import torch

    from torch_tts_tpu_torch.kernels import wn_stack
    from torch_tts_tpu_torch.kernels.wn_stack import (wn_group, wn_group_backward,
                                                      wn_group_backward_plain, wn_group_plain)

    g = torch.Generator().manual_seed(17)
    H, L, k = WN_SHAPE["H"], WN_SHAPE["L"], WN_SHAPE["k"]
    B, T = TRAIN_B, TRAIN_TY

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(device)

    def args(lengths, with_gl):
        mask = (torch.arange(T)[None, :] < torch.tensor(lengths)[:, None]).float()[:, :, None]
        w_rs, b_rs = randn(L, H, 2 * H, scale=0.5 / H ** 0.5), randn(L, 2 * H, scale=0.1)
        w_rs[-1, :, :H], b_rs[-1, :H] = 0, 0
        a = (randn(B, T, H), mask.to(device), randn(B, L, 2 * H) if with_gl else None,
             randn(L, k, H, 2 * H, scale=0.5 / (k * H) ** 0.5), randn(L, 2 * H, scale=0.1),
             w_rs, b_rs)
        return tuple(None if t is None else t.bfloat16().contiguous() for t in a)

    def widened(a):
        return tuple(None if t is None else t.float() for t in a)

    log(f"bf16 kernel checks (B={B}, T={T}, H={H}, L={L}, k={k}; tolerances of the output's "
        f"peak: {BF16_KERNEL_RTOL:.2e} against the plain version in bf16, which rounds every "
        f"op, {BF16_FP32_RTOL:.2e} against the fp32 plain version on the same bf16 values):")
    stats, errs = {}, []
    cases = (([T] * B, False), ([T - 37 * i for i in range(B)], True))
    for lengths, with_gl in cases:
        a = args(lengths, with_gl)
        out, ref, ref32 = wn_group(*a), wn_group_plain(*a), wn_group_plain(*widened(a))
        for n, o, r, r32 in zip(("x_out", "skip"), out, ref, ref32):
            what = f"wn_group bf16 B={B}{' gl' * with_gl} {n}"
            if o.dtype != torch.bfloat16:
                raise RuntimeError(f"{what}: {o.dtype}, not bf16")
            errs.append(bf16_check(what, o, r, BF16_KERNEL_RTOL))
            bf16_check(what + " (fp32 plain)", o, r32, BF16_FP32_RTOL)
    a = args([T] * B, False)
    a32 = widened(a)
    # the bf16 saving forward and the fp32 one on the same values, in turns
    turns = {"bf16": [], "fp32": []}
    for dt in ("bf16", "fp32", "fp32", "bf16"):
        turns[dt].append(cuda_ms(lambda: wn_stack._forward_cuda(*(a if dt == "bf16" else a32),
                                                               save=True)))
    t_k, t_32 = statistics.median(turns["bf16"]), statistics.median(turns["fp32"])
    t_p = cuda_ms(lambda: wn_group_plain(*a))
    flops = 2.0 * B * T * H * 2 * H * (k + 1) * L
    # reads bf16 x, mask and weights; writes bf16 x_out, skip and x_i, fp32 x_in
    nbytes = (2.0 * (3 * B * T * H + B * T + L * (k + 1) * H * 2 * H + 2 * L * 2 * H)
              + 2.0 * L * B * T * H + 4.0 * L * B * T * 2 * H)
    stats["wn_group_bf16"] = dict(max_abs_err=max(errs), ms=t_k, plain_ms=t_p, fp32_ms=t_32,
                                  bound=bf16_bound("wn_group bf16 saving forward", flops, nbytes,
                                                   card), shape=[B, T, H, L, k])
    log(f"  wn_group bf16 saving forward B={B} T={T}: kernel {t_k:.3f} ms (turns "
        f"{', '.join(f'{v:.3f}' for v in turns['bf16'])}), the fp32 kernel on the same values "
        f"{t_32:.3f} ms (turns {', '.join(f'{v:.3f}' for v in turns['fp32'])}), plain (bf16) "
        f"{t_p:.3f} ms [{card}]")

    names = ("d_x", "d_gl", "d_w_in", "d_b_in", "d_w_rs", "d_b_rs")
    errs = []
    for lengths, with_gl in cases:
        a = args(lengths, with_gl)
        d_xo, d_sk = randn(B, T, H).bfloat16(), randn(B, T, H).bfloat16()
        saved = wn_stack._forward_cuda(*a, save=True)[2]
        if (saved[0].dtype, saved[1].dtype) != wn_stack.save_dtypes(torch.bfloat16):
            raise RuntimeError(f"wn_group bf16 saves: {saved[0].dtype}, {saved[1].dtype}")
        got = wn_group_backward(*a, d_xo, d_sk, saved=saved)
        want = wn_group_backward_plain(*a, d_xo, d_sk)
        want32 = wn_group_backward_plain(*widened(a), d_xo.float(), d_sk.float())
        for n, x, y, y32 in zip(names, got, want, want32):
            if y is None:
                continue
            what = f"wn_group_backward bf16 B={B}{' gl' * with_gl} {n}"
            if x.dtype != torch.bfloat16:
                raise RuntimeError(f"{what}: {x.dtype}, not bf16")
            errs.append(bf16_check(what, x, y, BF16_KERNEL_RTOL))
            bf16_check(what + " (fp32 plain)", x, y32, BF16_FP32_RTOL)
        again = wn_group_backward(*a, d_xo, d_sk, saved=saved)
        if not all(torch.equal(x, y) for x, y in zip(got, again) if x is not None):
            raise RuntimeError("wn_group_backward bf16: two runs on the same inputs differ")
    log("  wn_group_backward bf16: two runs equal bit for bit -> ok")
    per_call = kernels_in(lambda: wn_group_backward(*a, d_xo, d_sk, saved=saved))
    log(f"  wn_group_backward bf16: {per_call} device kernels a call (by CUDA graph capture; "
        f"2 L + 2 = {2 * L + 2} by design) -> {'ok' if per_call == 2 * L + 2 else 'differs'}")
    a32, d32 = widened(a), (d_xo.float(), d_sk.float())
    saved32 = wn_stack._forward_cuda(*a32, save=True)[2]
    turns = {"bf16": [], "fp32": []}
    for dt in ("bf16", "fp32", "fp32", "bf16"):
        turns[dt].append(cuda_ms(
            (lambda: wn_group_backward(*a, d_xo, d_sk, saved=saved)) if dt == "bf16"
            else (lambda: wn_group_backward(*a32, *d32, saved=saved32))))
    t_k, t_32 = statistics.median(turns["bf16"]), statistics.median(turns["fp32"])
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (a[0], a[2], *a[3:])]
        out = wn_group_plain(ins[0], a[1], *ins[1:])
        t_p = cuda_ms(lambda: torch.autograd.grad(out, ins, (d_xo, d_sk), retain_graph=True))
    # reads x_i (bf16) and x_in (fp32), bf16 cotangents, mask and weights;
    # writes bf16 d_x and the gradients
    nbytes = (2.0 * L * B * T * H + 4.0 * L * B * T * 2 * H
              + 2.0 * (3 * B * T * H + B * T + B * L * 2 * H)
              + 2.0 * 2 * (L * (k + 1) * H * 2 * H + 2 * L * 2 * H))
    stats["wn_group_backward_bf16"] = dict(
        max_abs_err=max(errs), ms=t_k, plain_ms=t_p, fp32_ms=t_32, shape=[B, T, H, L, k],
        kernels_per_call=per_call,
        bound=bf16_bound("wn_group_backward bf16", 2 * flops, nbytes, card))
    log(f"  wn_group_backward bf16 B={B} T={T} gl: kernel {t_k:.3f} ms (turns "
        f"{', '.join(f'{v:.3f}' for v in turns['bf16'])}), the fp32 kernel on the same values "
        f"{t_32:.3f} ms (turns {', '.join(f'{v:.3f}' for v in turns['fp32'])}), plain "
        f"(autograd of the plain group in bf16) {t_p:.3f} ms [{card}]")
    return stats


def bf16_train_phase(device, card: str, tmp: str):
    """bf16 training (`train.use_bf16`) of the default config at full width:
    the bf16 WN kernels against their plain versions; counts zeroed, three
    `ddp` steps on the kernels (the posterior encoder's WN on the bf16
    kernels, the flows' on the fp32 ones: the fp32 attention promotes their
    x, as in JAX); the step on the kernels against the plain path; one
    multi-speaker step (d_gl from the bf16 backward); the train CLI with
    `use_bf16` for two epochs, resumed bit for bit; then a bf16 step against
    an fp32 step on the same weights and batch, in turns. -> (the path's
    launch counts, the bf16 kernels' stats)."""
    import torch

    from torch_tts_tpu_torch.cli import vits2_train as cli
    from torch_tts_tpu_torch.core.config import VITS2Config
    from torch_tts_tpu_torch.data.dataset import TextAudioDataset
    from torch_tts_tpu_torch.data.sampler import DistributedBucketSampler
    from torch_tts_tpu_torch.kernels import mas
    from torch_tts_tpu_torch.kernels.wn_stack import wn_group, wn_group_backward
    from torch_tts_tpu_torch.models.vits2 import model as model_module
    from torch_tts_tpu_torch.text import symbols
    from torch_tts_tpu_torch.train import checkpoint
    from torch_tts_tpu_torch.train.vits2_trainer import BUCKET_BOUNDARIES
    from torch_tts_tpu_torch.train.vits2_train import (build_dur_disc, build_mpd,
                                                       create_train_state, train_step)
    from torch_tts_tpu_torch.utils.logging_utils import Recorder

    stats = bf16_kernel_checks(device, card)
    counters = {"wn_group_bf16": (wn_group, "launches_bf16"),
                "wn_group_backward_bf16": (wn_group_backward, "launches_bf16"),
                "wn_group": (wn_group, "launches"),
                "wn_group_backward": (wn_group_backward, "launches"),
                "maximum_path": (mas.maximum_path, "launches")}

    def zero():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def read():
        torch.cuda.synchronize()
        return {n: getattr(fn, attr) for n, (fn, attr) in counters.items()}

    def bf16(c):
        return dataclasses.replace(c, train=dataclasses.replace(c.train, use_bf16=True))

    def use_path(path):
        os.environ["TTS_FUSED_WN"] = "1" if path == "kernel" else "0"
        model_module.maximum_path = (mas.maximum_path if path == "kernel"
                                     else mas.maximum_path_via_plain)

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    def fresh_state(c):
        return create_train_state(c, seeded_synthesizer(c, device),
                                  build_mpd(c, seed=1, device=device),
                                  dur_disc=build_dur_disc(c, seed=2, device=device))

    def masters_ok(state, what):
        opts = [o for o in (state.opt_g, state.opt_d, state.opt_dur) if o is not None]
        bad = [n for o in opts for n, p, mu in zip(o.names, o.params, o.mu)
               if p.dtype != torch.float32 or mu.dtype != torch.float32
               or not bool(torch.isfinite(p).all())]
        log(f"  {what}: master parameters and moments fp32 and finite -> "
            f"{'ok' if not bad else 'FAIL ' + str(bad[:3])}")
        if bad:
            raise RuntimeError(f"{what}: master parameters not fp32 and finite: {bad[:3]}")

    def finite(history, what):
        for i, m in enumerate(history):
            log(f"  {what} {i}: " + ", ".join(f"{k}={v:.4f}" for k, v in m.items()))
            if m["nonfinite"] or not all(map(math.isfinite, m.values())):
                raise RuntimeError(f"{what} {i}: non-finite loss or gradient")

    cfg = bf16(VITS2Config())
    hop = cfg.audio.hop_length
    B, T_x, T_y = TRAIN_B, TRAIN_TX, TRAIN_TY
    g = torch.Generator().manual_seed(0)
    batch = {"x": torch.randint(1, len(symbols), (B, T_x), generator=g),
             "x_lengths": torch.full((B,), T_x),
             "spec": torch.randn(B, T_y, cfg.posterior_channels, generator=g),
             "spec_lengths": torch.full((B,), T_y),
             "wav": torch.randn(B, T_y * hop, 1, generator=g) * 0.1}
    batch = {k: v.to(device) for k, v in batch.items()}

    # --- main path: three ddp steps in bf16 through the kernels
    use_path("kernel")
    state = fresh_state(cfg)
    before = [p.detach().clone() for p in state.opt_g.params + state.opt_d.params]
    zero()
    history = [train_step(cfg, state, batch, generator=gen(i)) for i in range(TRAIN_STEPS)]
    launches = read()
    log(f"bf16 train phase: default config, use_bf16, B={B} T_x={T_x} T_y={T_y}; launch counts "
        f"({TRAIN_STEPS} steps): {launches}")
    finite(history, "bf16 step")
    want = {"wn_group_bf16": 4 * TRAIN_STEPS, "wn_group_backward_bf16": 4 * TRAIN_STEPS,
            "wn_group": 4 * TRAIN_STEPS, "wn_group_backward": 4 * TRAIN_STEPS,
            "maximum_path": TRAIN_STEPS}
    if launches != want:
        raise RuntimeError(f"bf16 steps launched {launches}, not the posterior encoder's 4 bf16 "
                           f"groups, the flows' 4 fp32 groups and one MAS a step: {want}")
    masters_ok(state, "after 3 bf16 steps")
    moved = [float((p.detach() - q).abs().max()) for p, q in
             zip(state.opt_g.params + state.opt_d.params, before)]
    log(f"  parameters moved: {sum(m > 0 for m in moved)} of {len(moved)} tensors")
    if sum(m > 0 for m in moved) < 0.9 * len(moved):
        raise RuntimeError("the bf16 steps left most parameters where they were")
    del state, before

    # --- one step from one fresh state on each path, the same noise
    res = {}
    for path in ("kernel", "plain"):
        use_path(path)
        st = fresh_state(cfg)
        res[path] = train_step(cfg, st, batch, generator=gen(100))
        del st
    use_path("kernel")
    for key in res["kernel"]:
        mk, mp = res["kernel"][key], res["plain"][key]
        d = abs(mk - mp)
        log(f"  bf16 step {key}: kernel {mk:.6f} plain {mp:.6f} |d|={d:.3e} "
            f"({d / max(abs(mp), 1e-30):.2e} of plain)")
        if not (math.isfinite(mk) and math.isfinite(mp)) or (
                key.startswith("loss") and d > BF16_LOSS_RTOL * abs(mp) + LOSS_ATOL):
            raise RuntimeError(f"bf16 step {key}: kernel path and plain path disagree beyond "
                               f"{BF16_LOSS_RTOL}")

    # --- multi-speaker: the posterior encoder's WN conditioned, d_gl from the
    # bf16 backward
    mcfg = bf16(multispeaker_config())
    mbatch = dict(batch, sid=torch.arange(B, device=device) * 13 % mcfg.model.n_speakers)
    st = fresh_state(mcfg)
    grads, step = {}, st.opt_g.step
    st.opt_g.step = lambda gr, apply=True: (grads.update(g=gr), step(gr, apply))[1]
    zero()
    m = train_step(mcfg, st, mbatch, generator=gen(3))
    counts = read()
    finite([m], "multi-speaker bf16 step")
    by_name = dict(zip(st.opt_g.names, grads["g"]))
    emb = by_name["emb_g.weight"]
    rows = int((emb.abs().sum(1) > 0).sum())
    log(f"  multi-speaker bf16 step: launches {counts}; emb_g's gradient fp32, non-zero in "
        f"{rows} rows (the batch's {len(set(mbatch['sid'].tolist()))} speakers)")
    if (counts["wn_group_backward_bf16"] != 4 or emb.dtype != torch.float32 or rows == 0
            or not bool(torch.isfinite(emb).all())):
        raise RuntimeError(f"multi-speaker bf16 step: {counts}, emb_g {emb.dtype}, {rows} rows")
    masters_ok(st, "multi-speaker bf16 step")
    for n, c in counts.items():
        launches[n] += c
    del st, grads
    torch.cuda.empty_cache()

    # --- the train CLI with use_bf16: an epoch, then a resume for a second
    tcfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, text_cleaners=("transliteration_cleaners",)))
    corpus = os.path.join(tmp, "corpus")
    write_corpus(corpus, TRAINER_CLIPS, tcfg.audio.sampling_rate)
    full = TextAudioDataset.from_ljspeech(corpus, tcfg.audio, tcfg.data)
    train_items, _ = cli.split_train_val(full.items, 100, 1234)
    lengths = TextAudioDataset(train_items, tcfg.audio, tcfg.data).lengths
    spe = len(DistributedBucketSampler(lengths, tcfg.train.batch_size, BUCKET_BOUNDARIES))
    raw = {"model": dataclasses.asdict(tcfg.model),
           "data": {**dataclasses.asdict(tcfg.data), **dataclasses.asdict(tcfg.audio)},
           "train": {**dataclasses.asdict(tcfg.train), "log_interval": 1, "eval_interval": spe}}
    config = os.path.join(tmp, "bf16.json")
    with open(config, "w") as f:
        json.dump(raw, f)
    run_dir = os.path.join(tmp, "run_bf16")

    def run(epochs):
        zero()
        tr = cli.main(["-c", config, "-m", run_dir, "--data-root", corpus, "--epochs",
                       str(epochs), "--device", str(device)], make_writer=lambda d: Recorder())
        return tr, read()

    t0 = time.perf_counter()
    tr, counts = run(1)
    path = checkpoint.latest_checkpoint(run_dir)
    saved = checkpoint.load_file(path)
    bad = tree_mismatches(saved, checkpoint.state_tree(tr.state))
    floats = [v for v in _tree_tensors(saved) if v.is_floating_point()]
    log(f"  train CLI, use_bf16, epoch 1: {spe} steps in {time.perf_counter() - t0:.1f} s with "
        f"the data's first pass and evaluate(); launches {counts}; checkpoint "
        f"{os.path.basename(path)} holds the state ({'ok' if not bad else bad[:3]}), its "
        f"{len(floats)} float tensors all fp32: {all(v.dtype == torch.float32 for v in floats)}")
    if (tr.state.step != spe or bad or not tr.cfg.train.use_bf16
            or not all(v.dtype == torch.float32 for v in floats)):
        raise RuntimeError(f"bf16 trainer epoch 1: step {tr.state.step}, mismatches {bad[:3]}")
    for n, c in counts.items():
        launches[n] += c
    del tr, saved
    restore, restored = checkpoint.restore_checkpoint, {}

    def checked_restore(p, state, lenient=True):
        out = restore(p, state, lenient)
        restored["step"] = state.step
        restored["mismatches"] = tree_mismatches(checkpoint.state_tree(state),
                                                 checkpoint.load_file(p))
        return out

    checkpoint.restore_checkpoint = checked_restore
    try:
        tr, counts = run(2)
    finally:
        checkpoint.restore_checkpoint = restore
    if restored.get("step") != spe or restored["mismatches"] or tr.state.step != 2 * spe:
        raise RuntimeError(f"the bf16 resume did not restore the saved state: {restored}")
    log(f"  train CLI, use_bf16, resume: step {restored['step']}, the state equal to the "
        f"checkpoint bit for bit -> ok; epoch 2 to step {tr.state.step}; launches {counts}")
    masters_ok(tr.state, "bf16 trainer")
    for n, c in counts.items():
        launches[n] += c
    del tr
    torch.cuda.empty_cache()

    # --- a bf16 step against an fp32 step on the same weights and batch, in turns
    cfg32 = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, use_bf16=False))
    states = {"fp32": fresh_state(cfg32), "bf16": fresh_state(cfg)}
    cfgs = {"fp32": cfg32, "bf16": cfg}
    times = {}
    for what in ("fp32", "bf16", "bf16", "fp32"):
        times.setdefault(what, []).append(wall_ms(
            lambda: train_step(cfgs[what], states[what], batch, generator=gen(7)),
            warmup=1, reps=2))
    for what in ("fp32", "bf16"):
        zero()
        busy, ops, host, top = profile_breakdown(
            lambda: train_step(cfgs[what], states[what], batch, generator=gen(8)))
        c = read()
        log(f"  train step B={B} T_y={T_y} {what}: host {statistics.median(times[what]):.1f} "
            f"ms/step (turns {', '.join(f'{t:.1f}' for t in times[what])}); a profiled step: "
            f"device busy {busy:.1f} ms in {host:.1f} ms of host (idle share "
            f"{1 - busy / host:.2f}), {ops} device operations; WN launches "
            f"{ {n: v for n, v in c.items() if n.startswith('wn')} } [{card}]")
        log(f"    {what} step's device time by kernel (the largest {len(top)}): " + "; ".join(
            f"{name[:60]} {ms:.1f} ms x{n}" for name, ms, n in top))
    del states
    torch.cuda.empty_cache()
    log(f"  launch counts on the bf16 train path (3 steps, a multi-speaker step, the trainer's "
        f"two epochs): {launches}")
    return launches, stats


def _tree_tensors(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _tree_tensors(v)
        elif hasattr(v, "is_floating_point"):
            yield v


def write_corpus(root: str, n: int, sr: int, seed: int = 0):
    """An LJSpeech-layout corpus: metadata.csv and wavs/*.wav, 16-bit PCM at
    `sr`, n seeded clips of TRAINER_SECONDS (a tone with two harmonics and
    noise), the text from SENTENCES in turn."""
    import numpy as np
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "wavs"))
    lines = []
    for i in range(n):
        t = np.arange(int(rng.uniform(*TRAINER_SECONDS) * sr)) / sr
        f0 = rng.uniform(90, 260)
        wav = sum(0.2 / k * np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 6.3))
                  for k in (1, 2, 3)) + 0.02 * rng.standard_normal(t.size)
        wavfile.write(os.path.join(root, "wavs", f"LJ{i:03d}.wav"), sr,
                      np.round(np.clip(wav, -1, 1) * 32767).astype(np.int16))
        text = SENTENCES[i % len(SENTENCES)]
        lines.append(f"LJ{i:03d}|{text}|{text}")
    with open(os.path.join(root, "metadata.csv"), "w") as f:
        f.write("\n".join(lines) + "\n")


def tree_mismatches(a: dict, b: dict, prefix: str = "") -> list:
    """Keys of two checkpoint dicts whose values are not equal bit for bit."""
    import torch

    bad = [prefix + k for k in set(a) ^ set(b)]
    for k in set(a) & set(b):
        va, vb = a[k], b[k]
        if isinstance(va, dict) and isinstance(vb, dict):
            bad += tree_mismatches(va, vb, f"{prefix}{k}/")
        elif isinstance(va, torch.Tensor) and isinstance(vb, torch.Tensor):
            if va.shape != vb.shape or not torch.equal(va.cpu(), vb.cpu()):
                bad.append(prefix + k)
        elif va != vb:
            bad.append(prefix + k)
    return bad


def adam_change_bound(opt, p_abs: float) -> float:
    """The most `opt.count` AdamW updates can move an element of size at
    most p_abs: per update t, lr_t (|m_t| / sqrt(v_t) + weight_decay p_abs)
    with the bias corrections, and by Cauchy-Schwarz |m_t| / sqrt(v_t) <=
    (1 - b1) / sqrt(1 - b2) * sqrt(sum_{j<t} (b1^2 / b2)^j)."""
    b1, b2, total = opt.b1, opt.b2, 0.0
    for t in range(1, opt.count + 1):
        lr = opt.learning_rate * opt.lr_decay ** ((t - 1) // opt.steps_per_epoch)
        ratio = ((1 - b1) / math.sqrt(1 - b2) * math.sqrt(sum((b1 * b1 / b2) ** j for j in range(t)))
                 * math.sqrt(1 - b2 ** t) / (1 - b1 ** t))
        total += lr * (ratio + opt.weight_decay * p_abs)
    return total


def trainer_phase(device, card: str, tmp: str):
    """The shipped recipe through the train CLI on a synthetic corpus: one
    epoch, then a resume for a second; then the other options for one
    epoch. Returns the trainer path's launch counts."""
    import numpy as np
    import torch

    from torch_tts_tpu_torch.cli import vits2_train as cli
    from torch_tts_tpu_torch.core.config import VITS2Config
    from torch_tts_tpu_torch.data.dataset import TextAudioDataset
    from torch_tts_tpu_torch.data.sampler import DistributedBucketSampler
    from torch_tts_tpu_torch.kernels import mas
    from torch_tts_tpu_torch.models.vits2 import model as model_module
    from torch_tts_tpu_torch.train import checkpoint
    from torch_tts_tpu_torch.train.vits2_trainer import BUCKET_BOUNDARIES, build_models
    from torch_tts_tpu_torch.utils.logging_utils import Recorder

    # the port's defaults: TTS_FUSED_WN unset, MAS through its kernel
    os.environ.pop("TTS_FUSED_WN", None)
    model_module.maximum_path = mas.maximum_path
    counters = kernel_counters()
    base = VITS2Config()
    cfg = dataclasses.replace(
        base, data=dataclasses.replace(base.data, text_cleaners=("transliteration_cleaners",)))
    corpus = os.path.join(tmp, "corpus")
    t0 = time.perf_counter()
    write_corpus(corpus, TRAINER_CLIPS, cfg.audio.sampling_rate)
    full = TextAudioDataset.from_ljspeech(corpus, cfg.audio, cfg.data)
    train_items, eval_items = cli.split_train_val(full.items, 100, 1234)
    lengths = TextAudioDataset(train_items, cfg.audio, cfg.data).lengths
    spe = len(DistributedBucketSampler(lengths, cfg.train.batch_size, BUCKET_BOUNDARIES))
    buckets = {b: sum(lo < n <= b for n in lengths)
               for lo, b in zip(BUCKET_BOUNDARIES, BUCKET_BOUNDARIES[1:])}
    log(f"trainer phase: {TRAINER_CLIPS} clips of {TRAINER_SECONDS[0]}-{TRAINER_SECONDS[1]} s "
        f"written in {time.perf_counter() - t0:.1f} s; {len(train_items)} train, "
        f"{len(eval_items)} eval; train items per bucket {dict((b, n) for b, n in buckets.items() if n)}; "
        f"{spe} steps an epoch at batch {cfg.train.batch_size}")
    if spe < 2 or tuple(b for b, n in buckets.items() if n) != TRAINER_FRAMES:
        raise RuntimeError(f"the corpus does not fill the buckets {TRAINER_FRAMES}, whose shapes "
                           f"the kernel phase checks")

    def write_config(name, **changes):
        train = {**dataclasses.asdict(cfg.train), "log_interval": 1, "eval_interval": spe,
                 **changes.pop("train", {})}
        raw = {"model": {**dataclasses.asdict(cfg.model), **changes.pop("model", {})},
               "data": {**dataclasses.asdict(cfg.data), **dataclasses.asdict(cfg.audio)},
               "train": train}
        path = os.path.join(tmp, name)
        with open(path, "w") as f:
            json.dump(raw, f)
        return path

    writers = []

    def recorder(log_dir):
        writers.append(Recorder())
        return writers[-1]

    def run(config, run_dir, epochs):
        writers.clear()
        for c in counters.values():
            c.launches = 0
        tr = cli.main(["-c", config, "-m", run_dir, "--data-root", corpus, "--epochs",
                       str(epochs), "--device", str(device)], make_writer=recorder)
        torch.cuda.synchronize()
        counts = {n: c.launches for n, c in counters.items()}
        logged = [(tag, s, v) for w in writers for tag, vals in w.scalars.items()
                  for s, v in vals]
        bad = [x for x in logged if not math.isfinite(x[2])
               or (x[0] in ("nonfinite", "perf/nonfinite_skipped") and x[2] != 0.0)]
        if bad or not logged:
            raise RuntimeError(f"non-finite or skipped steps in the log: {bad[:5]}")
        return tr, counts, writers[0].scalars

    def report(counts, scalars, what, steps):
        # log_interval 1: each logged window is one step
        by_bucket = {int(tag.rsplit("/", 1)[1]): [v for _, v in vals]
                     for tag, vals in scalars.items() if tag.startswith("perf/step_ms/")}
        load_ms = [v for _, v in scalars["perf/load_ms"]]
        sps = [v for _, v in scalars["perf/steps_per_s"]]
        log(f"  {what}: {steps} steps; launches {counts} "
            f"({', '.join(f'{n} {c / steps:.1f}' for n, c in counts.items())} a step); "
            f"steps/s median {statistics.median(sps):.3f} (each logged step {', '.join(f'{v:.2f}' for v in sps)}); "
            f"step ms median by bucket "
            + ", ".join(f"{pad} frames {statistics.median(v):.1f} (n={len(v)})"
                        for pad, v in sorted(by_bucket.items()))
            + f"; batch loading ms median {statistics.median(load_ms):.1f} [{card}]")
        last = {k: v[-1][1] for k, v in scalars.items()}
        log("    last logged: " + ", ".join(f"{k}={v:.4f}" for k, v in last.items()))

    # --- run 1: the shipped recipe, one epoch, then a resume for a second
    cfg1 = write_config("recipe.json")
    run1 = os.path.join(tmp, "run_recipe")
    t0 = time.perf_counter()
    tr, counts, scalars = run(cfg1, run1, 1)
    log(f"  run 1, epoch 1: {time.perf_counter() - t0:.1f} s with the data's first pass, "
        f"evaluate() and the checkpoint")
    if tr.state.step != spe:
        raise RuntimeError(f"epoch 1 ended at step {tr.state.step}, not {spe}")
    if tr.pad_text != TRAINER_TX:
        raise RuntimeError(f"the trainer pads text to {tr.pad_text} ids, not the {TRAINER_TX} "
                           f"that the kernel phase checks")
    launches = dict(counts)
    if not all(launches.values()):
        raise RuntimeError(f"a kernel of the trainer path did not launch: {launches}")
    report(counts, scalars, "run 1, epoch 1", spe)
    eval_scalars = {k: v[-1][1] for k, v in writers[1].scalars.items()}
    log(f"  evaluate(): {tr.eval_s:.2f} s (eval_step on {len(eval_items)} items, then infer at "
        f"max_frames {tr.eval_max_frames}): {eval_scalars}; audio "
        f"{[a[0][1].shape for a in writers[1].audios.values()]} [{card}]")
    path = checkpoint.latest_checkpoint(run1)
    saved = checkpoint.load_file(path)
    bad = tree_mismatches(saved, checkpoint.state_tree(tr.state))
    if bad or not path.endswith(f"ckpt_{spe}.pt"):
        raise RuntimeError(f"the checkpoint {path} does not hold the state: {bad[:5]}")
    log(f"  checkpoint {os.path.basename(path)}: {tr.ckpt.last_bytes} bytes; host copy "
        f"{tr.ckpt.last_copy_s:.3f} s, then the write {tr.ckpt.last_write_s:.3f} s (background) "
        f"[{card}]")
    del tr, saved
    torch.cuda.empty_cache()

    restore = checkpoint.restore_checkpoint
    restored = {}

    def checked_restore(path, state, lenient=True):
        out = restore(path, state, lenient)
        restored["step"] = state.step
        restored["mismatches"] = tree_mismatches(checkpoint.state_tree(state),
                                                 checkpoint.load_file(path))
        return out

    checkpoint.restore_checkpoint = checked_restore
    try:
        t0 = time.perf_counter()
        tr, counts, scalars = run(cfg1, run1, 2)
    finally:
        checkpoint.restore_checkpoint = restore
    if restored.get("step") != spe or restored["mismatches"]:
        raise RuntimeError(f"the resume did not restore the saved state: {restored}")
    log(f"  run 1, resume: step {restored['step']}, parameters and the three optimizers' "
        f"moments and counts equal to the checkpoint bit for bit -> ok")
    if tr.state.step != 2 * spe:
        raise RuntimeError(f"epoch 2 ended at step {tr.state.step}, not {2 * spe}")
    report(counts, scalars, "run 1, epoch 2 (resumed)", spe)
    for n, c in counts.items():
        launches[n] += c
    del tr
    torch.cuda.empty_cache()
    shutil.rmtree(run1)

    # --- run 2: lightning, dur_disc_2, grad_accum 2, one epoch
    cfg2 = write_config("options.json", train={"step_order": "lightning", "grad_accum": 2},
                        model={"use_duration_discriminator": True,
                               "duration_discriminator_type": "dur_disc_2"})
    run2 = os.path.join(tmp, "run_options")
    tr, counts, scalars = run(cfg2, run2, 1)
    report(counts, scalars, "run 2 (lightning, dur_disc_2, grad_accum 2)", spe)
    for n, c in counts.items():
        launches[n] += c
    for key in ("loss/dur_disc", "grad_norm_dur_disc"):
        if key not in scalars:
            raise RuntimeError(f"run 2 logged no {key}")
    init = build_models(tr.cfg, device=device)
    for name, opt, module in (("G", tr.state.opt_g, init[0]), ("D", tr.state.opt_d, init[1]),
                              ("dur_disc", tr.state.opt_dur, init[2])):
        before = dict(module.named_parameters())
        if (opt.count, opt.mini_step) != (spe // 2, spe % 2):
            raise RuntimeError(f"{name}: {opt.count} updates and {opt.mini_step} micro-steps open "
                               f"after {spe} micro-steps at grad_accum 2")
        moved, worst = 0, 0.0
        for n, p in zip(opt.names, opt.params):
            q = before[n].detach()
            d = float((p.detach() - q).abs().max())
            moved += d > 0
            if name != "G" and d > 0:
                p_abs = max(float(q.abs().max()), float(p.detach().abs().max()))
                # fp32 rounding of each update's sum: a relative 1e-5 and an ulp
                lim = adam_change_bound(opt, p_abs) * (1 + 1e-5) + 2.0 ** -23 * p_abs
                worst = max(worst, d / lim)
                if d > lim:
                    raise RuntimeError(f"{name} {n}: changed by {d:.3e}, more than {opt.count} "
                                       f"Adam updates can make ({lim:.3e})")
        log(f"  run 2 {name}: {moved} of {len(opt.params)} tensors moved, {opt.count} updates"
            + (f"; largest change / the {opt.count}-update Adam bound {worst:.3f}" if name != "G"
               else ""))
        if moved < 0.9 * len(opt.params):
            raise RuntimeError(f"run 2 left most {name} parameters where they were")
    del init

    # --- a second epoch of run 2 with two steps traced (profile_steps):
    # device busy, kernels and the host's waits on the card a step
    first, n_prof = spe + 2, 2
    tr.train(epochs=2, profile_steps=(first, first + n_prof))
    with open(os.path.join(run2, "profile", "trace.json")) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    waits = [e for e in events if e.get("cat") == "cuda_runtime" and e.get("name") in
             ("cudaStreamSynchronize", "cudaMemcpyAsync", "cudaDeviceSynchronize")]
    step_ms = statistics.mean(v for tag, vals in tr.writer.scalars.items()
                              if tag.startswith("perf/step_ms/")
                              for s, v in vals if first < s <= first + n_prof)
    busy = sum(e["dur"] for e in kernels) / 1e3 / n_prof
    wait = sum(e["dur"] for e in waits) / 1e3 / n_prof
    log(f"  run 2 traced steps {first + 1}-{first + n_prof} (profile_steps): {step_ms:.1f} ms a "
        f"step on the host clock (the profiler's cost included), {len(kernels) / n_prof:.0f} "
        f"kernels a step, device busy {busy:.1f} ms a step (idle share {1 - busy / step_ms:.2f}), "
        f"the host waiting on the card in copies to the host and synchronisations "
        f"{wait:.1f} ms a step ({len(waits) / n_prof:.0f} calls) [{card}]")
    if not kernels or busy <= 0:
        raise RuntimeError("the trace of the trainer's steps holds no kernel")
    del tr
    torch.cuda.empty_cache()
    shutil.rmtree(run2)
    log(f"  launch counts on the trainer path (4 epochs, 3 evaluate() calls; run 2's traced "
        f"epoch not counted): {launches}")
    return launches


def multispeaker_config():
    """configs/vits2-multispeaker.yaml as a VITS2Config, built from the
    dataclass defaults (the card has no PyYAML; a CPU test holds the two
    equal)."""
    from torch_tts_tpu_torch.core.config import VITS2Config

    base = VITS2Config()
    return dataclasses.replace(
        base, model=dataclasses.replace(base.model, **MULTISPEAKER),
        data=dataclasses.replace(base.data, text_cleaners=("transliteration_cleaners",),
                                 n_speakers=MULTISPEAKER["n_speakers"]))


def mbistft_config():
    """configs/vits2-ljspeech-mbistft.yaml as a VITS2Config, built from the
    dataclass defaults (the card has no PyYAML; a CPU test holds the two
    equal)."""
    from torch_tts_tpu_torch.core.config import VITS2Config

    base = VITS2Config()
    return dataclasses.replace(
        base, model=dataclasses.replace(base.model, **MBISTFT),
        data=dataclasses.replace(base.data, text_cleaners=("transliteration_cleaners",))).check()


def seeded_synthesizer(cfg, device, seed: int = 0):
    """build_synthesizer's seeded model, with small seeded weights in the
    flows' zero-initialised output convs, which would otherwise make the
    flows' WN stacks irrelevant to the audio and give them no gradient."""
    import torch

    from torch_tts_tpu_torch.models.vits2 import build_synthesizer
    from torch_tts_tpu_torch.text import symbols

    model = build_synthesizer(cfg, len(symbols), seed=seed, device=device)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for flow in (f for f in model.flow.flows if hasattr(f, "post")):
            flow.post.weight.copy_(torch.randn(flow.post.weight.shape, generator=g) * 0.02)
    return model


@contextlib.contextmanager
def conditioned_wn_forwards():
    """Counts, while open, the WN forward kernel's launches that take a
    per-layer conditioning gl ("gl"), and of those the saving ones, each of
    which the backward kernel follows with its d_gl ("gl_saving"). Wraps
    `wn_stack._forward_cuda`, the one function that launches the forward
    kernel."""
    from torch_tts_tpu_torch.kernels import wn_stack

    real, counts = wn_stack._forward_cuda, {"gl": 0, "gl_saving": 0}

    def counting(*args, **kw):
        if args[2] is not None:
            counts["gl"] += 1
            counts["gl_saving"] += bool(kw.get("save", False))
        return real(*args, **kw)

    wn_stack._forward_cuda = counting
    try:
        yield counts
    finally:
        wn_stack._forward_cuda = real


def use_model_path(model, path: str):
    """The kernel path is the port's defaults (fuse_mrf on, TTS_FUSED_WN
    unset, MAS through its kernel); the plain path is named (fuse_mrf off,
    TTS_FUSED_WN=0, MAS's plain version)."""
    from torch_tts_tpu_torch.kernels import mas
    from torch_tts_tpu_torch.models.vits2 import model as model_module

    model.dec.fuse_mrf = path == "kernel"
    if path == "kernel":
        os.environ.pop("TTS_FUSED_WN", None)
    else:
        os.environ["TTS_FUSED_WN"] = "0"
    model_module.maximum_path = (mas.maximum_path if path == "kernel"
                                 else mas.maximum_path_via_plain)


def times_in_turns(what: str, fn, model, card: str):
    """Host ms of fn() and its device busy ms on the plain and the kernel
    path, in turns plain, kernel, kernel, plain."""
    times = {}
    for path in ("plain", "kernel", "kernel", "plain"):
        use_model_path(model, path)
        times.setdefault(path, []).append(wall_ms(fn, warmup=1, reps=3))
    for path, ts in times.items():
        use_model_path(model, path)
        log(f"  {what} {path}: {statistics.median(ts):.2f} ms on the host clock "
            f"(turns {', '.join(f'{t:.2f}' for t in ts)}); device busy "
            f"{profile_busy_ms(fn):.2f} ms [{card}]")
    use_model_path(model, "kernel")


def kernel_counters():
    from torch_tts_tpu_torch.kernels import mas
    from torch_tts_tpu_torch.kernels.mrf_fused import mrf_fused
    from torch_tts_tpu_torch.kernels.wn_stack import wn_group, wn_group_backward

    return {"maximum_path": mas.maximum_path, "wn_group": wn_group,
            "wn_group_backward": wn_group_backward, "mrf_fused": mrf_fused}


def counted(fn, counters=None):
    """fn() with every kernel counter (of `counters`, by default
    `kernel_counters()`) set to 0 just before -> (its result, the counts
    just after)."""
    import torch

    counters = counters or kernel_counters()
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {n: c.launches for n, c in counters.items()}


def ms_infer(model, cfg, device, card: str):
    """`infer` with speaker ids at the bench shapes, on the defaults and on
    the plain path; two speakers give different audio."""
    import torch

    hop = cfg.audio.hop_length
    sids = {1: [5], 8: [13 * i for i in range(8)]}

    def run(B, sid=None, seed=None):
        return bench_infer(model, B, device, seed=seed,
                           sid=torch.tensor(sids[B] if sid is None else sid, device=device))

    use_model_path(model, "kernel")
    with conditioned_wn_forwards() as gl:
        outs, launches = counted(lambda: {B: run(B) for B in (1, 8)})
    launches = {n: c for n, c in launches.items() if n in ("mrf_fused", "wn_group")}
    log(f"  infer with sids {sids}: launches {launches}, of which wn_group with a per-layer "
        f"gl {gl['gl']}")
    if not all(launches.values()) or gl["gl"] != launches["wn_group"]:
        raise RuntimeError(f"infer with speakers did not launch its kernels, or a WN forward "
                           f"without gl: {launches}, {gl}")
    use_model_path(model, "plain")
    diffs = {}
    for B in (1, 8):
        audio, _, _, _, y_lengths = run(B)
        check_audio(audio, y_lengths, hop, f"multi-speaker plain B={B}")
        check_audio(outs[B][0], outs[B][4], hop, f"multi-speaker B={B}")
        if not torch.equal(y_lengths, outs[B][4]):
            raise RuntimeError("the plain path gave other durations")
        diff = diffs[B] = float((audio - outs[B][0]).abs().max())
        log(f"  infer B={B}: max |audio_kernel - audio_plain| = {diff:.3e} (bound {AUDIO_ATOL:g}),"
            f" durations equal")
        if diff > AUDIO_ATOL:
            raise RuntimeError("multi-speaker infer: kernel path and plain path disagree")
    use_model_path(model, "kernel")
    other = run(1, sid=[77], seed=1)[0]
    n = min(other.shape[1], outs[1][0].shape[1])
    moved = float((other[:, :n] - outs[1][0][:, :n]).abs().max())
    log(f"  infer B=1, speaker 77 against speaker 5 (the same text and noise): max |d audio| "
        f"{moved:.3e}, against {diffs[1]:.3e} between the kernel and the plain path")
    if not moved > 10 * diffs[1]:
        raise RuntimeError("two speakers gave the same audio, within ten times the kernel path's "
                           "difference from the plain path")
    for B in (1, 8):
        times_in_turns(f"multi-speaker infer B={B} T_x={T_X} max_frames={MAX_FRAMES}",
                       lambda B=B: run(B), model, card)
    return launches


def ms_voice_conversion(model, cfg, device, card: str):
    """`voice_conversion` at B=MS_VC_B, T_y=MS_VC_TY (full lengths: the
    decode runs unmasked, through the MRF kernel) on both paths."""
    import torch

    g = torch.Generator().manual_seed(7)
    y = (torch.randn(MS_VC_B, MS_VC_TY, cfg.posterior_channels, generator=g) - 4).to(device)
    yl = torch.full((MS_VC_B,), MS_VC_TY, device=device)
    src, tgt = torch.tensor([3, 40], device=device), torch.tensor([90, 7], device=device)

    def run():
        return model.voice_conversion(y, yl, src, tgt,
                                      generator=torch.Generator(device=device).manual_seed(3))

    use_model_path(model, "kernel")
    with conditioned_wn_forwards() as gl:
        out, launches = counted(run)
    launches = {n: c for n, c in launches.items() if n in ("mrf_fused", "wn_group")}
    log(f"  voice_conversion B={MS_VC_B} T_y={MS_VC_TY}: o_hat {tuple(out[0].shape)}; launches "
        f"{launches}, of which wn_group with a per-layer gl {gl['gl']}")
    if not all(launches.values()) or gl["gl"] != launches["wn_group"]:
        raise RuntimeError(f"voice conversion did not launch its kernels with gl: {launches}")
    use_model_path(model, "plain")
    ref = run()
    use_model_path(model, "kernel")
    for name, a, b in (("o_hat", out[0], ref[0]), ("z_hat", out[2][2], ref[2][2]),
                       ("z_p", out[2][1], ref[2][1])):
        diff = float((a - b).abs().max())
        log(f"  voice_conversion {name}: max |kernel - plain| = {diff:.3e} (bound {AUDIO_ATOL:g})")
        if not bool(torch.isfinite(a).all()) or diff > AUDIO_ATOL:
            raise RuntimeError(f"voice conversion {name}: kernel path and plain path disagree")
    times_in_turns(f"voice_conversion B={MS_VC_B} T_y={MS_VC_TY}", run, model, card)
    return launches


def ms_train(cfg, device, card: str):
    """Three full-width `ddp` steps with speaker ids on the kernel path; the
    first of them against one step on the plain path from the same fresh
    state and noise; then step times on both paths."""
    import torch

    from torch_tts_tpu_torch.text import symbols
    from torch_tts_tpu_torch.train.vits2_train import build_mpd, create_train_state, train_step

    hop = cfg.audio.hop_length
    B, T_x, T_y = TRAIN_B, TRAIN_TX, TRAIN_TY
    g = torch.Generator().manual_seed(0)
    batch = {"x": torch.randint(1, len(symbols), (B, T_x), generator=g),
             "x_lengths": torch.full((B,), T_x),
             "spec": torch.randn(B, T_y, cfg.posterior_channels, generator=g),
             "spec_lengths": torch.full((B,), T_y),
             "wav": torch.randn(B, T_y * hop, 1, generator=g) * 0.1,
             "sid": torch.tensor([0, 5, 17, 33, 50, 64, 81, 108])}
    batch = {k: v.to(device) for k, v in batch.items()}

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    def fresh_state(path):
        """A fresh state on `path` whose G optimizer keeps the gradients of
        its first step."""
        st = create_train_state(cfg, seeded_synthesizer(cfg, device),
                                build_mpd(cfg, seed=1, device=device))
        use_model_path(st.model, path)
        grads, step_fn = {}, st.opt_g.step

        def record(gr, apply=True):
            if not grads:
                grads.update(zip(st.opt_g.names, (x.clone() for x in gr)))
            return step_fn(gr, apply)

        st.opt_g.step = record
        return st, grads

    state, gk = fresh_state("kernel")
    with conditioned_wn_forwards() as gl:
        history, launches = counted(lambda: [train_step(cfg, state, batch, generator=gen(i))
                                             for i in range(TRAIN_STEPS)])
    launches = {n: c for n, c in launches.items() if n != "mrf_fused"}
    log(f"  {TRAIN_STEPS} ddp steps B={B} T_x={T_x} T_y={T_y}, sids "
        f"{batch['sid'].tolist()}: launches {launches}; saving WN forwards with gl "
        f"{gl['gl_saving']} (each followed by the backward kernel's d_gl)")
    for i, m in enumerate(history):
        log(f"  step {i}: " + ", ".join(f"{k}={v:.4f}" for k, v in m.items()))
        if m["nonfinite"] or not all(map(math.isfinite, m.values())):
            raise RuntimeError(f"multi-speaker step {i}: non-finite loss or gradient")
    if not all(launches.values()) or gl["gl_saving"] != launches["wn_group_backward"]:
        raise RuntimeError(f"the multi-speaker step did not run its kernels with gl: {launches}, "
                           f"{gl}")

    plain, gp = fresh_state("plain")
    mp, mk = train_step(cfg, plain, batch, generator=gen(0)), history[0]
    del plain
    for key in mk:
        d = abs(mk[key] - mp[key])
        log(f"  step 0 {key}: kernel {mk[key]:.6f} plain {mp[key]:.6f} |d|={d:.3e}")
        if key.startswith("loss") and d > LOSS_RTOL * abs(mp[key]) + LOSS_ATOL:
            raise RuntimeError(f"multi-speaker {key}: kernel path and plain path disagree")
    rows = (gk["emb_g.weight"].abs().sum(1) > 0).nonzero().flatten().tolist()
    log(f"  emb_g rows with a gradient: {rows}")
    if rows != sorted(batch["sid"].tolist()):
        raise RuntimeError("emb_g's gradient is not on the rows of the batch's speakers")
    grad_compare("emb_g gradient, kernel vs plain", gk["emb_g.weight"], gp["emb_g.weight"])
    for n in ("enc_p.encoder.spk_emb_linear.weight", "dec.cond.weight",
              "enc_q.enc.cond_layer.weight_v", "flow.flows.0.enc.cond_layer.weight_v"):
        d, ref = float((gk[n] - gp[n]).abs().max()), float(gp[n].abs().max())
        log(f"  {n} gradient: max |kernel - plain| {d:.3e}, max |plain| {ref:.3e}")
    del gk, gp
    times = {}
    for path in ("plain", "kernel", "kernel", "plain"):
        use_model_path(state.model, path)
        times.setdefault(path, []).append(
            wall_ms(lambda: train_step(cfg, state, batch, generator=gen(7)), warmup=0, reps=1))
    use_model_path(state.model, "kernel")
    busy = profile_busy_ms(lambda: train_step(cfg, state, batch, generator=gen(7)))
    for path, ts in times.items():
        log(f"  multi-speaker train step B={B} T_y={T_y} {path}: {statistics.median(ts):.1f} "
            f"ms/step on the host clock (turns {', '.join(f'{t:.1f}' for t in ts)})"
            + (f"; device busy {busy:.1f} ms/step" if path == "kernel" else "") + f" [{card}]")
    del state
    torch.cuda.empty_cache()
    return launches


def ms_trainer(cfg, device, card: str, tmp: str):
    """The multi-speaker recipe through the train CLI on a synthetic corpus
    of MS_TRAINER_SPEAKERS speakers in the `audio|sid|text` filelist form:
    one epoch, then a resume for a second, checked bit for bit."""
    import torch

    from torch_tts_tpu_torch.cli import vits2_train as cli
    from torch_tts_tpu_torch.data.dataset import TextAudioDataset
    from torch_tts_tpu_torch.data.sampler import DistributedBucketSampler
    from torch_tts_tpu_torch.train import checkpoint
    from torch_tts_tpu_torch.train.vits2_trainer import BUCKET_BOUNDARIES
    from torch_tts_tpu_torch.utils.logging_utils import Recorder

    corpus = os.path.join(tmp, "ms_corpus")
    write_corpus(corpus, MS_TRAINER_CLIPS, cfg.audio.sampling_rate, seed=1)
    with open(os.path.join(corpus, "metadata.csv")) as f:
        rows = [line.split("|") for line in f.read().splitlines()]
    filelist = os.path.join(corpus, "filelist.txt")
    with open(filelist, "w") as f:
        f.write("\n".join(f"{os.path.join(corpus, 'wavs', r[0] + '.wav')}|"
                          f"{i % MS_TRAINER_SPEAKERS}|{r[1]}" for i, r in enumerate(rows)))
    # one evaluate() and checkpoint an epoch: the CLI's split, the sampler's steps
    full = TextAudioDataset.from_filelist(filelist, cfg.audio, cfg.data)
    train_items, _ = cli.split_train_val(full.items, 100, 1234)
    spe = len(DistributedBucketSampler(TextAudioDataset(train_items, cfg.audio, cfg.data).lengths,
                                       cfg.train.batch_size, BUCKET_BOUNDARIES))
    config = os.path.join(tmp, "multispeaker.json")
    with open(config, "w") as f:
        json.dump({"model": dataclasses.asdict(cfg.model),
                   "data": {**dataclasses.asdict(cfg.data), **dataclasses.asdict(cfg.audio)},
                   "train": {**dataclasses.asdict(cfg.train), "log_interval": 1,
                             "eval_interval": spe}}, f)
    run_dir = os.path.join(tmp, "run_ms")
    writers = []

    def recorder(log_dir):
        writers.append(Recorder())
        return writers[-1]

    def run(epochs):
        writers.clear()
        tr, counts = counted(lambda: cli.main(
            ["-c", config, "-m", run_dir, "--filelist", filelist, "--epochs", str(epochs),
             "--device", str(device)], make_writer=recorder))
        logged = [(t, v) for t, vals in writers[0].scalars.items() for _, v in vals]
        if not logged or not all(math.isfinite(v) for _, v in logged):
            raise RuntimeError("non-finite losses in the multi-speaker trainer's log")
        sps = [v for _, v in writers[0].scalars["perf/steps_per_s"]]
        log(f"  trainer to epoch {epochs} ({spe} steps an epoch, step {tr.state.step}): launches "
            f"{counts}; steps/s {', '.join(f'{v:.2f}' for v in sps)}; evaluate() "
            f"{tr.eval_s:.2f} s [{card}]")
        return tr, counts

    t0 = time.perf_counter()
    tr, launches = run(1)
    if tr.state.step != spe or spe < 1 or tr.cfg.model.n_speakers != MULTISPEAKER["n_speakers"]:
        raise RuntimeError(f"the multi-speaker trainer took {tr.state.step} steps, not {spe}")
    path = checkpoint.latest_checkpoint(run_dir)
    saved = checkpoint.load_file(path)
    if "emb_g.weight" not in saved["model"] or tree_mismatches(
            saved, checkpoint.state_tree(tr.state)):
        raise RuntimeError(f"the checkpoint {path} does not hold the multi-speaker state")
    del tr, saved
    restore, restored = checkpoint.restore_checkpoint, {}

    def checked_restore(p, state, lenient=True):
        out = restore(p, state, lenient)
        restored["step"] = state.step
        restored["mismatches"] = tree_mismatches(checkpoint.state_tree(state),
                                                 checkpoint.load_file(p))
        return out

    checkpoint.restore_checkpoint = checked_restore
    try:
        tr, counts = run(2)
    finally:
        checkpoint.restore_checkpoint = restore
    if restored.get("step") != spe or restored["mismatches"] or tr.state.step != 2 * spe:
        raise RuntimeError(f"the multi-speaker resume did not restore the saved state: {restored}")
    log(f"  trainer resume at step {spe}: parameters (emb_g included) and moments equal to the "
        f"checkpoint bit for bit -> ok; {time.perf_counter() - t0:.1f} s for both runs")
    for n, c in counts.items():
        launches[n] += c
    if not all(launches.values()):
        raise RuntimeError(f"a kernel of the multi-speaker trainer did not launch: {launches}")
    del tr
    torch.cuda.empty_cache()
    return launches


def narrow_defaults(device, card: str):
    """Fault 1's card check: a VITS2 narrower than the kernels take in
    places (hidden 128: no WN kernel; upsample_initial_channel 256: a
    16-channel decoder stage) runs `infer` and one train step on the card's
    defaults, and matches the plain path."""
    import torch

    from torch_tts_tpu_torch.core.config import VITS2Config
    from torch_tts_tpu_torch.text import symbols
    from torch_tts_tpu_torch.train.vits2_train import build_mpd, create_train_state, train_step

    base = VITS2Config()
    cfg = dataclasses.replace(base, model=dataclasses.replace(base.model, **NARROW))
    model = seeded_synthesizer(cfg, device)
    g = torch.Generator().manual_seed(5)
    x = torch.randint(1, len(symbols), (2, 128), generator=g).to(device)
    xl = torch.tensor([128, 97], device=device)

    def infer():
        return model.infer(x, xl, noise_scale=0.667, noise_scale_w=0.8, max_frames=512,
                           generator=torch.Generator(device=device).manual_seed(0))

    use_model_path(model, "kernel")
    out, launches = counted(infer)
    use_model_path(model, "plain")
    ref = infer()
    use_model_path(model, "kernel")
    diff = float((out[0] - ref[0]).abs().max())
    log(f"  narrow VITS2 {NARROW}, infer B=2 on the defaults: launches {launches}; max "
        f"|audio_defaults - audio_plain| {diff:.3e} (bound {AUDIO_ATOL:g})")
    if (not torch.equal(out[4], ref[4]) or diff > AUDIO_ATOL or launches["mrf_fused"] == 0
            or launches["wn_group"]):
        raise RuntimeError("the narrow model's defaults did not take the kernels the gates allow, "
                           "or disagree with the plain path")
    del model
    B, T_x, T_y = 4, 96, 400
    batch = {"x": torch.randint(1, len(symbols), (B, T_x), generator=g),
             "x_lengths": torch.tensor([96, 90, 80, 70]),
             "spec": torch.randn(B, T_y, cfg.posterior_channels, generator=g),
             "spec_lengths": torch.tensor([400, 380, 350, 300]),
             "wav": torch.randn(B, T_y * cfg.audio.hop_length, 1, generator=g) * 0.1}
    res = {}
    for path in ("kernel", "plain"):
        model = seeded_synthesizer(cfg, device)
        use_model_path(model, path)
        st = create_train_state(cfg, model, build_mpd(cfg, seed=1, device=device))
        res[path], counts = counted(lambda: train_step(
            cfg, st, batch, generator=torch.Generator(device=device).manual_seed(1)))
        if path == "kernel":
            log(f"  narrow VITS2 train step B={B} T_y={T_y} on the defaults: launches {counts}")
            if counts["maximum_path"] != 1 or counts["wn_group"]:
                raise RuntimeError(f"the narrow train step's kernels: {counts}")
            launches = {n: c + counts[n] for n, c in launches.items()}
        del st, model
    for key in res["kernel"]:
        d = abs(res["kernel"][key] - res["plain"][key])
        if key.startswith("loss") and d > LOSS_RTOL * abs(res["plain"][key]) + LOSS_ATOL:
            raise RuntimeError(f"narrow train step {key}: the defaults and the plain path disagree")
    log(f"  narrow train step: every loss term within {LOSS_RTOL:g} * |plain| + {LOSS_ATOL:g} of "
        f"the plain path's (loss/g/total {res['kernel']['loss/g/total']:.6f} against "
        f"{res['plain']['loss/g/total']:.6f}) [{card}]")
    torch.cuda.empty_cache()
    return launches


def multispeaker_phase(device, card: str, tmp: str):
    """The multi-speaker model at the full width of
    configs/vits2-multispeaker.yaml, seeded: infer, voice conversion, three
    train steps, the trainer through its CLI; then fault 1's card check.
    Returns the path's launch counts (each part counted on its own)."""
    cfg = multispeaker_config()
    t0 = time.perf_counter()
    model = seeded_synthesizer(cfg, device)
    log(f"multi-speaker phase: {MULTISPEAKER}, {sum(p.numel() for p in model.parameters())} "
        f"params, seeded init {time.perf_counter() - t0:.1f} s")
    parts = [ms_infer(model, cfg, device, card), ms_voice_conversion(model, cfg, device, card)]
    del model
    parts += [ms_train(cfg, device, card), ms_trainer(cfg, device, card, tmp),
              narrow_defaults(device, card)]
    launches = {}
    for p in parts:
        for n, c in p.items():
            launches[n] = launches.get(n, 0) + c
    log(f"  launch counts on the multi-speaker path: {launches}")
    return launches


def serving_kernel_checks(model, buckets, tiers, device, card: str):
    """The MRF bank (the decoder's stages the kernel takes, with the model's
    weights) and the flows' WN group forward against their plain versions
    at the largest shape of the serving path (the top tier at the largest
    bucket's frames) and the smallest (the stream's B=1 window for the bank;
    B=1 at the smallest bucket for the WN), with their times."""
    import torch

    with torch.no_grad():  # the model's weights need no gradient here
        _serving_kernel_checks(model, buckets, tiers, device, card)
    torch.cuda.empty_cache()


def _serving_kernel_checks(model, buckets, tiers, device, card: str):
    import torch

    from torch_tts_tpu_torch.kernels import mrf_fused as mrf_kernel
    from torch_tts_tpu_torch.kernels.wn_stack import wn_group, wn_group_plain

    g = torch.Generator().manual_seed(12)
    dec, nk = model.dec, model.dec.num_kernels
    window = STREAM_CHUNK + 2 * STREAM_CONTEXT
    checked = 0
    for B, frames in ((max(tiers), buckets[-1][1]), (1, window)):
        T = frames
        for i, u in enumerate(dec.upsample_rates):
            T *= u
            bank = dec.resblocks[i * nk:(i + 1) * nk]
            C = bank[0].channels
            if not mrf_kernel.supports(C, dec.max_taps):
                continue
            blocks = tuple(block.kernels() for block in bank)
            x = (torch.randn(B, T, C, generator=g) * 0.5).to(device)
            compare(f"serving mrf_fused B={B} T={T} C={C}", mrf_kernel.mrf_fused(x, blocks),
                    mrf_kernel.mrf_plain(x, blocks))
            t_k = cuda_ms(lambda: mrf_kernel.mrf_fused(x, blocks), warmup=1, reps=3)
            t_p = cuda_ms(lambda: mrf_kernel.mrf_plain(x, blocks), warmup=1, reps=3)
            log(f"  serving mrf_fused B={B} T={T} C={C}: kernel {t_k:.3f} ms, plain "
                f"{t_p:.3f} ms [{card}]")
            checked += 1
            del x
    wn = model.flow.flows[0].enc
    w_in, b_in, w_rs, b_rs = wn.fused_weights()
    for B, T in ((max(tiers), buckets[-1][1]), (1, buckets[0][1])):
        lengths = torch.tensor([T - 97 * i for i in range(B)])
        mask = (torch.arange(T)[None, :] < lengths[:, None]).float()[:, :, None].to(device)
        x = torch.randn(B, T, wn.hidden_channels, generator=g).to(device)
        args = (x, mask, None, w_in, b_in, w_rs, b_rs)
        for n, o, r in zip(("x_out", "skip"), wn_group(*args), wn_group_plain(*args)):
            compare(f"serving wn_group B={B} T={T} {n}", o, r)
        t_k = cuda_ms(lambda: wn_group(*args), warmup=1, reps=3)
        t_p = cuda_ms(lambda: wn_group_plain(*args), warmup=1, reps=3)
        log(f"  serving wn_group B={B} T={T}: kernel {t_k:.3f} ms, plain {t_p:.3f} ms [{card}]")
    if device.type == "cuda" and not checked:
        raise RuntimeError("no decoder stage of the serving model takes the MRF kernel")


def serving_results_agree(what: str, got, want, atol: float):
    """Per request: the same length, samples within atol."""
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if len(a.audio) != len(b.audio) or not len(a.audio):
            raise RuntimeError(f"{what}: request {i} has {len(a.audio)} samples, "
                               f"against {len(b.audio)}")
        worst = max(worst, float(abs(a.audio - b.audio).max()))
    log(f"  {what}: lengths equal, max |d audio| {worst:.3e} (bound {atol:g})")
    if worst > atol:
        raise RuntimeError(f"{what}: audio disagrees")
    return worst


def serving_batcher_load(synth, ms_synth, texts, card: str):
    """BATCHER_REQUESTS requests from BATCHER_THREADS threads at zero noise
    scales, BATCHER_SID_REQUESTS of them with a speaker id through the
    multi-speaker model's batcher; each against the serial synthesize of
    its text."""
    import threading

    from torch_tts_tpu_torch.infer.serving import ContinuousBatcher

    zero = dict(noise_scale=0.0, noise_scale_w=0.0)
    jobs = [(texts[i % len(texts)], None if i >= BATCHER_SID_REQUESTS else 7 * i + 1)
            for i in range(BATCHER_REQUESTS)]
    serial = {t: synth.synthesize([t], **zero)[0] for t in texts}
    ms_serial = {(t, sid): ms_synth.synthesize([t], sid=[sid], **zero)[0]
                 for t, sid in jobs if sid is not None}
    futures = [None] * len(jobs)
    with ContinuousBatcher(synth) as batcher, ContinuousBatcher(ms_synth) as ms_batcher:
        def submit(k):
            for i in range(k, len(jobs), BATCHER_THREADS):
                t, sid = jobs[i]
                b = batcher if sid is None else ms_batcher
                futures[i] = b.submit(t, sid=sid, seed=i, **zero)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=submit, args=(k,)) for k in range(BATCHER_THREADS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        results = [f.result(timeout=600) for f in futures]
        wall = time.perf_counter() - t0
        stats, ms_stats = batcher.stats(), ms_batcher.stats()
    want = [serial[t] if sid is None else ms_serial[(t, sid)] for t, sid in jobs]
    serving_results_agree("batcher results against serial synthesize", results, want,
                          AUDIO_ATOL)
    n = stats["batched_requests_total"] + ms_stats["batched_requests_total"]
    failures = stats["failures_total"] + ms_stats["failures_total"]
    audio_s = sum(len(r.audio) for r in results) / synth.cfg.audio.sampling_rate
    log(f"  batcher: {len(jobs)} requests from {BATCHER_THREADS} threads ({BATCHER_SID_REQUESTS} "
        f"with a speaker id): {stats['batches_total']} + {ms_stats['batches_total']} batches, "
        f"{n} batched, {failures} failures; {wall:.3f} s, {len(jobs) / wall:.2f} requests/s, "
        f"{audio_s / wall:.2f} audio s/s on the host clock; stats {stats} [{card}]")
    if failures or n != len(jobs):
        raise RuntimeError(f"batcher: {failures} failures, {n} of {len(jobs)} requests batched")


def serving_stream(synth, synth32, model, card: str):
    """stream() in the (256, 1344) bucket: its time to first chunk and
    total, with the windows that the host's length allows decoded unmasked
    and with every window masked; the concatenation against the bucketed
    decode at tier 1."""
    import numpy as np
    import torch

    from torch_tts_tpu_torch.infer.streaming import StreamingDecoder

    enc = synth.encode_text(STREAM_TEXT)
    bucket = synth._bucket_for(len(enc))
    log(f"  stream text: {len(enc)} ids, bucket {bucket}")
    synth.warmup_streaming(STREAM_CHUNK, STREAM_CONTEXT, buckets=[bucket])

    def run():
        t0 = time.perf_counter()
        first, pieces = None, []
        for a in synth.stream(STREAM_TEXT, STREAM_CHUNK, STREAM_CONTEXT, seed=3,
                              length_scale=STREAM_LENGTH_SCALE):
            pieces.append(a)
            if first is None:
                first = time.perf_counter() - t0
        return np.concatenate(pieces), first * 1e3, (time.perf_counter() - t0) * 1e3, len(pieces)

    audio, ttfc, total, n = run()
    audio, ttfc2, total2, _ = run()
    secs = len(audio) / synth.cfg.audio.sampling_rate
    log(f"  stream: {secs:.2f} s of audio in {n} chunks of {STREAM_CHUNK} frames (context "
        f"{STREAM_CONTEXT}); first chunk {ttfc:.2f}, {ttfc2:.2f} ms; whole stream {total:.2f}, "
        f"{total2:.2f} ms on the host clock [{card}]")

    # the decoder's windows alone, every window masked against the host's rule
    x = torch.zeros(1, bucket[0], dtype=torch.int64)
    x[0, :len(enc)] = torch.tensor(enc)
    z, g, y_mask, y_lengths = model.infer_latents(
        x.to(synth.device), torch.tensor([len(enc)], device=synth.device), noise_scale=0.667,
        noise_scale_w=0.8, length_scale=STREAM_LENGTH_SCALE, max_frames=bucket[1],
        generator=torch.Generator(device=synth.device).manual_seed(3))
    n_frames = int(y_lengths[0])
    sd = StreamingDecoder(model, STREAM_CHUNK, STREAM_CONTEXT)
    for name, lengths in (("unmasked where full", [n_frames]), ("all masked", None),
                          ("unmasked where full", [n_frames]), ("all masked", None)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        it = sd.stream(z, g, y_mask, lengths=lengths)
        next(it)[0, :, 0].cpu()
        first = (time.perf_counter() - t0) * 1e3
        for _ in range(-(-n_frames // STREAM_CHUNK) - 1):
            next(it)[0, :, 0].cpu()
        log(f"  stream windows {name}: first window {first:.2f} ms, the utterance's "
            f"{-(-n_frames // STREAM_CHUNK)} windows {(time.perf_counter() - t0) * 1e3:.2f} ms "
            f"on the host clock [{card}]")
    for name, lengths in (("unmasked where full", [n_frames]), ("all masked", None)):
        busy = profile_busy_ms(lambda: next(sd.stream(z, g, y_mask, lengths=lengths)).cpu())
        log(f"  stream first window {name}: device busy {busy:.2f} ms [{card}]")

    for path, atol in (("kernel", AUDIO_ATOL), ("plain", STREAM_ATOL)):
        use_model_path(model, path)
        streamed = np.concatenate(list(synth32.stream(
            STREAM_TEXT, STREAM_CHUNK, STREAM_CONTEXT, seed=3, length_scale=STREAM_LENGTH_SCALE)))
        whole = synth32.synthesize([STREAM_TEXT], seed=3,
                                   length_scale=STREAM_LENGTH_SCALE)[0].audio
        if streamed.shape != whole.shape:
            raise RuntimeError(f"stream {path}: {streamed.shape} samples against {whole.shape}")
        diff = float(abs(streamed - whole).max())
        log(f"  stream on the {path} path against synthesize at tier 1 on it: max |d audio| "
            f"{diff:.3e} (bound {atol:g})")
        if diff > atol:
            raise RuntimeError(f"stream on the {path} path disagrees with synthesize")
    use_model_path(model, "kernel")


def serving_webui(synth, texts, card: str):
    """make_server on 127.0.0.1:0: one /tts_stream while BATCHER_THREADS
    /tts requests load the batcher, then /tts, /tts_stream and /metrics."""
    import threading
    import urllib.parse
    import urllib.request

    import numpy as np

    from torch_tts_tpu_torch.cli import webui

    server, batcher = webui.make_server(synth, port=0, host="127.0.0.1",
                                       stream_chunks=(STREAM_CHUNK,))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"

    def get(path, **q):
        with urllib.request.urlopen(f"{url}{path}?{urllib.parse.urlencode(q)}",
                                    timeout=600) as r:
            return r.status, r.read()

    try:
        out = {}

        def load(k):
            out[k] = get("/tts", text=texts[k % len(texts)], seed=k)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=load, args=(k,)) for k in range(BATCHER_THREADS)]
        for th in threads:
            th.start()
        out["stream"] = get("/tts_stream", text=STREAM_TEXT, seed=3, chunk=STREAM_CHUNK,
                            length=STREAM_LENGTH_SCALE)
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0
        if any(code != 200 for code, _ in out.values()):
            raise RuntimeError(f"web UI: statuses {[c for c, _ in out.values()]}")
        pcm = np.frombuffer(out["stream"][1], "<i2").astype(np.float32) / 32767
        want = np.concatenate(list(synth.stream(STREAM_TEXT, STREAM_CHUNK, STREAM_CONTEXT,
                                                seed=3, length_scale=STREAM_LENGTH_SCALE)))
        diff = float(abs(pcm - want).max()) if pcm.shape == want.shape else float("inf")
        log(f"  web UI: {BATCHER_THREADS} /tts and one /tts_stream at once in {wall:.3f} s; "
            f"the stream's PCM against a serial stream: max |d| {diff:.3e} (bound "
            f"{AUDIO_ATOL:g} + one 16-bit step) [{card}]")
        if diff > AUDIO_ATOL + 1 / 32767:
            raise RuntimeError("web UI: /tts_stream under load disagrees with a serial stream")
        code, wav = get("/tts", text=texts[0])
        if code != 200 or wav[:4] != b"RIFF":
            raise RuntimeError("web UI: /tts did not give a WAV")
        code, metrics = get("/metrics")
        values = dict(line.split() for line in metrics.decode().splitlines()
                      if not line.startswith("#"))
        log(f"  web UI /metrics: {values}")
        if values["tts_failures_total"] != "0" or int(values["tts_requests_total"]) != (
                BATCHER_THREADS + 1):
            raise RuntimeError(f"web UI: /metrics {values}")
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
        thread.join(timeout=60)


def serving_phase(device, card: str, tmp: str):
    """The serving layer on the full-width LJSpeech VITS2 (seeded as the
    inference phase's): the (tier, bucket) grid's warm-up, `synthesize` on
    the kernel and the plain path, the ContinuousBatcher under concurrent
    load, `stream()`, `synthesize_long` and the web UI. Returns the path's
    launch counts."""
    import numpy as np
    import torch

    from torch_tts_tpu_torch.core.config import VITS2Config
    from torch_tts_tpu_torch.infer import serving

    base = VITS2Config()
    cfg = dataclasses.replace(
        base, data=dataclasses.replace(base.data, text_cleaners=("transliteration_cleaners",)))
    os.environ.pop("TTS_FUSED_WN", None)
    t0 = time.perf_counter()
    model = seeded_synthesizer(cfg, device)
    buckets = SERVING_BUCKETS or serving.DEFAULT_BUCKETS
    tiers = serving.DEFAULT_BATCH_TIERS
    synth = serving.Synthesizer(cfg, model, buckets=buckets, batch_tiers=tiers, device=device)
    synth32 = serving.Synthesizer(cfg, model, buckets=buckets, batch_tiers=tiers,
                                  transfer_dtype="float32", device=device)
    log(f"serving phase: buckets {list(buckets)}, tiers {list(tiers)}, seeded init "
        f"{time.perf_counter() - t0:.1f} s")
    in_buckets = sorted({synth._bucket_for(len(synth.encode_text(t))) for t in SERVING_TEXTS})
    if in_buckets != sorted(buckets):
        raise RuntimeError(f"the serving texts fill buckets {in_buckets}, not {list(buckets)}")
    serving_kernel_checks(model, buckets, tiers, device, card)

    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    # 1. the grid's warm-up: each cell's first and second host time, device busy
    for b in buckets:
        for t in tiers:
            first = wall_ms(lambda: synth.warmup(tiers=[t], buckets=[b]), warmup=0, reps=1)
            again = wall_ms(lambda: synth.warmup(tiers=[t], buckets=[b]), warmup=0, reps=1)
            busy = profile_busy_ms(lambda: synth.warmup(tiers=[t], buckets=[b]))
            log(f"  warm-up tier {t} bucket {b}: first {first:.2f} ms, again {again:.2f} ms on "
                f"the host clock; device busy {busy:.2f} ms [{card}]")
    # the one-deep pipeline: dispatch returns before the device has run the group
    t = time.perf_counter()
    h = synth._dispatch_group([[1]] * max(tiers), (0.667, 1.0, 0.8), 0, bucket=buckets[-1])
    t_dispatch = time.perf_counter() - t
    synth._collect_group(h)
    log(f"  tier {max(tiers)} bucket {buckets[-1]}: _dispatch_group returned after "
        f"{t_dispatch * 1e3:.2f} ms, _collect_group after {(time.perf_counter() - t) * 1e3:.2f} "
        f"ms on the host clock [{card}]")
    # 2. synthesize on both paths
    results = {}
    for path in ("kernel", "plain"):
        use_model_path(model, path)
        t = time.perf_counter()
        results[path] = synth.synthesize(SERVING_TEXTS, seed=5)
        torch.cuda.synchronize()
        log(f"  synthesize {len(SERVING_TEXTS)} texts, {path} path: "
            f"{(time.perf_counter() - t) * 1e3:.2f} ms on the host clock [{card}]")
        for r in results[path]:
            if not len(r.audio) or not np.isfinite(r.audio).all():
                raise RuntimeError("synthesize: empty or non-finite audio")
    use_model_path(model, "kernel")
    serving_results_agree("synthesize, kernel path against plain path", results["kernel"],
                          results["plain"], AUDIO_ATOL)
    # 3. the batcher under concurrent load, with the multi-speaker model's
    ms_cfg = multispeaker_config()
    ms_synth = serving.Synthesizer(ms_cfg, seeded_synthesizer(ms_cfg, device), buckets=buckets,
                                   batch_tiers=tiers, device=device)
    serving_batcher_load(synth, ms_synth, SERVING_TEXTS, card)
    del ms_synth
    # 4. stream(), 5. synthesize_long, 6. the web UI
    serving_stream(synth, synth32, model, card)
    text = " ".join(SERVING_TEXTS)
    text = (text + " ") * (LONG_CHARS // len(text)) + text[:LONG_CHARS % len(text)]
    t = time.perf_counter()
    r = synth.synthesize_long(text, pause_ms=100.0, seed=2)
    pieces = synth._long_chunks(text)
    log(f"  synthesize_long: {len(text)} characters in {len(pieces)} pieces, "
        f"{len(r.audio) / r.sample_rate:.2f} s of audio in {time.perf_counter() - t:.3f} s on the "
        f"host clock [{card}]")
    if not np.isfinite(r.audio).all() or len(r.audio) <= len(pieces) * 0.1 * r.sample_rate:
        raise RuntimeError("synthesize_long: empty or non-finite audio")
    serving_webui(synth, SERVING_TEXTS, card)
    torch.cuda.synchronize()
    launches = {n: counters[n].launches for n in ("mrf_fused", "wn_group")}
    log(f"  launch counts on the serving path: {launches}")
    if not all(launches.values()):
        raise RuntimeError(f"a kernel of the serving path did not launch: {launches}")
    del synth, synth32, model
    torch.cuda.empty_cache()
    return launches

def mb_rel_diff(a, b) -> float:
    """max |a - b| / max(1, max |b|): the MB-iSTFT audio's yardstick."""
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def mb_infer(model, cfg, device, card: str):
    """`infer` at the bench shapes on the defaults and on the plain path:
    equal durations, audio within AUDIO_ATOL of the plain path's peak; one
    mrf_fused launch (the C=128 stage of the bulk decode; the patch window
    decodes masked) and one wn_group launch a flow per call; times beside
    the HiFi-GAN model's of the inference phase."""
    import torch

    hop = cfg.audio.hop_length

    def run(B):
        return bench_infer(model, B, device)

    use_model_path(model, "kernel")
    outs, launches = counted(lambda: {B: run(B) for B in (1, 8)})
    launches = {n: c for n, c in launches.items() if n in ("mrf_fused", "wn_group")}
    want = {"mrf_fused": 2, "wn_group": 2 * cfg.model.flow_n_flows}
    log(f"  MB-iSTFT infer B=1 and B=8: launches {launches} (expected {want}: per call one "
        f"C=128 bank, one WN group a flow)")
    if launches != want:
        raise RuntimeError(f"MB-iSTFT infer launched {launches}, not {want}")
    use_model_path(model, "plain")
    for B in (1, 8):
        audio, _, _, _, y_lengths = run(B)
        check_audio(audio, y_lengths, hop, f"MB-iSTFT plain B={B}")
        check_audio(outs[B][0], outs[B][4], hop, f"MB-iSTFT B={B}")
        if not torch.equal(y_lengths, outs[B][4]):
            raise RuntimeError("MB-iSTFT: the plain path gave other durations")
        rel = mb_rel_diff(outs[B][0], audio)
        log(f"  MB-iSTFT infer B={B}: y_lengths {outs[B][4].tolist()}, max |audio| "
            f"{float(audio.abs().max()):.3f}; max |kernel - plain| / max(1, max |plain|) = "
            f"{rel:.3e} (bound {AUDIO_ATOL:g}), durations equal")
        if rel > AUDIO_ATOL:
            raise RuntimeError("MB-iSTFT infer: kernel path and plain path disagree")
    for B in (1, 8):
        times = {}
        for path in ("plain", "kernel", "kernel", "plain"):
            use_model_path(model, path)
            times.setdefault(path, []).append(wall_ms(lambda: run(B), warmup=1, reps=3))
        for path, ts in times.items():
            use_model_path(model, path)
            ms, busy = statistics.median(ts), profile_busy_ms(lambda: run(B))
            h_ms, h_busy = INFER_TIMES.get(("HiFi-GAN", B, path), (float("nan"),) * 2)
            log(f"  infer B={B} T_x={T_X} max_frames={MAX_FRAMES} {path}: MB-iSTFT {ms:.2f} "
                f"ms/call on the host clock (turns {', '.join(f'{t:.2f}' for t in ts)}), device "
                f"busy {busy:.2f} ms; HiFi-GAN (inference phase) {h_ms:.2f} ms, busy "
                f"{h_busy:.2f} ms [{card}]")
    use_model_path(model, "kernel")
    return launches


def mb_kernel_checks(model, device, card: str):
    """The MRF kernel with the trunk's C=128 bank at MB_MRF_SHAPE against
    its plain version, timed beside its bound; the iSTFT + PQMF head on the
    card against the same head on the CPU, on conv_post-shaped inputs whose
    edge bins have imaginary parts."""
    import torch

    from torch_tts_tpu_torch.kernels import mrf_fused as mrf_kernel
    from torch_tts_tpu_torch.ops.mb_istft import MultiBandISTFTGenerator

    dec, nk = model.dec, model.dec.num_kernels
    B, T, C = MB_MRF_SHAPE
    banks = [dec.resblocks[i:i + nk] for i in range(0, len(dec.resblocks), nk)
             if dec.resblocks[i].channels == C]
    if len(banks) != 1 or not mrf_kernel.supports(C, dec.max_taps):
        raise RuntimeError(f"the MB-iSTFT trunk has no one C={C} bank that the kernel takes")
    g = torch.Generator().manual_seed(13)
    with torch.no_grad():
        blocks = tuple(block.kernels() for block in banks[0])
        x = (torch.randn(B, T, C, generator=g) * 0.5).to(device)
        err = compare(f"MB-iSTFT mrf_fused B={B} T={T} C={C}", mrf_kernel.mrf_fused(x, blocks),
                      mrf_kernel.mrf_plain(x, blocks))
        t_k = cuda_ms(lambda: mrf_kernel.mrf_fused(x, blocks), warmup=1, reps=5)
        t_p = cuda_ms(lambda: mrf_kernel.mrf_plain(x, blocks), warmup=1, reps=5)
        taps = sum(len(offs) for block in blocks for it in block for offs, _, _ in it)
        nbytes = 4.0 * (2 * B * T * C + sum(w.numel() + b.numel() for block in blocks
                                             for it in block for _, w, b in it))
        b = product_bound(f"MB-iSTFT mrf_fused B={B} T={T} C={C}", 2.0 * B * T * C * C * taps,
                          nbytes, card)
        log(f"  MB-iSTFT mrf_fused B={B} T={T} C={C}: kernel {t_k:.3f} ms, plain {t_p:.3f} ms, "
            f"bound {b[0]:.3f} ms ({b[1]}) [{card}]")
        del x
        S, Fb = dec.subbands, dec.fbins
        h = torch.randn(8, S * 2 * Fb, 4096, generator=g) * 2.0
        cpu = MultiBandISTFTGenerator(8, upsample_initial_channel=32, subbands=S,
                                      istft_n_fft=dec.istft_n_fft, istft_hop=dec.istft_hop)
        ref = cpu.head(h)
        out = dec.head(h.to(device)).cpu()
        hb = h.reshape(8 * S, 2 * Fb, -1)
        edge_imag = float((torch.exp(torch.clamp(hb[:, [0, Fb - 1]], -12, 6))
                           * torch.sin(hb[:, [Fb, 2 * Fb - 1]])).abs().max())
        rel = mb_rel_diff(out, ref)
        log(f"  MB-iSTFT head (iSTFT n_fft {dec.istft_n_fft} hop {dec.istft_hop}, PQMF x{S}) "
            f"on [8, {S * 2 * Fb}, 4096], edge bins' imaginary parts up to {edge_imag:.2f}: max "
            f"|card - CPU| / max(1, max |CPU|) = {rel:.3e} (bound {MB_HEAD_RTOL:g}), max |CPU| "
            f"{float(ref.abs().max()):.2f}")
        if rel > MB_HEAD_RTOL or not bool(torch.isfinite(out).all()):
            raise RuntimeError("the MB-iSTFT head on the card disagrees with the CPU")
    torch.cuda.empty_cache()
    return err


def mb_cli_and_serving(model, cfg, device, card: str, tmp: str):
    """The inference CLI once (config as JSON, the seeded state dict), then a
    Synthesizer: `synthesize` of four texts, and one stream() in the
    (256, 1344) bucket against `synthesize` of its text."""
    import numpy as np
    import torch

    from torch_tts_tpu_torch.cli import vits2_infer
    from torch_tts_tpu_torch.infer import serving

    ckpt, cfg_path = os.path.join(tmp, "G_mb.pth"), os.path.join(tmp, "mbistft.json")
    torch.save({"model": model.state_dict()}, ckpt)
    with open(cfg_path, "w") as f:
        json.dump({"model": dataclasses.asdict(cfg.model),
                   "data": {**dataclasses.asdict(cfg.data), **dataclasses.asdict(cfg.audio)}}, f)
    use_model_path(model, "kernel")

    def cli():
        wav = os.path.join(tmp, "mb_request.wav")
        audio = vits2_infer.main(["-c", cfg_path, "-m", ckpt, "--text", SENTENCES[1], "-o", wav,
                                  "--max-frames", str(MAX_FRAMES), "--seed", "1",
                                  "--device", str(device)])
        if audio.size == 0 or not np.isfinite(audio).all() or (
                os.path.getsize(wav) != 44 + 2 * audio.size):
            raise RuntimeError("the inference CLI on the MB-iSTFT model: bad audio or WAV")
        return audio

    audio, launches = counted(cli)
    log(f"  MB-iSTFT inference CLI: {audio.size} samples; launches {launches}")
    synth = serving.Synthesizer(cfg, model, buckets=SERVING_BUCKETS or serving.DEFAULT_BUCKETS,
                                transfer_dtype="float32", device=device)
    texts = SERVING_TEXTS[:4]

    def stream():
        return np.concatenate(list(synth.stream(
            STREAM_TEXT, STREAM_CHUNK, STREAM_CONTEXT, seed=3, length_scale=STREAM_LENGTH_SCALE)))

    def serve():
        t = time.perf_counter()
        res = synth.synthesize(texts, seed=5)
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t) * 1e3, stream()

    (res, wall, streamed), counts = counted(serve)
    for r in res:
        if not len(r.audio) or not np.isfinite(r.audio).all():
            raise RuntimeError("MB-iSTFT synthesize: empty or non-finite audio")
    log(f"  MB-iSTFT synthesize of {len(texts)} texts: "
        f"{', '.join(f'{len(r.audio) / r.sample_rate:.2f}' for r in res)} s of audio in "
        f"{wall:.2f} ms on the host clock (first call of its cells) [{card}]")
    bucket = synth._bucket_for(len(synth.encode_text(STREAM_TEXT)))
    for path, atol in (("kernel", AUDIO_ATOL), ("plain", STREAM_ATOL)):
        use_model_path(model, path)
        if path == "plain":
            streamed = stream()
        whole = synth.synthesize([STREAM_TEXT], seed=3, length_scale=STREAM_LENGTH_SCALE)[0].audio
        if streamed.shape != whole.shape or bucket[0] != 256:
            raise RuntimeError(f"MB-iSTFT stream: {streamed.shape} samples against "
                               f"{whole.shape}, bucket {bucket}")
        peak = max(1.0, float(abs(whole).max()))
        body = float(abs(streamed[:-MB_EDGE] - whole[:-MB_EDGE]).max()) / peak
        edge = float(abs(streamed[-MB_EDGE:] - whole[-MB_EDGE:]).max()) / peak
        log(f"  MB-iSTFT stream on the {path} path, bucket {bucket}, chunk {STREAM_CHUNK}, "
            f"context {STREAM_CONTEXT}: {len(whole) / cfg.audio.sampling_rate:.2f} s; against "
            f"synthesize on it max |d| / max(1, peak) {body:.3e} (bound {atol:g}) but for the "
            f"last {MB_EDGE} samples ({edge:.3e} there: a stream decodes them masked, "
            f"synthesize the exact length)")
        if body > atol:
            raise RuntimeError(f"the MB-iSTFT stream on the {path} path disagrees with synthesize")
    use_model_path(model, "kernel")
    for n, c in counts.items():
        launches[n] += c
    del synth
    return launches


def mb_train(cfg, device, card: str):
    """Three full-width `ddp` steps of the MB-iSTFT model at the train
    phase's batch (MAS and the WN forward and backward must launch; the
    decoder's banks on their plain convolutions under autograd), the first
    against one plain-path step from the same fresh state and noise."""
    import torch

    from torch_tts_tpu_torch.text import symbols
    from torch_tts_tpu_torch.train.vits2_train import build_mpd, create_train_state, train_step

    B, T_x, T_y = TRAIN_B, TRAIN_TX, TRAIN_TY
    g = torch.Generator().manual_seed(0)
    batch = {"x": torch.randint(1, len(symbols), (B, T_x), generator=g),
             "x_lengths": torch.full((B,), T_x),
             "spec": torch.randn(B, T_y, cfg.posterior_channels, generator=g),
             "spec_lengths": torch.full((B,), T_y),
             "wav": torch.randn(B, T_y * cfg.audio.hop_length, 1, generator=g) * 0.1}
    batch = {k: v.to(device) for k, v in batch.items()}

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    def fresh_state(path):
        st = create_train_state(cfg, seeded_synthesizer(cfg, device),
                                build_mpd(cfg, seed=1, device=device))
        use_model_path(st.model, path)
        return st

    state = fresh_state("kernel")
    history, step_ms = [], []

    def steps():
        for i in range(TRAIN_STEPS):
            t = time.perf_counter()
            history.append(train_step(cfg, state, batch, generator=gen(i)))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)

    _, launches = counted(steps)
    log(f"  MB-iSTFT {TRAIN_STEPS} ddp steps B={B} T_x={T_x} T_y={T_y}: launches {launches}; "
        f"{', '.join(f'{t:.1f}' for t in step_ms)} ms a step on the host clock [{card}]")
    for i, m in enumerate(history):
        log(f"  step {i}: " + ", ".join(f"{k}={v:.4f}" for k, v in m.items()))
        if m["nonfinite"] or not all(map(math.isfinite, m.values())):
            raise RuntimeError(f"MB-iSTFT step {i}: non-finite loss or gradient")
    if not all(launches[n] for n in ("maximum_path", "wn_group", "wn_group_backward")):
        raise RuntimeError(f"the MB-iSTFT step did not run its kernels: {launches}")
    del state
    plain = fresh_state("plain")
    mp, mk = train_step(cfg, plain, batch, generator=gen(0)), history[0]
    del plain
    for key in mk:
        d = abs(mk[key] - mp[key])
        log(f"  step 0 {key}: kernel {mk[key]:.6f} plain {mp[key]:.6f} |d|={d:.3e}")
        if key.startswith("loss") and d > LOSS_RTOL * abs(mp[key]) + LOSS_ATOL:
            raise RuntimeError(f"MB-iSTFT {key}: kernel path and plain path disagree")
    torch.cuda.empty_cache()
    return {n: c for n, c in launches.items() if n != "mrf_fused"}


def mb_variants(device, card: str):
    """Each other transformer flow type, and a ResBlock2 HiFi-GAN decoder,
    at full width: `infer` at B=1 on the defaults against the plain path;
    no mrf_fused launch on a ResBlock2 bank, no wn_group launch in the fft
    flows (they have no WN)."""
    import torch

    from torch_tts_tpu_torch.core.config import VITS2Config
    from torch_tts_tpu_torch.kernels import mrf_fused as mrf_kernel
    from torch_tts_tpu_torch.ops import hifigan
    from torch_tts_tpu_torch.text import symbols

    base = VITS2Config()
    variants = [(f"flow {t}", dict(transformer_flow_type=t)) for t in MB_FLOW_TYPES]
    variants.append(("ResBlock2 decoder", RESBLOCK2))
    g = torch.Generator().manual_seed(101)
    x = torch.randint(1, len(symbols), (1, T_X), generator=g).to(device)
    xl = torch.tensor([T_X], device=device)
    total = {}
    for name, change in variants:
        cfg = dataclasses.replace(base, model=dataclasses.replace(base.model, **change))
        model = seeded_synthesizer(cfg, device)

        def infer():
            return model.infer(x, xl, noise_scale=0.667, noise_scale_w=0.8, max_frames=MAX_FRAMES,
                               generator=torch.Generator(device=device).manual_seed(1))

        use_model_path(model, "kernel")
        out, launches = counted(infer)
        use_model_path(model, "plain")
        ref = infer()
        diff = float((out[0] - ref[0]).abs().max())
        check_audio(out[0], out[4], cfg.audio.hop_length, name)
        # the bulk decode's stages whose ResBlock1 bank the kernel takes (the
        # patch window decodes masked)
        dec, nk = model.dec, model.dec.num_kernels
        want_mrf = sum(isinstance(b, hifigan.ResBlock1) and mrf_kernel.supports(b.channels,
                                                                                dec.max_taps)
                       for b in dec.resblocks[::nk])
        want_wn = 0 if change.get("transformer_flow_type") == "fft" else cfg.model.flow_n_flows
        log(f"  {name}: infer B=1, y_lengths {out[4].tolist()}; launches {launches} (expected "
            f"mrf_fused {want_mrf}, wn_group {want_wn}); max |audio_kernel - audio_plain| "
            f"{diff:.3e} (bound {AUDIO_ATOL:g})")
        if (not torch.equal(out[4], ref[4]) or diff > AUDIO_ATOL
                or launches["mrf_fused"] != want_mrf or launches["wn_group"] != want_wn):
            raise RuntimeError(f"{name}: wrong launches, or kernel and plain paths disagree")
        for n, c in launches.items():
            total[n] = total.get(n, 0) + c
        del model
    torch.cuda.empty_cache()
    return {n: c for n, c in total.items() if n in ("mrf_fused", "wn_group")}


def mbistft_phase(device, card: str, tmp: str):
    """configs/vits2-ljspeech-mbistft.yaml at full width, seeded: infer,
    the MRF bank at the trunk's shape and the head on the card against the
    CPU, the inference CLI, serving, three train steps; then the four other
    flow types and the ResBlock2 decoder. Returns the path's launch counts
    (each part counted on its own; the kernel checks not counted)."""
    import torch

    cfg = mbistft_config()
    os.environ.pop("TTS_FUSED_WN", None)
    t0 = time.perf_counter()
    model = seeded_synthesizer(cfg, device)
    log(f"MB-iSTFT phase: {MBISTFT}, {sum(p.numel() for p in model.parameters())} params, "
        f"seeded init {time.perf_counter() - t0:.1f} s")
    parts = [mb_infer(model, cfg, device, card)]
    mb_kernel_checks(model, device, card)
    parts.append(mb_cli_and_serving(model, cfg, device, card, tmp))
    del model
    torch.cuda.empty_cache()
    parts += [mb_train(cfg, device, card), mb_variants(device, card)]
    launches = {}
    for p in parts:
        for n, c in p.items():
            launches[n] = launches.get(n, 0) + c
    log(f"  launch counts on the MB-iSTFT path: {launches}")
    if not all(launches.get(n) for n in ("mrf_fused", "wn_group", "wn_group_backward",
                                         "maximum_path")):
        raise RuntimeError(f"a kernel of the MB-iSTFT path did not launch: {launches}")
    return launches


@contextlib.contextmanager
def int8_plain_path():
    """While open, the int8 convolutions run their plain versions on the
    card (the wrappers' torch ops), not the kernels: the plain int8 path."""
    from torch_tts_tpu_torch.kernels import int8_conv

    real = int8_conv.quantize_act, int8_conv.int8_conv1d

    def plain_conv(x_q, s_x, w_q, s_w, bias, padding=(0, 0), dilation=1, phases=1, stride=1,
                   residual=None):
        return int8_conv.int8_conv1d_plain(x_q, s_x, w_q, s_w, bias, padding, dilation, phases,
                                           residual)

    int8_conv.quantize_act, int8_conv.int8_conv1d = int8_conv.quantize_act_plain, plain_conv
    try:
        yield
    finally:
        int8_conv.quantize_act, int8_conv.int8_conv1d = real


@contextlib.contextmanager
def int8_conv_calls():
    """While open, records each distinct int8 conv (key: B, C_in, T,
    columns, taps, dilation, padding, phases, the pre-activation's slope,
    whether it is masked and whether it adds a residual) with its first
    call's inputs and its number of calls."""
    from torch_tts_tpu_torch.ops import quant

    real, calls = quant.int8_conv1d_quantized, {}

    def recording(x, w_q, s_w, bias, padding, dilation=1, phases=1, slope=None, mask=None,
                  residual=None):
        N, k, C_in = w_q.shape
        key = (x.shape[0], C_in, x.shape[2], N, k, dilation, tuple(padding), phases, slope,
               mask is not None, residual is not None)
        if key not in calls:
            calls[key] = dict(n=0, args=(x.clone(), w_q, s_w, bias, slope,
                                         None if mask is None else mask.clone(),
                                         None if residual is None else residual.clone()))
        calls[key]["n"] += 1
        return real(x, w_q, s_w, bias, padding, dilation, phases, slope, mask, residual)

    quant.int8_conv1d_quantized = recording
    try:
        yield calls
    finally:
        quant.int8_conv1d_quantized = real


def unfolded(x_q, k: int, dilation: int, padding, T_out: int):
    """x_q [B, T, C] int8 (rows padded_channels(C) apart) -> [B T_out, k Cp]:
    each output frame's k taps of padded rows side by side, the implicit
    GEMM's A as one matrix (the `torch._int_mm` yardstick's input)."""
    import torch
    import torch.nn.functional as F

    from torch_tts_tpu_torch.kernels import int8_conv

    B, T, C = x_q.shape
    Cp = int8_conv.padded_channels(C)
    full = int8_conv.padded_rows(x_q).as_strided((B, T, Cp), (T * Cp, Cp, 1))
    xp = F.pad(full, (0, 0, padding[0], padding[1]))
    taps = [xp[:, j * dilation:j * dilation + T_out] for j in range(k)]
    return torch.stack(taps, dim=2).reshape(B * T_out, k * Cp)


def int8_counted(fn):
    """fn() with the int8 and the other kernels' counters set to 0 just
    before -> (its result, the counts just after)."""
    import torch

    from torch_tts_tpu_torch.kernels import int8_conv

    counters = {"quantize_act": int8_conv.quantize_act, "int8_conv1d": int8_conv.int8_conv1d,
                **kernel_counters()}
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {n: c.launches for n, c in counters.items()}


def int8_config():
    """configs/vits2-ljspeech.yaml with `quantize_decoder: true`, from the
    dataclass defaults (the card has no PyYAML; a CPU test holds the two
    equal)."""
    from torch_tts_tpu_torch.core.config import VITS2Config

    base = VITS2Config()
    return dataclasses.replace(
        base, model=dataclasses.replace(base.model, **INT8),
        data=dataclasses.replace(base.data, text_cleaners=("transliteration_cleaners",)))


def int8_convs(dec) -> int:
    """The decoder's int8 convolutions (a transposed conv is int8 on its
    subpixel geometry only)."""
    from torch_tts_tpu_torch.ops.layers import Conv1d, ConvTranspose1d

    return sum(m.quant is not None and (isinstance(m, Conv1d) or m.subpixel)
               for m in dec.modules() if isinstance(m, (Conv1d, ConvTranspose1d)))


def int8_kernel_checks(calls, card: str, timed_: bool = True, what: str = ""):
    """Each recorded conv: the quantizer kernel (with the call's slope and
    mask) against its plain version (x_q and s_x equal), the conv kernel
    (with the call's residual) against its plain version: equal bit for
    bit, and so within INT8_CONV_RTOL of the output's peak. With timed_,
    each kernel, its plain version, fp32 cuDNN `F.conv1d` at the same shape
    (TF32 off) and `torch._int_mm` on x_q unfolded to [B T_out, k Cp] (built
    before the timing) and w_q (the int8 product alone, without the
    dequantize: yardsticks the port never calls), timed by CUDA events
    around replays of a CUDA graph of INT8_GRAPH calls (INT8_GRAPH_PLAIN
    for the plain versions): no host between launches, since a call is a
    few microseconds of device work (and torch.profiler, over many short
    sessions, lost device events), beside the kernel's bound. -> per
    kernel, ms, plain_ms, library_ms and bound of one call at its dominant
    shape (the recorded shape whose calls take the most kernel time), and
    the sums over all the recorded calls (each shape times its number of
    calls) under names of their own (`*_per_infer`)."""
    import torch
    import torch.nn.functional as F

    from torch_tts_tpu_torch.kernels import int8_conv

    tot = {n: dict(ms=0.0, plain_ms=0.0, max_abs_err=0.0, ops_ms=0.0, bytes_ms=0.0, calls=0,
                   top=None) for n in ("quantize_act", "int8_conv1d")}
    fp32_ms, lib_ms = 0.0, 0.0
    for key, rec in sorted(calls.items(), key=repr):
        B, C_in, T, N, k, d, pad, phases, slope, masked, has_res = key
        x, w_q, s_w, bias, _, mask, res = rec["args"]
        n = rec["n"]
        with torch.no_grad():
            x_q, s_x = int8_conv.quantize_act(x, slope, mask)
            x_qp, s_xp = int8_conv.quantize_act_plain(x, slope, mask)
            q_err = float((x_q.float() - x_qp.float()).abs().max())
            if not torch.equal(x_q, x_qp) or float(s_x) != float(s_xp):
                raise RuntimeError(f"quantize_act {key}: x_q or s_x differs from its plain "
                                   f"version (|x_q - plain| {q_err}, s_x {float(s_x)!r} against "
                                   f"{float(s_xp)!r})")
            y = int8_conv.int8_conv1d(x_q, s_x, w_q, s_w, bias, pad, d, phases, residual=res)
            y_p = int8_conv.int8_conv1d_plain(x_q, s_x, w_q, s_w, bias, pad, d, phases, res)
            err, peak = float((y - y_p).abs().max()), float(y_p.abs().max())
            if (not torch.equal(y, y_p) or not err <= INT8_CONV_RTOL * peak
                    or not bool(torch.isfinite(y).all())):
                raise RuntimeError(f"int8_conv1d {key}: max |kernel - plain| {err:.3e}, not "
                                   f"bit for bit (the peak {peak:.3e}, INT8_CONV_RTOL "
                                   f"{INT8_CONV_RTOL:g})")
            tot["quantize_act"]["max_abs_err"] = max(tot["quantize_act"]["max_abs_err"], q_err)
            tot["int8_conv1d"]["max_abs_err"] = max(tot["int8_conv1d"]["max_abs_err"], err)
            if not timed_:
                continue
            T_out = T + pad[0] + pad[1] - d * (k - 1)
            M, Cp = B * T_out, int8_conv.padded_channels(C_in)
            w_fp = torch.randn(N, C_in, k, device=x.device)
            a = unfolded(x_q, k, d, pad, T_out)
            wt = int8_conv.padded_rows(w_q).as_strided((N, k * Cp), (k * Cp, 1)).t()
            t_q = graph_ms(lambda: int8_conv.quantize_act(x, slope, mask), n=INT8_GRAPH)
            t_qp = graph_ms(lambda: int8_conv.quantize_act_plain(x, slope, mask),
                            n=INT8_GRAPH_PLAIN)
            t_c = graph_ms(lambda: int8_conv.int8_conv1d(x_q, s_x, w_q, s_w, bias, pad, d,
                                                         phases, residual=res), n=INT8_GRAPH)
            t_cp = graph_ms(lambda: int8_conv.int8_conv1d_plain(x_q, s_x, w_q, s_w, bias, pad, d,
                                                                phases, res), n=INT8_GRAPH_PLAIN)
            t_fp = graph_ms(lambda: F.conv1d(F.pad(x, pad), w_fp, None, dilation=d),
                            n=INT8_GRAPH)
            # torch._int_mm takes M > 16 rows and K, N multiples of 8: every decoder shape
            t_lib = graph_ms(lambda: torch._int_mm(a, wt), n=INT8_GRAPH)
            del a
        K = k * C_in
        ops = 2.0 * M * N * K
        conv_parts = (ops / PEAK_INT8_OPS * 1e3,
                      (B * T * C_in + N * K + 4 * M * N * (2 if has_res else 1) + 4 * N * 2)
                      / PEAK_BYTES_PER_S * 1e3)
        q_parts = (4.0 * B * C_in * T / PEAK_FP32_FLOPS * 1e3,
                   (4.0 * B * C_in * T + B * T * Cp + (4 * B * T if masked else 0))
                   / PEAK_BYTES_PER_S * 1e3)
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        log(f"  int8 {key} x{n}: quantize {t_q:.4f} / plain {t_qp:.4f} / bound "
            f"{max(q_parts):.4f}; conv {t_c:.4f} / plain {t_cp:.4f} / fp32 cuDNN {t_fp:.4f} / "
            f"torch._int_mm {t_lib:.4f} / bound {max(conv_parts):.4f} "
            f"({ops / max(t_c, 1e-9) / 1e9:.0f} TOPS; tile "
            f"{int8_conv.conv_tile(B, T_out, N, phases, sms)})")
        for name, t, tp, parts in (("quantize_act", t_q, t_qp, q_parts),
                                   ("int8_conv1d", t_c, t_cp, conv_parts)):
            st = tot[name]
            st["ms"] += n * t
            st["plain_ms"] += n * tp
            by = "operations" if parts[0] >= parts[1] else "bytes"
            st["ops_ms" if by == "operations" else "bytes_ms"] += n * max(parts)
            st["calls"] += n
            if st["top"] is None or n * t > st["top"]["calls"] * st["top"]["ms"]:
                st["top"] = dict(shape=list(key[:6]) + [list(pad), phases, slope, masked, has_res],
                                 calls=n, ms=t, plain_ms=tp, bound=(max(parts), by),
                                 fp32_conv_ms=t_fp, library_ms=t_lib)
        fp32_ms += n * t_fp
        lib_ms += n * t_lib
    if not timed_:
        log(f"  {what}int8 kernels at {len(calls)} conv shapes ({sum(r['n'] for r in calls.values())} "
            f"calls): x_q and s_x equal to the plain version's, the conv equal to its plain "
            f"version bit for bit")
        return None
    stats = {}
    for name, st in tot.items():
        by = "operations" if st["ops_ms"] >= st["bytes_ms"] else "bytes"
        top = st["top"]
        stats[name] = dict(ms=top["ms"], plain_ms=top["plain_ms"], max_abs_err=st["max_abs_err"],
                           bound=top["bound"], library_ms=None, shape=top["shape"],
                           shape_calls=top["calls"], calls_per_infer=st["calls"],
                           ms_per_infer=st["ms"], plain_ms_per_infer=st["plain_ms"],
                           bound_ms_per_infer=st["ops_ms"] + st["bytes_ms"])
        log(f"  {name}, a call at its dominant shape {top['shape']} (x{top['calls']}): kernel "
            f"{top['ms']:.4f} ms, plain {top['plain_ms']:.4f} ms, bound {top['bound'][0]:.4f} ms "
            f"({top['bound'][1]}); the {st['calls']} calls of one B=1 int8 infer ({len(calls)} "
            f"shapes; key B, C_in, T, columns, taps, dilation, padding, phases, slope, masked, "
            f"residual; ms over a CUDA graph): kernel {st['ms']:.4f} ms, plain "
            f"{st['plain_ms']:.4f} ms, bound {stats[name]['bound_ms_per_infer']:.4f} ms ({by}); "
            f"max error {st['max_abs_err']:.3e} [{card}]")
    conv = stats["int8_conv1d"]
    conv["fp32_conv_ms"] = tot["int8_conv1d"]["top"]["fp32_conv_ms"]
    conv["fp32_conv_ms_per_infer"] = fp32_ms
    conv["library_ms"] = tot["int8_conv1d"]["top"]["library_ms"]
    conv["library_ms_per_infer"] = lib_ms
    log(f"  fp32 cuDNN F.conv1d at the same shapes (TF32 off, over a CUDA graph): a call at the "
        f"conv's dominant shape {conv['fp32_conv_ms']:.4f} ms, the infer's calls {fp32_ms:.4f} "
        f"ms; torch._int_mm on x_q unfolded (the int8 product alone): {conv['library_ms']:.4f} "
        f"ms, the infer's calls {lib_ms:.4f} ms [{card}]")
    return stats


def int8_edge_checks(device, card: str):
    """Both kernels against their plain versions, bit for bit, at the
    shapes of INT8_EDGES (C_in off the 32-channel granule and with a K tail
    in a 128-byte step, phases 8, 4, 3 and above a tile's columns, T_out
    off the tile with B > 1, the residual, slope and mask variants); then
    the quantizer and a residual conv captured in a CUDA graph, replayed
    twice on new inputs: equal to the plain versions each time (nothing of
    a launch persists to the next)."""
    import torch

    from torch_tts_tpu_torch.kernels import int8_conv
    from torch_tts_tpu_torch.ops import quant

    g = torch.Generator().manual_seed(80)

    def case(C_in, T, B, C_out, k, d, pad, phases, slope, masked, has_res):
        N = C_out * phases
        T_out = T + pad[0] + pad[1] - d * (k - 1)
        x = (torch.randn(B, C_in, T, generator=g) * 0.3).to(device)
        w_q, s_w = quant.conv_weights((torch.randn(N, C_in, k, generator=g) * 0.05).to(device))
        bias = torch.randn(C_out, generator=g).to(device)
        lengths = [T - 7 * i for i in range(B)]
        mask = ((torch.arange(T)[None, :] < torch.tensor(lengths)[:, None]).float()[:, None]
                .to(device) if masked else None)
        res = (torch.randn(B, C_out, T_out * phases, generator=g).to(device)
               if has_res else None)
        return x, w_q, s_w, bias, mask, res

    def plain(x, w_q, s_w, bias, mask, res, pad, d, phases, slope):
        x_q, s_x = int8_conv.quantize_act_plain(x, slope, mask)
        return x_q, s_x, int8_conv.int8_conv1d_plain(x_q, s_x, w_q, s_w, bias, pad, d, phases,
                                                     res)

    with torch.no_grad():
        for spec in INT8_EDGES:
            C_in, T, B, C_out, k, d, pad, phases, slope, masked, has_res = spec
            x, w_q, s_w, bias, mask, res = case(*spec)
            x_q, s_x = int8_conv.quantize_act(x, slope, mask)
            y = int8_conv.int8_conv1d(x_q, s_x, w_q, s_w, bias, pad, d, phases, residual=res)
            x_qp, s_xp, yp = plain(x, w_q, s_w, bias, mask, res, pad, d, phases, slope)
            torch.cuda.synchronize()
            same = (torch.equal(x_q, x_qp) and float(s_x) == float(s_xp)
                    and torch.equal(y, yp))
            T_out = T + pad[0] + pad[1] - d * (k - 1)
            tile = int8_conv.conv_tile(B, T_out, C_out * phases, phases,
                                       torch.cuda.get_device_properties(device).multi_processor_count)
            log(f"int8 phase: edge {spec} (T_out {T_out}, Cp {int8_conv.padded_channels(C_in)}, "
                f"tile {tile}): x_q, s_x and the conv equal to their plain versions bit for bit "
                f"-> {'ok' if same else 'FAIL'}")
            if not same:
                raise RuntimeError(f"the int8 kernels at {spec} differ from their plain versions")
        # the quantizer at values on and next to every rounding half of a scale
        # other than 1 (the kernel rounds a product with 1 / s_x unless it lies
        # that close to a half, then divides)
        s = float(int8_conv.symmetric_scale(torch.tensor(100.3)))
        halves = torch.tensor([(q + 0.5) * s for q in range(-127, 127)], dtype=torch.float64)
        halves = halves.float()
        vals = torch.cat([halves, torch.nextafter(halves, torch.tensor(float("inf"))),
                          torch.nextafter(halves, torch.tensor(float("-inf"))),
                          torch.tensor([100.3, -0.0])])
        x = vals.reshape(1, 1, -1).repeat(2, 40, 1).to(device)
        for slope, mask in ((None, None), (0.1, torch.ones(2, 1, x.shape[2], device=device))):
            x_q, s_x = int8_conv.quantize_act(x, slope, mask)
            x_qp, s_xp = int8_conv.quantize_act_plain(x, slope, mask)
            same = torch.equal(x_q, x_qp) and float(s_x) == float(s_xp)
            log(f"int8 phase: the quantizer at {x.shape[2]} values on and next to the rounding "
                f"halves (slope {slope}): x_q and s_x equal to the plain version's -> "
                f"{'ok' if same else 'FAIL'}")
            if not same:
                raise RuntimeError("the quantizer differs from its plain version at the halves")
        spec = INT8_EDGES[INT8_GRAPH_EDGE]
        C_in, T, B, C_out, k, d, pad, phases, slope, masked, has_res = spec
        x, w_q, s_w, bias, mask, res = case(*spec)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                int8_conv.int8_conv1d(*int8_conv.quantize_act(x, slope, mask), w_q, s_w, bias,
                                      pad, d, phases, residual=res)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            x_q, s_x = int8_conv.quantize_act(x, slope, mask)
            y = int8_conv.int8_conv1d(x_q, s_x, w_q, s_w, bias, pad, d, phases, residual=res)
        for scale in (0.3, 7.0):
            x.copy_(torch.randn(x.shape, generator=g).to(device) * scale)
            res.copy_(torch.randn(res.shape, generator=g).to(device))
            graph.replay()
            torch.cuda.synchronize()
            x_qp, s_xp, yp = plain(x, w_q, s_w, bias, mask, res, pad, d, phases, slope)
            same = (torch.equal(x_q, x_qp) and float(s_x) == float(s_xp)
                    and torch.equal(y, yp))
            log(f"int8 phase: a CUDA graph of the quantizer and the residual conv at {spec}, "
                f"replayed on new inputs (x scale {scale}): equal to the plain versions -> "
                f"{'ok' if same else 'FAIL'}")
            if not same:
                raise RuntimeError("a replayed int8 graph differs from the plain versions")
        del graph


def int8_infer_checked(model, cfg, device, what: str, batches):
    """`infer` at the bench shapes on the int8 kernels, counted: the int8
    launches equal the decoder calls times the decoder's int8 convs, the MRF
    kernel one launch per fp ResBlock1 stage of each unmasked decode (the
    patch window decodes masked), one WN group a flow. The same inputs
    through the plain int8 path must give equal durations and audio within
    AUDIO_ATOL of its peak. -> (outputs by B, launches)."""
    import torch

    from torch_tts_tpu_torch.kernels import mrf_fused as mrf_kernel
    from torch_tts_tpu_torch.ops import hifigan

    dec, hop = model.dec, cfg.audio.hop_length
    n_int8 = int8_convs(dec)
    fp_mrf = sum(b.quant is None and isinstance(b, hifigan.ResBlock1)
                 and mrf_kernel.supports(b.channels, dec.max_taps)
                 for b in dec.resblocks[::dec.num_kernels])
    decodes = {"all": 0, "unmasked": 0}
    real_forward = dec.forward

    def counting_forward(x, x_mask=None, g=None):
        decodes["all"] += 1
        decodes["unmasked"] += x_mask is None
        return real_forward(x, x_mask=x_mask, g=g)

    dec.forward = counting_forward
    try:
        outs, launches = int8_counted(lambda: {B: bench_infer(model, B, device) for B in batches})
    finally:
        del dec.forward
    want = {"quantize_act": decodes["all"] * n_int8, "int8_conv1d": decodes["all"] * n_int8,
            "mrf_fused": decodes["unmasked"] * fp_mrf,
            "wn_group": len(batches) * cfg.model.flow_n_flows}
    got = {n: launches[n] for n in want}
    log(f"  {what} int8 infer B={', '.join(map(str, batches))}: {decodes['all']} decoder calls "
        f"({decodes['unmasked']} unmasked) x {n_int8} int8 convs; launches {got} (expected "
        f"{want})")
    if got != want or not decodes["all"]:
        raise RuntimeError(f"{what}: int8 infer launched {got}, not {want}")
    with int8_plain_path():
        for B in batches:
            audio, _, _, _, y_lengths = bench_infer(model, B, device)
            check_audio(outs[B][0], outs[B][4], hop, f"{what} int8 B={B}")
            if not torch.equal(y_lengths, outs[B][4]):
                raise RuntimeError(f"{what}: the plain int8 path gave other durations")
            rel = mb_rel_diff(outs[B][0], audio)
            log(f"  {what} int8 infer B={B}: y_lengths {y_lengths.tolist()}; max |kernels - "
                f"plain int8 path| / max(1, max |plain|) = {rel:.3e} (bound {AUDIO_ATOL:g})")
            if rel > AUDIO_ATOL:
                raise RuntimeError(f"{what}: the int8 kernels and the plain int8 path disagree")
    return outs, got


def int8_against_fp32(q_model, fp_model, outs, cfg, device, card: str, what: str, batches):
    """The int8 model against the fp32 one on the same weights and inputs:
    the SNR of the int8 audio over the fp32 audio's valid samples; host ms
    and device-busy ms a call, fp32, int8, int8, fp32 in turns."""
    import torch

    hop = cfg.audio.hop_length
    for B in batches:
        audio_q, y_len = outs[B][0], outs[B][4]
        audio_fp, _, _, _, y_fp = bench_infer(fp_model, B, device)
        if not torch.equal(y_fp, y_len):
            raise RuntimeError(f"{what}: the int8 and the fp32 model gave other durations")
        valid = (torch.arange(audio_fp.shape[1], device=device)[None, :]
                 < (y_len.to(torch.int64) * hop)[:, None])
        sig = float((audio_fp[:, :, 0] ** 2 * valid).sum())
        err = float(((audio_q - audio_fp)[:, :, 0] ** 2 * valid).sum())
        snr = 10 * math.log10(sig / max(err, 1e-30))
        models = {"fp32": fp_model, "int8": q_model}
        times = {}
        for path in ("fp32", "int8", "int8", "fp32"):
            times.setdefault(path, []).append(
                wall_ms(lambda: bench_infer(models[path], B, device), warmup=1, reps=3))
        for path, ts in times.items():
            busy, seen = profile_kernels(lambda: bench_infer(models[path], B, device),
                                         ("int8_conv_kernel", "quantize_kernel", "emset"))
            log(f"  {what} infer B={B} T_x={T_X} max_frames={MAX_FRAMES} {path}: "
                f"{statistics.median(ts):.2f} ms/call on the host clock (turns "
                f"{', '.join(f'{t:.2f}' for t in ts)}), device busy {busy:.2f} ms (seen by the "
                f"profiler: {seen['int8_conv_kernel']} int8 conv launches, "
                f"{seen['quantize_kernel']} quantizer launches, {seen['emset']} memsets in all) "
                f"[{card}]")
            if path == "int8" and seen["int8_conv_kernel"] and (
                    seen["quantize_kernel"] != seen["int8_conv_kernel"]):
                raise RuntimeError(f"{what}: {seen['quantize_kernel']} quantizer kernels for "
                                   f"{seen['int8_conv_kernel']} int8 convs, not one each")
        log(f"  {what} B={B}: SNR of the int8 audio against the fp32 audio {snr:.2f} dB "
            f"(seeded weights: no quality claim)")


def int8_phase(device, card: str):
    """The int8 decoder (`quantize_decoder: true`) at full width:
    configs/vits2-ljspeech.yaml (`pack_narrow_convs` on, as shipped: the
    C=64 and C=32 stages stay fp) and the MB-iSTFT config, seeded. Both
    kernels against their plain versions at every conv of a B=1 `infer`;
    then, counts zeroed, `infer` at B=1 and B=8 (HiFi-GAN) and B=1
    (MB-iSTFT) with their launch counts, against the plain int8 path, and
    against the fp32 model on the same weights (SNR, host and busy ms).
    -> (the path's launch counts, the kernels' stats)."""
    import torch

    from torch_tts_tpu_torch.ops import quant

    mb = mbistft_config()
    cfgs = {"HiFi-GAN": int8_config(),
            "MB-iSTFT": dataclasses.replace(mb, model=dataclasses.replace(mb.model, **INT8))}
    os.environ.pop("TTS_FUSED_WN", None)
    int8_edge_checks(device, card)
    launches, stats = {}, None
    for what, cfg in cfgs.items():
        t0 = time.perf_counter()
        q_model = seeded_synthesizer(cfg, device)
        fp_model = seeded_synthesizer(dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, quantize_decoder=False)), device)
        log(f"int8 phase, {what}: {INT8}, {int8_convs(q_model.dec)} int8 convs in the decoder, "
            f"seeded init of both models {time.perf_counter() - t0:.1f} s")
        with int8_conv_calls() as calls:
            bench_infer(q_model, 1, device)
        # the kernels line's figures: one B=1 HiFi-GAN infer's calls
        checked = int8_kernel_checks(calls, card, timed_=what == "HiFi-GAN")
        stats = checked or stats
        with int8_conv_calls() as calls:
            bench_infer(q_model, 8, device)
        int8_kernel_checks(calls, card, timed_=False, what=f"{what} B=8: ")
        del calls
        batches = (1, 8) if what == "HiFi-GAN" else (1,)
        outs, got = int8_infer_checked(q_model, cfg, device, what, batches)
        for n, c in got.items():
            launches[n] = launches.get(n, 0) + c
        int8_against_fp32(q_model, fp_model, outs, cfg, device, card, what, batches)
        del q_model, fp_model, outs
        torch.cuda.empty_cache()
    log(f"  launch counts on the int8 path: {launches}")
    return launches, stats


def taco_path(synth, path: str):
    """The Tacotron serving path on the kernels (the port's defaults) or on
    the plain step and the plain convolutions."""
    synth.model.decoder.use_kernel = path == "kernel"
    if synth.vocoder is not None:
        synth.vocoder.generator.fuse_mrf = path == "kernel"


def mrf_stages(gen) -> int:
    """The number of the generator's banks that take the MRF kernel."""
    from torch_tts_tpu_torch.kernels import mrf_fused as mrf_kernel

    return sum(mrf_kernel.supports(gen.resblocks[i * gen.num_kernels].channels, gen.max_taps)
               for i in range(len(gen.ups)))


@contextlib.contextmanager
def expected_taco_launches(synth):
    """Counts, while open, the launches the synthesizer's dispatches imply on
    the kernel path: one `taco_step_streamed` per Taco2Prod decoder step and
    row group of at most 8 (none for the other cells), one `mrf_fused` per
    MRF stage of each vocoder call (none without a vocoder)."""
    import threading

    from torch_tts_tpu_torch.kernels import taco_step as ts

    dec, voc = synth.model.decoder, synth.vocoder
    counts, lock = {"taco_step_streamed": 0, "mrf_fused": 0}, threading.Lock()
    real_run = dec._run

    def run(carry, memory, prenet_masks, step_inputs=None, **train):
        draws = [train.get(k) for k in ("coin", "zoneout", "att_noise")]
        if dec.use_kernel and dec.cell_type == "tacotron2prod" and \
                not any(v is not None for v in draws):
            with lock:
                counts["taco_step_streamed"] += (prenet_masks.shape[0]
                                                 * len(ts.row_groups(memory.shape[0])))
        return real_run(carry, memory, prenet_masks, step_inputs, **train)

    dec._run = run
    if voc is not None:
        real_wave = voc.wave

        def wave(mel):
            if voc.generator.fuse_mrf:
                with lock:
                    counts["mrf_fused"] += mrf_stages(voc.generator)
            return real_wave(mel)

        voc.wave = wave
    try:
        yield counts
    finally:
        del dec._run
        if voc is not None:
            del voc.wave


def taco_serving_kernel_checks(model, gen, device, card: str):
    """The step kernel with the model's packed weights at the serving
    shapes (the top tier at the second bucket's text, B=1 at the stream's),
    and the MRF bank with a vocoder's widths at the stream's window and the
    grid's largest cell, against their plain versions."""
    import torch

    from torch_tts_tpu_torch.kernels import mrf_fused as mrf_kernel
    from torch_tts_tpu_torch.kernels import taco_step as ts
    from torch_tts_tpu_torch.infer.taco_serving import DEFAULT_TACO_BUCKETS, DEFAULT_TACO_TIERS

    g = torch.Generator().manual_seed(14)
    packed = model.decoder.packed_weights()
    H, Dc, P = packed.query_w.shape[0], packed.query_w.shape[1], packed.prenet_w2.shape[0]
    with torch.no_grad():
        for B, L in ((max(DEFAULT_TACO_TIERS), DEFAULT_TACO_BUCKETS[1][0]),
                     (1, DEFAULT_TACO_BUCKETS[2][0])):
            w = torch.softmax(torch.randn(B, L, generator=g) * 3, dim=1)
            state = ts.TacoStepState(w, *(torch.randn(B, n, generator=g) * 0.3
                                          for n in (Dc, H, H, H, H)))
            state = ts.TacoStepState(*(t.to(device) for t in state))
            memory = (torch.randn(B, L, Dc, generator=g) * 0.5).to(device)
            y_in = (torch.rand(B, packed.prenet_w1.shape[0], generator=g)).to(device)
            masks = tuple((torch.rand(B, P, generator=g) < 0.5).to(device) for _ in range(2))
            ones = torch.ones(B, L, device=device)
            err, ok = step_errors(  # n_tile: the TPU kernel's DMA tile, which 4 H must divide
                ts.taco_step_streamed(y_in, state, memory, ones, packed, n_tile=32,
                                      prenet_masks=masks),
                ts.taco_step_streamed_via_plain(y_in, state, memory, ones, packed, n_tile=32,
                                                prenet_masks=masks))
            log(f"  tacotron serving taco_step_streamed B={B} L={L}: max_abs_err={err:.3e} "
                f"-> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError("taco_step_streamed disagrees with its plain version")
        window = TACO_STREAM_CHUNK + 2 * TACO_STREAM_PAD
        for B, frames in ((1, window), (max(DEFAULT_TACO_TIERS), DEFAULT_TACO_BUCKETS[1][1])):
            T = frames
            for i, u in enumerate(gen.upsample_rates):
                T *= u
                bank = gen.resblocks[i * gen.num_kernels:(i + 1) * gen.num_kernels]
                C = bank[0].channels
                if not mrf_kernel.supports(C, gen.max_taps):
                    continue
                blocks = tuple(block.kernels() for block in bank)
                x = (torch.randn(B, T, C, generator=g) * 0.5).to(device)
                compare(f"tacotron serving mrf_fused B={B} T={T} C={C}",
                        mrf_kernel.mrf_fused(x, blocks), mrf_kernel.mrf_plain(x, blocks))
                t_k = cuda_ms(lambda: mrf_kernel.mrf_fused(x, blocks), warmup=1, reps=3)
                t_p = cuda_ms(lambda: mrf_kernel.mrf_plain(x, blocks), warmup=1, reps=3)
                log(f"  tacotron serving mrf_fused B={B} T={T} C={C}: kernel {t_k:.3f} ms, "
                    f"plain {t_p:.3f} ms [{card}]")
    torch.cuda.empty_cache()


def taco_grid_texts(synth, bucket, n: int):
    """n prefixes of SENTENCES[2] whose ids fall in `bucket`, longest first."""
    texts = [SENTENCES[2][:k] for k in range(len(SENTENCES[2]), 4, -1)
             if synth._bucket_for(len(synth.encode_text(SENTENCES[2][:k]))) == bucket]
    if len(texts) < n:
        raise RuntimeError(f"no {n} texts in bucket {bucket}")
    return texts[::max(1, len(texts) // n)][:n]


def taco_serving_grid(synth, card: str):
    """Each (tier, bucket) cell of the two smallest buckets on the kernel and
    the plain path: equal stop lengths, audio within TACO_AUDIO_ATOL; host
    ms a dispatch and its collect on both paths in turns, the kernel path's
    device busy (torch.profiler) and the vocoder's alone on a mel of the
    cell's shape (busy, and its time between CUDA events)."""
    import numpy as np
    import torch

    worst = 0.0
    for bucket in synth.buckets[:TACO_GRID_BUCKETS]:
        for tier in synth.batch_tiers:
            ids = [synth.encode_text(t) for t in taco_grid_texts(synth, bucket, tier)]
            out, times = {}, {}
            for path in ("plain", "kernel", "kernel", "plain"):
                taco_path(synth, path)
                t0 = time.perf_counter()
                out[path] = synth._collect_group(synth._dispatch_group(ids, seed=5))
                torch.cuda.synchronize()
                times.setdefault(path, []).append((time.perf_counter() - t0) * 1e3)
            for a, b in zip(out["kernel"], out["plain"]):
                if a.audio.shape != b.audio.shape or not np.isfinite(a.audio).all():
                    raise RuntimeError(f"tier {tier} bucket {bucket}: {a.audio.shape} samples "
                                       f"against the plain path's {b.audio.shape}")
                worst = max(worst, float(np.abs(a.audio - b.audio).max()))
            taco_path(synth, "kernel")
            busy = profile_busy_ms(lambda: synth._collect_group(synth._dispatch_group(ids, seed=5)))
            mel = torch.rand(tier, bucket[1] * synth.cfg.model.r, synth.cfg.audio.num_mels,
                             device=synth.device)
            voc_ms = cuda_ms(lambda: synth.vocoder.wave(mel), warmup=1, reps=3)
            voc_busy = profile_busy_ms(lambda: synth.vocoder.wave(mel))
            stops = [len(r.audio) // (synth.cfg.model.r * synth.cfg.audio.hop_length)
                     for r in out["kernel"]]
            log(f"  dispatch tier {tier} bucket {bucket}: stop lengths {stops}; host "
                f"{statistics.median(times['kernel']):.1f} ms (turns plain "
                f"{', '.join(f'{t:.1f}' for t in times['plain'])}, kernel "
                f"{', '.join(f'{t:.1f}' for t in times['kernel'])}), device busy {busy:.2f} ms; "
                f"the vocoder alone busy {voc_busy:.2f} ms ({voc_busy / busy:.2f} of the "
                f"dispatch's), {voc_ms:.2f} ms between CUDA events [{card}]")
    log(f"  grid, kernel path against plain path: stop lengths equal, max |d audio| {worst:.3e} "
        f"(bound {TACO_AUDIO_ATOL:g})")
    if worst > TACO_AUDIO_ATOL:
        raise RuntimeError("tacotron serving: the kernel path's audio disagrees with the plain "
                           "path")


def taco_serving_stream(synth, card: str):
    """stream() in the (128, 400) bucket: its chunked mel against the tier-1
    batch decode (equal), its audio against postnet + vocoder over that mel
    trimmed at the stop and against the batch audio; time to first chunk."""
    import numpy as np
    import torch

    r, hop = synth.cfg.model.r, synth.cfg.audio.hop_length
    K, pad = TACO_STREAM_CHUNK, TACO_STREAM_PAD
    ids = synth.encode_text(TACO_STREAM_TEXT)
    bucket = synth._bucket_for(len(ids))
    if bucket != synth.buckets[2]:
        raise RuntimeError(f"the stream text ({len(ids)} ids) is in bucket {bucket}")
    log(f"  stream text: {len(ids)} ids, bucket {bucket}, chunk {K} steps, pad {pad} frames; "
        f"warm-up of {synth.warmup_streaming(K, pad)} buckets")
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        first, pieces = None, []
        for a in synth.stream(TACO_STREAM_TEXT, seed=3, chunk_steps=K, pad_frames=pad):
            pieces.append(a)
            first = first if first is not None else (time.perf_counter() - t0) * 1e3
        runs.append((np.concatenate(pieces), first, (time.perf_counter() - t0) * 1e3,
                     len(pieces)))
    audio = runs[0][0]
    if not np.array_equal(audio, runs[1][0]):
        raise RuntimeError("two streams of one text and seed differ")
    log(f"  stream: {len(audio) / synth.cfg.audio.sample_rate:.2f} s of audio in {runs[0][3]} "
        f"chunks; first chunk {runs[0][1]:.1f}, {runs[1][1]:.1f} ms; whole stream "
        f"{runs[0][2]:.1f}, {runs[1][2]:.1f} ms on the host clock [{card}]")
    # the chunked decode the stream runs, against the tier-1 batch decode
    S = bucket[1]
    memory, mmask, carry, buf, masks, _ = synth._stream_start(ids, 3, K)
    for t0 in range(0, buf.shape[1] // r, K):
        carry, _, _ = synth._chunk(memory, mmask, carry, buf, masks, t0, K)
    x = torch.zeros(1, bucket[0], dtype=torch.int64)
    x[0, :len(ids)] = torch.tensor(ids)
    y, *_ = synth.model.infer(x.to(synth.device), torch.tensor([len(ids)], device=synth.device),
                              max_steps=S, prenet_masks=synth._masks(3, S, 1))
    mel_d = float((buf[:, :S * r] - y).abs().max())
    log(f"  stream's chunked mel against the tier-1 batch decode: max |d| {mel_d:.3e} (bound 0)")
    if mel_d != 0:
        raise RuntimeError("the stream's chunked decode differs from the batch decode")
    res = synth.synthesize([TACO_STREAM_TEXT], seed=3)[0].audio
    total = len(audio) // hop
    if total < K * r + 2 * pad:  # fell back to the batch path
        if not np.array_equal(audio, res):
            raise RuntimeError("the stream's fallback differs from the batch path")
        log(f"  stream stopped at {total} frames, under one window: the batch path's audio")
        return
    with torch.no_grad():
        trimmed = synth.vocoder.wave(synth.model.apply_postnet(y[:, :total]))[0].cpu().numpy()
        whole = synth.vocoder.wave(synth.model.apply_postnet(y))[0, :total * hop].cpu().numpy()
    peak = float(np.abs(whole).max())
    d_trim = float(np.abs(audio - trimmed).max()) / peak
    keep = max(0, total - TACO_EDGE_FRAMES) * hop
    d_batch = float(np.abs(audio[:keep] - whole[:keep]).max()) / peak if keep else 0.0
    d_res = float(np.abs(res - whole / peak).max())
    log(f"  stream ({total} of {S * r} frames) against postnet + vocoder over the batch mel "
        f"trimmed at the stop: max |d| / peak {d_trim:.3e}; against the batch audio but for the "
        f"last {TACO_EDGE_FRAMES} frames {d_batch:.3e}, the last "
        f"{float(np.abs(audio[keep:] - whole[keep:]).max()) / peak:.3e}; synthesize against that "
        f"audio over its peak {d_res:.3e} (bound {TACO_AUDIO_ATOL:g})")
    if max(d_trim, d_batch, d_res) > TACO_AUDIO_ATOL:
        raise RuntimeError("the stream disagrees with the batch path")


def taco_serving_webui(synth, vits_synth, stream_audio, card: str):
    """make_server with the Tacotron synthesizer: TACO_WEB_REQUESTS /tts_taco
    and one /tts_taco_stream at once, then /metrics."""
    import threading
    import urllib.parse
    import urllib.request

    import numpy as np

    from torch_tts_tpu_torch.cli import webui

    server, batcher = webui.make_server(vits_synth, port=0, host="127.0.0.1", taco_synth=synth,
                                       taco_stream_params=((TACO_STREAM_CHUNK, TACO_STREAM_PAD),))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"

    def get(path, **q):
        with urllib.request.urlopen(f"{url}{path}?{urllib.parse.urlencode(q)}",
                                    timeout=600) as resp:
            return resp.status, resp.read()

    try:
        out = {}
        texts = taco_grid_texts(synth, synth.buckets[1], TACO_WEB_REQUESTS)

        def tts(k):
            out[k] = get("/tts_taco", text=texts[k], seed=k)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=tts, args=(k,)) for k in range(TACO_WEB_REQUESTS)]
        for th in threads:
            th.start()
        out["stream"] = get("/tts_taco_stream", text=TACO_STREAM_TEXT, seed=3,
                            chunk=TACO_STREAM_CHUNK, pad=TACO_STREAM_PAD)
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0
        if any(code != 200 for code, _ in out.values()):
            raise RuntimeError(f"web UI: statuses {[c for c, _ in out.values()]}")
        pcm = np.frombuffer(out["stream"][1], "<i2").astype(np.float32) / 32767
        want = np.clip(stream_audio, -1, 1)
        diff = float(abs(pcm - want).max()) if pcm.shape == want.shape else float("inf")
        code, metrics = get("/metrics")
        values = dict(line.split() for line in metrics.decode().splitlines()
                      if not line.startswith("#"))
        taco = {k: v for k, v in values.items() if k.startswith("tts_taco")}
        log(f"  web UI: {TACO_WEB_REQUESTS} /tts_taco and one /tts_taco_stream at once in "
            f"{wall:.3f} s; the stream's PCM against a serial stream: max |d| {diff:.3e} (bound "
            f"{AUDIO_ATOL:g} + one 16-bit step); {taco} [{card}]")
        if diff > AUDIO_ATOL + 1 / 32767:
            raise RuntimeError("web UI: /tts_taco_stream under load disagrees with a stream")
        if (values["tts_taco_failures_total"] != "0"
                or int(values["tts_taco_requests_total"]) != TACO_WEB_REQUESTS):
            raise RuntimeError(f"web UI: /metrics {values}")
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
        server.taco_batcher.close()
        thread.join(timeout=60)


def taco_serving_phase(device, card: str, tmp: str):
    """Tacotron serving at full width (LJSpeech Taco2Prod, seeded as the
    Tacotron phase's): the vocoder trainer's CLI on a synthetic corpus, its
    artifact behind a TacotronSynthesizer: the grid against the plain path,
    one stream, one Griffin-Lim dispatch, the inference CLI with --vocoder,
    and the web UI's Tacotron routes under concurrent requests. Returns the
    path's launch counts, each equal to what its dispatches imply."""
    import numpy as np
    import torch

    from torch_tts_tpu_torch.cli import tacotron_infer, vocoder_train
    from torch_tts_tpu_torch.core.config import TacotronConfig, VITS2Config
    from torch_tts_tpu_torch.infer import serving
    from torch_tts_tpu_torch.infer.taco_serving import TacotronSynthesizer
    from torch_tts_tpu_torch.infer.vocoder import build_generator, load_vocoder
    from torch_tts_tpu_torch.kernels import taco_step as ts
    from torch_tts_tpu_torch.kernels.mrf_fused import mrf_fused
    from torch_tts_tpu_torch.models.tacotron import build_tacotron
    from torch_tts_tpu_torch.ops.layers import init_params_

    cfg = TacotronConfig()
    a = cfg.audio
    t0 = time.perf_counter()
    model = build_tacotron(cfg, seed=0, device=device)
    ckpt, cfg_path = os.path.join(tmp, "tacotron.pth"), os.path.join(tmp, "tacotron.json")
    torch.save({"model": model.state_dict()}, ckpt)
    with open(cfg_path, "w") as f:
        json.dump({k: dataclasses.asdict(getattr(cfg, k)) for k in ("audio", "text", "model")}, f)
    gen_kwargs = vocoder_train.gen_kwargs_for(a.hop_length)
    log(f"tacotron serving phase: Tacotron-2 seeded init {time.perf_counter() - t0:.1f} s; "
        f"vocoder {gen_kwargs}")
    gen = build_generator(gen_kwargs, a.num_mels).to(device)
    init_params_(gen, torch.Generator().manual_seed(1))
    taco_serving_kernel_checks(model, gen, device, card)
    if mrf_stages(gen) != len(gen.ups):
        raise RuntimeError("a stage of the LJSpeech vocoder does not take the MRF kernel")
    del gen

    # --- the main path, its launches counted from here
    ts.taco_step_streamed.launches = mrf_fused.launches = 0
    corpus = os.path.join(tmp, "corpus")
    write_corpus(corpus, TACO_VOCODER_CLIPS, a.sample_rate, seed=7)
    run_dir = os.path.join(tmp, "vocoder")
    t = time.perf_counter()
    state = vocoder_train.main([os.path.join(corpus, "wavs"), cfg_path, "--run-dir", run_dir,
                                "--steps", str(TACO_VOCODER_STEPS), "--batch-size",
                                str(TACO_VOCODER_BATCH), "--log-interval", "1", "--ckpt-interval",
                                str(TACO_VOCODER_STEPS), "--device", str(device)])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    if state.step != TACO_VOCODER_STEPS or not all(
            bool(torch.isfinite(p).all()) for p in state.model.parameters()):
        raise RuntimeError("the vocoder trainer did not take its steps, or its weights are "
                           "not finite")
    log(f"  vocoder trainer CLI: {TACO_VOCODER_CLIPS} clips, {TACO_VOCODER_STEPS} GAN steps of "
        f"{TACO_VOCODER_BATCH} x 32 frames, the checkpoint and the artifact in {train_s:.1f} s "
        f"(corpus encoding and the first step's warm-up included) [{card}]")
    del state
    artifact = os.path.join(run_dir, "vocoder.pt")
    voc = load_vocoder(artifact, device=device)
    synth = TacotronSynthesizer(cfg, model, vocoder=voc, device=device)
    with expected_taco_launches(synth) as expected:
        taco_serving_grid(synth, card)
        taco_serving_stream(synth, card)
        stream_audio = np.concatenate(list(synth.stream(
            TACO_STREAM_TEXT, seed=3, chunk_steps=TACO_STREAM_CHUNK, pad_frames=TACO_STREAM_PAD)))
        # one Griffin-Lim dispatch (the same model, no vocoder)
        gl = TacotronSynthesizer(cfg, model, device=device)
        t = time.perf_counter()
        r = gl.synthesize([SENTENCES[0]], seed=2)[0]
        log(f"  Griffin-Lim dispatch: {len(r.audio) / a.sample_rate:.2f} s of audio in "
            f"{(time.perf_counter() - t) * 1e3:.1f} ms on the host clock [{card}]")
        if not len(r.audio) or not np.isfinite(r.audio).all():
            raise RuntimeError("Griffin-Lim dispatch: empty or non-finite audio")
        # the inference CLI with the artifact: its own model and vocoder
        wav_path = os.path.join(tmp, "tacotron_vocoder.wav")
        wav, mel = tacotron_infer.main([SENTENCES[1], cfg_path, "-m", ckpt, "-o", wav_path,
                                        "--max-steps", str(TACO_STEPS), "--vocoder", artifact,
                                        "--device", str(device)])
        cli_launches = {"taco_step_streamed": TACO_STEPS, "mrf_fused": mrf_stages(voc.generator)}
        if wav.size != mel.shape[0] * a.hop_length or not np.isfinite(wav).all():
            raise RuntimeError("tacotron_infer --vocoder: audio of the wrong length or not finite")
        base = VITS2Config()
        vcfg = dataclasses.replace(base, data=dataclasses.replace(
            base.data, text_cleaners=("transliteration_cleaners",)))
        vits = serving.Synthesizer(vcfg, seeded_synthesizer(vcfg, device), device=device)
        taco_serving_webui(synth, vits, stream_audio, card)
        torch.cuda.synchronize()
        want = {n: c + cli_launches[n] for n, c in expected.items()}
    launches = {"taco_step_streamed": ts.taco_step_streamed.launches,
                "mrf_fused": mrf_fused.launches}
    log(f"  launch counts on the tacotron serving path: {launches} (implied by its dispatches "
        f"{want})")
    if launches != want or not all(launches.values()):
        raise RuntimeError(f"tacotron serving launches {launches}, its dispatches imply {want}")
    del synth, gl, voc, model, vits
    torch.cuda.empty_cache()
    return launches


def kernels_in(fn):
    """The device kernels one fn() call launches: fn captured into a CUDA
    graph (never replayed), its kernel nodes counted through the driver
    API; None where that fails (logged). (torch.profiler read no device
    events of a single such call in this process on the card.)"""
    import ctypes

    import torch

    try:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        torch.cuda.synchronize()
        with torch.cuda.graph(graph):
            fn()
        cuda = ctypes.CDLL("libcuda.so.1")
        handle, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
        if cuda.cuGraphGetNodes(handle, None, ctypes.byref(n)) != 0:
            raise RuntimeError("cuGraphGetNodes failed")
        nodes = (ctypes.c_void_p * n.value)()
        if cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) != 0:
            raise RuntimeError("cuGraphGetNodes failed")
        kind, count = ctypes.c_int(), 0
        for node in nodes:
            if cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) != 0:
                raise RuntimeError("cuGraphNodeGetType failed")
            count += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
        graph.reset()
        return count
    except Exception as e:  # the count is a report, not a check
        log(f"  kernels_in: not measured ({type(e).__name__}: {e})")
        return None


def profile_step(fn):
    """(device busy ms, device operations: kernels and copies, host ms) of
    one fn() call, its busy time by torch.profiler tracing the device alone
    (with the host's events, a Tacotron train step's 90,000 operations took
    the trace minutes to average) and its host time on the host clock from
    the call to the device's end, the same call's."""
    return profile_breakdown(fn, 0)[:3]


def profile_breakdown(fn, n: int = 8):
    """`profile_step`'s (device busy ms, operations, host ms) of one fn()
    call, and its n largest device operations by name: (name, ms, count).
    torch.profiler traces the device alone (see `profile_step`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    ops = [e for e in prof.key_averages() if e.device_type == cuda]
    top = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in ops),
                 key=lambda r: -r[1])[:n]
    return (sum(e.self_device_time_total for e in ops) / 1e3, sum(e.count for e in ops),
            host_ms, top)


def taco_training_phase(device, card: str, tmp: str):
    """Tacotron-2 training at full width (configs/tacotron-ljspeech.yaml, the
    dataclass defaults): the port's TacotronDataset (no cache) on a
    synthetic corpus, TacotronTrainer for an epoch with evaluate(), a
    resume checked bit for bit and a second epoch, the trained run
    directory through TacotronSynthesizer.from_run_dir; then eval_step on
    the kernel against the plain path, a train step's times at the batch's
    shape, and the loss over TACO_LOSS_STEPS steps on one batch's first
    TACO_LOSS_FRAMES frames. Returns the path's launch counts, equal to
    what its decodes imply."""
    import numpy as np
    import torch

    from torch_tts_tpu_torch.audio.frontend import AudioFrontend
    from torch_tts_tpu_torch.cli.tacotron_infer import text_encoder
    from torch_tts_tpu_torch.cli.tacotron_train import pad_lengths
    from torch_tts_tpu_torch.core.config import TacotronConfig
    from torch_tts_tpu_torch.data.tacotron_dataset import (TacotronDataset,
                                                           TranscribedAudioDataset,
                                                           collate_tacotron)
    from torch_tts_tpu_torch.infer.taco_serving import TacotronSynthesizer
    from torch_tts_tpu_torch.kernels import taco_step as ts
    from torch_tts_tpu_torch.models.tacotron import build_tacotron
    from torch_tts_tpu_torch.train import checkpoint
    from torch_tts_tpu_torch.train import tacotron_train as tt
    from torch_tts_tpu_torch.train.vits2_trainer import step_generator, to_tensors
    from torch_tts_tpu_torch.utils.logging_utils import Recorder

    cfg = TacotronConfig()
    r, B = cfg.model.r, TACO_TRAIN_B
    cfg_path = os.path.join(tmp, "tacotron.json")
    with open(cfg_path, "w") as f:
        json.dump({k: dataclasses.asdict(getattr(cfg, k)) for k in ("audio", "text", "model")}, f)
    corpus = os.path.join(tmp, "corpus")
    t0 = time.perf_counter()
    write_corpus(corpus, TACO_TRAIN_CLIPS, cfg.audio.sample_rate, seed=11)
    ds = TacotronDataset(TranscribedAudioDataset(corpus), text_encoder(cfg),
                         AudioFrontend(cfg.audio, device))
    items = [ds[i] for i in range(len(ds))]
    pad_c, pad_x = pad_lengths(items, r, TACO_TRAIN_FRAMES)
    longest = max(it["x"].shape[0] for it in items)
    if pad_x != TACO_TRAIN_FRAMES or longest > pad_x:
        raise RuntimeError(f"frames pad to {pad_x}, the longest mel has {longest}")

    def batches(sel):
        return [collate_tacotron(sel[i: i + B], pad_text_to=pad_c, pad_frames_to=pad_x, r=r)
                for i in range(0, len(sel), B)]

    train_b, eval_b = batches(items[TACO_TRAIN_EVAL:]), batches(items[:TACO_TRAIN_EVAL])
    spe, S = len(train_b), pad_x // r
    log(f"tacotron training phase: {len(items)} clips of {TRAINER_SECONDS[0]}-"
        f"{TRAINER_SECONDS[1]} s written and their mels made by the port's TacotronDataset on "
        f"the card in {time.perf_counter() - t0:.1f} s; {spe} train batches and {len(eval_b)} "
        f"eval batch(es) of {B} x {pad_c} ids x {pad_x} frames (longest mel {longest})")

    writers = []

    def recorder(log_dir):
        writers.append(Recorder())
        return writers[-1]

    def finite_log(what):
        logged = [(tag, v) for w in writers for tag, vals in w.scalars.items() for _, v in vals]
        if not logged or not all(math.isfinite(v) for _, v in logged):
            raise RuntimeError(f"{what}: nothing logged or a non-finite scalar")
        return {tag: vals[-1][1] for tag, vals in writers[-1].scalars.items()}

    # --- the main path, its launches counted from here: an epoch with
    # evaluate(), a resume and a second epoch, the run directory decoded
    ts.taco_step_streamed.launches = 0
    run_dir = os.path.join(tmp, "taco_run")
    t0 = time.perf_counter()
    tr = tt.TacotronTrainer(cfg, run_dir, make_writer=recorder, device=device)
    tr.train(train_b, eval_b, num_epochs=1, log_interval=1)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    last = finite_log("epoch 1")
    path = checkpoint.latest_checkpoint(run_dir)
    bad = tree_mismatches(checkpoint.load_file(path), checkpoint.state_tree(tr.state))
    if tr.state.step != spe or bad or not path.endswith(f"ckpt_{spe}.pt"):
        raise RuntimeError(f"epoch 1: step {tr.state.step}, checkpoint {path} differs at {bad[:5]}")
    step_ms = [v for _, v in writers[-1].scalars["perf/step_ms"]]
    log(f"  epoch 1: {spe} steps and evaluate() in {epoch_s:.1f} s (model init and first calls "
        f"included), step ms on the host clock {', '.join(f'{v:.1f}' for v in step_ms)}; last "
        f"logged loss {last['loss']:.4f}, eval/loss {last['eval/loss']:.4f} [{card}]")
    del tr
    writers.clear()
    tr = tt.TacotronTrainer(cfg, run_dir, make_writer=recorder, device=device)
    bad = tree_mismatches(checkpoint.state_tree(tr.state), checkpoint.load_file(path))
    if tr.state.step != spe or bad:
        raise RuntimeError(f"the resume did not restore the saved state: step {tr.state.step}, "
                           f"{bad[:5]}")
    tr.train(train_b, eval_b, num_epochs=2, log_interval=1)
    torch.cuda.synchronize()
    last = finite_log("epoch 2")
    if tr.state.step != 2 * spe or checkpoint.latest_checkpoint(run_dir) != \
            checkpoint.checkpoint_path(run_dir, 2 * spe):
        raise RuntimeError(f"epoch 2 ended at step {tr.state.step}, not {2 * spe}")
    log(f"  resume: step {spe}, parameters, BatchNorm buffers and the optimizer's moments and "
        f"count equal to the checkpoint bit for bit; epoch 2 to step {tr.state.step}, last "
        f"logged loss {last['loss']:.4f}, eval/loss {last['eval/loss']:.4f}")
    synth = TacotronSynthesizer.from_run_dir(cfg_path, run_dir, device=device)
    trained = tr.model.state_dict()
    if any(not torch.equal(v, trained[k]) for k, v in synth.model.state_dict().items()):
        raise RuntimeError("from_run_dir did not load the trainer's latest weights")
    with expected_taco_launches(synth) as expected:
        t = time.perf_counter()
        res = synth.synthesize([SENTENCES[1]], seed=4)[0]
        torch.cuda.synchronize()
        synth_ms = (time.perf_counter() - t) * 1e3
        want = 2 * len(eval_b) * S * len(ts.row_groups(B)) + expected["taco_step_streamed"]
    if not len(res.audio) or not np.isfinite(res.audio).all():
        raise RuntimeError("the trained checkpoint's decode gave empty or non-finite audio")
    launches = {"taco_step_streamed": ts.taco_step_streamed.launches}
    log(f"  from_run_dir: {len(res.audio) / cfg.audio.sample_rate:.2f} s of Griffin-Lim audio in "
        f"{synth_ms:.1f} ms; launches on the path {launches} (two evaluate() calls of "
        f"{len(eval_b)} x {S} steps x {len(ts.row_groups(B))} row groups and the decode's "
        f"{expected['taco_step_streamed']}: {want}) [{card}]")
    if launches["taco_step_streamed"] != want:
        raise RuntimeError(f"taco_step_streamed launches {launches}, the decodes imply {want}")
    del synth

    # --- eval_step on the kernel against the plain path, same PreNet masks
    model, b = tr.model, tr.batch(eval_b[0])
    draws = model.draw(B, pad_c, S, torch.Generator(device=device).manual_seed(9), train=False)

    def evaluate(path):
        model.decoder.use_kernel = path == "kernel"
        with torch.no_grad():
            y, y_post, _, _ = model(b["c"], b["c_lengths"], b["x"], b["x_lengths"], draws=draws)
        metrics, w = tt.eval_step(model, b, draws=draws)
        return {"w": w, "y": y, "y_post": y_post, "loss": metrics["loss"]}

    t_part = time.perf_counter()
    n0 = ts.taco_step_streamed.launches
    got = evaluate("kernel")
    torch.cuda.synchronize()
    n_kernel = ts.taco_step_streamed.launches - n0
    ref = evaluate("plain")
    torch.cuda.synchronize()
    errs = {k: float((got[k] - ref[k]).abs().max()) for k in got}
    log(f"  eval_step kernel vs plain (B={B}, {S} teacher-forced steps): max |d| "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (bound {TACO_EVAL_ATOL:g}); loss {float(got['loss']):.5f}; taco_step_streamed "
        f"launches {n_kernel} (2 x {S} x {len(ts.row_groups(B))}), plain path "
        f"{ts.taco_step_streamed.launches - n0 - n_kernel}")
    if not all(v <= TACO_EVAL_ATOL for v in errs.values()):
        raise RuntimeError("eval_step on the kernel disagrees with the plain path")
    if n_kernel != 2 * S * len(ts.row_groups(B)) or ts.taco_step_streamed.launches != n0 + n_kernel:
        raise RuntimeError("eval_step did not run each step as one launch per row group")
    # a teacher-forced forward's host ms (evaluate() runs two), the paths in
    # turns; then one profiled eval_step on each path: its device busy ms
    # and, on the host clock, that same call's ms
    times = {}
    for path in ("kernel", "plain", "plain", "kernel"):
        times.setdefault(path, []).append(wall_ms(lambda: evaluate(path), warmup=0, reps=1) / 2)
    prof = {}
    for path in ("kernel", "plain"):
        model.decoder.use_kernel = path == "kernel"
        prof[path] = profile_step(lambda: tt.eval_step(model, b, draws=draws))
    model.decoder.use_kernel = True
    log(f"  eval_step ms on the host clock (B={B}, {S} steps, turns): " + ", ".join(
        f"{p} {', '.join(f'{t:.1f}' for t in tt)}" for p, tt in times.items())
        + "; a profiled eval_step: " + ", ".join(
            f"{p} {h:.1f} ms host, busy {busy:.1f} ms in {n} device operations, idle share "
            f"{max(0.0, 1 - busy / h):.2f}" for p, (busy, n, h) in prof.items())
        + f"; the checks and times {time.perf_counter() - t_part:.1f} s [{card}]")
    del tr, model, b, got, ref
    torch.cuda.empty_cache()

    # --- a train step at the batch's shape from a fresh model: host time
    # (two steps, the second timed), then one profiled step
    t_part = time.perf_counter()
    state = tt.create_train_state(build_tacotron(cfg, seed=1, device=device))
    b = to_tensors(train_b[0], device)

    def timed_step(i, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = tt.train_step(state, batch, generator=step_generator(1, i, device))
        loss = float(m["loss"])
        return loss, (time.perf_counter() - t) * 1e3

    first_ms = timed_step(0, b)[1]
    step_ms = timed_step(1, b)[1]
    busy_step, ops, prof_ms = profile_step(lambda: tt.train_step(
        state, b, generator=step_generator(1, 2, device)))
    log(f"  train step (B={B}, {pad_c} ids, {pad_x} frames): {step_ms:.1f} ms on the host clock "
        f"(the fresh model's first {first_ms:.1f}); a profiled step: {prof_ms:.1f} ms on the "
        f"host clock, device busy {busy_step:.1f} ms, {ops} device operations (kernels and "
        f"copies), idle share {max(0.0, 1 - busy_step / prof_ms):.2f} (that step's busy over "
        f"its host ms); {time.perf_counter() - t_part:.1f} s with the model's init and the "
        f"profile [{card}]")

    # --- the loss over TACO_LOSS_STEPS steps on that batch's first
    # TACO_LOSS_FRAMES frames, from another fresh model
    state = tt.create_train_state(build_tacotron(cfg, seed=2, device=device))
    n = TACO_LOSS_FRAMES
    short = dict(b, x=b["x"][:, :n].contiguous(), x_lengths=b["x_lengths"].clamp(max=n))
    runs = [timed_step(i, short) for i in range(TACO_LOSS_STEPS)]
    losses = [v for v, _ in runs]
    log(f"  {TACO_LOSS_STEPS} train steps on one batch (B={B}, {n} frames): loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} (min {min(losses):.4f}); step "
        f"{statistics.median(ms for _, ms in runs[1:]):.1f} ms median on the host clock [{card}]")
    if not all(math.isfinite(v) for v in losses) or \
            not statistics.mean(losses[-3:]) < losses[0]:
        raise RuntimeError(f"the training loss is not finite or did not fall: {losses}")
    del state, b, short
    torch.cuda.empty_cache()
    return launches


# Tacotron variants: the VAE style path at full width (style_dim_vae
# TACO_STYLE_DIM; reference clips of TACO_REF_SECONDS through the port's
# frontend), then the Tacotron-2 cell and the Tacotron-1 family
# (TACO_VARIANTS: decoder_type and encoder_type as the JAX package names
# them; "melpostnet2" is a postnet_type other than tacotron2, which builds
# MelPostnet2) decoded for TACO_VARIANT_STEPS steps at TACO_VARIANT_B.
# Tolerance: TACO_TF_ATOL, step by step (each step given the frame the
# route checked against produced), for the kernel route against the cell
# route and for the card against the CPU
TACO_STYLE_DIM, TACO_REF_SECONDS = 16, (1.0, 3.0)
TACO_VARIANT_STEPS, TACO_VARIANT_B, TACO_VARIANT_CHUNK = 200, (1, 4), 32
TACO_VARIANTS = (("tacotron2 cell", dict(decoder_type="tacotron2")),
                 ("tacotron1", dict(encoder_type="tacotron1", decoder_type="tacotron1",
                                    postnet_type="melpostnet2")))


def taco_variants_phase(device, card: str, tmp: str):
    """The VAE style path on kernel #7 (infer B=1 and ragged B=8 with
    ragged references, the kernel route against the cell route, a train
    step and an eval_step with the teacher mels as reference,
    `tacotron_infer --ref --plot` in a subprocess), then the Tacotron-2
    cell and the Tacotron-1 family on the card against the CPU. Returns
    the style path's launch counts."""
    import numpy as np
    import torch
    from scipy.io import wavfile

    from torch_tts_tpu_torch.audio.frontend import AudioFrontend, m_fwd
    from torch_tts_tpu_torch.cli.tacotron_infer import text_encoder
    from torch_tts_tpu_torch.core.config import TacotronConfig
    from torch_tts_tpu_torch.infer.taco_serving import TacotronSynthesizer
    from torch_tts_tpu_torch.kernels import taco_step as ts
    from torch_tts_tpu_torch.models.tacotron import build_tacotron
    from torch_tts_tpu_torch.train import tacotron_train as tt
    from torch_tts_tpu_torch.train.vits2_trainer import step_generator

    base = TacotronConfig()
    r, D = base.model.r, base.audio.num_mels

    def variant(**upd):
        return dataclasses.replace(base, model=dataclasses.replace(base.model, **upd))

    enc = text_encoder(base)

    def texts(B, dev=device):
        ids = [enc.encode(SENTENCES[2][: 150 - 13 * i]) for i in range(B)]
        c = torch.zeros(B, max(map(len, ids)), dtype=torch.int64)
        for i, row in enumerate(ids):
            c[i, : len(row)] = torch.tensor(row)
        return c.to(dev), torch.tensor([len(row) for row in ids], device=dev)

    def checked(out, what, S):
        y_post, aux = out[1], out[3]
        stop, dev = aux["stop_lengths"], float((aux["w"].sum(-1) - 1).abs().max())
        if not bool(torch.isfinite(y_post).all()) or not bool(((stop >= 1) & (stop <= S)).all()) \
                or dev > 1e-4:
            raise RuntimeError(f"{what}: non-finite mel, stop lengths {stop.tolist()} outside "
                               f"[1, {S}] or attention rows off 1 by {dev:.2e}")

    def step_frames(y, B, S):
        """Each step's input frame of the decode y: zeros, then the last
        frame of the previous group."""
        return torch.cat([torch.zeros(B, 1, D, device=y.device),
                          y.reshape(B, S, r, D)[:, :-1, -1]], 1)

    def max_diff(a, b):
        return max(float((x.to(b[0].device) - y).abs().max()) for x, y in zip(a, b))

    # --- reference recordings: seeded tones with harmonics and noise, their
    # m_fwd mels by the port's frontend on the card, padded to a batch
    t0 = time.perf_counter()
    rng = np.random.default_rng(21)
    sr = base.audio.sample_rate
    fe = AudioFrontend(base.audio, device)
    waves, mels = [], []
    for i in range(8):
        t = np.arange(int(rng.uniform(*TACO_REF_SECONDS) * sr)) / sr
        f0 = rng.uniform(90, 260)
        w = sum(0.2 / k * np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 6.3)) for k in (1, 2, 3))
        waves.append((w + 0.02 * rng.standard_normal(t.size)).astype(np.float32))
        mels.append(m_fwd(fe.encode(waves[-1])[1]))
    xrl = torch.tensor([m.shape[0] for m in mels], device=device)
    xref = torch.zeros(8, int(xrl.max()), D, device=device)
    for i, m in enumerate(mels):
        xref[i, : m.shape[0]] = m
    ref_wav = os.path.join(tmp, "ref.wav")
    wavfile.write(ref_wav, sr, np.round(np.clip(waves[0], -1, 1) * 32767).astype(np.int16))

    cfg = variant(style_dim_vae=TACO_STYLE_DIM)
    model = build_tacotron(cfg, seed=0, device=device)
    S = TACO_STEPS
    log(f"tacotron variants phase: VAE style (style_dim_vae {TACO_STYLE_DIM}) on the LJSpeech "
        f"Tacotron-2, {sum(p.numel() for p in model.parameters())} params; reference mels of "
        f"{xrl.tolist()} frames; set-up {time.perf_counter() - t0:.1f} s")

    # --- the style path, its launches counted: infer at B=1 and a ragged
    # B=8 with ragged references, every step through the kernel
    outs = {}
    ts.taco_step_streamed.launches = 0
    for B in (1, 8):
        c, cl = texts(B)
        draws = model.draw(B, c.shape[1], S, torch.Generator(device=device).manual_seed(30 + B),
                           train=False, style=True)
        kw = dict(prenet_masks=draws.prenet, xref=xref[:B], xref_lengths=xrl[:B],
                  style_eps=draws.style_eps)
        outs[B] = (c, cl, kw, model.infer(c, cl, S, **kw))
    torch.cuda.synchronize()
    launches = ts.taco_step_streamed.launches
    expected = S * (len(ts.row_groups(1)) + len(ts.row_groups(8)))
    for B, (_, _, _, out) in outs.items():
        checked(out, f"VAE B={B}", S)
    log(f"  infer B=1 and B=8 (text lengths {outs[8][1].tolist()}): stop lengths "
        f"{outs[1][3][3]['stop_lengths'].tolist()}, {outs[8][3][3]['stop_lengths'].tolist()}; "
        f"taco_step_streamed launches {launches} (expected {S} x (1 + 1) row groups)")
    if launches != expected:
        raise RuntimeError("the VAE decode did not run every step through taco_step_streamed")

    # --- the kernel route against the cell route on the same memory, masks
    # and eps; the styled memory is not zero past each text
    c, cl, kw, _ = outs[8]
    memory, _ = model.encode(c, cl, kw["xref"], kw["xref_lengths"], kw["style_eps"])
    pad_min = float(memory[-1, int(cl[-1]):].abs().min())
    if not pad_min > 0:
        raise RuntimeError("the style did not reach the memory's padding")
    for B, (c, cl, kw, (y_k, _, s_k, aux_k)) in outs.items():
        model.decoder.use_kernel = False
        y_c, _, s_c, aux_c = model.infer(c, cl, S, step_inputs=step_frames(y_k, B, S), **kw)
        model.decoder.use_kernel = True
        err = max_diff((y_c, s_c, aux_c["w"]), (y_k, s_k, aux_k["w"]))
        log(f"  B={B}: cell route with the kernel route's frames: max |d| over y, s, w "
            f"{err:.3e} (bound {TACO_TF_ATOL:g}); memory past the shortest text min |m| "
            f"{pad_min:.3e}")
        if not err <= TACO_TF_ATOL:
            raise RuntimeError(f"VAE B={B}: the kernel route and the cell route disagree")
    if ts.taco_step_streamed.launches != launches:
        raise RuntimeError("the cell route launched the kernel")

    # --- decode times with and without the style (the same weights), in turns
    for B in (1, 8):
        c, cl, kw, _ = outs[B]
        style_free = {"prenet_masks": kw["prenet_masks"]}
        times = {}
        for styled in (True, False, False, True):
            k = kw if styled else style_free
            times.setdefault(styled, []).append(wall_ms(lambda: model.infer(c, cl, S, **k),
                                                        warmup=1, reps=1))
        busy = {st: profile_busy_ms(lambda: model.infer(c, cl, S, **(kw if st else style_free)))
                for st in (True, False)}
        log(f"  decode B={B}, {S} steps on the kernel: with the style "
            f"{statistics.median(times[True]):.1f} ms/call (turns "
            f"{', '.join(f'{v:.1f}' for v in times[True])}), device busy {busy[True]:.1f} ms; "
            f"without {statistics.median(times[False]):.1f} ms/call (turns "
            f"{', '.join(f'{v:.1f}' for v in times[False])}), busy {busy[False]:.1f} ms [{card}]")

    # --- a train step with xref = x and an eval_step (no reference) at the
    # training phase's shape
    def train_batch(B, T, seed):
        g = torch.Generator(device=device).manual_seed(seed)
        c, cl = texts(B)
        xl = torch.linspace(T, T // 2, B, device=device).long()
        x = torch.rand(B, T, D, generator=g, device=device)
        x = x * (torch.arange(T, device=device)[None, :, None] < xl[:, None, None])
        return {"c": c, "c_lengths": cl, "x": x, "x_lengths": xl}

    def one_step(m, what, T):
        b = train_batch(TACO_TRAIN_B, T, 5)
        state = tt.create_train_state(m)
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = tt.train_step(state, b, generator=step_generator(3, 0, device))
        vals = {k: float(v) for k, v in metrics.items()}
        step_ms = (time.perf_counter() - t) * 1e3
        em, _ = tt.eval_step(m, b, generator=torch.Generator(device=device).manual_seed(6))
        ev = {k: float(v) for k, v in em.items()}
        if not all(math.isfinite(v) for v in (*vals.values(), *ev.values())):
            raise RuntimeError(f"{what}: a non-finite loss term or gradient norm: {vals}, {ev}")
        log(f"  {what} train step (B={TACO_TRAIN_B}, {T} frames): loss "
            f"{vals['loss']:.4f}, loss_kl {vals['loss_kl']:.4e}, grad_norm "
            f"{vals['grad_norm']:.4f}, {step_ms:.1f} ms on the host clock; eval_step loss "
            f"{ev['loss']:.4f}, loss_kl {ev['loss_kl']:.1f} [{card}]")
        return vals, ev

    vals, ev = one_step(model, "VAE", TACO_TRAIN_FRAMES)
    if not vals["loss_kl"] > 0 or ev["loss_kl"] != 0.0:
        raise RuntimeError("the VAE step has no KL term, or eval_step read a reference")

    # --- tacotron_infer --ref --plot, a process of its own on the card
    ckpt, cfg_path = os.path.join(tmp, "vae.pth"), os.path.join(tmp, "vae.json")
    out_wav, png = os.path.join(tmp, "vae.wav"), os.path.join(tmp, "vae.png")
    torch.save({"model": model.state_dict()}, ckpt)
    with open(cfg_path, "w") as f:
        json.dump({k: dataclasses.asdict(getattr(cfg, k)) for k in ("audio", "text", "model")}, f)
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "torch_tts_tpu_torch.cli.tacotron_infer",
                           SENTENCES[0], cfg_path, "-m", ckpt, "--ref", ref_wav, "--plot", png,
                           "-o", out_wav, "--max-steps", str(S), "--device", str(device)],
                          cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"tacotron_infer --ref --plot failed:\n{proc.stderr[-3000:]}")
    with open(png, "rb") as f:
        head = f.read(24)
    sr_out, pcm = wavfile.read(out_wav)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or sr_out != sr or not pcm.size:
        raise RuntimeError("tacotron_infer --ref --plot wrote no readable WAV or PNG")
    log(f"  tacotron_infer --ref --plot: {proc.stdout.strip().splitlines()[-2]}; PNG "
        f"{int.from_bytes(head[16:20], 'big')} x {int.from_bytes(head[20:24], 'big')}; "
        f"{time.perf_counter() - t:.1f} s as a process")
    del model
    torch.cuda.empty_cache()

    # --- the Tacotron-2 cell and the Tacotron-1 family at the yaml's widths
    for name, upd in TACO_VARIANTS:
        vcfg = variant(**upd)
        t0 = time.perf_counter()
        cpu = build_tacotron(vcfg, seed=0, device="cpu")
        model = copy.deepcopy(cpu).to(device)
        Sv = TACO_VARIANT_STEPS
        n0 = ts.taco_step_streamed.launches
        for B in TACO_VARIANT_B:
            c, cl = texts(B)
            masks = model.decoder.draw_prenet_masks(Sv, B, device,
                                                    torch.Generator(device=device).manual_seed(B))
            out = model.infer(c, cl, Sv, prenet_masks=masks)
            checked(out, f"{name} B={B}", Sv)
            ref = cpu.infer(c.cpu(), cl.cpu(), Sv, prenet_masks=masks.cpu(),
                            step_inputs=step_frames(out[0], B, Sv).cpu())
            err = max_diff((ref[0], ref[2], ref[3]["w"]), (out[0], out[2], out[3]["w"]))
            # the chunked decode against the whole one, on the card
            mem, mmask = model.encode(c, cl)
            n = -(-Sv // TACO_VARIANT_CHUNK) * TACO_VARIANT_CHUNK
            cm = torch.cat([masks, torch.ones_like(masks[: n - Sv])])
            carry, ys = model.decode_init(mem), []
            for t0c in range(0, n, TACO_VARIANT_CHUNK):
                carry, yc, _, _ = model.decode_chunk(mem, carry, cm[t0c:t0c + TACO_VARIANT_CHUNK],
                                                     mmask)
                ys.append(yc)
            chunk_err = float((torch.cat(ys, 1)[:, : Sv * r] - out[0]).abs().max())
            times = [wall_ms(lambda: model.infer(c, cl, Sv, prenet_masks=masks), warmup=1,
                             reps=2)]
            busy = profile_busy_ms(lambda: model.infer(c, cl, Sv, prenet_masks=masks))
            log(f"  {name} B={B}, {Sv} steps: card vs CPU with the card's frames, max |d| over "
                f"y, s, w {err:.3e} (bound {TACO_TF_ATOL:g}); chunks of {TACO_VARIANT_CHUNK} "
                f"against the whole decode "
                f"{chunk_err:.3e}; {times[0]:.1f} ms/call, device busy {busy:.1f} ms [{card}]")
            if not err <= TACO_TF_ATOL or not chunk_err <= TACO_TF_ATOL:
                raise RuntimeError(f"{name} B={B}: the card and the CPU, or the chunks and the "
                                   "whole decode, disagree")
        one_step(model, name, TACO_LOSS_FRAMES)
        synth = TacotronSynthesizer(vcfg, model, device=device)
        t = time.perf_counter()
        res = synth._collect_group(synth._dispatch_group([enc.encode(SENTENCES[1][:60])],
                                                         seed=2))[0]
        synth_ms = (time.perf_counter() - t) * 1e3
        if not res.audio.size or not np.isfinite(res.audio).all():
            raise RuntimeError(f"{name}: the synthesizer's dispatch gave empty or non-finite audio")
        if ts.taco_step_streamed.launches != n0:
            raise RuntimeError(f"{name}: its cell launched the Taco2Prod step kernel")
        log(f"  {name} TacotronSynthesizer dispatch (Griffin-Lim): "
            f"{len(res.audio) / sr:.2f} s of audio in {synth_ms:.1f} ms; phase part "
            f"{time.perf_counter() - t0:.1f} s [{card}]")
        del model, cpu, synth
        torch.cuda.empty_cache()
    return {"taco_step_streamed": launches}


def wav_within(pcm, audio, atol: float) -> bool:
    """Whether 16-bit samples `pcm` are what `cli/vits2_infer.write_wav`
    writes for some waveform within `atol` of `audio` (its rounding,
    trunc(clip(v) * 32767), is monotonic in v)."""
    import numpy as np

    lo = np.trunc(np.clip(audio - atol, -1, 1) * 32767)
    hi = np.trunc(np.clip(audio + atol, -1, 1) * 32767)
    return pcm.shape == audio.shape and bool(((pcm >= lo) & (pcm <= hi)).all())


@contextlib.contextmanager
def recorded_ops(names):
    """Records, while open, the outputs of every call of the `tts::`
    operators in `names`, in call order (a TorchDispatchMode; measurement
    off)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    calls = []

    class Recorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.namespace == "tts" and func.__name__.split(".")[0] in names:
                calls.append((func.__name__.split(".")[0], out))
            return out

    with Recorder():
        yield calls


def export_counters():
    """The launch counters of the four `tts::` operators."""
    from torch_tts_tpu_torch.kernels import int8_conv, mrf_fused, wn_stack

    return {"mrf_fused": mrf_fused.mrf_fused, "wn_group": wn_stack.wn_group,
            "quantize_act": int8_conv.quantize_act, "int8_conv1d": int8_conv.int8_conv1d}


def dispatch_costs(device, card: str):
    """Host microseconds a call of each `tts::` operator against its bare
    CUDA body (`_mrf_cuda` etc., the kernel launch without the dispatcher)
    at small shapes: DISPATCH_CALLS enqueues timed on the host clock
    (the device runs each launch faster than the host issues it), in turns
    op, bare, bare, op."""
    import torch

    from torch_tts_tpu_torch.kernels import int8_conv, mrf_fused as mrf, wn_stack
    from torch_tts_tpu_torch.ops import quant

    g = torch.Generator().manual_seed(3)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(device)

    C, k = 32, 3
    blocks = tuple(tuple(((mrf.dilated_offsets(k, d), rnd(k * C, C, scale=0.1), rnd(C)),
                          (mrf.dilated_offsets(k, 1), rnd(k * C, C, scale=0.1), rnd(C)))
                         for d in (1, 3, 5)) for _ in range(1))
    H, L = 192, 4
    wn = (rnd(1, 64, H), torch.ones(1, 64, 1, device=device), None, rnd(L, 5, H, 2 * H, scale=0.01),
          rnd(L, 2 * H), rnd(L, H, 2 * H, scale=0.01), rnd(L, 2 * H))
    x = rnd(1, 64, 64)
    x_q, s_x = int8_conv.quantize_act(x)
    w_q, s_w = quant.conv_weights(rnd(64, 64, 3, scale=0.05))
    conv = (x_q, s_x, w_q, s_w, rnd(64), [1, 1], 1, 1, None)
    cases = {"mrf_fused": (torch.ops.tts.mrf_fused, mrf._mrf_cuda,
                           (rnd(1, 256, C), *mrf.flatten_blocks(blocks))),
             "wn_group": (torch.ops.tts.wn_group, wn_stack._wn_group_cuda, wn),
             "quantize_act": (torch.ops.tts.quantize_act, int8_conv._quantize_cuda,
                              (x, 0.1, None)),
             "int8_conv1d": (torch.ops.tts.int8_conv1d, int8_conv._conv_cuda, conv)}
    costs = {}
    with torch.no_grad():
        for name, (op, bare, args) in cases.items():
            times = {"op": [], "bare": []}
            for fn in (op, bare):
                for _ in range(20):
                    fn(*args)
            for which in ("op", "bare", "bare", "op"):
                fn = op if which == "op" else bare
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(DISPATCH_CALLS):
                    fn(*args)
                times[which].append((time.perf_counter() - t0) * 1e6 / DISPATCH_CALLS)
                torch.cuda.synchronize()
            op_us, bare_us = (statistics.median(times[w]) for w in ("op", "bare"))
            costs[name] = round(op_us - bare_us, 2)
            log(f"  dispatch {name}: {op_us:.1f} us a call through torch.ops.tts against "
                f"{bare_us:.1f} us bare: {op_us - bare_us:.1f} us of dispatch (turns "
                f"{', '.join(f'{t:.1f}' for t in times['op'] + times['bare'])}) [{card}]")
    return costs


def export_phase(device, card: str, tmp: str):
    """The export path: the CLIs as processes on a run dir of seeded
    full-width LJSpeech weights (`cli/vits2_infer.py` against the in-process
    fp32 `infer`, and against a TF32 run to show what the check sees;
    `cli/export.py` at EXPORT_TEXT_LEN / EXPORT_FRAMES), the saved program
    loaded and run at B=1 against eager `infer` (the same launches of each
    `tts::` operator, audio within EXPORT_ATOL), then the int8-decoder
    model's program (its quantizer and conv outputs bit for bit, recorded
    in both runs) and the vocoder's; host and busy ms of each program
    against eager, in turns; each operator's dispatch cost."""
    import numpy as np
    import torch
    from scipy.io import wavfile

    from torch_tts_tpu_torch.cli import vits2_infer, vocoder_train
    from torch_tts_tpu_torch.core.config import TacotronConfig, VITS2Config
    from torch_tts_tpu_torch.infer import export, vocoder
    from torch_tts_tpu_torch.models.vits2.model import DEFAULT_RNG
    from torch_tts_tpu_torch.ops.layers import init_params_

    t_phase = time.perf_counter()
    base = VITS2Config()
    cfg = dataclasses.replace(
        base, data=dataclasses.replace(base.data, text_cleaners=("transliteration_cleaners",)))
    os.environ.pop("TTS_FUSED_WN", None)
    model = seeded_synthesizer(cfg, device, seed=5)
    # a run dir as the trainer writes it (ckpt_<step>.pt), which both CLIs read
    run, cfg_path = os.path.join(tmp, "run"), os.path.join(tmp, "config.json")
    os.makedirs(run)
    torch.save({"step": 100, "model": model.state_dict()}, os.path.join(run, "ckpt_100.pt"))
    with open(cfg_path, "w") as f:
        json.dump({"model": dataclasses.asdict(cfg.model),
                   "data": {**dataclasses.asdict(cfg.data), **dataclasses.asdict(cfg.audio)}}, f)
    text, seed, hop = SENTENCES[1], 4, cfg.audio.hop_length
    cli_wav, pt2 = os.path.join(tmp, "cli.wav"), os.path.join(tmp, "vits2.pt2")
    root = os.path.dirname(os.path.abspath(__file__))
    # both CLIs as processes, started together; the in-process work overlaps them
    procs = {
        "vits2_infer": subprocess.Popen(
            [sys.executable, "-m", "torch_tts_tpu_torch.cli.vits2_infer", "-c", cfg_path, "-m",
             run, "--text", text, "-o", cli_wav, "--seed", str(seed), "--max-frames",
             str(EXPORT_FRAMES), "--device", str(device)],
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        "export": subprocess.Popen(
            [sys.executable, "-m", "torch_tts_tpu_torch.cli.export", "-c", cfg_path, "-m", run,
             "-o", pt2, "--max-text-len", str(EXPORT_TEXT_LEN), "--max-frames",
             str(EXPORT_FRAMES), "--device", str(device)],
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)}

    def cli_audio(tf32: bool):
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            return vits2_infer.synthesize(
                model, vits2_infer.text_ids(text, cfg), hop, noise_scale=EXPORT_NOISE[0],
                noise_scale_w=EXPORT_NOISE[2], length_scale=EXPORT_NOISE[1],
                max_frames=EXPORT_FRAMES,
                generator=torch.Generator(device=device).manual_seed(seed))
        finally:
            torch.backends.cudnn.allow_tf32 = False

    fp32_audio, tf32_audio = cli_audio(False), cli_audio(True)

    # the int8-decoder model's program, exported in this process
    q_model = seeded_synthesizer(int8_config(), device, seed=5)
    q_pt2 = os.path.join(tmp, "int8.pt2")
    t = time.perf_counter()
    export.export_vits2_infer(q_model, EXPORT_TEXT_LEN, EXPORT_FRAMES, path=q_pt2, device=device)
    log(f"export phase: int8 model exported in {time.perf_counter() - t:.1f} s")
    # the vocoder's program (the LJSpeech vocoder of `cli/vocoder_train.py`)
    a = TacotronConfig().audio
    gen_kwargs = vocoder_train.gen_kwargs_for(a.hop_length)
    gen = vocoder.build_generator(gen_kwargs, a.num_mels)
    init_params_(gen, torch.Generator().manual_seed(2))
    voc = vocoder.Vocoder(gen, gen_kwargs, a.sample_rate, a.num_mels, device=device)
    v_pt2 = os.path.join(tmp, "vocoder.pt2")
    t = time.perf_counter()
    vocoder.export_vocoder(voc, VOCODER_EXPORT_FRAMES, path=v_pt2, device=device)
    log(f"export phase: vocoder exported in {time.perf_counter() - t:.1f} s")

    for name, proc in procs.items():
        t = time.perf_counter()
        out, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"cli/{name}.py failed:\n{err[-3000:]}")
        log(f"export phase: cli/{name}.py process done {time.perf_counter() - t_phase:.1f} s "
            f"into the phase: {(out.strip().splitlines() or [''])[-1]}")
    sr, pcm = wavfile.read(cli_wav)
    if sr != cfg.audio.sampling_rate:
        raise RuntimeError(f"cli/vits2_infer.py wrote {sr} Hz")
    for what, ref in (("fp32", fp32_audio), ("TF32", tf32_audio)):
        n = min(len(ref), len(pcm))
        diff = float(np.abs(pcm[:n] / 32767.0 - ref[:n]).max())
        ok = wav_within(pcm, ref, CLI_WAV_ATOL)
        log(f"  cli/vits2_infer.py WAV against the in-process {what} infer: {len(pcm)} vs "
            f"{len(ref)} samples, max |wav - audio| {diff:.3e} (16-bit step 3.05e-05); within "
            f"{CLI_WAV_ATOL:g} before the rounding: {ok}")
        if what == "fp32" and not ok:
            raise RuntimeError("the CLI's WAV does not match the in-process fp32 infer")
    tf32_seen = not wav_within(pcm, tf32_audio, CLI_WAV_ATOL)
    log(f"  TF32 on moves the audio by {float(np.abs(tf32_audio - fp32_audio).max()):.3e} at "
        f"most; the check {'sees' if tf32_seen else 'cannot see'} it")

    # --- the programs against eager, at B=1
    ids = vits2_infer.text_ids(SENTENCES[2], cfg)
    x = torch.zeros(1, EXPORT_TEXT_LEN, dtype=torch.int32, device=device)
    x[0, :len(ids)] = torch.tensor(ids, dtype=torch.int32)
    lengths = torch.tensor([len(ids)], dtype=torch.int32, device=device)
    scales = torch.tensor(EXPORT_NOISE, device=device)
    by_path = {}
    for what, path, eager_model in (("vits2", pt2, model), ("int8", q_pt2, q_model)):
        t = time.perf_counter()
        program = export.load_exported(path)
        log(f"export phase: {what} program loaded in {time.perf_counter() - t:.1f} s "
            f"({os.path.getsize(path) / 2 ** 20:.1f} MiB)")

        def run_program(p=program):
            torch.manual_seed(11)
            return p(x, lengths, scales)

        def run_eager(m=eager_model):
            torch.manual_seed(11)
            audio, _, _, _, y_lengths = m.infer(
                x, lengths, noise_scale=EXPORT_NOISE[0], length_scale=EXPORT_NOISE[1],
                noise_scale_w=EXPORT_NOISE[2], max_frames=EXPORT_FRAMES, generator=DEFAULT_RNG)
            return audio, y_lengths

        run_program()  # first call: cuDNN's algorithm choice, the MRF plans
        (got, got_len), n_prog = counted(run_program, export_counters())
        (want, want_len), n_eager = counted(run_eager, export_counters())
        check_audio(got, got_len, hop, f"exported {what}", EXPORT_FRAMES)
        diff = float((got - want).abs().max())
        log(f"  {what} program at B=1: y_lengths {got_len.tolist()} (eager "
            f"{want_len.tolist()}), max |exported - eager| {diff:.3e} (bound {EXPORT_ATOL:g}); "
            f"launches {n_prog} (eager {n_eager})")
        if not torch.equal(got_len, want_len) or diff > EXPORT_ATOL:
            raise RuntimeError(f"the exported {what} program disagrees with eager infer")
        if n_prog != n_eager or not n_prog["mrf_fused"] or not n_prog["wn_group"]:
            raise RuntimeError(f"the exported {what} program's launches differ: {n_prog}")
        by_path.setdefault("export", {})
        for n, c in n_prog.items():
            if c:
                by_path["export"][n] = by_path["export"].get(n, 0) + c
        if what == "int8":
            if not n_prog["quantize_act"] or not n_prog["int8_conv1d"]:
                raise RuntimeError("the int8 program launched no int8 kernel")
            names = ("quantize_act", "int8_conv1d")
            with recorded_ops(names) as prog_calls:
                run_program()
            with recorded_ops(names) as eager_calls:
                run_eager()
            same = len(prog_calls) == len(eager_calls) and all(
                a[0] == b[0] and all(torch.equal(u, v) for u, v in zip(
                    a[1] if isinstance(a[1], tuple) else (a[1],),
                    b[1] if isinstance(b[1], tuple) else (b[1],)))
                for a, b in zip(prog_calls, eager_calls))
            log(f"  int8 program: {len(prog_calls)} quantizer and conv calls, each output equal "
                f"to eager's bit for bit: {same}")
            if not same:
                raise RuntimeError("the exported int8 kernels differ from eager's")
        times_of({"eager": run_eager, "exported": run_program}, card, f"{what} infer B=1")

    # --- the vocoder's program against `Vocoder.wave`
    program = export.load_exported(v_pt2)
    mel = torch.rand(1, VOCODER_EXPORT_FRAMES, a.num_mels, generator=torch.Generator()
                     .manual_seed(6)).to(device)
    program(mel)
    got, n_prog = counted(lambda: program(mel), export_counters())
    want, n_eager = counted(lambda: voc.wave(mel), export_counters())
    diff = float((got - want).abs().max())
    log(f"  vocoder program: wav {tuple(got.shape)}, max |exported - eager| {diff:.3e}; "
        f"launches {n_prog} (eager {n_eager})")
    if got.shape != (1, VOCODER_EXPORT_FRAMES * a.hop_length) or diff > EXPORT_ATOL \
            or n_prog != n_eager or not n_prog["mrf_fused"]:
        raise RuntimeError("the exported vocoder disagrees with Vocoder.wave")
    by_path["export"]["mrf_fused"] += n_prog["mrf_fused"]
    times_of({"eager": lambda: voc.wave(mel), "exported": lambda: program(mel)}, card,
             "vocoder")
    dispatch = dispatch_costs(device, card)
    log(f"export phase: {time.perf_counter() - t_phase:.1f} s")
    return by_path["export"], dispatch


def times_of(fns, card: str, what: str):
    """Logs the host ms (median of turns a, b, b, a) and device busy ms of
    each callable of `fns` (two)."""
    names = list(fns)
    times = {n: [] for n in names}
    for n in (names[0], names[1], names[1], names[0]):
        times[n].append(wall_ms(fns[n], warmup=1, reps=3))
    out = {}
    for n in names:
        out[n] = (statistics.median(times[n]), profile_busy_ms(fns[n]))
        log(f"  {what} {n}: {out[n][0]:.2f} ms on the host clock (turns "
            f"{', '.join(f'{t:.2f}' for t in times[n])}); device busy {out[n][1]:.2f} ms "
            f"[{card}]")
    return out


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
    by_path = {}  # each main path's own launch counts
    with tempfile.TemporaryDirectory() as tmp:
        by_path["inference"] = timed("inference", slice_phase, device, card, tmp)
        by_path["tacotron"] = timed("tacotron", tacotron_phase, device, card, tmp)
    by_path["training"] = timed("training", train_phase, device, card)
    with tempfile.TemporaryDirectory() as tmp:
        by_path["trainer"] = timed("trainer", trainer_phase, device, card, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        by_path["bf16 train"], bf16_stats = timed("bf16 train", bf16_train_phase, device, card,
                                                  tmp)
    stats.update(bf16_stats)
    with tempfile.TemporaryDirectory() as tmp:
        by_path["multi-speaker"] = timed("multi-speaker", multispeaker_phase, device, card, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        by_path["serving"] = timed("serving", serving_phase, device, card, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        by_path["mb-istft"] = timed("mb-istft", mbistft_phase, device, card, tmp)
    by_path["int8 decoder"], int8_stats = timed("int8 decoder", int8_phase, device, card)
    stats.update(int8_stats)
    with tempfile.TemporaryDirectory() as tmp:
        by_path["export"], dispatch = timed("export", export_phase, device, card, tmp)
    for n, us in dispatch.items():
        stats[n]["dispatch_us"] = us
    with tempfile.TemporaryDirectory() as tmp:
        by_path["tacotron serving"] = timed("tacotron serving", taco_serving_phase, device, card,
                                            tmp)
    with tempfile.TemporaryDirectory() as tmp:
        by_path["tacotron training"] = timed("tacotron training", taco_training_phase, device,
                                             card, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        by_path["tacotron variants"] = timed("tacotron variants", taco_variants_phase, device,
                                             card, tmp)
    by_path["mel frontend"] = timed("mel frontend", mel_frontend_phase, device, card)
    by_path["lltm"] = timed("lltm", lltm_phase, device, card)
    # launches: the last of these paths that runs the kernel (wn_group: the
    # train step's), plus the trainer's, the multi-speaker path's, the
    # serving path's, the MB-iSTFT path's and the Tacotron serving,
    # training and variants paths'
    launches = {}
    for p in ("inference", "tacotron", "training", "mel frontend", "lltm"):
        launches.update(by_path[p])
    for p in ("trainer", "bf16 train", "multi-speaker", "serving", "mb-istft", "int8 decoder",
              "export", "tacotron serving", "tacotron training", "tacotron variants"):
        for n, c in by_path[p].items():
            launches[n] = launches.get(n, 0) + c
    # the fused step is on no model path: its count is the kernel phase's
    launches["taco_step_fused"] = stats["taco_step_fused"]["launches"]
    by_path["kernel phase"] = {"taco_step_fused": launches["taco_step_fused"]}

    sources = {"mrf_fused": ("torch_tts_tpu_torch/csrc/mrf_fused.cu",
                             "torch_tts_tpu/kernels/mrf_fused.py:150"),
               "wn_group": ("torch_tts_tpu_torch/csrc/wn_stack.cu",
                            "torch_tts_tpu/kernels/wn_stack.py:156"),
               "wn_group_backward": ("torch_tts_tpu_torch/csrc/wn_stack.cu",
                                     "torch_tts_tpu/kernels/wn_stack.py:330"),
               # the bf16 kernels for the same TPU kernels (bf16 training)
               "wn_group_bf16": ("torch_tts_tpu_torch/csrc/wn_stack_bf16.cu",
                                 "torch_tts_tpu/kernels/wn_stack.py:156"),
               "wn_group_backward_bf16": ("torch_tts_tpu_torch/csrc/wn_stack_bf16.cu",
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
                        "torch_tts_tpu/kernels/gated_cell.py:81"),
               # no Pallas counterpart: XLA work in the JAX package's int8 decoder
               "quantize_act": ("torch_tts_tpu_torch/csrc/int8_conv.cu",
                                "torch_tts_tpu/ops/quant.py:47"),
               "int8_conv1d": ("torch_tts_tpu_torch/csrc/int8_conv.cu",
                               "torch_tts_tpu/ops/quant.py:54")}
    # library_ms: the torch.stft mel's device busy time for the STFT+mel
    # kernel (whose ms and plain_ms are device busy times too); for the int8
    # conv `torch._int_mm` on x_q unfolded to [B T_out, k Cp] (built outside
    # the timing) and w_q, the int8 product without the dequantize (PyTorch
    # has no int8 convolution on the card; fp32_conv_ms is fp32 cuDNN at the
    # same shape). No single PyTorch call computes the quantizer (a symmetric
    # per-tensor int8 quantization with this scale, its max taken on the
    # card) or any of the other functions. The int8 kernels' ms, plain_ms,
    # library_ms and bound_ms are one call at their dominant `shape` (timed
    # over CUDA graphs); the *_per_infer fields sum the calls of one B=1
    # int8 infer. dispatch_us: the host microseconds a call through the
    # `tts::` operator adds over its bare CUDA body (export phase)
    kernels = [dict(name=n, route="cuda", source=src, replaces=rep, launches=launches[n],
                    launches_by_path={p: c[n] for p, c in by_path.items() if n in c},
                    max_abs_err=stats[n]["max_abs_err"], ms=stats[n]["ms"],
                    plain_ms=stats[n]["plain_ms"], bound_ms=stats[n]["bound"][0],
                    bound_by=stats[n]["bound"][1], library_ms=stats[n].get("library_ms"),
                    **{k: v for k, v in stats[n].items()
                       if k in INT8_FIELDS + BF16_FIELDS + ("dispatch_us",)})
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
