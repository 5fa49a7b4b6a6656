"""One eval-mode Taco2Prod decoder step (the Tacotron-2 autoregressive step).

Replaces the TPU kernels `torch_tts_tpu/kernels/taco_step.py`
(`taco_step_fused` -> `_kernel`, weights resident; `taco_step_streamed` ->
`_streamed_kernel`, the four big LSTM matrices streamed, fp32 or bf16) with
one CUDA kernel, `torch_tts_tpu_torch/csrc/taco_step.cu`, behind two entry
points with the JAX functions' contracts:

- `taco_step_fused(y_in, state, memory, mmask, wts, p_zoneout)` with
  `TacoStepWeights` in the JAX layouts ([in, out] matrices);
- `taco_step_streamed(y_in, state, memory, mmask, packed, p_zoneout, n_tile)`
  with `pack_streamed(wts, dtype)`: each LSTM's [w_ih; w_hh] concatenated
  once (as the JAX wrapper's concatenation is hoisted out of the AR loop),
  fp32 or bf16, in the kernel's tile-major layout [H / 8, K, 32]: the
  rows of each 8-unit tile (its 4 gates x 8 columns) contiguous, so the
  CTA that owns a tile streams one contiguous range. `n_tile` is the TPU
  kernel's DMA tile: the kernel here has no use for it, but the call
  raises on the JAX function's rule (4 H divisible by n_tile), so both
  accept the same arguments.

`taco_step_plain` is the port of `taco_step_ref`. bf16 matrices reach it
widened to fp32, as the kernel widens them: activations stay fp32 (the TPU
kernel rounds them to bf16 too, so the two packages' bf16 results differ
by that rounding).

One extension of the TPU contract: `prenet_masks`, None (no dropout, the
TPU kernel exactly) or a pair of PreNet keep masks [B, P], applied as
where(mask, x / (1 - PRENET_DROPOUT), 0) after each PreNet ReLU. The JAX
model keeps the PreNet's dropout on at inference, so the model passes them.

Any batch: the kernel takes at most `ROWS_PER_LAUNCH` (8) rows, so on the
card the wrapper splits the batch into groups of at most 8 rows
(`row_groups`) and launches the kernel once per group, on row views of the
same tensors (no copies). Rows are independent in the step, so the groups
give the whole batch's result; each launch streams the weights once more.

The kernel's launch has no grid-wide barrier: its dependencies are counters
in a small device buffer that persists across launches, one buffer per
(device, stream), with the number of launches made on it (`_counters`).
Launches take a lock around reading that number and enqueueing, so host
threads that decode at once on one stream (a server's batcher and its
stream handlers) enqueue their launches in the order of their numbers.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. `taco_step_fused_via_plain` and
`taco_step_streamed_via_plain` take the plain version on any device.
`taco_step_fused.launches` and `taco_step_streamed.launches` count kernel
launches (one per row group).
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from torch_tts_tpu_torch.kernels import build
from torch_tts_tpu_torch.ops.tacotron_attention import shift_monotonic
from torch_tts_tpu_torch.ops.tacotron_blocks import dropout_with_mask, isru_sigmoid

PRENET_DROPOUT = 0.5  # the Taco2Prod PreNet's p
ROWS_PER_LAUNCH = 8  # rows one launch of the kernel takes


def row_groups(B: int):
    """[(b0, b1), ...]: the batch's rows in groups of at most ROWS_PER_LAUNCH,
    one kernel launch each."""
    return [(b0, min(b0 + ROWS_PER_LAUNCH, B)) for b0 in range(0, B, ROWS_PER_LAUNCH)]


class TacoStepWeights(NamedTuple):
    """Parameters of one Taco2Prod step, channels-last layouts."""

    prenet_w1: torch.Tensor  # [D_mel, P]
    prenet_b1: torch.Tensor  # [P]
    prenet_w2: torch.Tensor  # [P, P]
    prenet_b2: torch.Tensor  # [P]
    att_w_ih: torch.Tensor  # [P + Dc, 4*H1]
    att_w_hh: torch.Tensor  # [H1, 4*H1]
    att_b: torch.Tensor  # [4*H1] (b_ih + b_hh)
    query_w: torch.Tensor  # [H1, Dc]
    dec_w_ih: torch.Tensor  # [H1 + Dc, 4*H2]
    dec_w_hh: torch.Tensor  # [H2, 4*H2]
    dec_b: torch.Tensor  # [4*H2]
    mel_w: torch.Tensor  # [H2 + Dc, r*D_mel]
    mel_b: torch.Tensor  # [r*D_mel]
    stop_w: torch.Tensor  # [H2 + Dc, r]
    stop_b: torch.Tensor  # [r]


class TacoStepState(NamedTuple):
    w: torch.Tensor  # [B, L]
    ctx: torch.Tensor  # [B, Dc]
    h_att: torch.Tensor  # [B, H1]
    c_att: torch.Tensor  # [B, H1]
    h_dec: torch.Tensor  # [B, H2]
    c_dec: torch.Tensor  # [B, H2]


_BIG = ("att_w_ih", "att_w_hh", "dec_w_ih", "dec_w_hh")
_SMALL = tuple(f for f in TacoStepWeights._fields if f not in _BIG)


class TacoStepStreamed(NamedTuple):
    """`pack_streamed`'s output: the small weights in fp32 and each LSTM's
    [w_ih; w_hh] rows concatenated, fp32 or bf16, tile-major: element
    [u // 8, k, gate * 8 + u % 8] is W[k, gate * H + u]."""

    prenet_w1: torch.Tensor
    prenet_b1: torch.Tensor
    prenet_w2: torch.Tensor
    prenet_b2: torch.Tensor
    att_b: torch.Tensor
    query_w: torch.Tensor
    dec_b: torch.Tensor
    mel_w: torch.Tensor
    mel_b: torch.Tensor
    stop_w: torch.Tensor
    stop_b: torch.Tensor
    att_w: torch.Tensor  # [H1 / 8, P + Dc + H1, 32]
    dec_w: torch.Tensor  # [H2 / 8, H1 + Dc + H2, 32]


def _tile_major(w: torch.Tensor) -> torch.Tensor:
    """[K, 4H] -> [H / 8, K, 32]: element [u // 8, k, gate * 8 + u % 8] is
    w[k, gate * H + u]."""
    K, H = w.shape[0], w.shape[1] // 4
    if H % 8:
        raise ValueError(f"pack_streamed: H={H} must be a multiple of 8")
    return w.reshape(K, 4, H // 8, 8).permute(2, 0, 1, 3).reshape(H // 8, K, 32).contiguous()


def _from_tile_major(w: torch.Tensor) -> torch.Tensor:
    """The inverse of _tile_major: [H / 8, K, 32] -> [K, 4H]."""
    T, K = w.shape[:2]
    return w.reshape(T, K, 4, 8).permute(1, 2, 0, 3).reshape(K, 32 * T)


def pack_streamed(wts: TacoStepWeights, dtype: torch.dtype = torch.float32) -> TacoStepStreamed:
    """Once per decode: concatenate each LSTM's matrices in `dtype` (fp32 or
    bf16), tile-major; the small weights fp32 and contiguous."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"pack_streamed: LSTM matrices are fp32 or bf16, not {dtype}")
    small = {f: getattr(wts, f).float().contiguous() for f in _SMALL}
    return TacoStepStreamed(
        **small,
        att_w=_tile_major(torch.cat([wts.att_w_ih.to(dtype), wts.att_w_hh.to(dtype)], 0)),
        dec_w=_tile_major(torch.cat([wts.dec_w_ih.to(dtype), wts.dec_w_hh.to(dtype)], 0)))


def _lstm(x, h, c, w_ih, w_hh, b, p_zoneout):
    gates = x @ w_ih + h @ w_hh + b
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    # zoneout eval blend
    return p_zoneout * h + (1 - p_zoneout) * h_new, p_zoneout * c + (1 - p_zoneout) * c_new


def taco_step_plain(y_in, state: TacoStepState, memory, mmask, wts: TacoStepWeights,
                    p_zoneout: float = 0.1,
                    prenet_masks: Optional[Sequence[torch.Tensor]] = None):
    """Port of `taco_step_ref` (fp32): -> (y [B, r*D_mel], s [B, r], new state)."""
    wts = TacoStepWeights(*(w.float() for w in wts))
    m1, m2 = prenet_masks if prenet_masks is not None else (None, None)
    x = dropout_with_mask(F.relu(y_in @ wts.prenet_w1 + wts.prenet_b1), m1, PRENET_DROPOUT)
    x_pre = dropout_with_mask(F.relu(x @ wts.prenet_w2 + wts.prenet_b2), m2, PRENET_DROPOUT)

    h_att, c_att = _lstm(torch.cat([x_pre, state.ctx], -1), state.h_att, state.c_att,
                         wts.att_w_ih, wts.att_w_hh, wts.att_b, p_zoneout)
    q = h_att @ wts.query_w
    e = torch.sum(memory * q[:, None, :], dim=-1).clone()
    e[:, -1] = 1e4
    w_new = shift_monotonic(state.w, isru_sigmoid(e))
    if mmask is not None:
        w_new = w_new * mmask
    ctx = torch.sum(memory * w_new[:, :, None], dim=1)
    h_dec, c_dec = _lstm(torch.cat([h_att, ctx], -1), state.h_dec, state.c_dec,
                         wts.dec_w_ih, wts.dec_w_hh, wts.dec_b, p_zoneout)

    out = torch.cat([h_dec, ctx], -1)
    y = F.leaky_relu(out @ wts.mel_w + wts.mel_b, 0.01)
    s = out @ wts.stop_w + wts.stop_b
    return y, s, TacoStepState(w_new, ctx, h_att, c_att, h_dec, c_dec)


def _check_n_tile(packed: TacoStepStreamed, n_tile: int):
    for n, name in ((32 * packed.att_w.shape[0], "att"), (32 * packed.dec_w.shape[0], "dec")):
        if n % n_tile:
            raise ValueError(f"4*H_{name}={n} not divisible by n_tile={n_tile}")


def _unpacked(packed: TacoStepStreamed) -> TacoStepWeights:
    """The JAX layouts back, widened to fp32."""
    P, Dc = packed.prenet_w2.shape[1], packed.query_w.shape[1]
    H1 = packed.query_w.shape[0]
    att, dec = (_from_tile_major(w).float() for w in (packed.att_w, packed.dec_w))
    small = {f: getattr(packed, f) for f in _SMALL}
    return TacoStepWeights(**small, att_w_ih=att[:P + Dc], att_w_hh=att[P + Dc:],
                           dec_w_ih=dec[:H1 + Dc], dec_w_hh=dec[H1 + Dc:])


def taco_step_fused_via_plain(y_in, state, memory, mmask, wts, p_zoneout=0.1, prenet_masks=None):
    """`taco_step_fused`'s contract through the plain version, on any device."""
    return taco_step_plain(y_in, state, memory, mmask, wts, p_zoneout, prenet_masks)


def taco_step_streamed_via_plain(y_in, state, memory, mmask, packed: TacoStepStreamed,
                                 p_zoneout=0.1, n_tile: int = 512, prenet_masks=None):
    """`taco_step_streamed`'s contract through the plain version, on any device."""
    _check_n_tile(packed, n_tile)
    return taco_step_plain(y_in, state, memory, mmask, _unpacked(packed), p_zoneout, prenet_masks)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


_COUNTERS = {}  # (device index, stream) -> [the kernel's counters, launches made on them]
_LAUNCH_LOCK = threading.Lock()  # a launch's number and its place in the stream go together


def _counters(dev: torch.device, stream: torch.cuda.Stream):
    """The step kernel's dependency counters of one stream (zero before its
    first launch) and the count of launches made on them."""
    key = (dev.index, stream.cuda_stream)
    if key not in _COUNTERS:
        with torch.cuda.stream(stream):
            _COUNTERS[key] = [torch.zeros(8, dtype=torch.int32, device=dev), 0]
    return _COUNTERS[key]


def check_step_args(y_in, state: TacoStepState, memory, mmask, prenet_masks, small: dict,
                    big: Sequence[torch.Tensor]):
    """The kernel's checks on one step's arguments, any B >= 1 -> (B, L, D_mel,
    P, Dc, H1, H2, r); raises ValueError on what the kernel does not take.
    `big` is (att_w_ih, att_w_hh, dec_w_ih, dec_w_hh) in the JAX layout, or
    pack_streamed's (att_w, dec_w)."""
    B, L, Dc = memory.shape
    D_mel, P = small["prenet_w1"].shape
    H1, H2 = state.h_att.shape[1], state.h_dec.shape[1]
    r = small["stop_b"].shape[0]
    if B < 1:
        raise ValueError(f"taco_step: B={B}, the kernel takes B >= 1")
    if H1 % 8 or H2 % 8 or Dc % 4 or Dc > 1024:
        raise ValueError(f"taco_step: H1={H1} and H2={H2} must be multiples of 8, Dc={Dc} a "
                         "multiple of 4 up to 1024")
    wdt = big[0].dtype
    if wdt not in (torch.float32, torch.bfloat16) or any(w.dtype != wdt for w in big):
        raise ValueError("taco_step: the four LSTM matrices must all be fp32 or all bf16")
    if len(big) == 2:
        lstm = ((big[0], (H1 // 8, P + Dc + H1, 32)), (big[1], (H2 // 8, H1 + Dc + H2, 32)))
    else:
        lstm = ((big[0], (P + Dc, 4 * H1)), (big[1], (H1, 4 * H1)), (big[2], (H1 + Dc, 4 * H2)),
                (big[3], (H2, 4 * H2)))
    shapes = (*lstm, (small["prenet_b1"], (P,)), (small["prenet_w2"], (P, P)),
              (small["prenet_b2"], (P,)), (small["att_b"], (4 * H1,)), (small["query_w"], (H1, Dc)),
              (small["dec_b"], (4 * H2,)), (small["mel_w"], (H2 + Dc, r * D_mel)),
              (small["mel_b"], (r * D_mel,)), (small["stop_w"], (H2 + Dc, r)), (y_in, (B, D_mel)),
              (mmask, (B, L)), *zip(state, ((B, L), (B, Dc), (B, H1), (B, H1), (B, H2), (B, H2))),
              *((m, (B, P)) for m in prenet_masks or ()))
    for t, shape in shapes:
        if tuple(t.shape) != shape:
            raise ValueError(f"taco_step: tensor of shape {tuple(t.shape)}, expected {shape}")
    dev = y_in.device
    if any(t.device != dev for t in (*state, memory, mmask, *small.values(), *big, *(prenet_masks or ()))):
        raise ValueError("taco_step: all tensors must be on one CUDA device")
    return B, L, D_mel, P, Dc, H1, H2, r


def prepare_cuda(y_in, state: TacoStepState, memory, mmask, prenet_masks, small: dict,
                 big: Sequence[torch.Tensor], p_zoneout: float):
    """Check and lay out one step of csrc/taco_step.cu -> (launch, outputs):
    `launch()` runs the kernel into the outputs (y, s, new state), one
    launch per row group, and returns the number of launches; it counts
    nothing. `small` maps the _SMALL names to tensors, `big` is (att_w_ih,
    att_w_hh, dec_w_ih, dec_w_hh) in the JAX layout or pack_streamed's
    tile-major (att_w, dec_w)."""
    dev = y_in.device
    B, L, D_mel, P, Dc, H1, H2, r = check_step_args(y_in, state, memory, mmask, prenet_masks,
                                                    small, big)
    wdt = big[0].dtype
    ins = [_f32(y_in), *(_f32(s) for s in state), _f32(memory), _f32(mmask)]
    masks = [None, None] if prenet_masks is None else [_f32(m) for m in prenet_masks]
    sm = {k: _f32(v) for k, v in small.items()}
    bg = [w.contiguous() for w in big]
    f32 = dict(device=dev, dtype=torch.float32)
    outs = [torch.empty(B, r * D_mel, **f32), torch.empty(B, r, **f32), torch.empty(B, L, **f32),
            torch.empty(B, Dc, **f32), torch.empty(B, H1, **f32), torch.empty(B, H1, **f32),
            torch.empty(B, H2, **f32), torch.empty(B, H2, **f32)]
    groups = row_groups(B)
    scratch = torch.empty(min(B, ROWS_PER_LAUNCH) * (Dc + 2 * P + L), **f32)
    weights = [sm[k].data_ptr() for k in ("prenet_w1", "prenet_b1", "prenet_w2", "prenet_b2")]
    tile_major = len(bg) == 2
    att_ih, att_hh, dec_ih, dec_hh = (bg[0], bg[0], bg[1], bg[1]) if tile_major else bg
    weights += [att_ih.data_ptr(), att_hh.data_ptr(), sm["att_b"].data_ptr(),
                sm["query_w"].data_ptr(), dec_ih.data_ptr(), dec_hh.data_ptr(), sm["dec_b"].data_ptr()]
    weights += [sm[k].data_ptr() for k in ("mel_w", "mel_b", "stop_w", "stop_b")]
    ptr_arrs = []
    for b0, b1 in groups:  # row views: each group's rows are contiguous in every tensor
        ptrs = [t[b0:b1].data_ptr() for t in ins]
        ptrs += [0 if m is None else m[b0:b1].data_ptr() for m in masks] + weights
        ptrs += [o[b0:b1].data_ptr() for o in outs] + [scratch.data_ptr()]
        if any(p % 16 for p in ptrs):
            raise ValueError("taco_step: every tensor must be 16-byte aligned")
        ptr_arrs.append((b1 - b0, torch.tensor(ptrs, dtype=torch.int64)))
    scalars = torch.tensor([p_zoneout, 1.0 - PRENET_DROPOUT], dtype=torch.float32)
    lib = build.load_library()
    keep = (ins, masks, sm, bg, outs, scratch)  # the pointers' tensors live as long as launch

    def launch(_keep=keep):
        with torch.cuda.device(dev), _LAUNCH_LOCK:
            stream = torch.cuda.current_stream(dev)
            counters = _counters(dev, stream)
            for rows, ptr_arr in ptr_arrs:
                epoch = (counters[1] + 1) % 2 ** 32  # ctypes passes its low 32 bits
                code = lib.tts_taco_step_forward(
                    ptr_arr.data_ptr(), scalars.data_ptr(), rows, L, D_mel, P, Dc, H1, H2, r,
                    int(wdt == torch.bfloat16), int(tile_major), counters[0].data_ptr(), epoch,
                    stream.cuda_stream)
                build.check_cuda_error(code, "taco_step")
                counters[1] = epoch
        return len(ptr_arrs)

    return launch, (outs[0], outs[1], TacoStepState(*outs[2:]))


def launch_args(weights):
    """TacoStepWeights or TacoStepStreamed -> (small, big) for prepare_cuda."""
    small = {f: getattr(weights, f) for f in _SMALL}
    if isinstance(weights, TacoStepStreamed):
        return small, (weights.att_w, weights.dec_w)
    return small, [getattr(weights, f).float() for f in _BIG]


def _step_cuda(y_in, state, memory, mmask, prenet_masks, weights, p_zoneout):
    """-> (launches, (y, s, new state))."""
    if mmask is None:
        mmask = torch.ones_like(state.w)
    launch, out = prepare_cuda(y_in, state, memory, mmask, prenet_masks, *launch_args(weights),
                               p_zoneout)
    return launch(), out


def _device_of(y_in: torch.Tensor, name: str) -> str:
    if y_in.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {y_in.device}")
    return y_in.device.type


def taco_step_fused(y_in, state: TacoStepState, memory, mmask, wts: TacoStepWeights,
                    p_zoneout: float = 0.1,
                    prenet_masks: Optional[Sequence[torch.Tensor]] = None):
    """One step with the weights as given. Same contract as taco_step_plain."""
    if _device_of(y_in, "taco_step_fused") == "cpu":
        return taco_step_fused_via_plain(y_in, state, memory, mmask, wts, p_zoneout, prenet_masks)
    n, out = _step_cuda(y_in, state, memory, mmask, prenet_masks, wts, p_zoneout)
    build.count_launch(taco_step_fused, n)
    return out


def taco_step_streamed(y_in, state: TacoStepState, memory, mmask, packed: TacoStepStreamed,
                       p_zoneout: float = 0.1, n_tile: int = 512,
                       prenet_masks: Optional[Sequence[torch.Tensor]] = None):
    """One step with `pack_streamed`'s matrices (fp32 or bf16). Same
    contract as taco_step_plain."""
    if _device_of(y_in, "taco_step_streamed") == "cpu":
        return taco_step_streamed_via_plain(y_in, state, memory, mmask, packed, p_zoneout, n_tile,
                                            prenet_masks)
    _check_n_tile(packed, n_tile)
    n, out = _step_cuda(y_in, state, memory, mmask, prenet_masks, packed, p_zoneout)
    build.count_launch(taco_step_streamed, n)
    return out


taco_step_fused.launches = 0
taco_step_streamed.launches = 0


def weights_from_state_dict(sd, prefix: str = "decoder.") -> TacoStepWeights:
    """Step weights from the port's Tacotron state dict (the reference's
    names; torch [out, in] layouts -> [in, out]); the counterpart of the JAX
    `weights_from_cell_params`."""
    c = f"{prefix}decoder_cell."
    t = lambda k: sd[k].t()  # noqa: E731
    return TacoStepWeights(
        prenet_w1=t(f"{c}pre_net.layers.0.weight"), prenet_b1=sd[f"{c}pre_net.layers.0.bias"],
        prenet_w2=t(f"{c}pre_net.layers.1.weight"), prenet_b2=sd[f"{c}pre_net.layers.1.bias"],
        att_w_ih=t(f"{c}attention_rnn.weight_ih"), att_w_hh=t(f"{c}attention_rnn.weight_hh"),
        att_b=sd[f"{c}attention_rnn.bias_ih"] + sd[f"{c}attention_rnn.bias_hh"],
        query_w=t(f"{c}attention_module.query_layer.weight"),
        dec_w_ih=t(f"{c}decoder_rnn.weight_ih"), dec_w_hh=t(f"{c}decoder_rnn.weight_hh"),
        dec_b=sd[f"{c}decoder_rnn.bias_ih"] + sd[f"{c}decoder_rnn.bias_hh"],
        mel_w=t(f"{prefix}fc_mel.weight"), mel_b=sd[f"{prefix}fc_mel.bias"],
        stop_w=t(f"{prefix}fc_stop.weight"), stop_b=sd[f"{prefix}fc_stop.bias"])
