"""Tacotron training losses (port of `torch_tts_tpu/models/tacotron/losses.py`).

`mel_loss_fn` (order 0: volume-weighted asymmetric L1, 1: L1, 2: RMSE;
masked or not), `alignment_max_loss`, `alignment_std_loss`,
`stop_bce_loss` (the positive class weighted 0.1) and `tacotron_loss`, the
mix 0.8 mel + 0.2 mel_post + 0.1 stop + 2e-4 kl + 1e-4 w, whose mel terms
add the unmasked L1 of the frame-to-frame differences.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F


def mel_loss_fn(y: torch.Tensor, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                order: int = 1) -> torch.Tensor:
    """y, x [B, T, D]; mask [B, T, 1] or None (the plain mean)."""
    if order == 0:
        vol = torch.clamp(x.detach().mean(dim=2, keepdim=True), min=0.1)
        diff = y - x
        loss = torch.where(diff > 0, vol * diff, -diff)
    elif order == 1:
        loss = torch.abs(x - y)
    else:
        loss = torch.square(x - y)
    if mask is None:
        loss = loss.mean()
    else:
        loss = torch.sum((loss * mask).mean(dim=2)) / torch.clamp(mask.sum(), min=1.0)
    return loss if order in (0, 1) else torch.sqrt(loss)


def alignment_max_loss(w: torch.Tensor) -> torch.Tensor:
    """Penalises weak per-step maxima of w [B, S, L]."""
    return torch.mean(1.0 - w.max(dim=2).values)


def alignment_std_loss(w: torch.Tensor) -> torch.Tensor:
    """The root mean variance of each step's attention position."""
    t = torch.arange(w.shape[2], dtype=w.dtype, device=w.device)[None, None, :]
    w_var = torch.sum(w * t ** 2, dim=2) - torch.sum(w * t, dim=2) ** 2
    return torch.sqrt(torch.mean(torch.clamp(w_var, min=0.0)))


def stop_bce_loss(s_logits: torch.Tensor, target_mask: torch.Tensor,
                  pos_weight: float = 0.1) -> torch.Tensor:
    """BCE with logits on the stop channel; the target is the in-sequence
    mask, its positive class weighted pos_weight."""
    y = target_mask.to(torch.float32)
    x = s_logits.to(torch.float32)
    return -torch.mean(pos_weight * y * F.logsigmoid(x) + (1.0 - y) * F.logsigmoid(-x))


def tacotron_loss(y, y_post, s, x, xmask, w, kl_loss) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """y, y_post [B, T, D] (decoder and postnet mels), s [B, T, 1] stop
    logits, x [B, >= T, D] targets, xmask [B, >= T] bool, w [B, S, L]
    -> (loss, metrics)."""
    T = y.shape[1]
    x, xmask = x[:, :T], xmask[:, :T]
    m = xmask[..., None].to(y.dtype)
    dx = torch.diff(x, dim=1)
    loss_mel = mel_loss_fn(y, x, m, 1) + mel_loss_fn(torch.diff(y, dim=1), dx, order=1)
    loss_mel_post = mel_loss_fn(y_post, x, m, 1) + mel_loss_fn(torch.diff(y_post, dim=1), dx,
                                                               order=1)
    loss_stop = stop_bce_loss(s[..., 0], xmask)
    loss_w = alignment_std_loss(w)
    loss = 0.8 * loss_mel + 0.2 * loss_mel_post + 0.1 * loss_stop
    loss = loss + 2e-4 * kl_loss + 1e-4 * loss_w
    metrics = {"loss": loss, "loss_mel_db": 100.0 * loss_mel,
               "loss_mel_post_db": 100.0 * loss_mel_post, "loss_stop": loss_stop,
               "loss_kl": kl_loss, "loss_w": loss_w}
    return loss, metrics
