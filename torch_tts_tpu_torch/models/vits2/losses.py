"""VITS2 training losses (port of `torch_tts_tpu/models/vits2/losses.py`).

Sums over sub-discriminators, as the `ddp` step order (the reference's
train.py) weighs them. Layout-agnostic: every loss is a mean or a masked
sum of elementwise terms.
"""

from __future__ import annotations

import torch


def feature_loss(fmap_r, fmap_g) -> torch.Tensor:
    """Doubled L1 feature matching; no gradient into the real maps."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl.detach().float() - gl.float()))
    return loss * 2.0


def discriminator_loss(disc_real_outputs, disc_generated_outputs):
    """LSGAN D loss -> (total, per-disc real [n], per-disc generated [n])."""
    r = torch.stack([torch.mean((1.0 - dr.float()) ** 2) for dr in disc_real_outputs])
    g = torch.stack([torch.mean(dg.float() ** 2) for dg in disc_generated_outputs])
    return torch.sum(r) + torch.sum(g), r, g


def generator_loss(disc_outputs):
    """LSGAN G loss -> (total, per-disc [n])."""
    per = torch.stack([torch.mean((1.0 - dg.float()) ** 2) for dg in disc_outputs])
    return torch.sum(per), per


def kl_loss(z_p, logs_q, m_p, logs_p, z_mask) -> torch.Tensor:
    """Masked gaussian KL between posterior samples and the expanded prior;
    z_mask broadcasts against the others."""
    z_p, logs_q, m_p, logs_p = (t.float() for t in (z_p, logs_q, m_p, logs_p))
    kl = logs_p - logs_q - 0.5
    kl = kl + 0.5 * ((z_p - m_p) ** 2) * torch.exp(-2.0 * logs_p)
    return torch.sum(kl * z_mask) / torch.sum(z_mask)
