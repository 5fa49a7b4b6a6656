"""Checkpoint converter CLI: the reference's PyTorch `.pth` <-> this
package's run directory (port of `torch_tts_tpu/cli/convert_checkpoint.py`).

The port's modules carry the reference's parameter names and layouts, so a
conversion renames nothing: it moves state dicts between the reference's
files and the trainer's `ckpt_<step>.pt` (`train/checkpoint.py`).

  # reference -> here (then resume training or infer from runs/imported)
  python -m torch_tts_tpu_torch.cli.convert_checkpoint --model vits2 \\
      -c configs/vits2-ljspeech.yaml --from-torch G_114000.pth \\
      --mpd D_114000.pth -o runs/imported

  # here -> reference (G_<step>.pth / D_<step>.pth with {model, iteration})
  python -m torch_tts_tpu_torch.cli.convert_checkpoint --model vits2 \\
      -c configs/vits2-ljspeech.yaml --to-torch runs/ljspeech -o exported/

  # tacotron checkpoint.pt -> here
  python -m torch_tts_tpu_torch.cli.convert_checkpoint --model tacotron \\
      -c configs/tacotron-ljspeech.yaml --from-torch checkpoint_120000.pt \\
      -o runs/taco-imported

As in the JAX package: the optimizer state is not converted (a resumed run
re-warms its optimizers: the trainer's restore keeps the state's values
for what a checkpoint lacks), a parameter the file lacks is reported (and,
in a Tacotron import or an export, written as zeros, as the JAX package's
templates do), and the duration discriminator (DUR_*.pth) has no
converter.
"""

from __future__ import annotations

import argparse
import logging
import os
import re
from typing import Dict, Optional, Sequence, Tuple

import torch

from torch_tts_tpu_torch.core.precision import fp32_cudnn

logger = logging.getLogger(__name__)


def _step_of(path: str, fallback: int = 0) -> int:
    m = re.search(r"(\d+)(?:\.pth|\.pt|\.msgpack)?$", os.path.basename(path))
    return int(m.group(1)) if m else fallback


def _torch_state(path: str, key: str) -> Dict[str, torch.Tensor]:
    """The state dict in a reference file: blob[key] when present, else the
    blob itself, "module." prefixes dropped."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    sd = blob.get(key, blob)
    return {k.replace("module.", ""): torch.as_tensor(v) for k, v in sd.items()}


def _matched(sd: Dict[str, torch.Tensor],
             template: Dict[str, torch.Tensor]) -> Tuple[Dict[str, torch.Tensor], list, list]:
    """(the tensors of `sd` whose name and shape the template has, the
    template's names not so given, the names of `sd` not taken)."""
    took = {k: v.to(template[k].dtype) for k, v in sd.items()
            if k in template and tuple(v.shape) == tuple(template[k].shape)}
    return took, [k for k in template if k not in took], [k for k in sd if k not in took]


def _vits2_templates(cfg):
    """The generator's and the MPD's state dicts, built on the meta device
    (names and shapes only)."""
    from torch_tts_tpu_torch.models.vits2.discriminators import MultiPeriodDiscriminator
    from torch_tts_tpu_torch.models.vits2.model import SynthesizerTrn
    from torch_tts_tpu_torch.text import symbols

    with torch.device("meta"):
        g = SynthesizerTrn(len(symbols), cfg.posterior_channels, cfg.model, cfg.segment_frames)
        d = MultiPeriodDiscriminator(use_spectral_norm=cfg.model.use_spectral_norm)
    return g.state_dict(), d.state_dict()


def _vits2_from_torch(args) -> None:
    from torch_tts_tpu_torch.core.config import load_vits2_config
    from torch_tts_tpu_torch.train import checkpoint as ckpt

    cfg = load_vits2_config(args.config)
    tpl_g, tpl_d = _vits2_templates(cfg)
    params_g, missing, unused = _matched(_torch_state(args.from_torch, "model"), tpl_g)
    if missing or unused:
        logger.warning("generator: %d torch keys missing, %d unused", len(missing), len(unused))
    else:
        logger.info("generator: converted cleanly")
    step = _step_of(args.from_torch)
    tree = {"step": step, "model": params_g}
    if args.mpd:
        tree["mpd"], _, _ = _matched(_torch_state(args.mpd, "model"), tpl_d)
        logger.info("discriminator: converted")
    os.makedirs(args.output, exist_ok=True)
    path = ckpt.checkpoint_path(args.output, step)
    torch.save(tree, path)
    print(f"wrote {path} (restores leniently into the trainer state; "
          "optimizers re-warm)")


def _vits2_to_torch(args) -> None:
    from torch_tts_tpu_torch.core.config import load_vits2_config
    from torch_tts_tpu_torch.train import checkpoint as ckpt

    cfg = load_vits2_config(args.config)
    src = args.to_torch
    if os.path.isdir(src):
        src = ckpt.latest_checkpoint(src)
        if src is None:
            raise SystemExit(f"no checkpoint found in {args.to_torch}")
    loaded = ckpt.load_file(src)
    step = _step_of(src)
    os.makedirs(args.output, exist_ok=True)
    for (prefix, key), tpl in zip((("G", "model"), ("D", "mpd")), _vits2_templates(cfg)):
        took, missing, _ = _matched(loaded.get(key, {}), tpl)
        if missing:  # the JAX exporter's template holds zeros there
            logger.warning("%s: %d tensors missing from %s, written as zeros", prefix,
                           len(missing), src)
        sd = {k: took[k].contiguous() if k in took
              else torch.zeros(tpl[k].shape, dtype=tpl[k].dtype) for k in tpl}
        out = os.path.join(args.output, f"{prefix}_{step}.pth")
        torch.save({"model": sd, "iteration": step, "learning_rate": cfg.train.learning_rate,
                    "optimizer": None}, out)
        print(f"wrote {out} ({len(sd)} tensors)")


def _tacotron_from_torch(args) -> None:
    from torch_tts_tpu_torch.core.config import load_tacotron_config
    from torch_tts_tpu_torch.models.tacotron.model import Tacotron
    from torch_tts_tpu_torch.train import checkpoint as ckpt

    cfg = load_tacotron_config(args.config)
    model = Tacotron(cfg, 1 + len(cfg.text.alphabet))  # not initialised: only the buffers are read
    tpl = model.state_dict()
    took, missing, unused = _matched(_torch_state(args.from_torch, "model_state"), tpl)
    if missing or unused:
        logger.warning("tacotron: %d torch keys missing, %d unused", len(missing), len(unused))
    step = _step_of(args.from_torch)
    # what the file lacks: a parameter zero, as in the JAX importer's
    # template; a buffer (the attention's constant bias) the module's own
    params = dict(model.named_parameters())
    sd = {k: took[k] if k in took else torch.zeros_like(v) if k in params else v
          for k, v in tpl.items()}
    os.makedirs(args.output, exist_ok=True)
    path = ckpt.checkpoint_path(args.output, step)
    torch.save({"step": step, "model": sd}, path)
    print(f"wrote {path}")


def main(argv: Optional[Sequence[str]] = None) -> None:
    fp32_cudnn()
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    p.add_argument("--model", choices=("vits2", "tacotron"), required=True)
    p.add_argument("-c", "--config", required=True)
    d = p.add_mutually_exclusive_group(required=True)
    d.add_argument("--from-torch", metavar="PTH",
                   help="reference checkpoint (G_*.pth / checkpoint.pt) -> run dir")
    d.add_argument("--to-torch", metavar="RUN_OR_CKPT",
                   help="our run dir / ckpt_*.pt -> reference .pth files")
    p.add_argument("--mpd", default=None,
                   help="reference D_*.pth to convert alongside (vits2 --from-torch)")
    p.add_argument("-o", "--output", required=True,
                   help="output run dir (--from-torch) or directory (--to-torch)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    if args.model == "vits2":
        if args.from_torch:
            _vits2_from_torch(args)
        else:
            _vits2_to_torch(args)
    else:
        if args.from_torch:
            _tacotron_from_torch(args)
        else:
            raise SystemExit(
                "tacotron --to-torch: a run dir's ckpt_<step>.pt holds the reference-format "
                "state dict under 'model' (not wired as a CLI yet)"
            )


if __name__ == "__main__":
    main()
