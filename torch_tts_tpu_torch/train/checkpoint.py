"""Checkpoints of a whole train state, with keep-last-N retention (port of
`torch_tts_tpu/train/checkpoint.py`).

One file per step, `<model_dir>/ckpt_<step>.pt`: `torch.save` of one dict
holding only tensors, numbers and dicts, so `torch.load(...,
weights_only=True)` reads it:

    {"step": int,
     "model": {name: tensor}, ["mpd": {...}], ["dur_disc": {...}],
     "opt_g": {"count": int, "mini_step": int, "mu": {name: tensor},
               "nu": {...}[, "acc": {...}]}, ["opt_d": {...}], ["opt_dur": {...}]}

(A state without a discriminator, the vocoder's recon-only one, has no
"mpd" / "opt_d".)

Semantics are the JAX package's: `list_checkpoints` sorts on the step
number, `remove_old_checkpoints` keeps the last `keep`, a save writes
`<path>.tmp` and renames it (`os.replace`), and the restore is lenient: a
key missing from the file, or a tensor of another shape, keeps the
state's value and logs a warning; keys the state lacks are ignored.
`average_checkpoints` averages the float tensors of several files.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Any, Dict, List, Optional

import torch

logger = logging.getLogger(__name__)

_CKPT_RE = re.compile(r"ckpt_(\d+)\.pt$")


def state_tree(state, copy: bool = False) -> Dict[str, Any]:
    """The checkpoint dict of a `TrainState`. copy=True copies every tensor
    to the host now (a snapshot that later in-place updates do not touch);
    otherwise the tensors are the state's own."""
    take = (lambda t: t.detach().to("cpu", copy=True)) if copy else (lambda t: t)

    def module(m):
        return {k: take(v) for k, v in m.state_dict().items()}

    def opt(o):
        d = o.state_dict()
        return {k: ({n: take(t) for n, t in v.items()} if isinstance(v, dict) else v)
                for k, v in d.items()}

    tree = {"step": int(state.step), "model": module(state.model), "opt_g": opt(state.opt_g)}
    for net, o in (("mpd", "opt_d"), ("dur_disc", "opt_dur")):
        if getattr(state, net, None) is not None:
            tree[net], tree[o] = module(getattr(state, net)), opt(getattr(state, o))
    return tree


@torch.no_grad()
def load_state_tree(state, tree: Dict[str, Any]) -> None:
    """Write a complete checkpoint dict (as `state_tree` gives) into `state`
    in place."""
    state.step = int(tree["step"])
    for key in ("model", "mpd", "dur_disc"):
        if key in tree and getattr(state, key, None) is not None:
            getattr(state, key).load_state_dict(tree[key], strict=True)
    for key in ("opt_g", "opt_d", "opt_dur"):
        o = getattr(state, key, None)
        if key not in tree or o is None:
            continue
        t = tree[key]
        o.count, o.mini_step = int(t["count"]), int(t.get("mini_step", 0))
        for slot in ("mu", "nu", "acc"):
            for dst, n in zip(getattr(o, slot), o.names if getattr(o, slot) else ()):
                dst.copy_(t[slot][n])


def _merge_lenient(target: Any, loaded: Any, path: str = "") -> Any:
    """Take loaded values where structure and shape match; keep the
    target's value (and warn) otherwise."""
    if isinstance(target, dict):
        if not isinstance(loaded, dict):
            logger.warning("checkpoint: %s is not a dict, keeping init", path)
            return target
        out = {}
        for k, v in target.items():
            if k in loaded:
                out[k] = _merge_lenient(v, loaded[k], f"{path}/{k}")
            else:
                logger.warning("checkpoint: missing %s/%s, keeping init", path, k)
                out[k] = v
        return out
    if isinstance(target, torch.Tensor):
        if not isinstance(loaded, torch.Tensor) or tuple(target.shape) != tuple(loaded.shape):
            logger.warning("checkpoint: shape mismatch at %s (%s vs %s), keeping init", path,
                           tuple(target.shape), tuple(getattr(loaded, "shape", ())))
            return target
        return loaded
    return loaded


def _write(path: str, tree: Dict[str, Any]) -> None:
    tmp = path + ".tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)


def checkpoint_path(model_dir: str, step: int) -> str:
    return os.path.join(model_dir, f"ckpt_{step}.pt")


def save_checkpoint(model_dir: str, step: int, state, keep: int = 3) -> str:
    """Write `state` to <model_dir>/ckpt_<step>.pt; prune old ones."""
    os.makedirs(model_dir, exist_ok=True)
    path = checkpoint_path(model_dir, step)
    _write(path, state_tree(state, copy=True))
    logger.info("Saved checkpoint: %s", path)
    remove_old_checkpoints(model_dir, keep=keep)
    return path


def list_checkpoints(model_dir: str) -> List[str]:
    if not os.path.isdir(model_dir):
        return []
    files = [f for f in os.listdir(model_dir) if _CKPT_RE.search(f)]
    files.sort(key=lambda f: int(_CKPT_RE.search(f).group(1)))
    return [os.path.join(model_dir, f) for f in files]


def latest_checkpoint(model_dir: str) -> Optional[str]:
    ckpts = list_checkpoints(model_dir)
    return ckpts[-1] if ckpts else None


def remove_old_checkpoints(model_dir: str, keep: int = 3) -> None:
    ckpts = list_checkpoints(model_dir)
    for path in ckpts[:-keep] if keep > 0 else []:
        os.remove(path)
        logger.info("Removed old checkpoint: %s", path)


def load_file(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_checkpoint(path: str, state, lenient: bool = True):
    """Load a checkpoint file into `state` (in place); returns `state`."""
    raw = load_file(path)
    target = state_tree(state)
    merged = _merge_lenient(target, raw) if lenient else raw
    load_state_tree(state, merged)
    return state


def average_trees(paths: List[str], subtree: Optional[str] = None) -> Dict[str, Any]:
    """The checkpoint dict of the last file with the float tensors replaced
    by their uniform average over `paths`; with `subtree` (e.g. "model")
    only that top-level key is averaged."""
    if not paths:
        raise ValueError("average_checkpoints: no checkpoint paths given")

    def add(acc, part):
        if isinstance(part, dict):
            return {k: add(acc.get(k) if acc is not None else None, v) for k, v in part.items()}
        if isinstance(part, torch.Tensor) and part.is_floating_point():
            return part.double() if acc is None else acc + part.double()
        return part

    def mean(acc, like):
        if isinstance(acc, dict):
            return {k: mean(v, like[k]) for k, v in acc.items()}
        if isinstance(acc, torch.Tensor) and acc.dtype == torch.float64:
            return (acc / len(paths)).to(like.dtype)
        return acc

    acc, last = None, None
    for p in paths:
        last = load_file(p)
        acc = add(acc, last[subtree] if subtree else last)
    avg = mean(acc, last[subtree] if subtree else last)
    if not subtree:
        return avg
    merged = dict(last)
    merged[subtree] = avg
    return merged


def average_checkpoints(paths: List[str], state, subtree: Optional[str] = None):
    """Uniform average of the float tensors of several checkpoints, loaded
    into `state` (in place; returns it). Other values come from the last
    file. `subtree` (e.g. "model") restricts the average to one top-level
    key, so the optimizer state is never averaged; the rest also comes
    from the last file."""
    merged = average_trees(paths, subtree)
    load_state_tree(state, _merge_lenient(state_tree(state), merged))
    return state
