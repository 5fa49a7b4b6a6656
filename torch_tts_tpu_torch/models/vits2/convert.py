"""JAX parameter tree -> reference-format torch state dict (numpy only).

`state_dict_from_jax_params` reproduces the names and layouts of
`torch_tts_tpu.models.vits2.convert.export_torch_state_dict` without
importing the JAX package, so a flax parameter tree (as nested dicts of
numpy arrays) loads into this package's `SynthesizerTrn` with
`load_state_dict(..., strict=True)`:

  conv kernel [k, in, out] -> weight [out, in, k]; transposed-conv
  [k, out, in] -> [in, out, k] (the same axis reversal); dense [in, out] ->
  [out, in]; weight norm (g, v) -> weight_g [n, 1, 1], weight_v;
  LayerNorm scale/bias -> gamma/beta; embedding -> weight;
  ElementwiseAffine m/logs [C] -> [C, 1]; `resblock_i_j` -> `resblocks.{i*nk+j}`.

`mpd_state_dict_from_jax_params` does the same for the multi-period
discriminator (the JAX `export_mpd_torch_state_dict`).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

import numpy as np
import torch

# flax submodule name -> reference torch name, for `<prefix>_<n>` names
_INDEXED = {
    "attn": "attn_layers", "self_attn": "self_attn_layers", "ffn": "ffn_layers",
    "norm0": "norm_layers_0", "sep": "convs_sep", "pw": "convs_1x1",
    "in": "in_layers", "res_skip": "res_skip_layers", "flows": "flows",
    "post_flows": "post_flows", "up": "ups",
}
_DDS = ("convs", "post_convs")


def _torch_name(path: List[str], n_kernels: int) -> str:
    parts = []
    for i, p in enumerate(path):
        m = re.match(r"^(.*)_(\d+)$", p)
        prefix, idx = (m.group(1), m.group(2)) if m else (p, None)
        prev = path[i - 1] if i else ""
        in_resblock = any(q.startswith("resblock_") for q in path[:i])
        if idx is None:
            parts.append(p)
        elif prefix in _INDEXED:
            parts.append(f"{_INDEXED[prefix]}.{idx}")
        elif prefix in ("norm1", "norm2"):
            parts.append(f"norms_{prefix[-1]}.{idx}" if prev in _DDS
                         else f"norm_layers_{prefix[-1]}.{idx}")
        elif prefix in ("conv1", "conv2", "conv") and in_resblock:
            parts.append(f"convs{prefix[4:]}.{idx}")
        elif re.match(r"^resblock_\d+$", prefix):
            parts.append(f"resblocks.{int(prefix.split('_')[1]) * n_kernels + int(idx)}")
        else:
            parts.append(p)
    return ".".join(parts)


def _placeholders(hidden: int, n_flows: int) -> Dict[str, np.ndarray]:
    """The never-used post_transformer of each pre_conv flow."""
    out = {}
    for fi in range(n_flows):
        p = f"flow.flows.{2 * fi}.post_transformer"
        for li in range(2):
            for nm in ("conv_q", "conv_k", "conv_v", "conv_o"):
                out[f"{p}.attn_layers.{li}.{nm}.weight"] = np.zeros((hidden, hidden, 1), np.float32)
                out[f"{p}.attn_layers.{li}.{nm}.bias"] = np.zeros((hidden,), np.float32)
            for ln in ("norm_layers_1", "norm_layers_2"):
                out[f"{p}.{ln}.{li}.gamma"] = np.ones((hidden,), np.float32)
                out[f"{p}.{ln}.{li}.beta"] = np.zeros((hidden,), np.float32)
            for cv in ("conv_1", "conv_2"):
                out[f"{p}.ffn_layers.{li}.{cv}.weight"] = np.zeros((hidden, hidden, 3), np.float32)
                out[f"{p}.ffn_layers.{li}.{cv}.bias"] = np.zeros((hidden,), np.float32)
    return out


def state_dict_from_jax_params(params: Dict[str, Any], cfg=None) -> Dict[str, torch.Tensor]:
    """Flax VITS2 params (nested dicts of arrays) -> {torch name: tensor}.
    `cfg` (a VITS2ModelConfig) sets the number of resblocks per stage and
    adds the pre_conv flows' post_transformer placeholders; without it the
    tree may be any submodule's."""
    out: Dict[str, np.ndarray] = {}
    n_kernels = len(cfg.resblock_kernel_sizes) if cfg is not None else 0

    def emit(path, key, value):
        out[f"{_torch_name(path, n_kernels)}.{key}" if path else key] = np.asarray(value)

    def walk(tree, path):
        keys = set(tree)
        if {"v", "g"} <= keys:
            emit(path, "weight_v", np.asarray(tree["v"]).transpose(2, 1, 0))
            emit(path, "weight_g", np.asarray(tree["g"]).reshape(-1, 1, 1))
            if "bias" in keys:
                emit(path, "bias", tree["bias"])
        elif "kernel" in keys:
            k = np.asarray(tree["kernel"])
            emit(path, "weight", k.transpose(2, 1, 0) if k.ndim == 3 else k.T)
            if "bias" in keys:
                emit(path, "bias", tree["bias"])
        elif keys == {"scale", "bias"}:
            emit(path, "gamma", tree["scale"])
            emit(path, "beta", tree["bias"])
        elif "embedding" in keys:
            emit(path, "weight", tree["embedding"])
        elif keys == {"m", "logs"}:
            emit(path, "m", np.asarray(tree["m"]).reshape(-1, 1))
            emit(path, "logs", np.asarray(tree["logs"]).reshape(-1, 1))
        else:
            for k in sorted(keys):
                v = tree[k]
                if isinstance(v, dict) or hasattr(v, "keys"):
                    walk(v, path + [k])
                else:
                    out[_torch_name(path + [k], n_kernels)] = np.asarray(v)

    walk(params, [])
    if cfg is not None and cfg.use_transformer_flows and cfg.transformer_flow_type == "pre_conv":
        out.update(_placeholders(cfg.hidden_channels, cfg.flow_n_flows))
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def mpd_state_dict_from_jax_params(params: Dict[str, Any],
                                   periods=(2, 3, 5, 7, 11)) -> Dict[str, torch.Tensor]:
    """Flax MultiPeriodDiscriminator params -> the reference's torch names
    and layouts (those of the JAX `export_mpd_torch_state_dict`), for
    `MultiPeriodDiscriminator.load_state_dict(..., strict=True)`:
    1-D v [k, in/g, out] -> weight_v [out, in/g, k], 2-D v [kh, kw, in, out]
    -> [out, in, kh, kw]; g [out] -> weight_g [out, 1, 1(, 1)]."""
    out: Dict[str, np.ndarray] = {}

    def emit(tkey: str, tree, is2d: bool):
        v = np.asarray(tree["v"])
        out[f"{tkey}.weight_v"] = v.transpose(3, 2, 0, 1) if is2d else v.transpose(2, 1, 0)
        out[f"{tkey}.weight_g"] = np.asarray(tree["g"]).reshape((-1, 1, 1, 1) if is2d
                                                                else (-1, 1, 1))
        out[f"{tkey}.bias"] = np.asarray(tree["bias"])

    s = params["disc_s"]
    for j in range(6):
        emit(f"discriminators.0.convs.{j}", s[f"conv_{j}"], is2d=False)
    emit("discriminators.0.conv_post", s["conv_post"], is2d=False)
    for i, p in enumerate(periods, start=1):
        d = params[f"disc_p{p}"]
        for j in range(5):
            emit(f"discriminators.{i}.convs.{j}", d[f"conv_{j}"], is2d=True)
        emit(f"discriminators.{i}.conv_post", d["conv_post"], is2d=True)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}
