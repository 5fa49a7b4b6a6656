"""JAX Tacotron parameters -> reference-format torch state dict (numpy only).

`state_dict_from_jax_params(params, batch_stats, cfg)` reproduces the names
and layouts of `torch_tts_tpu.models.tacotron.convert.export_torch_state_dict`
without importing the JAX package, for the variants this port runs
(Encoder2, the tacotron2prod decoder, MelPostnet); the result loads into
`models/tacotron/model.py:Tacotron` with `load_state_dict(..., strict=True)`:

  dense [in, out] -> weight [out, in]; conv [k, in, out] -> [out, in, k];
  LSTM cell w_ih/w_hh [in, 4H] -> weight_ih/weight_hh [4H, in] (same
  i, f, g, o gate order); flax BatchNorm scale/bias and batch_stats
  mean/var -> weight/bias/running_mean/running_var, plus
  num_batches_tracked = 0; the reference's constant
  `attention_module.bias` = [1.0].
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def _lin(w):
    return np.asarray(w).transpose(1, 0)


def _conv1d(w):
    return np.asarray(w).transpose(2, 1, 0)


def state_dict_from_jax_params(params: Dict[str, Any], batch_stats: Dict[str, Any],
                               cfg) -> Dict[str, np.ndarray]:
    """flax (params, batch_stats) as nested dicts of arrays + TacotronConfig
    -> {reference torch name: numpy array}."""
    m = cfg.model
    if (m.encoder_type, m.decoder_type) != ("tacotron2", "tacotron2prod") or m.style_dim_vae:
        raise NotImplementedError("the converter covers Encoder2 with the tacotron2prod decoder")
    out: Dict[str, np.ndarray] = {}

    def put_linear(name, tree):
        out[f"{name}.weight"] = _lin(tree["kernel"])
        if "bias" in tree:
            out[f"{name}.bias"] = np.asarray(tree["bias"])

    def put_lstm_cell(name, tree):
        cell = tree["cell"]
        out[f"{name}.weight_ih"] = _lin(cell["w_ih"])
        out[f"{name}.weight_hh"] = _lin(cell["w_hh"])
        if "b_ih" in cell:
            out[f"{name}.bias_ih"] = np.asarray(cell["b_ih"])
            out[f"{name}.bias_hh"] = np.asarray(cell["b_hh"])

    def put_bn(name, ptree, stree, affine=True):
        if affine:
            out[f"{name}.weight"] = np.asarray(ptree["BatchNorm_0"]["scale"])
            out[f"{name}.bias"] = np.asarray(ptree["BatchNorm_0"]["bias"])
        out[f"{name}.running_mean"] = np.asarray(stree["BatchNorm_0"]["mean"])
        out[f"{name}.running_var"] = np.asarray(stree["BatchNorm_0"]["var"])
        out[f"{name}.num_batches_tracked"] = np.zeros((), np.int64)

    enc, enc_bs = params["encoder"], batch_stats["encoder"]
    out["encoder.emb.weight"] = np.asarray(enc["emb"]["embedding"])
    for i in range(3):
        out[f"encoder.conv.{3 * i}.weight"] = _conv1d(enc[f"conv_{i}"]["kernel"])
        put_bn(f"encoder.conv.{3 * i + 1}", enc.get(f"bn_{i}"), enc_bs[f"bn_{i}"], affine=i < 2)
    for ours, theirs in (("fwd", ""), ("bwd", "_reverse")):
        cell = enc["rnn"][ours]["cell"]
        out[f"encoder.rnn.rnn.weight_ih_l0{theirs}"] = _lin(cell["w_ih"])
        out[f"encoder.rnn.rnn.weight_hh_l0{theirs}"] = _lin(cell["w_hh"])
        if "b_ih" in cell:
            out[f"encoder.rnn.rnn.bias_ih_l0{theirs}"] = np.asarray(cell["b_ih"])
            out[f"encoder.rnn.rnn.bias_hh_l0{theirs}"] = np.asarray(cell["b_hh"])
    out["encoder.rnn_h0"] = np.asarray(enc["rnn_h0"])[None]
    out["encoder.rnn_c0"] = np.asarray(enc["rnn_c0"])[None]

    dec = params["decoder"]
    cell = dec["cell"]
    pfx = "decoder.decoder_cell"
    put_linear(f"{pfx}.pre_net.layers.0", cell["pre_net"]["fc1"])
    put_linear(f"{pfx}.pre_net.layers.1", cell["pre_net"]["fc2"])
    out[f"{pfx}.attention_module.query_layer.weight"] = _lin(cell["attention"]["query_layer"]["kernel"])
    out[f"{pfx}.attention_module.bias"] = np.ones((1,), np.float32)
    put_lstm_cell(f"{pfx}.attention_rnn", cell["attention_rnn"])
    put_lstm_cell(f"{pfx}.decoder_rnn", cell["decoder_rnn"])
    for i in range(2):
        out[f"{pfx}.initial_decoder_h.{i}"] = np.asarray(dec[f"init_h_{i}"])
        out[f"{pfx}.initial_decoder_c.{i}"] = np.asarray(dec[f"init_c_{i}"])
    put_linear("decoder.fc_mel", dec["fc_mel"])
    put_linear("decoder.fc_stop", dec["fc_stop"])

    if m.postnet_type == "tacotron2" and "postnet" in params:
        post, post_bs = params["postnet"], batch_stats["postnet"]
        for i in range(m.postnet_num_layers):
            out[f"postnet.conv.{i}.0.weight"] = _conv1d(post[f"conv_{i}"]["kernel"])
            put_bn(f"postnet.conv.{i}.1", post[f"bn_{i}"], post_bs[f"bn_{i}"])
        out["postnet.fc_out.weight"] = _lin(post["fc_out"]["kernel"])
    return out

