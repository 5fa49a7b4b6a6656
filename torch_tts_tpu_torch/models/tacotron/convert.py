"""JAX Tacotron parameters -> reference-format torch state dict (numpy only).

`state_dict_from_jax_params(params, batch_stats, cfg)` reproduces the names
and layouts of `torch_tts_tpu.models.tacotron.convert.export_torch_state_dict`
without importing the JAX package, and extends them to every variant the
JAX `Tacotron` builds; the result loads into
`models/tacotron/model.py:Tacotron` with `load_state_dict(..., strict=True)`:

  dense [in, out] -> weight [out, in]; conv1d [k, in, out] -> [out, in, k];
  conv2d [kh, kw, in, out] -> [out, in, kh, kw]; LSTM and GRU cell
  w_ih/w_hh [in, G H] -> weight_ih/weight_hh [G H, in] (same i, f, g, o
  and r, z, n gate orders); flax BatchNorm scale/bias and batch_stats
  mean/var -> weight/bias/running_mean/running_var, plus
  num_batches_tracked = 0; the reference's constant
  `attention_module.bias` = [1.0].

The JAX exporter names Encoder2, the tacotron2prod and tacotron2 cells
(`decoder_rnn_list.{i}`, `initial_decoder_{h,c}.{i}`) and MelPostnet. No
reference name for the other modules is in the repository, so theirs
follow the JAX param paths: the VAE's `refencoder.encoder.conv_{i}`,
`bn_{i}`, `rnn.cell`, `refencoder.{mean_linear,logvar_linear,fc_out}`;
the tacotron1 Encoder's `encoder.pre_net.layers.{0,1}` and
`encoder.cbhg.{bank_k, bank_bn_k, proj1, proj_bn1, proj2, highway_in,
highway.{i}.{T,H}}`, its bidirectional GRU `encoder.cbhg.gru` in
torch.nn.GRU's names (`weight_ih_l0` for gru_fwd, `..._reverse` for
gru_bwd); the tacotron1 cell's `attention_rnn`, `attention_module.
fc_query` and `decoder_rnn_list.{i}` (its residual GRUs); MelPostnet2's
`postnet.l{i}_conv{j}` and `postnet.l{i}_bn{j}`.
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
    out: Dict[str, np.ndarray] = {}

    def put_linear(name, tree):
        out[f"{name}.weight"] = _lin(tree["kernel"])
        if "bias" in tree:
            out[f"{name}.bias"] = np.asarray(tree["bias"])

    def put_cell(name, cell, suffix=""):
        out[f"{name}.weight_ih{suffix}"] = _lin(cell["w_ih"])
        out[f"{name}.weight_hh{suffix}"] = _lin(cell["w_hh"])
        if "b_ih" in cell:
            out[f"{name}.bias_ih{suffix}"] = np.asarray(cell["b_ih"])
            out[f"{name}.bias_hh{suffix}"] = np.asarray(cell["b_hh"])

    def put_bn(name, ptree, stree, affine=True):
        if affine:
            out[f"{name}.weight"] = np.asarray(ptree["BatchNorm_0"]["scale"])
            out[f"{name}.bias"] = np.asarray(ptree["BatchNorm_0"]["bias"])
        out[f"{name}.running_mean"] = np.asarray(stree["BatchNorm_0"]["mean"])
        out[f"{name}.running_var"] = np.asarray(stree["BatchNorm_0"]["var"])
        out[f"{name}.num_batches_tracked"] = np.zeros((), np.int64)

    def put_conv1d(name, tree):
        out[f"{name}.weight"] = _conv1d(tree["kernel"])
        if "bias" in tree:
            out[f"{name}.bias"] = np.asarray(tree["bias"])

    enc, enc_bs = params["encoder"], batch_stats["encoder"]
    out["encoder.emb.weight"] = np.asarray(enc["emb"]["embedding"])
    if m.encoder_type == "tacotron1":
        put_linear("encoder.pre_net.layers.0", enc["pre_net"]["fc1"])
        put_linear("encoder.pre_net.layers.1", enc["pre_net"]["fc2"])
        cb, cb_bs = enc["cbhg"], enc_bs["cbhg"]
        for k in range(1, 17, 2):
            put_conv1d(f"encoder.cbhg.bank_{k}", cb[f"bank_{k}"])
            put_bn(f"encoder.cbhg.bank_bn_{k}", cb[f"bank_bn_{k}"], cb_bs[f"bank_bn_{k}"])
        put_conv1d("encoder.cbhg.proj1", cb["proj1"])
        put_bn("encoder.cbhg.proj_bn1", cb["proj_bn1"], cb_bs["proj_bn1"])
        put_conv1d("encoder.cbhg.proj2", cb["proj2"])
        if "highway_in" in cb:
            put_linear("encoder.cbhg.highway_in", cb["highway_in"])
        for i in range(4):
            for t in ("T", "H"):
                put_linear(f"encoder.cbhg.highway.{i}.{t}", cb[f"highway_{i}"][t])
        put_cell("encoder.cbhg.gru", cb["gru_fwd"], "_l0")
        put_cell("encoder.cbhg.gru", cb["gru_bwd"], "_l0_reverse")
    else:
        for i in range(3):
            out[f"encoder.conv.{3 * i}.weight"] = _conv1d(enc[f"conv_{i}"]["kernel"])
            put_bn(f"encoder.conv.{3 * i + 1}", enc.get(f"bn_{i}"), enc_bs[f"bn_{i}"],
                   affine=i < 2)
        for ours, theirs in (("fwd", ""), ("bwd", "_reverse")):
            put_cell("encoder.rnn.rnn", enc["rnn"][ours]["cell"], f"_l0{theirs}")
        out["encoder.rnn_h0"] = np.asarray(enc["rnn_h0"])[None]
        out["encoder.rnn_c0"] = np.asarray(enc["rnn_c0"])[None]

    dec = params["decoder"]
    cell = dec["cell"]
    pfx = "decoder.decoder_cell"
    put_linear(f"{pfx}.pre_net.layers.0", cell["pre_net"]["fc1"])
    put_linear(f"{pfx}.pre_net.layers.1", cell["pre_net"]["fc2"])
    if m.decoder_type == "tacotron1":
        put_cell(f"{pfx}.attention_rnn", cell["attention_rnn"])
        out[f"{pfx}.attention_module.fc_query.weight"] = _lin(cell["attention"]["fc_query"]["kernel"])
        for i in range(2):
            put_cell(f"{pfx}.decoder_rnn_list.{i}", cell[f"decoder_rnn_{i}"]["gru"])
    else:
        out[f"{pfx}.attention_module.query_layer.weight"] = _lin(
            cell["attention"]["query_layer"]["kernel"])
        out[f"{pfx}.attention_module.bias"] = np.ones((1,), np.float32)
        if m.decoder_type == "tacotron2":
            for i in range(2):
                put_cell(f"{pfx}.decoder_rnn_list.{i}", cell[f"decoder_rnn_{i}"]["cell"])
        else:
            put_cell(f"{pfx}.attention_rnn", cell["attention_rnn"]["cell"])
            put_cell(f"{pfx}.decoder_rnn", cell["decoder_rnn"]["cell"])
        for i in range(2):
            out[f"{pfx}.initial_decoder_h.{i}"] = np.asarray(dec[f"init_h_{i}"])
            out[f"{pfx}.initial_decoder_c.{i}"] = np.asarray(dec[f"init_c_{i}"])
    put_linear("decoder.fc_mel", dec["fc_mel"])
    put_linear("decoder.fc_stop", dec["fc_stop"])

    if "postnet" in params:
        post, post_bs = params["postnet"], batch_stats["postnet"]
        if m.postnet_type == "tacotron2":
            for i in range(m.postnet_num_layers):
                out[f"postnet.conv.{i}.0.weight"] = _conv1d(post[f"conv_{i}"]["kernel"])
                put_bn(f"postnet.conv.{i}.1", post[f"bn_{i}"], post_bs[f"bn_{i}"])
            out["postnet.fc_out.weight"] = _lin(post["fc_out"]["kernel"])
        else:
            for i in range(m.postnet_num_layers):
                for j in (1, 2, 3):
                    put_conv1d(f"postnet.l{i}_conv{j}", post[f"l{i}_conv{j}"])
                for j in (1, 2):
                    put_bn(f"postnet.l{i}_bn{j}", post[f"l{i}_bn{j}"], post_bs[f"l{i}_bn{j}"])

    if "refencoder" in params:
        ref, ref_bs = params["refencoder"]["encoder"], batch_stats["refencoder"]["encoder"]
        for i in range(len([k for k in ref if k.startswith("conv_")])):
            out[f"refencoder.encoder.conv_{i}.weight"] = np.asarray(
                ref[f"conv_{i}"]["kernel"]).transpose(3, 2, 0, 1)
            out[f"refencoder.encoder.conv_{i}.bias"] = np.asarray(ref[f"conv_{i}"]["bias"])
            put_bn(f"refencoder.encoder.bn_{i}", ref[f"bn_{i}"], ref_bs[f"bn_{i}"])
        put_cell("refencoder.encoder.rnn.cell", ref["rnn"]["cell"])
        for name in ("mean_linear", "logvar_linear", "fc_out"):
            put_linear(f"refencoder.{name}", params["refencoder"][name])
    return out
