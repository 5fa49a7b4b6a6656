"""VITS2 and Tacotron configuration dataclasses and loaders.

Same fields and defaults as `torch_tts_tpu/core/config.py` (its VITS2 and
Tacotron parts), so one YAML/JSON file configures both packages. Kept as a separate module
because importing `torch_tts_tpu.core` pulls in jax.

The defaults equal the `model:` section of `configs/vits2-ljspeech.yaml`
apart from `pack_narrow_convs`, a TPU lane-packing switch (the YAML's true,
the JAX default's false). This package packs nothing; the switch only
selects, under `quantize_decoder`, which HiFi-GAN stages are int8, as in
the JAX package (`ops/hifigan.py:int8_stages`). The Tacotron defaults equal
`configs/tacotron-ljspeech.yaml` apart from `character_map`. PyYAML is
imported only inside the loaders, for a `.yaml` file, so building a config
from the defaults or loading a `.json` one needs nothing beyond the
standard library.
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple


def _apply(cfg, d: dict):
    """Dataclass update from dict, ignoring unknown keys."""
    names = {f.name for f in dataclasses.fields(cfg)}
    return dataclasses.replace(cfg, **{k: v for k, v in d.items() if k in names})


@dataclass(frozen=True)
class AudioConfig:
    sampling_rate: int = 22050
    filter_length: int = 1024  # n_fft
    hop_length: int = 256
    win_length: int = 1024
    n_mel_channels: int = 80
    mel_fmin: float = 0.0
    mel_fmax: Optional[float] = None
    max_wav_value: float = 32768.0


@dataclass(frozen=True)
class VITS2ModelConfig:
    inter_channels: int = 192
    hidden_channels: int = 192
    filter_channels: int = 768
    n_heads: int = 2
    n_layers: int = 6
    kernel_size: int = 3
    p_dropout: float = 0.1
    resblock: str = "1"
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5),
        (1, 3, 5),
        (1, 3, 5),
    )
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2)
    upsample_initial_channel: int = 512
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4)

    n_speakers: int = 0
    gin_channels: int = 0
    use_sdp: bool = True
    dp_dropout: float = 0.5
    use_spk_conditioned_encoder: bool = False
    use_transformer_flows: bool = True
    transformer_flow_type: str = "pre_conv"
    use_noise_scaled_mas: bool = True
    mas_noise_scale_initial: float = 0.01
    noise_scale_delta: float = 2e-6
    use_spectral_norm: bool = False
    use_mel_posterior_encoder: bool = True
    use_duration_discriminator: bool = False
    duration_discriminator_type: str = "dur_disc_1"
    # a TPU lane-packing layout; here it only picks the int8 decoder's stages:
    # with it, the HiFi-GAN stages narrower than 128 channels stay fp
    pack_narrow_convs: bool = False
    # int8 W8A8 dynamic-quant inference of the decoder's convolutions
    # (ops/quant.py, kernels/int8_conv.py); approximate, never for training
    quantize_decoder: bool = False
    # decoder ResBlock1 banks with C <= 128 run through kernels/mrf_fused.py
    # when no gradient is needed (inference); training runs the plain
    # convolutions. On by default in the port: the H100 measured the fused
    # bank 30-52% under cuDNN fp32 per stage (PERF.md; the JAX package's
    # False is a TPU verdict)
    fuse_mrf: bool = True
    # "hifigan", or "mb_istft": the conv trunk stops at prod(upsample_rates)
    # and an iSTFT head (gen_istft_n_fft, gen_istft_hop_size) and a fixed
    # PQMF bank of `subbands` bands make the rest (ops/mb_istft.py);
    # prod(upsample_rates) * gen_istft_hop_size * subbands must equal the
    # audio hop_length (VITS2Config.check)
    decoder_type: str = "hifigan"
    subbands: int = 4
    gen_istft_n_fft: int = 16
    gen_istft_hop_size: int = 4

    segment_size: int = 8192  # in samples

    posterior_wn_layers: int = 16
    flow_n_flows: int = 4

    def __post_init__(self):
        # JSON/YAML gives lists; normalise to tuples so the config is hashable
        for name in ("resblock_kernel_sizes", "upsample_rates", "upsample_kernel_sizes"):
            v = getattr(self, name)
            if isinstance(v, list):
                object.__setattr__(self, name, tuple(v))
        v = self.resblock_dilation_sizes
        if isinstance(v, (list, tuple)) and v and isinstance(v[0], list):
            object.__setattr__(self, "resblock_dilation_sizes", tuple(tuple(x) for x in v))


@dataclass(frozen=True)
class VITS2TrainConfig:
    seed: int = 1234
    learning_rate: float = 2e-4
    betas: Tuple[float, float] = (0.8, 0.99)
    eps: float = 1e-9
    lr_decay: float = 0.999875
    batch_size: int = 8
    segment_size: int = 8192
    c_mel: float = 45.0
    c_kl: float = 1.0
    c_fm: float = 0.2
    c_dur: float = 1.0
    use_bf16: bool = False
    skip_nonfinite: bool = True
    step_order: str = "ddp"
    epochs: int = 20000
    log_interval: int = 200
    eval_interval: int = 1000
    keep_ckpts: int = 3
    grad_accum: int = 1

    def __post_init__(self):
        if isinstance(self.betas, list):
            object.__setattr__(self, "betas", tuple(self.betas))


@dataclass(frozen=True)
class DataConfig:
    training_files: str = ""
    validation_files: str = ""
    text_cleaners: Tuple[str, ...] = ("basic_cleaners",)
    add_blank: bool = True
    min_text_len: int = 1
    max_text_len: int = 190
    n_speakers: int = 0
    cleaned_text: bool = False

    def __post_init__(self):
        if isinstance(self.text_cleaners, list):
            object.__setattr__(self, "text_cleaners", tuple(self.text_cleaners))


@dataclass(frozen=True)
class VITS2Config:
    audio: AudioConfig = field(default_factory=AudioConfig)
    model: VITS2ModelConfig = field(default_factory=VITS2ModelConfig)
    train: VITS2TrainConfig = field(default_factory=VITS2TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)

    def check(self) -> "VITS2Config":
        """Raise ValueError on an unknown decoder_type, or an MB-iSTFT
        decoder whose upsampling, prod(upsample_rates) * gen_istft_hop_size *
        subbands, is not the audio hop_length; return the config."""
        m = self.model
        if m.decoder_type not in ("hifigan", "mb_istft"):
            raise ValueError(f"unknown decoder_type {m.decoder_type!r}")
        if m.decoder_type == "mb_istft":
            up = math.prod(m.upsample_rates) * m.gen_istft_hop_size * m.subbands
            if up != self.audio.hop_length:
                raise ValueError(f"the mb_istft decoder upsamples by {up} (prod(upsample_rates) * "
                                 f"gen_istft_hop_size * subbands), the audio hop_length is "
                                 f"{self.audio.hop_length}")
        return self

    @property
    def posterior_channels(self) -> int:
        """Mel posterior (VITS2) or linear-spectrogram posterior (VITS1)."""
        if self.model.use_mel_posterior_encoder:
            return self.audio.n_mel_channels
        return self.audio.filter_length // 2 + 1

    @property
    def segment_frames(self) -> int:
        return self.model.segment_size // self.audio.hop_length


def _read(path: str) -> dict:
    """A `.json` file through json, anything else through PyYAML."""
    with open(path) as f:
        text = f.read()
    if path.endswith(".json"):
        return json.loads(text)
    import yaml

    return yaml.safe_load(text)


def load_vits2_config(path: str) -> VITS2Config:
    """Load a YAML or JSON VITS2 config, in this repo's layout or the
    reference's ({train, data, model} or {data: {config}, model: {config}})."""
    raw = _read(path)
    cfg = VITS2Config()
    if isinstance(raw.get("model"), dict):
        model_d = raw["model"].get("config", raw["model"])
        cfg = dataclasses.replace(cfg, model=_apply(cfg.model, model_d))
        cfg = dataclasses.replace(cfg, audio=_apply(cfg.audio, model_d))
        if "accumulate_grad" in model_d:
            cfg = dataclasses.replace(
                cfg, train=dataclasses.replace(cfg.train, grad_accum=int(model_d["accumulate_grad"]))
            )
    if isinstance(raw.get("data"), dict):
        data_d = raw["data"].get("config", raw["data"])
        cfg = dataclasses.replace(cfg, data=_apply(cfg.data, data_d))
        cfg = dataclasses.replace(cfg, audio=_apply(cfg.audio, data_d))
    if isinstance(raw.get("train"), dict):
        cfg = dataclasses.replace(cfg, train=_apply(cfg.train, raw["train"]))
    return cfg.check()


# ---------------------------------------------------------------------------
# Tacotron (the reference's configs/config-ljspeech.yaml and data/audio.py)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TacotronAudioConfig:
    sample_rate: int = 22050
    hop_length: int = 256
    win_length: int = 1024
    num_mels: int = 80
    fmin: float = 50.0
    fmax: float = 7600.0


@dataclass(frozen=True)
class TacotronTextConfig:
    alphabet: str = "#abcdefghijklmnopqrstuvwxyz -:;,.!?()\"'"
    character_map: Tuple[Tuple[str, str], ...] = ()
    bos_symbols: str = ""
    eos_symbols: str = "#"

    def __post_init__(self):
        if isinstance(self.character_map, list):
            object.__setattr__(self, "character_map", tuple(tuple(x) for x in self.character_map))


@dataclass(frozen=True)
class TacotronModelConfig:
    encoder_type: str = "tacotron2"
    dim_emb: int = 512
    dim_out: int = 512
    decoder_type: str = "tacotron2prod"
    r: int = 1
    dim_pre: int = 256
    dim_att: int = 1024
    dim_rnn: Tuple[int, int] = (1024, 1024)
    postnet_type: Optional[str] = "tacotron2"
    postnet_dim_hidden: int = 512
    postnet_num_layers: int = 3
    style_dim_vae: Optional[int] = None  # set -> VAE reference encoder

    def __post_init__(self):
        if isinstance(self.dim_rnn, list):
            object.__setattr__(self, "dim_rnn", tuple(self.dim_rnn))


@dataclass(frozen=True)
class TacotronConfig:
    audio: TacotronAudioConfig = field(default_factory=TacotronAudioConfig)
    text: TacotronTextConfig = field(default_factory=TacotronTextConfig)
    model: TacotronModelConfig = field(default_factory=TacotronModelConfig)


def load_tacotron_config(path: str) -> TacotronConfig:
    """Load a YAML or JSON Tacotron config: this repo's layout (the
    dataclasses' own fields under audio/text/model) or the reference's
    (model: {encoder, decoder, postnet, style_encoder})."""
    raw = _read(path)
    cfg = TacotronConfig()
    if "audio" in raw:
        cfg = dataclasses.replace(cfg, audio=_apply(cfg.audio, raw["audio"]))
    if "text" in raw:
        cfg = dataclasses.replace(cfg, text=_apply(cfg.text, raw["text"]))
    if "model" in raw:
        m = raw["model"]
        upd: dict = {k: v for k, v in m.items() if not isinstance(v, dict)}
        if "encoder" in m:
            upd.update(encoder_type=m["encoder"].get("type", "tacotron2"),
                       dim_emb=m["encoder"].get("dim_emb", 512),
                       dim_out=m["encoder"].get("dim_out", 512))
        if "decoder" in m:
            d = m["decoder"]
            upd.update(decoder_type=d.get("type", "tacotron2prod"), r=d.get("r", 1),
                       dim_pre=d.get("dim_pre", 256), dim_att=d.get("dim_att", 1024),
                       dim_rnn=tuple(d.get("dim_rnn", (1024, 1024))))
        if isinstance(m.get("postnet"), dict):
            p = m["postnet"]
            upd.update(postnet_type=p.get("type", "tacotron2"),
                       postnet_dim_hidden=p.get("dim_hidden", 512),
                       postnet_num_layers=p.get("num_layers", 3))
        elif "postnet" in m or "postnet_type" not in m:
            upd.update(postnet_type=None)
        if m.get("style_encoder"):
            upd.update(style_dim_vae=m["style_encoder"].get("dim_vae", 16))
        cfg = dataclasses.replace(cfg, model=_apply(cfg.model, upd))
    return cfg
