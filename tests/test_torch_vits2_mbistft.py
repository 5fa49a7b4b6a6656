"""VITS2 with the MB-iSTFT decoder (`decoder_type: mb_istft`): the port
(torch_tts_tpu_torch) against the JAX package, inference and training.

A tiny config: hop 32 = 2 (the trunk's one upsample stage) * 4 (iSTFT hop,
n_fft 16) * 4 (PQMF sub-bands), pre_conv flows, the deterministic duration
predictor, a full-width period discriminator of period 2. Random weights
from a numpy seed carried into the port by its converters with
strict=True, the same inputs, and the same noise (`jax.random.normal` /
`uniform` patched to numpy-seeded arrays, the JAX Dropout the identity,
the port's dropout p = 0). Each JAX reference (`infer` at two max_frames,
the `ddp` and `lightning` steps, the eval step) is jitted once and
compiled in a thread.

- `infer` on a ragged batch with injected noise, above the 128-frame patch
  window and below it: durations, attn and y_mask exactly, the latents
  within rtol 1e-4 / atol 1e-5, the waveform within rtol 1e-4 and 1e-5 of
  its peak (the MB-iSTFT output has no tanh); `_decode_padded` on JAX's
  latents against JAX's audio the same way.
- One whole step in each order from one state: every loss term within
  rtol 1e-4 (the norms 1e-3); every G and D gradient tensor within 1e-3
  of its JAX norm plus 1e-6 of the global norm, the decoder's `conv_post`
  bias among them with a gradient.
- The eval step against the JAX `make_eval_step` (rtol 1e-4).
- The converter's names and shapes against the JAX exporter's, loaded
  with strict=True; configs/vits2-ljspeech-mbistft.yaml against
  chip_smoke.py's dataclass copy, and the hop check; the config with
  `quantize_decoder` builds its int8 trunk with the same state dict and
  infers (tests/test_torch_int8_infer.py holds that against JAX).
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_vits2_infer import injected_noise
from test_torch_vits2_train import (_check_grads, _recording, _t, _tc, _torch_batch, patched_jax,
                                    random_params)
from torch_tts_tpu.core.config import AudioConfig as JAudio
from torch_tts_tpu.core.config import VITS2Config as JConfig
from torch_tts_tpu.core.config import VITS2ModelConfig as JModelConfig
from torch_tts_tpu.core.config import VITS2TrainConfig as JTrainConfig
from torch_tts_tpu.models.vits2 import MultiPeriodDiscriminator as JaxMPD
from torch_tts_tpu.models.vits2 import SynthesizerTrn as JaxSynth
from torch_tts_tpu.train import vits2_train as jtrain
from torch_tts_tpu_torch.core.config import AudioConfig, VITS2Config, VITS2ModelConfig
from torch_tts_tpu_torch.core.config import VITS2TrainConfig, load_vits2_config
from torch_tts_tpu_torch.models.vits2.convert import (mpd_state_dict_from_jax_params,
                                                      state_dict_from_jax_params)
from torch_tts_tpu_torch.models.vits2.discriminators import MultiPeriodDiscriminator
from torch_tts_tpu_torch.models.vits2.model import SynthesizerTrn
from torch_tts_tpu_torch.ops.layers import Dropout
from torch_tts_tpu_torch.ops.mb_istft import MultiBandISTFTGenerator
from torch_tts_tpu_torch.train import vits2_train

N_VOCAB, B, T_X, T_Y, HOP, N_MELS, D = 20, 2, 10, 30, 32, 12, 8
X_LENGTHS, Y_LENGTHS = (10, 7), (30, 22)
INFER_TX, INFER_LENGTHS = 24, (24, 17)
MF_LOW, MF_HIGH = 64, 200  # below / above SynthesizerTrn._PATCH_WINDOW
LENGTH_SCALE = 0.3  # the seeded durations then end inside both max_frames
SEG = 8
MODEL_KW = dict(
    inter_channels=D, hidden_channels=8, filter_channels=16, n_heads=2, n_layers=1,
    kernel_size=3, p_dropout=0.0, dp_dropout=0.0, resblock="1", resblock_kernel_sizes=(3,),
    resblock_dilation_sizes=((1, 3),), upsample_rates=(2,), upsample_initial_channel=16,
    upsample_kernel_sizes=(4,), decoder_type="mb_istft", subbands=4, gen_istft_n_fft=16,
    gen_istft_hop_size=4, use_sdp=False, use_noise_scaled_mas=True,
    use_mel_posterior_encoder=True, use_transformer_flows=True, transformer_flow_type="pre_conv",
    segment_size=SEG * HOP, posterior_wn_layers=2, flow_n_flows=2, fuse_mrf=True,
)
AUDIO_KW = dict(sampling_rate=8000, filter_length=64, hop_length=HOP, win_length=64,
                n_mel_channels=N_MELS)
PERIODS = (2,)
ORDERS = ("ddp", "lightning")
LOSSES = ("loss/g/total", "loss/g/gen", "loss/g/fm", "loss/g/mel", "loss/g/dur", "loss/g/kl",
          "loss/d/total")
RTOL, ATOL = 1e-4, 1e-5
WAVE_RTOL, WAVE_REL_ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist a thread
    per core in every worker oversubscribes the cores, which slowed the
    port's tests about twofold and took CPU from the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(step_order="ddp"):
    return (JConfig(audio=JAudio(**AUDIO_KW), model=JModelConfig(**MODEL_KW),
                    train=JTrainConfig(step_order=step_order)),
            VITS2Config(audio=AudioConfig(**AUDIO_KW), model=VITS2ModelConfig(**MODEL_KW),
                        train=VITS2TrainConfig(step_order=step_order)).check())


@pytest.fixture(scope="module")
def setup():
    """Random G and MPD weights, a training batch, an inference batch and
    the noise; the jitted JAX references, compiled in threads as soon as
    each is traced under the patched noise."""
    rng = np.random.default_rng(23)
    batch = {
        "x": rng.integers(1, N_VOCAB, (B, T_X)).astype(np.int32),
        "x_lengths": np.asarray(X_LENGTHS, np.int32),
        "spec": rng.standard_normal((B, T_Y, N_MELS)).astype(np.float32),
        "spec_lengths": np.asarray(Y_LENGTHS, np.int32),
        "wav": (rng.standard_normal((B, T_Y * HOP, 1)) * 0.1).astype(np.float32),
    }
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rngs = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1),
            "dropout": jax.random.PRNGKey(2)}
    jmpd = JaxMPD(periods=PERIODS)
    wav_seg = jnp.zeros((B, SEG * HOP, 1))
    params_d = random_params(jax.eval_shape(lambda: jmpd.init(rngs, wav_seg, wav_seg)["params"]),
                             rng)
    jcfg, _ = _configs()
    jmodel = JaxSynth(n_vocab=N_VOCAB, spec_channels=N_MELS, segment_frames=SEG, cfg=jcfg.model)
    params_g = random_params(jax.eval_shape(lambda: jmodel.init(
        rngs, jb["x"], jb["x_lengths"], jb["spec"], jb["spec_lengths"])["params"]), rng)
    eps = rng.standard_normal((B, T_Y, D)).astype(np.float32)
    mas = rng.standard_normal((B, T_Y, T_X)).astype(np.float32)
    u = rng.uniform(size=B).astype(np.float32)
    ids = (u * np.maximum(np.asarray(Y_LENGTHS) - SEG + 1, 1)).astype(np.int32)
    table = {(B, T_Y, D): [eps], (B, T_Y, T_X): [mas]}
    ids_infer = rng.integers(1, N_VOCAB, (B, INFER_TX)).astype(np.int32)
    prior = {mf: rng.standard_normal((B, mf, D)).astype(np.float32) for mf in (MF_LOW, MF_HIGH)}

    pending = {}
    with ThreadPoolExecutor(len(ORDERS) + 3) as ex:
        with patched_jax(table, u):
            for order in ORDERS:
                jc, _ = _configs(order)
                tx = _recording(jtrain.make_optimizer(jc, steps_per_epoch=1000))
                state = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params_g=params_g,
                                          opt_g=tx.init(params_g), params_d=params_d,
                                          opt_d=tx.init(params_d))
                args = (state, jb, jax.random.PRNGKey(0))
                step = jtrain.make_train_step(jc, jmodel, jmpd, tx)
                pending[order] = ex.submit(jax.jit(step).lower(*args).compile), args
            args = (params_g, jb, jax.random.PRNGKey(0))
            lowered = jax.jit(jtrain.make_eval_step(jcfg, jmodel)).lower(*args)
            pending["eval"] = ex.submit(lowered.compile), args
        with injected_noise({(B, mf, D): v for mf, v in prior.items()}):
            x, xl = jnp.asarray(ids_infer), jnp.asarray(INFER_LENGTHS)
            for mf in (MF_LOW, MF_HIGH):
                fn = jax.jit(lambda p, a, b, _mf=mf: jmodel.apply(
                    {"params": p}, a, b, noise_scale=0.667, length_scale=LENGTH_SCALE,
                    max_frames=_mf,
                    method=JaxSynth.infer, rngs={"noise": jax.random.PRNGKey(0)}))
                args = (params_g, x, xl)
                pending[mf] = ex.submit(fn.lower(*args).compile), args
        jax_runs = {}
        for key, (fut, args) in pending.items():
            res = fut.result()(*args)
            if key in ORDERS:
                new, metrics = res
                res = dict(metrics=metrics, grads_g=new.opt_g[1], grads_d=new.opt_d[1])
            jax_runs[key] = jax.tree.map(np.asarray, res)
    return dict(batch=batch, jcfg=jcfg, params_g=params_g, params_d=params_d, jax=jax_runs,
                ids_infer=ids_infer, prior=prior,
                port_noise=dict(eps=_tc(eps), mas_noise=_t(mas), ids_slice=_t(ids)))


def _port_model(s, cfg=None):
    cfg = cfg or _configs()[1]
    model = SynthesizerTrn(N_VOCAB, N_MELS, cfg.model, SEG)
    model.load_state_dict(state_dict_from_jax_params(s["params_g"], s["jcfg"].model), strict=True)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0  # the flows' pre_transformer has the reference's fixed 0.1
    return model


def _wave_close(got, want):
    np.testing.assert_allclose(got, want, rtol=WAVE_RTOL,
                               atol=WAVE_REL_ATOL * float(np.abs(want).max()))


@pytest.mark.parametrize("max_frames", [MF_LOW, MF_HIGH], ids=["masked", "patch_window"])
def test_ragged_infer_matches_jax(setup, max_frames):
    model = _port_model(setup).eval()
    assert isinstance(model.dec, MultiBandISTFTGenerator)
    out = model.infer(torch.from_numpy(setup["ids_infer"].astype(np.int64)),
                      torch.tensor(INFER_LENGTHS), noise_scale=0.667,
                      length_scale=LENGTH_SCALE, max_frames=max_frames,
                      prior_noise=_tc(setup["prior"][max_frames]))
    audio, attn, y_mask, aux, y_lengths = out
    r_audio, r_attn, r_mask, r_aux, r_len = setup["jax"][max_frames]
    np.testing.assert_array_equal(y_lengths.numpy(), r_len)
    assert r_len[0] != r_len[1] and (r_len < max_frames).all(), r_len  # ragged, with tails
    np.testing.assert_array_equal(attn.numpy(), r_attn)
    np.testing.assert_array_equal(y_mask.numpy(), r_mask)
    for a, b in zip(aux, r_aux):
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=ATOL)
    assert audio.shape == r_audio.shape == (B, max_frames * HOP, 1)
    _wave_close(audio.numpy(), r_audio)
    for i, n in enumerate(r_len):
        assert float(audio[i, int(n) * HOP:].abs().max()) == 0.0


def test_decode_padded_on_jax_latents_matches_jax_audio(setup):
    """The patch-window branch: the bulk decoded unmasked, a masked
    128-frame window pasted at each item's end; the PQMF's reach across the
    end stays inside the pasted half."""
    r_audio, _, y_mask, (z, _, _, _), y_lengths = setup["jax"][MF_HIGH]
    model = _port_model(setup).eval()
    ym = _tc(y_mask)
    with torch.no_grad():
        out = model._decode_padded(_tc(z) * ym, ym, _t(y_lengths), MF_HIGH)
    _wave_close(out.transpose(1, 2).numpy(), r_audio)


@pytest.fixture(scope="module", params=ORDERS)
def step_pair(setup, request):
    """The JAX step of `setup` in one order beside one port step from the
    same state."""
    s, order = setup, request.param
    _, cfg = _configs(order)
    mpd = MultiPeriodDiscriminator(periods=PERIODS)
    mpd.load_state_dict(mpd_state_dict_from_jax_params(s["params_d"], PERIODS), strict=True)
    pstate = vits2_train.create_train_state(cfg, _port_model(s, cfg).train(), mpd)
    recorded = {}
    for name in ("g", "d"):
        opt = getattr(pstate, f"opt_{name}")

        def record(grads, apply=True, _name=name, _step=opt.step):
            recorded[_name] = [g.clone() for g in grads]
            return _step(grads, apply)
        opt.step = record
    metrics = vits2_train.train_step(cfg, pstate, _torch_batch(s["batch"]), **s["port_noise"])
    return dict(jax=s["jax"][order], metrics=metrics, state=pstate, grads=recorded)


def test_step_loss_terms_match_jax(step_pair):
    jm, pm = step_pair["jax"]["metrics"], step_pair["metrics"]
    assert pm["nonfinite"] == 0.0 == float(jm["nonfinite"])
    assert step_pair["state"].step == 1
    for k in LOSSES:
        np.testing.assert_allclose(pm[k], float(jm[k]), rtol=1e-4, err_msg=k)
    for k in ("grad_norm_g", "grad_norm_d"):
        np.testing.assert_allclose(pm[k], float(jm[k]), rtol=1e-3, err_msg=k)


def test_step_gradients_match_jax(step_pair, setup):
    st, j = step_pair["state"], step_pair["jax"]
    names = st.opt_g.names
    _check_grads(step_pair["grads"]["g"],
                 state_dict_from_jax_params(j["grads_g"], setup["jcfg"].model), names)
    _check_grads(step_pair["grads"]["d"], mpd_state_dict_from_jax_params(j["grads_d"], PERIODS),
                 st.opt_d.names)
    grads = dict(zip(names, step_pair["grads"]["g"]))
    for n in ("dec.conv_post.bias", "dec.conv_post.weight", "dec.resblocks.0.convs1.1.weight_v"):
        assert float(grads[n].abs().max()) > 0, n


def test_eval_step_matches_jax(setup):
    s, want = setup, setup["jax"]["eval"]
    cfg = _configs()[1]
    got = vits2_train.eval_step(cfg, _port_model(s, cfg).train(), _torch_batch(s["batch"]),
                                eps=s["port_noise"]["eps"], ids_slice=s["port_noise"]["ids_slice"])
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-4, err_msg=k)


def test_converter_names_match_the_jax_exporter(setup):
    """The MB-iSTFT decoder's names: `dec.conv_post` with its bias, the
    trunk's `ups` and `resblocks`, no PQMF buffers; loaded with strict=True
    (`_port_model`)."""
    from torch_tts_tpu.models.vits2.convert import export_torch_state_dict

    sd = state_dict_from_jax_params(setup["params_g"], setup["jcfg"].model)
    want = export_torch_state_dict(setup["params_g"], setup["jcfg"].model)
    # the JAX exporter writes post_transformer placeholders for four flows
    # whatever flow_n_flows is; this model has two
    n = 2 * MODEL_KW["flow_n_flows"]
    want = {k: v for k, v in want.items()
            if not (".post_transformer." in k and int(k.split(".")[2]) >= n)}
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(v.shape)
                                                         for k, v in want.items()}
    model = _port_model(setup)
    assert set(model.state_dict()) == set(sd)
    assert sd["dec.conv_post.weight"].shape == (4 * 2 * 9, 8, 7)
    assert sd["dec.conv_post.bias"].shape == (4 * 2 * 9,)
    assert not any("pqmf" in k for k in model.state_dict())


def test_shipped_mbistft_config_builds_and_matches_chip_smoke():
    """configs/vits2-ljspeech-mbistft.yaml loads (its hop check passes),
    builds on the meta device and passes `check_supported`; chip_smoke.py's
    copy of it (the card has no PyYAML) equals it; a hop that the decoder
    does not make is refused."""
    import importlib.util
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    cfg = load_vits2_config(str(root / "configs" / "vits2-ljspeech-mbistft.yaml"))
    assert cfg.model.decoder_type == "mb_istft" and cfg.model.upsample_rates == (4, 4)
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.mbistft_config() == cfg
    vits2_train.check_supported(cfg)
    with torch.device("meta"):
        model = SynthesizerTrn(100, cfg.posterior_channels, cfg.model, cfg.segment_frames)
    assert isinstance(model.dec, MultiBandISTFTGenerator)
    assert model.dec.conv_post.weight.shape == (4 * 2 * 9, 128, 7)
    assert [b.channels for b in model.dec.resblocks] == [256] * 3 + [128] * 3
    with pytest.raises(ValueError, match="hop_length"):
        dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, subbands=2)).check()
    with torch.device("meta"):
        q8 = SynthesizerTrn(100, cfg.posterior_channels,
                            dataclasses.replace(cfg.model, quantize_decoder=True))
    assert q8.dec.conv_pre.quant == "int8" and all(u.quant == "int8" and u.subpixel
                                                   for u in q8.dec.ups)
    assert {k: v.shape for k, v in q8.state_dict().items()} == {
        k: v.shape for k, v in model.state_dict().items()}


def test_mbistft_model_infers_with_quantize_decoder(setup):
    """The int8 trunk (every conv but conv_post) on the same weights: the
    same durations and attn as JAX's fp model, finite audio within the
    int8 error of it; tests/test_torch_int8_infer.py holds it against JAX's
    int8 model."""
    cfg = _configs()[1]
    model = _port_model(setup, dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, quantize_decoder=True))).eval()
    audio, attn, _, _, y_lengths = model.infer(
        torch.from_numpy(setup["ids_infer"].astype(np.int64)), torch.tensor(INFER_LENGTHS),
        noise_scale=0.667, length_scale=LENGTH_SCALE, max_frames=MF_HIGH,
        prior_noise=_tc(setup["prior"][MF_HIGH]))
    r_audio, r_attn, _, _, r_len = setup["jax"][MF_HIGH]
    np.testing.assert_array_equal(y_lengths.numpy(), r_len)
    np.testing.assert_array_equal(attn.numpy(), r_attn)
    assert torch.isfinite(audio).all()
    err = float(np.abs(audio.numpy() - r_audio).max())
    assert 0 < err < 0.2 * float(np.abs(r_audio).max())
