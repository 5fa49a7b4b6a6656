"""The port's weight bridge and config against the JAX package.

- `state_dict_from_jax_params` (numpy only) equals the JAX package's
  `export_torch_state_dict` key for key and value for value, on the full
  parameter tree of a training init (posterior encoder and SDP posterior
  flows included), and the result loads into the port's SynthesizerTrn
  with strict=True.
- The port's config dataclasses have the JAX package's fields and
  defaults, and `load_vits2_config` reads the repo's YAML the same way.
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_tts_tpu.core import config as jax_config
from torch_tts_tpu.models.vits2 import SynthesizerTrn as JaxSynth
from torch_tts_tpu.models.vits2.convert import export_torch_state_dict
from torch_tts_tpu_torch.core import config
from torch_tts_tpu_torch.models.vits2.convert import state_dict_from_jax_params
from torch_tts_tpu_torch.models.vits2.model import SynthesizerTrn

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = dict(
    inter_channels=8, hidden_channels=8, filter_channels=16, n_heads=2, n_layers=2,
    kernel_size=3, p_dropout=0.0, resblock="1", resblock_kernel_sizes=(3, 5),
    resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)), upsample_rates=(4, 2),
    upsample_initial_channel=16, upsample_kernel_sizes=(8, 4), segment_size=64,
    posterior_wn_layers=3,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist a thread
    per core in every worker oversubscribes the cores, which slowed the
    port's tests about twofold and took CPU from the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("use_sdp", [True, False])
def test_converter_matches_export_and_loads_strictly(use_sdp):
    jcfg = jax_config.VITS2ModelConfig(use_sdp=use_sdp, **TINY)
    model = JaxSynth(n_vocab=20, spec_channels=12, segment_frames=4, cfg=jcfg)
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "noise", "dropout"))}
    shapes = jax.eval_shape(lambda: model.init(
        rngs, jnp.ones((1, 5), jnp.int32), jnp.asarray([5]), jnp.zeros((1, 16, 12)),
        jnp.asarray([16]))["params"])
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)

    ref = export_torch_state_dict(params, jcfg)
    sd = state_dict_from_jax_params(params, jcfg)
    assert sorted(sd) == sorted(ref)
    for k, v in ref.items():
        assert tuple(sd[k].shape) == v.shape, k
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    assert any(k.startswith("enc_q.") for k in sd)
    assert any(".post_transformer." in k for k in sd)
    assert any(k.startswith("dp.post_flows.") for k in sd) == use_sdp

    port = SynthesizerTrn(20, 12, config.VITS2ModelConfig(use_sdp=use_sdp, **TINY))
    port.load_state_dict(sd, strict=True)
    assert set(port.state_dict()) == set(sd)


# Defaults the port sets from H100 measurements, not the JAX package's TPU
# verdicts: the fused MRF bank (taken only when no gradient is needed)
PORT_DEFAULTS = {"VITS2ModelConfig": {"fuse_mrf": True}}


@pytest.mark.parametrize("name", ["AudioConfig", "VITS2ModelConfig", "VITS2TrainConfig",
                                  "DataConfig", "VITS2Config"])
def test_config_fields_and_defaults_match(name):
    """The same fields and defaults as the JAX config, but PORT_DEFAULTS."""
    ours, theirs = getattr(config, name), getattr(jax_config, name)
    f_ours = {f.name: f for f in dataclasses.fields(ours)}
    f_theirs = {f.name: f for f in dataclasses.fields(theirs)}
    assert list(f_ours) == list(f_theirs)
    a, b = ours(), theirs()
    for field in f_ours:
        va, vb = getattr(a, field), getattr(b, field)
        if dataclasses.is_dataclass(va):
            da, db = dataclasses.asdict(va), dataclasses.asdict(vb)
            for key, want in PORT_DEFAULTS.get(type(va).__name__, {}).items():
                assert da.pop(key) == want and db.pop(key) != want, key
            assert da == db
        elif field in PORT_DEFAULTS.get(name, {}):
            assert va == PORT_DEFAULTS[name][field] and vb != va, field
        else:
            assert va == vb, field
    if name == "VITS2Config":
        assert a.posterior_channels == b.posterior_channels
        assert a.segment_frames == b.segment_frames


def test_yaml_loads_like_jax_and_defaults_match_its_model_section():
    path = str(ROOT / "configs" / "vits2-ljspeech.yaml")
    ours, theirs = config.load_vits2_config(path), jax_config.load_vits2_config(path)
    for part in ("audio", "model", "train", "data"):
        a, b = dataclasses.asdict(getattr(ours, part)), dataclasses.asdict(getattr(theirs, part))
        for key, want in PORT_DEFAULTS.get(type(getattr(ours, part)).__name__, {}).items():
            assert a.pop(key) == want, key  # the file leaves it to each package's default
            b.pop(key)
        assert a == b
    # the defaults are the file's model section, apart from the ignored TPU packing flag
    assert dataclasses.replace(ours.model, pack_narrow_convs=False) == config.VITS2ModelConfig()


def test_json_config_round_trip(tmp_path):
    """A JSON config (what chip_smoke writes; PyYAML may be absent) loads back."""
    import json

    cfg = dataclasses.replace(
        config.VITS2Config(),
        model=dataclasses.replace(config.VITS2ModelConfig(), fuse_mrf=True, n_layers=3),
        data=dataclasses.replace(config.DataConfig(), text_cleaners=("transliteration_cleaners",)))
    p = tmp_path / "c.json"
    p.write_text(json.dumps({"model": dataclasses.asdict(cfg.model),
                             "data": {**dataclasses.asdict(cfg.data),
                                      **dataclasses.asdict(cfg.audio)}}))
    assert config.load_vits2_config(str(p)) == cfg


def test_seeded_init_is_deterministic():
    from torch_tts_tpu_torch.models.vits2 import build_synthesizer

    cfg = dataclasses.replace(config.VITS2Config(), model=config.VITS2ModelConfig(**TINY))
    a, b = (build_synthesizer(cfg, 20, seed=3, device="cpu").state_dict() for _ in range(2))
    c = build_synthesizer(cfg, 20, seed=4, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
