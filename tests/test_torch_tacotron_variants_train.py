"""Training of the other Tacotron variants: the port (torch_tts_tpu_torch)
against the JAX package, with JAX's own draws.

Two variants of the tiny config of tests/test_torch_tacotron_train.py
(r = 2, dims 16, dim_rnn (16, 16), PreNet 8, dim_att 8, 20 mels): "taco2"
(the Tacotron-2 decoder cell, MelPostnet2) and "taco1" (the CBHG encoder,
the Tacotron-1 cell, MelPostnet2), on that file's ragged B=3 batch, with
weights and batch statistics from a numpy seed converted by the port's
converter and loaded with strict=True. Each variant's JAX train and eval
steps are traced with `recorded` (every draw, in program order) and
compiled at once in threads; `variant_draws` turns a record into one
`TacotronDraws` for any variant (tests/test_torch_tacotron_style.py uses
it for the VAE).

Then one `TacotronSynthesizer.synthesize` of a tacotron1 model with a tiny
HiFi-GAN vocoder (tests/test_torch_vocoder.py's) against the JAX
synthesizer's, its PreNet masks replayed from the key JAX derives.

Tolerances (tests/test_torch_tacotron_train.py's): the training forward's
y, y_post, s and w within 1e-4, the running statistics within 1e-5; the
loss terms and grad_norm within RTOL 1e-4; gradients RTOL 1e-4 / ATOL
1e-5; eval_step within 1e-4; the synthesized audio within 1e-4 of its
peak and the stop lengths exactly.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_tacotron_train import (ATOL, B, L_TEXT, MODEL_ATOL, P_NO_FORCING, P_ZONEOUT, RTOL,
                                       STATS_ATOL, T_FRAMES, fill, make_batch, recorded,
                                       recording_tx, tiny_cfg, torch_batch)
from torch_tts_tpu.core import config as jcfg
from torch_tts_tpu.models.tacotron import build_tacotron as jax_build
from torch_tts_tpu.train import tacotron_train as jtrain
from torch_tts_tpu_torch.core import config as tcfg
from torch_tts_tpu_torch.models.tacotron.convert import state_dict_from_jax_params
from torch_tts_tpu_torch.models.tacotron.model import Encoder2, Tacotron, TacotronDraws
from torch_tts_tpu_torch.ops.rnn import LSTMZoneoutCell
from torch_tts_tpu_torch.train import tacotron_train as ttrain

VARIANTS = {
    "vae": dict(style_dim_vae=4),
    "taco2": dict(decoder_type="tacotron2", postnet_type="mel2"),
    "taco1": dict(encoder_type="tacotron1", decoder_type="tacotron1", postnet_type="mel2"),
}
TRAINED = ("taco2", "taco1")  # this file's variants; the VAE's are in ..._style.py


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist a thread
    per core in every worker oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def variant_cfg(pkg, name, base=None):
    base = base or tiny_cfg(pkg)
    return dataclasses.replace(base, model=dataclasses.replace(base.model, **VARIANTS[name]))


def jax_variables(jc, batch, rng, xref=False):
    """(flax model, {"params", "batch_stats"} filled from rng); xref: init
    with the teacher mels as the reference (the VAE's parameters)."""
    jm = jax_build(jc)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, batch["c"], batch["c_lengths"], batch["x"],
        batch["x_lengths"], xref=batch["x"] if xref else None,
        xref_lengths=batch["x_lengths"] if xref else None, train=True, deterministic=False))
    return jm, {"params": fill(shapes["params"], rng),
                "batch_stats": fill(shapes["batch_stats"], rng, stats=True)}


def port_model(variables, cfg) -> Tacotron:
    model = Tacotron(cfg, 1 + len(cfg.text.alphabet))
    sd = state_dict_from_jax_params(variables["params"], variables["batch_stats"], cfg)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    return model


def widened(mask, W):
    """A [B, w] PreNet mask padded to the step tensor's width W."""
    m = torch.from_numpy(np.array(mask))
    return torch.nn.functional.pad(m, (0, W - m.shape[-1]))


def variant_draws(record, model: Tacotron, S: int, train: bool, style: bool = False,
                  ) -> TacotronDraws:
    """A JAX forward's draws in program order -> TacotronDraws, for any
    variant (the order of the `TacotronDraws` docstring)."""
    it = iter(record)

    def take(name):
        n, v = next(it)
        assert n == name, (n, name)
        return torch.from_numpy(np.array(v))

    d = TacotronDraws(None)
    cell, cell_type = model.decoder.decoder_cell, model.decoder.cell_type
    if train:
        d.encoder = (take("bernoulli") if isinstance(model.encoder, Encoder2)
                     else (take("bernoulli"), take("bernoulli")))
    if style:
        d.style_eps = take("normal")
    if train:
        d.coin = take("uniform") > np.float32(P_NO_FORCING)
    W = cell.pre_net.mask_width
    prenet, zone, noise = [], [[] for _ in cell.rnns], []
    for _ in range(S):
        prenet.append(torch.stack([widened(take("bernoulli"), W) for _ in range(2)]))
        if not train:
            continue
        for i, rnn in enumerate(cell.rnns):
            n = 2 if isinstance(rnn, LSTMZoneoutCell) else 1
            z = torch.stack([take("uniform") for _ in range(n)]) < np.float32(P_ZONEOUT)
            zone[i].append(z if n == 2 else z[0])
            if cell_type == "tacotron2prod" and i == 0:
                noise.append(take("normal"))
        if cell_type == "tacotron2":
            noise.append(take("normal"))
    d.prenet = torch.stack(prenet)
    if train:
        d.zoneout = [torch.stack(z) for z in zone]
        d.att_noise = torch.stack(noise) if noise else None
        if model.postnet is not None:
            d.postnet = [take("bernoulli") for _ in model.postnet.dropout_shapes(B, S * 2)]
    assert next(it, None) is None, "draws left over"
    return d


def jax_step_records(jc, jm, variables, batch, pool, xref=False):
    """Trace the JAX train and eval steps (draws recorded), submit their
    compiles to `pool` at once -> a function that runs them and returns
    the records, the forward's outputs, the metrics and the gradients."""
    tx = recording_tx(jtrain.make_optimizer(1e-3))
    state = jtrain.TacoTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                                  batch_stats=variables["batch_stats"],
                                  opt=tx.init(variables["params"]))
    forward = []
    real_loss = jtrain.tacotron_loss

    def loss_and_outputs(y, y_post, s, x, xmask, w, kl):
        jax.debug.callback(lambda *a: forward.append([np.asarray(v) for v in a]), y, y_post, s, w,
                           kl, ordered=True)
        return real_loss(y, y_post, s, x, xmask, w, kl)

    jtrain.tacotron_loss = loss_and_outputs
    try:
        with recorded() as train_record:
            train_fut = pool.submit(jax.jit(jtrain.make_train_step(jc, jm, tx)).lower(
                state, batch, jax.random.PRNGKey(3)).compile)
    finally:
        jtrain.tacotron_loss = real_loss
    with recorded() as eval_record:
        eval_fut = pool.submit(jax.jit(jtrain.make_eval_step(jc, jm)).lower(
            state, batch, jax.random.PRNGKey(4)).compile)

    def run():
        new_state, metrics = train_fut.result()(state, batch, jax.random.PRNGKey(3))
        eval_metrics, eval_w = eval_fut.result()(state, batch, jax.random.PRNGKey(4))
        jax.effects_barrier()
        as_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
        return dict(train_record=train_record, eval_record=eval_record, forward=forward[0],
                    metrics=as_np(metrics), grads=as_np(new_state.opt[1]),
                    new_stats=as_np(new_state.batch_stats), eval_metrics=as_np(eval_metrics),
                    eval_w=np.asarray(eval_w))
    return run


@pytest.fixture(scope="module")
def setup():
    """Per variant of TRAINED: configs, variables, the batch, JAX's records."""
    out, runs = {}, {}
    with ThreadPoolExecutor(4) as pool:
        for i, name in enumerate(TRAINED):
            rng = np.random.default_rng(40 + i)
            jc, tc = variant_cfg(jcfg, name), variant_cfg(tcfg, name)
            batch = make_batch(rng)
            jm, variables = jax_variables(jc, batch, rng)
            runs[name] = jax_step_records(jc, jm, variables, batch, pool)
            out[name] = dict(jc=jc, tc=tc, batch=batch, variables=variables)
        for name in TRAINED:
            out[name].update(runs[name]())
    S = T_FRAMES // 2
    for s in out.values():
        model = port_model(s["variables"], s["tc"])
        s["draws"] = variant_draws(s["train_record"], model, S, train=True)
        s["eval_draws"] = variant_draws(s["eval_record"], model, S, train=False)
    return out


def port_grads_tree(tree, s):
    zeros = jax.tree.map(np.zeros_like, s["variables"]["batch_stats"])
    return {k: torch.from_numpy(np.array(v))
            for k, v in state_dict_from_jax_params(tree, zeros, s["tc"]).items()}


@pytest.mark.parametrize("name", TRAINED)
def test_training_forward_matches_jax(setup, name):
    s = setup[name]
    assert not bool(s["draws"].coin.all()), "some step feeds back its own frame"
    model = port_model(s["variables"], s["tc"])
    b = torch_batch(s["batch"])
    y, y_post, st, aux = model(b["c"], b["c_lengths"], b["x"], b["x_lengths"], train=True,
                               deterministic=False, draws=s["draws"])
    for k, got, want in zip(("y", "y_post", "s", "w"), (y, y_post, st, aux["w"]), s["forward"]):
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=MODEL_ATOL, atol=MODEL_ATOL,
                                   err_msg=k)
    want_sd = state_dict_from_jax_params(s["variables"]["params"], s["new_stats"], s["tc"])
    names = [k for k in model.state_dict() if k.endswith(("running_mean", "running_var"))]
    assert len(names) == 2 * {"taco2": 3 + 4, "taco1": 9 + 4}[name]
    for k in names:
        np.testing.assert_allclose(model.state_dict()[k].numpy(), want_sd[k], rtol=0,
                                   atol=STATS_ATOL, err_msg=k)


@pytest.mark.parametrize("name", TRAINED)
def test_train_step_matches_jax(setup, name):
    """The loss terms, grad_norm and every parameter's gradient."""
    s = setup[name]
    model = port_model(s["variables"], s["tc"])
    state = ttrain.create_train_state(model)
    metrics = ttrain.train_step(state, torch_batch(s["batch"]), draws=s["draws"])
    assert set(metrics) == set(s["metrics"]) and state.step == 1
    for k, want in s["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), want, rtol=RTOL, atol=ATOL, err_msg=k)
    model = port_model(s["variables"], s["tc"])
    names, params = zip(*model.named_parameters())
    _, grads = ttrain.loss_and_grads(model, params, torch_batch(s["batch"]), draws=s["draws"])
    want = port_grads_tree(s["grads"], s)
    assert sorted(names) == sorted(k for k in want if k in dict(model.named_parameters()))
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), rtol=RTOL, atol=ATOL, err_msg=n)


@pytest.mark.parametrize("name", TRAINED)
def test_eval_step_matches_jax(setup, name):
    s = setup[name]
    model = port_model(s["variables"], s["tc"])
    metrics, w = ttrain.eval_step(model, torch_batch(s["batch"]), draws=s["eval_draws"])
    np.testing.assert_allclose(w.numpy(), s["eval_w"], rtol=MODEL_ATOL, atol=MODEL_ATOL)
    for k, want in s["eval_metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), want, rtol=MODEL_ATOL, atol=MODEL_ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_draw_gives_the_shapes_jax_draws(setup, name):
    """`Tacotron.draw` from a generator: the shapes of JAX's recorded draws
    (the VAE's against the taco2prod fields of ..._train.py's record)."""
    cfg = variant_cfg(tcfg, name)
    model = Tacotron(cfg, 1 + len(cfg.text.alphabet))
    S = T_FRAMES // 2
    d = model.draw(B, L_TEXT, S, torch.Generator().manual_seed(0), style=name == "vae")
    want = setup.get(name, {}).get("draws")
    if want is None:
        assert tuple(d.style_eps.shape) == (B, 4)
        assert [tuple(z.shape) for z in d.zoneout] == [(S, 2, 16), (S, 2, 16)]
        return
    assert d.prenet.shape == want.prenet.shape and d.coin.shape == want.coin.shape
    assert [z.shape for z in d.zoneout] == [z.shape for z in want.zoneout]
    assert (d.att_noise is None) == (want.att_noise is None) == (name == "taco1")
    enc = (d.encoder,) if torch.is_tensor(d.encoder) else d.encoder
    want_enc = (want.encoder,) if torch.is_tensor(want.encoder) else want.encoder
    assert [e.shape for e in enc] == [e.shape for e in want_enc]
    assert [p.shape for p in d.postnet] == [p.shape for p in want.postnet]
    # each PreNet layer reads the first columns of its mask
    W = model.decoder.decoder_cell.pre_net.mask_width
    assert W == {"taco2": 128, "taco1": 256}[name] == d.prenet.shape[-1]


def test_synthesizer_tacotron1_matches_jax():
    """`TacotronSynthesizer.synthesize` of a tacotron1 model (CBHG encoder,
    Markov attention on the memory mask, MelPostnet2) with the vocoder."""
    from test_torch_vocoder import AUDIO, GEN_KWARGS, M, jax_generator_params
    from torch_tts_tpu.infer import taco_serving as jserving
    from torch_tts_tpu.infer import vocoder as jvoc
    from torch_tts_tpu_torch.infer import taco_serving as serving
    from torch_tts_tpu_torch.infer import vocoder
    from torch_tts_tpu_torch.models.vits2.convert import generator_state_dict_from_jax_params

    buckets, tiers, texts = ((16, 10), (32, 14)), (1, 2), ["hello world", "abc", "a longer one"]

    def cfg_for(pkg):
        return variant_cfg(pkg, "taco1", dataclasses.replace(
            tiny_cfg(pkg), audio=pkg.TacotronAudioConfig(**AUDIO), text=pkg.TacotronTextConfig()))

    jc, tc = cfg_for(jcfg), cfg_for(tcfg)
    rng = np.random.default_rng(61)
    jm = jax_build(jc)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, jnp.ones((1, 8), jnp.int32), jnp.asarray([8]),
        jnp.zeros((1, 4, M)), train=True, deterministic=False))
    variables = {"params": fill(shapes["params"], rng),
                 "batch_stats": fill(shapes["batch_stats"], rng, stats=True)}
    vparams = jax_generator_params(GEN_KWARGS, M, seed=9)
    jv = jvoc.Vocoder(params=vparams, gen_kwargs=GEN_KWARGS, sample_rate=AUDIO["sample_rate"],
                      num_mels=M)
    want = jserving.TacotronSynthesizer(jc, variables, vocoder=jv, buckets=buckets,
                                        batch_tiers=tiers).synthesize(texts, seed=3)
    gen = vocoder.build_generator(GEN_KWARGS, M)
    gen.load_state_dict(generator_state_dict_from_jax_params(vparams, (3,)), strict=True)
    tv = vocoder.Vocoder(gen, GEN_KWARGS, AUDIO["sample_rate"], M, device="cpu")
    model = port_model(variables, tc).eval()
    widths = [layer.weight.shape[0] for layer in model.decoder.decoder_cell.pre_net.layers]
    W = max(widths)

    def jax_masks(seed, steps, batch):
        """The JAX group key's per-step masks fold_in(fold_in(kd, t), j)."""
        kd, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), batch))
        keys = [jax.random.fold_in(kd, t) for t in range(steps)]
        return torch.stack([torch.stack([
            widened(jax.random.bernoulli(jax.random.fold_in(k, j), 0.5, (batch, w)), W)
            for j, w in zip((1, 2), widths)]) for k in keys])

    got = serving.TacotronSynthesizer(tc, model, vocoder=tv, buckets=buckets, batch_tiers=tiers,
                                      prenet_masks=jax_masks, device="cpu").synthesize(texts, 3)
    for g, w in zip(got, want):
        assert g.audio.shape == w.audio.shape and g.audio.size > 0
        np.testing.assert_allclose(g.audio, w.audio, rtol=0, atol=MODEL_ATOL)
        np.testing.assert_allclose(g.attn, np.asarray(w.attn), rtol=0, atol=MODEL_ATOL)
