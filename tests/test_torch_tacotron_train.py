"""Tacotron training: the port (torch_tts_tpu_torch) against the JAX package.

A copy of the tiny config of tests/test_trainers_e2e.py (r = 2, dims 16,
dim_rnn (16, 16), postnet 16 x 2, 20 mels) with weights and batch
statistics from a numpy seed, converted by the port's converter and loaded
with strict=True, and a ragged B=3 batch (text 11, 8, 5 ids; 24, 19, 12
frames of 24).

JAX's threefry draws cannot be drawn again in torch, and in the JAX step
they sit inside `nn.scan`, whose body is traced once. So each JAX function
is jitted with `jax.random.uniform`, `normal` and `bernoulli` wrapped to
pass each draw to an ordered `jax.debug.callback` (`recorded`): the
record holds every draw in program order, and `draws_from_record` hands
them to the port as one `TacotronDraws`. The train step also records the
forward's outputs (a callback around its `tacotron_loss`) and its
gradients (an optax transformation chained in front of its optimizer,
`recording_tx`). One train step and one eval step are traced in turn and
compiled at once in threads.

Tolerances: the training forward's y, y_post, s and w within MODEL_ATOL
1e-4, the BatchNorms' running statistics within 1e-5; the loss terms and
grad_norm within RTOL 1e-4; gradients within RTOL 1e-4 / ATOL 1e-5;
eval_step within 1e-4; the optimizer given JAX's gradients within 1e-6 of
optax's parameters (one update and a MultiSteps window of two).
"""

import contextlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_tts_tpu.core import config as jcfg
from torch_tts_tpu.models.tacotron import build_tacotron as jax_build
from torch_tts_tpu.train import tacotron_train as jtrain
from torch_tts_tpu_torch.core import config as tcfg
from torch_tts_tpu_torch.models.tacotron.convert import state_dict_from_jax_params
from torch_tts_tpu_torch.models.tacotron.model import (Tacotron, TacotronDraws, build_tacotron,
                                                       step_route)
from torch_tts_tpu_torch.train import tacotron_train as ttrain

RTOL, ATOL, MODEL_ATOL, STATS_ATOL = 1e-4, 1e-5, 1e-4, 1e-5
ALPHABET = "#abcdefghijklmnopqrstuvwxyz "
B, L_TEXT, T_FRAMES = 3, 11, 24
TEXT_LENGTHS, FRAME_LENGTHS = (11, 8, 5), (24, 19, 12)
P_ZONEOUT, P_NO_FORCING = 0.1, 0.1


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist a thread
    per core in every worker oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cfg(pkg):
    """tests/test_trainers_e2e.py's TACO_TINY, in either package."""
    return pkg.TacotronConfig(
        audio=pkg.TacotronAudioConfig(sample_rate=8000, hop_length=64, win_length=256,
                                      num_mels=20, fmin=50, fmax=3500),
        text=pkg.TacotronTextConfig(alphabet=ALPHABET, eos_symbols="#"),
        model=pkg.TacotronModelConfig(dim_emb=16, dim_out=16, r=2, dim_pre=8, dim_att=8,
                                      dim_rnn=(16, 16), postnet_dim_hidden=16,
                                      postnet_num_layers=2))


def fill(tree, rng, stats=False):
    def one(path, x):
        name = path[-1].key
        n = rng.standard_normal(x.shape)
        if stats:
            return (0.3 * n if name == "mean" else 0.5 + rng.random(x.shape)).astype(np.float32)
        if name == "scale":
            return (1 + 0.1 * n).astype(np.float32)
        if name in ("kernel", "w_ih", "w_hh", "embedding"):
            fan = x.shape[0] if x.ndim == 2 else np.prod(x.shape[:-1])
            return (n / np.sqrt(fan)).astype(np.float32)
        return (0.2 * n).astype(np.float32)
    return jax.tree_util.tree_map_with_path(one, tree)


def make_batch(rng):
    c = rng.integers(1, len(ALPHABET) + 1, (B, L_TEXT))
    x = rng.random((B, T_FRAMES, 20)).astype(np.float32)
    for b, (n, m) in enumerate(zip(TEXT_LENGTHS, FRAME_LENGTHS)):
        c[b, n:] = 0
        x[b, m:] = 0.0
    return {"c": c.astype(np.int32), "c_lengths": np.asarray(TEXT_LENGTHS, np.int32), "x": x,
            "x_lengths": np.asarray(FRAME_LENGTHS, np.int32)}


def torch_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v)
            for k, v in batch.items()}


def jax_variables(cfg, batch, rng):
    """(flax model, {"params", "batch_stats"} filled from rng)."""
    jm = jax_build(cfg)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, batch["c"], batch["c_lengths"], batch["x"],
        batch["x_lengths"], train=True, deterministic=False))
    return jm, {"params": fill(shapes["params"], rng),
                "batch_stats": fill(shapes["batch_stats"], rng, stats=True)}


def port_model(variables, cfg=None) -> Tacotron:
    cfg = cfg or tiny_cfg(tcfg)
    model = Tacotron(cfg, 1 + len(cfg.text.alphabet))
    sd = state_dict_from_jax_params(variables["params"], variables["batch_stats"], cfg)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    return model


@contextlib.contextmanager
def recorded():
    """While open, jax.random.uniform / normal / bernoulli pass every draw
    of what is traced to an ordered debug callback; the yielded list gets
    (name, value) as the traced programs run."""
    record = []
    real = {n: getattr(jax.random, n) for n in ("uniform", "normal", "bernoulli")}

    def wrap(name):
        def draw(*args, **kw):
            out = real[name](*args, **kw)
            jax.debug.callback(lambda v: record.append((name, np.asarray(v))), out, ordered=True)
            return out
        return draw

    for n in real:
        setattr(jax.random, n, wrap(n))
    try:
        yield record
    finally:
        for n, f in real.items():
            setattr(jax.random, n, f)


def draws_from_record(record, S: int, train: bool, n_postnet: int = 2) -> TacotronDraws:
    """The JAX forward's draws in program order -> TacotronDraws: (the
    encoder's dropout, the coin,) each step's PreNet pair (, the attention
    cell's zoneout pair, the attention noise, the decoder cell's zoneout
    pair), (the postnet's dropout a layer)."""
    it = iter(record)

    def take(name):
        n, v = next(it)
        assert n == name, (n, name)
        return torch.from_numpy(np.array(v))

    enc = take("bernoulli") if train else None
    coin = take("uniform") > np.float32(P_NO_FORCING) if train else None
    prenet, z_att, z_dec, noise = [], [], [], []
    for _ in range(S):
        prenet.append(torch.stack([take("bernoulli"), take("bernoulli")]))
        if train:
            z_att.append(torch.stack([take("uniform"), take("uniform")]) < np.float32(P_ZONEOUT))
            noise.append(take("normal"))
            z_dec.append(torch.stack([take("uniform"), take("uniform")]) < np.float32(P_ZONEOUT))
    post = [take("bernoulli") for _ in range(n_postnet)] if train else None
    assert next(it, None) is None, "draws left over"
    if not train:
        return TacotronDraws(torch.stack(prenet))
    return TacotronDraws(torch.stack(prenet), coin, [torch.stack(z_att), torch.stack(z_dec)],
                         torch.stack(noise), enc, post)


def recording_tx(tx):
    """An optax transformation whose state also keeps the gradients it was
    given."""
    def init(params):
        return tx.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        upd, inner = tx.update(grads, state[0], params)
        return upd, (inner, grads)
    return optax.GradientTransformation(init, update)


def port_tree(tree, s):
    """A JAX params-shaped tree (gradients, updated parameters) -> {port
    name: tensor}; `s` is the setup fixture (its config and batch_stats)."""
    zeros = jax.tree.map(np.zeros_like, s["variables"]["batch_stats"])
    sd = state_dict_from_jax_params(tree, zeros, s["tc"])
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(5)
    jc, tc = tiny_cfg(jcfg), tiny_cfg(tcfg)
    batch = make_batch(rng)
    jm, variables = jax_variables(jc, batch, rng)
    tx = recording_tx(jtrain.make_optimizer(1e-3))
    state = jtrain.TacoTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                                  batch_stats=variables["batch_stats"],
                                  opt=tx.init(variables["params"]))
    forward = []
    real_loss = jtrain.tacotron_loss

    def loss_and_outputs(y, y_post, s, x, xmask, w, kl):
        jax.debug.callback(lambda *a: forward.append([np.asarray(v) for v in a]), y, y_post, s, w,
                           ordered=True)
        return real_loss(y, y_post, s, x, xmask, w, kl)

    jtrain.tacotron_loss = loss_and_outputs
    try:
        with recorded() as train_record:
            train_lowered = jax.jit(jtrain.make_train_step(jc, jm, tx)).lower(
                state, batch, jax.random.PRNGKey(3))
    finally:
        jtrain.tacotron_loss = real_loss
    with recorded() as eval_record:
        eval_lowered = jax.jit(jtrain.make_eval_step(jc, jm)).lower(state, batch,
                                                                   jax.random.PRNGKey(4))
    with ThreadPoolExecutor(2) as ex:
        train_fn, eval_fn = ex.map(lambda lo: lo.compile(), (train_lowered, eval_lowered))
    new_state, metrics = train_fn(state, batch, jax.random.PRNGKey(3))
    eval_metrics, eval_w = eval_fn(state, batch, jax.random.PRNGKey(4))
    jax.effects_barrier()
    S = T_FRAMES // jc.model.r
    as_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(
        jc=jc, tc=tc, batch=batch, variables=variables, S=S,
        draws=draws_from_record(train_record, S, train=True),
        eval_draws=draws_from_record(eval_record, S, train=False),
        forward=forward[0], metrics=as_np(metrics), grads=as_np(new_state.opt[1]),
        new_params=as_np(new_state.params), new_stats=as_np(new_state.batch_stats),
        eval_metrics=as_np(eval_metrics), eval_w=np.asarray(eval_w))


def test_training_forward_matches_jax(setup):
    """The training forward (BN batch statistics, the training draws, the
    coin) with JAX's recorded draws; the running statistics it leaves."""
    s = setup
    assert not bool(s["draws"].coin.all()), "some step feeds back its own frame"
    model = port_model(s["variables"])
    b = torch_batch(s["batch"])
    y, y_post, st, aux = model(b["c"], b["c_lengths"], b["x"], b["x_lengths"], train=True,
                               deterministic=False, draws=s["draws"])
    for name, got, want in zip(("y", "y_post", "s", "w"), (y, y_post, st, aux["w"]), s["forward"]):
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=MODEL_ATOL, atol=MODEL_ATOL,
                                   err_msg=name)
    want_sd = state_dict_from_jax_params(s["variables"]["params"], s["new_stats"], s["tc"])
    sd = model.state_dict()
    names = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert len(names) == 2 * 5  # three encoder BNs, two postnet BNs
    for k in names:
        np.testing.assert_allclose(sd[k].numpy(), want_sd[k], rtol=0, atol=STATS_ATOL, err_msg=k)
        assert int(sd[k.rsplit(".", 1)[0] + ".num_batches_tracked"]) == 1


def test_train_step_loss_terms_and_grad_norm_match_jax(setup):
    s = setup
    model = port_model(s["variables"])
    state = ttrain.create_train_state(model)
    metrics = ttrain.train_step(state, torch_batch(s["batch"]), draws=s["draws"])
    assert set(metrics) == set(s["metrics"]) and state.step == 1 and state.opt_g.count == 1
    for k, want in s["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), want, rtol=RTOL, atol=ATOL, err_msg=k)


def test_train_step_gradients_match_jax(setup):
    s = setup
    model = port_model(s["variables"])
    names, params = zip(*model.named_parameters())
    _, grads = ttrain.loss_and_grads(model, params, torch_batch(s["batch"]), draws=s["draws"])
    want = port_tree(s["grads"], s)
    assert sorted(names) == sorted(k for k in want if k in dict(model.named_parameters()))
    moved = 0
    for n, g in zip(names, grads):
        w = want[n].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL, err_msg=n)
        moved += bool(np.abs(w).max() > 0)
    assert moved == len(names)  # every parameter has a gradient


@pytest.mark.parametrize("scale", [4.0, 0.25], ids=["clipped", "unclipped"])
def test_adamw_matches_optax_on_the_same_gradients(setup, scale):
    """JAX's gradients (scaled: the global norm above and below the clip at
    1.0) through the port's optimizer and through optax's chain, from the
    same parameters."""
    s = setup
    grads = jax.tree.map(lambda g: g * np.float32(scale), s["grads"])
    norm = float(optax.global_norm(grads))
    assert (norm > 1.0) == (scale > 1.0), norm
    tx = jtrain.make_optimizer(1e-3)
    params = s["variables"]["params"]
    step = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))
    want = port_tree(step(grads, params), s)
    model = port_model(s["variables"])
    opt = ttrain.make_optimizer(model)
    g = port_tree(grads, s)
    opt.step([g[n] for n in opt.names])
    for n, p in zip(opt.names, opt.params):
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=0, atol=1e-6,
                                   err_msg=n)


def test_accum_steps_2_matches_multisteps(setup):
    """accum_steps 2 against optax.MultiSteps over two micro-steps: no
    update after the first, then clip + adamw on the window's mean."""
    s = setup
    g1 = s["grads"]
    g2 = jax.tree.map(lambda g: np.float32(-0.3) * g + np.float32(1e-3), g1)
    tx = jtrain.make_optimizer(1e-3, accum_steps=2)
    params = s["variables"]["params"]
    opt_state = tx.init(params)
    model = port_model(s["variables"])
    opt = ttrain.make_optimizer(model, accum_steps=2)
    before = {n: p.detach().clone() for n, p in zip(opt.names, opt.params)}
    def micro(g, st, p):
        upd, st = tx.update(g, st, p)
        return optax.apply_updates(p, upd), st

    micro = jax.jit(micro)
    for i, g in enumerate((g1, g2)):
        params, opt_state = micro(g, opt_state, params)
        gp = port_tree(g, s)
        opt.step([gp[n] for n in opt.names])
        want = port_tree(params, s)
        for n, p in zip(opt.names, opt.params):
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=0, atol=1e-6,
                                       err_msg=f"micro-step {i}: {n}")
        if i == 0:
            assert all(torch.equal(before[n], p) for n, p in zip(opt.names, opt.params))
    assert (opt.count, opt.mini_step) == (1, 0)


def test_eval_step_matches_jax(setup):
    """eval_step: train=False, deterministic, every step teacher-forced,
    the PreNet's masks still on (JAX's, recorded)."""
    s = setup
    model = port_model(s["variables"])
    metrics, w = ttrain.eval_step(model, torch_batch(s["batch"]), draws=s["eval_draws"])
    np.testing.assert_allclose(w.numpy(), s["eval_w"], rtol=MODEL_ATOL, atol=MODEL_ATOL)
    for k, want in s["eval_metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), want, rtol=MODEL_ATOL, atol=MODEL_ATOL,
                                   err_msg=k)
    # the running statistics are read, not updated
    assert all(int(v) == 0 for k, v in model.state_dict().items() if "num_batches" in k)


def test_step_route_takes_the_kernel_only_without_gradient():
    assert step_route("cuda", True, True, False) == "kernel"
    for args in (("cpu", True, True, True), ("cuda", False, True, True),
                 ("cuda", True, False, True), ("cuda", True, False, False)):
        assert step_route(*args) == "cells", args
    with pytest.raises(RuntimeError, match="no backward"):
        step_route("cuda", True, True, True)


def test_draws_from_a_generator(setup):
    """`Tacotron.draw`'s shapes and rates, and a forward from a generator
    equal to one from the draws it gives."""
    s = setup
    model = port_model(s["variables"])
    S, b = s["S"], torch_batch(s["batch"])
    d = model.draw(B, L_TEXT, S, torch.Generator().manual_seed(0))
    shapes = {"prenet": (S, 2, B, 8), "coin": (S,), "att_noise": (S, B, L_TEXT),
              "encoder": (B, L_TEXT, 32)}
    for name, shape in shapes.items():
        assert tuple(getattr(d, name).shape) == shape, name
    assert [tuple(z.shape) for z in d.zoneout] == [(S, 2, 16), (S, 2, 16)]
    assert [tuple(m.shape) for m in d.postnet] == [(B, S * 2, 16)] * 2
    big = model.draw(16, 32, 1024, torch.Generator().manual_seed(1))
    for name, rate in (("prenet", 0.5), ("coin", 0.9), ("zoneout", 0.1), ("encoder", 0.9)):
        m = getattr(big, name)
        m = (m[0] if name == "zoneout" else m).float()
        assert abs(m.mean().item() - rate) < 4 * (rate * (1 - rate) / m.numel()) ** 0.5, name
    outs = []
    for draws, gen in ((d, None), (None, torch.Generator().manual_seed(0))):
        m = port_model(s["variables"])
        outs.append(m(b["c"], b["c_lengths"], b["x"], train=True, deterministic=False,
                      draws=draws, generator=gen)[1])
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


def test_free_running_forward_equals_infer(setup):
    """forward without teacher mels is the free-running decode of `infer`."""
    s = setup
    model = build_tacotron(s["tc"], seed=3, device="cpu")
    b = torch_batch(s["batch"])
    draws = model.draw(B, L_TEXT, 7, torch.Generator().manual_seed(2), train=False)
    with torch.no_grad():
        got = model(b["c"], b["c_lengths"], max_steps=7, draws=draws)
    want = model.infer(b["c"], b["c_lengths"], max_steps=7, prenet_masks=draws.prenet)
    for a, w in zip(got[:3], want[:3]):
        torch.testing.assert_close(a, w, rtol=0, atol=0)
    torch.testing.assert_close(got[3]["w"], want[3]["w"], rtol=0, atol=0)
    assert torch.equal(got[3]["stop_lengths"], want[3]["stop_lengths"])


def test_teacher_forced_decoder_draws_its_masks_and_the_step_keeps_the_mode(setup):
    """`Decoder.forward(x=..., generator=g)` draws the PreNet's masks as
    `draw_prenet_masks` does from the same seed; draws and prenet_masks
    together are refused; `loss_and_grads` restores the model's mode."""
    s = setup
    model = port_model(s["variables"]).eval()
    S, b = s["S"], torch_batch(s["batch"])
    with torch.no_grad():
        memory = model.encoder(b["c"], b["c_lengths"])
        masks = model.decoder.draw_prenet_masks(S, B, memory.device,
                                                torch.Generator().manual_seed(5))
        got = model.decoder(memory, x=b["x"], generator=torch.Generator().manual_seed(5))
        want = model.decoder(memory, x=b["x"], prenet_masks=masks)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=0)
    with pytest.raises(ValueError, match="not both"):
        model.decoder(memory, x=b["x"], prenet_masks=masks, draws=TacotronDraws(masks))
    params = [p for _, p in model.named_parameters()]
    for training in (False, True):
        model.train(training)
        ttrain.loss_and_grads(model, params, b, draws=s["draws"])
        assert model.training is training
