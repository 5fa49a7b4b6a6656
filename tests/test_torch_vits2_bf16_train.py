"""bf16 VITS2 training (`train.use_bf16`): the port against the JAX package.

The tiny config, weights, batch and noise of
tests/test_torch_vits2_train_options.py (deterministic duration predictor,
one pre_conv flow, a duration discriminator, dropout off), with
`use_bf16` on both sides. The draws are injected from the JAX side in the
dtype JAX draws them in: the posterior's eps in bf16 (`m.dtype`), the MAS
noise in fp32 (`neg_cent.dtype`).

- (a) The training forward's eight outputs, and the dtypes in and out of
  every `wn_stack` call, equal JAX's (an abstract trace of the JAX forward
  on bf16 parameters, its `wn_stack` wrapped to record; the WN stacks run
  fused on both sides: TTS_FUSED_WN=1, the port's kernel gate opened to the
  tiny width). JAX's `wn_group_ref` refuses a mix of dtypes, which the
  Pallas kernel takes (its products promote the weights, its outputs take
  x's dtype): the recording wrapper casts the weights to x's dtype after
  recording them, as the port's `wn_stack` does.
- (b) One `ddp` step (with `dur_disc_1`) and one `lightning` step (with
  `dur_disc_2`) against the jitted JAX `make_train_step` from the same
  state: each loss term, and each G, D and duration-discriminator gradient
  (each network's whole gradient, and each of its tensors), within
  2 |JAX bf16 - port fp32| + atol of JAX's bf16 value, in the L2 norm. atol
  is one bf16 ulp (2^-8) of the JAX value's norm, for a tensor of its
  network's gradient norm (as the fp32 tests add 1e-6 of the global norm:
  a tensor of a few elements, a LayerNorm scale, reduces over the batch
  with cancellation, and its bf16 noise is then a large share of its own
  norm; on this config the port's bf16 tensors lie up to 4.4 times the
  yardstick from JAX's in the worst tensor, 1.3 times over a whole
  network). The port's fp32 step on the same state is the fp32 yardstick
  (tests/test_torch_vits2_train_options.py holds it to JAX within 1e-4).
  The training forward's values the same way (atol of the output's own
  norm), against the JAX step's own first forward. The master parameters, the gradients that reach them and
  the optimizer's moments stay fp32.
- (c) grad_accum = 2 in bf16: the window's mean of the fp32 gradients
  makes one update; a non-finite bf16 step leaves every parameter
  bit-identical.
- The stochastic duration predictor's forward in bf16 (DDSConv, the spline
  flows): the dtypes JAX draws its noise in, every output's dtype, and the
  values by the same yardstick.
"""

import contextlib
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_vits2_train import (B, N_MELS, N_VOCAB, PERIODS, SEG, T_X, T_Y, _recording,
                                    _torch_batch, patched_jax, random_params)
from test_torch_vits2_train_options import JAX_DUR, H, LOSSES, _configs, _port_models, setup  # noqa: F401
import torch_tts_tpu.kernels.wn_stack as jwn
from torch_tts_tpu.models.vits2 import SynthesizerTrn as JaxSynth
from torch_tts_tpu.train import vits2_train as jtrain
from torch_tts_tpu_torch.kernels import wn_stack as wn_kernel
from torch_tts_tpu_torch.models.vits2.convert import (dur_disc_state_dict_from_jax_params,
                                                      mpd_state_dict_from_jax_params,
                                                      state_dict_from_jax_params)
from torch_tts_tpu_torch.models.vits2.model import SynthesizerTrn
from torch_tts_tpu_torch.ops import wavenet as port_wavenet
from torch_tts_tpu_torch.ops.layers import Dropout
from torch_tts_tpu_torch.train import vits2_train

ULP = 2.0 ** -8  # one bf16 ulp, relative: 8 bits of significand
STEPS = (("ddp", "dur_disc_1"), ("lightning", "dur_disc_2"))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs (see
    tests/test_torch_vits2_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(cfgs):
    return tuple(dataclasses.replace(c, train=dataclasses.replace(c.train, use_bf16=True))
                 for c in cfgs)


def _noise_bf16(port_noise):
    """The port's draws in the dtypes JAX draws them in under bf16."""
    return dict(port_noise, eps=port_noise["eps"].bfloat16())


def _cast_tree(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)


def _dtype(t) -> str:
    """A tensor's or array's dtype by name; integer kinds compared as such
    (the port's segment ids are int64, JAX's int32)."""
    name = str(t.dtype).replace("torch.", "")
    return "int" if name.startswith("int") else name


def within_yardstick(name, port_bf16, jax_bf16, port_fp32, scale=None):
    """|port bf16 - JAX bf16| <= 2 |JAX bf16 - port fp32| + ULP scale, in the
    L2 norm of the tensor (a loss term: its absolute value); scale is
    |JAX bf16| unless given."""
    p, j, f = (np.asarray(a, np.float64) for a in (port_bf16, jax_bf16, port_fp32))
    err, yard = float(np.linalg.norm(p - j)), float(np.linalg.norm(j - f))
    bound = 2 * yard + ULP * (float(np.linalg.norm(j)) if scale is None else scale)
    assert np.isfinite(p).all() and err <= bound, (
        f"{name}: |bf16 port - bf16 JAX| {err:.3e} > 2 x {yard:.3e} + ulp = {bound:.3e}")


# ---------------------------------------------------------------- (a) dtypes


@contextlib.contextmanager
def jax_wn_recorder(calls):
    """JAX's `wn_stack` recording its dtypes, then run at x's dtype."""
    orig = jwn.wn_stack

    def wrapped(x, mask, gl, *w, **kw):
        c = lambda t: None if t is None else t.astype(x.dtype)  # noqa: E731
        out = orig(x, c(mask), c(gl), *map(c, w), **kw)
        calls.append(tuple(None if t is None else _dtype(t) for t in (x, mask, gl, *w, out)))
        return out
    jwn.wn_stack = wrapped
    try:
        yield
    finally:
        jwn.wn_stack = orig


@contextlib.contextmanager
def port_wn_recorder(calls):
    orig = port_wavenet.wn_stack

    def wrapped(x, mask, gl, *w, **kw):
        out = orig(x, mask, gl, *w, **kw)
        calls.append(tuple(None if t is None else _dtype(t) for t in (x, mask, gl, *w, out)))
        return out
    port_wavenet.wn_stack = wrapped
    try:
        yield
    finally:
        port_wavenet.wn_stack = orig


def test_bf16_forward_dtypes_match_jax(setup, monkeypatch):
    s = setup
    jcfg, cfg = _bf16(_configs("ddp", "dur_disc_1"))
    monkeypatch.setenv("TTS_FUSED_WN", "1")  # both packages read it at call (JAX: trace) time
    monkeypatch.setattr(wn_kernel, "SUPPORTED_HIDDEN", (H,))
    jmodel = JaxSynth(n_vocab=N_VOCAB, spec_channels=N_MELS, segment_frames=SEG, cfg=jcfg.model)
    jb, jcalls, pcalls = s["jb"], [], []
    rngs = {"noise": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)}
    with patched_jax(s["table"], s["u"]), jax_wn_recorder(jcalls):
        want = jax.eval_shape(lambda p: jmodel.apply(
            {"params": p}, jb["x"], jb["x_lengths"], jb["spec"].astype(jnp.bfloat16),
            jb["spec_lengths"], mas_noise_scale=jnp.float32(0.01), deterministic=False,
            rngs=rngs), _cast_tree(s["params_g"]))
    model = _port_models(s, cfg, jcfg, "dur_disc_1")[0]
    b = _torch_batch(s["batch"])
    with torch.no_grad(), port_wn_recorder(pcalls):
        got = vits2_train.forward_as(cfg, model, b["x"], b["x_lengths"], b["spec"].bfloat16(),
                                     b["spec_lengths"], mas_noise_scale=0.01,
                                     **_noise_bf16(s["port_noise"]))
    flat_w, flat_g = jax.tree.leaves(want), jax.tree.leaves(list(got))
    assert [_dtype(t) for t in flat_g] == [_dtype(t) for t in flat_w]
    assert [tuple(t.shape) for t in flat_g] == [tuple(t.shape) for t in flat_w]
    # y_hat, y_mask, z and the posterior's m and logs stay bf16; the text
    # side, the flows' output and the MAS outputs are fp32 (the attention's
    # fp32 logits and the fp32 MAS noise promote them)
    assert _dtype(got[0]) == "bfloat16" and _dtype(got[6][1]) == "float32"
    # the posterior encoder's WN in bf16, the flows' on fp32 x with bf16 weights
    assert pcalls == jcalls and len(pcalls) == 2
    assert pcalls[0] == ("bfloat16",) * 2 + (None,) + ("bfloat16",) * 5
    assert pcalls[1][0] == pcalls[1][-1] == "float32" and pcalls[1][3] == "bfloat16"


def test_bf16_sdp_forward_matches_jax(setup):
    """The stochastic duration predictor (DDSConv, the spline flows, its
    posterior flows) in the bf16 training forward: the dtypes of every
    output and of the draws JAX asks for, and the values against the jitted
    JAX bf16 forward by the yardstick of the port's fp32 forward."""
    s = setup
    jcfg, cfg = _configs("ddp", "dur_disc_1")
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, use_sdp=True))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, use_sdp=True))
    jmodel = JaxSynth(n_vocab=N_VOCAB, spec_channels=N_MELS, segment_frames=SEG, cfg=jcfg.model)
    jb, rng = s["jb"], np.random.default_rng(23)
    rngs = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1),
            "dropout": jax.random.PRNGKey(2)}
    params_g = random_params(jax.eval_shape(lambda: jmodel.init(
        rngs, jb["x"], jb["x_lengths"], jb["spec"], jb["spec_lengths"])["params"]), rng)
    e_q, sdp = (rng.standard_normal((B, T_X, 2)).astype(np.float32) for _ in range(2))
    table = {**s["table"], (B, T_X, 2): [e_q, sdp]}
    asked = []
    with patched_jax(table, s["u"]):
        patched = jax.random.normal

        def normal(key, shape=(), dtype=jnp.float32):
            asked.append((tuple(shape), str(jnp.dtype(dtype))))
            return patched(key, shape, dtype)
        jax.random.normal = normal
        want = jax.jit(lambda p: jmodel.apply(
            {"params": p}, jb["x"], jb["x_lengths"], jb["spec"].astype(jnp.bfloat16),
            jb["spec_lengths"], mas_noise_scale=jnp.float32(0.01), deterministic=False,
            rngs={k: rngs[k] for k in ("noise", "dropout")}))(_cast_tree(params_g))
    dtypes = dict(asked)
    # the posterior's eps in bf16, the MAS noise and the SDP's draws in fp32
    assert dtypes == {(B, T_Y, H): "bfloat16", (B, T_Y, T_X): "float32",
                      (B, T_X, 2): "float32"}
    want = jax.tree.map(lambda a: np.asarray(a, np.float32), want)
    b = _torch_batch(s["batch"])
    outs = {}
    for bf16 in (True, False):
        c = _bf16((jcfg, cfg))[1] if bf16 else cfg
        model = SynthesizerTrn(N_VOCAB, N_MELS, c.model, SEG)
        model.load_state_dict(state_dict_from_jax_params(params_g, jcfg.model), strict=True)
        for m in model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
        noise = dict(s["port_noise"], sdp_noise_q=torch.from_numpy(e_q).transpose(1, 2),
                     sdp_noise=torch.from_numpy(sdp).transpose(1, 2))
        if bf16:
            noise["eps"] = noise["eps"].bfloat16()
        with torch.no_grad():
            outs[bf16] = vits2_train.forward_as(
                c, model.train(), b["x"], b["x_lengths"],
                b["spec"].bfloat16() if bf16 else b["spec"], b["spec_lengths"],
                mas_noise_scale=0.01, **noise)
    flat = [jax.tree.leaves(list(o)) for o in (outs[True], outs[False])]
    flat_w = jax.tree.leaves(want)
    np.testing.assert_array_equal(outs[True][2].numpy(), want[2])
    for i, (pb, j, pf) in enumerate(zip(flat[0], flat_w, flat[1])):
        within_yardstick(f"sdp output {i}", pb.float().numpy(), j, pf.float().numpy())


# ---------------------------------------------------------------- (b) whole steps


def _step_and_first_forward(s, jcfg, tx, dur_disc):
    """The JAX train step, returning its first generator forward beside its
    results."""
    class FirstForward:
        def __init__(self):
            self.out = []

        def apply(self, *args, **kw):
            self.out.append(s["jmodel"].apply(*args, **kw))
            return self.out[-1]

    def step(state, batch, key):
        first = FirstForward()
        result = jtrain.make_train_step(jcfg, first, s["jmpd"], tx, dur_disc=dur_disc)(
            state, batch, key)
        return first.out[0], result
    return step


@pytest.fixture(scope="module")
def jax_runs(setup):
    """Both jitted JAX bf16 steps from the same state, with a recording
    optimizer that keeps the gradients; the `ddp` step also returns its
    first generator forward (the `lightning` step's runs inside its
    gradient transform). Each compiles in a thread as soon as it is
    traced."""
    s = setup
    pending = {}
    with ThreadPoolExecutor(2) as ex:
        with patched_jax(s["table"], s["u"]):
            for order, kind in STEPS:
                jcfg, _ = _bf16(_configs(order, kind))
                tx = _recording(jtrain.make_optimizer(jcfg, steps_per_epoch=1000))
                pd = s["params_dur"][kind]
                state = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params_g=s["params_g"],
                                          opt_g=tx.init(s["params_g"]), params_d=s["params_d"],
                                          opt_d=tx.init(s["params_d"]), params_dur=pd,
                                          opt_dur=tx.init(pd))

                args = (state, s["jb"], jax.random.PRNGKey(0))
                if order == "ddp":  # its first forward runs outside any gradient transform
                    step = _step_and_first_forward(s, jcfg, tx, JAX_DUR[kind](H))
                else:
                    step = jtrain.make_train_step(jcfg, s["jmodel"], s["jmpd"], tx,
                                                  dur_disc=JAX_DUR[kind](H))
                pending[order] = ex.submit(jax.jit(step).lower(*args).compile), args
        out = {}
        for order, (fn, args) in pending.items():
            res = fn.result()(*args)
            fwd, (new, metrics) = res if order == "ddp" else (None, res)
            out[order] = jax.tree.map(lambda a: np.asarray(a, np.float32), dict(
                fwd=fwd, metrics=metrics, grads_g=new.opt_g[1], grads_d=new.opt_d[1],
                grads_dur=new.opt_dur[1]))
    return out


def _port_step(s, order, kind, bf16):
    """One port step from the JAX state -> (metrics, state, recorded
    gradients by network, parameters before)."""
    jcfg, cfg = _configs(order, kind)
    if bf16:
        jcfg, cfg = _bf16((jcfg, cfg))
    model, mpd, dd = _port_models(s, cfg, jcfg, kind)
    state = vits2_train.create_train_state(cfg, model, mpd, dur_disc=dd)
    recorded = {}
    for name in ("g", "d", "dur"):
        opt = getattr(state, f"opt_{name}")

        def record(grads, apply=True, _name=name, _step=opt.step):
            recorded[_name] = [g.clone() for g in grads]
            return _step(grads, apply)
        opt.step = record
    noise = _noise_bf16(s["port_noise"]) if bf16 else s["port_noise"]
    before = [p.detach().clone() for p in state.opt_g.params]
    metrics = vits2_train.train_step(cfg, state, _torch_batch(s["batch"]), **noise)
    return dict(metrics=metrics, state=state, grads=recorded, before=before, jcfg=jcfg)


@pytest.fixture(scope="module", params=STEPS, ids=["ddp-dur_disc_1", "lightning-dur_disc_2"])
def step_triple(setup, jax_runs, request):
    """The JAX bf16 step beside the port's bf16 step and its fp32 step, all
    from the same state."""
    order, kind = request.param
    return dict(kind=kind, jax=jax_runs[order], bf16=_port_step(setup, order, kind, True),
                fp32=_port_step(setup, order, kind, False))


def test_bf16_step_loss_terms_match_jax(step_triple):
    jm, pb, pf = (step_triple["jax"]["metrics"], step_triple["bf16"]["metrics"],
                  step_triple["fp32"]["metrics"])
    assert pb["nonfinite"] == 0.0 == float(jm["nonfinite"])
    for k in LOSSES + ("grad_norm_g", "grad_norm_d", "grad_norm_dur_disc"):
        within_yardstick(k, pb[k], jm[k], pf[k])
    assert step_triple["bf16"]["state"].step == 1


def test_bf16_step_gradients_match_jax(step_triple, setup):
    t, kind = step_triple, step_triple["kind"]
    jcfg = t["bf16"]["jcfg"]
    st = t["bf16"]["state"]
    named = {"g": [n for n, _ in st.model.named_parameters() if ".post_transformer." not in n],
             "d": [n for n, _ in st.mpd.named_parameters()],
             "dur": [n for n, p in st.dur_disc.named_parameters()
                     if any(p is q for q in st.opt_dur.params)]}
    jax_sd = {"g": state_dict_from_jax_params(t["jax"]["grads_g"], jcfg.model),
              "d": mpd_state_dict_from_jax_params(t["jax"]["grads_d"], PERIODS),
              "dur": dur_disc_state_dict_from_jax_params(t["jax"]["grads_dur"], kind)}
    for net, names in named.items():
        assert len(names) == len(t["bf16"]["grads"][net]) > 0
        flat = [np.concatenate([a.reshape(-1) for a in arrs]) for arrs in (
            [g.numpy() for g in t["bf16"]["grads"][net]], [jax_sd[net][n].numpy() for n in names],
            [g.numpy() for g in t["fp32"]["grads"][net]])]
        within_yardstick(net, *flat)
        norm = float(np.linalg.norm(flat[1]))
        for n, gb, gf in zip(names, t["bf16"]["grads"][net], t["fp32"]["grads"][net]):
            assert gb.dtype == torch.float32  # the gradient that reaches the fp32 master
            within_yardstick(f"{net}:{n}", gb.numpy(), jax_sd[net][n].numpy(), gf.numpy(), norm)


def test_bf16_step_keeps_fp32_masters(step_triple):
    st = step_triple["bf16"]["state"]
    for opt in (st.opt_g, st.opt_d, st.opt_dur):
        for p, mu, nu in zip(opt.params, opt.mu, opt.nu):
            assert p.dtype == mu.dtype == nu.dtype == torch.float32
            assert torch.isfinite(p).all()
    moved = [not torch.equal(a, b) for a, b in zip(step_triple["bf16"]["before"], st.opt_g.params)]
    assert sum(moved) > len(moved) // 2


def test_bf16_forward_values_match_jax(setup, jax_runs):
    """The port's bf16 training forward against the JAX bf16 step's own
    first forward, beside the port's fp32 forward; attn and the segment
    ids exactly."""
    s = setup
    want = jax_runs["ddp"]["fwd"]
    b = _torch_batch(s["batch"])
    outs = {}
    for bf16 in (True, False):
        jcfg, cfg = _configs("ddp", "dur_disc_1")
        if bf16:
            jcfg, cfg = _bf16((jcfg, cfg))
        model = _port_models(s, cfg, jcfg, "dur_disc_1")[0]
        noise = _noise_bf16(s["port_noise"]) if bf16 else s["port_noise"]
        spec = b["spec"].bfloat16() if bf16 else b["spec"]
        with torch.no_grad():
            outs[bf16] = vits2_train.forward_as(cfg, model, b["x"], b["x_lengths"], spec,
                                                b["spec_lengths"], mas_noise_scale=0.01, **noise)
    np.testing.assert_array_equal(outs[True][2].numpy(), want[2])
    np.testing.assert_array_equal(outs[True][3].numpy(), want[3])
    flat = [jax.tree.leaves(list(o)) for o in (outs[True], outs[False])]
    for i, (pb, j, pf) in enumerate(zip(*flat[:1], jax.tree.leaves(want), flat[1])):
        within_yardstick(f"output {i}", pb.float().numpy(), j, pf.float().numpy())


# ---------------------------------------------------------------- (c) options


def test_bf16_grad_accum_averages_fp32_gradients(setup):
    """grad_accum = 2: the first micro-step leaves the fp32 masters as they
    are, the second updates them once from the mean of the two fp32
    micro-gradients (the port's AdamW on that mean, from the same start)."""
    s = setup
    jcfg, cfg = _bf16(_configs("ddp", "dur_disc_1", grad_accum=2))
    model, mpd, dd = _port_models(s, cfg, jcfg, "dur_disc_1")
    state = vits2_train.create_train_state(cfg, model, mpd, dur_disc=dd)
    seen, step = [], state.opt_g.step
    state.opt_g.step = lambda grads, apply=True: (seen.append([g.clone() for g in grads]),
                                                  step(grads, apply))[1]
    start = [p.detach().clone() for p in state.opt_g.params]
    batch = _torch_batch(s["batch"])
    vits2_train.train_step(cfg, state, batch, **_noise_bf16(s["port_noise"]))
    assert all(torch.equal(a, b) for a, b in zip(start, state.opt_g.params))
    metrics = vits2_train.train_step(cfg, state, batch, **_noise_bf16(s["port_noise"]))
    assert metrics["nonfinite"] == 0.0 and state.opt_g.count == 1 and state.step == 2
    assert all(g.dtype == torch.float32 for g in seen[0] + seen[1])
    t = cfg.train
    ref = [p.clone() for p in start]
    opt = vits2_train.AdamW(ref, t.learning_rate, t.betas, t.eps, t.lr_decay, 1000 // 2)
    opt.step([(a + b) / 2 for a, b in zip(*seen)])
    for a, b in zip(ref, state.opt_g.params):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-7)
    assert not all(torch.equal(a, b) for a, b in zip(start, state.opt_g.params))


def test_bf16_nonfinite_step_keeps_parameters_bit_identical(setup):
    s = setup
    jcfg, cfg = _bf16(_configs("ddp", "dur_disc_1"))
    model, mpd, dd = _port_models(s, cfg, jcfg, "dur_disc_1")
    state = vits2_train.create_train_state(cfg, model, mpd, dur_disc=dd)
    batch = _torch_batch(s["batch"])
    batch["wav"] = batch["wav"].clone()
    batch["wav"][0] = float("nan")  # both losses: D sees the real slice, G's fm too
    nets = (model, mpd)  # the duration discriminator's inputs stay finite: it steps
    before = [p.detach().clone() for n in nets for p in n.parameters()]
    metrics = vits2_train.train_step(cfg, state, batch, **_noise_bf16(s["port_noise"]))
    assert metrics["nonfinite"] == 1.0 and state.step == 0
    assert state.opt_g.count == state.opt_d.count == state.opt_dur.count == 1
    after = [p for n in nets for p in n.parameters()]
    assert all(a.dtype == torch.float32 and torch.equal(a, b) for a, b in zip(before, after))


def test_forward_as_casts_inside_the_graph(setup):
    """forward_as takes one bf16 copy of each fp32 parameter per call, in
    the autograd graph: the gradient reaches the fp32 master; without
    use_bf16 it is the module's own call."""
    s = setup
    jcfg, cfg = _bf16(_configs("ddp", "dur_disc_1"))
    mpd = _port_models(s, cfg, jcfg, "dur_disc_1")[1]
    y = torch.randn(B, 1, SEG * 8, generator=torch.Generator().manual_seed(3))
    outs = vits2_train.forward_as(cfg, mpd, y.bfloat16(), y.bfloat16())
    assert outs[0][0].dtype == torch.bfloat16
    loss = sum(o.float().sum() for o in outs[0])
    grads = torch.autograd.grad(loss, list(mpd.parameters()), allow_unused=True)
    assert all(g is None or g.dtype == torch.float32 for g in grads)
    assert sum(g is not None for g in grads) > 0
    assert all(p.dtype == torch.float32 for p in mpd.parameters())
    fp32 = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, use_bf16=False))
    assert vits2_train.forward_as(fp32, mpd, y, y)[0][0].dtype == torch.float32
