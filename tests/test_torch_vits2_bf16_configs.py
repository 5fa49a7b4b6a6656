"""bf16 VITS2 training (`train.use_bf16`) across configurations, the plain
WN versions in bf16, and the trainer: the port against the JAX package.

- Multi-speaker (the tiny config of
  tests/test_torch_vits2_multispeaker_train.py: 4 speakers, gin 8, the
  speaker-conditioned text encoder) and MB-iSTFT (the tiny config of
  tests/test_torch_vits2_mbistft.py): the training forward on bf16
  parameters against the jitted JAX bf16 forward, with the same weights
  (numpy seed, the port's converters, strict=True) and the draws injected
  in JAX's dtypes: every output's dtype equal, the `wn_stack` calls'
  dtypes equal (an abstract JAX trace, as in
  tests/test_torch_vits2_bf16_train.py), the alignment equal in at least
  99% of its cells (a MAS near-tie can go either way under the two
  packages' bf16 roundings), and, with JAX's alignment given to the port's
  MAS, every output within 2 |JAX bf16 - port fp32| + one bf16 ulp (2^-8)
  of its norm, in the L2 norm, beside the port's fp32 forward. JAX's `lax.complex` refuses bf16
  parts, so the JAX package's own bf16 MB-iSTFT forward raises in its
  iSTFT; the port builds the complex spectrum in fp32 there, and the JAX
  side of this test does the same by a patched `lax.complex`. Then one
  port step each, finite, with fp32 masters and optimizer moments (the
  speaker embedding's gradient among them, through the WN kernels'
  conditioning path).
- The plain WN group and its backward in bf16 against the JAX
  `wn_group_ref` and its VJP in bf16 (with and without conditioning): every
  output and gradient bf16, as the JAX ones, within 2^-6 of its peak (a
  few bf16 roundings apart: XLA computes each fused elementwise chain in
  fp32 and rounds once, PyTorch rounds after every op).
- `wn_stack` computes in x's dtype: fp32 x with bf16 weights equals the
  fp32 stack on the bf16 weights' values.
- The train CLI with `train.use_bf16: true` in a JSON config: one epoch,
  then a resume to the second, bit for bit the state of two epochs
  straight; the checkpoints hold fp32 parameters.
"""

import contextlib
import dataclasses
import json
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_vits2_mbistft as mb
import test_torch_vits2_multispeaker_train as ms
from test_torch_vits2_bf16_train import (ULP, _cast_tree, _dtype, jax_wn_recorder,
                                         port_wn_recorder, within_yardstick)
from test_torch_vits2_train import _torch_batch, patched_jax, random_params
from test_torch_vits2_trainer import DATA_KW, AUDIO_KW as TRAINER_AUDIO_KW
from test_torch_vits2_trainer import assert_trees_equal, make_corpus, narrow_mpd, tiny_cfg
import torch_tts_tpu.kernels.wn_stack as jwn
from torch_tts_tpu.core.config import AudioConfig as JAudio
from torch_tts_tpu.core.config import VITS2Config as JConfig
from torch_tts_tpu.core.config import VITS2ModelConfig as JModelConfig
from torch_tts_tpu.models.vits2 import MultiPeriodDiscriminator as JaxMPD
from torch_tts_tpu.models.vits2 import SynthesizerTrn as JaxSynth
from torch_tts_tpu_torch.core.config import AudioConfig, VITS2Config, VITS2ModelConfig
from torch_tts_tpu_torch.core.config import VITS2TrainConfig
from torch_tts_tpu_torch.kernels import wn_stack as wn_kernel
from torch_tts_tpu_torch.models.vits2.convert import (mpd_state_dict_from_jax_params,
                                                      state_dict_from_jax_params)
from torch_tts_tpu_torch.models.vits2.discriminators import MultiPeriodDiscriminator
from torch_tts_tpu_torch.models.vits2 import model as model_module
from torch_tts_tpu_torch.models.vits2.model import SynthesizerTrn
from torch_tts_tpu_torch.ops.layers import Dropout
from torch_tts_tpu_torch.train import checkpoint, vits2_train, vits2_trainer

B, T_X, T_Y, N_VOCAB, N_MELS = 2, 10, 30, 20, 12
X_LENGTHS, Y_LENGTHS = (10, 7), (30, 22)
CASES = {
    # model kwargs, audio kwargs, hop
    "multispeaker": (ms.MS_KW, ms.AUDIO_KW, ms.HOP),
    "mb_istft": (mb.MODEL_KW, mb.AUDIO_KW, mb.HOP),
}
WN_TOL = 2.0 ** -6  # of the peak: the plain group in bf16 against JAX's


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs (see
    tests/test_torch_vits2_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(case, use_bf16):
    model_kw, audio_kw, _ = CASES[case]
    return (JConfig(audio=JAudio(**audio_kw), model=JModelConfig(**model_kw)),
            VITS2Config(audio=AudioConfig(**audio_kw), model=VITS2ModelConfig(**model_kw),
                        train=VITS2TrainConfig(use_bf16=use_bf16)))


@contextlib.contextmanager
def complex_of_bf16_in_fp32():
    """jax.lax.complex with bf16 parts taken in fp32 (the port's rule; JAX
    refuses bf16 parts)."""
    orig = jax.lax.complex

    def complex_(re, im):
        if re.dtype == jnp.bfloat16:
            re, im = re.astype(jnp.float32), im.astype(jnp.float32)
        return orig(re, im)
    jax.lax.complex = complex_
    try:
        yield
    finally:
        jax.lax.complex = orig


def _case_inputs(case, seed):
    model_kw, _, hop = CASES[case]
    rng = np.random.default_rng(seed)
    batch = {
        "x": rng.integers(1, N_VOCAB, (B, T_X)).astype(np.int32),
        "x_lengths": np.asarray(X_LENGTHS, np.int32),
        "spec": rng.standard_normal((B, T_Y, N_MELS)).astype(np.float32),
        "spec_lengths": np.asarray(Y_LENGTHS, np.int32),
        "wav": (rng.standard_normal((B, T_Y * hop, 1)) * 0.1).astype(np.float32),
    }
    if model_kw.get("n_speakers", 0) > 1:
        batch["sid"] = np.asarray(ms.SIDS, np.int32)
    D, seg = model_kw["inter_channels"], model_kw["segment_size"] // hop
    eps = rng.standard_normal((B, T_Y, D)).astype(np.float32)
    mas = rng.standard_normal((B, T_Y, T_X)).astype(np.float32)
    u = rng.uniform(size=B).astype(np.float32)
    ids = (u * np.maximum(np.asarray(Y_LENGTHS) - seg + 1, 1)).astype(np.int32)
    noise = dict(eps=torch.from_numpy(eps).transpose(1, 2), mas_noise=torch.from_numpy(mas),
                 ids_slice=torch.from_numpy(ids))
    return rng, batch, dict(table={(B, T_Y, D): [eps], (B, T_Y, T_X): [mas]}, u=u, noise=noise)


@pytest.fixture(scope="module")
def cases():
    """Per case: random G and MPD weights, a batch, the noise, the JAX bf16
    forward's outputs (jitted, both cases compiled in threads) and its
    `wn_stack` calls' dtypes (an abstract trace with the WN stacks fused)."""
    out, pending = {}, {}
    rngs = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1),
            "dropout": jax.random.PRNGKey(2)}
    with ThreadPoolExecutor(len(CASES)) as ex:
        for i, case in enumerate(CASES):
            rng, batch, draws = _case_inputs(case, 40 + i)
            jcfg, _ = _configs(case, True)
            _, _, hop = CASES[case]
            seg = jcfg.model.segment_size // hop
            jb = {k: jnp.asarray(v) for k, v in batch.items()}
            sid = jb.get("sid")
            jmodel = JaxSynth(n_vocab=N_VOCAB, spec_channels=N_MELS, segment_frames=seg,
                              cfg=jcfg.model)
            params_g = random_params(jax.eval_shape(lambda: jmodel.init(
                rngs, jb["x"], jb["x_lengths"], jb["spec"], jb["spec_lengths"],
                sid=sid)["params"]), rng)
            jmpd = JaxMPD(periods=(2,))
            wav_seg = jnp.zeros((B, jcfg.model.segment_size, 1))
            params_d = random_params(jax.eval_shape(
                lambda: jmpd.init(rngs, wav_seg, wav_seg)["params"]), rng)

            def forward(p, jmodel=jmodel, jb=jb, sid=sid):
                return jmodel.apply({"params": p}, jb["x"], jb["x_lengths"],
                                    jb["spec"].astype(jnp.bfloat16), jb["spec_lengths"], sid=sid,
                                    mas_noise_scale=jnp.float32(0.01), deterministic=False,
                                    rngs={"noise": rngs["noise"], "dropout": rngs["dropout"]})
            pb = _cast_tree(params_g)
            calls = []
            with patched_jax(draws["table"], draws["u"]), complex_of_bf16_in_fp32():
                with jax_wn_recorder(calls), _fused_wn():
                    shapes = jax.eval_shape(forward, pb)
                lowered = jax.jit(forward).lower(pb)
            pending[case] = ex.submit(lowered.compile), pb
            out[case] = dict(batch=batch, draws=draws, params_g=params_g, params_d=params_d,
                             jcfg=jcfg, seg=seg, calls=calls, shapes=shapes)
        for case, (fut, pb) in pending.items():
            out[case]["fwd"] = jax.tree.map(lambda a: np.asarray(a, np.float32),
                                            fut.result()(pb))
    return out


@contextlib.contextmanager
def _fused_wn():
    """Both packages' WN stacks through `wn_stack` (env TTS_FUSED_WN=1, the
    port's kernel gate opened to the tiny width)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("TTS_FUSED_WN", "1")
    mp.setattr(wn_kernel, "SUPPORTED_HIDDEN", (8,))
    try:
        yield
    finally:
        mp.undo()


def _port(c, case, use_bf16):
    jcfg, cfg = _configs(case, use_bf16)
    model = SynthesizerTrn(N_VOCAB, N_MELS, cfg.model, c["seg"])
    model.load_state_dict(state_dict_from_jax_params(c["params_g"], jcfg.model), strict=True)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    mpd = MultiPeriodDiscriminator(periods=(2,))
    mpd.load_state_dict(mpd_state_dict_from_jax_params(c["params_d"], (2,)), strict=True)
    return cfg, model.train(), mpd


def _port_forward(c, case, use_bf16, attn=None):
    """The port's training forward; `attn` given, MAS returns it (masked)."""
    cfg, model, _ = _port(c, case, use_bf16)
    if attn is not None:
        mp = pytest.MonkeyPatch()
        given = lambda neg_cent, mask: torch.from_numpy(attn) * mask  # noqa: E731
        mp.setattr(model_module, "maximum_path", given)
        mp.setattr(model_module, "maximum_path_via_plain", given)
    b = _torch_batch(c["batch"])
    noise = dict(c["draws"]["noise"])
    spec = b["spec"]
    if use_bf16:
        noise["eps"], spec = noise["eps"].bfloat16(), spec.bfloat16()
    try:
        with torch.no_grad():
            return vits2_train.forward_as(cfg, model, b["x"], b["x_lengths"], spec,
                                          b["spec_lengths"], sid=b.get("sid"),
                                          mas_noise_scale=0.01, **noise)
    finally:
        if attn is not None:
            mp.undo()


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_forward_matches_jax(cases, case):
    c = cases[case]
    calls = []
    with port_wn_recorder(calls), _fused_wn():
        got = _port_forward(c, case, True)
    fp32 = _port_forward(c, case, False)
    flat, shapes = jax.tree.leaves(list(got)), jax.tree.leaves(c["shapes"])
    assert [_dtype(t) for t in flat] == [_dtype(t) for t in shapes]
    assert _dtype(got[0]) == "bfloat16"  # the decoder's audio, HiFi-GAN or MB-iSTFT
    assert calls == c["calls"] and calls[0][0] == "bfloat16"
    if case == "multispeaker":  # every WN with its conditioning, the speaker's gl
        assert all(call[2] is not None for call in calls)
    # MAS takes argmax decisions: a near-tie that the two packages' bf16
    # roundings order differently moves a cell (4 of 600 in the multi-speaker
    # case here). The values are held with JAX's alignment given to both
    # port forwards
    same = float((got[2].numpy() == c["fwd"][2]).mean())
    assert same >= 0.99, f"{case}: attn equal in {same:.3%} of its cells"
    np.testing.assert_array_equal(got[3].numpy(), c["fwd"][3])  # segment ids
    got = _port_forward(c, case, True, attn=c["fwd"][2])
    fp32 = _port_forward(c, case, False, attn=c["fwd"][2])
    flat = jax.tree.leaves(list(got))
    for i, (pb, j, pf) in enumerate(zip(flat, jax.tree.leaves(c["fwd"]),
                                        jax.tree.leaves(list(fp32)))):
        within_yardstick(f"{case} output {i}", pb.float().numpy(), j, pf.float().numpy())


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_step_keeps_fp32_masters(cases, case):
    c = cases[case]
    cfg, model, mpd = _port(c, case, True)
    order = "ddp" if case == "multispeaker" else "lightning"
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, step_order=order))
    state = vits2_train.create_train_state(cfg, model, mpd)
    grads, step = {}, state.opt_g.step
    state.opt_g.step = lambda g, apply=True: (grads.update(g=g), step(g, apply))[1]
    noise = dict(c["draws"]["noise"], eps=c["draws"]["noise"]["eps"].bfloat16())
    before = [p.detach().clone() for p in state.opt_g.params]
    metrics = vits2_train.train_step(cfg, state, _torch_batch(c["batch"]), **noise)
    assert metrics["nonfinite"] == 0.0 and state.step == 1
    assert all(np.isfinite(v) for v in metrics.values())
    for opt in (state.opt_g, state.opt_d):
        for p, mu, nu in zip(opt.params, opt.mu, opt.nu):
            assert p.dtype == mu.dtype == nu.dtype == torch.float32 and torch.isfinite(p).all()
    assert all(g.dtype == torch.float32 for g in grads["g"])
    assert sum(not torch.equal(a, b) for a, b in zip(before, state.opt_g.params)) > len(before) // 2
    if case == "multispeaker":
        names = [n for n, _ in model.named_parameters() if ".post_transformer." not in n]
        by_name = dict(zip(names, grads["g"]))
        for n in ms.SPEAKER_PARAMS:
            assert float(by_name[n].abs().sum()) > 0, n


# ---------------------------------------------------------------- the plain WN in bf16


def _wn_inputs(seed, with_gl, L=3, H=8, k=5, T=20):
    rng = np.random.default_rng(seed)
    lengths = np.array([T, 13])
    mask = (np.arange(T)[None, :, None] < lengths[:, None, None]).astype(np.float32)
    w_rs = rng.standard_normal((L, H, 2 * H)) * 0.5 / np.sqrt(H)
    b_rs = rng.standard_normal((L, 2 * H)) * 0.1
    w_rs[-1, :, :H], b_rs[-1, :H] = 0, 0
    arrs = [rng.standard_normal((2, T, H)), mask,
            rng.standard_normal((2, L, 2 * H)) * 0.3 if with_gl else None,
            rng.standard_normal((L, k, H, 2 * H)) * 0.5 / np.sqrt(k * H),
            rng.standard_normal((L, 2 * H)) * 0.1, w_rs, b_rs]
    # bf16 values on both sides
    t = [None if a is None else torch.from_numpy(a.astype(np.float32)).bfloat16() for a in arrs]
    j = [None if a is None else jnp.asarray(a.float().numpy(), jnp.bfloat16) for a in t]
    return t, j


def _close_bf16(got, want, what):
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16, what
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    err, peak = float(np.abs(g - w).max()), float(np.abs(w).max())
    assert err <= WN_TOL * peak, f"{what}: {err:.3e} > {WN_TOL} x {peak:.3e}"


@pytest.mark.parametrize("with_gl", [False, True], ids=["no-gl", "gl"])
def test_plain_wn_group_bf16_matches_jax_ref(with_gl):
    t, j = _wn_inputs(5, with_gl)
    got = wn_kernel.wn_group_plain(*t)
    want = jax.jit(jwn.wn_group_ref)(*j)
    for name, a, b in zip(("x_out", "skip"), got, want):
        _close_bf16(a, b, name)


@pytest.mark.parametrize("with_gl", [False, True], ids=["no-gl", "gl"])
def test_plain_wn_backward_bf16_matches_jax_vjp(with_gl):
    t, j = _wn_inputs(6, with_gl)
    rng = np.random.default_rng(7)
    cts = [rng.standard_normal(t[0].shape).astype(np.float32) for _ in range(2)]
    d_xo, d_sk = (torch.from_numpy(c).bfloat16() for c in cts)
    got = wn_kernel.wn_group_backward_plain(*t, d_xo, d_sk)
    x, mask, gl, *w = j

    def vjp(x, gl, *w):
        fn = lambda x_, gl_, *w_: jwn.wn_group_ref(x_, mask, gl_, *w_)  # noqa: E731
        _, pull = jax.vjp(fn, x, gl, *w)
        return pull(tuple(jnp.asarray(c, jnp.bfloat16) for c in cts))
    want = jax.jit(vjp)(x, gl, *w)
    for name, a, b in zip(("d_x", "d_gl", "d_w_in", "d_b_in", "d_w_rs", "d_b_rs"), got, want):
        if not with_gl and name == "d_gl":
            assert a is None
            continue
        _close_bf16(a, b, name)


def test_wn_stack_computes_in_x_dtype():
    """fp32 x with bf16 mask, conditioning and weights (the flows' WN under
    bf16 training) gives fp32, the fp32 stack on the bf16 values; bf16 x
    gives bf16."""
    t, _ = _wn_inputs(8, True, L=5)
    x32 = t[0].float()
    got = wn_kernel.wn_stack(x32, *t[1:])
    want = wn_kernel.wn_stack(x32, *(a.float() for a in t[1:]))
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert wn_kernel.wn_stack(*t).dtype == torch.bfloat16
    assert wn_kernel.supports(192, 5, torch.bfloat16) and wn_kernel.supports(192, 5)
    assert not wn_kernel.supports(192, 5, torch.float16)


# ---------------------------------------------------------------- the trainer


def test_bf16_cli_resume_is_bit_identical(tmp_path, monkeypatch):
    """The train CLI with `train.use_bf16: true`: one epoch, then a resume
    to the second, equal bit for bit to two epochs straight; the
    checkpoint's parameters are the fp32 masters."""
    from torch_tts_tpu_torch.cli import vits2_train as cli
    from torch_tts_tpu_torch.utils import logging_utils as lu

    monkeypatch.setattr(vits2_trainer, "build_mpd", narrow_mpd)
    root = make_corpus(tmp_path / "ds", n=10, frames=(34, 38))  # 9 clips train: 3 steps
    cfg = tiny_cfg()
    raw = {"model": dataclasses.asdict(cfg.model), "data": {**DATA_KW, **TRAINER_AUDIO_KW},
           "train": {"batch_size": 4, "log_interval": 1, "eval_interval": 3,
                     "use_bf16": True}}
    cfg_path = tmp_path / "c.json"
    cfg_path.write_text(json.dumps(raw))

    def run(name, epochs):
        return cli.main(["-c", str(cfg_path), "-m", str(tmp_path / name), "--data-root", root,
                         "--epochs", str(epochs), "--device", "cpu"], make_writer=lu.Recorder)

    straight = run("a", 2)
    assert straight.cfg.train.use_bf16 and straight.state.step == 2 * straight.steps_per_epoch
    first = run("b", 1)
    saved = checkpoint.load_file(checkpoint.latest_checkpoint(str(tmp_path / "b")))
    floats = [v for k, v in _leaves(saved) if isinstance(v, torch.Tensor) and v.is_floating_point()]
    assert floats and all(v.dtype == torch.float32 for v in floats)
    assert first.state.step == straight.steps_per_epoch
    resumed = run("b", 2)
    assert resumed.state.step == straight.state.step
    assert_trees_equal(checkpoint.state_tree(resumed.state),
                       checkpoint.state_tree(straight.state))
    assert all(np.isfinite(v) for _, v in resumed.writer.scalars["loss/g/total"])


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v
