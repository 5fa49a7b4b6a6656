"""The VAE style path of Tacotron: the port (torch_tts_tpu_torch) against
the JAX package.

The tiny config of tests/test_torch_tacotron_train.py (Taco2Prod, r = 2,
dims 16, 20 mels) with style_dim_vae = 4, weights and batch statistics
from a numpy seed, converted by the port's converter and loaded with
strict=True. The training batch is ragged B=3 (text 11, 8, 5 ids; 130, 97
and 70 frames of 130: not a multiple of 64, so the reference encoder's
output index, clip(length // 64, 1, T') - 1, differs per item); the
reference mels for inference are another ragged batch (150, 100, 70
frames). The VAE's eps and every other draw of the JAX functions are
recorded (`recorded`) and handed to the port. One jit per JAX reference:
the ReferenceEncoder in its four modes, the VAE, `encode` + `infer` with a
reference, the train step and the eval step, compiled at once in threads.

Tolerances (tests/test_torch_tacotron_train.py's): outputs within 1e-4,
the BatchNorms' statistics within 1e-5; the loss terms and grad_norm RTOL
1e-4; gradients RTOL 1e-4 / ATOL 1e-5.
"""

import dataclasses
import json
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax

from test_torch_tacotron_train import (ATOL, MODEL_ATOL, RTOL, STATS_ATOL, recorded, torch_batch)
from test_torch_tacotron_variants_train import (jax_step_records, jax_variables, port_model,
                                                variant_cfg, variant_draws)
from torch_tts_tpu.core import config as jcfg
from torch_tts_tpu.models.tacotron.model import Tacotron as JaxTacotron
from torch_tts_tpu.ops.style import VAE as JaxVAE
from torch_tts_tpu.ops.style import ReferenceEncoder as JaxReferenceEncoder
from torch_tts_tpu_torch.cli import tacotron_infer
from torch_tts_tpu_torch.core import config as tcfg
from torch_tts_tpu_torch.kernels import taco_step as ts
from torch_tts_tpu_torch.models.tacotron.convert import state_dict_from_jax_params
from torch_tts_tpu_torch.train import tacotron_train as ttrain
from torch_tts_tpu_torch.utils.logging_utils import Recorder, plot_alignment_to_numpy, write_png

B, L_TEXT, TEXT_LENGTHS = 3, 11, (11, 8, 5)
FRAME_LENGTHS, REF_LENGTHS = (130, 97, 70), (150, 100, 70)
STEPS, DIM_VAE, M = 24, 4, 20


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist a thread
    per core in every worker oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ragged_mels(rng, lengths):
    x = rng.random((len(lengths), max(lengths), M)).astype(np.float32)
    for b, n in enumerate(lengths):
        x[b, n:] = 0.0
    return x


def make_batch(rng):
    c = rng.integers(1, 28, (B, L_TEXT))
    for b, n in enumerate(TEXT_LENGTHS):
        c[b, n:] = 0
    return {"c": c.astype(np.int32), "c_lengths": np.asarray(TEXT_LENGTHS, np.int32),
            "x": ragged_mels(rng, FRAME_LENGTHS), "x_lengths": np.asarray(FRAME_LENGTHS, np.int32)}


def normals(record):
    return [torch.from_numpy(np.array(v)) for n, v in record if n == "normal"]


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(17)
    jc, tc = variant_cfg(jcfg, "vae"), variant_cfg(tcfg, "vae")
    batch = make_batch(rng)
    jm, variables = jax_variables(jc, batch, rng, xref=True)
    xref, xrl = ragged_mels(rng, REF_LENGTHS), np.asarray(REF_LENGTHS, np.int32)
    p, bs = variables["params"]["refencoder"], variables["batch_stats"]["refencoder"]
    renc = JaxReferenceEncoder(128)

    def ref_fn(v, mels, lengths):
        """(train-mode h, its new statistics, eval-mode h) with and without lengths."""
        outs = []
        for lens in (lengths, None):
            h, mut = renc.apply(v, mels, lens, train=True, mutable=["batch_stats"])
            outs.append((h, mut["batch_stats"], renc.apply(v, mels, lens, train=False)))
        return outs

    def vae_fn(v, mels, lengths, key):
        return JaxVAE(dim_emb=16, dim_vae=DIM_VAE).apply(v, mels, lengths, rngs={"noise": key})

    kd, kn = jax.random.PRNGKey(7), jax.random.PRNGKey(8)

    def infer_fn(v, c, cl, xr, xl):
        mem, mmask = jm.apply(v, c, cl, xr, xl, method=JaxTacotron.encode, rngs={"noise": kn})
        out = jm.apply(v, c, cl, xref=xr, xref_lengths=xl, max_steps=STEPS, dropout_key=kd,
                       rngs={"noise": kn})
        return mem, mmask, out

    rv = {"params": p["encoder"], "batch_stats": bs["encoder"]}
    vv = {"params": p, "batch_stats": bs}
    with ThreadPoolExecutor(4) as pool:
        run_steps = jax_step_records(jc, jm, variables, batch, pool, xref=True)
        ref_c = pool.submit(jax.jit(ref_fn).lower(rv, xref, xrl).compile)
        with recorded() as vae_record:
            vae_c = pool.submit(jax.jit(vae_fn).lower(vv, xref, xrl, kn).compile)
        with recorded() as infer_record:
            infer_c = pool.submit(jax.jit(infer_fn).lower(
                variables, batch["c"], batch["c_lengths"], xref, xrl).compile)
        steps = run_steps()
        ref_out = ref_c.result()(rv, xref, xrl)
        vae_out = vae_c.result()(vv, xref, xrl, kn)
        infer_out = infer_c.result()(variables, batch["c"], batch["c_lengths"], xref, xrl)
        jax.effects_barrier()
    model = port_model(variables, tc)
    S = max(FRAME_LENGTHS) // 2
    as_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(jc=jc, tc=tc, batch=batch, variables=variables, xref=xref, xrl=xrl,
                ref_out=as_np(ref_out), vae_out=as_np(vae_out), vae_eps=normals(vae_record)[0],
                infer_out=as_np(infer_out), infer_record=infer_record, **steps,
                draws=variant_draws(steps["train_record"], model, S, train=True, style=True),
                eval_draws=variant_draws(steps["eval_record"], model, S, train=False))


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("with_lengths", [True, False], ids=["lengths", "no_lengths"])
def test_reference_encoder_matches_jax(setup, with_lengths):
    """Batch statistics (updating the running ones) and running statistics;
    with lengths, each item's output at its floor(length / 64)."""
    s = setup
    h_train, stats, h_eval = s["ref_out"][0 if with_lengths else 1]
    lens = t(s["xrl"]) if with_lengths else None
    enc = port_model(s["variables"], s["tc"]).refencoder.encoder
    with torch.no_grad():
        got_eval = enc(t(s["xref"]), lens)
        got_train = enc(t(s["xref"]), lens, batch_stats=True)
    np.testing.assert_allclose(got_eval.numpy(), h_eval, rtol=MODEL_ATOL, atol=MODEL_ATOL)
    np.testing.assert_allclose(got_train.numpy(), h_train, rtol=MODEL_ATOL, atol=MODEL_ATOL)
    for i in range(6):
        bn = getattr(enc, f"bn_{i}")
        for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_allclose(getattr(bn, ours).numpy(),
                                       stats[f"bn_{i}"]["BatchNorm_0"][theirs], rtol=0,
                                       atol=STATS_ATOL, err_msg=f"bn_{i}.{ours}")
    if with_lengths:  # the items read different steps of the LSTM (T' = 3)
        assert [min(max(n // 64, 1), 3) for n in REF_LENGTHS] == [2, 1, 1]
        assert not np.allclose(h_eval, s["ref_out"][1][2])


def test_vae_matches_jax(setup):
    s = setup
    style, losses = s["vae_out"]
    vae = port_model(s["variables"], s["tc"]).refencoder
    with torch.no_grad():
        got, got_losses = vae(t(s["xref"]), t(s["xrl"]), s["vae_eps"])
    assert tuple(s["vae_eps"].shape) == (B, DIM_VAE) and got.shape == (B, 1, 16)
    np.testing.assert_allclose(got.numpy(), style, rtol=MODEL_ATOL, atol=MODEL_ATOL)
    np.testing.assert_allclose(got_losses["kl"].numpy(), losses["kl"], rtol=MODEL_ATOL,
                               atol=MODEL_ATOL)


def test_training_forward_with_xref_matches_jax(setup):
    """xref = x: y, y_post, s, w, kl_loss, and the statistics of every BN
    (the reference encoder's six included)."""
    s = setup
    model = port_model(s["variables"], s["tc"])
    b = torch_batch(s["batch"])
    y, y_post, st, aux = model(b["c"], b["c_lengths"], b["x"], b["x_lengths"], xref=b["x"],
                               xref_lengths=b["x_lengths"], train=True, deterministic=False,
                               draws=s["draws"])
    got = (y, y_post, st, aux["w"], aux["kl_loss"])
    for k, g, want in zip(("y", "y_post", "s", "w", "kl_loss"), got, s["forward"]):
        np.testing.assert_allclose(g.detach().numpy(), want, rtol=MODEL_ATOL, atol=MODEL_ATOL,
                                   err_msg=k)
    assert float(aux["kl_loss"].detach()) > 0 and aux["kl_loss"].requires_grad
    want_sd = state_dict_from_jax_params(s["variables"]["params"], s["new_stats"], s["tc"])
    names = [k for k in model.state_dict() if k.endswith(("running_mean", "running_var"))]
    assert len(names) == 2 * (3 + 2 + 6)  # encoder, postnet, reference encoder
    for k in names:
        np.testing.assert_allclose(model.state_dict()[k].numpy(), want_sd[k], rtol=0,
                                   atol=STATS_ATOL, err_msg=k)


def test_train_step_with_xref_matches_jax(setup):
    """The loss terms (loss_kl > 0 reaches the loss), grad_norm and the
    gradients of every parameter, the VAE's included."""
    s = setup
    state = ttrain.create_train_state(port_model(s["variables"], s["tc"]))
    metrics = ttrain.train_step(state, torch_batch(s["batch"]), draws=s["draws"])
    assert set(metrics) == set(s["metrics"]) and float(metrics["loss_kl"]) > 0
    for k, want in s["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), want, rtol=RTOL, atol=ATOL, err_msg=k)
    model = port_model(s["variables"], s["tc"])
    names, params = zip(*model.named_parameters())
    _, grads = ttrain.loss_and_grads(model, params, torch_batch(s["batch"]), draws=s["draws"])
    zeros = jax.tree.map(np.zeros_like, s["variables"]["batch_stats"])
    want = state_dict_from_jax_params(s["grads"], zeros, s["tc"])
    assert any(n.startswith("refencoder.") for n in names)
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[n], rtol=RTOL, atol=ATOL, err_msg=n)
        assert np.abs(want[n]).max() > 0, n


def test_eval_step_skips_the_style(setup):
    """eval_step passes no reference mel (the JAX step's): kl_loss is 0."""
    s = setup
    model = port_model(s["variables"], s["tc"])
    metrics, w = ttrain.eval_step(model, torch_batch(s["batch"]), draws=s["eval_draws"])
    assert s["eval_draws"].style_eps is None and float(metrics["loss_kl"]) == 0.0
    np.testing.assert_allclose(w.numpy(), s["eval_w"], rtol=MODEL_ATOL, atol=MODEL_ATOL)
    for k, want in s["eval_metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), want, rtol=MODEL_ATOL, atol=MODEL_ATOL,
                                   err_msg=k)


def infer_draws(s, model):
    """(encode's eps, infer's eps, infer's PreNet masks) from JAX's record."""
    eps_enc, eps_inf = normals(s["infer_record"])
    record = [(n, v) for n, v in s["infer_record"] if n != "normal"]
    return eps_enc, eps_inf, variant_draws(record, model, STEPS, train=False).prenet


def test_infer_and_encode_with_xref_match_jax(setup):
    s = setup
    mem, mmask, (y, y_post, st, aux) = s["infer_out"]
    model = port_model(s["variables"], s["tc"]).eval()
    eps_enc, eps_inf, masks = infer_draws(s, model)
    c, cl = t(s["batch"]["c"]).long(), t(s["batch"]["c_lengths"]).long()
    got_mem, got_mask = model.encode(c, cl, t(s["xref"]), t(s["xrl"]), style_eps=eps_enc)
    np.testing.assert_allclose(got_mem.numpy(), mem, rtol=MODEL_ATOL, atol=MODEL_ATOL)
    np.testing.assert_array_equal(got_mask.numpy(), mmask)
    gy, gyp, gs, gaux = model.infer(c, cl, STEPS, prenet_masks=masks, xref=t(s["xref"]),
                                    xref_lengths=t(s["xrl"]), style_eps=eps_inf)
    for k, g, want in (("y", gy, y), ("y_post", gyp, y_post), ("s", gs, st),
                       ("w", gaux["w"], aux["w"])):
        np.testing.assert_allclose(g.numpy(), want, rtol=MODEL_ATOL, atol=MODEL_ATOL, err_msg=k)
    np.testing.assert_array_equal(gaux["stop_lengths"].numpy(), aux["stop_lengths"])
    # the style changes the decode; a generator draws the masks, then eps
    plain = model.infer(c, cl, STEPS, prenet_masks=masks)[1]
    assert float((plain - gyp).abs().max()) > 1e-3
    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    drawn = model.draw(B, L_TEXT, STEPS, g2, train=False, style=True)
    a = model.infer(c, cl, STEPS, generator=g1, xref=t(s["xref"]), xref_lengths=t(s["xrl"]))[1]
    b = model.infer(c, cl, STEPS, prenet_masks=drawn.prenet, xref=t(s["xref"]),
                    xref_lengths=t(s["xrl"]), style_eps=drawn.style_eps)[1]
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_taco2prod_step_on_styled_ragged_memory_matches_jax(setup):
    """The styled memory is not zero past each text's length, and the
    attention reads every position in both packages: the port's cell route
    on JAX's styled memory gives JAX's decode, and the plain version of
    the step kernel (`taco_step_streamed` on the CPU) gives the cell
    route's, step by step."""
    s = setup
    mem, _, (y, _, st, aux) = s["infer_out"]
    for b, n in enumerate(TEXT_LENGTHS[1:], 1):
        assert np.abs(mem[b, n:]).min() > 0, "the style reaches the padding"
    model = port_model(s["variables"], s["tc"]).eval()
    _, _, masks = infer_draws(s, model)
    dec = model.decoder
    with torch.no_grad():
        gy, gs, gw, _ = dec(t(mem), STEPS, masks)
    np.testing.assert_allclose(gy.numpy(), y, rtol=MODEL_ATOL, atol=MODEL_ATOL)
    np.testing.assert_allclose(gw.numpy(), aux["w"], rtol=MODEL_ATOL, atol=MODEL_ATOL)
    assert float(gw[2, :, TEXT_LENGTHS[2]:].sum()) > 0  # weight moves into the padding
    packed = dec.packed_weights()
    state, y_in = dec.init_carry(t(mem))
    ones = torch.ones(B, L_TEXT)
    step = torch.no_grad()(ts.taco_step_streamed)  # the parameters need no gradient here
    for j in range(STEPS):
        y_t, _, state = step(y_in, state, t(mem), ones, packed, dec.decoder_cell.p_zoneout,
                             n_tile=64, prenet_masks=(masks[j, 0], masks[j, 1]))
        np.testing.assert_allclose(y_t.numpy(), gy[:, 2 * j:2 * j + 2].reshape(B, -1).numpy(),
                                   rtol=MODEL_ATOL, atol=MODEL_ATOL, err_msg=f"step {j}")
        y_in = y_t.reshape(B, 2, M)[:, -1]


def read_png(path):
    """(width, height, RGB array) of a PNG as write_png writes it."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        assert struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] == zlib.crc32(kind + body)
        chunks.setdefault(kind, b"")
        chunks[kind] += body
        pos += 12 + n
    w, h, depth, colour = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (depth, colour) == (8, 2) and b"IEND" in chunks
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return w, h, rows[:, 1:].reshape(h, w, 3)


def test_write_png_round_trips_the_alignment_image(tmp_path):
    img = plot_alignment_to_numpy(np.random.default_rng(0).random((13, 7)))
    write_png(str(tmp_path / "a.png"), img)
    w, h, pixels = read_png(str(tmp_path / "a.png"))
    assert (h, w) == img.shape[:2] == (7, 13)
    np.testing.assert_array_equal(pixels, img)


def test_cli_ref_and_plot_on_cpu(setup, tmp_path):
    """`tacotron_infer --ref WAV --plot PNG` on a VAE model: the mel of
    `infer` with the CLI's seeded generator (masks, then eps) and the
    reference's m_fwd mel; the PNG is the attention image of the decode
    up to its stop."""
    from scipy.io import wavfile

    from torch_tts_tpu_torch.audio.frontend import AudioFrontend, m_fwd

    s = setup
    cfg = s["tc"]
    model = port_model(s["variables"], cfg).eval()
    ckpt, cfg_path = tmp_path / "vae.pth", tmp_path / "vae.json"
    torch.save({"model": model.state_dict()}, ckpt)
    cfg_path.write_text(json.dumps({k: dataclasses.asdict(getattr(cfg, k))
                                    for k in ("audio", "text", "model")}))
    rng = np.random.default_rng(3)
    tt = np.arange(int(0.5 * cfg.audio.sample_rate)) / cfg.audio.sample_rate
    ref = 0.3 * np.sin(2 * np.pi * 180 * tt) + 0.02 * rng.standard_normal(tt.size)
    wavfile.write(str(tmp_path / "ref.wav"), cfg.audio.sample_rate,
                  np.round(ref * 32767).astype(np.int16))
    out, png = tmp_path / "o.wav", tmp_path / "a.png"
    text = "hello there"
    wav, mel = tacotron_infer.main([text, str(cfg_path), "-m", str(ckpt), "-o", str(out),
                                    "--max-steps", "12", "--griffin-lim-iters", "2",
                                    "--device", "cpu", "--seed", "5", "--ref",
                                    str(tmp_path / "ref.wav"), "--plot", str(png)])
    assert np.isfinite(wav).all() and out.stat().st_size == 44 + 2 * wav.size
    ids = tacotron_infer.text_encoder(cfg).encode(text)
    c, cl = torch.tensor([ids]), torch.tensor([len(ids)])
    fe = AudioFrontend(cfg.audio, "cpu")
    sr, pcm = wavfile.read(str(tmp_path / "ref.wav"))
    xref = m_fwd(fe.encode(pcm.astype(np.float32) / 32768.0, sr)[1])[None]
    _, y_post, _, aux = model.infer(c, cl, 12, generator=torch.Generator().manual_seed(5),
                                    xref=xref, xref_lengths=torch.tensor([xref.shape[1]]))
    n = int(aux["stop_lengths"][0])
    torch.testing.assert_close(mel, y_post[0, :2 * n], rtol=0, atol=0)
    w, h, pixels = read_png(str(png))
    assert (w, h) == (n, len(ids))
    np.testing.assert_array_equal(pixels, plot_alignment_to_numpy(aux["w"][0, :n].numpy()))


def test_trainer_runs_a_vae_config(setup, tmp_path):
    """TacotronTrainer on a VAE config: an epoch of two steps with
    evaluate() and a checkpoint; the KL term is logged above 0."""
    s = setup
    batch = {k: v for k, v in s["batch"].items()}
    rec = Recorder()
    trainer = ttrain.TacotronTrainer(s["tc"], str(tmp_path), make_writer=lambda d: rec,
                                     device="cpu")
    assert trainer.model.refencoder is not None
    trainer.train([batch, batch], eval_batches=[batch], num_epochs=1, log_interval=1)
    kl = [v for _, v in rec.scalars["loss_kl"]]
    assert len(kl) == 2 and all(np.isfinite(v) and v > 0 for v in kl)
    assert np.isfinite(rec.scalars["eval/loss"][0][1]) and trainer.state.step == 2
    assert (tmp_path / "ckpt_2.pt").exists() or any(p.name.startswith("ckpt_")
                                                    for p in tmp_path.iterdir())
