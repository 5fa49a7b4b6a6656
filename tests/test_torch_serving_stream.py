"""The serving layer's streaming, long-form, warm-up, loading and speaker
paths (`infer/serving.py`), on the port alone, with the tiny model and
buckets of tests/test_torch_serving.py (`jax_pair`'s weights).

Held: `stream(text, seed)` concatenated against `synthesize([text],
seed)[0].audio` with float32 transfer at nonzero noise within 2e-5, with
windows and in one window; `synthesize_long` and `stream_long` of a text
over the largest bucket: the lengths of the pieces plus the pauses, and
the long stream equal to its pieces' streams with the pauses between;
`warmup` and
`warmup_streaming` run the grid; `from_run_dir` on a reference-format
`.pth` written by the JAX exporter (the same audio as the converted
weights, exactly) and on a run directory, its latest checkpoint and
`average_last=2` (the average of the weights); `sid` on a multi-speaker
model, through `synthesize` and `stream` (1e-6 against `infer`).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from test_torch_serving import BUCKETS, HOP, jax_pair, port_config
from torch_tts_tpu_torch.infer import serving

STREAM_ATOL = 2e-5
SAME_ATOL = 1e-6
SCALES = dict(noise_scale=0.667, length_scale=1.0, noise_scale_w=0.8)
LONG = ("Speech synthesis is neat. It turns text into audio, one sentence at a time; "
        "long texts are split at their sentences, then at their clauses. "
        "Each piece fits the largest bucket, and the audio is joined in order.")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist a thread
    per core in every worker oversubscribes the cores, which slowed the
    port's tests about twofold and took CPU from the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    jcfg, params, cfg, sd = jax_pair()
    return dict(jcfg=jcfg, params=params, cfg=cfg, sd=sd)


def synth(weights, **kw):
    return serving.Synthesizer(weights["cfg"], weights["sd"], buckets=BUCKETS, device="cpu",
                               transfer_dtype="float32", **kw)


@pytest.fixture(scope="module")
def ms_synth():
    from torch_tts_tpu_torch.models.vits2 import build_synthesizer
    from torch_tts_tpu_torch.text import symbols

    cfg = port_config(n_speakers=4, gin_channels=8)
    model = build_synthesizer(cfg, len(symbols), seed=2, device="cpu")
    return serving.Synthesizer(cfg, model, buckets=BUCKETS, device="cpu",
                               transfer_dtype="float32")


@pytest.mark.parametrize("chunk,context", [(16, 16), (64, 32)], ids=["windows", "one_window"])
def test_stream_matches_synthesize(weights, chunk, context):
    s = synth(weights)
    text = "a longer sentence here."
    whole = s.synthesize([text], seed=21, **SCALES)[0].audio
    pieces = list(s.stream(text, chunk_frames=chunk, context_frames=context, seed=21, **SCALES))
    n_frames = len(whole) // HOP
    assert n_frames > 2 * chunk or chunk + 2 * context >= BUCKETS[1][1]
    assert len(pieces) == (-(-n_frames // chunk) if chunk + 2 * context < BUCKETS[1][1] else 1)
    np.testing.assert_allclose(np.concatenate(pieces), whole, rtol=0, atol=STREAM_ATOL)


def test_synthesize_long_is_its_pieces_and_pauses(weights):
    s = synth(weights)
    chunks = s._long_chunks(LONG)
    assert len(chunks) > 1 and all(len(s.encode_text(c)) <= BUCKETS[-1][0] for c in chunks)
    pieces = s.synthesize(chunks, seed=5, **SCALES)
    r = s.synthesize_long(LONG, pause_ms=50.0, seed=5, **SCALES)
    pause = int(8000 * 50 / 1000)
    assert len(r.audio) == sum(len(p.audio) for p in pieces) + pause * (len(chunks) - 1)
    np.testing.assert_array_equal(r.audio[:len(pieces[0].audio)], pieces[0].audio)
    np.testing.assert_array_equal(r.audio[len(pieces[0].audio):][:pause], 0)
    with pytest.raises(ValueError, match="too long to split"):
        s.synthesize_long("x" * 200)


def test_stream_long_equals_the_streams_of_its_pieces(weights):
    s = synth(weights)
    out = list(s.stream_long(LONG, pause_ms=25.0, seed=5, chunk_frames=16, context_frames=16,
                             **SCALES))
    want = []
    for i, chunk in enumerate(s._long_chunks(LONG)):
        if i:
            want.append(np.zeros(200, np.float32))
        want.extend(s.stream(chunk, seed=5, chunk_frames=16, context_frames=16, **SCALES))
    assert len(out) == len(want)
    for a, b in zip(out, want):
        np.testing.assert_array_equal(a, b)


def test_warmup_runs_the_grid(weights):
    s = synth(weights)
    assert s.warmup() == len(BUCKETS) * 3
    assert s.shapes_run == {(t, p, f) for p, f in BUCKETS for t in (1, 2, 8)}
    assert s.warmup_streaming(chunk_frames=16, context_frames=16) == len(BUCKETS)
    assert set(s._decoders) == {(16, 16)}


def write_config(path, cfg):
    path.write_text(json.dumps({"model": dataclasses.asdict(cfg.model),
                                "data": {**dataclasses.asdict(cfg.data),
                                         **dataclasses.asdict(cfg.audio)}}))
    return str(path)


def test_from_run_dir_takes_a_reference_pth(weights, tmp_path):
    """A reference-format G_*.pth as the JAX exporter writes it."""
    from torch_tts_tpu.models.vits2.convert import export_torch_state_dict

    sd = {k: torch.from_numpy(np.array(v))
          for k, v in export_torch_state_dict(weights["params"], weights["jcfg"].model).items()}
    torch.save({"model": sd, "iteration": 7}, tmp_path / "G_7.pth")
    cfg_path = write_config(tmp_path / "config.json", weights["cfg"])
    s = serving.Synthesizer.from_run_dir(cfg_path, str(tmp_path / "G_7.pth"), buckets=BUCKETS,
                                         device="cpu", transfer_dtype="float32")
    got = s.synthesize(["hello there"], seed=1, **SCALES)[0].audio
    np.testing.assert_array_equal(got, synth(weights).synthesize(["hello there"], seed=1,
                                                                 **SCALES)[0].audio)


def test_from_run_dir_averages_the_last_checkpoints(weights, tmp_path):
    cfg_path = write_config(tmp_path / "config.json", weights["cfg"])
    run = tmp_path / "run"
    run.mkdir()
    sds = []
    for step, scale in ((10, 1.0), (20, 0.5), (30, 1.5)):
        sd = {k: v * scale if v.is_floating_point() else v for k, v in weights["sd"].items()}
        torch.save({"step": step, "model": sd}, run / f"ckpt_{step}.pt")
        sds.append(sd)
    last = serving.Synthesizer.from_run_dir(cfg_path, str(run), device="cpu")
    avg = serving.Synthesizer.from_run_dir(cfg_path, str(run), average_last=2, device="cpu")
    for k, v in last.model.state_dict().items():
        assert torch.equal(v, sds[2][k])
        want = ((sds[1][k].double() + sds[2][k].double()) / 2).to(v.dtype)
        assert torch.equal(avg.model.state_dict()[k], want if v.is_floating_point() else v)
    (tmp_path / "empty").mkdir()
    assert serving.load_generator_state(str(tmp_path / "empty")) is None


def test_synthesize_with_speaker_ids(ms_synth):
    s = ms_synth
    texts = ["hello there", "a longer sentence here."]
    out = s.synthesize(texts, sid=[1, 3], seed=4, **SCALES)
    other = s.synthesize(texts, sid=[2, 3], seed=4, **SCALES)
    assert not np.array_equal(out[0].audio[:len(other[0].audio)],
                              other[0].audio[:len(out[0].audio)])
    np.testing.assert_array_equal(out[1].audio, other[1].audio)  # rows are independent
    x = torch.zeros(2, 80, dtype=torch.int64)
    for i, t in enumerate(texts):
        e = s.encode_text(t)
        x[i, :len(e)] = torch.tensor(e)
    audio, _, _, _, yl = s.model.infer(
        x, torch.tensor([len(s.encode_text(t)) for t in texts]), sid=torch.tensor([1, 3]),
        max_frames=96, generator=torch.Generator().manual_seed(4), **SCALES)
    for i, r in enumerate(out):
        np.testing.assert_allclose(r.audio, audio[i, :int(yl[i]) * HOP, 0].numpy(), rtol=0,
                                   atol=SAME_ATOL)


def test_stream_with_a_speaker_id(ms_synth):
    text = "a longer sentence here."
    whole = ms_synth.synthesize([text], sid=[2], seed=8, **SCALES)[0].audio
    pieces = ms_synth.stream(text, sid=2, seed=8, chunk_frames=16, context_frames=16, **SCALES)
    np.testing.assert_allclose(np.concatenate(list(pieces)), whole, rtol=0, atol=STREAM_ATOL)
