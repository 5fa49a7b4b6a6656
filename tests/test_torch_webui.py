"""The port's web UI (`cli/webui.py`) and the inference CLI's serving flags
(`cli/vits2_infer.py`), on the CPU, with the tiny model of
tests/test_torch_serving.py.

The stdlib server from `make_server` on 127.0.0.1, port 0, in a thread:
`/tts` gives a 16-bit WAV of the synthesized length; `/tts_stream` gives
chunked s16le PCM within one 16-bit step of `/tts`'s samples (the stream
and the bucketed decode agree within 2e-5 before quantization); a text
over the largest bucket takes the long-form route; an unsplittable text
and an off-list `chunk` give 400; `/tts_taco` and `/tts_taco_stream` 404;
`/healthz` and `/metrics` keep the JAX UI's names. The CLI, `--device
cpu`: `--text-file` writes one WAV a line equal to the `Synthesizer`'s
audio, `--long` equals `synthesize_long`, `--stream-chunk` equals the
whole decode within one 16-bit step; `--taco-config` without
`--taco-run-dir` exits with an error (the Tacotron routes with a model:
tests/test_torch_webui_taco.py).
"""

import dataclasses
import inspect
import io
import json
import threading
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest
import torch

from test_torch_serving import BUCKETS, jax_pair
from torch_tts_tpu_torch.cli import vits2_infer, webui
from torch_tts_tpu_torch.infer import serving

LSB = 1  # in 16-bit steps
LONG = ("Speech synthesis is neat. It turns text into audio, one sentence at a time; "
        "long texts are split at their sentences, then at their clauses. ") * 3


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
    _, _, cfg, sd = jax_pair()
    return cfg, sd


@pytest.fixture(scope="module")
def server(weights):
    cfg, sd = weights
    synth = serving.Synthesizer(cfg, sd, buckets=BUCKETS, device="cpu")
    srv, batcher = webui.make_server(synth, port=0, host="127.0.0.1", stream_chunks=(16, 64))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield dict(url=f"http://127.0.0.1:{srv.server_address[1]}", synth=synth)
    srv.shutdown()
    srv.server_close()
    batcher.close()
    thread.join(timeout=30)


def get(server, path):
    """(status, headers, body) of a GET."""
    try:
        with urllib.request.urlopen(server["url"] + path, timeout=300) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def wav_samples(body):
    with wave.open(io.BytesIO(body)) as f:
        assert (f.getnchannels(), f.getsampwidth(), f.getframerate()) == (1, 2, 8000)
        return np.frombuffer(f.readframes(f.getnframes()), "<i2")


def test_tts_gives_a_wav(server):
    code, headers, body = get(server, "/tts?text=hello%20there&seed=3")
    assert code == 200 and headers["Content-Type"] == "audio/wav"
    want = server["synth"].synthesize(["hello there"], seed=3)[0].audio
    np.testing.assert_array_equal(wav_samples(body), np.round(want * 32767).astype("<i2"))


@pytest.mark.parametrize("chunk", [16, 64])
def test_tts_stream_gives_the_pcm_of_tts(server, chunk):
    text = "a%20longer%20sentence%20here."
    code, headers, body = get(server, f"/tts_stream?text={text}&seed=5&chunk={chunk}")
    assert code == 200 and headers["X-Sample-Rate"] == "8000"
    assert headers["X-Format"] == "s16le-mono"
    pcm = np.frombuffer(body, "<i2").astype(np.int32)
    ref = wav_samples(get(server, f"/tts?text={text}&seed=5")[2]).astype(np.int32)
    assert pcm.shape == ref.shape
    assert int(np.abs(pcm - ref).max()) <= LSB


def test_long_text_takes_the_long_form_route(server):
    s = server["synth"]
    assert len(s.encode_text(LONG)) > BUCKETS[-1][0]
    code, _, body = get(server, "/tts?" + urllib.parse.urlencode({"text": LONG, "seed": 2}))
    assert code == 200
    want = s.synthesize_long(LONG, seed=2).audio
    np.testing.assert_array_equal(wav_samples(body), np.round(want * 32767).astype("<i2"))
    code, _, body = get(server, "/tts_stream?" + urllib.parse.urlencode(
        {"text": LONG, "seed": 2, "pause_ms": 10}))
    assert code == 200 and len(body) // 2 > len(want)


def test_unsplittable_text_gives_400(server):
    code, _, body = get(server, "/tts?text=" + "x" * 300)
    assert code == 400 and b"too long to split" in body
    assert get(server, "/tts_stream?text=" + "x" * 300)[0] == 400


def test_off_list_chunk_gives_400(server):
    code, _, body = get(server, "/tts_stream?text=hi&chunk=32")
    assert code == 400 and b"allowed: [16, 64]" in body


def test_tacotron_routes_give_404(server):
    for path in ("/tts_taco?text=hi", "/tts_taco_stream?text=hi"):
        code, _, body = get(server, path)
        assert code == 404 and body == b"no tacotron model loaded"


def test_healthz(server):
    get(server, "/tts?text=hi")
    code, _, body = get(server, "/healthz")
    h = json.loads(body)
    assert code == 200 and h["status"] == "ok" and h["tacotron"] is False
    assert h["buckets"] == [list(b) for b in BUCKETS] and h["batch_tiers"] == [1, 2, 8]
    assert h["compiled_executables"] == len(server["synth"].shapes_run) >= 1


def test_metrics(server):
    get(server, "/tts?text=hi")
    code, headers, body = get(server, "/metrics")
    assert code == 200 and headers["Content-Type"].startswith("text/plain")
    values = dict(line.split() for line in body.decode().splitlines()
                  if not line.startswith("#"))
    for name in ("requests_total", "failures_total", "fetch_timeouts_total", "batches_total",
                 "batched_requests_total", "dispatch_ms_sum", "queue_depth"):
        assert f"tts_{name}" in values
    assert int(values["tts_requests_total"]) >= 1 and values["tts_fetch_timeouts_total"] == "0"
    assert int(values["tts_compiled_executables"]) == len(server["synth"].shapes_run)
    assert "# TYPE tts_queue_depth gauge" in body.decode()


@pytest.fixture(scope="module")
def run_files(weights, tmp_path_factory):
    cfg, sd = weights
    d = tmp_path_factory.mktemp("cli")
    torch.save({"model": sd}, d / "G.pth")
    (d / "config.json").write_text(json.dumps({
        "model": dataclasses.asdict(cfg.model),
        "data": {**dataclasses.asdict(cfg.data), **dataclasses.asdict(cfg.audio)}}))
    synth = serving.Synthesizer(cfg, sd, device="cpu")  # the CLI's default buckets
    return dict(dir=d, args=["-c", str(d / "config.json"), "-m", str(d / "G.pth"),
                             "--device", "cpu", "--seed", "4"], synth=synth)


def read_wav(path):
    with open(path, "rb") as f:
        return wav_samples(f.read())


def test_cli_text_file(run_files):
    d, texts = run_files["dir"], ["hello there", "ok", "a longer sentence here."]
    (d / "texts.txt").write_text("\n".join(texts) + "\n\n")
    vits2_infer.main(run_files["args"] + ["--text-file", str(d / "texts.txt"),
                                          "-o", str(d / "batch.wav")])
    want = run_files["synth"].synthesize(texts, seed=4)
    for i, r in enumerate(want):
        got = read_wav(d / f"batch_{i:03d}.wav")
        np.testing.assert_array_equal(got, np.round(r.audio * 32767).astype("<i2"))


def test_cli_long(run_files):
    d = run_files["dir"]
    vits2_infer.main(run_files["args"] + ["--text", LONG, "--long", "--pause-ms", "20",
                                          "-o", str(d / "long.wav")])
    want = run_files["synth"].synthesize_long(LONG, pause_ms=20, seed=4).audio
    np.testing.assert_array_equal(read_wav(d / "long.wav"),
                                  (np.clip(want, -1, 1) * 32767).astype("<i2"))


def test_cli_stream_chunk(run_files, capsys):
    d, text = run_files["dir"], "a longer sentence here, with a clause."
    common = run_files["args"] + ["--text", text, "--max-frames", "300"]
    whole = vits2_infer.main(common + ["-o", str(d / "whole.wav")])
    streamed = vits2_infer.main(common + ["--stream-chunk", "16", "-o", str(d / "stream.wav")])
    assert "chunk 1:" in capsys.readouterr().out
    assert streamed.shape == whole.shape and len(whole) > 16 * 64
    np.testing.assert_allclose(streamed, whole, rtol=0, atol=2e-5)
    a, b = read_wav(d / "whole.wav").astype(int), read_wav(d / "stream.wav").astype(int)
    assert int(np.abs(a - b).max()) <= LSB


def test_webui_main_refuses_tacotron_and_defaults_to_the_card(weights, capsys):
    assert 'default="cuda"' in inspect.getsource(webui.main)
    with pytest.raises(SystemExit):  # a Tacotron model needs its config and its weights
        webui.main(["-c", "c.json", "-m", "run", "--taco-config", "t.json"])
    assert "--taco-config and --taco-run-dir must be given together" in capsys.readouterr().err
