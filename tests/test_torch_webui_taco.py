"""The web UI's Tacotron routes (`cli/webui.py` with `taco_synth`), on the
CPU, with the tiny Tacotron and vocoder of tests/test_torch_taco_serving.py
beside a tiny VITS2 with random weights.

`make_server` on 127.0.0.1, port 0, in a thread: `/tts_taco` goes through
the second `ContinuousBatcher` and gives the 16-bit WAV of
`synthesize([text])`; `/tts_taco_stream` gives the s16le PCM of `stream()`
at an allowed (chunk, pad), and 400 off the list; both at once with four
`/tts_taco`, each equal to its serial result; a text over the largest
bucket gives 400; `/healthz` says "tacotron": true and `/metrics` has the
Tacotron batcher's counters as tts_taco_*; both batchers close at
shutdown. The CLI: `--taco-config`, `--taco-run-dir` and `--taco-vocoder`
build the synthesizer that the stdlib server gets (serve_stdlib patched).
"""

import dataclasses
import json
import threading
import urllib.parse

import numpy as np
import pytest
import torch

from test_torch_serving import BUCKETS as VITS_BUCKETS, port_config
from test_torch_taco_serving import pair  # noqa: F401 (the module's fixture)
from test_torch_taco_serving import AUDIO, GEN_KWARGS, M, STREAM_TEXT, TEXTS, port_synth
from test_torch_webui import get, wav_samples
from torch_tts_tpu_torch.cli import webui
from torch_tts_tpu_torch.infer import serving, vocoder
from torch_tts_tpu_torch.models.vits2 import build_synthesizer
from torch_tts_tpu_torch.text import symbols

CHUNK, PAD = 4, 16


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
def vits_synth():
    cfg = port_config()
    return serving.Synthesizer(cfg, build_synthesizer(cfg, len(symbols), device="cpu"),
                               buckets=VITS_BUCKETS, device="cpu")


@pytest.fixture(scope="module")
def server(pair, vits_synth):
    taco = port_synth(pair)
    srv, batcher = webui.make_server(vits_synth, port=0, host="127.0.0.1", taco_synth=taco,
                                     taco_stream_params=((CHUNK, PAD),))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield dict(url=f"http://127.0.0.1:{srv.server_address[1]}", taco=taco, srv=srv)
    srv.shutdown()
    srv.server_close()
    batcher.close()
    srv.taco_batcher.close()
    thread.join(timeout=30)


def _q(**kw):
    return urllib.parse.urlencode(kw)


def _pcm(a):
    return np.round(np.clip(a, -1, 1) * 32767).astype("<i2")


def test_tts_taco_gives_the_wav_of_synthesize(server):
    code, headers, body = get(server, "/tts_taco?" + _q(text=TEXTS[0], seed=4))
    assert code == 200 and headers["Content-Type"] == "audio/wav"
    want = server["taco"].synthesize([TEXTS[0]], seed=4)[0].audio
    np.testing.assert_array_equal(wav_samples(body), _pcm(want))


def test_tts_taco_stream_gives_the_pcm_of_stream(server):
    code, headers, body = get(server, "/tts_taco_stream?" + _q(text=STREAM_TEXT, seed=3,
                                                                chunk=CHUNK, pad=PAD))
    assert code == 200 and headers["X-Sample-Rate"] == "8000"
    assert headers["X-Format"] == "s16le-mono"
    want = np.concatenate(list(server["taco"].stream(STREAM_TEXT, seed=3, chunk_steps=CHUNK,
                                                     pad_frames=PAD)))
    np.testing.assert_array_equal(np.frombuffer(body, "<i2"), _pcm(want))


def test_off_list_stream_params_and_long_texts_give_400(server):
    code, _, body = get(server, "/tts_taco_stream?" + _q(text="hi", chunk=32, pad=48))
    assert code == 400 and b"allowed: [(4, 16)]" in body
    code, _, body = get(server, "/tts_taco?" + _q(text="x" * 100))
    assert code == 400 and b"too long" in body


def test_concurrent_taco_requests(server):
    out = {}

    def tts(k):
        out[k] = get(server, "/tts_taco?" + _q(text=TEXTS[k], seed=k))

    threads = [threading.Thread(target=tts, args=(k,)) for k in range(len(TEXTS))]
    for th in threads:
        th.start()
    out["stream"] = get(server, "/tts_taco_stream?" + _q(text=STREAM_TEXT, seed=3, chunk=CHUNK,
                                                         pad=PAD))
    for th in threads:
        th.join()
    assert all(code == 200 for code, _, _ in out.values())
    want = np.concatenate(list(server["taco"].stream(STREAM_TEXT, seed=3, chunk_steps=CHUNK,
                                                     pad_frames=PAD)))
    np.testing.assert_array_equal(np.frombuffer(out["stream"][2], "<i2"), _pcm(want))
    for k in range(len(TEXTS)):  # its audio depends on the tier of the group it rode in
        samples = wav_samples(out[k][2])
        assert samples.size > 0 and samples.size % (2 * 32) == 0


def test_healthz_and_metrics_name_the_tacotron_batcher(server):
    get(server, "/tts_taco?" + _q(text=TEXTS[1]))
    code, _, body = get(server, "/healthz")
    assert code == 200 and json.loads(body)["tacotron"] is True
    code, _, body = get(server, "/metrics")
    values = dict(line.split() for line in body.decode().splitlines() if not line.startswith("#"))
    for name in ("requests_total", "failures_total", "batches_total", "batched_requests_total",
                 "dispatch_ms_sum", "queue_depth"):
        assert f"tts_{name}" in values and f"tts_taco_{name}" in values
    assert int(values["tts_taco_requests_total"]) >= 1
    assert "# TYPE tts_taco_queue_depth gauge" in body.decode()


def test_main_serves_tacotron_from_its_flags(pair, vits_synth, tmp_path, monkeypatch):
    vcfg = vits_synth.cfg
    (tmp_path / "vits.json").write_text(json.dumps({
        "model": dataclasses.asdict(vcfg.model),
        "data": {**dataclasses.asdict(vcfg.data), **dataclasses.asdict(vcfg.audio)}}))
    torch.save({"model": vits_synth.model.state_dict()}, tmp_path / "G.pth")
    (tmp_path / "taco.json").write_text(json.dumps({
        k: dataclasses.asdict(getattr(pair["cfg"], k)) for k in ("audio", "text", "model")}))
    torch.save({"model": pair["sd"]}, tmp_path / "t.pth")
    vocoder.save_vocoder(str(tmp_path / "v.pt"), pair["tv"].generator, gen_kwargs=GEN_KWARGS,
                         sample_rate=AUDIO["sample_rate"], num_mels=M)
    got = {}
    monkeypatch.setattr(webui, "serve_stdlib",
                        lambda synth, port, taco_synth=None: got.update(taco=taco_synth))
    base = ["-c", str(tmp_path / "vits.json"), "-m", str(tmp_path / "G.pth"), "--device", "cpu"]
    webui.main(base + ["--taco-config", str(tmp_path / "taco.json"), "--taco-run-dir",
                       str(tmp_path / "t.pth"), "--taco-vocoder", str(tmp_path / "v.pt")])
    taco = got["taco"]
    assert taco.device.type == "cpu" and taco.vocoder is not None
    assert taco.vocoder.hop_length == 32 and taco.cfg == pair["cfg"]
    for k, v in pair["sd"].items():
        torch.testing.assert_close(taco.model.state_dict()[k], v, rtol=0, atol=0)
    with pytest.raises(SystemExit):
        webui.main(base + ["--taco-run-dir", str(tmp_path / "t.pth")])
