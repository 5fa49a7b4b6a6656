"""`ContinuousBatcher` (`infer/serving.py`) on the port, with the tiny model
and buckets of tests/test_torch_serving.py.

Held: every future resolves to the audio of a serial `synthesize` of the
same text at zero noise scales (which makes a request's audio independent
of the group it rides in; 1e-6); 32 requests from 8 submitting threads;
requests of other scales, or with and without a speaker id, never share a
group (groups counted with the worker started after the submits, so one
drain sees them all); a request that fails (a text over the largest
bucket, a dispatch that raises, a collect that raises) resolves its own
future with the error and the loop serves the next one; `stats()` adds up.
"""

import threading

import numpy as np
import pytest
import torch

from test_torch_serving import BUCKETS, jax_pair, port_config
from torch_tts_tpu_torch.infer import serving

SAME_ATOL = 1e-6
ZERO = dict(noise_scale=0.0, noise_scale_w=0.0)
TEXTS = ["hi", "hello there", "a longer sentence here.", "ok", "six", "and a third one"]


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
def synth():
    _, _, cfg, sd = jax_pair()
    return serving.Synthesizer(cfg, sd, buckets=BUCKETS, device="cpu", transfer_dtype="float32")


@pytest.fixture(scope="module")
def serial(synth):
    return {t: synth.synthesize([t], **ZERO)[0].audio for t in TEXTS}


def check(results, texts, serial):
    for r, t in zip(results, texts):
        assert r.audio.shape == serial[t].shape
        np.testing.assert_allclose(r.audio, serial[t], rtol=0, atol=SAME_ATOL)


def test_basic_use(synth, serial):
    with serving.ContinuousBatcher(synth) as b:
        futs = [b.submit(t, **ZERO) for t in TEXTS]
        check([f.result(timeout=120) for f in futs], TEXTS, serial)
        s = b.stats()
    assert s["requests_total"] == s["batched_requests_total"] == len(TEXTS)
    assert s["failures_total"] == s["fetch_timeouts_total"] == s["queue_depth"] == 0


def test_concurrent_submitters(synth, serial):
    futs, lock = [], threading.Lock()

    def submitter(k):
        for j in range(4):
            t = TEXTS[(k + j) % len(TEXTS)]
            f = b.submit(t, seed=k, **ZERO)
            with lock:
                futs.append((t, f))

    with serving.ContinuousBatcher(synth) as b:
        threads = [threading.Thread(target=submitter, args=(k,)) for k in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        check([f.result(timeout=120) for _, f in futs], [t for t, _ in futs], serial)
        s = b.stats()
    assert len(futs) == 32 == s["batched_requests_total"] == s["requests_total"]
    assert s["failures_total"] == 0 and s["batches_total"] <= 32


def groups_of(synth, requests):
    """Submit with the worker stopped, start it (one drain takes every
    request), and return (results, stats)."""
    b = serving.ContinuousBatcher(synth, autostart=False)
    futs = [b.submit(t, **kw) for t, kw in requests]
    b.start()
    try:
        return [f.result(timeout=120) for f in futs], b.stats()
    finally:
        b.close()


def test_mixed_scales_do_not_merge(synth, serial):
    reqs = [("hi", ZERO), ("ok", ZERO), ("six", dict(ZERO, length_scale=1.5)),
            ("hello there", ZERO)]
    out, s = groups_of(synth, reqs)
    assert s["batches_total"] == 3  # (bucket 16, scales 1), (16, scales 2), (80, scales 1)
    check([out[i] for i in (0, 1, 3)], ["hi", "ok", "hello there"], serial)
    assert len(out[2].audio) != len(serial["six"]) or not np.array_equal(out[2].audio,
                                                                          serial["six"])


def test_speaker_and_no_speaker_requests_do_not_merge():
    from torch_tts_tpu_torch.models.vits2 import build_synthesizer
    from torch_tts_tpu_torch.text import symbols

    cfg = port_config(n_speakers=4, gin_channels=8)
    ms = serving.Synthesizer(cfg, build_synthesizer(cfg, len(symbols), seed=2, device="cpu"),
                             buckets=BUCKETS, device="cpu", transfer_dtype="float32")
    reqs = [("hi", dict(ZERO, sid=1)), ("ok", ZERO), ("six", dict(ZERO, sid=3)), ("hm", ZERO)]
    out, s = groups_of(ms, reqs)
    assert s["batches_total"] == 2 and s["batched_requests_total"] == 4
    want = ms.synthesize(["hi", "six"], sid=[1, 3], **ZERO)
    for r, w in zip((out[0], out[2]), want):
        np.testing.assert_allclose(r.audio, w.audio, rtol=0, atol=SAME_ATOL)


def test_a_failing_request_leaves_the_loop_alive(synth, serial, monkeypatch):
    real_dispatch, real_collect = synth._dispatch_group, synth._collect_group

    def dispatch(encoded, scales, seed, **kw):
        if seed == 666:
            raise RuntimeError("dispatch failed")
        return dict(real_dispatch(encoded, scales, seed, **kw), seed=seed)

    def collect(h):
        if h["seed"] == 777:
            raise RuntimeError("collect failed")
        return real_collect(h)

    monkeypatch.setattr(synth, "_dispatch_group", dispatch)
    monkeypatch.setattr(synth, "_collect_group", collect)
    with serving.ContinuousBatcher(synth) as b:
        too_long = b.submit("x " * 200, **ZERO)
        with pytest.raises(ValueError, match="too long"):
            too_long.result(timeout=120)
        for seed, match in ((666, "dispatch failed"), (777, "collect failed")):
            with pytest.raises(RuntimeError, match=match):
                b.submit("hi", seed=seed, **ZERO).result(timeout=120)
        check([b.submit("hello there", **ZERO).result(timeout=120)], ["hello there"], serial)
        s = b.stats()
    assert s["requests_total"] == 4 and s["failures_total"] == 3
    # the over-long text never reached a group
    assert s["batched_requests_total"] == 3 and s["batches_total"] == 3


def test_stats_add_up(synth):
    with serving.ContinuousBatcher(synth) as b:
        futs = [b.submit(t, **ZERO) for t in TEXTS * 2]
        for f in futs:
            f.result(timeout=120)
        s = b.stats()
    assert set(s) == {"requests_total", "failures_total", "fetch_timeouts_total",
                      "batches_total", "batched_requests_total", "dispatch_ms_sum",
                      "queue_depth"}
    assert s["requests_total"] == s["batched_requests_total"] == 12
    assert 2 <= s["batches_total"] <= 12 and s["dispatch_ms_sum"] > 0
