"""The VITS2 trainer path of the port (torch_tts_tpu_torch): checkpoints,
the trainer and the train CLI, on the CPU (the data path against the JAX
package: tests/test_torch_vits2_data.py).

- Checkpoints: keep-last-N with a numeric sort, the lenient restore (a
  missing key and a shape mismatch keep the init), the background
  writer's file equal to the synchronous one's, a save followed by an
  in-place update storing the values from before the update, averaging.
- The trainer at a tiny config (dropout on, so every step draws from its
  generator), with a narrow MPD (the full one's 47M parameters make each
  CPU step seconds of optimizer work): two epochs straight end with the
  same parameters and optimizer state, bit for bit, as one epoch and a
  fresh trainer resumed for the second; a mid-epoch checkpoint rounds the
  step down; a window of non-finite steps saves and raises.
- `cli.vits2_train.main(..., "--device", "cpu")` writes the config copy,
  a checkpoint and scalars through an injected recorder.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from torch import nn

from test_torch_vits2_data import AUDIO_KW, DATA_KW, HOP, make_corpus
from torch_tts_tpu_torch.core.config import (AudioConfig, DataConfig, VITS2Config,
                                             VITS2ModelConfig, VITS2TrainConfig)
from torch_tts_tpu_torch.data import dataset, sampler
from torch_tts_tpu_torch.models.vits2.discriminators import (DiscriminatorP, DiscriminatorS,
                                                             MultiPeriodDiscriminator)
from torch_tts_tpu_torch.ops.layers import Conv2d, init_params_
from torch_tts_tpu_torch.train import async_checkpoint, checkpoint, vits2_train, vits2_trainer
from torch_tts_tpu_torch.utils import logging_utils as lu


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist a thread
    per core in every worker oversubscribes the cores, which slowed the
    port's tests about twofold and took CPU from the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- checkpoints


def tiny_cfg(**train_kw):
    model = VITS2ModelConfig(
        inter_channels=8, hidden_channels=8, filter_channels=16, n_heads=2, n_layers=1,
        kernel_size=3, p_dropout=0.1, resblock_kernel_sizes=(3,),
        resblock_dilation_sizes=((1, 3),), upsample_rates=(8, 8), upsample_initial_channel=16,
        upsample_kernel_sizes=(16, 16), segment_size=4 * HOP, posterior_wn_layers=2,
        flow_n_flows=2)
    train = VITS2TrainConfig(**{**dict(batch_size=2, log_interval=2, eval_interval=4,
                                       epochs=1), **train_kw})
    return VITS2Config(audio=AudioConfig(**AUDIO_KW), model=model, train=train,
                       data=DataConfig(**DATA_KW, max_text_len=40))


class _NarrowP(DiscriminatorP):
    """DiscriminatorP's layers at widths 4 and 8."""

    def __init__(self, period):
        nn.Module.__init__(self)
        self.period = period
        chans = (1, 4, 8, 8, 8, 8)
        self.convs = nn.ModuleList(
            Conv2d(cin, cout, (5, 1), (3 if i < 4 else 1, 1), (2, 0))
            for i, (cin, cout) in enumerate(zip(chans[:-1], chans[1:])))
        self.conv_post = Conv2d(chans[-1], 1, (3, 1), (1, 1), (1, 0))


class _NarrowS(DiscriminatorS):
    SPECS = ((4, 15, 1, 7, 1), (8, 41, 4, 20, 4), (8, 41, 4, 20, 8), (8, 5, 1, 2, 1))


def narrow_mpd(cfg, seed=1, device="cpu"):
    mpd = MultiPeriodDiscriminator(periods=(2,))
    mpd.discriminators = nn.ModuleList([_NarrowS(), _NarrowP(2)])
    init_params_(mpd, torch.Generator().manual_seed(seed))
    return mpd.to(device)


@pytest.fixture
def narrow(monkeypatch):
    monkeypatch.setattr(vits2_trainer, "build_mpd", narrow_mpd)


def tiny_state(seed=0, dur_disc=False):
    cfg = tiny_cfg()
    if dur_disc:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, use_duration_discriminator=True, duration_discriminator_type="dur_disc_2"))
    model = vits2_trainer.build_synthesizer(cfg, 20, seed=seed, device="cpu")
    return vits2_train.create_train_state(cfg, model, narrow_mpd(cfg, seed + 1),
                                          dur_disc=vits2_train.build_dur_disc(cfg, seed + 2,
                                                                              device="cpu"))


def _tensors(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _tensors(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def assert_trees_equal(a, b):
    ta, tb = dict(_tensors(a)), dict(_tensors(b))
    assert ta.keys() == tb.keys()
    for k in ta:
        if isinstance(ta[k], torch.Tensor):
            assert torch.equal(ta[k], tb[k]), k
        else:
            assert ta[k] == tb[k], k


def test_checkpoints_keep_the_last_n_in_step_order(tmp_path):
    state = tiny_state()
    for step in (2, 10, 9, 100, 1):
        checkpoint.save_checkpoint(str(tmp_path), step, state, keep=3)
    # after 100, {9, 10, 100} are the last three; then 1 joins, and the
    # smallest of {1, 9, 10, 100} goes
    names = [os.path.basename(p) for p in checkpoint.list_checkpoints(str(tmp_path))]
    assert names == ["ckpt_9.pt", "ckpt_10.pt", "ckpt_100.pt"]
    assert checkpoint.latest_checkpoint(str(tmp_path)).endswith("ckpt_100.pt")
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path))
    raw = torch.load(checkpoint.latest_checkpoint(str(tmp_path)), weights_only=True)
    assert set(raw) == {"step", "model", "mpd", "opt_g", "opt_d"}


def test_lenient_restore_keeps_init_for_missing_and_misshapen(tmp_path):
    src, dst = tiny_state(seed=0, dur_disc=True), tiny_state(seed=5, dur_disc=True)
    src.step, src.opt_g.count = 7, 3
    src.opt_g.mu[0].fill_(0.5)
    path = checkpoint.save_checkpoint(str(tmp_path), 7, src)
    raw = torch.load(path, weights_only=True)
    del raw["model"]["enc_p.proj.weight"]
    raw["mpd"]["discriminators.1.conv_post.bias"] = torch.zeros(3)
    del raw["dur_disc"]
    torch.save(raw, path)
    keep = {k: v.clone() for k, v in dst.model.state_dict().items()}
    keep_mpd = dst.mpd.state_dict()["discriminators.1.conv_post.bias"].clone()
    keep_dur = [p.clone() for p in dst.dur_disc.parameters()]
    checkpoint.restore_checkpoint(path, dst)
    assert dst.step == 7 and dst.opt_g.count == 3 and torch.equal(dst.opt_g.mu[0], src.opt_g.mu[0])
    src_sd = src.model.state_dict()
    for k, v in dst.model.state_dict().items():
        want = keep[k] if k == "enc_p.proj.weight" else src_sd[k]
        assert torch.equal(v, want), k
    assert torch.equal(dst.mpd.state_dict()["discriminators.1.conv_post.bias"], keep_mpd)
    assert torch.equal(dst.mpd.discriminators[0].conv_post.weight_v,
                       src.mpd.discriminators[0].conv_post.weight_v)
    assert all(torch.equal(a, b) for a, b in zip(dst.dur_disc.parameters(), keep_dur))
    with pytest.raises(RuntimeError, match="enc_p.proj.weight"):
        checkpoint.restore_checkpoint(path, tiny_state(dur_disc=True), lenient=False)


def test_thread_checkpoint_equals_sync_and_snapshots_before_update(tmp_path):
    state = tiny_state(dur_disc=True)
    state.step = 4
    sync = checkpoint.save_checkpoint(str(tmp_path / "sync"), 4, state)
    before = checkpoint.state_tree(state, copy=True)
    ck = async_checkpoint.AsyncCheckpointer("thread")
    ck.save(str(tmp_path / "thread"), 4, state)
    with torch.no_grad():  # the next step's in-place updates, at once
        for p in list(state.model.parameters()) + state.opt_d.mu:
            p.add_(1.0)
    state.step = 5
    ck.wait()
    ck.close()
    got = checkpoint.load_file(checkpoint.latest_checkpoint(str(tmp_path / "thread")))
    assert_trees_equal(got, checkpoint.load_file(sync))
    assert_trees_equal(got, before)
    assert ck.last_bytes == os.path.getsize(sync) and ck.last_copy_s > 0
    with pytest.raises(NotImplementedError):
        async_checkpoint.AsyncCheckpointer("orbax")


def test_average_checkpoints(tmp_path):
    states = [tiny_state(seed=s) for s in (0, 3)]
    paths = []
    for i, st in enumerate(states):
        st.step = i + 1
        paths.append(checkpoint.save_checkpoint(str(tmp_path), i + 1, st))
    out = checkpoint.average_checkpoints(paths, tiny_state(seed=9), subtree="model")
    sds = [s.model.state_dict() for s in states]
    for k, v in out.model.state_dict().items():
        a, b = (sd[k] for sd in sds)
        assert torch.allclose(v, ((a.double() + b.double()) / 2).float(), rtol=0, atol=0), k
    assert out.step == 2 and torch.equal(out.opt_g.mu[0], states[1].opt_g.mu[0])
    assert all(torch.equal(a, b) for a, b in zip(out.mpd.parameters(), states[1].mpd.parameters()))


# ---------------------------------------------------------------- trainer


def _trainer(cfg, run, ds, **kw):
    return vits2_trainer.VITS2Trainer(cfg, str(run), ds, bucket_boundaries=[4, 48],
                                      pad_text_to=48, make_writer=lu.Recorder, device="cpu",
                                      **kw)


def _train_ds(tmp_path, cfg):
    root = make_corpus(tmp_path / "ds", n=8)
    return dataset.TextAudioDataset.from_ljspeech(root, cfg.audio, cfg.data)


def test_trainer_resume_is_bit_identical(tmp_path, narrow):
    cfg = tiny_cfg()
    ds = _train_ds(tmp_path, cfg)
    spe = len(sampler.DistributedBucketSampler(ds.lengths, 2, [4, 48]))
    assert spe == 4
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, eval_interval=spe))
    straight = _trainer(cfg, tmp_path / "a", ds, eval_dataset=ds, eval_max_frames=32)
    straight.train(epochs=2)
    assert straight.state.step == 2 * spe
    rec = straight.writer
    assert [s for s, _ in rec.scalars["loss/g/total"]] == [2, 4, 6, 8]
    # host times as the log windows' means (every batch pads to 48 frames)
    assert {k for k in rec.scalars if k.startswith("perf/")} == {
        "perf/steps_per_s", "perf/nonfinite_skipped", "perf/load_ms", "perf/step_ms/48"}
    assert [s for s, _ in rec.scalars["perf/step_ms/48"]] == [2, 4, 6, 8]
    assert all(v > 0 for k in ("perf/load_ms", "perf/step_ms/48") for _, v in rec.scalars[k])
    assert all(np.isfinite(v) for vals in rec.scalars.values() for _, v in vals)
    assert straight.writer_eval.scalars["eval/loss_mel"][0][0] == spe
    assert straight.writer_eval.images["gen/attn_0"][0][1].dtype == np.uint8
    first = _trainer(cfg, tmp_path / "b", ds)
    first.train(epochs=1)
    saved = checkpoint.load_file(checkpoint.latest_checkpoint(str(tmp_path / "b")))
    resumed = _trainer(cfg, tmp_path / "b", ds)
    assert resumed.state.step == spe
    assert_trees_equal(checkpoint.state_tree(resumed.state), saved)
    resumed.train(epochs=2)
    assert_trees_equal(checkpoint.state_tree(resumed.state),
                       checkpoint.state_tree(straight.state))


def test_trainer_mid_epoch_checkpoint_rounds_step_down(tmp_path, narrow):
    cfg = tiny_cfg(eval_interval=3)
    ds = _train_ds(tmp_path, cfg)
    _trainer(cfg, tmp_path / "run", ds).train(epochs=1)  # saves at step 3 of 4
    t = _trainer(cfg, tmp_path / "run", ds)
    assert t.state.step == 3
    t.train(epochs=1)  # replays epoch 1 with its own step numbers
    assert t.state.step == 4


def test_trainer_raises_after_a_window_of_nonfinite_steps(tmp_path, narrow, monkeypatch):
    cfg = tiny_cfg(log_interval=2, eval_interval=100)
    ds = _train_ds(tmp_path, cfg)
    t = _trainer(cfg, tmp_path / "run", ds)
    make = t._make_batch

    def poisoned(pad_frames, idxs):
        b = make(pad_frames, idxs)
        b["wav"][:] = float("nan")
        return b

    monkeypatch.setattr(t, "_make_batch", poisoned)
    params = [p.clone() for p in t.model.parameters()]
    with pytest.raises(FloatingPointError):
        t.train(epochs=1)
    assert t.state.step == 0 and all(torch.equal(a, b) for a, b in zip(params,
                                                                       t.model.parameters()))
    assert checkpoint.latest_checkpoint(str(tmp_path / "run")).endswith("ckpt_2.pt")
    with pytest.raises(NotImplementedError):
        _trainer(cfg, tmp_path / "x", ds, use_native_loader=True)


# ---------------------------------------------------------------- CLI and logging


def test_cli_trains_on_cpu_through_an_injected_recorder(tmp_path, monkeypatch):
    from torch_tts_tpu_torch.cli import vits2_train as cli

    monkeypatch.setattr(vits2_trainer, "build_mpd", narrow_mpd)
    root = make_corpus(tmp_path / "ds", n=10, frames=(34, 38))  # the (32, 300] bucket
    cfg = tiny_cfg()
    raw = {"model": dataclasses.asdict(cfg.model), "data": {**DATA_KW, **AUDIO_KW},
           "train": {"batch_size": 4, "log_interval": 1, "eval_interval": 3}}
    cfg_path = tmp_path / "c.json"
    cfg_path.write_text(json.dumps(raw))
    writers = {}

    def recorder(log_dir):
        writers[log_dir] = lu.Recorder(log_dir)
        return writers[log_dir]

    run = tmp_path / "run"
    trainer = cli.main(["-c", str(cfg_path), "-m", str(run), "--data-root", root, "--epochs", "1",
                        "--device", "cpu"], make_writer=recorder)
    assert (run / "config.json").read_text() == cfg_path.read_text()
    assert len(trainer.eval_dataset) == 1 and len(trainer.train_dataset) == 9
    assert trainer.steps_per_epoch == 3 and trainer.state.step == 3
    assert checkpoint.latest_checkpoint(str(run)).endswith("ckpt_3.pt")
    rec = writers[str(run)]
    assert [s for s, _ in rec.scalars["loss/g/mel"]] == [1, 2, 3]
    assert rec.scalars["perf/nonfinite_skipped"][-1][1] == 0.0
    lines = [json.loads(x) for x in (run / "scalars.jsonl").read_text().splitlines()]
    assert {"step": 3, "tag": "loss/g/mel", "value": rec.scalars["loss/g/mel"][-1][1]} in lines
    assert writers[str(run / "eval")].audios["gen/audio_0"][0][1].ndim == 1
    with pytest.raises(SystemExit):  # speaker ids past a single-speaker config
        cli.main(["-c", str(cfg_path), "-m", str(tmp_path / "r2"), "--filelist",
                  os.path.join(root, "filelist.txt"), "--device", "cpu"], make_writer=recorder)


def test_logging_utils(tmp_path, monkeypatch):
    img = lu.plot_alignment_to_numpy(np.eye(5, 3))
    assert img.shape == (3, 5, 3) and img.dtype == np.uint8
    assert tuple(img[-1, 0]) == (253, 231, 37) and tuple(img[-1, 1]) == (68, 1, 84)
    monkeypatch.setitem(__import__("sys").modules, "tensorboardX", None)
    with pytest.raises(ImportError, match="tensorboardX"):
        lu.make_writer(str(tmp_path / "tb"))
    lu.check_git_hash(str(tmp_path))
    lu.check_git_hash(str(tmp_path))
