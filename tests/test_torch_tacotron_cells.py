"""The Tacotron-2 and Tacotron-1 modules of the port (torch_tts_tpu_torch)
against the JAX package: the GRU cells, the Markov attention, the highway
layer and CBHG, the tacotron1 `Encoder`, `MelPostnet2`, one step of each
new decoder cell, whole inference per decoder type, and chunked decodes.

The "taco2" (Tacotron-2 cell, MelPostnet2) and "taco1" (CBHG encoder,
Tacotron-1 cell, MelPostnet2) variants of the tiny config of
tests/test_torch_tacotron_variants_train.py, weights and batch statistics
from a numpy seed, converted by the port's converter and loaded with
strict=True; texts ragged B=3 (11, 8, 5 ids of 11). The standalone modules
take their own seeded parameters. Every draw of the JAX functions (the
GRUs' zoneout masks, the PreNet masks) is recorded (`recorded`) and handed
to the port. One jit per JAX reference, compiled at once in threads.

Tolerances: modules and one step fp32 RTOL 1e-4 / ATOL 1e-5, the BN
statistics 1e-5; whole inference y, y_post, s and w within 1e-4 and the
stop lengths equal; the port's chunked decode equal to its whole decode
exactly, and within 1e-4 of JAX's.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax

from test_torch_tacotron_train import (ATOL, MODEL_ATOL, RTOL, STATS_ATOL, fill, make_batch,
                                       recorded)
from test_torch_tacotron_variants_train import (jax_variables, port_model, variant_cfg,
                                                variant_draws, widened)
from torch_tts_tpu.core import config as jcfg
from torch_tts_tpu.ops import rnn as jrnn
from torch_tts_tpu.ops import tacotron_attention as jatt
from torch_tts_tpu.ops import tacotron_blocks as jblocks
from torch_tts_tpu_torch.core import config as tcfg
from torch_tts_tpu_torch.ops.rnn import GRUCell, ResGRUCell
from torch_tts_tpu_torch.ops.tacotron_attention import ContentMarkovAttention
from torch_tts_tpu_torch.ops.tacotron_blocks import CBHG

B, L, STEPS, H_GRU, T_CBHG = 3, 11, 14, 32, 9
CELLS = ("taco2", "taco1")
P_ZONEOUT = 0.1


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist a thread
    per core in every worker oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.array(x))


def init_shapes(module, *args, **kw):
    return jax.eval_shape(lambda: module.init({"params": jax.random.PRNGKey(0),
                                               "dropout": jax.random.PRNGKey(1)}, *args, **kw))


def gru_state_dict(p, prefix=""):
    sd = {f"{prefix}weight_ih": t(p["w_ih"]).T, f"{prefix}weight_hh": t(p["w_hh"]).T,
          f"{prefix}bias_ih": t(p["b_ih"]), f"{prefix}bias_hh": t(p["b_hh"])}
    return {k: v.contiguous() for k, v in sd.items()}


def bn_state_dict(name, p, s):
    return {f"{name}.weight": t(p["BatchNorm_0"]["scale"]), f"{name}.bias": t(p["BatchNorm_0"]["bias"]),
            f"{name}.running_mean": t(s["BatchNorm_0"]["mean"]),
            f"{name}.running_var": t(s["BatchNorm_0"]["var"]),
            f"{name}.num_batches_tracked": torch.zeros((), dtype=torch.int64)}


def cbhg_state_dict(p, s):
    """A standalone flax CBHG's variables -> the port CBHG's state dict."""
    sd = {}
    conv = lambda w: t(w).permute(2, 1, 0).contiguous()  # noqa: E731
    lin = lambda w: t(w).T.contiguous()  # noqa: E731
    for k in range(1, 17, 2):
        sd[f"bank_{k}.weight"] = conv(p[f"bank_{k}"]["kernel"])
        sd.update(bn_state_dict(f"bank_bn_{k}", p[f"bank_bn_{k}"], s[f"bank_bn_{k}"]))
    sd["proj1.weight"] = conv(p["proj1"]["kernel"])
    sd.update(bn_state_dict("proj_bn1", p["proj_bn1"], s["proj_bn1"]))
    sd["proj2.weight"], sd["proj2.bias"] = conv(p["proj2"]["kernel"]), t(p["proj2"]["bias"])
    if "highway_in" in p:
        sd["highway_in.weight"] = lin(p["highway_in"]["kernel"])
    for i in range(4):
        for n in ("T", "H"):
            sd[f"highway.{i}.{n}.weight"] = lin(p[f"highway_{i}"][n]["kernel"])
            sd[f"highway.{i}.{n}.bias"] = t(p[f"highway_{i}"][n]["bias"])
    for d, suffix in (("gru_fwd", "_l0"), ("gru_bwd", "_l0_reverse")):
        for k, v in gru_state_dict(p[d]).items():
            sd[f"gru.{k}{suffix}"] = v
    return sd


def cmask_ragged():
    return np.arange(L)[None, :] < np.asarray([11, 8, 5])[:, None]


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(23)
    out = {}
    with ThreadPoolExecutor(4) as pool:
        # the GRU cells: training (masks recorded) and the eval blend
        x, h = rng.standard_normal((B, 10)).astype(np.float32), rng.standard_normal(
            (B, H_GRU)).astype(np.float32)
        grus = {"gru": jrnn.GRUCell(H_GRU, p_zoneout=P_ZONEOUT),
                "resgru": jrnn.ResGRUCell(H_GRU, p_zoneout=P_ZONEOUT)}
        xr = rng.standard_normal((B, H_GRU)).astype(np.float32)  # ResGRU: in = out width
        gru_p = {n: fill(init_shapes(m, h, x if n == "gru" else xr)["params"], rng)
                 for n, m in grus.items()}

        def gru_fn(p, key):
            return {n: [m.apply({"params": p[n]}, h, x if n == "gru" else xr, det,
                                rngs={"dropout": key}) for det in (False, True)]
                    for n, m in grus.items()}

        with recorded() as gru_record:
            gru_c = pool.submit(jax.jit(gru_fn).lower(gru_p, jax.random.PRNGKey(5)).compile)
        # the Markov attention on a ragged mask
        att = jatt.ContentMarkovAttention(16)
        q, mem = rng.standard_normal((B, 8)).astype(np.float32), rng.standard_normal(
            (B, L, 16)).astype(np.float32)
        w = rng.random((B, L)).astype(np.float32)
        w /= w.sum(1, keepdims=True)
        att_p = fill(init_shapes(att, q, w, mem, cmask_ragged())["params"], rng)
        att_c = pool.submit(jax.jit(lambda p: att.apply({"params": p}, q, w, mem, cmask_ragged()))
                            .lower(att_p).compile)
        # CBHG at width 128 (no highway_in) and 24 (highway_in), both BN modes
        cbhgs, cbhg_v, cbhg_x = {}, {}, {}
        for width in (128, 24):
            cbhgs[width] = jblocks.CBHG(16)
            cbhg_x[width] = rng.standard_normal((B, T_CBHG, width)).astype(np.float32)
            v = init_shapes(cbhgs[width], cbhg_x[width], train=True)
            cbhg_v[width] = {"params": fill(v["params"], rng),
                             "batch_stats": fill(v["batch_stats"], rng, stats=True)}

        def cbhg_fn(v):
            return {w: (cbhgs[w].apply(v[w], cbhg_x[w], train=True, mutable=["batch_stats"]),
                        cbhgs[w].apply(v[w], cbhg_x[w], train=False)) for w in cbhgs}

        cbhg_c = pool.submit(jax.jit(cbhg_fn).lower(cbhg_v).compile)
        # the two model variants: encoder and postnet modules, one cell step,
        # whole inference
        batch = make_batch(rng)
        kd = jax.random.PRNGKey(9)
        for name in CELLS:
            jc, tc = variant_cfg(jcfg, name), variant_cfg(tcfg, name)
            jm, variables = jax_variables(jc, batch, rng)
            y_post_in = rng.standard_normal((B, 10, 20)).astype(np.float32)

            def modules_fn(v, c, cl, jm=jm, y_post_in=y_post_in):
                enc = lambda m, train: m.encoder(c, cl, train=train)  # noqa: E731
                post = lambda m, train: m.postnet(y_post_in, train=train)  # noqa: E731
                return [jm.apply(v, train, method=f, mutable=["batch_stats"]) if train
                        else jm.apply(v, train, method=f) for f in (enc, post)
                        for train in (True, False)]

            step_in = step_inputs(name, rng)

            def step_fn(v, st, key, jm=jm, step_in=step_in):
                return jm.apply(v, st, step_in["x"], step_in["memory"], cmask_ragged(), key,
                                method=lambda m, st, x, mem, mm, k: m.decoder.cell(
                                    st, x, mem, mm, True, prenet_rng=k))

            def infer_fn(v, c, cl, jm=jm):
                return jm.apply(v, c, cl, max_steps=STEPS, dropout_key=kd)

            mod_c = pool.submit(jax.jit(modules_fn).lower(variables, batch["c"],
                                                          batch["c_lengths"]).compile)
            with recorded() as step_record:
                step_c = pool.submit(jax.jit(step_fn).lower(variables, step_in["state"],
                                                            jax.random.PRNGKey(3)).compile)
            with recorded() as infer_record:
                infer_c = pool.submit(jax.jit(infer_fn).lower(variables, batch["c"],
                                                              batch["c_lengths"]).compile)
            out[name] = dict(jc=jc, tc=tc, variables=variables, y_post_in=y_post_in,
                             step_in=step_in, step_record=step_record,
                             infer_record=infer_record, compiled=(mod_c, step_c, infer_c))
        out["gru"] = dict(p=gru_p, x=x, h=h, xr=xr, record=gru_record,
                          out=gru_c.result()(gru_p, jax.random.PRNGKey(5)))
        out["att"] = dict(p=att_p, q=q, w=w, mem=mem, out=att_c.result()(att_p))
        out["cbhg"] = dict(v=cbhg_v, x=cbhg_x, out=cbhg_c.result()(cbhg_v))
        for name in CELLS:
            s = out[name]
            mod_c, step_c, infer_c = s.pop("compiled")
            s["modules"] = mod_c.result()(s["variables"], batch["c"], batch["c_lengths"])
            s["step"] = step_c.result()(s["variables"], s["step_in"]["state"],
                                        jax.random.PRNGKey(3))
            s["infer"] = infer_c.result()(s["variables"], batch["c"], batch["c_lengths"])
        jax.effects_barrier()
    out["batch"] = batch
    return jax.tree.map(lambda a: np.asarray(a) if isinstance(a, jax.Array) else a, out)


def step_inputs(name, rng):
    """A state away from the initial one, an input frame and memory."""
    r = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    w = rng.random((B, L)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    if name == "taco2":
        state = (w, ((r(B, 16), r(B, 16)), (r(B, 16), r(B, 16))))
    else:  # dim_att 8, residual GRUs of dim_att + dim_ctx
        state = (w, r(B, 8), (r(B, 24), r(B, 24)))
    return {"state": state, "x": r(B, 1, 20), "memory": r(B, L, 16)}


@pytest.mark.parametrize("kind", ["gru", "resgru"])
def test_gru_cells_match_jax(setup, kind):
    """Training (keep-previous masks [H] shared over the batch, JAX's) and
    the eval blend p * h + (1 - p) * h_new."""
    s = setup["gru"]
    cls = GRUCell if kind == "gru" else ResGRUCell
    x = s["x"] if kind == "gru" else s["xr"]
    cell = cls(x.shape[1], H_GRU, p_zoneout=P_ZONEOUT)
    cell.load_state_dict(gru_state_dict(s["p"][kind]["gru"] if kind == "resgru" else s["p"][kind]),
                         strict=True)
    masks = [v for _, v in s["record"]]
    mask = t(masks[0 if kind == "gru" else 1]) < np.float32(P_ZONEOUT)
    assert mask.shape == (H_GRU,) and 0 < int(mask.sum()) < H_GRU
    with torch.no_grad():
        got = [cell(t(s["h"]), t(x), mask), cell(t(s["h"]), t(x))]
    for g, (want, _) in zip(got, s["out"][kind]):
        g = g if kind == "gru" else g[0]
        np.testing.assert_allclose(g.numpy(), want, rtol=RTOL, atol=ATOL)
    if kind == "resgru":  # the output is x + h_new
        np.testing.assert_allclose(cell(t(s["h"]), t(x))[1].detach().numpy(),
                                   s["out"][kind][1][1], rtol=RTOL, atol=ATOL)


def test_markov_attention_matches_jax_on_a_ragged_mask(setup):
    s = setup["att"]
    att = ContentMarkovAttention(8, 16)
    att.fc_query.weight.data = t(s["p"]["fc_query"]["kernel"]).T.contiguous()
    with torch.no_grad():
        got = att(t(s["q"]), t(s["w"]), t(s["mem"]), torch.from_numpy(cmask_ragged()))
    np.testing.assert_allclose(got.numpy(), s["out"], rtol=RTOL, atol=ATOL)
    # the roll wraps: weight reaches position 0 of a short item only from the end
    assert float(got[2, 5:7].sum()) > 0


@pytest.mark.parametrize("width", [128, 24], ids=["no_highway_in", "highway_in"])
def test_cbhg_matches_jax(setup, width):
    """Both BN modes (the batch statistics updating the running ones);
    the highway layers; the bidirectional GRU over the padded sequence."""
    s = setup["cbhg"]
    v = s["v"][width]
    cbhg = CBHG(width, 16)
    cbhg.load_state_dict(cbhg_state_dict(v["params"], v["batch_stats"]), strict=True)
    assert (cbhg.highway_in is None) == (width == 128)
    (train_out, mut), eval_out = s["out"][width]
    with torch.no_grad():
        np.testing.assert_allclose(cbhg(t(s["x"][width])).numpy(), eval_out, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(cbhg(t(s["x"][width]), batch_stats=True).numpy(), train_out,
                                   rtol=RTOL, atol=ATOL)
    want = cbhg_state_dict(v["params"], mut["batch_stats"])
    for k, val in cbhg.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(val.numpy(), want[k].numpy(), rtol=0, atol=STATS_ATOL,
                                       err_msg=k)


@pytest.mark.parametrize("module", ["encoder", "postnet"])
def test_tacotron1_encoder_and_melpostnet2_match_jax(setup, module):
    """The CBHG `Encoder` (tacotron1) and `MelPostnet2` of the taco1 model,
    in both BN modes."""
    from torch_tts_tpu_torch.models.tacotron.convert import state_dict_from_jax_params

    s = setup["taco1"]
    model = port_model(s["variables"], s["tc"])
    i = 0 if module == "encoder" else 2
    (train_out, mut), eval_out = s["modules"][i], s["modules"][i + 1]
    b = setup["batch"]
    run = ((lambda bs: model.encoder(t(b["c"]).long(), t(b["c_lengths"]).long(), bs))
           if module == "encoder" else (lambda bs: model.postnet(t(s["y_post_in"]), bs)))
    with torch.no_grad():
        np.testing.assert_allclose(run(False).numpy(), eval_out, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(run(True).numpy(), train_out, rtol=RTOL, atol=ATOL)
    stats = jax.tree.map(np.asarray, dict(s["variables"]["batch_stats"]))
    stats[module] = mut["batch_stats"][module]
    want = state_dict_from_jax_params(s["variables"]["params"], stats, s["tc"])
    names = [k for k in model.state_dict() if k.startswith(module + ".") and "running" in k]
    assert len(names) == 2 * (9 if module == "encoder" else 4)
    for k in names:
        np.testing.assert_allclose(model.state_dict()[k].numpy(), want[k], rtol=0,
                                   atol=STATS_ATOL, err_msg=k)


def port_state(name, st):
    from torch_tts_tpu_torch.models.tacotron.model import Taco1State, Taco2State

    if name == "taco2":
        return Taco2State(t(st[0]), tuple((t(h), t(c)) for h, c in st[1]))
    return Taco1State(t(st[0]), t(st[1]), tuple(t(h) for h in st[2]))


@pytest.mark.parametrize("name", CELLS)
def test_one_cell_step_matches_jax(setup, name):
    """One deterministic step of the Tacotron-2 cell (the zeros in its
    output's ctx slot) and the Tacotron-1 cell (the Markov attention on the
    memory mask) from a state away from the initial one."""
    s = setup[name]
    model = port_model(s["variables"], s["tc"])
    cell = model.decoder.decoder_cell
    W = cell.pre_net.mask_width
    masks = [widened(v, W) for _, v in s["step_record"]]
    (want_state, want_out, want_ctx) = s["step"]
    with torch.no_grad():
        state, out = cell(port_state(name, s["step_in"]["state"]), t(s["step_in"]["x"][:, 0]),
                          t(s["step_in"]["memory"]), torch.from_numpy(cmask_ragged()), masks)
    np.testing.assert_allclose(out.numpy(), want_out, rtol=RTOL, atol=ATOL)
    for g, w in zip(jax.tree.leaves(tuple(state)), jax.tree.leaves(want_state)):
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL)
    if name == "taco2":
        assert float(out[:, -16:].abs().max()) == 0.0  # the ctx slot holds zeros


def infer_masks(s, model):
    return variant_draws(s["infer_record"], model, STEPS, train=False).prenet


@pytest.mark.parametrize("name", CELLS)
def test_infer_matches_jax(setup, name):
    s = setup[name]
    model = port_model(s["variables"], s["tc"]).eval()
    b = setup["batch"]
    gy, gyp, gs, gaux = model.infer(t(b["c"]).long(), t(b["c_lengths"]).long(), STEPS,
                                    prenet_masks=infer_masks(s, model))
    y, y_post, st, aux = s["infer"]
    for k, g, want in (("y", gy, y), ("y_post", gyp, y_post), ("s", gs, st),
                       ("w", gaux["w"], aux["w"])):
        np.testing.assert_allclose(g.numpy(), want, rtol=MODEL_ATOL, atol=MODEL_ATOL, err_msg=k)
    np.testing.assert_array_equal(gaux["stop_lengths"].numpy(), aux["stop_lengths"])


@pytest.mark.parametrize("name", CELLS)
def test_decode_chunk_equals_the_whole_decode(setup, name):
    """Chunks of 4 from decode_init (the last overhanging the steps, with
    all-keep masks), each given encode's memory mask: the whole decode's
    frames and attention exactly, and JAX's decode within 1e-4."""
    s = setup[name]
    model = port_model(s["variables"], s["tc"]).eval()
    b = setup["batch"]
    c, cl = t(b["c"]).long(), t(b["c_lengths"]).long()
    masks = infer_masks(s, model)
    y, _, _, aux = model.infer(c, cl, STEPS, prenet_masks=masks)
    K, n = 4, -(-STEPS // 4) * 4
    masks = torch.cat([masks, torch.ones_like(masks[:n - STEPS])])
    mem, mmask = model.encode(c, cl)
    carry, ys, ws = model.decode_init(mem), [], []
    for t0 in range(0, n, K):
        carry, yc, _, w = model.decode_chunk(mem, carry, masks[t0:t0 + K], mmask)
        ys.append(yc)
        ws.append(w)
    got_y, got_w = torch.cat(ys, 1)[:, :STEPS * 2], torch.cat(ws, 1)[:, :STEPS]
    torch.testing.assert_close(got_y, y, rtol=0, atol=0)
    torch.testing.assert_close(got_w, aux["w"], rtol=0, atol=0)
    np.testing.assert_allclose(got_y.numpy(), s["infer"][0], rtol=MODEL_ATOL, atol=MODEL_ATOL)
