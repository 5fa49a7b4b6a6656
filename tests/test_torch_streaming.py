"""The streaming decoders (`infer/streaming.py`): the port against the JAX
package's, and against the port's own whole decode.

The tiny plain-coupling model of tests/test_torch_vits2_plain_flows.py
(`plain_pair`: the JAX model and the port's on the same converted
weights), and a tiny multi-speaker port model for the decoder's g. Latents
are seeded from numpy, channels-last [B, T, C] as in the JAX API, two rows
of lengths T and a shorter one.

Compared: `StreamingDecoder` and `StreamingFlowDecoder` against their JAX
counterparts (one jitted window each) within 1e-4; the port's stream,
concatenated, against its own whole masked decode within 2e-5, with T
below one window (decoded at once) and above it, with and without g; the
flow decoder against its whole flow reverse and decode within 2e-5; windows
decoded unmasked where the host's lengths allow give the same values as
the all-masked stream (exactly, on the plain path); the window arithmetic;
the rejection of transformer flows.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_vits2_infer import CFG_KW, N_VOCAB, SPEC_CH
from test_torch_vits2_plain_flows import plain_pair
from torch_tts_tpu_torch.core.config import VITS2ModelConfig
from torch_tts_tpu_torch.infer.streaming import StreamingDecoder, StreamingFlowDecoder, windows
from torch_tts_tpu_torch.models.vits2.model import SynthesizerTrn

JAX_ATOL, STREAM_ATOL = 1e-4, 2e-5
D, T, CHUNK, CTX = 8, 150, 16, 16  # a window of 48 frames
SHORT = 40  # T below one window
FLOW_T, FLOW_CTX = 200, 64  # the flow's context covers its couplings and the decoder


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist a thread
    per core in every worker oversubscribes the cores, which slowed the
    port's tests about twofold and took CPU from the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def latents(rng, T, lengths):
    z = rng.standard_normal((len(lengths), T, D)).astype(np.float32)
    mask = (np.arange(T)[None, :, None] < np.asarray(lengths)[:, None, None]).astype(np.float32)
    return z * mask, mask


@pytest.fixture(scope="module")
def pair():
    jmodel, _, params, model, rng = plain_pair(seed=17)
    return dict(jmodel=jmodel, params=params, model=model, rng=rng)


@pytest.fixture(scope="module")
def ms_model():
    """A tiny multi-speaker port model (random weights), for g."""
    from torch_tts_tpu_torch.core.config import VITS2Config
    from torch_tts_tpu_torch.models.vits2 import build_synthesizer

    cfg = VITS2Config(model=VITS2ModelConfig(**dict(CFG_KW, n_speakers=4, gin_channels=8)))
    return build_synthesizer(cfg, N_VOCAB, seed=3, device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def whole_decode(model, z, mask, g=None):
    """The port's whole masked decode, samples past each length zeroed, in
    the stream's layout ([B, T, C] in, [B, T * factor, 1] out)."""
    m = mask.transpose(1, 2)
    with torch.inference_mode():
        o = model.dec(z.transpose(1, 2) * m, x_mask=m, g=None if g is None else g.transpose(1, 2))
    return (o * torch.repeat_interleave(m, o.shape[2] // m.shape[2], dim=2)).transpose(1, 2)


def test_streaming_decoder_matches_jax(pair):
    from torch_tts_tpu.infer.streaming import StreamingDecoder as JaxStreamingDecoder

    z, mask = latents(np.random.default_rng(1), T, (T, 101))
    ref = JaxStreamingDecoder(pair["jmodel"], {"params": pair["params"]}, chunk_frames=CHUNK,
                              context_frames=CTX).decode(jnp.asarray(z), None, jnp.asarray(mask))
    out = StreamingDecoder(pair["model"], CHUNK, CTX).decode(_t(z), None, _t(mask))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=JAX_ATOL)


def test_streaming_flow_decoder_matches_jax(pair):
    from torch_tts_tpu.infer.streaming import StreamingFlowDecoder as JaxStreamingFlowDecoder

    z_p, mask = latents(np.random.default_rng(2), FLOW_T, (FLOW_T, 131))
    ref = JaxStreamingFlowDecoder(pair["jmodel"], {"params": pair["params"]},
                                  chunk_frames=CHUNK, context_frames=FLOW_CTX).decode(
        jnp.asarray(z_p), None, jnp.asarray(mask))
    out = StreamingFlowDecoder(pair["model"], CHUNK, FLOW_CTX).decode(_t(z_p), None, _t(mask))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=JAX_ATOL)


@pytest.mark.parametrize("with_g", [False, True], ids=["no_g", "g"])
@pytest.mark.parametrize("frames", [SHORT, T], ids=["one_window", "windows"])
def test_stream_matches_whole_decode(ms_model, frames, with_g):
    lengths = (frames, frames - 13)
    z, mask = latents(np.random.default_rng(frames + with_g), frames, lengths)
    g = ms_model.emb_g(torch.tensor([1, 3])).unsqueeze(1).detach() if with_g else None
    sd = StreamingDecoder(ms_model, CHUNK, CTX)
    chunks = list(sd.stream(_t(z), g, _t(mask), lengths=lengths))
    assert len(chunks) == (1 if frames <= CHUNK + 2 * CTX else -(-frames // CHUNK))
    out = torch.cat(chunks, dim=1)
    ref = whole_decode(ms_model, _t(z), _t(mask), g)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=STREAM_ATOL)
    if with_g:  # the speaker moved the audio
        assert float((ref - whole_decode(ms_model, _t(z), _t(mask))).abs().max()) > 1e-3


def test_flow_stream_matches_whole_flow_and_decode(pair):
    model = pair["model"]
    lengths = (FLOW_T, 131)
    z_p, mask = latents(np.random.default_rng(4), FLOW_T, lengths)
    out = StreamingFlowDecoder(model, CHUNK, FLOW_CTX).decode(_t(z_p), None, _t(mask),
                                                              lengths=lengths)
    m = _t(mask).transpose(1, 2)
    with torch.inference_mode():
        z = model.flow(_t(z_p).transpose(1, 2), m, reverse=True)
    ref = whole_decode(model, z.transpose(1, 2), _t(mask))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=STREAM_ATOL)


def test_unmasked_windows_equal_masked_ones(pair):
    """Windows that end within every row decode unmasked when the host's
    lengths are given (so on the card the decoder's banks can take the MRF
    kernel); on the plain path their values are exactly the masked ones."""
    lengths = (T, 101)
    z, mask = latents(np.random.default_rng(5), T, lengths)
    calls = []
    sd = StreamingDecoder(pair["model"], CHUNK, CTX)
    real = sd._window
    sd._window = lambda x, m, g: calls.append(m is None) or real(x, m, g)
    unmasked = sd.decode(_t(z), None, _t(mask), lengths=lengths)
    n_free = sum(calls)
    assert n_free == sum(s + CHUNK + 2 * CTX <= 101 for s, _, _ in windows(T, CHUNK, CTX)) > 0
    assert not all(calls)  # the windows past 101 frames carry the mask
    assert torch.equal(unmasked, sd.decode(_t(z), None, _t(mask)))


@pytest.mark.parametrize("T_,chunk,ctx", [(150, 16, 16), (64, 64, 32), (1000, 64, 32),
                                          (97, 10, 3)])
def test_windows_cover_the_stream_once(T_, chunk, ctx):
    """Each window lies inside [0, T) (clamped, never zero-padded) and the
    kept frames tile [0, T) in order (the JAX trim arithmetic)."""
    W, pos = chunk + 2 * ctx, 0
    for i, (start, lo, n_keep) in enumerate(windows(T_, chunk, ctx)):
        if T_ > W:
            assert 0 <= start and start + W <= T_
        assert start + lo == pos == i * chunk and 0 < n_keep <= chunk
        pos += n_keep
    assert pos == T_


def test_flow_decoder_rejects_transformer_flows():
    model = SynthesizerTrn(N_VOCAB, SPEC_CH, VITS2ModelConfig(**CFG_KW)).eval()
    with pytest.raises(ValueError, match="conv-local"):
        StreamingFlowDecoder(model)
    StreamingFlowDecoder(model, allow_nonlocal_flow=True)
