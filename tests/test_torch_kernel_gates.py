"""The port's kernel gates: each kernel module's `supports` predicate, true
and false around the limits its wrapper checks, the wrappers still raising
on a shape their kernel does not take, and the model routing such shapes
to the plain path before it calls the kernel (the decoder's ResBlock1
banks, the WN stacks, MAS).

On the CPU every wrapper takes its plain version, so the routing tests
patch the wrapper the model calls with a counter and hold the output
against the plain path's.
"""

import numpy as np
import pytest
import torch

from torch_tts_tpu_torch.kernels import mas, mrf_fused, wn_stack


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist a thread
    per core in every worker oversubscribes the cores, which slowed the
    port's tests about twofold and took CPU from the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _max_t_y(T_x):
    lo, hi = 1, 1 << 20
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if mas.supports(mid, T_x) else (lo, mid)
    return lo


def test_supports_predicates_around_their_limits():
    for C in (32, 64, 128):
        assert mrf_fused.supports(C) and mrf_fused.supports(C, 16)
    for C in (16, 96, 256):
        assert not mrf_fused.supports(C)
    assert not mrf_fused.supports(128, 17)
    assert wn_stack.supports(192, 5) and wn_stack.supports(192, 15) and wn_stack.supports(192, 1)
    for H, k in ((192, 17), (192, 4), (128, 5), (256, 5)):
        assert not wn_stack.supports(H, k)
    assert mas.supports(1000, 512) and not mas.supports(1000, 513)
    assert mas.supports(1000, 192) and mas.supports(300, 381)
    for T_x in (192, 512):
        t_y = _max_t_y(T_x)
        ring, rec, _ = mas.smem_parts(t_y, T_x)
        assert ring + rec <= mas.SMEM_BYTES < sum(mas.smem_parts(t_y + 1, T_x)[:2])
        assert not mas.supports(t_y + 1, T_x)


def test_wrappers_still_raise_on_shapes_their_kernels_do_not_take():
    """The argument checks that run before any launch refuse what the
    predicates refuse (CPU tensors: the checks raise before the library is
    loaded)."""
    x = torch.zeros(1, 8, 16)
    w, b = torch.zeros(48, 16), torch.zeros(16)
    blocks = ((((mrf_fused.dilated_offsets(3, 1), w, b), (mrf_fused.dilated_offsets(3, 1), w, b)),),)
    with pytest.raises(ValueError, match="C=16"):
        mrf_fused._check_cuda_args(x, blocks)
    H, L, k = 128, 2, 5
    xw = torch.zeros(1, 8, H)
    with pytest.raises(ValueError, match="H=128"):
        wn_stack._check_cuda_args(xw, xw[..., :1], None, torch.zeros(L, k, H, 2 * H),
                                  torch.zeros(L, 2 * H), torch.zeros(L, H, 2 * H),
                                  torch.zeros(L, 2 * H))
    with pytest.raises(ValueError, match="not taken by the kernel"):
        mas._maximum_path_cuda(torch.zeros(1, 600, 513), torch.tensor([600]),
                               torch.tensor([513]))


def test_decoder_sends_only_supported_banks_to_the_kernel(monkeypatch):
    """upsample_initial_channel 256: stages of 128, 64, 32 and 16 channels;
    the first three take `mrf_fused`, the 16-channel one its plain
    convolutions; the audio equals the plain decoder's."""
    from torch_tts_tpu_torch.ops import hifigan
    from torch_tts_tpu_torch.ops.layers import init_params_

    dec = hifigan.Generator(8, "1", (3, 5), ((1, 3, 5), (1, 3, 5)), (2, 2, 2, 2), 256,
                            (4, 4, 4, 4), fuse_mrf=True)
    init_params_(dec, torch.Generator().manual_seed(0))
    widths = []

    def counting(x, blocks):
        widths.append(x.shape[2])
        return mrf_fused.mrf_plain(x, blocks)

    monkeypatch.setattr(hifigan, "mrf_fused", counting)
    z = torch.randn(1, 8, 12, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        out = dec(z)
        dec.fuse_mrf = False
        plain = dec(z)
    assert widths == [128, 64, 32]
    np.testing.assert_allclose(out.numpy(), plain.numpy(), rtol=1e-4, atol=1e-5)


def test_mbistft_trunk_sends_only_its_128_channel_bank_to_the_kernel(monkeypatch):
    """The MB-iSTFT trunk at the shipped widths (upsample_initial_channel
    512: stages of 256 and 128 channels) goes through the HiFi-GAN
    decoder's bank rule: the 128-channel bank takes `mrf_fused`, the
    256-channel one its plain convolutions, and a masked decode none; the
    audio equals the plain decoder's."""
    from torch_tts_tpu_torch.ops import hifigan, mb_istft
    from torch_tts_tpu_torch.ops.layers import init_params_

    dec = mb_istft.MultiBandISTFTGenerator(8, "1", (3, 5), ((1, 3, 5), (1, 3, 5)), (2, 2), 512,
                                           (4, 4), fuse_mrf=True)
    init_params_(dec, torch.Generator().manual_seed(0))
    widths = []

    def counting(x, blocks):
        widths.append(x.shape[2])
        return mrf_fused.mrf_plain(x, blocks)

    monkeypatch.setattr(hifigan, "mrf_fused", counting)
    z = torch.randn(1, 8, 6, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        out = dec(z)
        masked = dec(z, x_mask=torch.ones(1, 1, 6))
        dec.fuse_mrf = False
        plain = dec(z)
    assert widths == [128]
    np.testing.assert_allclose(out.numpy(), plain.numpy(), rtol=1e-4,
                               atol=1e-5 * float(plain.abs().max()))
    np.testing.assert_allclose(masked.numpy(), plain.numpy(), rtol=1e-4,
                               atol=1e-5 * float(plain.abs().max()))


def test_resblock2_banks_never_reach_the_kernel(monkeypatch):
    """The kernel computes a ResBlock1 bank: a ResBlock2 decoder with
    fuse_mrf on and 128-, 64- and 32-channel stages runs every bank on its
    plain convolutions."""
    from torch_tts_tpu_torch.ops import hifigan
    from torch_tts_tpu_torch.ops.layers import init_params_

    dec = hifigan.Generator(8, "2", (3, 5), ((1, 2), (2, 6)), (2, 2, 2), 256, (4, 4, 4),
                            fuse_mrf=True)
    init_params_(dec, torch.Generator().manual_seed(0))
    calls = []
    monkeypatch.setattr(hifigan, "mrf_fused", lambda x, blocks: calls.append(x.shape))
    with torch.no_grad():
        out = dec(torch.randn(1, 8, 12, generator=torch.Generator().manual_seed(1)))
    assert calls == [] and out.shape == (1, 1, 96)
    assert all(isinstance(b, hifigan.ResBlock2) for b in dec.resblocks)
    assert [b.channels for b in dec.resblocks] == [128, 128, 64, 64, 32, 32]


@pytest.mark.parametrize("H,k,fused", [(192, 5, True), (128, 5, False), (192, 17, False)])
def test_wn_sends_only_supported_stacks_to_the_kernel(monkeypatch, H, k, fused):
    from torch_tts_tpu_torch.ops import wavenet
    from torch_tts_tpu_torch.ops.layers import init_params_

    wn = wavenet.WN(H, k, 1, 2, gin_channels=4, fused=True)
    init_params_(wn, torch.Generator().manual_seed(0))
    calls = []

    def counting(*args):
        calls.append(args[0].shape)
        return wn_stack.wn_stack(*args)

    monkeypatch.setattr(wavenet, "wn_stack", counting)
    g = torch.Generator().manual_seed(1)
    x, cond = torch.randn(2, H, 9, generator=g), torch.randn(2, 4, 1, generator=g)
    mask = (torch.arange(9)[None, None] < torch.tensor([9, 6])[:, None, None]).float()
    with torch.no_grad():
        out = wn(x, mask, g=cond)
        wn.fused = False
        plain = wn(x, mask, g=cond)
    assert bool(calls) == fused
    np.testing.assert_allclose(out.numpy(), plain.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("T_x,kernel", [(40, True), (513, False)])
def test_training_forward_sends_mas_to_the_kernel_where_it_takes_the_shape(monkeypatch, T_x,
                                                                           kernel):
    """Above 512 text positions MAS runs its plain version at the model
    level; both give a valid path."""
    from torch_tts_tpu_torch.core.config import VITS2ModelConfig
    from torch_tts_tpu_torch.models.vits2 import model as model_module
    from torch_tts_tpu_torch.ops.layers import init_params_

    cfg = VITS2ModelConfig(
        inter_channels=4, hidden_channels=4, filter_channels=8, n_heads=2, n_layers=1,
        kernel_size=3, p_dropout=0.0, resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1,),),
        upsample_rates=(2,), upsample_initial_channel=8, upsample_kernel_sizes=(4,),
        posterior_wn_layers=1, flow_n_flows=1, use_sdp=False)
    model = init_params_(model_module.SynthesizerTrn(10, 6, cfg, 4),
                         torch.Generator().manual_seed(0)).eval()
    used = []
    for name in ("maximum_path", "maximum_path_via_plain"):
        fn = getattr(model_module, name)
        monkeypatch.setattr(model_module, name,
                            lambda nc, m, _fn=fn, _n=name: used.append(_n) or _fn(nc, m))
    T_y = T_x + 7
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        attn = model(torch.randint(1, 10, (1, T_x), generator=g), torch.tensor([T_x]),
                     torch.randn(1, T_y, 6, generator=g), torch.tensor([T_y]), generator=g)[2]
    assert used == ["maximum_path" if kernel else "maximum_path_via_plain"]
    assert float(attn.sum()) == T_y and bool((attn.sum(2) == 1).all())
