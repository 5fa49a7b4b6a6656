"""VITS2 inference with the deterministic duration predictor: the tests of
tests/test_torch_vits2_infer.py (the same functions, imported) on its
`dp` pair, built by that file's `build_pair(use_sdp=False)`: the same
tiny config, weights, inputs and tolerances, `use_sdp` off.
"""

import pytest
import torch

from test_torch_vits2_infer import (build_pair, test_decoder_on_jax_latents,  # noqa: F401
                                    test_duration_predictor, test_flow_reverse_on_jax_latents,
                                    test_infer_matches_jax_at_noise_zero,
                                    test_infer_matches_jax_with_injected_noise,
                                    test_infer_needs_generator_or_noise,
                                    test_patch_window_branch_sees_short_items,
                                    test_posterior_encoder, test_text_encoder)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist a thread
    per core in every worker oversubscribes the cores, which slowed the
    port's tests about twofold and took CPU from the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=[False], ids=["dp"])
def pair(request):
    return build_pair(request.param)
