"""The port's CUDA kernels against their plain PyTorch versions, on a card.

A hand-written CUDA kernel has no CPU mode, so these tests skip without a
card.  They import no JAX, so they also run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest sets JAX up.)
"""

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.ops import hopper_kernels as hk

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from predictionio_tpu_torch.device import resolve_device

    return resolve_device("cuda")


@pytest.mark.parametrize("mask_dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("shape", [(5, 12, 300), (1, 32, 100_000),
                                   (17, 33, 1001), (64, 32, 100_000)])
def test_masked_score_kernel_matches_plain(dev, shape, with_bias, mask_dtype):
    b, k, n = shape
    rng = np.random.default_rng(sum(shape))
    u = torch.from_numpy(rng.normal(size=(b, k)).astype(np.float32)).to(dev)
    v = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32)).to(dev)
    mask = torch.from_numpy(rng.random((b, n)) < 0.1).to(dev, mask_dtype)
    bias = (torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dev)
            if with_bias else None)
    before = hk.masked_score_matmul.launches
    got = hk.masked_score_matmul(u, v, mask, bias)
    want = hk.masked_score_matmul_plain(u, v, mask, bias)
    torch.cuda.synchronize()
    assert hk.masked_score_matmul.launches == before + 1
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-5)
