"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Skips without a CUDA device. Imports no JAX, so it also runs where only
PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: none; the kernels round like their plain versions.
"""

import numpy as np
import pytest
import torch

from rtda_semanticsegmentation_tpu_torch.kernels import int8_conv as k3

# (kernel, stride, pad, C, CO): BiSeNet-R18's quantized conv shapes, narrowed
SHAPES = [(3, 1, 1, 128, 128), (3, 2, 1, 32, 48), (1, 2, 0, 32, 48), (3, 1, 1, 64, 19),
          (3, 2, 1, 64, 19), (3, 1, 1, 6, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("k,s,p,C,CO", SHAPES)
def test_int8_conv_kernel_matches_plain_version(k, s, p, C, CO):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.RandomState(k * 1000 + C + CO)
    dev = torch.device("cuda")
    xq = torch.from_numpy(rng.randint(-127, 128, (2, 15, 17, C)).astype(np.int8)).to(dev)
    wq = torch.from_numpy(rng.randint(-127, 128, (k, k, C, CO)).astype(np.int8)).to(dev)
    a = torch.from_numpy(rng.rand(CO).astype(np.float32) * 1e-4).to(dev)
    b = torch.from_numpy(rng.randn(CO).astype(np.float32)).to(dev)
    inv = torch.from_numpy((rng.rand(CO).astype(np.float32) + 0.5) * 50).to(dev)
    before = k3.launches
    for inv_out, relu, dt in ((None, False, torch.bfloat16), (None, True, torch.float32),
                              (inv, True, torch.bfloat16)):
        kw = dict(stride=s, padding=p, relu=relu, out_dtype=dt)
        got = k3.int8_conv(xq, wq, a, b, inv_out, **kw)
        want = k3.int8_conv_plain(xq, wq, a, b, inv_out, **kw)
        torch.cuda.synchronize()
        assert got.device == xq.device and got.dtype == want.dtype
        assert torch.equal(got, want), (relu, dt, inv_out is not None)
    assert k3.launches == before + 3
