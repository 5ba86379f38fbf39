"""PyTorch port on the card: each hand-written CUDA kernel against its
plain PyTorch version, and the batched RX through both kernels.

Marked `cuda`; every test skips (from the `cuda_device` fixture) where
torch sees no CUDA device. On the card (whose Python has no jax, which
tests/conftest.py imports): python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py. FIR within 1.2e-4 (tests/test_pallas_filters.py
tolerance), LDPC bit for bit.
"""
import numpy as np
import pytest
import torch

from python_5gtoolbox_tpu_torch import kernels
from python_5gtoolbox_tpu_torch.ops import filters
from python_5gtoolbox_tpu_torch.ops.ldpc import decode as ldpc_dec
from python_5gtoolbox_tpu_torch.ops.ldpc.encode import ldpc_encode

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("mode", ["same", "up2", "down2"])
@pytest.mark.parametrize("bw,shape", [(20, (4, 307200)), (20, (8, 3001)),
                                      (100, (2, 70000))])
def test_banded_fir_kernel_matches_plain(cuda_device, mode, bw, shape):
    taps = filters.fir_coeff(30, bw)
    gen = torch.Generator(device=cuda_device).manual_seed(bw)
    x = torch.randn(shape, generator=gen, device=cuda_device)
    before = kernels.LAUNCHES["banded_fir"]
    got = filters.banded_fir(x, taps, mode)
    ref = filters.banded_fir_plain(x, taps, mode)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["banded_fir"] == before + 1
    assert got.shape == ref.shape
    assert (got - ref).abs().max().item() < 1.2e-4


def test_banded_fir_rejects_bad_input(cuda_device):
    x = torch.zeros((2, 100), dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError):
        filters.banded_fir(x, filters.halfband_coeff(), "same")


@pytest.mark.parametrize("zc,bgn,batch,snr", [(352, 2, 20, -2.0),
                                              (352, 2, 20, -6.0),
                                              (384, 1, 8, 0.0),
                                              (16, 2, 30, 1.0)])
def test_ldpc_kernel_matches_plain(cuda_device, zc, bgn, batch, snr):
    rng = np.random.default_rng(zc + batch)
    k = (22 if bgn == 1 else 10) * zc
    bits = torch.as_tensor(rng.integers(0, 2, (batch, k), dtype=np.int8),
                           device=cuda_device)
    dn = ldpc_encode(bits, bgn).to(torch.float32)
    s2 = 10 ** (-snr / 10)
    noise = torch.as_tensor(rng.standard_normal(tuple(dn.shape),
                                                dtype=np.float32),
                            device=cuda_device)
    llr = (2 / s2) * (1 - 2 * dn + noise * np.sqrt(s2))
    b1, ok1, f1 = ldpc_dec.ldpc_decode(llr, zc, bgn, 12, "min-sum", 0.8, 0.3)
    b2, ok2, f2 = ldpc_dec._ldpc_decode_plain(llr, zc, bgn, 12, 0.8, 0.3)
    torch.cuda.synchronize()
    assert torch.equal(f1, f2)
    assert torch.equal(ok1, ok2)
    assert torch.equal(b1, b2)


def test_batched_rx_goes_through_both_kernels(cuda_device):
    from python_5gtoolbox_tpu_torch.sim import pdsch_throughput as sim
    carrier, pdsch, chan, ce, ldpc = sim.bench_link_level_config()
    kernels.reset_launches()
    res = sim.run_pdsch_throughput(carrier, pdsch, chan, [25.0],
                                   ["MMSE-IRC"], n_slots=4, ce_config=ce,
                                   ldpc_config=ldpc, device=cuda_device)
    assert res["MMSE-IRC"] == [1.0]
    assert kernels.LAUNCHES["banded_fir"] > 0
    assert kernels.LAUNCHES["ldpc_minsum_flooded"] > 0
