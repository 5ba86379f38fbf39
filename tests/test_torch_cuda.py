"""PyTorch port on the card: each hand-written CUDA kernel against its
plain PyTorch version, and the batched RX through both kernels.

Marked `cuda`; every test skips (from the `cuda_device` fixture) where
torch sees no CUDA device. On the card (whose Python has no jax, which
tests/conftest.py imports): python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py. FIR and fused DUC kernels within 1.2e-4
(tests/test_pallas_filters.py tolerance), LDPC bit for bit.
"""
import numpy as np
import pytest
import torch

from python_5gtoolbox_tpu_torch import kernels
from python_5gtoolbox_tpu_torch.ops import filters, ofdm
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


def _max_err(got, ref):
    assert got.shape == ref.shape
    return (got - ref).abs().max().item()


@pytest.mark.parametrize("bw,shape", [(20, (4, 307200)), (100, (2, 70001)),
                                      (5, (3, 130)), (100, (1, 1))])
def test_fir_up2_fused_kernel_matches_plain(cuda_device, bw, shape):
    fir, hb = filters.fir_coeff(30, bw), filters.halfband_coeff()
    gen = torch.Generator(device=cuda_device).manual_seed(bw)
    x = torch.randn(shape, generator=gen, device=cuda_device)
    before = kernels.LAUNCHES["fir_up2_fused"]
    got = filters.fir_up2_fused_planes(x, fir, hb)
    ref = filters.fir_up2_fused_plain(x, fir, hb)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fir_up2_fused"] == before + 1
    assert _max_err(got, ref) < 1.2e-4
    xc = torch.complex(x, x.flip(-1))
    got_c = filters.fir_up2_fused(xc, fir, hb)
    ref_c = filters.hb_upsample2(filters.fir_same(xc, fir), hb)
    assert _max_err(torch.view_as_real(got_c),
                    torch.view_as_real(ref_c)) < 1.2e-4


def _grid(cuda_device, scs, bw, nant, n_slots):
    n_sc = 12 * ofdm.num.carrier_prb_size(scs, bw)
    gen = torch.Generator(device=cuda_device).manual_seed(scs + bw + n_slots)
    return torch.complex(
        torch.randn((nant, n_slots, 14, n_sc), generator=gen,
                    device=cuda_device),
        torch.randn((nant, n_slots, 14, n_sc), generator=gen,
                    device=cuda_device))


# (15, 5), (30, 5), (30, 10): every carrier below nfft 1024
@pytest.mark.parametrize("scs,bw,nant,n_slots", [(15, 5, 2, 3), (30, 5, 1, 1),
                                                 (30, 10, 2, 2)])
def test_fir_up2_fused_symbols_kernel_matches_plain(cuda_device, scs, bw,
                                                    nant, n_slots):
    fd = _grid(cuda_device, scs, bw, nant, n_slots)
    symp = ofdm.tx_low_phy_sym_planes(fd, scs, bw, 3_500_000_000,
                                      slot_phase=True, start_slot=1)
    cps = ofdm._cp_table(scs, symp.shape[-1])
    fir, hb = filters.fir_coeff(scs, bw), filters.halfband_coeff()
    before = kernels.LAUNCHES["fir_up2_fused_symbols"]
    got = filters.fir_up2_fused_symbols(symp, cps, fir, hb)
    ref = filters.fir_up2_fused_symbols_plain(symp, cps, fir, hb)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fir_up2_fused_symbols"] == before + 1
    assert _max_err(got, ref) < 1.2e-4


@pytest.mark.parametrize("scs,bw,nant,n_slots", [(30, 20, 2, 3),
                                                 (30, 20, 1, 1),
                                                 (15, 20, 1, 2),
                                                 (30, 100, 2, 2)])
def test_duc_from_spec_kernel_matches_plain(cuda_device, scs, bw, nant,
                                            n_slots):
    fc = 3_500_000_000
    fd = _grid(cuda_device, scs, bw, nant, n_slots)
    spec = ofdm.tx_spec_planes(fd, scs, bw, fc, slot_phase=True,
                               start_slot=2)
    nfft = spec.shape[-1]
    cps, pc = ofdm._cp_table(scs, nfft), ofdm._phase_comp(scs, nfft, fc)
    fir, hb = filters.fir_coeff(scs, bw), filters.halfband_coeff()
    before = kernels.LAUNCHES["duc_from_spec"]
    got = torch.cat(filters.duc_from_spec_planes(spec, cps, fir, hb, pc))
    ref = torch.cat(filters.duc_from_spec_planes_plain(spec, cps, fir, hb,
                                                       pc))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["duc_from_spec"] == before + 1
    assert _max_err(got, ref) < 1.2e-4


@pytest.mark.parametrize("scs,bw,launched", [
    (30, 100, "duc_from_spec"), (30, 20, "duc_from_spec"),
    (15, 5, "fir_up2_fused_symbols"), (30, 10, "fir_up2_fused_symbols")])
@pytest.mark.parametrize("as_planes", [False, True, "split"])
def test_tx_lowphy_duc_on_card_matches_cpu(cuda_device, scs, bw, launched,
                                           as_planes):
    """The 245.76 Msps TX chain on the card (fused kernel + banded_fir up2
    stages) against the same entry point on the CPU (plain versions)."""
    fd = _grid(cuda_device, scs, bw, 2, 2)
    kw = dict(as_planes=as_planes, slot_phase=True, start_slot=1)
    kernels.reset_launches()
    got = filters.tx_lowphy_duc(fd, scs, bw, 3_500_000_000, 245.76e6, **kw)
    ref = filters.tx_lowphy_duc(fd.cpu(), scs, bw, 3_500_000_000, 245.76e6,
                                **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[launched] == 1
    if as_planes != "split":
        got, ref = (got,), (ref,)
    for g, r in zip(got, ref):
        if g.is_complex():
            g, r = torch.view_as_real(g), torch.view_as_real(r)
        assert _max_err(g.cpu(), r) < 1.2e-4


def test_fused_wrappers_reject_bad_input(cuda_device):
    fir, hb = filters.fir_coeff(30, 20), filters.halfband_coeff()
    with pytest.raises(ValueError):
        filters.fir_up2_fused_planes(
            torch.zeros((2, 100), dtype=torch.float64, device=cuda_device),
            fir, hb)
    with pytest.raises(ValueError):
        filters.fir_up2_fused_symbols(
            torch.zeros((2, 1, 13, 256), device=cuda_device), [18] * 14, fir,
            hb)
    with pytest.raises(ValueError):
        filters.duc_from_spec_planes(
            torch.zeros((2, 1, 14, 1000), device=cuda_device), [72] * 14,
            fir, hb, np.ones(14, np.complex64))


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


def test_oversampled_sweep_goes_through_the_duc_kernels(cuda_device):
    from python_5gtoolbox_tpu_torch.sim import pdsch_throughput as sim
    carrier, pdsch, chan, ce, ldpc = sim.bench_link_level_config()
    carrier["samplerate_in_mhz"] = 245.76
    kernels.reset_launches()
    res = sim.run_pdsch_throughput(carrier, pdsch, chan, [25.0],
                                   ["MMSE-IRC"], n_slots=4, ce_config=ce,
                                   ldpc_config=ldpc, device=cuda_device)
    assert res["MMSE-IRC"] == [1.0]
    for name in ("duc_from_spec", "banded_fir", "ldpc_minsum_flooded"):
        assert kernels.LAUNCHES[name] > 0, name
