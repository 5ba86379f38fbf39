"""PyTorch port on the card: each hand-written CUDA kernel against its
plain PyTorch version (the two LDPC kernels in every schedule and check
node), the sweeps through them, the plain-PyTorch polar decoder (a
CUDA graph on the card, and its counters), its study and UCI on PUSCH
against the CPU, and
the multi-channel DL waveforms (a full-width test model, all four DL
channels at 245.76 Msps, the standalone SSB waveform), and the receiver
breadth against the CPU (the per-slot RX, the ML equalizers, the DCT CE,
the TDL channel with pinned taps), ML2's search kernel against the
plain search on the card, and the fading channel's kernel against the
plain per-path loop.

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
from python_5gtoolbox_tpu_torch.phy.prach import prach_halfband
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
                                      (100, (2, 70000)), (20, (2, 307200))])
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


# 56: the PRACH chain's halfband (phy/prach.py:prach_halfband), the one
# even tap count
FIR_TAP_COUNTS = sorted(set(filters._FIR_NUMTAPS.values()) | {55, 56})


def _fir_taps(n):
    if n == 55:
        return filters.halfband_coeff()
    if n == 56:
        return prach_halfband()
    scs, bw = next(k for k, v in filters._FIR_NUMTAPS.items() if v == n)
    return filters.fir_coeff(scs, bw)


@pytest.mark.parametrize("mode", ["same", "up2", "down2"])
@pytest.mark.parametrize("n", FIR_TAP_COUNTS)
@pytest.mark.parametrize("t_in,offset", [(4103, 0), (2050, 0), (8192, 1),
                                         (3, 0), (1, 0)])
def test_banded_fir_staging_paths(cuda_device, n, mode, t_in, offset):
    """Every tap count at ragged lengths (4-byte staging), and rows of a
    multiple of 4 samples on a base 4 bytes past a 16-byte boundary
    (offset 1: the plan must pick 4-byte staging too)."""
    taps = _fir_taps(n)
    gen = torch.Generator(device=cuda_device).manual_seed(n + t_in)
    flat = torch.randn(3 * t_in + offset, generator=gen, device=cuda_device)
    x = flat[offset:].view(3, t_in)
    assert x.is_contiguous()
    plan = filters.fir_plan(n, mode, t_in, 3, x.data_ptr() % 16 == 0)
    assert plan.vec == (t_in % 4 == 0 and offset == 0)
    got = filters.banded_fir(x, taps, mode)
    torch.cuda.synchronize()
    assert got.shape == (3, plan.t_out)
    if plan.t_out:
        ref = filters.banded_fir_plain(x, taps, mode)
        assert _max_err(got, ref) < 1.2e-4


@pytest.mark.parametrize("bw,shape", [(20, (4, 307200)), (100, (2, 70001)),
                                      (5, (3, 130)), (100, (1, 1)),
                                      (40, (2, 614400)), (40, (2, 1228800))])
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


@pytest.mark.parametrize("per", [4, 8])
@pytest.mark.parametrize("n1,aligned", [(71, True), (287, True),
                                        (27, False)])
def test_fir_up2_fused_forced_plans(cuda_device, per, n1, aligned):
    """Every forced choice of fused_plan: 4 or 8 outputs per thread,
    16-byte and 4-byte staging (3 planes of several tiles each)."""
    fir, hb = _fir_taps(n1), filters.halfband_coeff()
    gen = torch.Generator(device=cuda_device).manual_seed(n1 + per)
    x = torch.randn((3, 4096), generator=gen, device=cuda_device)
    plan = filters.fused_plan(3, 4096, n1, 55, aligned, per)
    assert plan.vec == aligned
    before = kernels.LAUNCHES["fir_up2_fused"]
    got = filters.fir_up2_fused_planes(x, fir, hb, plan=plan)
    ref = filters.fir_up2_fused_plain(x, fir, hb)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fir_up2_fused"] == before + 1
    assert _max_err(got, ref) < 1.2e-4
    with pytest.raises(ValueError):
        filters.fir_up2_fused_planes(x[:2].contiguous(), fir, hb, plan=plan)
    assert kernels.LAUNCHES["fir_up2_fused"] == before + 1


@pytest.mark.parametrize("t,offset", [(4100, 1), (4103, 0), (4103, 3),
                                      (1228800, 2)])
@pytest.mark.parametrize("n1", [45, 71, 287])
def test_fir_up2_fused_unaligned_and_ragged(cuda_device, t, offset, n1):
    """A sliced view 4-12 bytes past a 16-byte boundary (the plan must take
    4-byte staging) and ragged rows; a forced 16-byte plan is refused on
    the unaligned view."""
    fir, hb = _fir_taps(n1), filters.halfband_coeff()
    gen = torch.Generator(device=cuda_device).manual_seed(t + offset)
    flat = torch.randn(2 * t + offset, generator=gen, device=cuda_device)
    x = flat[offset:].view(2, t)
    got = filters.fir_up2_fused_planes(x, fir, hb)
    ref = filters.fir_up2_fused_plain(x, fir, hb)
    assert _max_err(got, ref) < 1.2e-4
    if offset and t % 4 == 0:
        with pytest.raises(ValueError):
            filters.fir_up2_fused_planes(
                x, fir, hb, plan=filters.fused_plan(2, t, n1, 55))


def test_fir_up2_fused_full_width(cuda_device):
    """The BW 100 Dm waveform's only filter stage: 2 antennas x 20 slots at
    122.88 Msps as 4 planes of 1228800, 287 + 55 taps."""
    fir, hb = filters.fir_coeff(30, 100), filters.halfband_coeff()
    gen = torch.Generator(device=cuda_device).manual_seed(100)
    x = torch.randn((4, 1228800), generator=gen, device=cuda_device)
    got = filters.fir_up2_fused_planes(x, fir, hb)
    assert _max_err(got, filters.fir_up2_fused_plain(x, fir, hb)) < 1.2e-4


@pytest.mark.parametrize("scs,bw", [(15, 5), (30, 10), (30, 5)])
@pytest.mark.parametrize("n_slots", [1, 20])
def test_fir_up2_fused_symbols_every_carrier(cuda_device, scs, bw, n_slots):
    """The three carriers below nfft 1024 at 1 and 20 slots, the default
    plan (at scs 30 / BW 5 the CPs of 18 and 22 samples take 4-byte
    runs) and every forced group size."""
    fd = _grid(cuda_device, scs, bw, 2, n_slots)
    symp = ofdm.tx_low_phy_sym_planes(fd, scs, bw, 3_500_000_000)
    nfft = symp.shape[-1]
    cps = tuple(int(c) for c in ofdm._cp_table(scs, nfft))
    fir, hb = filters.fir_coeff(scs, bw), filters.halfband_coeff()
    ref = filters.fir_up2_fused_symbols_plain(symp, cps, fir, hb)
    plans = [None] + [filters.fused_symbols_plan(4, n_slots, nfft, len(fir),
                                                 55, cps, True, group)
                      for group in filters.FUSED_GROUPS]

    for plan in plans:
        before = kernels.LAUNCHES["fir_up2_fused_symbols"]
        got = filters.fir_up2_fused_symbols(symp, cps, fir, hb, plan=plan)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["fir_up2_fused_symbols"] == before + 1
        assert _max_err(got, ref) < 1.2e-4
    # a sliced, unaligned input takes 4-byte runs only
    flat = torch.cat([symp.new_zeros(1), symp.reshape(-1)])
    view = flat[1:].view(symp.shape)
    assert _max_err(filters.fir_up2_fused_symbols(view, cps, fir, hb),
                    ref) < 1.2e-4
    with pytest.raises(ValueError):
        filters.fir_up2_fused_symbols(view, cps, fir, hb, plan=plans[1])


@pytest.mark.parametrize("scs,bw,nant,n_slots", [(30, 20, 2, 3),
                                                 (30, 20, 1, 1),
                                                 (15, 20, 1, 2),
                                                 (30, 100, 2, 2),
                                                 (30, 40, 1, 20)])
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


@pytest.mark.parametrize("mode", ["same", "up2", "down2"])
@pytest.mark.parametrize("stages", [1, 2])
@pytest.mark.parametrize("tiles_per_block", [1, 3, 4])
def test_banded_fir_forced_ring(cuda_device, mode, stages, tiles_per_block):
    """Both ring depths with blocks of one tile, of a few, and of more
    tiles than the row has (3 tiles, 2 in down2: a block's last tiles
    cross into the next plane)."""
    taps = filters.fir_coeff(30, 20)
    gen = torch.Generator(device=cuda_device).manual_seed(stages)
    x = torch.randn((3, 6144), generator=gen, device=cuda_device)
    plan = filters.fir_plan(len(taps), mode, 6144, 3,
                            tiles_per_block=tiles_per_block, stages=stages)
    got = filters._banded_fir_launch(x, taps, plan)
    ref = filters.banded_fir_plain(x, taps, mode)
    assert _max_err(got, ref) < 1.2e-4
    with pytest.raises(ValueError):
        filters._banded_fir_launch(x[:2].contiguous(), taps, plan)


@pytest.mark.parametrize("cluster", [1, 2, 3, 4, 7, 8, 12, 14, 16])
@pytest.mark.parametrize("scs,bw,n_slots", [(30, 20, 1), (30, 20, 3),
                                            (30, 100, 2)])
def test_duc_from_spec_every_cluster_size(cuda_device, cluster, scs, bw,
                                          n_slots):
    """A forced plan at each cluster size: padded grids (14 or 42 symbols
    in clusters of 3, 4, 8, 16, ...), clusters across slot boundaries, the
    1-slot waveform."""
    fc = 3_500_000_000
    fd = _grid(cuda_device, scs, bw, 2, n_slots)
    spec = ofdm.tx_spec_planes(fd, scs, bw, fc)
    nfft = spec.shape[-1]
    cps, pc = ofdm._cp_table(scs, nfft), ofdm._phase_comp(scs, nfft, fc)
    fir, hb = filters.fir_coeff(scs, bw), filters.halfband_coeff()
    plan = filters.duc_plan(2, n_slots, nfft, len(fir), len(hb), cps,
                            cluster)
    before = kernels.LAUNCHES["duc_from_spec"]
    got = filters._duc_from_spec(spec, cps, fir, hb, pc, plan=plan)
    ref = torch.cat(filters.duc_from_spec_planes_plain(spec, cps, fir, hb,
                                                       pc))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["duc_from_spec"] == before + 1
    assert _max_err(got, ref) < 1.2e-4


def test_duc_from_spec_forced_plan_that_does_not_fit_raises(cuda_device):
    fd = _grid(cuda_device, 30, 20, 1, 2)
    spec = ofdm.tx_spec_planes(fd, 30, 20, 0)
    cps, pc = ofdm._cp_table(30, 1024), ofdm._phase_comp(30, 1024, 0)
    fir, hb = filters.fir_coeff(30, 20), filters.halfband_coeff()
    with pytest.raises(ValueError):
        filters.duc_plan(1, 2, 1024, len(fir), len(hb), cps, 17)
    other = filters.duc_plan(1, 3, 1024, len(fir), len(hb), cps, 8)
    before = kernels.LAUNCHES["duc_from_spec"]
    with pytest.raises(ValueError):
        filters._duc_from_spec(spec, cps, fir, hb, pc, plan=other)
    assert kernels.LAUNCHES["duc_from_spec"] == before


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


def _noisy_llrs(device, zc, bgn, batch, snr, seed=0):
    rng = np.random.default_rng(zc + batch + seed)
    k = (22 if bgn == 1 else 10) * zc
    bits = torch.as_tensor(rng.integers(0, 2, (batch, k), dtype=np.int8),
                           device=device)
    dn = ldpc_encode(bits, bgn).to(torch.float32)
    s2 = 10 ** (-snr / 10)
    noise = torch.as_tensor(rng.standard_normal(tuple(dn.shape),
                                                dtype=np.float32),
                            device=device)
    return (2 / s2) * (1 - 2 * dn + noise * np.sqrt(s2))


def _assert_same_decode(got, ref):
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("zc,bgn,batch,snr", [(352, 2, 20, -2.0),
                                              (352, 2, 20, -6.0),
                                              (384, 1, 8, 0.0),
                                              (16, 2, 30, 1.0),
                                              (288, 2, 20, -2.0)])
def test_ldpc_kernel_matches_plain(cuda_device, zc, bgn, batch, snr):
    llr = _noisy_llrs(cuda_device, zc, bgn, batch, snr)
    before = kernels.LAUNCHES["ldpc_minsum_flooded"]
    got = ldpc_dec.ldpc_decode(llr, zc, bgn, 12, "min-sum", 0.8, 0.3,
                               layout="batch")
    assert kernels.LAUNCHES["ldpc_minsum_flooded"] == before + 1
    _assert_same_decode(got, ldpc_dec._ldpc_decode_plain(llr, zc, bgn, 12,
                                                         0.8, 0.3))


VARIANTS = [("flooded", "fast"), ("layered", "exact"), ("layered", "fast")]


@pytest.mark.parametrize("schedule,semantics", VARIANTS)
@pytest.mark.parametrize("zc,bgn,batch,snr", [(352, 2, 6, -2.0),
                                              (352, 2, 6, -6.0),
                                              (384, 1, 4, 0.0),
                                              (16, 2, 30, 1.0)])
def test_ldpc_kernel_variants_match_plain(cuda_device, zc, bgn, batch, snr,
                                          schedule, semantics):
    """ldpc_minsum, layered schedule and fast check node, bit for bit."""
    llr = _noisy_llrs(cuda_device, zc, bgn, batch, snr)
    name = f"ldpc_minsum_{schedule}" + ("_fast" if semantics == "fast"
                                        else "")
    before = kernels.LAUNCHES[name]
    got = ldpc_dec.ldpc_decode(llr, zc, bgn, 8, "min-sum", 0.8, 0.3,
                               schedule=schedule, semantics=semantics,
                               layout="batch")
    assert kernels.LAUNCHES[name] == before + 1
    _assert_same_decode(got, ldpc_dec._ldpc_decode_plain(
        llr, zc, bgn, 8, 0.8, 0.3, schedule, semantics))


@pytest.mark.parametrize("schedule,semantics",
                         [("flooded", "exact")] + VARIANTS)
@pytest.mark.parametrize("zc,bgn,batch,snr,group", [
    (12, 1, 40, -0.5, None),      # the decoder study's code
    (10, 1, 37, 0.0, 5),          # a batch that is no multiple of the group
    (16, 2, 30, 1.0, None),
    (80, 2, 20, -2.0, None),      # the small-allocation sweep's code
    (80, 2, 5, -8.0, 2),          # does not converge
    (112, 2, 6, -2.0, None),
    (2, 1, 300, 2.0, None),       # the smallest lifting, many per block
])
def test_ldpc_packed_kernel_matches_plain(cuda_device, zc, bgn, batch, snr,
                                          group, schedule, semantics):
    """ldpc_minsum_packed, all four variants, bit for bit; auto layout
    takes it for these liftings."""
    llr = _noisy_llrs(cuda_device, zc, bgn, batch, snr)
    ref = ldpc_dec._ldpc_decode_plain(llr, zc, bgn, 8, 0.8, 0.3, schedule,
                                      semantics)
    iters = torch.zeros(batch, dtype=torch.int32, device=cuda_device)
    plan = (None if group is None else ldpc_dec.plan_launch(
        bgn, zc, batch, schedule, "packed", group=group))
    got = ldpc_dec.ldpc_minsum_packed(llr, zc, bgn, 8, 0.8, 0.3, iters,
                                      schedule, semantics, plan)
    _assert_same_decode(got, ref)
    assert int(iters.min()) >= 0 and int(iters.max()) <= 8
    before = dict(kernels.LAUNCHES)
    got = ldpc_dec.ldpc_decode(llr, zc, bgn, 8, "min-sum", 0.8, 0.3,
                               schedule=schedule, semantics=semantics)
    assert kernels.LAUNCHES["ldpc_minsum_packed"] == \
        before["ldpc_minsum_packed"] + 1
    _assert_same_decode(got, ref)


def test_ldpc_packed_rejects_what_does_not_fit(cuda_device):
    assert ldpc_dec.packed_group_limit(384, 1) == 0
    llr = torch.zeros((2, 66 * 384), device=cuda_device)
    with pytest.raises(ValueError):
        ldpc_dec.ldpc_decode(llr, 384, 1, 2, layout="packed")
    llr = torch.zeros((2, 50 * 80), device=cuda_device)
    with pytest.raises(ValueError):
        ldpc_dec.ldpc_minsum_packed(llr, 80, 2, 2, plan=ldpc_dec.plan_launch(
            2, 80, 2, layout="packed", group=3))


# every lifting size the kernels' layouts treat differently: slices
# narrower than a warp, one warp, padded last warps (144, 176, 208, 240),
# clusters of several blocks (352, 384)
LIFTINGS = [2, 12, 16, 32, 80, 112, 144, 176, 208, 240, 352, 384]
ALL_VARIANTS = [("flooded", "exact")] + VARIANTS


def _forced(kern, llr, zc, bgn, schedule, semantics, **force):
    """kern on a launch forced through plan_launch (which raises
    ValueError where it does not fit)."""
    layout = "packed" if kern is ldpc_dec.ldpc_minsum_packed else "batch"
    plan = ldpc_dec.plan_launch(bgn, zc, llr.shape[0], schedule, layout,
                                **force)
    return kern(llr, zc, bgn, 5, 0.8, 0.3, schedule=schedule,
                semantics=semantics, plan=plan)


def _mixed_llrs(device, zc, bgn, batch, snr):
    """Noisy codewords, the last two replaced by LLRs that never converge
    (the final rule), one of them with zero LLRs (sign(0))."""
    llr = _noisy_llrs(device, zc, bgn, batch, snr)
    junk = 4.0 * np.random.default_rng(zc * bgn).standard_normal(
        (2, llr.shape[1]), dtype=np.float32)
    junk[1, ::7] = 0.0
    llr[-2:] = torch.as_tensor(junk, device=device)
    return llr


@pytest.mark.parametrize("schedule,semantics", ALL_VARIANTS)
@pytest.mark.parametrize("bgn", [1, 2])
@pytest.mark.parametrize("zc", LIFTINGS)
def test_ldpc_kernels_bit_exact_across_liftings(cuda_device, zc, bgn,
                                                 schedule, semantics):
    """Both kernels at their planned launch against the plain decoder,
    bit for bit in bits, ok and iteration counts."""
    llr = _mixed_llrs(cuda_device, zc, bgn, 6, 0.0)
    ref = ldpc_dec._ldpc_decode_plain(llr, zc, bgn, 6, 0.8, 0.3, schedule,
                                      semantics)
    kerns = [ldpc_dec.ldpc_minsum]
    if ldpc_dec.packed_group_limit(zc, bgn) >= 1:
        kerns.append(ldpc_dec.ldpc_minsum_packed)
    iters = []
    for kern in kerns:
        it = torch.zeros(6, dtype=torch.int32, device=cuda_device)
        _assert_same_decode(kern(llr, zc, bgn, 6, 0.8, 0.3, it, schedule,
                                 semantics), ref)
        iters.append(it)
    assert int(iters[0][-2:].min()) == 6
    assert all(torch.equal(i, iters[0]) for i in iters)


@pytest.mark.parametrize("zc,bgn", [(384, 1), (352, 2), (144, 1), (80, 2),
                                    (32, 2), (12, 1)])
def test_ldpc_kernels_with_forced_cluster_and_group(cuda_device, zc, bgn):
    """Every cluster size the lifting allows, groups across their range
    and LR in device memory, 7 codewords (a multiple of no group above 1):
    the same bits; a cluster or group that does not fit raises."""
    llr = _mixed_llrs(cuda_device, zc, bgn, 7, 0.0)
    slices = ldpc_dec.cluster_slices(zc)
    g_max = ldpc_dec.packed_group_limit(zc, bgn)
    for schedule, semantics in ALL_VARIANTS:
        ref = ldpc_dec._ldpc_decode_plain(llr, zc, bgn, 5, 0.8, 0.3,
                                          schedule, semantics)
        var = (llr, zc, bgn, schedule, semantics)
        for k, zl in slices.items():
            if ldpc_dec.smem_bytes(bgn, zc, 1, zl) > 232448:
                with pytest.raises(ValueError):
                    _forced(ldpc_dec.ldpc_minsum, *var, cluster=k)
                continue
            _assert_same_decode(
                _forced(ldpc_dec.ldpc_minsum, *var, cluster=k), ref)
            for g in sorted({1, 2, 3, g_max} & set(range(1, g_max + 1))):
                if ldpc_dec.smem_bytes(bgn, zc, g, zl) > 232448 or (
                        schedule == "layered" and zc <= 32 and k > 1):
                    continue
                _assert_same_decode(_forced(ldpc_dec.ldpc_minsum_packed,
                                            *var, cluster=k, group=g), ref)
        if g_max >= 1:
            _assert_same_decode(
                _forced(ldpc_dec.ldpc_minsum_packed, *var, threads=64), ref)
        # LR in device memory, LQ in one block
        _assert_same_decode(
            _forced(ldpc_dec.ldpc_minsum, *var, lr_on_chip=False), ref)


def test_ldpc_forced_launch_that_does_not_fit_raises(cuda_device):
    llr = torch.zeros((2, 66 * 384), device=cuda_device)
    for cluster in (1, 2, 4, 17):      # too large a slice, or no such K
        with pytest.raises(ValueError):
            _forced(ldpc_dec.ldpc_minsum, llr, 384, 1, "flooded", "exact",
                    cluster=cluster)
    big = ldpc_dec.plan_launch(1, 384, 2)
    llr = torch.zeros((2, 66 * 12), device=cuda_device)
    with pytest.raises(ValueError):
        _forced(ldpc_dec.ldpc_minsum_packed, llr, 12, 1, "flooded", "exact",
                group=13)
    with pytest.raises(ValueError):
        _forced(ldpc_dec.ldpc_minsum, llr, 12, 1, "flooded", "exact",
                threads=48)
    with pytest.raises(ValueError):     # a plan made for another code
        ldpc_dec.ldpc_minsum(llr, 12, 1, 2, plan=big)
    # the C entry refuses what the planner would never ask for, and the
    # wrapper's check raises: a slice that is no power of two
    lib = kernels.library("ldpc_minsum")
    tab = ldpc_dec._device_tables(1, 384, cuda_device)
    out = torch.empty((2, 68 * 384), dtype=torch.int8, device=cuda_device)
    ok = torch.empty(2, dtype=torch.bool, device=cuda_device)
    llr = torch.zeros((2, 66 * 384), device=cuda_device)
    rc = lib.ldpc_minsum(llr.data_ptr(), tab.data_ptr(), 2, 46, 68, 316, 32,
                         384, 2, 1.0, 0.0, 0, 0, 4, 96, 1024, None,
                         out.data_ptr(),
                         ok.data_ptr(), None,
                         torch.cuda.current_stream().cuda_stream)
    with pytest.raises(RuntimeError):
        kernels.check("ldpc_minsum", rc)


def test_bp_and_bit_flipping_on_card_match_cpu(cuda_device):
    llr = _noisy_llrs(cuda_device, 16, 2, 24, 3.0)
    got = ldpc_dec.ldpc_decode(llr, 16, 2, 8, "BP")
    ref = ldpc_dec.ldpc_decode(llr.cpu(), 16, 2, 8, "BP")
    assert torch.equal(got[1].cpu(), ref[1])
    conv = ref[1]
    assert conv.any() and torch.equal(got[0].cpu()[conv], ref[0][conv])
    full = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (40, 52 * 16), dtype=np.float32), device=cuda_device)
    full[:20] = 1.0 + 0.4 * full[:20]
    got = ldpc_dec.ldpc_decode_bf(full, 16, 2, 10)
    ref = ldpc_dec.ldpc_decode_bf(full.cpu(), 16, 2, 10)
    assert torch.equal(got[0].cpu(), ref[0])
    assert torch.equal(got[1].cpu(), ref[1]) and ref[1].any()


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
    assert kernels.LAUNCHES["fading_channel"] == 1


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


def test_small_alloc_sweep_goes_through_the_packed_kernel(cuda_device):
    from python_5gtoolbox_tpu_torch.sim import pdsch_throughput as sim
    carrier, pdsch, chan, ce, ldpc = sim.small_alloc_link_level_config()
    kernels.reset_launches()
    res = sim.run_pdsch_throughput(carrier, pdsch, chan, [25.0, -20.0],
                                   ["MMSE-IRC"], n_slots=4, ce_config=ce,
                                   ldpc_config=ldpc, device=cuda_device)
    assert res["MMSE-IRC"] == [1.0, 0.0] and res["tbs_bits"] == 736
    assert kernels.LAUNCHES["ldpc_minsum_packed"] == 2
    assert kernels.LAUNCHES["ldpc_minsum_flooded"] == 0


@pytest.mark.parametrize("tp", [1, 0])
def test_ul_sweep_goes_through_both_kernels(cuda_device, tp):
    from python_5gtoolbox_tpu_torch.sim import pusch_throughput as usim
    carrier, pusch, chan, ce, ldpc = usim.bench_link_level_pusch_tp_config()
    pusch["nTransPrecode"] = tp
    kernels.reset_launches()
    res = usim.run_pusch_throughput(carrier, pusch, chan, [25.0, -20.0],
                                    ["MMSE-IRC"], n_slots=4, ce_config=ce,
                                    ldpc_config=ldpc, device=cuda_device)
    assert res["MMSE-IRC"] == [1.0, 0.0] and res["tbs_bits"] == 2600
    assert kernels.LAUNCHES["banded_fir"] == 4
    assert kernels.LAUNCHES["ldpc_minsum_flooded"] == 2
    assert kernels.LAUNCHES["ldpc_minsum_packed"] == 0


def test_decoder_study_on_card_matches_cpu(cuda_device):
    from python_5gtoolbox_tpu_torch.sim import ldpc_decoder as study
    args = (12, 1, "24A", ["min-sum", "mixed-MS"], [], [], [[0.8, 0.3]],
            [16], [-1.0, 0.5], None)
    kernels.reset_launches()
    got = study.run_ldpc_simulation(*args, n_trials=64, device=cuda_device,
                                    schedule="layered")
    assert kernels.LAUNCHES["ldpc_minsum_packed"] == 4
    assert got == study.run_ldpc_simulation(*args, n_trials=64, device="cpu",
                                            schedule="layered")


# ---------------------------------------------------------------------------
# Polar decoder and UCI on PUSCH (plain PyTorch on the card; no kernel of
# their own): the card's decode equals the host's, and the UCI path runs
# the FIR and LDPC kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K,E,L,nmax,iil,clen,pad", [
    (164, 512, 8, 9, 1, 24, 0),       # bench_polar_scl: N 512, CRC24C
    (512, 1024, 8, 10, 0, 11, 0),     # N 1024, UL
    (64, 432, 8, 9, 1, 24, 1)])       # PDCCH candidates, per-row RNTI
def test_polar_decoder_on_card_matches_cpu(cuda_device, K, E, L, nmax, iil,
                                           clen, pad):
    from python_5gtoolbox_tpu_torch.ops import polar
    N, _ = polar.gen_n_value(K, E, nmax)
    rng = np.random.default_rng(K)
    llr = torch.as_tensor((rng.standard_normal((12, N)) * 2 + 1.5)
                          .astype(np.float32))
    rnti = torch.as_tensor(rng.integers(0, 2 ** 16, 12)) if pad else 0
    ref = polar.polar_decode_scl(llr, E, K, L, nmax, iil, clen, pad, rnti)
    # the first call captures the CUDA graph; later calls replay it, also
    # after other decodes have reused the memory around it
    for rep in range(3):
        got = polar.polar_decode_scl(
            llr.to(cuda_device), E, K, L, nmax, iil, clen, pad,
            rnti.to(cuda_device) if pad else 0)
        assert torch.equal(got[0].cpu(), ref[0])
        assert torch.equal(got[1].cpu(), ref[1])
        polar.polar_decode_scl(torch.randn(5, N, device=cuda_device), E, K,
                               L, nmax, iil, clen, 0, 0)


def test_polar_study_on_card_matches_cpu(cuda_device):
    from python_5gtoolbox_tpu_torch.sim import polar_decoder as study
    args = (study.K, study.E, study.N_MAX, study.I_IL, study.CRC_LEN,
            ["SC", "SCL"], [8], [1.0, 2.5], None)
    got = study.run_polar_simulation(*args, n_trials=64, device=cuda_device,
                                     verbose=False)
    assert got == study.run_polar_simulation(*args, n_trials=64,
                                             device="cpu", verbose=False)


def test_uci_on_pusch_on_card(cuda_device):
    """The CP-OFDM UL sweep's configuration with ACK 2 + CSI1 5 bits:
    per-slot TX through gen_ul_waveform, fading channel at 25 dB, batched
    UCI RX; every TB and UCI stream decodes to what was sent, through
    both kernels."""
    from python_5gtoolbox_tpu_torch.interop import state_from_numpy
    from python_5gtoolbox_tpu_torch.sim import pdsch_throughput as sim
    from python_5gtoolbox_tpu_torch.sim import pusch_throughput as usim
    carrier, pusch, chan, ce, ldpc = usim.bench_link_level_pusch_tp_config()
    pusch.update(nTransPrecode=0, EnableACK=1, NumACKBits=2, ACKbits=[1, 0],
                 EnableCSI1=1, NumCSI1Bits=5, CSI1bits=[1, 0, 1, 1, 0])
    trblks = np.random.default_rng(1).integers(0, 2, (4, 2600), np.int8)
    kernels.reset_launches()
    obj, slots, rx_fd = usim.pusch_before_ceq_processing(
        carrier, pusch, chan, -25.0, 4, seed=1, device=cuda_device,
        state=state_from_numpy(trblks=trblks, device=cuda_device))
    stack = rx_fd.reshape(carrier["Nr"], 4, -1).transpose(0, 1)
    ok, tbblk, uci = obj.rx_process_batch(
        stack, slots, {"algo": "MMSE-IRC"}, ldpc,
        sim._ce_config(ce, chan, carrier["scs"]))
    assert ok.all() and np.array_equal(tbblk, trblks)
    for name, sent in (("ack", [1, 0]), ("csi1", [1, 0, 1, 1, 0])):
        assert uci[name][1].all()
        np.testing.assert_array_equal(uci[name][0], np.tile(sent, (4, 1)))
    assert kernels.LAUNCHES["banded_fir"] == 2
    assert kernels.LAUNCHES["ldpc_minsum_flooded"] == 1


def test_polar_counters_on_card(cuda_device):
    """Under a StageProfiler on the card the UCI polar decoder counts its
    blocks (rows x code blocks), its failed CRCs (summed on the card) and
    the CUDA graphs captured: 1 for a new shape, 0 for each replay; no
    profiler, no count."""
    from python_5gtoolbox_tpu_torch.phy.pusch_uci import encode_uci_rows
    from python_5gtoolbox_tpu_torch.rx.batch_core import make_uci_decoder
    from python_5gtoolbox_tpu_torch.utils.profiling import StageProfiler

    bits = torch.randint(0, 2, (6, 40), dtype=torch.int8,
                         generator=torch.Generator().manual_seed(40))
    llr = 4.0 * (1.0 - 2.0 * encode_uci_rows(bits, 40, 636, 6).float())
    llr[5] = -llr[5]                        # one block that fails its CRC
    bits, llr = bits.to(cuda_device), llr.to(cuda_device)
    dec = make_uci_decoder(40, 636, 6)
    prof = StageProfiler(cuda_device)
    with prof.stage("rx.ratematch"):
        for rows in (6, 6, 3):              # capture, replay, capture
            got, ok = dec(llr[:rows])
    assert torch.equal(got[:3], bits[:3]) and bool(ok[:3].all())
    assert prof.counters == {"polar_blocks": 15, "uci_crc_fail": 2,
                             "polar_graph_captures": 2}
    assert prof.stats["rx.uci.polar"].calls == 3
    other = StageProfiler(cuda_device)
    dec(llr)                                # replayed, no profiler open
    assert other.counters == {}


def test_testmodel_full_width_on_card(cuda_device):
    """TM3.1a at scs 30 / BW 100 / TDD (40 slots, 122.88 Msps): exactly
    one banded_fir launch (287 taps on 2x2457600 planes), dl equal to the
    plain FIR on the returned td, fd equal to the CPU run's."""
    from python_5gtoolbox_tpu_torch.sim import gen_nr_testmodel as tscript
    from python_5gtoolbox_tpu_torch.waveform import dl as dl_wf

    def run(device):
        wf, carrier, lists = tscript.tm_channel_lists(
            "NR-FR1-TM3.1a", tscript.FULL_WIDTH, seed=2, device=device)
        return dl_wf.gen_dl_waveform(wf, carrier, *lists)
    kernels.reset_launches()
    fd, td, dl, _ = run(cuda_device)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["banded_fir"] == 1
    assert sum(kernels.LAUNCHES.values()) == 1
    assert dl.shape == td.shape == (1, 2457600)
    ref = filters.banded_fir_plain(torch.cat([td.real, td.imag]),
                                   filters.fir_coeff(*tscript.FULL_WIDTH[:2]),
                                   "same")
    assert (dl - torch.complex(ref[:1], ref[1:])).abs().max() < 1.2e-4
    fd_cpu = run("cpu")[0]
    assert (fd.cpu() - fd_cpu).abs().max() <= 1e-5


def test_dl_multichannel_245_on_card(cuda_device):
    """SSB + CSI-RS + PDCCH + PDSCH, 2 antennas, scs 30 / BW 40, 20 slots
    at 245.76 Msps: one fir_up2_fused and one banded_fir up2, dl equal to
    the plain chain on the returned td."""
    from python_5gtoolbox_tpu_torch.sim import gen_nr_testmodel as tscript
    from python_5gtoolbox_tpu_torch.waveform import dl as dl_wf
    kw = tscript.dl_multichannel_config(n_slots=20, samplerate_in_mhz=245.76)
    wf, carrier = kw.pop("waveform_config"), kw.pop("carrier_config")
    kernels.reset_launches()
    lists = dl_wf.gen_dl_channel_list(wf, carrier, **kw, device=cuda_device)
    fd, td, dl, _ = dl_wf.gen_dl_waveform(wf, carrier, *lists)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fir_up2_fused"] == 1
    assert kernels.LAUNCHES["banded_fir"] == 1
    assert sum(kernels.LAUNCHES.values()) == 2
    hb = filters.halfband_coeff()
    ref = filters.fir_up2_fused_plain(torch.cat([td.real, td.imag]),
                                      filters.fir_coeff(30, 40), hb)
    ref = filters.banded_fir_plain(ref, hb, "up2")
    assert dl.shape == (2, 4 * td.shape[1])
    assert (dl - torch.complex(ref[:2], ref[2:])).abs().max() < 1.2e-4


def test_ssb_waveform_gen_on_card(cuda_device):
    """NrSSB.waveform_gen at 245.76 Msps (ifftsize 8192), card == CPU."""
    from python_5gtoolbox_tpu_torch.phy.ssb import NrSSB
    from python_5gtoolbox_tpu_torch.utils.config import (get_default_config,
                                                         merged)
    carrier = merged(get_default_config("dl_carrier"), dict(num_of_ant=2))
    wf = dict(samplerate_in_mhz=245.76, numofslots=4, startSFN=0,
              startslot=0)
    td = NrSSB(carrier, get_default_config("ssb"),
               device=cuda_device).waveform_gen(wf)
    td_cpu = NrSSB(carrier, get_default_config("ssb"),
                   device="cpu").waveform_gen(wf)
    assert td.shape == td_cpu.shape == (2, 4 * 15 * 8192)
    assert (td.cpu() - td_cpu).abs().max() <= 1e-5
    assert td_cpu.abs().max() > 0


# --- receiver breadth: per-slot RX, ML equalizers, DCT CE, TDL -------------

def _bench_point(device, snr=20.0, n_slots=2, seed=3, state=None):
    from python_5gtoolbox_tpu_torch.sim import pdsch_throughput as sim
    carrier, pdsch, chan, ce, ldpc = sim.bench_link_level_config()
    obj, slots, rx_fd = sim.pdsch_before_ceq_processing(
        carrier, pdsch, chan, -snr, n_slots, seed=seed, device=device,
        state=state)
    return obj, slots, rx_fd, sim._ce_config(ce, chan, 30), ldpc


def test_per_slot_rx_on_card_matches_cpu(cuda_device):
    """The per-slot RX (H_LS_est, NrChannelEstimation, RX_process with
    MMSE-IRC and ML2-IRC-soft) on the same received slots (the card's
    front end on pinned blocks): flags and TB bits card == CPU, one
    ldpc_minsum launch per slot."""
    from python_5gtoolbox_tpu_torch.interop import state_from_numpy
    from python_5gtoolbox_tpu_torch.phy.pdsch import Pdsch
    from python_5gtoolbox_tpu_torch.sim import pdsch_throughput as sim
    blocks = np.random.default_rng(1).integers(0, 2, (2, 3240),
                                               dtype=np.int8)
    obj, slots, rx_fd, ce, ldpc = _bench_point(
        cuda_device, snr=0.0, state=state_from_numpy(trblks=blocks,
                                                     device=cuda_device))
    cpu = Pdsch(obj.cfg, obj.carrier, device="cpu")
    for algo in ("MMSE-IRC", "ML2-IRC-soft"):
        before = kernels.LAUNCHES["ldpc_minsum_flooded"]
        card = sim.rx_slots(obj, sim.slot_estimates(obj, slots, rx_fd, [0, 1],
                                                    ce), algo, ldpc)
        assert kernels.LAUNCHES["ldpc_minsum_flooded"] == before + 2
        host = sim.rx_slots(cpu, sim.slot_estimates(cpu, slots, rx_fd.cpu(),
                                                    [0, 1], ce), algo, ldpc)
        for a, b in zip(card, host):
            assert bool(a[0]) == bool(b[0])
            assert torch.equal(a[1].cpu(), b[1])


def test_per_slot_rx_numpy_input_goes_to_the_card(cuda_device):
    """The per-slot RX functions given numpy run on the card, as every
    entry point's default device: the LS estimate of one bench slot
    equals the one from a CPU tensor, and the resource copy, the channel
    estimate and the DL-SCH / UL-SCH / UCI decodes return card tensors."""
    from python_5gtoolbox_tpu_torch.phy import pdsch_rx as drx
    from python_5gtoolbox_tpu_torch.phy import pusch_rx as urx
    from python_5gtoolbox_tpu_torch.rx.channel_estimate import \
        NrChannelEstimation
    obj, slots, rx_fd, ce, ldpc = _bench_point(cuda_device, snr=20.0,
                                               n_slots=1)
    rx = rx_fd.cpu().numpy()
    h, info = drx.pdsch_dmrs_ls_est(rx, obj.cfg, slots[0])
    h_ref, _ = drx.pdsch_dmrs_ls_est(torch.as_tensor(rx), obj.cfg, slots[0])
    assert h.is_cuda and h_ref.device.type == "cpu"
    assert (h.cpu() - h_ref).abs().max() <= 1e-5 * h_ref.abs().max()
    assert drx.copy_rx_pdsch_resource(rx, obj.cfg)[0].is_cuda
    H, cov = NrChannelEstimation(h_ref.numpy(), dict(info, scs=30),
                                 dict(ce)).channel_est()
    assert H.is_cuda and cov.is_cuda
    llr = np.zeros(2304, np.float32)
    for out in (drx.dlsch_decode(llr, 2536, 2, 193, 1, 0, 10 ** 9, ldpc),
                urx.ulsch_decode(llr, 2536, 2, 193, 1, 0, ldpc)):
        assert out[0].is_cuda and out[1].is_cuda and out[2].is_cuda
    assert urx.decode_uci_on_ulsch(np.zeros(64, np.float32), 5, 2)[0].is_cuda


def test_ml_equalizers_on_card_match_cpu(cuda_device):
    from python_5gtoolbox_tpu_torch.rx import equalize as teq
    rng = np.random.default_rng(2)
    n, nr, nl = 300, 4, 2
    h = (rng.normal(size=(n, nr, nl)) + 1j * rng.normal(size=(n, nr, nl)))
    s = np.exp(2j * np.pi * rng.integers(4, size=(n, nl)) / 4 + 0.25j * np.pi)
    y = np.einsum("nrl,nl->nr", h, s) + 0.1 * (
        rng.normal(size=(n, nr)) + 1j * rng.normal(size=(n, nr)))
    a = 0.2 * (rng.normal(size=(n, nr, nr)) + 1j * rng.normal(size=(n, nr, nr)))
    cov = a @ a.conj().transpose(0, 2, 1) / 8 + 0.05 * np.eye(nr)
    args = [v.astype(np.complex64) for v in (y, h, cov)]
    for algo in teq.ML_EQUALIZERS:
        for mod in ("qpsk", "16qam"):
            card = teq.channel_equ_and_demod(*args, mod, {"algo": algo},
                                             device=cuda_device)
            host = teq.channel_equ_and_demod(*args, mod, {"algo": algo},
                                             device="cpu")
            assert torch.equal(card[2].cpu(), host[2]), (algo, mod)
            assert (card[3].cpu() - host[3]).abs().max() \
                <= 1e-3 * host[3].abs().max(), (algo, mod)


@pytest.mark.parametrize("algo", ["DCT", "DCT_symmetric"])
def test_dct_ce_on_card_matches_cpu(cuda_device, algo):
    from python_5gtoolbox_tpu_torch.rx import ce_batch
    from python_5gtoolbox_tpu_torch.rx.channel_estimate import \
        NrChannelEstimation
    obj, slots, rx_fd, ce, _ = _bench_point(cuda_device, snr=10.0, n_slots=1)
    h_ls, info = obj.H_LS_est(rx_fd, slots[0])
    cfg = dict(ce, CE_algo=algo)
    for kind in ("per_slot", "batched"):
        got = []
        for dev in (cuda_device, "cpu"):
            h = h_ls.to(dev)
            if kind == "per_slot":
                H, cov = NrChannelEstimation(h, dict(info), dict(cfg)) \
                    .channel_est()
            else:
                out = ce_batch.channel_est_batch(h[None], info, dict(cfg))
                H, cov = out["H"][0], out["cov"][0]
            got.append((H.cpu(), cov.cpu()))
        for a, b in zip(*got):
            assert (a - b).abs().max() <= 1e-4 * b.abs().max(), kind


def test_tdl_filter_on_card_matches_cpu(cuda_device):
    from python_5gtoolbox_tpu_torch.models import channel as chan_mod
    from python_5gtoolbox_tpu_torch.interop import state_from_numpy
    cfg = chan_mod.gen_channel_model_config(
        model_format="TDL-A", Nt=1, Nr=2, fm_inHz=200, DSdesired=30,
        Rspat_config=("low", "uniform", "UL", (0, 0)))
    n, fs = 30720, 30.72e6
    gen = torch.Generator().manual_seed(4)
    taps = [chan_mod.gen_mimo_channel(gen, 1, 2, np.asarray(cfg["Rspat"]), n,
                                      fs, p[2], p[3], p[4], 200, 30).numpy()
            for p in cfg["multi_paths"]]
    rng = np.random.default_rng(5)
    noise = (rng.standard_normal((2, n)), rng.standard_normal((2, n)))
    tx = (rng.standard_normal((1, n)) + 1j * rng.standard_normal((1, n))
          ).astype(np.complex64)
    out = []
    for dev in (cuda_device, "cpu"):
        st = state_from_numpy(taps=taps, noise=noise, device=dev)
        model = chan_mod.NrChannelModel(cfg, -10.0, 3.5e9, fs, 30, device=dev)
        out.append(model.filter(torch.as_tensor(tx, device=dev),
                                taps=st["taps"], noise=st["noise"]).cpu())
    assert (out[0] - out[1]).abs().max() <= 1e-5 * out[1].abs().max()


# --- the fading channel: csrc/fading_channel.cu against the plain loop ---
#
# Both run the same filter() on the same seed: the kernel path and
# filter_plain draw the same uniforms, in the same order, so their
# generators agree afterwards and so do the AWGN draws. Tolerance 1e-5 of
# the largest output magnitude: a term is a hardware cosine (absolute
# error ~4e-7) of the argument the plain path rounds, where the plain path
# takes an accurate cosine; 30 such terms a link and the L mix stay near
# 1e-6 of a tap.

FADING_CASES = {
    # the TDL cells' channel (TDL-A 30 ns, fm 10 Hz) at one slot and one
    # 20-slot point of 122.88 Msps
    "tdla30_2x4_slot": ("TDL-A", 2, 4, 61440, dict(DSdesired=30,
                                                    fm_inHz=10)),
    "tdla30_2x4_point": ("TDL-A", 2, 4, 1228800, dict(DSdesired=30,
                                                       fm_inHz=10)),
    # a Rician LOS path
    "tdld_1x2": ("TDL-D", 1, 2, 61440, dict(
        DSdesired=300, fm_inHz=200,
        Rspat_config=("low", "uniform", "UL", (0, 0)))),
    # the ML cell's one tap at fm 200 Hz
    "one_tap_fm200_2x4": ("customized", 2, 4, 1228800, dict(
        fm_inHz=200, multi_paths=[[0, 0, "Rayleigh", 0, 0]])),
    # timing and frequency errors, correlated antennas
    "timeoff_rho_2x4": ("TDL-A", 2, 4, 61440, dict(
        DSdesired=300, fm_inHz=100, Timeoff_ns=120, rho=2e-6,
        Rspat_config=("medium", "uniform", "DL", (0, 0)))),
}


def _fading_models(device, case, pnoise_db=-20.0, seed=11):
    from python_5gtoolbox_tpu_torch.models import channel as chan_mod
    fmt, nt, nr, n, kw = FADING_CASES[case]
    kw = dict(kw)
    kw.setdefault("Rspat_config", ("customized", "uniform", "DL", (0, 0)))
    cfg = chan_mod.gen_channel_model_config(model_format=fmt, Nt=nt, Nr=nr,
                                            **kw)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    tx = torch.complex(torch.randn((nt, n), generator=gen, device=device),
                       torch.randn((nt, n), generator=gen, device=device))
    return cfg, tx, [chan_mod.NrChannelModel(cfg, pnoise_db, 3.5e9, 122.88e6,
                                             30, seed=seed, device=device)
                     for _ in range(2)]


@pytest.mark.parametrize("case", list(FADING_CASES))
def test_fading_kernel_matches_the_plain_loop(cuda_device, case):
    from python_5gtoolbox_tpu_torch.utils.profiling import StageProfiler
    cfg, tx, (kern, plain) = _fading_models(cuda_device, case)
    before = dict(kernels.LAUNCHES)
    prof = StageProfiler(cuda_device)
    with prof.stage("channel"):
        got = kern.filter(tx)
    ref = plain.filter_plain(tx)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == dict(before, fading_channel=before[
        "fading_channel"] + 1)
    assert prof.counters == {"fading_kernel_paths": len(cfg["multi_paths"])}
    assert got.shape == ref.shape == (cfg["Nr"], tx.shape[1])
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()
    assert torch.equal(torch.rand(8, generator=kern.gen, device=cuda_device),
                       torch.rand(8, generator=plain.gen, device=cuda_device))


def test_fading_kernel_refuses_or_routes_what_it_does_not_take(cuda_device):
    """The wrapper refuses another device, dtype, shape or layout; filter
    sends more than 16 links, and pre-drawn taps, to the plain loop and
    counts them there."""
    from python_5gtoolbox_tpu_torch.models import channel as chan_mod
    from python_5gtoolbox_tpu_torch.utils.profiling import StageProfiler
    cfg, tx, (m, _) = _fading_models(cuda_device, "tdla30_2x4_slot")
    paths = m.multi_paths
    draws, draws0 = chan_mod.fading_draws(m.gen, paths, 8, m.n_sin)
    consts = chan_mod.fading_constants(m.rspat, paths, m.fs, cuda_device)
    w, amp = 2 * np.pi * m.fm / m.fs, np.sqrt(2 / m.n_sin)
    ok = chan_mod.fading_channel(tx, draws, draws0, consts, 4, w, amp)
    assert ok.shape == (4, tx.shape[1])
    wide = torch.zeros((2, 2 * tx.shape[1]), dtype=torch.complex64,
                       device=cuda_device)
    for bad in (dict(tx=tx.cpu()), dict(consts=consts.cpu()),
                dict(tx=tx.to(torch.complex128)), dict(draws=draws.double()),
                dict(tx=wide[:, ::2]), dict(nr=2), dict(draws0=draws0[:1]),
                dict(consts=consts[:-1])):
        args = dict(tx=tx, draws=draws, draws0=draws0, consts=consts, nr=4,
                    w=w, amp=amp)
        args.update(bad)
        with pytest.raises(ValueError):
            chan_mod.fading_channel(**args)
    wide_cfg = chan_mod.gen_channel_model_config(
        model_format="customized", Nt=4, Nr=8, fm_inHz=200,
        multi_paths=[[0, 0, "Rayleigh", 0, 0]])
    model = chan_mod.NrChannelModel(wide_cfg, -20.0, 3.5e9, 30.72e6, 30,
                                    device=cuda_device)
    taps = [torch.zeros((3000, 4, 2), dtype=torch.complex64,
                        device=cuda_device)] * len(paths)
    before = kernels.LAUNCHES["fading_channel"]
    prof = StageProfiler(cuda_device)
    with prof.stage("channel"):
        model.filter(torch.ones((4, 3000), dtype=torch.complex64,
                                device=cuda_device))
        m.filter(tx[:, :3000], taps=taps)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fading_channel"] == before
    assert prof.counters == {"fading_plain_paths": 1 + len(paths)}


def test_ml_irc_whitening_in_eigh_batches_on_card(cuda_device):
    """More 4x4 covariances than one cuSOLVER batched eigh takes
    (equalize.EIGH_BATCH at a time): ML-IRC hard bits and LLRs card ==
    CPU."""
    from python_5gtoolbox_tpu_torch.rx import equalize as teq
    rng = np.random.default_rng(3)
    n, nr, nl = 2 * teq.EIGH_BATCH + 100, 4, 2
    h = rng.normal(size=(n, nr, nl)) + 1j * rng.normal(size=(n, nr, nl))
    s = np.exp(2j * np.pi * rng.integers(4, size=(n, nl)) / 4 + 0.25j * np.pi)
    y = np.einsum("nrl,nl->nr", h, s) + 0.1 * (
        rng.normal(size=(n, nr)) + 1j * rng.normal(size=(n, nr)))
    a = 0.2 * (rng.normal(size=(n, nr, nr)) + 1j * rng.normal(size=(n, nr, nr)))
    cov = a @ a.conj().transpose(0, 2, 1) / 8 + 0.05 * np.eye(nr)
    args = [v.astype(np.complex64) for v in (y, h, cov)]
    card = teq.channel_equ_and_demod(*args, "qpsk", {"algo": "ML-IRC-soft"},
                                     device=cuda_device)
    host = teq.channel_equ_and_demod(*args, "qpsk", {"algo": "ML-IRC-soft"},
                                     device="cpu")
    assert torch.equal(card[2].cpu(), host[2])
    assert (card[3].cpu() - host[3]).abs().max() <= 1e-3 * host[3].abs().max()


# --- ML2's search: csrc/ml2_maxlog.cu against the plain search ------------
#
# Tolerance: the kernel sums |(y - h0 c0) - h1 c1|^2 as re^2 + im^2 with
# FMAs, the plain search |y - (h0 c0 + h1 c1)| by hypot, squared; each
# metric takes a few FP32 roundings of its own size either way (~1e-6
# relative), and an LLR is a difference of two metrics, so LLRs and the
# least metric are held within 1e-4 of their largest magnitude. The best
# candidate is the first of least metric in both; where the two
# arithmetics disagree it must be a tie within that rounding.

def _ml2_inputs(rng, n, nr, nl, modtype, snr_amp=0.1):
    from python_5gtoolbox_tpu_torch.rx import equalize as teq
    syms, _ = teq.constellation(modtype)
    h = (rng.normal(size=(n, nr, nl)) + 1j * rng.normal(size=(n, nr, nl))) \
        / np.sqrt(2)
    s = syms[rng.integers(len(syms), size=(n, nl))]
    y = np.einsum("nrl,nl->nr", h, s) + snr_amp * (
        rng.normal(size=(n, nr)) + 1j * rng.normal(size=(n, nr)))
    a = 0.2 * (rng.normal(size=(n, nr, nr)) + 1j * rng.normal(size=(n, nr, nr)))
    cov = a @ a.conj().transpose(0, 2, 1) / 8 + 0.05 * np.eye(nr)
    return [v.astype(np.complex64) for v in (y, h, cov)]


def _ml2_search_pair(device, y, h, cov, modtype, irc):
    """The kernel's and the plain search's (best, min_lv, llr) on the same
    whitened inputs, and those inputs; the kernel launched once."""
    from python_5gtoolbox_tpu_torch.rx import equalize as teq
    y, h, cov = (torch.as_tensor(v, device=device) for v in (y, h, cov))
    yw, hw, cw = teq._whitened(y, h, cov, irc)
    s2 = teq._sigma2(cw)
    before = kernels.LAUNCHES["ml2_maxlog"]
    got = teq.ml2_maxlog(yw.contiguous(), hw.contiguous(), s2.contiguous(),
                         modtype)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ml2_maxlog"] == before + 1
    return got, teq.ml2_maxlog_plain(yw, hw, s2, modtype), (yw, hw, s2)


def _assert_ml2_search_close(got, ref, inputs, modtype):
    """-> the number of REs whose best candidates differ (ties)."""
    from python_5gtoolbox_tpu_torch.rx import equalize as teq
    best, min_lv, llr = got
    rbest, rmin, rllr = ref
    assert (llr - rllr).abs().max() <= 1e-4 * rllr.abs().max()
    assert (min_lv - rmin).abs().max() <= 1e-4 * rmin.abs().max()
    differ = torch.nonzero(best != rbest)[:, 0]
    if len(differ):
        yw, hw, s2 = inputs
        cand = torch.as_tensor(teq._candidates(modtype, hw.shape[-1])[1],
                               device=yw.device)
        lv = teq._distances(yw[differ], hw[differ], cand) / s2[differ, None]
        pick = lv.gather(1, best[differ, None])[:, 0]
        # a tie within float rounding: the kernel's pick scores the plain
        # minimum to a few ulps in the plain arithmetic
        assert ((pick - rmin[differ]).abs()
                <= 1e-5 * rmin[differ].abs() + 1e-30).all(), differ
    return len(differ)


@pytest.mark.parametrize("irc", [False, True])
@pytest.mark.parametrize("case", [0, 1, 2])
def test_ml2_kernel_on_the_goldens(cuda_device, case, irc):
    """The equalize_ml2_cases inputs (16QAM; 2x2, 4x2 and 4x1): ml2 goes
    through the kernel once and its hard bits equal the plain search's,
    LLRs within 1e-4 of their scale."""
    import pathlib
    from python_5gtoolbox_tpu_torch.rx import equalize as teq
    path = pathlib.Path(__file__).parent / "golden" / \
        "equalize_ml2_cases.npz"
    with np.load(path) as z:
        y, h, cov = (z[f"{v}_{case}"].astype(np.complex64)
                     for v in ("y", "h", "cov"))
    args = [torch.as_tensor(v, device=cuda_device) for v in (y, h, cov)]
    before = kernels.LAUNCHES["ml2_maxlog"]
    got = teq.ml2(*args, "16qam", irc=irc)
    assert kernels.LAUNCHES["ml2_maxlog"] == before + 1
    ref = teq.ml2_plain(*args, "16qam", irc=irc)
    assert torch.equal(got[2], ref[2]) and torch.equal(got[0], ref[0])
    assert (got[3] - ref[3]).abs().max() <= 1e-4 * ref[3].abs().max()
    assert _assert_ml2_search_close(*_ml2_search_pair(
        cuda_device, y, h, cov, "16qam", irc), "16qam") == 0


def test_ml2_kernel_full_slot(cuda_device):
    """A full bench slot's worth of REs at the cell's shape: 36,036 REs,
    64QAM, 2 layers, 4 RX, IRC, in one launch."""
    rng = np.random.default_rng(11)
    y, h, cov = _ml2_inputs(rng, 36036, 4, 2, "64qam")
    ties = _assert_ml2_search_close(*_ml2_search_pair(
        cuda_device, y, h, cov, "64qam", True), "64qam")
    assert ties <= 3


@pytest.mark.parametrize("modtype,nl,nr,n", [
    ("qpsk", 2, 4, 4001), ("256qam", 2, 4, 1027), ("16qam", 2, 4, 999),
    ("qpsk", 1, 4, 513), ("16qam", 1, 2, 257), ("64qam", 1, 4, 1001),
    ("256qam", 1, 4, 1003), ("64qam", 2, 1, 301), ("64qam", 2, 3, 302),
    ("64qam", 2, 8, 303), ("bpsk", 2, 2, 37), ("64qam", 2, 4, 1),
    ("16qam", 2, 4, 6)])
def test_ml2_kernel_shapes(cuda_device, modtype, nl, nr, n):
    """Every constellation and both layer counts, 1 to 8 RX antennas (3
    padded to 4), N ragged against the block's 4 REs."""
    rng = np.random.default_rng(n)
    y, h, cov = _ml2_inputs(rng, n, nr, nl, modtype)
    for irc in (False, True):
        ties = _assert_ml2_search_close(*_ml2_search_pair(
            cuda_device, y, h, cov, modtype, irc), modtype)
        assert ties <= 1


def test_ml2_kernel_first_minimum_on_a_tie(cuda_device):
    """y = 0, h0 = e_0, h1 = e_1 (64QAM, 4 RX): d(i, j) = |c_i|^2 + |c_j|^2
    exactly in both arithmetics, so the 16 pairs of inner points tie; both
    pick the first of them in row-major order. A random RE beside it."""
    from python_5gtoolbox_tpu_torch.rx import equalize as teq
    rng = np.random.default_rng(5)
    y, h, cov = _ml2_inputs(rng, 2, 4, 2, "64qam")
    y[0] = 0
    h[0] = 0
    h[0, 0, 0] = h[0, 1, 1] = 1
    cov[0] = np.eye(4)
    got, ref, (yw, hw, s2) = _ml2_search_pair(cuda_device, y, h, cov,
                                              "64qam", False)
    lv = teq._distances(yw[:1], hw[:1], torch.as_tensor(
        teq._candidates("64qam", 2)[1], device=cuda_device))[0]
    assert int((lv == lv.min()).sum()) == 16
    assert int(got[0][0]) == int(ref[0][0]) == int(torch.argmin(lv))
    assert _assert_ml2_search_close(got, ref, (yw, hw, s2), "64qam") == 0


def test_ml2_kernel_rejects_what_it_does_not_take(cuda_device):
    from python_5gtoolbox_tpu_torch.rx import equalize as teq
    y, h, cov = (torch.as_tensor(v, device=cuda_device) for v in
                 _ml2_inputs(np.random.default_rng(1), 8, 4, 2, "qpsk"))
    s2 = torch.ones(8, device=cuda_device)
    with pytest.raises(ValueError):
        teq.ml2_maxlog(y, h.transpose(1, 2).contiguous().transpose(1, 2),
                       s2, "qpsk")
    with pytest.raises(ValueError):
        teq.ml2_maxlog(y.to(torch.complex128), h, s2, "qpsk")
    with pytest.raises(ValueError):
        teq.ml2_maxlog(y.cpu(), h.cpu(), s2.cpu(), "qpsk")
    h3 = torch.cat([h, h[..., :1]], dim=-1)
    with pytest.raises(ValueError):
        teq.ml2_maxlog(y, h3, s2, "qpsk")
    # three layers on the card take the plain search, no launch
    before = kernels.LAUNCHES["ml2_maxlog"]
    teq.ml2(y, h3, cov, "qpsk", irc=True)
    assert kernels.LAUNCHES["ml2_maxlog"] == before


# --- UL control and PRACH ---------------------------------------------------

def test_ul_control_waveform_on_card_matches_cpu(cuda_device):
    """PUSCH + PUCCH formats 0-4 + a 4-port SRS (ul_multichannel_config,
    scs 30 / BW 40, 4 antennas, 4 slots at 245.76 Msps): one
    fir_up2_fused and one banded_fir up2, fd equal to the CPU's, dl
    within 1.2e-4 of the CPU's (the plain chain); the list without the
    PUSCH too."""
    from python_5gtoolbox_tpu_torch.sim.gen_nr_testmodel import \
        ul_multichannel_config
    from python_5gtoolbox_tpu_torch.waveform import ul as ul_wf
    for with_pusch in (True, False):
        kw = ul_multichannel_config(bw=40, n_slots=4)
        if not with_pusch:
            kw["pusch_config_list"] = []
        wf, carrier = kw.pop("waveform_config"), kw.pop("carrier_config")
        outs = {}
        for dev in (cuda_device, torch.device("cpu")):
            kernels.reset_launches()
            lists = ul_wf.gen_ul_channel_list(wf, carrier, **kw, seed=2,
                                              device=dev)
            outs[dev.type] = ul_wf.gen_ul_waveform(wf, carrier, *lists)
            if dev.type == "cuda":
                torch.cuda.synchronize()
                assert kernels.LAUNCHES["fir_up2_fused"] == 1
                assert kernels.LAUNCHES["banded_fir"] == 1
                assert sum(kernels.LAUNCHES.values()) == 2
        (fd, td, ul), (fd_c, td_c, ul_c) = outs["cuda"], outs["cpu"]
        assert ul.shape == (4, 4 * td.shape[1])
        assert (fd.cpu() - fd_c).abs().max() <= 1e-5
        assert (ul.cpu() - ul_c).abs().max() < 1.2e-4
        assert fd_c.abs().max() > 0


@pytest.mark.parametrize("shape", [(8, 307200), (8, 614400), (4, 3001)])
def test_prach_halfband_kernel_matches_plain(cuda_device, shape):
    """banded_fir up2 with the PRACH chain's 56-tap halfband (the one even
    tap count) at the PRACH stage shapes and a ragged row."""
    gen = torch.Generator(device=cuda_device).manual_seed(shape[1])
    x = torch.randn(shape, generator=gen, device=cuda_device)
    before = kernels.LAUNCHES["banded_fir"]
    got = filters.banded_fir(x, prach_halfband(), "up2")
    ref = filters.banded_fir_plain(x, prach_halfband(), "up2")
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["banded_fir"] == before + 1
    assert _max_err(got, ref) < 1.2e-4


@pytest.mark.parametrize("index,duplex,msg1,sub", [(16, "FDD", 15, 1),
                                                   (77, "TDD", 30, 9)])
def test_prach_waveform_on_card_matches_cpu(cuda_device, index, duplex,
                                            msg1, sub):
    """gen_prach_waveform at 245.76 Msps (4 SFNs for 20 slots at scs 30):
    three banded_fir up2 launches, td within 1.2e-4 of the CPU's, the
    preamble data equal."""
    from python_5gtoolbox_tpu_torch.phy import prach
    from python_5gtoolbox_tpu_torch.utils.config import (get_default_config,
                                                         merged)
    base = get_default_config("prach")
    carrier = merged(get_default_config("ul_carrier"),
                     dict(BW=100, duplex_type=duplex))
    wf = merged(get_default_config("ul_waveform"),
                dict(samplerate_in_mhz=245.76))
    cfg = merged(base["config"], dict(prach_ConfigurationIndex=index,
                                      msg1_SubcarrierSpacing=msg1))
    par = merged(base["parameters"], dict(PRACH_subframe=sub))
    kernels.reset_launches()
    td, data = prach.gen_prach_waveform(wf, carrier, cfg, par,
                                        device=cuda_device)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["banded_fir"] == 3
    assert sum(kernels.LAUNCHES.values()) == 3
    td_c, data_c = prach.gen_prach_waveform(wf, carrier, cfg, par,
                                            device="cpu")
    assert td.shape == td_c.shape == (1, 4 * 2457600)
    assert data_c.shape[0] > 0 and torch.equal(data.cpu(), data_c)
    assert (td.cpu() - td_c).abs().max() < 1.2e-4


def test_csirs_report_example_on_card_matches_cpu(cuda_device, tmp_path):
    """sim/nr_csirs_report_example.py at one SNR point and one test: the
    same RI, PMI and CQI on the card and on the CPU for the same seed."""
    from python_5gtoolbox_tpu_torch.sim import nr_csirs_report_example as ex
    config = dict(ex.example_config(), snr_db_list=[10.0], total_tests=1)
    rows = {dev: ex.run_csirs_report(config, dev, seed=1)
            for dev in (cuda_device, "cpu")}
    card, cpu = rows[cuda_device], rows["cpu"]
    assert len(card) == len(cpu) == 1
    for key in ("RI", "PMI", "CQI", "subband_CQI"):
        assert card[0][key] == cpu[0][key], key


def test_stage_profiler_times_stages_with_events(cuda_device):
    """StageProfiler on the card: a stage's time is the span between its
    two events on the stream (here a spin kernel of known cycles), read
    with one synchronize when the stats are asked for."""
    from python_5gtoolbox_tpu_torch.utils.profiling import StageProfiler

    prof = StageProfiler(cuda_device)
    x = torch.randn((4, 307200), device=cuda_device)
    filters.banded_fir(x, filters.fir_coeff(30, 100), "same")   # built
    torch.cuda.synchronize()
    with prof.stage("spin", items=2, unit="spins"):
        torch.cuda._sleep(20_000_000)
    for _ in range(2):
        with prof.stage("fir"):
            filters.banded_fir(x, filters.fir_coeff(30, 100), "same")
    assert len(prof._pending) == 3           # nothing resolved yet
    spin, fir = prof.stats["spin"], prof.stats["fir"]
    assert not prof._pending
    assert (spin.calls, fir.calls) == (1, 2)
    assert spin.seconds > 1e-3                # 2e7 cycles at <= 2 GHz
    assert 0 < fir.seconds < spin.seconds
    assert prof.rate("spin") == 2 / spin.seconds
    assert prof.check_dispatch_routing() == []


@pytest.mark.parametrize("small_alloc", [False, True],
                         ids=["ldpc_minsum", "ldpc_minsum_packed"])
def test_ldpc_iterations_counter_is_the_sum_of_iters_out(cuda_device,
                                                         monkeypatch,
                                                         small_alloc):
    """Under a StageProfiler the batched RX hands iters_out to the
    kernel and counts its sum as ldpc_iterations: the same total as a
    direct ldpc_minsum call on the LLRs each decode got. rx.ldpc's items
    are the codewords. Without a profiler no iters_out is passed."""
    from python_5gtoolbox_tpu_torch.ops import ldpc as ldpc_ops
    from python_5gtoolbox_tpu_torch.sim import pdsch_throughput as sim
    from python_5gtoolbox_tpu_torch.utils.profiling import StageProfiler

    seen = []
    real = ldpc_ops.ldpc_decode

    def spy(llr, zc, bgn, n_iter, **kw):
        seen.append((llr.clone(), zc, bgn, n_iter, kw))
        return real(llr, zc, bgn, n_iter, **kw)
    monkeypatch.setattr(ldpc_ops, "ldpc_decode", spy)
    carrier, pdsch, chan, ce, ldpc = (
        sim.small_alloc_link_level_config() if small_alloc
        else sim.bench_link_level_config())
    kw = dict(n_slots=4, ce_config=ce, ldpc_config=ldpc, seed=5,
              device=cuda_device)
    snrs = [-12.0, 25.0] if small_alloc else [-2.0, 25.0]
    sim.run_pdsch_throughput(carrier, pdsch, chan, snrs, ["MMSE-IRC"], **kw)
    assert [s[4]["iters_out"] for s in seen] == [None, None]
    seen.clear()
    prof = StageProfiler(cuda_device)
    sim.run_pdsch_throughput(carrier, pdsch, chan, snrs, ["MMSE-IRC"],
                             prof=prof, **kw)
    want, n_cw = 0, 0
    for llr, zc, bgn, n_iter, dkw in seen:
        assert dkw["iters_out"].shape == (llr.shape[0],)
        it = torch.zeros(llr.shape[0], dtype=torch.int32, device=cuda_device)
        ldpc_dec.ldpc_minsum(llr, zc, bgn, n_iter, dkw["alpha"], dkw["beta"],
                             iters_out=it)
        assert torch.equal(it, dkw["iters_out"])
        want += int(it.sum())
        n_cw += llr.shape[0]
    got = prof.counters["ldpc_iterations"]
    assert got == want and 0 < got <= n_cw * ldpc["L"]
    assert prof.stats["rx.ldpc"].items == n_cw
    assert "ldpc_iterations" in prof.report()


def test_timeshard_two_ranks_on_card(cuda_device, tmp_path):
    """Two gloo ranks sharing cuda:0 (tests/torch_parallel_ranks.py,
    run_card): the time-sharded TX and RX filters through banded_fir,
    gathered, within 2e-5 of the unsharded filters on the card."""
    import pathlib
    import socket
    import subprocess
    import sys

    script = pathlib.Path(__file__).resolve().parent / \
        "torch_parallel_ranks.py"
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    out = tmp_path / "card.pt"
    procs = [subprocess.Popen([sys.executable, str(script), str(r), "2",
                               port, str(out), "cuda"],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    res = torch.load(out)
    # per rank: FIR same + one up2 (TX), one down2 + FIR same (RX)
    assert res["launches"]["banded_fir"] == 4
    for k in ("tx", "rx"):
        assert res[k].shape == res[k + "_ref"].shape
        assert (res[k] - res[k + "_ref"]).abs().max().item() < 2e-5
