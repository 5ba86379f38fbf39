"""PyTorch port on the card: each hand-written CUDA kernel against its
plain PyTorch version (the two LDPC kernels in every schedule and check
node), and the sweeps through them.

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


FIR_TAP_COUNTS = sorted(set(filters._FIR_NUMTAPS.values()) | {55})


def _fir_taps(n):
    if n == 55:
        return filters.halfband_coeff()
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
                                              (16, 2, 30, 1.0)])
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
