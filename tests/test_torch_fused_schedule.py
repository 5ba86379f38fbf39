"""Launch plans of the two fused DUC kernels, on the CPU.

csrc/fir_up2_fused.cu and csrc/fir_up2_fused_symbols.cu cannot run here,
so every index they compute comes from a host plan (ops/filters.py:
fused_plan, fused_symbols_plan) that these tests walk:

* fir_up2_fused tile by tile: each tile's window (zeros outside the
  plane, starting on a multiple of 4 samples), the packed taps with their
  lead zeros, the FIR outputs a thread block computes (4 or 8 per thread)
  masked to [0, T), the halfband branches; the tiles cover [0, 2T) once.
  Against fir_up2_fused_plain within the FIR tolerance 1.2e-4 of
  tests/test_pallas_filters.py;
* fir_up2_fused_symbols block by block: the window assembled from the
  plan's runs equals ops/ofdm.py:cp_concat's timeline exactly, and the
  tiles walked over it give fir_up2_fused_symbols_plain within 1.2e-4;
* the 8-output geometry (every tap kept, tiles within their windows,
  the split window's reads, conflict-free) and the plans' refusals.
"""
import numpy as np
import pytest
import torch
from numpy.lib.stride_tricks import sliding_window_view

from python_5gtoolbox_tpu_torch import kernels
from python_5gtoolbox_tpu_torch.ops import filters, ofdm

TOL = 1.2e-4
CARRIERS = [(15, 5), (30, 10), (30, 5)]     # every carrier below nfft 1024


def _taps(n1):
    if n1 == 55:
        return filters.halfband_coeff()
    scs, bw = next(k for k, v in filters._FIR_NUMTAPS.items() if v == n1)
    return filters.fir_coeff(scs, bw)


def tile_outputs(w, blob, gm, t, z0, nz):
    """One tile as duc_common.cuh computes it from its window w (the
    timeline from z0/2 - hl on): FIR outputs in whole threads' worth of
    gm.per, masked to [0, t), then both halfband branches ->
    z[z0 .. z0 + nz)."""
    h = blob[:gm.n1p].astype(np.float64)
    ge = blob[gm.n1p:gm.n1p + gm.kp].astype(np.float64)
    go = blob[gm.n1p + gm.kp:].astype(np.float64)
    nv = nz // 2
    n_y = -(-(nv + gm.off) // gm.per) * gm.per
    # the FIR reads whole float4s of the window, nothing past it
    assert gm.n1p + n_y <= len(w)
    y = sliding_window_view(w, gm.n1p)[1:n_y + 1] @ h[::-1]
    tt = z0 // 2 - gm.y_back + np.arange(n_y)
    y[(tt < 0) | (tt >= t)] = 0.0
    rows = sliding_window_view(y, gm.kp)[1:nv + 1]
    out = np.empty(nz)
    out[0::2], out[1::2] = rows @ ge[::-1], rows @ go[::-1]
    return out


def fused_tiled(x, fir, hb, plan):
    """fir_up2_fused as its blocks compute it, tile by tile of the plan."""
    p, t = x.shape
    gm = plan.geometry
    blob = filters.fused_tap_blob(fir, hb, gm)
    z = np.zeros((p, 2 * t))
    seen = np.zeros((p, 2 * t), int)
    for k in range(p * plan.tiles):
        plane, z0, nz, lo = plan.tile(k)
        assert lo % 4 == 0 and z0 % 8 == 0 and nz % 2 == 0
        idx = lo + np.arange(plan.win)
        inside = (idx >= 0) & (idx < t)
        if plan.vec:    # each 16-byte chunk wholly inside or outside
            assert (inside.reshape(-1, 4).all(1)
                    | ~inside.reshape(-1, 4).any(1)).all()
        w = np.where(inside, x[plane, np.clip(idx, 0, t - 1)], 0.0)
        z[plane, z0:z0 + nz] = tile_outputs(w, blob, gm, t, z0, nz)
        seen[plane, z0:z0 + nz] += 1
    assert (seen == 1).all()
    return z


@pytest.mark.parametrize("per", [4, 8])
@pytest.mark.parametrize("n1", [27, 45, 51, 71, 287])
@pytest.mark.parametrize("planes,t", [(4, 15360), (1, 4103), (8, 1003),
                                      (3, 1)])
def test_fused_model_matches_plain(per, n1, planes, t):
    """Every FIR length of the fused path, both loops; one slot at BW 20,
    ragged rows (not a multiple of 4), 1-8 planes, a single sample."""
    rng = np.random.default_rng(n1 + t + per)
    x = rng.standard_normal((planes, t)).astype(np.float32)
    fir, hb = _taps(n1), filters.halfband_coeff()
    plan = filters.fused_plan(planes, t, n1, 55, per=per)
    got = fused_tiled(x.astype(np.float64), fir, hb, plan)
    ref = filters.fir_up2_fused_plain(torch.as_tensor(x), fir, hb).numpy()
    assert np.abs(got - ref).max() < TOL
    assert plan.vec == (t % 4 == 0)
    assert plan.geometry.hl % 4 == 0


@pytest.mark.parametrize("n1,per", [(71, 8), (287, 4)])
def test_fused_model_at_full_rows(n1, per):
    """The Dm waveform's rows at BW 20 (307200 samples a plane) with the
    default plan, and with the other loop forced."""
    rng = np.random.default_rng(n1)
    x = rng.standard_normal((2, 307200)).astype(np.float32)
    fir, hb = _taps(n1), filters.halfband_coeff()
    ref = filters.fir_up2_fused_plain(torch.as_tensor(x), fir, hb).numpy()
    for plan in (filters.fused_plan(2, 307200, n1, 55),
                 filters.fused_plan(2, 307200, n1, 55, per=per)):
        got = fused_tiled(x.astype(np.float64), fir, hb, plan)
        assert np.abs(got - ref).max() < TOL
        assert plan.blocks == 2 * plan.tiles
    assert plan.geometry.per != filters.fused_plan(2, 307200, n1,
                                                   55).geometry.per


def test_fused_model_at_ul_waveform_rows():
    """gen_ul_waveform's td branch at the default UL configuration (BW 40,
    nfft 2048, 20 slots, one antenna, 122.88 Msps): 2 planes of 614400
    samples in, 1228800 out, 143 + 55 taps, the default plan (8 outputs
    per thread)."""
    rng = np.random.default_rng(143)
    x = rng.standard_normal((2, 614400)).astype(np.float32)
    fir, hb = filters.fir_coeff(30, 40), filters.halfband_coeff()
    assert len(fir) == 143
    plan = filters.fused_plan(2, 614400, 143, 55)
    got = fused_tiled(x.astype(np.float64), fir, hb, plan)
    ref = filters.fir_up2_fused_plain(torch.as_tensor(x), fir, hb).numpy()
    assert np.abs(got - ref).max() < TOL
    assert plan.geometry.per == 8 and plan.vec
    assert plan.blocks == 2 * plan.tiles


def test_fused_plan_choices():
    """Defaults: 8 outputs per thread for FIRs of 143 taps or more where
    that still gives a block per SM (the Dm waveform's rows at BW 100),
    4 for shorter FIRs (BW 20: 71 taps) and short rows; one block per
    tile; the shared memory within the opt-in limit."""
    for shape, per in (((4, 1228800, 287), 8), ((4, 3932160, 287), 8),
                       ((4, 307200, 143), 8), ((4, 307200, 87), 4),
                       ((2, 614400, 143), 8), ((2, 1228800, 143), 8),
                       ((4, 307200, 71), 4), ((2, 15360, 71), 4),
                       ((1, 4096, 287), 4)):
        plan = filters.fused_plan(*shape, 55)
        assert plan.geometry.per == per
        assert plan.blocks == shape[0] * plan.tiles
        assert plan.smem_bytes <= kernels.SMEM_OPTIN_BYTES
        assert plan.c_args[-1] == plan.smem_bytes
    assert not filters.fused_plan(4, 307200, 71, 55, aligned=False).vec
    assert not filters.fused_plan(4, 307201, 71, 55).vec


def test_fused_plan_refusals():
    for shape, kw in (((2, 1000), dict(per=6)), ((-1, 1000), {})):
        with pytest.raises(ValueError):
            filters.fused_plan(*shape, 71, 55, **kw)
    plan = filters.fused_plan(2, 1000, 71, 55, per=8)
    assert filters.checked_fused_plan(plan, 2, 1000, 71, 55, True) is plan
    for shape in ((3, 1000, 71), (2, 1004, 71), (2, 1000, 87)):
        with pytest.raises(ValueError):
            filters.checked_fused_plan(plan, *shape, 55, True)
    # 16-byte staging on an unaligned input; 4-byte staging is fine there
    with pytest.raises(ValueError):
        filters.checked_fused_plan(plan, 2, 1000, 71, 55, False)
    four = filters.fused_plan(2, 1000, 71, 55, aligned=False)
    assert filters.checked_fused_plan(four, 2, 1000, 71, 55, True) is four


# ---------------------------------------------------------------------------
# fir_up2_fused_symbols: windows from the run table
# ---------------------------------------------------------------------------

def _symbols(scs, bw, planes, n_slots, seed=0):
    nfft = ofdm.num.fft_size(ofdm.num.carrier_prb_size(scs, bw))
    rng = np.random.default_rng(seed + nfft + n_slots)
    sym = rng.standard_normal((planes, n_slots, 14, nfft)).astype(np.float32)
    cps = tuple(int(c) for c in ofdm._cp_table(scs, nfft))
    return sym, cps, filters.fir_coeff(scs, bw), filters.halfband_coeff()


def block_window(sym, plan, slot, j, plane):
    """The window block (slot, group j) of `plane` assembles from its runs,
    as the kernel copies them (flag 2: zeros; rows outside the waveform:
    zeros)."""
    nfft, n_sym = plan.nfft, 14 * plan.n_slots
    rows = sym[plane].reshape(n_sym, nfft)
    g0 = 14 * slot + j * plan.group
    w = np.full(plan.win, np.nan)
    for dst, row, src, n, flags in plan.runs[j]:
        if flags & 1:
            assert dst % 4 == 0 and src % 4 == 0 and n % 4 == 0
        assert np.isnan(w[dst:dst + n]).all()          # runs do not overlap
        r = g0 + row
        if flags & 2 or not 0 <= r < n_sym:
            w[dst:dst + n] = 0.0
        else:
            assert 0 <= src and src + n <= nfft
            w[dst:dst + n] = rows[r, src:src + n]
    assert not np.isnan(w).any()
    return w


def symbols_tiled(sym, fir, hb, plan, timeline):
    """fir_up2_fused_symbols as its blocks compute it; every window is
    checked against the CP timeline (exactly) on the way."""
    gm, p = plan.geometry, plan.planes
    slot_samples, t = plan.slot_samples, plan.n_slots * plan.slot_samples
    blob = filters.fused_tap_blob(fir, hb, gm)
    z = np.zeros((p, 2 * t))
    seen = np.zeros((p, 2 * t), int)
    for plane in range(p):
        padded = np.concatenate([np.zeros(gm.hl), timeline[plane],
                                 np.zeros(plan.win)])
        for slot in range(plan.n_slots):
            for j in range(plan.groups):
                w = block_window(sym, plan, slot, j, plane)
                start = slot * slot_samples + plan.starts[j]
                n = plan.starts[j + 1] - plan.starts[j]
                ends = gm.hl + n + gm.hr
                want = padded[start:start + ends]
                assert np.array_equal(w[:ends], want)
                assert not w[ends:].any()
                tile = plan.tiles[j]
                assert tile % 8 == 0 and tile <= gm.nz_tile
                for u0 in range(0, 2 * n, tile):
                    nz = min(tile, 2 * n - u0)
                    z0 = 2 * start + u0
                    z[plane, z0:z0 + nz] = tile_outputs(
                        w[u0 // 2:], blob, gm, t, z0, nz)
                    seen[plane, z0:z0 + nz] += 1
    assert (seen == 1).all()
    return z


@pytest.mark.parametrize("scs,bw", CARRIERS)
@pytest.mark.parametrize("n_slots", [1, 2, 3, 20])
@pytest.mark.parametrize("group", filters.FUSED_GROUPS)
def test_symbol_windows_are_the_cp_timeline(scs, bw, n_slots, group):
    """Every block's window, the waveform's first and last symbols
    included, is cp_concat's timeline exactly (zeros beyond the ends)."""
    sym, cps, fir, hb = _symbols(scs, bw, 2, n_slots)
    timeline = ofdm.cp_concat(torch.as_tensor(sym), cps).reshape(
        2, -1).numpy()
    plan = filters.fused_symbols_plan(2, n_slots, sym.shape[-1], len(fir),
                                      55, cps, group=group)
    gm = plan.geometry
    for slot in range(n_slots):
        for j in range(plan.groups):
            w = block_window(sym, plan, slot, j, 1)
            start = slot * plan.slot_samples + plan.starts[j]
            lo, hi = start - gm.hl, start + plan.starts[j + 1] \
                - plan.starts[j] + gm.hr
            want = np.concatenate([np.zeros(max(0, -lo)),
                                   timeline[1, max(lo, 0):hi]])
            want = np.concatenate([want, np.zeros(plan.win - len(want))])
            assert np.array_equal(w, want)


@pytest.mark.parametrize("scs,bw", CARRIERS)
@pytest.mark.parametrize("n_slots,group", [(1, 1), (2, 2), (3, 1), (1, 2),
                                           (20, None)])
def test_symbols_model_matches_plain(scs, bw, n_slots, group):
    sym, cps, fir, hb = _symbols(scs, bw, 4, n_slots, seed=1)
    plan = filters.fused_symbols_plan(4, n_slots, sym.shape[-1], len(fir),
                                      55, cps, group=group)
    timeline = ofdm.cp_concat(torch.as_tensor(sym), cps).reshape(
        4, -1).double().numpy()
    got = symbols_tiled(sym.astype(np.float64), fir, hb, plan, timeline)
    ref = filters.fir_up2_fused_symbols_plain(torch.as_tensor(sym), cps,
                                              fir, hb).numpy()
    assert np.abs(got - ref).max() < TOL


def test_symbols_plan_staging():
    """16-byte runs wherever source and window offsets are multiples of 4:
    every run at scs 15 / BW 5 but the right halo's ragged head; at scs 30
    / BW 5 the CP of 18 or 22 samples puts every CP and most bodies on
    4-byte copies."""
    sym, cps, fir, hb = _symbols(15, 5, 1, 1)
    plan = filters.fused_symbols_plan(4, 20, 512, len(fir), 55, cps)
    assert plan.runs[0][:4] == ((0, -1, 512 - plan.geometry.hl,
                                 plan.geometry.hl, 1),
                                (plan.geometry.hl, 0, 512 - 40, 40, 1),
                                (plan.geometry.hl + 40, 0, 0, 512, 1),
                                (plan.geometry.hl + 552, 1, 512 - 36, 36, 1))
    # one symbol and one plane per block at nfft 512; two symbols at nfft
    # 256 with 20 slots, one with 1 slot
    assert (plan.group, plan.geometry.per) == (1, 4)
    assert plan.blocks == 20 * 14 * 4
    unaligned = filters.fused_symbols_plan(4, 20, 512, len(fir), 55, cps,
                                           aligned=False)
    assert not any(r[4] & 1 for rs in unaligned.runs for r in rs)
    _, cps5, fir5, _ = _symbols(30, 5, 1, 1)
    plan5 = filters.fused_symbols_plan(4, 20, 256, len(fir5), 55, cps5)
    assert plan5.group == 2 and plan5.blocks == 20 * 7 * 4
    assert filters.fused_symbols_plan(4, 1, 256, len(fir5), 55,
                                      cps5).group == 1
    copies = [r for rs in plan5.runs for r in rs if not r[4] & 2]
    assert any(r[4] & 1 for r in copies)
    assert all(not r[4] & 1 for r in copies if r[2] in (256 - 18, 256 - 22))
    table = plan5.table
    assert table.dtype == np.int32
    assert len(table) == 3 * plan5.groups + 2 + 5 * sum(
        len(r) for r in plan5.runs)
    assert sum(len(r) for r in plan5.runs) <= filters.FUSED_MAX_RUNS


def test_symbols_plan_shares_the_duc_tile_rule():
    """One symbol per block: each symbol's tiles are duc_from_spec's at
    the same geometry (_tile_table)."""
    for scs, bw in CARRIERS:
        sym, cps, fir, hb = _symbols(scs, bw, 1, 1)
        nfft = sym.shape[-1]
        plan = filters.fused_symbols_plan(2, 1, nfft, len(fir), 55, cps,
                                          group=1)
        table = filters._tile_table(plan.geometry, nfft, cps)
        assert plan.tiles == table[0::3]


def test_symbols_plan_refusals():
    sym, cps, fir, hb = _symbols(15, 5, 1, 1)
    for group in (3, 5, 7, 14):
        with pytest.raises(ValueError):
            filters.fused_symbols_plan(2, 1, 512, len(fir), 55, cps,
                                       group=group)
    # a halo longer than a symbol
    with pytest.raises(ValueError):
        filters.fused_symbols_plan(2, 1, 64, 287, 55, (4,) * 14)
    plan = filters.fused_symbols_plan(2, 3, 512, len(fir), 55, cps, group=2)
    assert filters.checked_fused_symbols_plan(
        plan, 2, 3, 512, len(fir), 55, cps, True) is plan
    assert plan.blocks == 3 * 7 * 2
    assert plan.smem_bytes == 4 * (plan.geometry.n1p + 2 * plan.geometry.kp
                                   + 4 * filters.DUC_THREADS + plan.win)
    default = filters.fused_symbols_plan(2, 3, 512, len(fir), 55, cps)
    assert default != plan and filters.checked_fused_symbols_plan(
        default, 2, 3, 512, len(fir), 55, cps, True) is default
    for args in ((2, 4, 512, len(fir)), (4, 3, 512, len(fir)),
                 (2, 3, 512, 45)):
        with pytest.raises(ValueError):
            filters.checked_fused_symbols_plan(plan, *args, 55, cps, True)
    with pytest.raises(ValueError):
        filters.checked_fused_symbols_plan(plan, 2, 3, 512, len(fir), 55,
                                           cps, False)


# ---------------------------------------------------------------------------
# The 8-output loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n1", [27, 45, 51, 71, 87, 143, 153, 287])
@pytest.mark.parametrize("per", [4, 8])
def test_tap_blob_keeps_every_tap(n1, per):
    """The packed taps hold each FIR tap once after the lead zeros and each
    halfband tap once (scaled by sqrt 2), the near-zero ones too; the tile
    of outputs fits its threads."""
    fir, hb = _taps(n1), filters.halfband_coeff()
    gm = filters.duc_geometry(n1, 55, filters.fused_lead(n1, 55), per)
    blob = filters.fused_tap_blob(fir, hb, gm)
    assert len(blob) == gm.n1p + 2 * gm.kp and len(blob) % 4 == 0
    assert not blob[:gm.lead].any()
    np.testing.assert_array_equal(blob[gm.lead:gm.lead + n1],
                                  fir.astype(np.float32))
    assert not blob[gm.lead + n1:gm.n1p].any()
    branches = blob[gm.n1p:]
    g = (hb * np.sqrt(2)).astype(np.float32)
    np.testing.assert_array_equal(np.sort(branches[branches != 0]),
                                  np.sort(g[g != 0]))
    assert gm.hl % 4 == 0 and gm.nz_tile % 8 == 0
    assert gm.nz_tile // 2 + gm.off <= filters.DUC_THREADS * per
    assert gm.b1 == n1 - 1 - n1 // 2 + gm.lead


def _split(f, half):
    """duc_common.cuh:split: window float f in a window split into its
    even and odd float4s."""
    return ((f >> 2) & 1) * half + ((f >> 3) << 2) + (f & 3)


@pytest.mark.parametrize("n1", [27, 45, 51, 71, 87, 143, 153, 287])
def test_split_window_reads(n1):
    """fir_up2_tile8's loads: the half pointers pa, pb and the unrolled
    steps (6 at a time, then one by one) read float4 a - q - 1 of the
    window for every thread and step, a = (n1p + 8 tid) / 4 (153 taps give
    an even m = n1p / 4 - 1, the others odd); a quarter warp reads eight
    consecutive float4s of one half (no bank conflict); the split maps the
    window one to one."""
    gm = filters.duc_geometry(n1, 55, filters.fused_lead(n1, 55), 8)
    win = filters._window_floats(gm, gm.nz_tile)
    phys = filters._phys_floats(gm, win)
    half = phys // 2
    f = np.arange(win)
    where = _split(f, half)
    assert len(set(where)) == win and where.max() < phys
    # float4 k of the window sits at float4 (k & 1) * half / 4 + (k >> 1)
    tid = np.arange(filters.DUC_THREADS)
    m = gm.n1p // 4 - 1
    ev, od = tid, half // 4 + tid
    pa = (od if m & 1 else ev) + (m >> 1)
    pb = (ev if m & 1 else od) + ((m - 1) >> 1)
    a = (gm.n1p + 8 * tid) // 4
    k_of = {}                          # shared float4 -> window float4
    for k in range(win // 4):
        k_of[_split(4 * k, half) // 4] = k
    assert [k_of[x] for x in pa + 1] == list(a + 1)
    assert [k_of[x] for x in pb + 1] == list(a)
    nq, q, steps = gm.n1p // 4, 0, []
    while q + 6 <= nq:
        steps += [(q + i, (pa if i % 2 == 0 else pb) - q // 2 - i // 2)
                  for i in range(6)]
        q += 6
    steps += [(j, (pb if j & 1 else pa) - (j >> 1)) for j in range(q, nq)]
    assert [s for s, _ in steps] == list(range(nq))
    for q, ptr in steps:
        assert [k_of[x] for x in ptr] == list(a - q - 1)
        for w in range(0, filters.DUC_THREADS, 8):
            assert np.array_equal(np.diff(ptr[w:w + 8]), np.ones(7))
