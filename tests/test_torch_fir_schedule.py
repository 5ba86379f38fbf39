"""Launch plans of the two filter kernels, on the CPU.

csrc/banded_fir.cu and csrc/duc_from_spec.cu cannot run here, so every
index they compute comes from a host plan (ops/filters.py: fir_plan,
duc_plan) that these tests reach:

* a model of banded_fir as the kernel tiles it (the plan's windows,
  branch taps, delays and input phases; no conv1d) against
  banded_fir_plain in all three modes, within the FIR tolerance 1.2e-4 of
  tests/test_pallas_filters.py;
* a model of duc_from_spec's cluster halo exchange (each block's window
  assembled from its neighbours' timelines, or from an IDFT of its own
  where the plan says so; the tiles walked as the kernel walks the plan's
  tile table) against duc_from_spec_planes_plain;
* the plans' rules: IDFTs per symbol, padded grids, refusals.
"""
import numpy as np
import pytest
import torch
from numpy.lib.stride_tricks import sliding_window_view

from python_5gtoolbox_tpu_torch import kernels
from python_5gtoolbox_tpu_torch.ops import filters, ofdm
from python_5gtoolbox_tpu_torch.phy.prach import prach_halfband

TOL = 1.2e-4
# 56: the PRACH chain's halfband (phy/prach.py:prach_halfband), the one
# even tap count
TAP_COUNTS = sorted(set(filters._FIR_NUMTAPS.values()) | {55, 56})


def _taps(n: int) -> np.ndarray:
    if n == 55:
        return filters.halfband_coeff()
    if n == 56:
        return prach_halfband()
    scs, bw = next(k for k, v in filters._FIR_NUMTAPS.items() if v == n)
    return filters.fir_coeff(scs, bw)


def banded_fir_tiled(x: np.ndarray, taps: np.ndarray, mode: str,
                     plan: filters.FirPlan) -> np.ndarray:
    """banded_fir as csrc/banded_fir.cu computes it: tile by tile of the
    flattened (plane, tile) order, each tile from its staged window (zeros
    outside [0, t_in)), down2 from the window's two phases; the position v
    reads the window from its index (v - v_lo) + kp (the sample v + d)
    down over the kp branch taps."""
    p, t_in = x.shape
    h = plan.pack(taps).astype(np.float64)
    y = np.zeros((p, plan.t_out))
    for k in range(p * plan.tiles):
        plane, v_lo, lo = plan.tile_window(k)
        idx = lo + np.arange(plan.window)
        w = np.where((idx >= 0) & (idx < t_in),
                     x[plane, np.clip(idx, 0, t_in - 1)], 0.0)
        streams = ([w[0::2], w[1::2]] if mode == "down2" else [w])
        acc = []
        for e in range(plan.branches):
            s = streams[plan.phase[e]] if mode == "down2" else streams[0]
            assert len(s) == plan.tile + plan.kp
            rows = sliding_window_view(s, plan.kp)[1:plan.tile + 1]
            acc.append(rows @ h[e, ::-1])
        v = v_lo + np.arange(plan.tile)
        keep = v < plan.positions
        if mode == "same":
            y[plane, v[keep]] = acc[0][keep]
        elif mode == "up2":
            y[plane, 2 * v[keep]] = acc[0][keep]
            y[plane, 2 * v[keep] + 1] = acc[1][keep]
        else:
            y[plane, v[keep]] = (acc[0] + acc[1])[keep]
    return y


def _check_fir(n, mode, t_in, planes=2):
    rng = np.random.default_rng(n * 7 + t_in)
    x = rng.standard_normal((planes, t_in)).astype(np.float32)
    taps = _taps(n)
    plan = filters.fir_plan(n, mode, t_in, planes)
    got = banded_fir_tiled(x.astype(np.float64), taps, mode, plan)
    if plan.t_out == 0:         # down2 of one sample: nothing to compute
        assert got.shape == (planes, 0) and plan.tiles == 0
        return plan
    ref = filters.banded_fir_plain(torch.as_tensor(x), taps, mode).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < TOL
    return plan


@pytest.mark.parametrize("mode", ["same", "up2", "down2"])
@pytest.mark.parametrize("n", TAP_COUNTS)
@pytest.mark.parametrize("t_in", [4103, 6144, 2050])
def test_tiled_banded_fir_matches_plain(n, mode, t_in):
    """Lengths: ragged (not a multiple of 4 or of the tile), exactly three
    tiles, and one position past a tile (up2 / same) or an odd half."""
    plan = _check_fir(n, mode, t_in)
    assert plan.vec == (t_in % 4 == 0)
    assert plan.d % 4 == 0 and plan.kp % 4 == 0
    assert all(s >= 0 for s in plan.shift)


@pytest.mark.parametrize("mode", ["same", "up2", "down2"])
@pytest.mark.parametrize("t_in", [1, 2, 3, 5])
@pytest.mark.parametrize("n", [55, 287])
def test_tiled_banded_fir_short_rows(n, mode, t_in):
    _check_fir(n, mode, t_in, planes=3)


@pytest.mark.parametrize("planes", [2, 4])
def test_tiled_banded_fir_at_ul_sweep_shapes(planes):
    """The UL sweep's channel filters at the carrier rate (BW 20, 20
    slots, 71 taps): TX on 1 antenna (2 planes), RX on 2 (4 planes)."""
    plan = _check_fir(71, "same", 307200, planes)
    assert (plan.tiles_per_block, plan.stages, plan.vec) == (1, 1, True)
    assert plan.blocks == planes * plan.tiles


def test_fir_plan_keeps_every_tap():
    """The branches together hold each tap once (scaled), nothing else:
    the halfband's near-zero taps are kept."""
    for n in TAP_COUNTS:
        taps = _taps(n)
        for mode in ("same", "up2", "down2"):
            plan = filters.fir_plan(n, mode, 10000, 1)
            packed = plan.pack(taps)
            assert sum(plan.kn) == n
            np.testing.assert_allclose(
                np.sort(packed[packed != 0]),
                np.sort((taps * plan.scale).astype(np.float32)[
                    (taps * plan.scale).astype(np.float32) != 0]))
    hb = filters.halfband_coeff()
    assert 0 < np.abs(hb[1::2][np.abs(hb[1::2]) < 1e-3]).max() < 1e-5


def test_fir_plan_launch_shape():
    """One tile and one window per block, or two tiles through a ring of
    two above 64K outputs per SM; every tile is served once; windows start
    on multiples of 4 samples."""
    small = filters.fir_plan(71, "same", 3001, 8)
    assert (small.tiles_per_block, small.stages, small.blocks) == (1, 1, 16)
    # the six stages of a 245.76 Msps sweep point: the two of 74.5K
    # outputs per SM ring, down2 8x1228800 (37.2K) does not
    hb = 55
    for (p, t, mode), ring in [((4, 614400, "up2"), False),
                               ((4, 1228800, "up2"), True),
                               ((8, 2457600, "down2"), True),
                               ((8, 1228800, "down2"), False),
                               ((8, 614400, "down2"), False),
                               ((8, 307200, "same"), False)]:
        plan = filters.fir_plan(hb, mode, t, p)
        assert (plan.tiles_per_block, plan.stages) == ((2, 2) if ring
                                                       else (1, 1))
    big = filters.fir_plan(55, "down2", 2457600, 8)
    assert big.blocks * big.tiles_per_block >= 8 * big.tiles
    assert (big.blocks - 1) * big.tiles_per_block < 8 * big.tiles
    for k in (0, 1, big.tiles, 8 * big.tiles - 1):
        assert big.tile_window(k)[2] % 8 == 0
    assert big.smem_bytes > 48 * 1024      # needs the opt-in
    assert filters.fir_plan(55, "up2", 307201, 2).vec is False
    assert filters.fir_plan(55, "up2", 307200, 2, aligned=False).vec is False
    forced = filters.fir_plan(71, "down2", 9000, 3, tiles_per_block=3,
                              stages=2)
    assert (forced.tiles_per_block, forced.stages, forced.blocks) == (3, 2, 3)
    assert forced.smem_bytes == 4 * (2 * forced.kp + 2 * forced.window
                                     + 2 * (forced.tile + forced.kp))
    for kw in (dict(tiles_per_block=filters.FIR_MAX_TILES_PER_BLOCK + 1),
               dict(tiles_per_block=0), dict(stages=0), dict(stages=3)):
        with pytest.raises(ValueError):
            filters.fir_plan(71, "same", 9000, 3, **kw)


# ---------------------------------------------------------------------------
# duc_from_spec: cluster halo exchange
# ---------------------------------------------------------------------------

def duc_cluster_model(spec_planes: torch.Tensor, cps, fir, hb, pc,
                      plan: filters.DucPlan) -> tuple[np.ndarray, int]:
    """duc_from_spec as its blocks compute it -> ((2 ant, 2 T) planes,
    IDFTs computed). Block g takes its halos from block g -/+ 1 of its
    cluster, from an IDFT of its own where the plan says so, zeros at the
    waveform's ends; padding blocks emit nothing and are never read. Each
    tile's FIR outputs and halfband outputs come from the window only
    (an index outside it fails); a tile the plan runs before the halo
    exchange sees NaN halos and must not read them. The tiles come from
    the plan's tile table as the kernel reads it: the halo-free run
    first, then the others."""
    nant, nfft, k_cl = plan.nant, plan.nfft, plan.cluster
    gm, n_sym = plan.geometry, plan.symbols
    sym = filters._spec_symbols_plain(spec_planes, pc).double().numpy()
    td = (sym[:nant] + 1j * sym[nant:]).reshape(nant, n_sym, nfft)
    cp_of = [cps[g % 14] for g in range(n_sym)]
    slot = sum(cps) + 14 * nfft
    starts = np.cumsum([0] + [c + nfft for c in cps])
    t_len = plan.n_slots * slot
    n1, n2 = len(fir), len(hb)
    b1, b2 = n1 - 1 - n1 // 2, n2 // 2 - 1
    h1 = np.asarray(fir, np.float64)
    g2 = np.asarray(hb, np.float64) * np.sqrt(2)
    out = np.zeros((nant, 2 * t_len), complex)
    idfts = 0
    for a in range(nant):
        tl = [np.concatenate([td[a, g, nfft - cp_of[g]:], td[a, g]])
              for g in range(n_sym)]
        for g in range(plan.blocks):
            if g >= n_sym:
                continue
            rank = g % k_cl
            outer = plan.computes_outer(g)
            idfts += 1 + sum(outer)
            if g == 0:
                left = np.zeros(gm.hl)
            else:
                # from the neighbour's published middle, or computed here
                assert outer[0] == (rank == 0)
                assert (g - 1) // k_cl == g // k_cl or outer[0]
                left = tl[g - 1][-gm.hl:]
            if g == n_sym - 1:
                right = np.zeros(gm.hr)
            else:
                assert outer[1] == (rank == k_cl - 1)
                assert (g + 1) // k_cl == g // k_cl or outer[1]
                right = tl[g + 1][:gm.hr]
            win = np.concatenate([left, tl[g], right])
            assert len(win) <= plan.win
            # what a tile run before the halo exchange sees
            early = np.concatenate([np.full(gm.hl, np.nan), tl[g],
                                    np.full(gm.hr, np.nan)])
            start = (g // 14) * slot + starts[g % 14]
            x_lo = start - gm.hl
            n_out = 2 * len(tl[g])
            tiles, free = plan.tiles(g)
            covered = 0
            for i in [*free, *(i for i in range(len(tiles))
                               if i not in free)]:
                u0, nz = tiles[i]
                assert nz % 2 == 0 and nz <= gm.nz_tile
                covered += nz
                w = early if i in free else win
                # the kernel's FIR reads whole float4s of the window
                assert (u0 // 2 + gm.n1p + filters._round_up4(nz // 2 + gm.off)
                        <= len(win))
                u = 2 * start + u0 + np.arange(nz)
                # halfband: z[u] = sum_k g[j0 + 2k] y[(u + b2 - j0)/2 - k]
                j0 = (u + b2) & 1
                ks = np.arange((n2 + 1) // 2)
                jj = j0[:, None] + 2 * ks[None, :]
                ty = (u[:, None] + b2 - jj) // 2
                ok = jj < n2
                # FIR: y[t] = sum_j h[j] x[t + b1 - j], zero outside [0, T)
                t_need = np.arange(ty[ok].min(), ty[ok].max() + 1)
                xi = t_need[:, None] + b1 - np.arange(n1)[None, :] - x_lo
                assert xi.min() >= 0 and xi.max() < len(win)
                y = (w[xi] * h1).sum(1)
                y[(t_need < 0) | (t_need >= t_len)] = 0
                yv = y[np.clip(ty - t_need[0], 0, len(y) - 1)]
                z = np.where(ok, g2[np.minimum(jj, n2 - 1)] * yv, 0).sum(1)
                assert np.isfinite(z).all()
                out[a, u] = z
            assert covered == n_out
    return np.concatenate([out.real, out.imag]), idfts


def _spec_case(scs, bw, nant, n_slots, seed=0):
    nfft = ofdm.num.fft_size(ofdm.num.carrier_prb_size(scs, bw))
    rng = np.random.default_rng(seed + nfft + n_slots)
    spec = torch.as_tensor(rng.standard_normal(
        (2 * nant, n_slots, 14, nfft)).astype(np.float32))
    fc = 3_500_000_000
    return (spec, ofdm._cp_table(scs, nfft), filters.fir_coeff(scs, bw),
            filters.halfband_coeff(), ofdm._phase_comp(scs, nfft, fc))


@pytest.mark.parametrize("scs,bw,nant,n_slots,cluster", [
    (30, 20, 1, 1, None),      # nfft 1024, 14 symbols padded to 16
    (30, 20, 2, 3, None),      # clusters across slot boundaries
    (30, 20, 1, 2, 3),         # 28 symbols padded to 30
    (30, 20, 2, 1, 1),         # no cluster: both neighbours computed
    (30, 20, 1, 3, 16),        # non-portable cluster, 42 padded to 48
    (30, 100, 1, 1, None),     # nfft 4096, 287 taps
    (30, 100, 2, 2, 5),
    (30, 40, 1, 2, None),      # nfft 2048, 143 taps: the UL waveform's
])
def test_cluster_halo_model_matches_plain(scs, bw, nant, n_slots, cluster):
    spec, cps, fir, hb, pc = _spec_case(scs, bw, nant, n_slots)
    nfft = spec.shape[-1]
    plan = filters.duc_plan(nant, n_slots, nfft, len(fir), len(hb), cps,
                            cluster)
    got, idfts = duc_cluster_model(spec, cps, fir, hb, pc, plan)
    ref = torch.cat(filters.duc_from_spec_planes_plain(spec, cps, fir, hb,
                                                       pc)).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < TOL
    assert idfts == nant * plan.idfts
    assert plan.blocks % plan.cluster == 0
    assert plan.blocks - plan.symbols < plan.cluster


def test_duc_plan_idfts_per_symbol_at_bench_width():
    """scs 30 / BW 100, 64 slots (the waveform bench): at most 1.25 IDFTs
    per output symbol with the default cluster, 3 without clusters."""
    cps = ofdm._cp_table(30, 4096)
    plan = filters.duc_plan(2, 64, 4096, 287, 55, cps)
    assert plan.cluster == filters.DUC_CLUSTER
    assert plan.idfts_per_symbol <= 1.25
    assert plan.idfts == 896 + 2 * (896 // 8) - 2
    assert filters.duc_plan(2, 64, 4096, 287, 55, cps, 1).idfts == 3 * 896 - 2
    assert 3 * plan.smem_bytes + filters.DUC_STATIC_SMEM \
        < kernels.SMEM_OPTIN_BYTES
    # the sweep's shape: 20 slots of nfft 1024, 71 + 55 taps
    sweep = filters.duc_plan(2, 20, 1024, 71, 55, ofdm._cp_table(30, 1024))
    assert sweep.blocks == 280 and sweep.idfts_per_symbol <= 1.25


def test_duc_plan_at_ul_waveform():
    """gen_ul_waveform's fused branch at the default UL configuration:
    scs 30 / BW 40 (nfft 2048, 143 + 55 taps), one antenna, 20 slots."""
    cps = ofdm._cp_table(30, 2048)
    plan = filters.duc_plan(1, 20, 2048, 143, 55, cps)
    assert (plan.cluster, plan.symbols, plan.blocks) == \
        (filters.DUC_CLUSTER, 280, 280)
    assert plan.idfts_per_symbol <= 1.25
    assert 3 * plan.smem_bytes + filters.DUC_STATIC_SMEM \
        < kernels.SMEM_OPTIN_BYTES


def test_duc_plan_even_tiles():
    """A symbol's outputs split into equal tiles (multiples of 8) of at
    most nz_tile; the last is not mostly empty."""
    for nfft, n1 in ((1024, 71), (2048, 143), (4096, 287)):
        cps = ofdm._cp_table(30, nfft)
        plan = filters.duc_plan(1, 1, nfft, n1, 55, cps)
        for g in range(14):
            tiles, _ = plan.tiles(g)
            assert [u0 for u0, _ in tiles] == list(
                range(0, 2 * (cps[g] + nfft), tiles[0][1]))
            assert sum(nz for _, nz in tiles) == 2 * (cps[g] + nfft)
            assert all(nz % 8 == 0 for _, nz in tiles[:-1])
            assert max(nz for _, nz in tiles) <= plan.geometry.nz_tile
            assert tiles[-1][1] > tiles[0][1] - 8 * len(tiles)


def test_duc_plan_halo_free_tiles():
    """At the bench width the middle three of a symbol's five tiles read
    no halo (they run before the cluster wait); at nfft 1024 both tiles
    read one. The table the kernel receives holds exactly that."""
    wide = filters.duc_plan(2, 64, 4096, 287, 55, ofdm._cp_table(30, 4096))
    narrow = filters.duc_plan(2, 20, 1024, 71, 55, ofdm._cp_table(30, 1024))
    for g in range(14):
        tiles, free = wide.tiles(g)
        assert len(tiles) == 5 and free == range(1, 4)
        tiles, free = narrow.tiles(g)
        assert len(tiles) == 2 and len(free) == 0
    assert len(wide.tile_table) == 3 * 14
    assert wide.tile_table[:3] == (wide.tiles(0)[0][0][1], 1, 4)


def test_duc_plan_refusals():
    cps = ofdm._cp_table(30, 1024)
    for k in (0, 17):
        with pytest.raises(ValueError):
            filters.duc_plan(1, 2, 1024, 71, 55, cps, k)
    plan = filters.duc_plan(1, 2, 1024, 71, 55, cps, 4)
    assert filters.checked_duc_plan(plan, 1, 2, 1024, 71, 55, cps) is plan
    with pytest.raises(ValueError):
        filters.checked_duc_plan(plan, 1, 3, 1024, 71, 55, cps)
    with pytest.raises(ValueError):
        filters.checked_duc_plan(plan, 1, 2, 1024, 143, 55, cps)
    # a halo longer than a neighbouring symbol
    with pytest.raises(ValueError):
        filters.duc_plan(1, 2, 64, 287, 55, [4] * 14)

