"""PyTorch port, the PUSCH TX: low-PAPR sequences, the UL TBS, the
slot-batched PUSCH grid (CP-OFDM and DFT-s-OFDM) and gen_ul_waveform,
held against the reference goldens and the JAX package on the same
inputs (the JAX run's transport blocks handed to the port).

Tolerances: low-PAPR sequences 2e-5 against the goldens
(tests/test_foundations.py); grids 3e-5 against the pusch_slot2 goldens
(tests/test_pusch.py) and 1e-6 against the JAX package (float32 DFT of
the transform-precoded blocks); the ul_waveform golden fd 3e-5, td 3e-4,
ul 3e-4 (tests/test_ul_channels.py); against the JAX package IQ 1e-5
and the filtered waveform 1.2e-4 (tests/test_pallas_filters.py).
"""
import numpy as np
import pytest
import torch

from tests.golden import get_golden
from tests.test_pusch import PUSCH_CASES, _mk_cfg
from tests.test_tx_batch_ul import CASES, _carrier, _pusch

from python_5gtoolbox_tpu.ops import lowpapr as jlp
from python_5gtoolbox_tpu.phy import pusch as jpusch
from python_5gtoolbox_tpu.phy import tbsize as jtbs
from python_5gtoolbox_tpu.utils.config import get_default_config, merged
from python_5gtoolbox_tpu.waveform import ul as jul

from python_5gtoolbox_tpu_torch.ops import lowpapr as tlp
from python_5gtoolbox_tpu_torch.phy import pusch as tpusch
from python_5gtoolbox_tpu_torch.phy import tbsize as ttbs
from python_5gtoolbox_tpu_torch.waveform import ul as tul

LP_CASES = [(0, 0, 0.0, 6), (29, 0, 1.5, 12), (7, 0, 0.7, 18),
            (13, 0, 0.0, 24), (5, 0, 2.1, 30), (11, 1, 0.3, 72),
            (25, 0, 4.0, 144), (17, 1, 0.9, 839 - 839 % 6)]
NON_UCI = [0, 1, 2, 3, 7, 8]          # the pusch_slot2 cases without UCI


def _no_golden_gen():
    raise RuntimeError("golden file missing")


@pytest.mark.parametrize("i", range(len(LP_CASES)))
def test_lowpapr_seq(i):
    gold = get_golden("lowpapr_cases", _no_golden_gen)
    u, v, a, m = LP_CASES[i]
    got = tlp.lowpapr_seq(u, v, a, m)
    np.testing.assert_allclose(got, gold[f"seq_{i}"], atol=2e-5)
    np.testing.assert_array_equal(got, jlp.lowpapr_seq(u, v, a, m))


@pytest.mark.parametrize("hopping", ["groupHopping", "sequenceHopping",
                                     "neither"])
@pytest.mark.parametrize("size", [36, 72, 144])
def test_dmrs_seq_tp_every_slot(hopping, size):
    """The DFT-s-OFDM DMRS on every slot and symbol of a frame at scs 30:
    group hopping (c_init nPuschID // 30), sequence hopping (from 72
    REs) and neither; 36 REs is below M_ZC, the tiled base sequence."""
    for slot in range(20):
        for sym in range(14):
            np.testing.assert_array_equal(
                tpusch._dmrs_seq_tp(100, hopping, size, slot, sym),
                jpusch._dmrs_seq_tp(100, hopping, size, slot, sym))


@pytest.mark.parametrize("i", range(len(PUSCH_CASES)))
def test_ulsch_tbsize(i):
    gold = get_golden("pusch_slot2", _no_golden_gen)
    cfg = _mk_cfg(get_default_config("pusch"), PUSCH_CASES[i])
    got = ttbs.ulsch_tbsize(cfg)
    np.testing.assert_array_equal(np.array(got), gold[f"tbs_{i}"])
    assert got == jtbs.ulsch_tbsize(cfg)


@pytest.mark.parametrize("i", NON_UCI)
def test_tx_grid_matches_slot_golden(i):
    gold = get_golden("pusch_slot2", _no_golden_gen)
    case = PUSCH_CASES[i]
    cfg = _mk_cfg(get_default_config("pusch"), case)
    carrier = merged(get_default_config("ul_carrier"),
                     dict(BW=case[9], scs=case[8], num_of_ant=case[3],
                          Nr=case[3]))
    ch = tpusch.NrPUSCH(carrier, cfg, device="cpu")
    assert ch.tx_batch_supported()
    grid = ch.tx_grid_batch([0])[0].numpy()           # (ant, 14, n_sc)
    np.testing.assert_allclose(grid.reshape(case[3], -1), gold[f"fd_{i}"],
                               atol=3e-5)


def _port_with_jax_draws(cfg, carrier, drawn):
    """A port NrPUSCH that draws the given blocks in order: its own rv
    cycling decides when it draws."""
    ch = tpusch.NrPUSCH(carrier, dict(cfg), device="cpu")
    it = iter(drawn)
    ch.get_trblk = lambda tbsize: next(it)
    return ch


def _jax_grid(cfg, carrier, slots, roll, seed):
    """JAX tx_grid_batch after np.random.seed(seed) -> (grid, the blocks
    it drew, in order)."""
    np.random.seed(seed)
    ch = jpusch.NrPUSCH(carrier, dict(cfg))
    drawn, draw = [], ch.get_trblk
    ch.get_trblk = lambda tbsize: drawn.append(draw(tbsize)) or drawn[-1]
    return np.asarray(ch.tx_grid_batch(slots, roll_ant=roll)), drawn


@pytest.mark.parametrize("roll", [0, 1])
@pytest.mark.parametrize("name,pu_kw,car_kw", CASES,
                         ids=[c[0] for c in CASES])
def test_tx_grid_matches_jax(name, pu_kw, car_kw, roll):
    carrier, cfg = _carrier(**car_kw), _pusch(**pu_kw)
    ref, drawn = _jax_grid(cfg, carrier, [0, 1, 2, 3], roll, 4321)
    got = _port_with_jax_draws(cfg, carrier, drawn).tx_grid_batch(
        [0, 1, 2, 3], roll_ant=roll).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("roll", [0, 1])
def test_tx_grid_rv_cycling_and_gating(roll):
    """rv [0, 2, 3, 1] with a fresh block every fourth allocated slot and
    slots 4 and 9 gated, as tests/test_tx_batch_ul.py; the blocks also go
    in as trblks= (one row per allocated slot)."""
    carrier = _carrier()
    cfg = _pusch(rv=[0, 2, 3, 1], period_in_slot=5,
                 allocated_slots=[0, 1, 2, 3])
    slots = list(range(10))
    ref, drawn = _jax_grid(cfg, carrier, slots, roll, 77)
    assert len(drawn) == 2
    got = _port_with_jax_draws(cfg, carrier, drawn).tx_grid_batch(
        slots, roll_ant=roll).numpy()
    assert np.all(got[4] == 0) and np.all(got[9] == 0)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    rows = np.stack([drawn[0]] * 4 + [drawn[1]] * 4)
    again = tpusch.NrPUSCH(carrier, dict(cfg), device="cpu").tx_grid_batch(
        slots, roll_ant=roll, trblks=rows).numpy()
    np.testing.assert_array_equal(again, got)


def _golden_wave_config():
    carrier = merged(get_default_config("ul_carrier"),
                     dict(BW=40, scs=30, num_of_ant=1, Nr=1))
    cfg = get_default_config("pusch")
    cfg.update(nNrOfAntennaPorts=1, nPMI=0, data_source=[1, 0, 0, 1])
    cfg["ResAlloType1"]["RBSize"] = 24
    wf = merged(get_default_config("ul_waveform"), dict(numofslots=2))
    return carrier, cfg, wf


@pytest.mark.parametrize("return_device", [False, True])
def test_ul_waveform_golden(return_device):
    gold = get_golden("ul_waveform", _no_golden_gen)
    carrier, cfg, wf = _golden_wave_config()
    ch = tpusch.NrPUSCH(carrier, cfg, device="cpu")
    fd, td, ul = tul.gen_ul_waveform(wf, carrier, [ch],
                                     return_device=return_device)
    np.testing.assert_allclose(fd.numpy(), gold["fd"], atol=3e-5)
    np.testing.assert_allclose(ul.numpy(), gold["ul"], atol=3e-4)
    if return_device:
        assert td is None
    else:
        np.testing.assert_allclose(td.numpy(), gold["td"], atol=3e-4)


@pytest.mark.parametrize("return_device", [False, True])
@pytest.mark.parametrize("nant", [1, 2])
def test_ul_waveform_matches_jax(nant, return_device):
    """The default UL configuration (BW 40, 100 RBs, 256QAM MCS 20,
    122.88 Msps) at 2 slots, on one antenna, and on two (1 layer, 2
    ports, nPMI 1: the antenna roll); random blocks from the JAX run."""
    carrier = merged(get_default_config("ul_carrier"),
                     dict(num_of_ant=nant, Nr=nant))
    cfg = merged(get_default_config("pusch"),
                 dict(nNrOfAntennaPorts=nant, nPMI=nant - 1))
    wf = merged(get_default_config("ul_waveform"), dict(numofslots=2))
    np.random.seed(9)
    jch = jpusch.NrPUSCH(carrier, cfg)
    drawn, draw = [], jch.get_trblk
    jch.get_trblk = lambda tbsize: drawn.append(draw(tbsize)) or drawn[-1]
    fd_j, td_j, ul_j = jul.gen_ul_waveform(wf, carrier, [jch],
                                           return_device=return_device)
    tch = tpusch.NrPUSCH(carrier, cfg, device="cpu")
    trblks = np.stack(drawn * 2)     # rv [0, 2, 3, 1]: one block, 2 slots
    assert len(drawn) == 1
    fd, td, ul = tul.gen_ul_waveform(wf, carrier, [tch],
                                     return_device=return_device,
                                     trblks=trblks)
    np.testing.assert_allclose(fd.numpy(), np.asarray(fd_j), atol=1e-5)
    assert ul.shape == (nant, 2 * 2 * 30720)       # 2 slots, oversample 2
    np.testing.assert_allclose(ul.numpy(), np.asarray(ul_j), atol=1.2e-4)
    if return_device:
        assert td is None and td_j is None
    else:
        np.testing.assert_allclose(td.numpy(), np.asarray(td_j), atol=1e-5)


def test_unported_entry_points_raise():
    """A UCI config is not batch-capable (it takes the per-slot branch,
    held against the JAX package in tests/test_torch_pusch_uci.py), and
    trblks= goes with one PUSCH only. (SRS and PUCCH lists are ported:
    tests/test_torch_ul_control.py.)"""
    carrier, cfg, wf = _golden_wave_config()
    ch = tpusch.NrPUSCH(carrier, cfg, device="cpu")
    uci = tpusch.NrPUSCH(carrier, dict(cfg, EnableACK=1, NumACKBits=2),
                         device="cpu")
    assert not uci.tx_batch_supported()
    with pytest.raises(ValueError):
        tul.gen_ul_waveform(wf, carrier, [uci, ch], trblks=np.zeros(
            (2, ch.tbsize), np.int8))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpusch.NrPUSCH(carrier, cfg)


def test_ul_waveform_branches_agree_at_any_start_slot():
    """Both branches count the slot phase from startslot: at startslot 1
    on a carrier whose slot is not a whole number of turns the waveforms
    still agree (1.2e-4)."""
    carrier = merged(get_default_config("ul_carrier"),
                     dict(carrier_frequency_in_mhz=3500.0011))
    cfg = merged(get_default_config("pusch"),
                 dict(nNrOfAntennaPorts=1, nPMI=0, data_source=[1, 0, 1]))
    wf = merged(get_default_config("ul_waveform"),
                dict(numofslots=2, startslot=1))
    uls = [tul.gen_ul_waveform(wf, carrier,
                               [tpusch.NrPUSCH(carrier, cfg, device="cpu")],
                               return_device=rd)[2] for rd in (False, True)]
    assert (uls[0] - uls[1]).abs().max().item() < 1.2e-4
