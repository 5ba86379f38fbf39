"""PyTorch port, PDSCH TX: transport block sizes, DLSCH coding, the
slot-batched grid and the DL waveform, held against the reference goldens
and the JAX package on the same transport blocks.

Coded bits must match exactly, grids within 1e-6 (the same float32
QAM/DMRS values, precoded), waveforms within 1e-5 (IQ) after the OFDM
and 1.2e-4 after the channel FIR.
"""
import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.golden import get_golden
from tests.test_pdsch import PDSCH_SLOT_CASES

from python_5gtoolbox_tpu.phy import pdsch as jpdsch
from python_5gtoolbox_tpu.utils.config import get_default_config, merged
from python_5gtoolbox_tpu.waveform import dl as jdl

from python_5gtoolbox_tpu_torch.phy import pdsch as tpdsch
from python_5gtoolbox_tpu_torch.phy import ssb as tssb
from python_5gtoolbox_tpu_torch.phy import tbsize as T
from python_5gtoolbox_tpu_torch.utils.numerology import carrier_prb_size
from python_5gtoolbox_tpu_torch.waveform import dl as tdl


def _no_golden_gen():
    raise RuntimeError("golden file missing")


# cases of tests/test_pdsch.py
TBS_CASES = [
    dict(mcs_table="64QAM", mcs_index=0, num_of_layers=1, NrOfSymbols=12,
         RBSize=10, NumCDMGroupsWithoutData=2, DMRSAddPos=0),
    dict(mcs_table="64QAM", mcs_index=3, num_of_layers=1, NrOfSymbols=12,
         RBSize=10, NumCDMGroupsWithoutData=1, DMRSAddPos=0),
    dict(mcs_table="64QAM", mcs_index=10, num_of_layers=2, NrOfSymbols=12,
         RBSize=40, NumCDMGroupsWithoutData=2, DMRSAddPos=1),
    dict(mcs_table="64QAM", mcs_index=18, num_of_layers=4, NrOfSymbols=12,
         RBSize=100, NumCDMGroupsWithoutData=2, DMRSAddPos=2),
    dict(mcs_table="256QAM", mcs_index=26, num_of_layers=4, NrOfSymbols=12,
         RBSize=273, NumCDMGroupsWithoutData=2, DMRSAddPos=3),
    dict(mcs_table="256QAM", mcs_index=27, num_of_layers=4, NrOfSymbols=12,
         RBSize=273, NumCDMGroupsWithoutData=2, DMRSAddPos=0),
    dict(mcs_table="64QAMLowSE", mcs_index=7, num_of_layers=2,
         NrOfSymbols=10, RBSize=52, NumCDMGroupsWithoutData=2, DMRSAddPos=1),
    dict(mcs_table="64QAM", mcs_index=18, num_of_layers=4, NrOfSymbols=12,
         RBSize=20, NumCDMGroupsWithoutData=2, DMRSAddPos=2),
]


def _apply_case(cfg, case):
    cfg = copy.deepcopy(cfg)
    for k in ("mcs_table", "mcs_index", "num_of_layers", "NrOfSymbols"):
        cfg[k] = case[k]
    cfg["ResAlloType1"]["RBSize"] = case["RBSize"]
    cfg["DMRS"]["NumCDMGroupsWithoutData"] = case["NumCDMGroupsWithoutData"]
    cfg["DMRS"]["DMRSAddPos"] = case["DMRSAddPos"]
    return cfg


@pytest.mark.parametrize("i", range(len(TBS_CASES)))
def test_tbsize(i):
    gold = get_golden("pdsch_tbs", _no_golden_gen)[f"tbs_{i}"]
    cfg = _apply_case(get_default_config("pdsch"), TBS_CASES[i])
    tbsize, qm, rate = T.gen_tbsize(cfg)
    np.testing.assert_array_equal(
        np.array([tbsize, qm, rate * 2, T.gen_tbs_lbrm(cfg, 273, 4)]), gold)


@pytest.mark.parametrize("i", range(4))
def test_dlsch_encode_golden(i):
    gold = get_golden("pdsch_dlsch", _no_golden_gen)
    tbsize, qm, rate2, layers, rv, lbrm, G = \
        [int(x) for x in gold[f"meta_{i}"]]
    trblk = gold[f"trblk_{i}"]
    got = tpdsch.dlsch_encode(torch.as_tensor(trblk), tbsize, qm, rate2 / 2,
                              layers, rv, lbrm, G).numpy()
    np.testing.assert_array_equal(got, gold[f"g_{i}"])
    ref = jpdsch.dlsch_encode(jnp.asarray(trblk[None]), tbsize, qm,
                              rate2 / 2, layers, rv, lbrm, G)
    np.testing.assert_array_equal(got, np.asarray(ref)[0])


def _small_config(rv=(0,), add_pos=1, ncdm=1):
    """The bench sweep's shape at a small size (BW 10, 8 RBs, 2x4)."""
    carrier = merged(get_default_config("dl_carrier"),
                     dict(BW=10, scs=30, num_of_ant=2, Nr=4,
                          maxMIMO_layers=2, PCI=1,
                          carrier_frequency_in_mhz=3840.0))
    pdsch = merged(get_default_config("pdsch"),
                   dict(mcs_index=2, mcs_table="256QAM", num_of_layers=2,
                        rv=list(rv), data_source=[], StartSymbolIndex=2,
                        NrOfSymbols=12))
    pdsch["ResAlloType1"].update(RBStart=1, RBSize=8)
    pdsch["DMRS"].update(nNIDnSCID=1, NumCDMGroupsWithoutData=ncdm,
                         DMRSAddPos=add_pos)
    pdsch["precoding_matrix"] = np.empty(0)
    return carrier, pdsch


def _jax_grid_and_blocks(pdsch, carrier, slots, roll_ant, seed):
    """JAX tx_grid_batch with its global-numpy draws, and those draws."""
    ch = jpdsch.Pdsch(pdsch, carrier)
    np.random.seed(seed)
    grid = np.asarray(ch.tx_grid_batch(slots, roll_ant=roll_ant))
    rs = np.random.RandomState(seed)
    blocks, idx = [], -1
    for _ in slots:
        idx = (idx + 1) % len(pdsch["rv"])
        if idx == 0:
            blk = rs.randint(2, size=ch.tbsize).astype(np.int8)
        blocks.append(blk)
    return grid, np.stack(blocks)


@pytest.mark.parametrize("roll_ant", [0, 1])
@pytest.mark.parametrize("rv,ncdm", [((0,), 1), ((0, 2, 3, 1), 2)],
                         ids=["rv0-cdm1", "rvcycle-cdm2"])
def test_tx_grid_batch_matches_jax(roll_ant, rv, ncdm):
    carrier, pdsch = _small_config(rv=rv, ncdm=ncdm)
    slots = [0, 1, 2, 3]
    ref, blocks = _jax_grid_and_blocks(pdsch, carrier, slots, roll_ant, 5)
    ch = tpdsch.Pdsch(pdsch, carrier, device="cpu")
    assert ch.tx_batch_supported()
    got = ch.tx_grid_batch(slots, roll_ant=roll_ant, trblks=blocks).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-6)
    assert ch.rvidx == (len(slots) - 1) % len(rv)


def test_tx_grid_batch_gated_slots():
    carrier, pdsch = _small_config()
    pdsch.update(period_in_slot=2, allocated_slots=[1])
    ch = tpdsch.Pdsch(pdsch, carrier, device="cpu")
    grid = ch.tx_grid_batch([0, 1, 2, 3]).numpy()
    assert not grid[0].any() and not grid[2].any()
    assert grid[1].any() and grid[3].any()


@pytest.mark.parametrize("with_dm", [False, True], ids=["no_dm", "dm"])
def test_dl_waveform_matches_jax(with_dm):
    carrier, pdsch = _small_config()
    scs = carrier["scs"]
    n_slots = 2
    from python_5gtoolbox_tpu.utils import numerology as num
    fs = num.fft_size(num.carrier_prb_size(scs, carrier["BW"])) * scs * 1e3
    wf = dict(numofslots=n_slots, startSFN=0, startslot=0,
              samplerate_in_mhz=fs / 1e6)
    dm = np.full((n_slots, 14), 3e-8) if with_dm else np.zeros((n_slots, 14))
    jch = jpdsch.Pdsch(pdsch, carrier)
    np.random.seed(8)
    fd_j, _, dl_j, fs_j = jdl.gen_dl_waveform(wf, carrier, nrPdsch_list=[jch],
                                              Dm=dm, return_device=True)
    blocks = np.random.RandomState(8).randint(
        2, size=(n_slots, jch.tbsize)).astype(np.int8)
    tch = tpdsch.Pdsch(pdsch, carrier, device="cpu")
    fd_t, _, dl_t, fs_t = tdl.gen_dl_waveform(wf, carrier, nrPdsch_list=[tch],
                                              Dm=dm, trblks=blocks)
    assert fs_t == fs_j
    np.testing.assert_allclose(fd_t.numpy(), np.asarray(fd_j), atol=1e-6)
    dl_j = np.asarray(dl_j)
    assert dl_t.shape == dl_j.shape
    assert np.abs(dl_t.numpy() - dl_j).max() < 1.2e-4


@pytest.mark.parametrize("i", range(len(PDSCH_SLOT_CASES)))
def test_pdsch_slot_golden(i):
    """The per-slot NrSSB.process + Pdsch.process against the pdsch_slot2
    golden (the cases of tests/test_pdsch.py: 1-4 antennas, scs 15 and
    30, FDD and TDD, BW 20-100, an SSB slot, 1-4 layers): usage equal, fd
    within that test's 3e-5."""
    gold = get_golden("pdsch_slot2", _no_golden_gen)
    ci, with_ssb, nant, slot, scs, bw, duplex = PDSCH_SLOT_CASES[i]
    prb = carrier_prb_size(scs, bw)
    cfg = _apply_case(get_default_config("pdsch"), TBS_CASES[ci])
    cfg["ResAlloType1"]["RBSize"] = min(cfg["ResAlloType1"]["RBSize"], prb)
    cfg["data_source"] = [1, 0, 0, 1]
    carrier = merged(get_default_config("dl_carrier"),
                     dict(num_of_ant=nant, maxMIMO_layers=4, BW=bw,
                          scs=scs, duplex_type=duplex))
    fd = torch.zeros((nant, 14 * 12 * prb), dtype=torch.complex64)
    usage = np.zeros((nant, 14 * 12 * prb), np.int8)
    if with_ssb:
        tssb.NrSSB(carrier, get_default_config("ssb"),
                   device="cpu").process(fd, usage, 0, slot)
    tpdsch.Pdsch(cfg, carrier, device="cpu").process(fd, usage, slot)
    np.testing.assert_array_equal(usage, gold[f"usage_{i}"])
    np.testing.assert_allclose(fd.numpy(), gold[f"fd_{i}"], atol=3e-5)
