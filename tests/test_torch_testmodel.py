"""PyTorch port, the NR-FR1 test models and the multi-channel DL waveform:
gen_nr_tm_cfg against the testmodel_cfg golden, the 20 test-model
waveforms (5 TMs x TDD/FDD x scs 15/30 at BW 10) against the tm_waveforms
golden at tests/test_tm_waveform.py's tolerances (fd, td, dl 2e-4;
per-slot power rtol 1e-3), an all-channel waveform (SSB, CSI-RS, PDCCH,
PDSCH; 2 antennas, 4 slots) against the JAX package on the same payloads
(usage-driven grid fd exact up to 1e-5, td 1e-5, dl 1.2e-4), the
single-PDSCH branch against the composed one at startslot 3, and
sim/gen_nr_testmodel.py end to end.
"""
import copy

import numpy as np
import pytest
import torch

from tests.golden import get_golden
from tests.test_testmodel import TM_CASES, _pdsch_fingerprint
from tests.test_tm_waveform import (BW, DL_PREFIX, FC_MHZ, WF_CASES,
                                    _n_slots, _pin_data, _slot_samples)

from python_5gtoolbox_tpu.phy import testmodel as jtm
from python_5gtoolbox_tpu.waveform import dl as jdl

from python_5gtoolbox_tpu_torch.interop import pin_payloads
from python_5gtoolbox_tpu_torch.phy import testmodel as ttm
from python_5gtoolbox_tpu_torch.phy.csirs import NrCSIRS
from python_5gtoolbox_tpu_torch.phy.pdsch import Pdsch
from python_5gtoolbox_tpu_torch.sim import gen_nr_testmodel as tscript
from python_5gtoolbox_tpu_torch.utils import numerology as num
from python_5gtoolbox_tpu_torch.utils.config import get_default_config
from python_5gtoolbox_tpu_torch.utils.profiling import StageProfiler
from python_5gtoolbox_tpu_torch.waveform import dl as tdl

_LIST_KEYS = ("ssb_config", "pdcch_config_list", "search_space_list",
              "coreset_config_list", "csirs_config_list",
              "pdsch_config_list")


def _no_golden_gen():
    raise RuntimeError("golden file missing")


@pytest.mark.parametrize("i", range(len(TM_CASES)))
def test_tm_cfg(i):
    gold = get_golden("testmodel_cfg", _no_golden_gen)
    got = ttm.gen_nr_tm_cfg(*TM_CASES[i])
    wf, pdcch, pdsch = got[0], got[6], got[7]
    np.testing.assert_allclose(
        np.array([wf["numofslots"], wf["samplerate_in_mhz"] * 100]),
        gold[f"wf_{i}"])
    assert len(pdsch) == gold[f"n_pdsch_{i}"][0]
    for j, row in enumerate(_pdsch_fingerprint(pdsch)):
        np.testing.assert_array_equal(row, gold[f"pdsch_{i}_{j}"])
    np.testing.assert_array_equal(
        np.array([pdcch[0]["period_in_slot"]]
                 + list(pdcch[0]["allocated_slots"])), gold[f"pdcch_{i}"])
    assert got == jtm.gen_nr_tm_cfg(*TM_CASES[i])


@pytest.mark.parametrize("i", range(len(WF_CASES)))
def test_tm_waveform(i):
    gold = get_golden("tm_waveforms", _no_golden_gen)
    tm, duplex, scs = WF_CASES[i]
    wf, carrier, ssb, csirs, coreset, ss, pdcch, pdsch = ttm.gen_nr_tm_cfg(
        scs, BW, duplex, tm, 1 + 3 * i, FC_MHZ)
    wf["numofslots"] = _n_slots(duplex, scs)
    _pin_data(pdcch, pdsch)
    lists = tdl.gen_dl_channel_list(wf, carrier, ssb, pdcch, ss, coreset,
                                    csirs, pdsch, device="cpu")
    fd, td, dl, fs = tdl.gen_dl_waveform(wf, carrier, *lists)
    fd, td, dl = fd.numpy(), td.numpy(), dl.numpy()
    np.testing.assert_allclose(fd, gold[f"fd_{i}"], atol=2e-4, rtol=0)
    assert fs == num.fft_size(num.carrier_prb_size(scs, BW)) * scs * 1000
    np.testing.assert_allclose(td[:, :gold[f"td_{i}"].shape[1]],
                               gold[f"td_{i}"], atol=2e-4, rtol=0)
    np.testing.assert_allclose(dl[:, :DL_PREFIX], gold[f"dl_{i}"],
                               atol=2e-4, rtol=0)
    pow_slots = np.mean(np.abs(_slot_samples(
        dl, wf["numofslots"], scs, wf["samplerate_in_mhz"] * 1e6)) ** 2,
        axis=-1)
    np.testing.assert_allclose(pow_slots, gold[f"dlpow_{i}"], atol=1e-6,
                               rtol=1e-3)


def _grid_and_usage(lists, wf, carrier, module):
    """One slot loop of the package's channel objects (the same loop as
    its gen_dl_waveform) -> the usage maps, to compare exactly."""
    ssb_l, pdsch_l, csirs_l, pdcch_l = lists
    prb = num.carrier_prb_size(carrier["scs"], carrier["BW"])
    shape = (carrier["num_of_ant"], 14 * 12 * prb)
    usages = []
    for slot in range(wf["numofslots"]):
        fd = (torch.zeros(shape, dtype=torch.complex64) if module is tdl
              else np.zeros(shape, np.complex64))
        use = np.zeros(shape, np.int8)
        for ch in (*ssb_l, *csirs_l, *pdcch_l):
            ch.process(fd, use, 0, slot)
        for ch in pdsch_l:
            ch.process(fd, use, slot)
        usages.append(use)
    return np.stack(usages)


def test_multichannel_waveform_matches_jax():
    """SSB + CSI-RS + PDCCH + PDSCH (2 layers), 2 antennas, 4 slots at
    245.76 Msps: random payloads drawn by the port, handed to both
    packages through data_source."""
    kw = tscript.dl_multichannel_config(n_slots=4)
    pin_payloads(np.random.default_rng(3), kw["pdsch_config_list"],
                 kw["pdcch_config_list"])
    wf, carrier = kw["waveform_config"], kw["carrier_config"]
    args = [kw[k] for k in _LIST_KEYS]
    t_lists = tdl.gen_dl_channel_list(wf, carrier, *args, device="cpu")
    j_lists = jdl.gen_dl_channel_list(wf, carrier, *args)
    assert [len(x) for x in t_lists] == [1, 1, 1, 1]
    fd, td, dl, fs = tdl.gen_dl_waveform(wf, carrier, *t_lists)
    fd_j, td_j, dl_j, fs_j = jdl.gen_dl_waveform(wf, carrier, *j_lists)
    assert fs == fs_j and dl.shape == dl_j.shape
    np.testing.assert_allclose(fd.numpy(), fd_j, atol=1e-5, rtol=0)
    np.testing.assert_allclose(td.numpy(), td_j, atol=1e-5, rtol=0)
    np.testing.assert_allclose(dl.numpy(), dl_j, atol=1.2e-4, rtol=0)
    # every RE-usage code, slot by slot, on fresh objects
    use_t = _grid_and_usage(
        tdl.gen_dl_channel_list(wf, carrier, *args, device="cpu"), wf,
        carrier, tdl)
    use_j = _grid_and_usage(jdl.gen_dl_channel_list(wf, carrier, *args),
                            wf, carrier, jdl)
    np.testing.assert_array_equal(use_t, use_j)
    assert {10, 15, 21, 22, 31, 32} <= set(np.unique(use_t).tolist())


def test_pdsch_asserts_like_jax():
    """A DMRS symbol on the CSI-RS symbol, and a PDSCH over the CORESET,
    raise as in the JAX package."""
    kw = tscript.dl_multichannel_config(n_slots=1)
    wf, carrier = kw["waveform_config"], kw["carrier_config"]
    bad_csirs = copy.deepcopy(kw)
    bad_csirs["csirs_config_list"][0]["firstOFDMSymbolInTimeDomain"] = 11
    bad_pdcch = copy.deepcopy(kw)
    bad_pdcch["pdsch_config_list"][0].update(StartSymbolIndex=1,
                                             NrOfSymbols=13)
    for case, pat in ((bad_csirs, "CSI-RS"), (bad_pdcch, "PDCCH")):
        lists = tdl.gen_dl_channel_list(wf, carrier,
                                        *[case[k] for k in _LIST_KEYS],
                                        device="cpu")
        with pytest.raises(AssertionError, match=pat):
            tdl.gen_dl_waveform(wf, carrier, *lists)


def test_stage_timer_sees_the_composed_stages():
    """prof= (a utils.profiling.StageProfiler) is charged with the
    composed branch's three stages in order, once each, and leaves the
    waveform as it is."""
    kw = tscript.dl_multichannel_config(n_slots=2, samplerate_in_mhz=61.44)
    wf, carrier = kw["waveform_config"], kw["carrier_config"]
    args = [kw[k] for k in _LIST_KEYS]
    rec = StageProfiler("cpu")
    out = [tdl.gen_dl_waveform(wf, carrier, *tdl.gen_dl_channel_list(
        wf, carrier, *args, seed=2, device="cpu"), prof=prof)
        for prof in (None, rec)]
    assert list(rec.stats) == ["slot_grids", "low_phy", "channel_filter"]
    assert [s.calls for s in rec.stats.values()] == [1, 1, 1]
    for a, b in zip(out[0][:3], out[1][:3]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rate_mhz", [61.44, 245.76])
def test_single_pdsch_branch_equals_composed(rate_mhz):
    """One PDSCH at startslot 3: the single-PDSCH branch and the
    composed per-slot branch (forced by a CSI-RS idle in these slots)
    give the same fd and dl."""
    kw = tscript.dl_multichannel_config(n_slots=4, samplerate_in_mhz=rate_mhz)
    wf, carrier = dict(kw["waveform_config"], startslot=3), \
        kw["carrier_config"]
    pdsch = kw["pdsch_config_list"][0]
    pin_payloads(np.random.default_rng(5), [pdsch])
    idle = dict(get_default_config("csirs"), periodicity=20, slotoffset=0)
    out = []
    for others in ({}, dict(nrCSIRS_list=[NrCSIRS(carrier, idle)])):
        ch = Pdsch(pdsch, carrier, device="cpu")
        assert ch.tx_batch_supported()
        out.append(tdl.gen_dl_waveform(wf, carrier, nrPdsch_list=[ch],
                                       **others))
    (fd_a, td_a, dl_a, _), (fd_b, td_b, dl_b, _) = out
    assert td_a is None and td_b is not None
    np.testing.assert_allclose(fd_a.numpy(), fd_b.numpy(), atol=1e-6)
    np.testing.assert_allclose(dl_a.numpy(), dl_b.numpy(), atol=1.2e-4)
    assert dl_a.abs().max() > 0.1


def test_gen_nr_testmodel_script(tmp_path, capsys):
    files = tscript.main(["--device", "cpu", "--seed", "1",
                          "--out-dir", str(tmp_path)])
    assert sorted(files) == sorted(tmp_path.glob("*.npz"))
    assert len(files) == 5
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines] == tscript.TM_list
    with np.load(files[0]) as z:
        assert sorted(z.files) == ["dl_waveform", "samplerate_in_mhz"]
        assert z["dl_waveform"].shape == (1, 20 * 61440)
        assert float(z["samplerate_in_mhz"]) == 61.44
        assert np.isfinite(z["dl_waveform"]).all()
