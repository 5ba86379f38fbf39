"""PyTorch port, SSB / PBCH: the slot grid, the SSB-only waveform and the
standalone SSB waveform (waveform_gen), held against the reference goldens
of tests/test_ssb.py at its tolerances (grids 2e-5, usage exact, the
IFFT-rate and filtered waveforms 2e-4, waveform_gen 2e-6) and against the
JAX package (BCH coded bits exact, grids and IQ 1e-5, the filtered
waveform 1.2e-4).
"""
import numpy as np
import pytest
import torch

from tests.golden import get_golden
from tests.test_ssb import HIFS_CASES, SSB_CASES

from python_5gtoolbox_tpu.phy import ssb as jssb
from python_5gtoolbox_tpu.utils.config import get_default_config, merged
from python_5gtoolbox_tpu.waveform import dl as jdl

from python_5gtoolbox_tpu_torch.phy import ssb as tssb
from python_5gtoolbox_tpu_torch.utils.numerology import carrier_prb_size
from python_5gtoolbox_tpu_torch.waveform import dl as tdl

STANDALONE = [(2, 30.72, 3840), (1, 61.44, 0), (4, 30.72, 3610.08)]


def _no_golden_gen():
    raise RuntimeError("golden file missing")


def _slot_cfgs(i):
    pci, sfn, slot, scs, bw, fc, kssb, ncrb = SSB_CASES[i]
    carrier = merged(get_default_config("dl_carrier"),
                     dict(PCI=pci, scs=scs, BW=bw,
                          carrier_frequency_in_mhz=fc, num_of_ant=2))
    ssb_cfg = merged(get_default_config("ssb"),
                     dict(kSSB=kssb, NSSB_CRB=ncrb))
    if scs == 15:
        ssb_cfg["SSBPattern"] = "Case A"
        ssb_cfg["MIB"]["subCarrierSpacingCommon"] = 0
    return carrier, ssb_cfg, sfn, slot


@pytest.mark.parametrize("i", range(len(SSB_CASES)))
def test_ssb_slot_grid(i):
    gold = get_golden("ssb_slot", _no_golden_gen)
    carrier, ssb_cfg, sfn, slot = _slot_cfgs(i)
    n_sc = 12 * carrier_prb_size(carrier["scs"], carrier["BW"])
    fd = torch.zeros((2, 14 * n_sc), dtype=torch.complex64)
    usage = np.zeros((2, 14 * n_sc), np.int8)
    fd, usage = tssb.NrSSB(carrier, ssb_cfg, device="cpu").process(
        fd, usage, sfn, slot)
    np.testing.assert_allclose(fd.numpy(), gold[f"fd_{i}"], atol=2e-5)
    np.testing.assert_array_equal(usage, gold[f"usage_{i}"])


@pytest.mark.parametrize("hrf", [0, 1])
@pytest.mark.parametrize("sfn", [0, 5, 1023])
def test_bch_and_block_match_jax(sfn, hrf):
    cfg = get_default_config("ssb")
    mib = tssb.gen_bch_mib(cfg, sfn)
    np.testing.assert_array_equal(mib, jssb.gen_bch_mib(cfg, sfn))
    for pci in (0, 501, 1007):
        np.testing.assert_array_equal(
            tssb.bch_encode(mib, cfg, sfn, hrf, pci),
            jssb.bch_encode(mib, cfg, sfn, hrf, pci))
        for lmax, issb in ((4, 3), (8, 6)):
            np.testing.assert_array_equal(
                tssb.gen_ssb_block(mib, cfg, lmax, pci, sfn, hrf, issb),
                jssb.gen_ssb_block(mib, cfg, lmax, pci, sfn, hrf, issb))


def test_ssb_only_waveform():
    """gen_dl_waveform with the SSB alone: the composed branch against
    the ssb_waveform golden and the JAX package."""
    gold = get_golden("ssb_waveform", _no_golden_gen)
    carrier = merged(get_default_config("dl_carrier"), dict(num_of_ant=2))
    ssb_cfg = get_default_config("ssb")
    wf = merged(get_default_config("dl_waveform"), dict(numofslots=4))
    fd, td, dl, fs = tdl.gen_dl_waveform(
        wf, carrier, [tssb.NrSSB(carrier, ssb_cfg, device="cpu")])
    assert fs == gold["fs"][0]
    np.testing.assert_allclose(fd.numpy(), gold["fd"], atol=2e-5)
    np.testing.assert_allclose(td.numpy(), gold["td"], atol=2e-4)
    np.testing.assert_allclose(dl.numpy(), gold["dl"], atol=2e-4)
    fd_j, td_j, dl_j, _ = jdl.gen_dl_waveform(
        wf, carrier, [jssb.NrSSB(carrier, ssb_cfg)])
    np.testing.assert_allclose(fd.numpy(), fd_j, atol=1e-5)
    np.testing.assert_allclose(td.numpy(), td_j, atol=1e-5)
    np.testing.assert_allclose(dl.numpy(), dl_j, atol=1.2e-4)


@pytest.mark.parametrize("i", range(len(STANDALONE)))
def test_ssb_waveform_gen(i):
    gold = get_golden("ssb_standalone_waveform", _no_golden_gen)
    nant, sr, fc = STANDALONE[i]
    carrier = merged(get_default_config("dl_carrier"),
                     dict(num_of_ant=nant, carrier_frequency_in_mhz=fc))
    td = tssb.NrSSB(carrier, get_default_config("ssb"),
                    device="cpu").waveform_gen(
        dict(samplerate_in_mhz=sr, numofslots=4, startSFN=0, startslot=0))
    assert td.shape == gold[f"td_{i}"].shape
    np.testing.assert_allclose(td.numpy(), gold[f"td_{i}"], atol=2e-6)


@pytest.mark.parametrize("i", range(len(HIFS_CASES)))
def test_ssb_waveform_gen_large_ifft(i):
    """ifftsize 8192 and 4096: the CP table scaled up from its 4096
    base (ssb_waveform_hifs)."""
    gold = get_golden("ssb_waveform_hifs", _no_golden_gen)
    nant, sr, fc, ssbscs = HIFS_CASES[i]
    carrier = merged(get_default_config("dl_carrier"),
                     dict(num_of_ant=nant, carrier_frequency_in_mhz=fc))
    ssb_cfg = get_default_config("ssb")
    if ssbscs == 15:
        carrier["scs"] = 15
        ssb_cfg["SSBPattern"] = "Case A"
        ssb_cfg["MIB"]["subCarrierSpacingCommon"] = 0
    wf = dict(samplerate_in_mhz=sr, numofslots=2, startSFN=0, startslot=0)
    td = tssb.NrSSB(carrier, ssb_cfg, device="cpu").waveform_gen(wf)
    assert td.shape == gold[f"td_{i}"].shape
    assert np.abs(gold[f"td_{i}"]).max() > 0
    np.testing.assert_allclose(td.numpy(), gold[f"td_{i}"], atol=2e-6)
    np.testing.assert_allclose(
        td.numpy(), jssb.NrSSB(carrier, ssb_cfg).waveform_gen(wf), atol=1e-6)
