"""PyTorch port, UL control: PUCCH formats 0-4 and the SRS against the
ul_channels golden (the cases of tests/test_ul_channels.py: RE usage
equal, fd within that test's 3e-5), and the composed gen_ul_waveform
(PUSCH + PUCCH formats 0-4 + a 4-port SRS, and the same list without
the PUSCH; sim/gen_nr_testmodel.py:ul_multichannel_config at BW 40, 4
antennas, 2 slots, startslot 0) against the JAX package's on the same
configurations: fd within 3e-5, td and ul within 3e-4, the tolerances
of tests/test_ul_channels.py:170-172.
"""
import numpy as np
import pytest
import torch

from tests.golden import get_golden
from tests.test_ul_channels import PUCCH_CASES, SRS_CASES

from python_5gtoolbox_tpu.waveform import ul as jul

from python_5gtoolbox_tpu_torch.phy import pucch as tpucch
from python_5gtoolbox_tpu_torch.phy import srs as tsrs
from python_5gtoolbox_tpu_torch.sim.gen_nr_testmodel import \
    ul_multichannel_config
from python_5gtoolbox_tpu_torch.utils.config import get_default_config, merged
from python_5gtoolbox_tpu_torch.utils.numerology import carrier_prb_size
from python_5gtoolbox_tpu_torch.waveform import ul as tul

N_RE = 14 * 12 * carrier_prb_size(30, 40)


def _no_golden_gen():
    raise RuntimeError("golden file missing")


@pytest.fixture(scope="module")
def golden():
    return get_golden("ul_channels", _no_golden_gen)


def _grid(nant):
    return (torch.zeros((nant, N_RE), dtype=torch.complex64),
            np.zeros((nant, N_RE), np.int8))


@pytest.mark.parametrize("i", range(len(PUCCH_CASES)))
def test_pucch_matches_golden(golden, i):
    fmt, over, sfn, slot = PUCCH_CASES[i]
    cfg = merged(get_default_config(f"pucch_format{fmt}"), over)
    carrier = merged(get_default_config("ul_carrier"),
                     dict(BW=40, scs=30, num_of_ant=1, Nr=1))
    ch = getattr(tpucch, f"NrPUCCHFormat{fmt}")(carrier, cfg, device="cpu")
    fd, usage = ch.process(*_grid(1), sfn, slot)
    np.testing.assert_array_equal(usage, golden[f"pucch_usage_{i}"])
    np.testing.assert_allclose(fd.numpy(), golden[f"pucch_fd_{i}"],
                               atol=3e-5)


@pytest.mark.parametrize("i", range(len(SRS_CASES)))
def test_srs_matches_golden(golden, i):
    cfg = merged(get_default_config("srs"), SRS_CASES[i])
    carrier = merged(get_default_config("ul_carrier"),
                     dict(BW=40, scs=30, num_of_ant=4, Nr=4))
    fd, usage = tsrs.NrSRS(carrier, cfg, device="cpu").process(*_grid(4),
                                                               0, 0)
    np.testing.assert_array_equal(usage, golden[f"srs_usage_{i}"])
    np.testing.assert_allclose(fd.numpy(), golden[f"srs_fd_{i}"], atol=3e-5)


def test_srs_collision_rules():
    """As the JAX class: PDSCH code points on the first SRS symbol raise;
    a symbol holding PDCCH code points is skipped."""
    cfg = merged(get_default_config("srs"), SRS_CASES[1])
    carrier = merged(get_default_config("ul_carrier"),
                     dict(BW=40, scs=30, num_of_ant=4, Nr=4))
    ch = tsrs.NrSRS(carrier, cfg, device="cpu")
    n_sc = N_RE // 14
    first, second = tsrs.get_srs_info(cfg, 0)["srs_symbols"]
    fd, usage = _grid(4)
    usage[0, first * n_sc] = tsrs.RE_USAGE["PDSCH-DATA"]
    with pytest.raises(AssertionError, match="first SRS symbol"):
        ch.process(fd, usage, 0, 0)
    fd, usage = _grid(4)
    usage[0, first * n_sc] = tsrs.RE_USAGE["PDCCH-DATA"]
    ch.process(fd, usage, 0, 0)
    assert not fd[:, first * n_sc:(first + 1) * n_sc].any()
    assert fd[:, second * n_sc:(second + 1) * n_sc].any()


@pytest.mark.parametrize("with_pusch", [True, False])
def test_composed_ul_waveform_matches_jax(with_pusch):
    kw = ul_multichannel_config(bw=40, n_slots=2, samplerate_in_mhz=122.88)
    kw["pusch_config_list"][0]["data_source"] = [1, 0, 0, 1]
    if not with_pusch:
        kw["pusch_config_list"] = []
    wf, carrier = kw.pop("waveform_config"), kw.pop("carrier_config")
    lists = tul.gen_ul_channel_list(wf, carrier, **kw, device="cpu")
    fd, td, ul = tul.gen_ul_waveform(wf, carrier, *lists)
    fd_j, td_j, ul_j = jul.gen_ul_waveform(
        wf, carrier, *jul.gen_ul_channel_list(wf, carrier, **kw))
    assert fd.device.type == "cpu" and ul.shape == (4, 2 * 2 * 30720)
    assert [len(x) for x in lists] == [int(with_pusch), 1, 1, 1, 1, 1, 1]
    np.testing.assert_allclose(fd.numpy(), fd_j, atol=3e-5)
    np.testing.assert_allclose(td.numpy(), np.asarray(td_j), atol=3e-4)
    np.testing.assert_allclose(ul.numpy(), np.asarray(ul_j), atol=3e-4)
    # every PUCCH format in slot 0, the SRS on its 4 ports in slot 1
    n_sc = N_RE // 14
    slot0 = fd[0, :N_RE].reshape(14, n_sc)
    assert slot0[12:, -120:].abs().sum(1).all()
    assert (fd[:, N_RE:].reshape(4, 14, n_sc)[:, 12:].abs()
            .sum(-1) > 0).all()


def test_channel_list_drops_disabled_configs():
    kw = ul_multichannel_config(bw=40, n_slots=2)
    wf, carrier = kw.pop("waveform_config"), kw.pop("carrier_config")
    kw["pusch_config_list"] = kw["pusch_config_list"] * 2
    kw["pusch_config_list"][0] = dict(kw["pusch_config_list"][0],
                                      enable="False")
    kw["pucch_format3_config_list"][0]["enable"] = "False"
    kw["srs_config_list"] = [dict(kw["srs_config_list"][0], enable="False")]
    got = tul.gen_ul_channel_list(wf, carrier, **kw, device="cpu")
    want = jul.gen_ul_channel_list(wf, carrier, **kw)
    assert [len(x) for x in got] == [len(x) for x in want] \
        == [1, 0, 1, 1, 1, 0, 1]
    assert all(type(a).__name__ == type(b).__name__
               for ga, wa in zip(got, want) for a, b in zip(ga, wa))
    assert all(ch.device.type == "cpu" for group in got for ch in group)
