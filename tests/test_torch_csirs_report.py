"""PyTorch port, the CSI report (RI / PMI / CQI): the codebooks, the
channel estimate (within 1e-5) and the reports (RI, PMI and CQI equal)
against the JAX package on the cases of tests/test_csirs_report.py, the
received grids built by that module from the same seeds; and
sim/nr_csirs_report_example.py at one SNR point and one test, its
received grids reported by the JAX package's NrCSIRSReport (equal RI,
PMI, CQI) without compiling the JAX TDL and filter chain.
"""
import numpy as np
import pytest
import torch

from tests.test_csirs_report import _cfgs, _rx_grid

from python_5gtoolbox_tpu.phy import csirs as jcsirs
from python_5gtoolbox_tpu.phy import csirs_report as jrep

from python_5gtoolbox_tpu_torch.phy import csirs as tcsirs
from python_5gtoolbox_tpu_torch.phy import csirs_report as trep
from python_5gtoolbox_tpu_torch.sim import nr_csirs_report_example as ex

CASES = [(2, 3, "000001"), (4, 4, "001"), (4, 5, "000010")]


@pytest.mark.parametrize("ports", [1, 2, 4])
def test_codebooks_match_jax(ports):
    for rank in range(1, ports + 1):
        w, meta = trep.type1_sp_codebook(ports, rank)
        w_j, meta_j = jrep.type1_sp_codebook(ports, rank)
        np.testing.assert_array_equal(w, w_j)
        assert meta == meta_j
    for n_prb in (11, 24, 106, 273):
        assert trep.valid_subband_sizes(n_prb) == \
            jrep.valid_subband_sizes(n_prb)


@pytest.mark.parametrize("ports,row,bits", CASES)
@pytest.mark.parametrize("noise", [0.0, 0.3])
def test_channel_estimate_matches_jax(ports, row, bits, noise):
    carrier, csirs, _ = _cfgs(ports, row, bits)
    rng = np.random.default_rng(1)
    h = (rng.normal(size=(3, ports)) + 1j * rng.normal(size=(3, ports))
         ).astype(np.complex64)
    y = _rx_grid(carrier, csirs, h, 3, noise=noise)
    hh, prbs, n_var = trep.csirs_channel_estimate(
        torch.as_tensor(y), tcsirs.NrCSIRS(carrier, csirs), 0, 0)
    hh_j, prbs_j, n_var_j = jrep.csirs_channel_estimate(
        y, jcsirs.NrCSIRS(carrier, csirs), 0, 0)
    np.testing.assert_array_equal(prbs, prbs_j)
    np.testing.assert_allclose(hh.numpy(), np.asarray(hh_j), atol=1e-5)
    np.testing.assert_allclose(float(n_var), float(n_var_j), rtol=1e-5,
                               atol=1e-9)


def test_channel_estimate_numpy_input_goes_to_the_card():
    """A numpy grid is taken to the card, as every entry point's default
    device; on a host without one that raises."""
    carrier, csirs, _ = _cfgs(*CASES[0])
    h = np.ones((3, 2), np.complex64)
    y = _rx_grid(carrier, csirs, h, 3, noise=0.0)
    nr = tcsirs.NrCSIRS(carrier, csirs)
    if torch.cuda.is_available():
        assert trep.csirs_channel_estimate(y, nr, 0, 0)[0].is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trep.csirs_channel_estimate(y, nr, 0, 0)


def _report_pair(carrier, csirs, rcfg, nrx, y, noise_var):
    got = trep.NrCSIRSReport(carrier, csirs, rcfg, n_rx=nrx,
                             device="cpu").report(torch.as_tensor(y), 0, 0,
                                                  noise_var=noise_var)
    want = jrep.NrCSIRSReport(carrier, csirs, rcfg, n_rx=nrx).report(
        y, 0, 0, noise_var=noise_var)
    return got, want


@pytest.mark.parametrize("ports,row,bits,rank", [
    (2, 3, "000001", 1), (2, 3, "000001", 2),
    (4, 4, "001", 1), (4, 4, "001", 2), (4, 5, "000010", 4)])
def test_pmi_ri_report_matches_jax(ports, row, bits, rank):
    """A channel built from a codebook precoder (the recovery cases):
    the same RI, PMI and CQI."""
    carrier, csirs, rcfg = _cfgs(ports, row, bits)
    w, meta = trep.type1_sp_codebook(ports, rank)
    rng = np.random.default_rng(2)
    g = np.linalg.qr(rng.normal(size=(rank, rank))
                     + 1j * rng.normal(size=(rank, rank)))[0] * 3.0
    h = (g @ w[len(meta) // 2].conj().T).astype(np.complex64)
    nrx = max(rank, 2)
    h = np.concatenate([h, np.zeros((nrx - rank, ports))]).astype(
        np.complex64)
    y = _rx_grid(carrier, csirs, h, nrx, noise=1e-3)
    got, want = _report_pair(carrier, csirs, rcfg, nrx, y, 1e-2)
    # at full rank every scaled-unitary W gives the same MMSE capacity:
    # the PMI is a tie broken by rounding, not identifiable (as in
    # tests/test_csirs_report.py), so only RI and CQI are held there
    keys = ("RI", "CQI", "subbands") + (("PMI",) if rank < ports else ())
    for key in keys:
        assert got[key] == want[key], key
    assert got["RI"] == rank


@pytest.mark.parametrize("snr_db", [-25.0, 0.0, 30.0])
@pytest.mark.parametrize("mode", ["Wideband", "Subband"])
def test_cqi_report_matches_jax(snr_db, mode):
    """Random 4x4 channels at three SNRs, wideband and subband CQI/PMI,
    the blind noise estimate at the high SNR: equal reports."""
    carrier, csirs, rcfg = _cfgs(4, 4, "001")
    rcfg["CQIMode "] = mode
    rcfg["PMIMode "] = mode
    rng = np.random.default_rng(4)
    h = (rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4))
         ).astype(np.complex64)
    nv = 10 ** (-snr_db / 10)
    y = _rx_grid(carrier, csirs, h, 4, noise=np.sqrt(nv))
    got, want = _report_pair(carrier, csirs, rcfg, 4, y,
                             None if snr_db > 20 else nv)
    # the PMI is held below full rank only (see above)
    keys = ("RI", "CQI", "subbands") + (("PMI",) if want["RI"] < 4 else ())
    for key in keys:
        assert got[key] == want[key], key
    assert got.get("subband_CQI") == want.get("subband_CQI")
    np.testing.assert_allclose(got["wideband_SE"], want["wideband_SE"],
                               rtol=1e-4)


def test_subband_size_validation():
    carrier, csirs, rcfg = _cfgs(4, 4, "001")
    rcfg["CQIMode "] = "Subband"
    rcfg["SubbandSize "] = 32  # invalid for 106 PRB (allows 8/16)
    with pytest.raises(AssertionError, match="SubbandSize"):
        trep.NrCSIRSReport(carrier, csirs, rcfg, n_rx=2, device="cpu")


def test_report_example_matches_jax_report(tmp_path):
    """The example at the JAX script's constants, cut to the 0 dB point
    and one test (on the CPU), through main: one report per CSI-RS slot
    of the 2 (slot 0), written to the out dir; the JAX report on the same
    received grid gives the same RI, PMI (below full rank, see above),
    CQI and subband CQI."""
    config = dict(ex.example_config(), snr_db_list=[0.0], total_tests=1)
    rows = ex.main(["--device", "cpu", "--seed", "0", "--out-dir",
                    str(tmp_path)], config=config)
    assert [(r["snr_db"], r["test"], r["slot"]) for r in rows] == \
        [(0.0, 0, 0)]
    assert (tmp_path / config["filename"]).exists()
    want = jrep.NrCSIRSReport(config["carrier"], config["csirs"],
                              config["report"], n_rx=config["n_rx"]).report(
        rows[0]["rx_slot"].numpy(), 0, 0)
    got = rows[0]
    keys = ("RI", "CQI", "subband_CQI") + (
        ("PMI",) if want["RI"] < config["csirs"]["nrofPorts"] else ())
    for key in keys:
        assert got[key] == want.get(key), key
