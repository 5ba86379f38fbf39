"""PyTorch port, the per-slot channel estimation
(rx/channel_estimate.py:NrChannelEstimation), the DCT models of the
slot-batched CE (rx/ce_batch.py) and the device PRBS (ops/prbs.py:
gen_prbs), against the ce_symmetric_cases golden and the JAX package:
the NumPy class of python_5gtoolbox_tpu/rx/channel_estimate.py on the
cases of tests/test_ce_jax.py, and rx/ce_jax.py:channel_est_batch.

Tolerances: H and cov within 2e-4 of their scale (the golden's 2e-4);
the timing offset as tests/test_ce_jax.py bounds it (2e-9 s + 1e-3
relative), the frequency offset 1e-2 Hz + 1e-3 relative; the compensated
data REs 2e-4 of scale; the batched DCT CE 1e-4 of scale against
ce_jax (tests/test_ce_jax.py allows 2e-3 against the NumPy class); PRBS
bits exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.golden import get_golden
from tests.test_ce_jax import CASES, _mk_hls
from tests.test_channel_estimate import CASES as SYM_CASES

from python_5gtoolbox_tpu.ops import prbs as jprbs
from python_5gtoolbox_tpu.rx import ce_jax
from python_5gtoolbox_tpu.rx import channel_estimate as jce

from python_5gtoolbox_tpu_torch.ops import prbs as tprbs
from python_5gtoolbox_tpu_torch.rx import ce_batch
from python_5gtoolbox_tpu_torch.rx import channel_estimate as tce


def _no_golden_gen():
    raise RuntimeError("golden file missing")


@pytest.fixture(scope="module")
def sym_goldens():
    return get_golden("ce_symmetric_cases", _no_golden_gen)


@pytest.mark.parametrize("i", range(len(SYM_CASES)))
def test_symmetric_ce_golden(sym_goldens, i):
    algo, sym_num, _, _, _ = SYM_CASES[i]
    rs_info = {"RE_distance": 2, "scs": 30, "RSSymMap": [2, 7][:sym_num],
               "NumCDMGroupsWithoutData": 2}
    ce_cfg = {"CE_algo": algo, "L_symm_left_in_ns": 1400,
              "L_symm_right_in_ns": 1200, "eRB": 4}
    h, cov = tce.dft_dct_channel_estimate(
        torch.as_tensor(sym_goldens[f"hls_{i}"]), rs_info, ce_cfg,
        algo.replace("_symmetric", ""), symmetric=True)
    np.testing.assert_allclose(h.numpy(), sym_goldens[f"h_{i}"], rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(cov.numpy(), sym_goldens[f"cov_{i}"],
                               rtol=2e-4, atol=2e-4)


def _case_inputs(case):
    rng = np.random.default_rng(11)
    s, n_sym, re_num, nr, nt = 3, case["sym"], 60, 4, 2
    rs_map = {1: [2], 2: [2, 11], 3: [2, 7, 11]}[n_sym]
    h_ls = _mk_hls(rng, s, n_sym, re_num, nr, nt,
                   fo_hz=40.0 if case["fo"] else 0.0, to_s=2e-7)
    rs_info = dict(RSSymMap=rs_map, RE_distance=4,
                   NumCDMGroupsWithoutData=1, scs=30)
    ce_cfg = dict(CE_algo=case["algo"], L_symm_left_in_ns=1400,
                  L_symm_right_in_ns=1200, eRB=4, enable_TO_comp=True,
                  enable_FO_est=case["fo"] and n_sym > 1,
                  enable_FO_comp=case["fo"] and n_sym > 1)
    data = (rng.normal(size=(12, 240, nr))
            + 1j * rng.normal(size=(12, 240, nr))).astype(np.complex64)
    return h_ls, rs_info, ce_cfg, data


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["algo"])
def test_per_slot_class_matches_jax_numpy_class(case):
    h_ls, rs_info, ce_cfg, data = _case_inputs(case)
    for i in range(h_ls.shape[0]):
        ref = jce.NrChannelEstimation(h_ls[i].copy(), dict(rs_info),
                                      dict(ce_cfg))
        H_ref, cov_ref = ref.channel_est()
        est = tce.NrChannelEstimation(torch.as_tensor(h_ls[i]),
                                      dict(rs_info), dict(ce_cfg))
        H, cov = est.channel_est()
        assert np.abs(H.numpy() - H_ref).max() < 2e-4 * np.abs(H_ref).max()
        assert np.abs(cov.numpy() - cov_ref).max() \
            < 2e-4 * np.abs(cov_ref).max()
        to_ref = np.mean(ref.TO_est)
        assert abs(float(est.TO_est.mean()) - to_ref) \
            < 2e-9 + 1e-3 * abs(to_ref)
        assert est.FO_status == ref.FO_status
        if ce_cfg["enable_FO_est"]:
            assert abs(float(est.FO_est) - ref.FO_est) \
                < 1e-2 + 1e-3 * abs(ref.FO_est)
        d_ref = ref.process_pdsch_data(data.copy(), 2)
        d = est.process_pdsch_data(torch.as_tensor(data), 2).numpy()
        assert np.abs(d - d_ref).max() < 2e-4 * np.abs(d_ref).max()


def test_per_slot_known_frequency_offset():
    """channel_est(freq_offset=) compensates the given offset, as the
    NumPy class does, and refuses an unknown algorithm."""
    h_ls, rs_info, ce_cfg, data = _case_inputs(CASES[0])
    ce_cfg = dict(ce_cfg, enable_FO_est=False)
    ref = jce.NrChannelEstimation(h_ls[0].copy(), dict(rs_info), dict(ce_cfg))
    H_ref, _ = ref.channel_est(freq_offset=35.0)
    est = tce.NrChannelEstimation(torch.as_tensor(h_ls[0]), dict(rs_info),
                                  dict(ce_cfg))
    H, _ = est.channel_est(freq_offset=35.0)
    assert np.abs(H.numpy() - H_ref).max() < 2e-4 * np.abs(H_ref).max()
    d_ref = ref.process_pdsch_data(data.copy(), 2)
    d = est.process_pdsch_data(torch.as_tensor(data), 2).numpy()
    assert np.abs(d - d_ref).max() < 2e-4 * np.abs(d_ref).max()
    bad = tce.NrChannelEstimation(torch.as_tensor(h_ls[0]), dict(rs_info),
                                  dict(ce_cfg, CE_algo="LMMSE"))
    with pytest.raises(ValueError):
        bad.channel_est()


@pytest.mark.parametrize("case", [c for c in CASES if "DCT" in c["algo"]],
                         ids=lambda c: c["algo"])
def test_batched_dct_matches_ce_jax(case):
    h_ls, rs_info, ce_cfg, _ = _case_inputs(case)
    ref = jax.jit(lambda h: ce_jax.channel_est_batch(h, rs_info, dict(
        ce_cfg)))(jnp.asarray(h_ls))
    got = ce_batch.channel_est_batch(torch.as_tensor(h_ls), rs_info,
                                     dict(ce_cfg))
    for k in ("H", "cov"):
        r = np.asarray(ref[k])
        assert np.abs(got[k].numpy() - r).max() < 1e-4 * np.abs(r).max()


def test_dct_matrix_is_orthonormal_dct2():
    from scipy import fft
    x = np.random.default_rng(1).normal(size=(3, 53)) \
        + 1j * np.random.default_rng(2).normal(size=(3, 53))
    t = torch.as_tensor(x.astype(np.complex64))
    ref = fft.dct(x.real, norm="ortho") + 1j * fft.dct(x.imag, norm="ortho")
    assert np.abs(ce_batch.dct_ortho(t).numpy() - ref).max() < 1e-5
    back = ce_batch.dct_ortho(torch.as_tensor(ref.astype(np.complex64)),
                              inverse=True).numpy()
    assert np.abs(back - x).max() < 1e-5


@pytest.mark.parametrize("entry", ["NrChannelEstimation",
                                   "dft_dct_channel_estimate"])
def test_numpy_input_goes_to_the_card(entry):
    """A numpy H_LS goes to the card, as every entry point's default
    device, and on a host without one that raises; a tensor keeps its
    device, and numpy data follows the estimator's."""
    h_ls, rs_info, ce_cfg, data = _case_inputs(CASES[0])

    def call(h):
        if entry == "dft_dct_channel_estimate":
            return tce.dft_dct_channel_estimate(h, rs_info, ce_cfg)[0]
        est = tce.NrChannelEstimation(h, dict(rs_info), dict(ce_cfg))
        est.channel_est()
        return est.process_pdsch_data(data, 2)
    assert call(torch.as_tensor(h_ls[0])).device.type == "cpu"
    if torch.cuda.is_available():
        assert call(h_ls[0]).is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(h_ls[0])


def test_fo_clamp_matches_jax():
    assert tce.FO_EST_FM_LIMIT_FRACTION == jce.FO_EST_FM_LIMIT_FRACTION
    for fm, scs in ((0, 30), (60, 30), (61, 30), (200, 15), (30, 15)):
        assert tce.fo_est_valid_for_doppler(fm, scs) \
            == jce.fo_est_valid_for_doppler(fm, scs)


@pytest.mark.parametrize("n,offset", [(1, 0), (5000, 0), (4097, 13)])
def test_device_prbs_matches_host_and_jax(n, offset):
    c = np.array([[0, 1, 12345], [2 ** 31 - 1, 777, 65535 * 2 ** 15 + 1]])
    got = tprbs.gen_prbs(torch.as_tensor(c), n, offset).numpy()
    ref = np.asarray(jprbs.gen_prbs(jnp.asarray(c), n, offset))
    np.testing.assert_array_equal(got, ref)
    for idx in np.ndindex(c.shape):
        np.testing.assert_array_equal(
            got[idx], tprbs.gen_prbs_np(int(c[idx]), n, offset))
    assert tprbs.gen_prbs(torch.tensor(5), 8).shape == (8,)
