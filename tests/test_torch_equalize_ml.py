"""PyTorch port, the ML equalizer family (rx/equalize.py: ML, ML2,
MMSE-ML, opt-rank2-ML, each with IRC): the equalize_ml_cases and
equalize_ml2_cases goldens, every algorithm against the JAX package on
the same inputs, the RE-axis split of the candidate tensor, the
slot-batched RX with ML algorithms, and ML2's choice between the card's
kernel and the plain search with its two counters.

Tolerances: the goldens' own (s 1e-3, LLR 2e-2, tests/test_equalize_ml.py);
against the JAX package hard bits exactly, LLRs within 1e-3 of their
largest magnitude, s within 1e-5; split against unsplit exactly.
"""
import types

import numpy as np
import pytest
import torch

from tests.golden import get_golden
from tests.test_equalize_ml import CASES, ML2_CASES, MODTYPE

from python_5gtoolbox_tpu.rx import equalize as jeq

from python_5gtoolbox_tpu_torch import kernels
from python_5gtoolbox_tpu_torch.phy import pdsch as tpdsch
from python_5gtoolbox_tpu_torch.rx import equalize as teq
from python_5gtoolbox_tpu_torch.utils import profiling
from python_5gtoolbox_tpu_torch.utils.config import get_default_config, merged


def _no_golden_gen():
    raise RuntimeError("golden file missing")


@pytest.fixture(scope="module")
def goldens():
    return dict(ml=get_golden("equalize_ml_cases", _no_golden_gen),
                ml2=get_golden("equalize_ml2_cases", _no_golden_gen))


@pytest.mark.parametrize("kind,i", [("ml", i) for i in range(len(CASES))]
                         + [("ml2", i) for i in range(len(ML2_CASES))])
def test_ml_goldens(goldens, kind, i):
    g = goldens[kind]
    algo = (CASES if kind == "ml" else ML2_CASES)[i][0]
    s, nv, hard, llr = teq.channel_equ_and_demod(
        g[f"y_{i}"], g[f"h_{i}"], g[f"cov_{i}"], MODTYPE, {"algo": algo},
        device="cpu")
    np.testing.assert_allclose(s.numpy(), g[f"s_{i}"], rtol=1e-3, atol=1e-3,
                               err_msg=algo)
    np.testing.assert_allclose(llr.numpy(), g[f"llr_{i}"], rtol=2e-2,
                               atol=2e-2, err_msg=algo)


def _inputs(modtype, nl, nr=4, n=40, seed=3):
    from python_5gtoolbox_tpu_torch.rx.equalize import constellation
    rng = np.random.default_rng(seed)
    syms, _ = constellation(modtype)
    s = syms[rng.integers(len(syms), size=(n, nl))]
    h = (rng.normal(size=(n, nr, nl))
         + 1j * rng.normal(size=(n, nr, nl))) / np.sqrt(2)
    y = np.einsum("nrl,nl->nr", h, s) + 0.05 * (
        rng.normal(size=(n, nr)) + 1j * rng.normal(size=(n, nr)))
    a = 0.2 * (rng.normal(size=(n, nr, nr)) + 1j * rng.normal(size=(n, nr, nr)))
    cov = a @ a.conj().transpose(0, 2, 1) / 8 + 0.05 * np.eye(nr)
    return [x.astype(np.complex64) for x in (y, h, cov)]


@pytest.mark.parametrize("algo", teq.ML_EQUALIZERS)
@pytest.mark.parametrize("nl", [1, 2])
def test_ml_matches_jax(algo, nl):
    modtype = "16qam" if nl == 2 else "64qam"
    y, h, cov = _inputs(modtype, nl)
    ref = jeq.channel_equ_and_demod(y, h, cov, modtype, {"algo": algo})
    got = teq.channel_equ_and_demod(y, h, cov, modtype, {"algo": algo},
                                    device="cpu")
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    r = np.asarray(ref[3])
    assert np.abs(got[3].numpy() - r).max() <= 1e-3 * np.abs(r).max()
    assert np.abs(got[0].numpy() - np.asarray(ref[0])).max() < 1e-5
    traced = teq.equalize_and_demod_traced(*(torch.as_tensor(v) for v in
                                             (y, h, cov)), modtype, algo)
    assert torch.equal(traced, got[3])


@pytest.mark.parametrize("fn", [teq.ml, teq.ml2], ids=["ml", "ml2"])
@pytest.mark.parametrize("irc", [False, True])
def test_split_equals_unsplit(fn, irc, monkeypatch):
    y, h, cov = (torch.as_tensor(v) for v in _inputs("16qam", 2, n=37))
    whole = fn(y, h, cov, "16qam", irc=irc)
    for budget in (1, 3 * 256 * 4 * 8):        # one RE, three REs a piece
        monkeypatch.setattr(teq, "ML_BYTE_BUDGET", budget)
        parts = fn(y, h, cov, "16qam", irc=irc)
        assert all(torch.equal(a, b) for a, b in zip(whole, parts))


def test_pieces_respect_the_budget():
    pieces = teq._pieces(2880, 65536, 4)
    assert pieces[0] == (0, 256) and pieces[-1][1] == 2880
    assert all(b - a <= 2 ** 29 // (65536 * 4 * 8) for a, b in pieces)
    assert teq._pieces(5, 16, 2) == [(0, 5)]


def test_unknown_algo_refused():
    y, h, cov = (torch.as_tensor(v) for v in _inputs("qpsk", 1, n=4))
    with pytest.raises(ValueError):
        teq.equalize_and_demod_traced(y, h, cov, "qpsk", "ML3")


def test_batched_rx_takes_ml():
    """The slot-batched RX with the ML family decodes a clean 2-layer
    slot stack exactly (the TX grid through a fixed 4x2 channel)."""
    carrier = merged(get_default_config("dl_carrier"),
                     dict(BW=10, scs=30, num_of_ant=2, Nr=4,
                          maxMIMO_layers=2, PCI=1))
    pdsch = merged(get_default_config("pdsch"),
                   dict(mcs_index=4, mcs_table="256QAM", num_of_layers=2,
                        rv=[0], data_source=[], StartSymbolIndex=2,
                        NrOfSymbols=12))
    pdsch["ResAlloType1"].update(RBStart=0, RBSize=16)
    pdsch["DMRS"].update(NumCDMGroupsWithoutData=1, DMRSAddPos=1)
    pdsch["precoding_matrix"] = np.empty(0)
    ch = tpdsch.Pdsch(pdsch, carrier, device="cpu")
    blocks = np.random.default_rng(4).integers(0, 2, (2, ch.tbsize),
                                               dtype=np.int8)
    grid = ch.tx_grid_batch([0, 1], trblks=blocks).numpy()
    rng = np.random.default_rng(6)
    hmat = (rng.normal(size=(4, 2)) + 1j * rng.normal(size=(4, 2))) / 2
    rx = np.einsum("rt,stkf->srkf", hmat, grid).reshape(2, 4, -1)
    rx = (rx + 0.01 * (rng.normal(size=rx.shape)
                       + 1j * rng.normal(size=rx.shape))).astype(np.complex64)
    ce = dict(CE_algo="DCT", L_symm_left_in_ns=200, L_symm_right_in_ns=200,
              eRB=2, enable_TO_comp=True, enable_FO_est=False,
              enable_FO_comp=False)
    ldpc = dict(L=16, algo="min-sum", alpha=0.8, beta=0.3)
    for algo in ("ML-IRC-soft", "ML2-IRC-soft", "MMSE-ML", "opt-rank2-ML-IRC"):
        ok, tb = ch.rx_process_batch(rx, [0, 1], {"algo": algo}, ldpc, ce)
        assert ok.all(), algo
        np.testing.assert_array_equal(tb, blocks)


@pytest.mark.parametrize("nl", [1, 2, 3])
def test_ml2_route_sends_cpu_tensors_to_the_plain_search(nl):
    """A CPU tensor takes the plain search whatever its shape, and
    launches nothing."""
    y, h, cov = (torch.as_tensor(v) for v in _inputs("qpsk", nl, n=6))
    assert not teq.ml2_on_kernel(h, "qpsk")
    before = dict(kernels.LAUNCHES)
    assert torch.equal(teq.ml2(y, h, cov, "qpsk", irc=True)[3],
                       teq.ml2_plain(y, h, cov, "qpsk", irc=True)[3])
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("shape,modtype,on_kernel", [
    ((5, 4, 2), "64qam", True), ((5, 4, 1), "256QAM", True),
    ((5, 8, 2), "qpsk", True), ((5, 4, 3), "qpsk", False),
    ((5, 9, 2), "16qam", False), ((5, 4, 2), "1024qam", False)])
def test_ml2_route_on_a_cuda_tensor(shape, modtype, on_kernel):
    """On a CUDA tensor the kernel takes NL <= 2, Nr <= 8 and Qm <= 8;
    three layers (and what else it does not take) go to the plain search.
    The chooser reads only is_cuda and the shape, so a stand-in shows it
    without a card."""
    h = types.SimpleNamespace(is_cuda=True, shape=shape)
    assert teq.ml2_on_kernel(h, modtype) is on_kernel


def test_ml2_counts_plain_res_under_a_profiler():
    y, h, cov = (torch.as_tensor(v) for v in _inputs("16qam", 2, n=13))
    prof = profiling.StageProfiler("cpu")
    with prof.stage("rx"):
        teq.ml2(y, h, cov, "16qam", irc=True)
        teq.ml2(y[:5], h[:5], cov[:5], "16qam")
    assert prof.counters == {"ml2_plain_res": 18}


def test_ml2_counts_nothing_without_a_profiler():
    y, h, cov = (torch.as_tensor(v) for v in _inputs("16qam", 2, n=7))
    prof = profiling.StageProfiler("cpu")
    assert profiling.active() is None
    teq.ml2(y, h, cov, "16qam", irc=True)
    assert prof.counters == {}
