"""PyTorch port, the rest of the link-level PDSCH slice: fading channel,
channel estimation, equalization, demodulation, the slot-batched RX and
the sweep end to end, held against the reference goldens and the JAX
package on identical inputs (the JAX run's own random draws are handed
to the port through interop.state_from_numpy).

Tolerances: IQ after the channel 1e-5 relative to the signal scale;
channel estimates 1e-4 relative (float32 FFT/matmul order); equalizer
outputs as tests/test_rx.py against the float64 reference; recovered
LLRs 1e-3 relative to their largest magnitude (float32 inverses of the
per-RE 4x4 covariance); decode flags and TB bits exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.golden import get_golden

from python_5gtoolbox_tpu.models import channel as jchan
from python_5gtoolbox_tpu.phy import pdsch as jpdsch
from python_5gtoolbox_tpu.rx import ce_jax
from python_5gtoolbox_tpu.rx import demod as jdemod
from python_5gtoolbox_tpu.rx import equalize as jeq
from python_5gtoolbox_tpu.utils import numerology as num
from python_5gtoolbox_tpu.utils.config import get_default_config, merged
from scripts.internal import sim_pdsch_throughput_internal as jsim

from python_5gtoolbox_tpu_torch.interop import state_from_numpy
from python_5gtoolbox_tpu_torch.models import channel as tchan
from python_5gtoolbox_tpu_torch.phy import pdsch as tpdsch
from python_5gtoolbox_tpu_torch.rx import ce_batch
from python_5gtoolbox_tpu_torch.rx import demod as tdemod
from python_5gtoolbox_tpu_torch.rx import equalize as teq
from python_5gtoolbox_tpu_torch.sim import pdsch_throughput as tsim


def _no_golden_gen():
    raise RuntimeError("golden file missing")


def _rel_err(got, ref):
    return np.abs(np.asarray(got) - np.asarray(ref)).max() / \
        np.abs(np.asarray(ref)).max()


def _jax_draws(chan_cfg, pnoise_db, fc, fs, scs, seed, n):
    """The fading taps and AWGN that jax NrChannelModel(seed).filter
    draws for an n-sample waveform, in its key order."""
    m = jchan.NrChannelModel(chan_cfg, pnoise_db, fc, fs, scs, seed=seed)
    taps = [np.asarray(jchan.gen_mimo_channel(
        m._next_key(), m.nt, m.nr, m.rspat, n, m.fs, p[2], p[3], p[4],
        m.fm, m.n_sin)) for p in m.multi_paths]
    k1, k2 = jax.random.split(m._next_key())
    noise = (np.asarray(jax.random.normal(k1, (m.nr, n))),
             np.asarray(jax.random.normal(k2, (m.nr, n))))
    return taps, noise


# ---------------------------------------------------------------------------
# Channel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("timeoff_ns", [0, 130])
def test_channel_filter_with_jax_draws(timeoff_ns):
    paths = [[0, 0, "Rayleigh", 0, 0], [300, -3, "Rician", 6.0, 40]]
    kw = dict(model_format="customized", Nt=2, Nr=4, fm_inHz=200,
              Timeoff_ns=timeoff_ns, multi_paths=paths,
              Rspat_config=("customized", "uniform", "DL", (0.3, 0.6)))
    jc = jchan.gen_channel_model_config(**kw)
    tc = tchan.gen_channel_model_config(**kw)
    np.testing.assert_allclose(tc["Rspat"], jc["Rspat"], atol=1e-7)
    fc, fs, scs, n, seed = 3.84e9, 15.36e6, 30, 4000, 21
    rng = np.random.default_rng(1)
    tx = (rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n))
          ).astype(np.complex64)
    ref = jchan.NrChannelModel(jc, -10.0, fc, fs, scs, seed=seed).filter(tx)
    taps, noise = _jax_draws(jc, -10.0, fc, fs, scs, seed, n)
    st = state_from_numpy(taps=taps, noise=noise, device="cpu")
    model = tchan.NrChannelModel(tc, -10.0, fc, fs, scs, seed=seed,
                                 device="cpu")
    got = model.filter(torch.as_tensor(tx), taps=st["taps"],
                       noise=st["noise"]).numpy()
    assert _rel_err(got, ref) < 1e-5
    np.testing.assert_allclose(model.gen_Dm(3),
                               jchan.NrChannelModel(jc, 0, fc, fs, scs
                                                    ).gen_Dm(3))


def test_rayleigh_generator_statistics():
    """The port draws its own fading (jax.random cannot be reproduced):
    the same mean power as the JAX generator (2: unit variance per I/Q
    branch) over 400 links, and independent links."""
    gen = torch.Generator().manual_seed(3)
    h = tchan.rayleigh_filters(gen, 2000, 200.0, 15.36e6, 30,
                               shape=(400,)).numpy()
    hj = np.asarray(jchan.rayleigh_filters(jax.random.PRNGKey(3), 2000,
                                           200.0, 15.36e6, 30, shape=(400,)))
    power, power_j = np.mean(np.abs(h) ** 2), np.mean(np.abs(hj) ** 2)
    assert abs(power - 2.0) < 0.3 and abs(power_j - 2.0) < 0.3
    c = np.corrcoef(np.abs(h[:200, 0]), np.abs(h[200:, 0]))[0, 1]
    assert abs(c) < 0.2


# ---------------------------------------------------------------------------
# Demodulation and equalization (cases of tests/test_rx.py)
# ---------------------------------------------------------------------------

MODTYPES = ["bpsk", "pi/2-bpsk", "qpsk", "16qam", "64qam", "256qam",
            "1024qam"]


@pytest.mark.parametrize("i", range(len(MODTYPES)))
def test_demod(i):
    gold = get_golden("demod_cases", _no_golden_gen)
    syms, nv = gold[f"sym_{i}"], gold[f"nv_{i}"]
    hard, llr = tdemod.demodulate(torch.as_tensor(syms), MODTYPES[i],
                                  torch.as_tensor(nv))
    np.testing.assert_allclose(llr.numpy(), gold[f"llr_{i}"], rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_array_equal(hard.numpy(), gold[f"hard_{i}"])
    _, jllr = jdemod.demodulate(jnp.asarray(syms), MODTYPES[i],
                                jnp.asarray(nv))
    np.testing.assert_allclose(llr.numpy(), np.asarray(jllr), rtol=1e-6,
                               atol=1e-5)


EQ_CASES = [("ZF", 2, 2), ("ZF-IRC", 4, 2), ("MMSE", 2, 2),
            ("MMSE-IRC", 4, 2), ("MMSE", 4, 4)]


@pytest.mark.parametrize("i", range(len(EQ_CASES)))
def test_equalize(i):
    algo = EQ_CASES[i][0]
    gold = get_golden("equalize_cases", _no_golden_gen)
    y, h, cov = (gold[f"{k}_{i}"].astype(np.complex64)
                 for k in ("y", "h", "cov"))
    fn = teq.zf if algo.startswith("ZF") else teq.mmse
    s, nv = fn(torch.as_tensor(y), torch.as_tensor(h), torch.as_tensor(cov),
               irc=algo.endswith("IRC"))
    llr = teq.equalize_and_demod_traced(
        torch.as_tensor(y), torch.as_tensor(h), torch.as_tensor(cov),
        "16qam", algo)
    np.testing.assert_allclose(s.numpy(), gold[f"s_{i}"], rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(nv.numpy(), gold[f"nv_{i}"], rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(llr.numpy(), gold[f"llr_{i}"], rtol=2e-2,
                               atol=2e-2)
    jllr = jeq.equalize_and_demod_traced(jnp.asarray(y), jnp.asarray(h),
                                         jnp.asarray(cov), "16qam", algo)
    assert _rel_err(llr.numpy(), jllr) < 1e-4


def test_inv_small_matches_jax():
    rng = np.random.default_rng(2)
    for n in (2, 3, 4):
        a = (rng.normal(size=(64, n, n)) + 1j * rng.normal(size=(64, n, n))
             ).astype(np.complex64)
        m = a @ np.conj(np.swapaxes(a, -1, -2)) + np.eye(n, dtype=np.complex64)
        got = teq.inv_small(torch.as_tensor(m)).numpy()
        assert _rel_err(got, jeq.inv_small(jnp.asarray(m))) < 1e-4
        assert _rel_err(got @ m, np.broadcast_to(np.eye(n), m.shape)) < 1e-4


# ---------------------------------------------------------------------------
# Channel estimation
# ---------------------------------------------------------------------------

CE_CASES = [
    dict(CE_algo="DFT", L_symm_left_in_ns=200, L_symm_right_in_ns=200,
         eRB=2, enable_TO_comp=True, enable_FO_est=False,
         enable_FO_comp=False),
    dict(CE_algo="DFT_symmetric", L_symm_left_in_ns=1400,
         L_symm_right_in_ns=1200, eRB=4, enable_TO_comp=True,
         enable_FO_est=True, enable_FO_comp=True),
]


@pytest.mark.parametrize("ce", CE_CASES, ids=["dft", "dft_sym_fo"])
def test_channel_est_batch_matches_jax(ce):
    rng = np.random.default_rng(12)
    s, rbs, nr, nt = 2, 20, 4, 2
    h_ls = (rng.normal(size=(s, 2, rbs * 3, nr, nt))
            + 1j * rng.normal(size=(s, 2, rbs * 3, nr, nt))
            ).astype(np.complex64)
    rs_info = dict(RSSymMap=[2, 11], RE_distance=4,
                   NumCDMGroupsWithoutData=1, scs=30)
    got = ce_batch.channel_est_batch(torch.as_tensor(h_ls), rs_info, ce)
    ref = ce_jax.channel_est_batch(jnp.asarray(h_ls), rs_info, ce)
    assert got["fo_applied"] == ref["fo_applied"]
    for key in ("H", "cov"):
        assert got[key].shape == ref[key].shape
        assert _rel_err(got[key].numpy(), ref[key]) < 1e-4, key
    np.testing.assert_allclose(got["to_avg"].numpy(), np.asarray(
        ref["to_avg"]), rtol=1e-4, atol=1e-12)
    np.testing.assert_allclose(got["fo"].numpy(), np.asarray(ref["fo"]),
                               rtol=1e-3, atol=1e-2)
    res = (rng.normal(size=(s, 12, rbs * 12, nr))
           + 1j * rng.normal(size=(s, 12, rbs * 12, nr))).astype(np.complex64)
    fo = ref["fo"] if ref["fo_applied"] else None
    got_d = ce_batch.comp_data_batch(
        torch.as_tensor(res), 2, 30, torch.tensor(np.array(ref["to_avg"])),
        None if fo is None else torch.tensor(np.array(fo)), ce)
    ref_d = ce_jax.comp_data_batch(jnp.asarray(res), 2, 30, ref["to_avg"],
                                   fo, ce)
    assert _rel_err(got_d.numpy(), ref_d) < 1e-4


# ---------------------------------------------------------------------------
# Slot-batched RX and the sweep (the bench shape at a small size)
# ---------------------------------------------------------------------------

CE = dict(CE_algo="DFT", L_symm_left_in_ns=200, L_symm_right_in_ns=200,
          eRB=2, enable_TO_comp=True, enable_FO_est=False,
          enable_FO_comp=False)
LDPC = dict(L=16, algo="min-sum", alpha=0.8, beta=0.3)
N_SLOTS = 2


def _small_config():
    carrier = merged(get_default_config("dl_carrier"),
                     dict(BW=10, scs=30, num_of_ant=2, Nr=4,
                          maxMIMO_layers=2, PCI=1,
                          carrier_frequency_in_mhz=3840.0))
    pdsch = merged(get_default_config("pdsch"),
                   dict(mcs_index=2, mcs_table="256QAM", num_of_layers=2,
                        rv=[0], data_source=[], StartSymbolIndex=2,
                        NrOfSymbols=12))
    pdsch["ResAlloType1"].update(RBStart=0, RBSize=16)
    pdsch["DMRS"].update(nNIDnSCID=1, NumCDMGroupsWithoutData=1,
                         DMRSAddPos=1)
    pdsch["precoding_matrix"] = np.empty(0)
    kw = dict(model_format="customized", Nt=2, Nr=4, fm_inHz=200,
              multi_paths=[[0, 0, "Rayleigh", 0, 0]])
    return (carrier, pdsch, jchan.gen_channel_model_config(**kw),
            tchan.gen_channel_model_config(**kw))


@pytest.fixture(scope="module")
def rx_grids():
    """A received slot stack (TX grid through a fixed 4x2 channel plus
    AWGN, numpy) at a high and a low SNR."""
    carrier, pdsch, _, _ = _small_config()
    ch = tpdsch.Pdsch(pdsch, carrier, device="cpu")
    blocks = np.random.default_rng(4).integers(0, 2, (N_SLOTS, ch.tbsize),
                                               dtype=np.int8)
    grid = ch.tx_grid_batch(list(range(N_SLOTS)), trblks=blocks
                            ).numpy()                      # (S, 2, 14, nsc)
    rng = np.random.default_rng(6)
    hmat = (rng.normal(size=(4, 2)) + 1j * rng.normal(size=(4, 2))) / 2
    clean = np.einsum("rt,stkf->srkf", hmat, grid).reshape(N_SLOTS, 4, -1)
    noise = (rng.normal(size=clean.shape)
             + 1j * rng.normal(size=clean.shape)) / np.sqrt(2)
    grids = {snr: (clean + 10 ** (-snr / 20) * noise).astype(np.complex64)
             for snr in (20.0, -6.0)}
    return grids, blocks


@pytest.mark.parametrize("snr", [20.0, -6.0])
def test_rx_process_batch_matches_jax(rx_grids, snr):
    carrier, pdsch, _, _ = _small_config()
    rx, blocks = rx_grids[0][snr], rx_grids[1]
    slots = list(range(N_SLOTS))
    jch = jpdsch.Pdsch(pdsch, carrier)
    ok_j, tb_j, llr_j = jch.rx_process_batch(
        rx, slots, {"algo": "MMSE-IRC"}, LDPC, CE, return_llr=True)
    tch = tpdsch.Pdsch(pdsch, carrier, device="cpu")
    ok_t, tb_t, llr_t = tch.rx_process_batch(
        rx, slots, {"algo": "MMSE-IRC"}, LDPC, CE, return_llr=True)
    llr_j = np.asarray(llr_j)
    assert llr_t.shape == llr_j.shape
    assert _rel_err(llr_t.numpy(), llr_j) < 1e-3
    if snr > 0:
        assert ok_t.all()
        np.testing.assert_array_equal(ok_t, ok_j)
        np.testing.assert_array_equal(tb_t, tb_j)
        np.testing.assert_array_equal(tb_t, blocks)
    else:
        assert not np.asarray(ok_j).any() and not ok_t.any()


def _jax_states(carrier, tbs, jc, snrs, seed, np_seed):
    """Per-SNR draws of a JAX sweep (run_pdsch_throughput or
    run_pusch_throughput at the carrier rate, scs 30, seed, N_SLOTS
    slots, transport blocks of tbs bits) after np.random.seed(np_seed)."""
    scs = carrier["scs"]
    fs = num.fft_size(num.carrier_prb_size(scs, carrier["BW"])) * scs * 1e3
    n = N_SLOTS * 15 * num.fft_size(num.carrier_prb_size(scs, carrier["BW"]))
    rs = np.random.RandomState(np_seed)
    states = []
    for i, snr in enumerate(snrs):
        taps, noise = _jax_draws(jc, -snr, carrier["carrier_frequency_in_mhz"]
                                 * 1e6, fs, scs, seed + 7919 * i, n)
        blocks = np.stack([rs.randint(2, size=tbs) for _ in range(N_SLOTS)])
        states.append(state_from_numpy(trblks=blocks, taps=taps, noise=noise,
                                       device="cpu"))
    return states


def test_sweep_front_end_matches_jax():
    """TX waveform -> channel -> RX filter and low-PHY on the JAX run's
    draws: the received grids agree."""
    carrier, pdsch, jc, tc = _small_config()
    snr, seed = 3.0, 5
    np.random.seed(13)
    _, _, rx_j = jsim.pdsch_before_ceq_processing(
        carrier, pdsch, jc, -snr, N_SLOTS, seed, CE, do_ce=False,
        return_full=True)
    st = _jax_states(carrier, jpdsch.Pdsch(pdsch, carrier).tbsize, jc, [snr],
                     seed, 13)[0]
    _, slots, rx_t = tsim.pdsch_before_ceq_processing(
        carrier, pdsch, tc, -snr, N_SLOTS, seed, device="cpu", state=st)
    assert slots == list(range(N_SLOTS))
    assert _rel_err(rx_t.numpy(), rx_j) < 1e-5


def test_sweep_end_to_end_matches_jax():
    carrier, pdsch, jc, tc = _small_config()
    snrs, seed = [-9.0, 20.0], 3
    np.random.seed(11)
    ref = jsim.run_pdsch_throughput(carrier, pdsch, jc, snrs,
                                    ceq_algo_list=["MMSE-IRC"],
                                    n_slots=N_SLOTS, ce_config=CE,
                                    ldpc_config=LDPC, seed=seed)
    states = _jax_states(carrier, jpdsch.Pdsch(pdsch, carrier).tbsize, jc,
                         snrs, seed, 11)
    got = tsim.run_pdsch_throughput(carrier, pdsch, tc, snrs, ["MMSE-IRC"],
                                    n_slots=N_SLOTS, ce_config=CE,
                                    ldpc_config=LDPC, seed=seed,
                                    device="cpu", states=states)
    assert got == ref
    assert got["MMSE-IRC"][-1] == 1.0


def test_sweep_own_draws_and_device_default():
    carrier, pdsch, _, tc = _small_config()
    got = tsim.run_pdsch_throughput(carrier, pdsch, tc, [25.0],
                                    ["MMSE-IRC"], n_slots=N_SLOTS,
                                    ce_config=CE, ldpc_config=LDPC,
                                    device="cpu")
    assert got["MMSE-IRC"] == [1.0]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsim.run_pdsch_throughput(carrier, pdsch, tc, [25.0],
                                      ["MMSE-IRC"], n_slots=N_SLOTS)
