"""PyTorch port, the 245.76 Msps waveform path: the planar TX low-PHY
entries, the three fused DUC stages (their plain versions: the CUDA
kernels run only on the card, tests/test_torch_cuda.py), tx_lowphy_duc in
all its branches and the oversampled link-level sweep, against the JAX
package on identical inputs.

The Pallas entries are called directly and pick interpret mode themselves
off-TPU, as tests/test_pallas_filters.py runs them. Tolerances: against a
Pallas kernel 1.2e-4 (tests/test_pallas_filters.py: the JAX side carries
its bf16x3 error); against the JAX composed path (tx_low_phy +
tx_channel_filter, XLA float32) 2e-5; the planar OFDM entries 1e-5
(docs/architecture.md principle 4); received grids of the sweep 1e-4
relative; decode flags and TB bits exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from python_5gtoolbox_tpu.models import channel as jchan
from python_5gtoolbox_tpu.ops import filters as jf
from python_5gtoolbox_tpu.ops import ofdm as jofdm
from python_5gtoolbox_tpu.ops import pallas_filters as pf
from python_5gtoolbox_tpu.phy import pdsch as jpdsch
from python_5gtoolbox_tpu.utils import numerology as num
from python_5gtoolbox_tpu.utils.config import get_default_config, merged
from scripts.internal import sim_pdsch_throughput_internal as jsim
from tools.filter_search import aclr_db

from python_5gtoolbox_tpu_torch import kernels
from python_5gtoolbox_tpu_torch.interop import state_from_numpy
from python_5gtoolbox_tpu_torch.models import channel as tchan
from python_5gtoolbox_tpu_torch.ops import filters as tf
from python_5gtoolbox_tpu_torch.ops import ofdm as tofdm
from python_5gtoolbox_tpu_torch.sim import pdsch_throughput as tsim
from python_5gtoolbox_tpu_torch.waveform import rx as trx

PALLAS_TOL = 1.2e-4
XLA_TOL = 2e-5
IQ_TOL = 1e-5
FC = 3_500_000_000
EDGE = 400


def _grid(seed, scs, bw, nant, n_slots):
    n_sc = 12 * num.carrier_prb_size(scs, bw)
    rng = np.random.default_rng(seed)
    shape = (nant, n_slots, 14, n_sc)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)
            ).astype(np.complex64)


def _nfft(scs, bw):
    return num.fft_size(num.carrier_prb_size(scs, bw))


def _close(got, ref, tol):
    """Whole array and, apart, the first and last EDGE samples (where the
    halos are the waveform's ends)."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got[..., :EDGE] - ref[..., :EDGE]).max() < tol
    assert np.abs(got[..., -EDGE:] - ref[..., -EDGE:]).max() < tol
    assert np.abs(got - ref).max() < tol


def _planes(c):
    """complex (A, T) -> (2A, T) real planes, real planes first."""
    c = np.asarray(c)
    return np.concatenate([c.real, c.imag]).astype(np.float32)


def _jax_composed(fd, scs, bw, rate_hz, slot_phase=False, start_slot=0):
    """The JAX composed path: tx_low_phy(roll_ant=False), slot phase,
    tx_channel_filter -> complex (ant, T)."""
    td = jofdm.tx_low_phy(jnp.asarray(fd), scs, bw, FC, roll_ant=False)
    if slot_phase:
        ph = jofdm._slot_phase_const(scs, FC, fd.shape[1], start_slot)
        td = td * jnp.asarray(ph)[None, :, None]
    return np.asarray(jf.tx_channel_filter(td.reshape(fd.shape[0], -1), scs,
                                           bw, rate_hz))


# ---------------------------------------------------------------------------
# Planar TX low-PHY entries
# ---------------------------------------------------------------------------

OFDM_CASES = [(30, 20, 2, 2, True, 3), (15, 5, 1, 2, False, 0),
              (30, 10, 2, 1, True, 0)]


@pytest.mark.parametrize("scs,bw,nant,n_slots,slot_phase,start", OFDM_CASES)
def test_tx_low_phy_planes(scs, bw, nant, n_slots, slot_phase, start):
    fd = _grid(1, scs, bw, nant, n_slots)
    kw = dict(pad=(7, 160), slot_phase=slot_phase, start_slot=start)
    got = tofdm.tx_low_phy_planes(torch.as_tensor(fd), scs, bw, FC, **kw)
    ref = jofdm.tx_low_phy_planes(jnp.asarray(fd), scs, bw, FC, **kw)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=IQ_TOL)
    assert not got[:, :7].any() and not got[:, -160:].any()


@pytest.mark.parametrize("scs,bw,nant,n_slots,slot_phase,start", OFDM_CASES)
def test_tx_low_phy_sym_planes(scs, bw, nant, n_slots, slot_phase, start):
    fd = _grid(2, scs, bw, nant, n_slots)
    kw = dict(slot_phase=slot_phase, start_slot=start)
    got = tofdm.tx_low_phy_sym_planes(torch.as_tensor(fd), scs, bw, FC, **kw)
    ref = jofdm.tx_low_phy_sym_planes(jnp.asarray(fd), scs, bw, FC, **kw)
    assert got.shape == ref.shape == (2 * nant, n_slots, 14, _nfft(scs, bw))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=IQ_TOL)
    # the JAX package's matmul IDFT computes the same values
    both = tofdm.tx_low_phy_sym_planes(torch.as_tensor(fd), scs, bw, FC,
                                       idft="matmul", **kw)
    assert torch.equal(both, got)
    with pytest.raises(ValueError):
        tofdm.tx_low_phy_sym_planes(torch.as_tensor(fd), scs, bw, FC,
                                    idft="dct")


@pytest.mark.parametrize("scs,bw,nant,n_slots,slot_phase,start", OFDM_CASES)
def test_tx_spec_planes(scs, bw, nant, n_slots, slot_phase, start):
    fd = _grid(3, scs, bw, nant, n_slots)
    kw = dict(slot_phase=slot_phase, start_slot=start)
    got = tofdm.tx_spec_planes(torch.as_tensor(fd), scs, bw, FC, **kw)
    ref = np.asarray(jofdm.tx_spec_planes(jnp.asarray(fd), scs, bw, FC, **kw))
    nfft = _nfft(scs, bw)
    assert got.shape == (2 * nant, n_slots, 14, nfft)
    # the JAX shape (.., 14*nfft/128, 128) is the same memory
    np.testing.assert_allclose(got.numpy(), ref.reshape(got.shape),
                               atol=IQ_TOL)


def test_cp_concat_is_tx_low_phy():
    scs, bw = 15, 5
    fd = _grid(4, scs, bw, 2, 2)
    symp = tofdm.tx_low_phy_sym_planes(torch.as_tensor(fd), scs, bw, FC)
    flat = tofdm.cp_concat(symp, tofdm._cp_table(scs, symp.shape[-1]))
    assert flat.shape == (4, 2, tofdm.slot_sample_count(scs, bw))
    td = tofdm.tx_low_phy(torch.as_tensor(fd), scs, bw, FC, roll_ant=False)
    np.testing.assert_allclose(flat.reshape(4, -1).numpy(),
                               _planes(td.reshape(2, -1)), atol=1e-6)


# ---------------------------------------------------------------------------
# fir_up2_fused (flat planes)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [4096, 1000, 130],
                         ids=["t4096", "t1000_not_x128", "t130_short"])
@pytest.mark.parametrize("bw", [100, 25], ids=["fir287", "fir71"])
def test_fir_up2_fused_plain(t, bw):
    fir, hb = jf.fir_coeff(30, bw), jf.halfband_coeff()
    rng = np.random.default_rng(t + bw)
    x = (rng.normal(size=(2, t)) + 1j * rng.normal(size=(2, t))
         ).astype(np.complex64)
    got = tf.fir_up2_fused(torch.as_tensor(x), fir, hb).numpy()
    assert got.dtype == np.complex64
    _close(got, pf.fir_up2_fused(jnp.asarray(x), fir, hb), PALLAS_TOL)
    _close(got, jf.hb_upsample2(jf.fir_same(jnp.asarray(x), fir), hb),
           XLA_TOL)
    planes = tf.fir_up2_fused_planes(torch.as_tensor(_planes(x)), fir, hb)
    np.testing.assert_array_equal(planes.numpy(), _planes(got))


@pytest.mark.parametrize("bw", [10, 5], ids=["fir45", "fir27"])
def test_fir_up2_fused_short_fir_carriers(bw):
    """scs 30 / BW 10 and BW 5 (45 and 27 taps): the port agrees with the
    serial JAX pipeline. The Pallas kernel does not: its frame window
    (K1 = roundup(n1 + 207, 128) = 256 columns) is narrower than the
    336 + (n1 - 1 - n1 // 2) columns its own tap indexing reads, so it
    drops taps for these FIRs; off-TPU nothing reaches it."""
    fir, hb = jf.fir_coeff(30, bw), jf.halfband_coeff()
    rng = np.random.default_rng(bw)
    x = (rng.normal(size=(2, 1000)) + 1j * rng.normal(size=(2, 1000))
         ).astype(np.complex64)
    ref = np.asarray(jf.hb_upsample2(jf.fir_same(jnp.asarray(x), fir), hb))
    _close(tf.fir_up2_fused(torch.as_tensor(x), fir, hb).numpy(), ref,
           XLA_TOL)
    pallas = np.asarray(pf.fir_up2_fused(jnp.asarray(x), fir, hb))
    assert np.abs(pallas - ref).max() > 0.1


def test_mask_between_the_stages_matters():
    """Filtering a zero-padded input through both stages is not the fused
    pair: the FIR tail beyond [0, T) must not reach the halfband."""
    fir, hb = tf.fir_coeff(30, 100), tf.halfband_coeff()
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(1, 600))
                        .astype(np.float32))
    fused = tf.fir_up2_fused_plain(x, fir, hb)
    pad = len(fir)
    wide = tf.banded_fir_plain(
        tf.banded_fir_plain(torch.nn.functional.pad(x, (pad, pad)), fir,
                            "same"), hb, "up2")[:, 2 * pad: 2 * (pad + 600)]
    assert (fused - wide)[:, 40:-40].abs().max() < 1e-5
    assert (fused - wide).abs().max() > 1e-3


# ---------------------------------------------------------------------------
# fir_up2_fused_symbols (CP insertion in the kernel), nfft < 1024
# ---------------------------------------------------------------------------

def _symbols_case(scs, bw, nant, n_slots, seed):
    fd = _grid(seed, scs, bw, nant, n_slots)
    nfft = _nfft(scs, bw)
    cps = jofdm._cp_table(scs, nfft)
    symp = np.asarray(jofdm.tx_low_phy_sym_planes(jnp.asarray(fd), scs, bw,
                                                  FC))
    got = tf.fir_up2_fused_symbols(torch.as_tensor(symp.copy()), cps,
                                   jf.fir_coeff(scs, bw), jf.halfband_coeff())
    return fd, symp, cps, nfft, got.numpy()


@pytest.mark.parametrize("n_slots", [2, 1], ids=["2slots", "1slot"])
def test_fir_up2_fused_symbols_plain(n_slots):
    scs, bw = 15, 5        # the one carrier the Pallas symbol kernel takes
    fd, symp, cps, nfft, got = _symbols_case(scs, bw, 2, n_slots, 5)
    ref = pf.fir_up2_fused_symbols(jnp.asarray(symp), cps,
                                   jf.fir_coeff(scs, bw), jf.halfband_coeff())
    _close(got, ref, PALLAS_TOL)
    _close(got, _planes(_jax_composed(fd, scs, bw, 2 * nfft * scs * 1000)),
           XLA_TOL)


@pytest.mark.parametrize("bw", [10, 5])
def test_fir_up2_fused_symbols_short_fir_carriers(bw):
    """scs 30 / BW 10 and BW 5 (45 and 27 taps): the port serves them; the
    Pallas kernel's frame geometry does not (right halo < 0)."""
    scs = 30
    fd, symp, cps, nfft, got = _symbols_case(scs, bw, 1, 2, 6)
    _close(got, _planes(_jax_composed(fd, scs, bw, 2 * nfft * scs * 1000)),
           XLA_TOL)
    with pytest.raises(AssertionError):
        pf.fir_up2_fused_symbols(jnp.asarray(symp), cps,
                                 jf.fir_coeff(scs, bw), jf.halfband_coeff())


# ---------------------------------------------------------------------------
# duc_from_spec_planes (IDFT in the kernel), nfft >= 1024
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scs,bw,nant,n_slots", [(30, 20, 1, 2),
                                                 (15, 10, 1, 1)],
                         ids=["scs30_bw20_2slots", "scs15_bw10_1slot"])
def test_duc_from_spec_planes_plain(scs, bw, nant, n_slots):
    fd = _grid(7, scs, bw, nant, n_slots)
    nfft = _nfft(scs, bw)
    cps, pc = jofdm._cp_table(scs, nfft), jofdm._phase_comp(scs, nfft, FC)
    fir, hb = jf.fir_coeff(scs, bw), jf.halfband_coeff()
    spec = jofdm.tx_spec_planes(jnp.asarray(fd), scs, bw, FC,
                                slot_phase=True, start_slot=1)
    yr, yi = pf.duc_from_spec_planes(spec, cps, fir, hb, pc)
    spec_t = torch.as_tensor(np.array(spec)).reshape(2 * nant, n_slots, 14,
                                                       nfft)
    gr, gi = tf.duc_from_spec_planes(spec_t, cps, fir, hb, pc)
    assert gr.shape == gi.shape == yr.shape
    _close(gr.numpy(), yr, PALLAS_TOL)
    _close(gi.numpy(), yi, PALLAS_TOL)
    ref = _jax_composed(fd, scs, bw, 2 * nfft * scs * 1000, slot_phase=True,
                        start_slot=1)
    _close(torch.cat([gr, gi]).numpy(), _planes(ref), XLA_TOL)


# ---------------------------------------------------------------------------
# tx_lowphy_duc and tx_channel_filter, every branch
# ---------------------------------------------------------------------------

# (scs, bw, oversample): spectrum kernel at 245.76 Msps, symbol kernel with
# one further up2 stage, composed path at the carrier rate
DUC_BRANCHES = [(30, 20, 8), (15, 5, 4), (30, 10, 1)]


@pytest.fixture(scope="module", params=DUC_BRANCHES,
                ids=["nfft1024_x8", "nfft512_x4", "carrier_rate"])
def duc_case(request):
    scs, bw, over = request.param
    rate = over * _nfft(scs, bw) * scs * 1000
    fd = _grid(8, scs, bw, 2, 2)
    ref = np.asarray(jf.tx_lowphy_duc(jnp.asarray(fd), scs, bw, FC, rate,
                                      slot_phase=True, start_slot=3))
    return scs, bw, rate, fd, ref


@pytest.mark.parametrize("as_planes", [False, True, "split"])
def test_tx_lowphy_duc_matches_jax(duc_case, as_planes):
    scs, bw, rate, fd, ref = duc_case
    before = dict(kernels.LAUNCHES)
    got = tf.tx_lowphy_duc(torch.as_tensor(fd), scs, bw, FC, rate,
                           as_planes=as_planes, slot_phase=True,
                           start_slot=3)
    assert kernels.LAUNCHES == before          # CPU tensors launch nothing
    if as_planes == "split":
        assert got[0].dtype == got[1].dtype == torch.float32
        got = torch.complex(got[0], got[1])
    elif as_planes:
        assert got.dtype == torch.float32 and got.shape[0] == 4
        got = torch.complex(got[:2], got[2:])
    assert got.dtype == torch.complex64
    _close(got.numpy(), ref, XLA_TOL)


def test_tx_lowphy_duc_full_rate_nfft512():
    """scs 15 / BW 5 up to 245.76 Msps: the symbol stage and four further
    halfband stages."""
    scs, bw = 15, 5
    fd = _grid(9, scs, bw, 1, 1)
    got = tf.tx_lowphy_duc(torch.as_tensor(fd), scs, bw, FC, 245.76e6)
    _close(got.numpy(), jf.tx_lowphy_duc(jnp.asarray(fd), scs, bw, FC,
                                         245.76e6), XLA_TOL)


@pytest.mark.parametrize("over", [2, 8])
def test_tx_channel_filter_fused_matches_jax(over):
    scs, bw = 30, 20
    rate = over * _nfft(scs, bw) * scs * 1000
    rng = np.random.default_rng(over)
    x = (rng.normal(size=(2, 3000)) + 1j * rng.normal(size=(2, 3000))
         ).astype(np.complex64)
    got = tf.tx_channel_filter(torch.as_tensor(x), scs, bw, rate)
    _close(got.numpy(), jf.tx_channel_filter(jnp.asarray(x), scs, bw, rate),
           XLA_TOL)
    back = tf.rx_channel_filter(got, scs, bw, rate)
    ref = jf.rx_channel_filter(jnp.asarray(got.numpy()), scs, bw, rate)
    _close(back.numpy(), ref, XLA_TOL)


def test_rate_must_be_power_of_two_multiple():
    fd = torch.as_tensor(_grid(10, 30, 10, 1, 1))
    with pytest.raises(ValueError):
        tf.tx_lowphy_duc(fd, 30, 10, FC, 3 * 15.36e6)


# ---------------------------------------------------------------------------
# The OFDM + DUC run of the waveform bench, small
# ---------------------------------------------------------------------------

def test_run_ofdm_duc_small():
    cfg = tsim.bench_ofdm_duc_config()
    assert (cfg["scs"], cfg["bw"], cfg["n_slots"], cfg["nant"]) == \
        (30, 100, 64, 2)
    cfg = dict(cfg, bw=20, n_slots=2)
    fd = tsim.ofdm_duc_grid(cfg, seed=0, device="cpu")
    assert torch.equal(fd, tsim.ofdm_duc_grid(cfg, seed=0, device="cpu"))
    re, im = tsim.run_ofdm_duc(fd, cfg, device="cpu")
    ref = jf.tx_lowphy_duc(jnp.asarray(fd.numpy()), 30, 20,
                           cfg["carrier_freq_hz"], cfg["out_rate_hz"])
    _close(torch.complex(re, im).numpy(), ref, XLA_TOL)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsim.run_ofdm_duc(fd, cfg)


# ---------------------------------------------------------------------------
# The oversampled link-level sweep against the JAX package, same draws
# ---------------------------------------------------------------------------

CE = dict(CE_algo="DFT", L_symm_left_in_ns=200, L_symm_right_in_ns=200,
          eRB=2, enable_TO_comp=True, enable_FO_est=False,
          enable_FO_comp=False)
LDPC = dict(L=16, algo="min-sum", alpha=0.8, beta=0.3)
N_SLOTS = 2


def _sweep_config(bw, over, second_path=True):
    carrier = merged(get_default_config("dl_carrier"),
                     dict(BW=bw, scs=30, num_of_ant=2, Nr=4,
                          maxMIMO_layers=2, PCI=1,
                          carrier_frequency_in_mhz=3840.0))
    carrier["samplerate_in_mhz"] = over * _nfft(30, bw) * 30e3 / 1e6
    pdsch = merged(get_default_config("pdsch"),
                   dict(mcs_index=2, mcs_table="256QAM", num_of_layers=2,
                        rv=[0], data_source=[], StartSymbolIndex=2,
                        NrOfSymbols=12))
    pdsch["ResAlloType1"].update(RBStart=0, RBSize=16)
    pdsch["DMRS"].update(nNIDnSCID=1, NumCDMGroupsWithoutData=1,
                         DMRSAddPos=1)
    pdsch["precoding_matrix"] = np.empty(0)
    paths = [[0, 0, "Rayleigh", 0, 0]]
    if second_path:
        paths.append([130, -6, "Rayleigh", 0, 0])
    kw = dict(model_format="customized", Nt=2, Nr=4, fm_inHz=200,
              multi_paths=paths)
    return (carrier, pdsch, jchan.gen_channel_model_config(**kw),
            tchan.gen_channel_model_config(**kw))


def _jax_states(carrier, pdsch, jc, snrs, seed, np_seed):
    """Per-SNR draws of the JAX sweep run_pdsch_throughput(seed) after
    np.random.seed(np_seed): fading taps and AWGN at the waveform's sample
    rate and length, in the model's key order, and the transport blocks."""
    scs = carrier["scs"]
    fs = carrier["samplerate_in_mhz"] * 1e6
    over = int(round(fs / (_nfft(scs, carrier["BW"]) * scs * 1000)))
    n = N_SLOTS * 15 * _nfft(scs, carrier["BW"]) * over
    fc = carrier["carrier_frequency_in_mhz"] * 1e6
    tbs = jpdsch.Pdsch(pdsch, carrier).tbsize
    rs = np.random.RandomState(np_seed)
    states = []
    for i, snr in enumerate(snrs):
        m = jchan.NrChannelModel(jc, -snr, fc, fs, scs, seed=seed + 7919 * i)
        taps = [np.asarray(jchan.gen_mimo_channel(
            m._next_key(), m.nt, m.nr, m.rspat, n, m.fs, p[2], p[3], p[4],
            m.fm, m.n_sin)) for p in m.multi_paths]
        k1, k2 = jax.random.split(m._next_key())
        noise = (np.asarray(jax.random.normal(k1, (m.nr, n))),
                 np.asarray(jax.random.normal(k2, (m.nr, n))))
        blocks = np.stack([rs.randint(2, size=tbs) for _ in range(N_SLOTS)])
        states.append(state_from_numpy(trblks=blocks, taps=taps, noise=noise,
                                       device="cpu"))
    return states


@pytest.mark.parametrize("bw,over", [(10, 2), (10, 8), (20, 2)],
                         ids=["symbols_x2", "symbols_x8", "spec_x2"])
def test_oversampled_front_end_matches_jax(bw, over):
    """TX waveform through the fused DUC -> two-path channel at the
    oversampled rate (the second path's delay is a function of fs) -> DDC
    -> RX low-PHY on the JAX run's draws: the received grids agree."""
    carrier, pdsch, jc, tc = _sweep_config(bw, over)
    snr, seed = 3.0, 5
    np.random.seed(13)
    _, _, rx_j = jsim.pdsch_before_ceq_processing(
        carrier, pdsch, jc, -snr, N_SLOTS, seed, CE, do_ce=False,
        return_full=True)
    st = _jax_states(carrier, pdsch, jc, [snr], seed, 13)[0]
    _, slots, rx_t = tsim.pdsch_before_ceq_processing(
        carrier, pdsch, tc, -snr, N_SLOTS, seed, device="cpu", state=st)
    assert slots == list(range(N_SLOTS))
    rx_j = np.asarray(rx_j)
    assert rx_t.shape == rx_j.shape
    assert np.abs(rx_t.numpy() - rx_j).max() / np.abs(rx_j).max() < 1e-4


def test_oversampled_sweep_end_to_end_matches_jax():
    carrier, pdsch, jc, tc = _sweep_config(10, 2, second_path=False)
    snrs, seed = [-20.0, 20.0], 3
    np.random.seed(11)
    ref = jsim.run_pdsch_throughput(carrier, pdsch, jc, snrs,
                                    ceq_algo_list=["MMSE-IRC"],
                                    n_slots=N_SLOTS, ce_config=CE,
                                    ldpc_config=LDPC, seed=seed)
    states = _jax_states(carrier, pdsch, jc, snrs, seed, 11)
    got = tsim.run_pdsch_throughput(carrier, pdsch, tc, snrs, ["MMSE-IRC"],
                                    n_slots=N_SLOTS, ce_config=CE,
                                    ldpc_config=LDPC, seed=seed,
                                    device="cpu", states=states)
    assert got == ref
    assert got["MMSE-IRC"] == [0.0, 1.0]
    # the clean point's TB bits are the ones sent
    st = states[1]
    nr_pdsch, slots, rx_fd = tsim.pdsch_before_ceq_processing(
        carrier, pdsch, tc, -snrs[1], N_SLOTS, seed + 7919, device="cpu",
        state=st)
    stack = rx_fd.reshape(4, N_SLOTS, -1).transpose(0, 1)
    ok, tb = nr_pdsch.rx_process_batch(stack, slots, {"algo": "MMSE-IRC"},
                                       LDPC, CE)
    assert ok.all()
    np.testing.assert_array_equal(tb, st["trblks"].numpy())


# ---------------------------------------------------------------------------
# Loopback on the port alone at 245.76 Msps: EVM and ACLR
# ---------------------------------------------------------------------------

def test_loopback_evm_and_aclr_at_245_76():
    """Full-band QPSK grid -> DUC 245.76 -> DDC -> rx_low_phy: EVM on the
    occupied REs < 1.5 % (tests/test_aclr_evm.py) and ACLR < -45 dB
    (38.104 6.6.3)."""
    scs, bw, n_slots = 30, 40, 2
    carrier = dict(scs=scs, BW=bw, carrier_frequency_in_mhz=FC / 1e6)
    n_sc = 12 * num.carrier_prb_size(scs, bw)
    rng = np.random.default_rng(12)
    bits = rng.integers(0, 2, (2, 1, n_slots, 14, n_sc))
    fd = (((1 - 2 * bits[0]) + 1j * (1 - 2 * bits[1])) / np.sqrt(2)
          ).astype(np.complex64)
    dl = tf.tx_lowphy_duc(torch.as_tensor(fd), scs, bw, FC, 245.76e6)
    assert dl.shape == (1, n_slots * 15 * _nfft(scs, bw) * 4)
    assert aclr_db(dl.numpy(), 245.76e6, bw * 1e6) < -45.0
    td, fd_rx = trx.waveform_rx_processing(dl, carrier, 245.76e6)
    assert td.shape == (1, n_slots * 15 * _nfft(scs, bw))
    err = fd_rx.numpy().reshape(fd.shape) - fd
    evm = np.sqrt(np.mean(np.abs(err) ** 2) / np.mean(np.abs(fd) ** 2)) * 100
    assert evm < 1.5, f"loopback EVM {evm:.3f}% >= 1.5%"
