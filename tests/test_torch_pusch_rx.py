"""PyTorch port, the PUSCH RX: the slot-batched UL-SCH RX (DFT-s-OFDM
with QPSK and pi/2-BPSK, 2-layer CP-OFDM), the sweep's front end and the
sweep end to end, held against the JAX package on identical inputs (the
JAX run's own random draws handed to the port through
interop.state_from_numpy, tests/test_torch_slice.py:_jax_states).

Tolerances as tests/test_torch_slice.py: recovered LLRs 1e-3 relative to
their largest magnitude; IQ after the channel and RX front end 1e-5
relative; decode flags, TB bits and pass rates exactly. Small size: BW
10, 12 RBs (above the 8 RBs under which the bench CE window keeps no
channel tap), 2 slots; each JAX core is built once per configuration.
"""
import numpy as np
import pytest
import torch

from tests.test_torch_slice import CE, LDPC, N_SLOTS, _jax_states, _rel_err

from python_5gtoolbox_tpu.models import channel as jchan
from python_5gtoolbox_tpu.phy import pusch as jpusch
from python_5gtoolbox_tpu.utils.config import get_default_config, merged
from scripts.internal import sim_pusch_throughput_internal as jsim

from python_5gtoolbox_tpu_torch.models import channel as tchan
from python_5gtoolbox_tpu_torch.phy import pusch as tpusch
from python_5gtoolbox_tpu_torch.sim import pusch_throughput as tsim

KINDS = ["tp_qpsk", "tp_pi2bpsk", "cp_2layer"]
SNRS = [20.0, -10.0]


def _config(kind):
    """BW 10 / 12 RBs versions of the UL sweep configuration:
    transform-precoded QPSK (MCS 2), pi/2-BPSK (MCS 0 with nTpPi2BPSK),
    and CP-OFDM with 2 layers on 2 ports (MCS 5)."""
    nl = 2 if kind == "cp_2layer" else 1
    carrier = merged(get_default_config("ul_carrier"),
                     dict(BW=10, scs=30, num_of_ant=nl, Nr=2,
                          maxMIMO_layers=nl, PCI=1,
                          carrier_frequency_in_mhz=3840.0))
    kw = dict(mcs_table="MCStable61411", mcs_index=2, nTpPi2BPSK=0,
              num_of_layers=nl, rv=[0], data_source=[], StartSymbolIndex=0,
              NrOfSymbols=14, nTransPrecode=1, EnableULSCH=1, EnableACK=0,
              EnableCSI1=0, EnableCSI2=0, PortIndexList=[1000],
              nNrOfAntennaPorts=1, nPMI=0)
    if kind == "tp_pi2bpsk":
        kw.update(mcs_index=0, nTpPi2BPSK=1)
    if kind == "cp_2layer":
        kw.update(nTransPrecode=0, PortIndexList=[1000, 1001],
                  nNrOfAntennaPorts=2, mcs_index=5)
    pusch = merged(get_default_config("pusch"), kw)
    pusch["ResAlloType1"].update(RBStart=0, RBSize=12)      # 2^2 * 3
    pusch["DMRS"].update(NumCDMGroupsWithoutData=2, DMRSAddPos=1)
    return carrier, pusch


def _chan(nt, nr):
    kw = dict(model_format="customized", Nt=nt, Nr=nr, fm_inHz=200,
              multi_paths=[[0, 0, "Rayleigh", 0, 0]])
    return (jchan.gen_channel_model_config(**kw),
            tchan.gen_channel_model_config(**kw))


@pytest.fixture(scope="module", params=KINDS)
def rx_case(request):
    """A received slot stack (the port's TX grid through a fixed channel
    plus AWGN, numpy) at each SNR of SNRS, the blocks sent, and the JAX
    RX's (ok, tbblk, llr) on it."""
    kind = request.param
    carrier, pusch = _config(kind)
    ch = tpusch.NrPUSCH(carrier, pusch, device="cpu")
    blocks = np.random.default_rng(4).integers(0, 2, (N_SLOTS, ch.tbsize),
                                               dtype=np.int8)
    grid = ch.tx_grid_batch(list(range(N_SLOTS)), trblks=blocks).numpy()
    rng = np.random.default_rng(6)
    nt = grid.shape[1]
    hmat = (rng.normal(size=(2, nt)) + 1j * rng.normal(size=(2, nt))) / 2
    clean = np.einsum("rt,stkf->srkf", hmat, grid).reshape(N_SLOTS, 2, -1)
    noise = (rng.normal(size=clean.shape)
             + 1j * rng.normal(size=clean.shape)) / np.sqrt(2)
    jch = jpusch.NrPUSCH(carrier, pusch)
    out = {}
    for snr in SNRS:
        rx = (clean + 10 ** (-snr / 20) * noise).astype(np.complex64)
        ok, tb, llr = jch.rx_process_batch(
            rx, list(range(N_SLOTS)), {"algo": "MMSE-IRC"}, LDPC, CE,
            return_llr=True)
        out[snr] = rx, (np.asarray(ok), np.asarray(tb), np.asarray(llr))
    return kind, blocks, out


@pytest.mark.parametrize("snr", SNRS)
def test_rx_process_batch_matches_jax(rx_case, snr):
    kind, blocks, out = rx_case
    rx, (ok_j, tb_j, llr_j) = out[snr]
    carrier, pusch = _config(kind)
    tch = tpusch.NrPUSCH(carrier, pusch, device="cpu")
    ok_t, tb_t, llr_t = tch.rx_process_batch(
        rx, list(range(N_SLOTS)), {"algo": "MMSE-IRC"}, LDPC, CE,
        return_llr=True)
    assert llr_t.shape == llr_j.shape
    assert _rel_err(llr_t.numpy(), llr_j) < 1e-3
    if snr > 0:
        assert ok_t.all()
        np.testing.assert_array_equal(ok_t, ok_j)
        np.testing.assert_array_equal(tb_t, tb_j)
        np.testing.assert_array_equal(tb_t, blocks)
    else:
        assert not ok_j.any() and not ok_t.any()


def test_rx_refuses_what_is_not_ported():
    carrier, pusch = _config("tp_qpsk")
    ch = tpusch.NrPUSCH(carrier, pusch, device="cpu")
    rx = np.zeros((1, 2, 14 * ch.prb_size * 12), np.complex64)
    with pytest.raises(AssertionError):
        ch.rx_process_batch(rx, [0], {"algo": "ML"}, LDPC, CE)
    # UCI on PUSCH is CP-OFDM only in the batched RX, as in the JAX package
    uci = tpusch.NrPUSCH(carrier, dict(pusch, EnableACK=1, NumACKBits=2),
                         device="cpu")
    with pytest.raises(AssertionError):
        uci.rx_process_batch(rx, [0], {"algo": "MMSE-IRC"}, LDPC, CE)
    # the per-slot RX takes what the batched RX refuses (ML with
    # transform precoding, UCI); a slot the configuration does not
    # allocate gives the JAX package's empty result
    assert not tsim.can_batch_pusch_rx(pusch, ["ML-soft"])
    assert not tsim.can_batch_pusch_rx(uci.cfg)
    gated = tpusch.NrPUSCH(carrier, dict(pusch, period_in_slot=2,
                                         allocated_slots=[0]), device="cpu")
    ok, tb, llr, dec = gated.RX_process(rx[0], 1, {"algo": "MMSE"}, None,
                                        None, LDPC)
    assert ok is False and tb.size == 0 and llr.size == 0 and dec == {}


def test_sweep_front_end_matches_jax():
    """UL waveform -> channel -> RX filter and low-PHY on the JAX run's
    draws (transform precoding): the received grids agree."""
    carrier, pusch = _config("tp_qpsk")
    jc, tc = _chan(1, 2)
    snr, seed = 3.0, 5
    np.random.seed(13)
    _, _, rx_j = jsim.pusch_before_ceq_processing(
        carrier, pusch, jc, -snr, N_SLOTS, seed, CE, do_ce=False,
        return_full=True)
    tbs = tpusch.NrPUSCH(carrier, pusch, device="cpu").tbsize
    st = _jax_states(carrier, tbs, jc, [snr], seed, 13)[0]
    _, slots, rx_t = tsim.pusch_before_ceq_processing(
        carrier, pusch, tc, -snr, N_SLOTS, seed, device="cpu", state=st)
    assert slots == list(range(N_SLOTS))
    assert _rel_err(rx_t.numpy(), rx_j) < 1e-5


@pytest.mark.parametrize("kind", ["tp_qpsk", "cp_2layer"])
def test_sweep_end_to_end_matches_jax(kind):
    carrier, pusch = _config(kind)
    jc, tc = _chan(carrier["num_of_ant"], 2)
    snrs, seed = [-15.0, 20.0], 3
    np.random.seed(11)
    ref = jsim.run_pusch_throughput(carrier, pusch, jc, snrs,
                                    ceq_algo_list=["MMSE-IRC"],
                                    n_slots=N_SLOTS, ce_config=CE,
                                    ldpc_config=LDPC, seed=seed,
                                    use_batch=True)
    tbs = tpusch.NrPUSCH(carrier, pusch, device="cpu").tbsize
    states = _jax_states(carrier, tbs, jc, snrs, seed, 11)
    got = tsim.run_pusch_throughput(carrier, pusch, tc, snrs, ["MMSE-IRC"],
                                    n_slots=N_SLOTS, ce_config=CE,
                                    ldpc_config=LDPC, seed=seed,
                                    device="cpu", states=states)
    assert got == ref
    assert got["MMSE-IRC"] == [0.0, 1.0]


def test_sweep_own_draws_and_device_default():
    carrier, pusch = _config("tp_qpsk")
    tc = _chan(1, 2)[1]
    got = tsim.run_pusch_throughput(carrier, pusch, tc, [25.0],
                                    ["MMSE-IRC"], n_slots=N_SLOTS,
                                    ce_config=CE, ldpc_config=LDPC,
                                    device="cpu")
    assert got["MMSE-IRC"] == [1.0]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsim.run_pusch_throughput(carrier, pusch, tc, [25.0],
                                      ["MMSE-IRC"], n_slots=N_SLOTS)
