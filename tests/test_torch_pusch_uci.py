"""PyTorch port, UCI on PUSCH: the rate-match resources, UCI coding and
the 38.212 6.2.7 multiplex against the JAX package; the per-slot
NrPUSCH.process against the pusch_slot2 goldens (all ten cases, four with
UCI); the demultiplex against the pusch_separate golden; the UCI
decoders against the JAX package; and the UCI path end to end (the
per-slot gen_ul_waveform branch and the batched UCI RX) against the JAX
package on the same noisy slots.

Tolerances: coded bits, placements, gather maps, decoded bits and flags
exactly; grids 3e-5 against the goldens (tests/test_pusch.py); the
waveform 1.2e-4 against the JAX package (tests/test_pallas_filters.py).
"""
import numpy as np
import pytest
import torch

from tests.golden import get_golden
from tests.test_pusch import PUSCH_CASES, _mk_cfg

from python_5gtoolbox_tpu.models import channel as jchan
from python_5gtoolbox_tpu.phy import pusch as jpusch
from python_5gtoolbox_tpu.phy import pusch_rx as jrx
from python_5gtoolbox_tpu.phy import pusch_uci as juci
from python_5gtoolbox_tpu.utils.config import get_default_config, merged
from python_5gtoolbox_tpu.waveform import rx as jrx_wf
from python_5gtoolbox_tpu.waveform import ul as jul

from python_5gtoolbox_tpu_torch.ops.ldpc.segment import sch_plan
from python_5gtoolbox_tpu_torch.phy import pusch as tpusch
from python_5gtoolbox_tpu_torch.phy import pusch_rx as trx
from python_5gtoolbox_tpu_torch.phy import pusch_uci as tuci
from python_5gtoolbox_tpu_torch.utils.numerology import carrier_prb_size
from python_5gtoolbox_tpu_torch.waveform import ul as tul

from tests.torch_oracles import jax_outputs

UCI_CASES = [4, 5, 6, 9]              # the pusch_slot2 cases with UCI


def _no_golden_gen():
    raise RuntimeError("golden file missing")


def _case(i):
    case = PUSCH_CASES[i]
    cfg = _mk_cfg(get_default_config("pusch"), case)
    carrier = merged(get_default_config("ul_carrier"),
                     dict(BW=case[9], scs=case[8], num_of_ant=case[3],
                          Nr=case[3]))
    return case, cfg, carrier


def _rm_setup(i):
    """(cfg, DMRS symbols, qm, rate, g_total, the JAX and port rm info)."""
    _, cfg, _ = _case(i)
    tbsize, qm, rate = jpusch.tbs_mod.ulsch_tbsize(cfg)
    symlist = jpusch.pusch_dmrs_symlist(
        cfg["StartSymbolIndex"] + cfg["NrOfSymbols"],
        cfg["DMRS"]["DMRSAddPos"])
    ncdm = cfg["DMRS"]["NumCDMGroupsWithoutData"]
    rb = cfg["ResAlloType1"]["RBSize"]
    n_data = sum(rb * ((6 if ncdm == 1 else 0) if s in symlist else 12)
                 for s in range(cfg["StartSymbolIndex"], cfg["StartSymbolIndex"]
                                + cfg["NrOfSymbols"]))
    g_total = qm * cfg["num_of_layers"] * n_data
    _, info, _ = jpusch.ulsch_crc_segment(np.zeros(tbsize, np.int8), tbsize,
                                          rate)
    t_info = sch_plan(tbsize, rate, g_total, qm, cfg["num_of_layers"],
                      None)[3]
    assert t_info.C * t_info.K == info.C * info.K
    rm_j = juci.get_ulsch_rm_info(cfg, symlist, info.C * info.K, qm, rate,
                                  g_total)
    rm_t = tuci.get_ulsch_rm_info(cfg, symlist, t_info.C * t_info.K, qm,
                                  rate, g_total)
    return cfg, symlist, qm, rate, g_total, rm_j, rm_t


@pytest.mark.parametrize("i", UCI_CASES)
def test_rm_info_coding_and_multiplex_match_jax(i):
    cfg, symlist, qm, _, g_total, rm_j, rm_t = _rm_setup(i)
    assert rm_t == rm_j
    streams = []
    for en, nb, bits, e in (("EnableACK", "NumACKBits", "ACKbits",
                             "Euci_ack"),
                            ("EnableCSI1", "NumCSI1Bits", "CSI1bits",
                             "Euci_CSI1"),
                            ("EnableCSI2", "NumCSI2Bits", "CSI2bits",
                             "Euci_CSI2")):
        if cfg[en] * cfg[nb] == 0:
            streams.append(np.zeros(0, np.int8))
            continue
        got = tuci.encode_uci_on_ulsch(cfg[bits], cfg[nb], rm_t[e], qm)
        ref = juci.encode_uci_on_ulsch(cfg[bits], cfg[nb], rm_j[e], qm)
        np.testing.assert_array_equal(got, ref)
        streams.append(got)
    g_ulsch = np.random.default_rng(i).integers(
        0, 2, rm_t["G_ULSCH"]).astype(np.int8)
    got = tuci.data_control_multiplex(g_ulsch, *streams, cfg, g_total,
                                      symlist, rm_t, qm)
    ref = juci.data_control_multiplex(g_ulsch, *streams, cfg, g_total,
                                      symlist, rm_j, qm)
    np.testing.assert_array_equal(got, ref)
    maps_t = trx.data_control_demux_maps(cfg, symlist, rm_t, qm, g_total)
    maps_j = jrx.data_control_demux_maps(cfg, symlist, rm_j, qm, g_total)
    for k in maps_j:
        np.testing.assert_array_equal(maps_t[k], maps_j[k], err_msg=k)


@pytest.mark.parametrize("i", range(len(PUSCH_CASES)))
def test_process_matches_slot_golden(i):
    """The per-slot process into an empty slot: all ten pusch_slot2
    cases, the four with UCI (2-bit ACK with placeholders; 5-bit ACK +
    4-bit CSI1; polar ACK 14 + CSI1 25 + Reed-Muller CSI2 4; 3-bit ACK on
    2 layers) among them."""
    gold = get_golden("pusch_slot2", _no_golden_gen)
    case, cfg, carrier = _case(i)
    ch = tpusch.NrPUSCH(carrier, cfg, device="cpu")
    n = 14 * 12 * carrier_prb_size(case[8], case[9])
    fd = torch.zeros((case[3], n), dtype=torch.complex64)
    usage = np.zeros((case[3], n), np.int8)
    fd, usage = ch.process(fd, usage, 0)
    np.testing.assert_array_equal(usage, gold[f"usage_{i}"])
    np.testing.assert_allclose(fd.numpy(), gold[f"fd_{i}"], atol=3e-5)


@pytest.mark.parametrize("i", [4, 5, 6])
def test_data_control_separate_golden(i):
    gold = get_golden("pusch_separate", _no_golden_gen)
    cfg, symlist, qm, _, _, _, rm_t = _rm_setup(i)
    llr = gold[f"llr_{i}"]
    got = trx.data_control_separate(torch.as_tensor(llr), cfg, symlist,
                                    rm_t, qm)
    for name, arr in zip(("ulsch", "ack", "csi1", "csi2"), got):
        np.testing.assert_array_equal(arr.numpy(), gold[f"{name}_{i}"],
                                      err_msg=name)


@pytest.mark.parametrize("n_bits,E,qm", [
    (1, 8, 2), (2, 36, 4), (2, 18, 1), (5, 100, 2), (11, 64, 8),
    (18, 50, 2),     # polar CRC6 with parity-check bits, shortening at
                     # N 64 (the shortening LLR is Er)
    (25, 72, 2)])    # CRC11, repetition at N 64
def test_decode_uci_on_ulsch_matches_jax(n_bits, E, qm):
    """Clean and broken streams through the per-slot decoder."""
    rng = np.random.default_rng(n_bits * 100 + E)
    for sigma in (0.3, 2.5):
        bits = rng.integers(0, 2, n_bits).astype(np.int8)
        coded = tuci.encode_uci_on_ulsch(bits, n_bits, E, qm)
        c = np.where(coded < 0, rng.integers(0, 2, E), coded)
        llr = ((1.0 - 2.0 * c) * 2.0 + rng.normal(size=E) * sigma
               ).astype(np.float32)
        got, ok = trx.decode_uci_on_ulsch(torch.as_tensor(llr), n_bits, qm)
        ref, ok_j = jrx.decode_uci_on_ulsch(llr, n_bits, qm)
        np.testing.assert_array_equal(got.numpy(), ref)
        assert ok == ok_j
        if sigma < 1:
            np.testing.assert_array_equal(got.numpy(), bits)
            assert ok


def test_polar_uci_two_blocks_odd_roundtrip():
    """361 bits on 2200 REs: two code blocks of 181 + CRC11 bits (the odd
    payload gets a zero in front), N 1024 each; noiseless."""
    bits = np.random.default_rng(361).integers(0, 2, 361).astype(np.int8)
    coded = tuci.encode_uci_on_ulsch(bits, 361, 2200, 2)
    got, ok = trx.decode_uci_on_ulsch(
        torch.as_tensor((1.0 - 2.0 * coded) * 4.0), 361, 2)
    assert ok
    np.testing.assert_array_equal(got.numpy(), bits)


# ---------------------------------------------------------------------------
# End to end: per-slot UL waveform with UCI, channel, batched UCI RX
# ---------------------------------------------------------------------------

CE = dict(CE_algo="DFT_symmetric", L_symm_left_in_ns=1400,
          L_symm_right_in_ns=1200, eRB=4, enable_TO_comp=True,
          enable_FO_est=False, enable_FO_comp=False)
LDPC = dict(L=16, algo="min-sum", alpha=0.8, beta=0.3)
S = 3


def _uci_config(ack_bits, csi1_bits, csi1_payload):
    """tests/test_batch_rx_uci.py:_run_case's configuration: BW 10 / scs
    30, 2 TX x 4 RX, 2 layers of 256QAM MCS 4 on 12 RBs, NumCDM 1."""
    carrier = merged(get_default_config("ul_carrier"),
                     dict(BW=10, scs=30, num_of_ant=2, Nr=4,
                          maxMIMO_layers=2, PCI=1,
                          carrier_frequency_in_mhz=3840.0))
    pusch = merged(get_default_config("pusch"),
                   dict(mcs_index=4, mcs_table="256QAM", num_of_layers=2,
                        rv=[0], data_source=[1, 0, 1], StartSymbolIndex=0,
                        NrOfSymbols=14, nTransPrecode=0, EnableULSCH=1,
                        EnableACK=1 if ack_bits else 0,
                        NumACKBits=len(ack_bits), ACKbits=list(ack_bits),
                        EnableCSI1=1 if csi1_bits else 0,
                        NumCSI1Bits=csi1_bits, CSI1bits=csi1_payload,
                        EnableCSI2=0, NumCSI2Bits=0))
    pusch["ResAlloType1"].update(RBStart=0, RBSize=12)
    pusch["DMRS"].update(NumCDMGroupsWithoutData=1, DMRSAddPos=1)
    return carrier, pusch


def _uci_path_jax(carrier, pusch, wf):
    """The JAX side of test_uci_path_matches_jax: the waveform, the noisy
    slots (JAX channel at 8 dB SNR, JAX RX front end) and the batched UCI
    RX's ok, TB bits and UCI streams."""
    fd_j, _, ul_j = jul.gen_ul_waveform(wf, dict(carrier),
                                        [jpusch.NrPUSCH(dict(carrier),
                                                        dict(pusch))])
    chan_cfg = jchan.gen_channel_model_config(
        model_format="customized", Nt=2, Nr=4,
        multi_paths=[[0, 0, "Rayleigh", 0, 0]])
    model = jchan.NrChannelModel(chan_cfg, -8.0, 3840e6, 30.72e6, 30,
                                 seed=42)
    _, rx_fd = jrx_wf.waveform_rx_processing(model.filter(np.asarray(ul_j)),
                                             dict(carrier), 30.72e6)
    slot_size = 14 * 12 * carrier_prb_size(30, 10)
    slots = np.stack([np.asarray(rx_fd[:, k * slot_size:(k + 1) * slot_size])
                      for k in range(S)])
    ok_j, tb_j, uci_j = jpusch.NrPUSCH(dict(carrier), dict(
        pusch)).rx_process_batch(slots, list(range(S)), {"algo": "MMSE-IRC"},
                                 dict(LDPC), dict(CE))
    out = dict(fd=fd_j, ul=ul_j, slots=slots, ok=ok_j, tb=tb_j)
    for name, (bits, okk) in uci_j.items():
        out["uci_" + name], out["uok_" + name] = bits, okk
    return out


@pytest.mark.parametrize("ack_bits,csi1_bits,seed", [
    ([1, 0], 5, 0),      # 2-bit ACK (special table) + 5-bit CSI1 (RM)
    ([], 14, 6)])        # 14-bit CSI1: polar CA-SCL
def test_uci_path_matches_jax(ack_bits, csi1_bits, seed):
    """The per-slot gen_ul_waveform branch against the JAX package's
    (1.2e-4), then the same noisy slots (JAX channel at 8 dB SNR, JAX RX
    front end) through both packages' batched UCI RX: ok, TB bits and
    every UCI stream's bits and flags equal, and equal to what was
    sent."""
    payload = np.random.default_rng(seed).integers(0, 2, csi1_bits).tolist()
    carrier, pusch = _uci_config(ack_bits, csi1_bits, payload)
    wf = dict(numofslots=S, startSFN=0, startslot=0, samplerate_in_mhz=30.72)
    jx = jax_outputs(
        f"uci_path_ack{len(ack_bits)}_csi{csi1_bits}",
        [f"python_5gtoolbox_tpu.{m}" for m in (
            "waveform.ul", "phy.pusch", "phy.pusch_rx", "models.channel",
            "waveform.rx")],
        (carrier, pusch, wf, LDPC, CE),
        lambda: _uci_path_jax(carrier, pusch, wf))
    fd_t, _, ul_t = tul.gen_ul_waveform(
        wf, dict(carrier), [tpusch.NrPUSCH(dict(carrier), dict(pusch),
                                           device="cpu")])
    np.testing.assert_allclose(fd_t.numpy(), jx["fd"], atol=1e-6)
    np.testing.assert_allclose(ul_t.numpy(), jx["ul"], atol=1.2e-4)

    slots = jx["slots"]
    ok_t, tb_t, uci_t = tpusch.NrPUSCH(dict(carrier), dict(pusch),
                                       device="cpu").rx_process_batch(
        slots, list(range(S)), {"algo": "MMSE-IRC"}, dict(LDPC), dict(CE))
    np.testing.assert_array_equal(ok_t, jx["ok"])
    np.testing.assert_array_equal(tb_t, jx["tb"])
    assert ok_t.all()
    uci_j = {k[4:]: (jx[k], jx["uok_" + k[4:]]) for k in jx
             if k.startswith("uci_")}
    assert sorted(uci_t) == sorted(uci_j)
    sent = dict(ack=ack_bits, csi1=payload)
    for name, (bits_j, okk_j) in uci_j.items():
        bits_t, okk_t = uci_t[name]
        np.testing.assert_array_equal(bits_t, np.asarray(bits_j),
                                      err_msg=name)
        np.testing.assert_array_equal(okk_t, np.asarray(okk_j),
                                      err_msg=name)
        np.testing.assert_array_equal(bits_t, np.tile(sent[name], (S, 1)),
                                      err_msg=name)
        assert okk_t.all()
