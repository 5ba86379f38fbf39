"""PyTorch port, UCI on the PUSCH sweep: payloads drawn per allocated slot
from the point's seed (phy/pusch.py:draw_uci_bits) and coded for the
whole point at once (NrPUSCH.encode_uci_rows), the UCI pass rates of
sim/pusch_throughput.py:run_pusch_throughput, and the spans and counters
of the UCI path. On the CPU at BW 20 / 51 PRB, 2 slots a point, 2 layers
on 2 x 4: HARQ-ACK 7 bits (Reed-Muller), CSI parts 1 and 2 of 40 bits
(CA-polar), beta-offset indices 11 / 13 / 13.

Tolerances: payloads, coded bits, grids, waveforms and pass rates
exactly (the paths compared run the same arithmetic)."""
import contextlib
import io
import re

import numpy as np
import pytest
import torch

from python_5gtoolbox_tpu.phy import pusch_uci as juci

from python_5gtoolbox_tpu_torch.models import channel as chan_mod
from python_5gtoolbox_tpu_torch.phy import pusch as tpusch
from python_5gtoolbox_tpu_torch.sim import pusch_throughput as usim
from python_5gtoolbox_tpu_torch.utils import profiling as tprof
from python_5gtoolbox_tpu_torch.utils.config import (get_default_config,
                                                     merged)
from python_5gtoolbox_tpu_torch.waveform import ul as tul

from tests.test_torch_profiling import (SWEEP_CE, SWEEP_LDPC, _Calls,
                                        _sweep_case)

S = 2
BITS = dict(ack=7, csi1=40, csi2=40)
CE = dict(CE_algo="DFT", L_symm_left_in_ns=200, L_symm_right_in_ns=200,
          eRB=2, enable_TO_comp=True, enable_FO_est=False,
          enable_FO_comp=False)
LDPC = dict(L=16, algo="min-sum", alpha=0.8, beta=0.3)
ALGOS = ["MMSE-IRC"]
SNR = [30.0]


def _config(ack=7, csi1=40, csi2=40, **payloads):
    """(carrier, PUSCH, channel model) configurations: the benchmark's
    UCI-on-PUSCH configuration at BW 20 / 51 PRB on a one-tap Rayleigh
    channel; a stream's payload list is empty (drawn per slot) unless
    given in payloads (ACKbits=, CSI1bits=, CSI2bits=)."""
    carrier = merged(get_default_config("ul_carrier"),
                     dict(BW=20, scs=30, num_of_ant=2, Nr=4,
                          maxMIMO_layers=2, PCI=1,
                          carrier_frequency_in_mhz=3500.0))
    pusch = merged(get_default_config("pusch"), dict(
        mcs_table="256QAM", mcs_index=12, num_of_layers=2, nPMI=0,
        PortIndexList=[1000, 1001], rv=[0], data_source=[],
        StartSymbolIndex=0, NrOfSymbols=14, nTransPrecode=0, EnableULSCH=1,
        UCIScaling=1, EnableACK=int(ack > 0), NumACKBits=ack,
        I_HARQ_ACK_offset=11, EnableCSI1=int(csi1 > 0), NumCSI1Bits=csi1,
        I_CSI1offset=13, EnableCSI2=int(csi2 > 0), NumCSI2Bits=csi2,
        I_CSI2offset=13,
        **dict(dict(ACKbits=[], CSI1bits=[], CSI2bits=[]), **payloads)))
    pusch["ResAlloType1"].update(RBStart=0, RBSize=51)
    pusch["DMRS"].update(NumCDMGroupsWithoutData=2, DMRSAddPos=1)
    chan = chan_mod.gen_channel_model_config(
        model_format="customized", Nt=2, Nr=4,
        multi_paths=[[0, 0, "Rayleigh", 0, 0]])
    return carrier, pusch, chan


def _point(seed, state=None, pusch=None):
    """One point's TX, channel and RX front end -> (nr_pusch, rx_fd)."""
    carrier, cfg, chan = _config()
    obj, _, rx_fd = usim.pusch_before_ceq_processing(
        carrier, pusch or cfg, chan, -30.0, n_slots=S, seed=seed,
        device="cpu", state=state)
    return obj, rx_fd


def _sweep(pusch=None, **kw):
    """run_pusch_throughput on _config at 30 dB -> (results, printed
    lines)."""
    carrier, cfg, chan = _config()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = usim.run_pusch_throughput(
            carrier, pusch or cfg, chan, SNR, ALGOS, n_slots=S,
            ce_config=CE, ldpc_config=LDPC, seed=5, device="cpu", **kw)
    return res, out.getvalue().splitlines()


def test_payload_draw_follows_the_seed():
    """One torch.Generator seeded with (2 seed + 2) mod 2^63 draws (S, n)
    int8 for ack, csi1, csi2 in turn; the draw repeats with its seed,
    differs between slots and between points, and skips a stream with a
    payload list."""
    _, cfg, _ = _config()
    seed = 2 ** 62 + 11
    got = tpusch.draw_uci_bits(cfg, S, seed, "cpu")
    gen = torch.Generator().manual_seed((2 * seed + 2) % 2 ** 63)
    assert list(got) == list(BITS)
    for name, n in BITS.items():
        ref = torch.randint(0, 2, (S, n), generator=gen, dtype=torch.int8)
        assert torch.equal(got[name], ref)
    again = tpusch.draw_uci_bits(cfg, S, seed, "cpu")
    other = tpusch.draw_uci_bits(cfg, S, seed + 7919, "cpu")
    for name in ("csi1", "csi2"):
        assert torch.equal(again[name], got[name])
        assert not torch.equal(got[name][0], got[name][1])
        assert not torch.equal(other[name], got[name])
    _, given, _ = _config(CSI1bits=[1] * 40)
    assert tpusch.uci_drawn(given) == ["ack", "csi2"]
    part = tpusch.draw_uci_bits(given, S, seed, "cpu")
    assert list(part) == ["ack", "csi2"]
    assert torch.equal(part["ack"], got["ack"])
    _, none, _ = _config(ack=0, csi1=0, csi2=0)
    assert tpusch.draw_uci_bits(none, S, seed, "cpu") == {}


def test_state_uci_bits_replace_the_draw():
    """The point keeps its draw as nr_pusch.uci_bits; state uci_bits in
    its place send those bits: the same rows give the same received
    grid bit for bit, one flipped bit another."""
    obj, rx = _point(21)
    drawn = obj.uci_bits
    assert set(drawn) == set(BITS)
    assert all(drawn[n].shape == (S, b) for n, b in BITS.items())
    obj2, rx2 = _point(21, state=dict(uci_bits=drawn))
    assert obj2.uci_bits is drawn and torch.equal(rx2, rx)
    flipped = dict(drawn, csi1=drawn["csi1"].clone())
    flipped["csi1"][1, 3] ^= 1
    obj3, rx3 = _point(21, state=dict(uci_bits=flipped))
    assert obj3.uci_bits is flipped and not torch.equal(rx3, rx)


def test_payload_lists_keep_the_waveform():
    """Payload lists are coded once per object as before; the rows of
    encode_uci_rows with the same payloads give the same grid and
    waveform bit for bit."""
    payloads = {name: np.random.default_rng(n).integers(0, 2, n).tolist()
                for name, n in BITS.items()}
    carrier, listed, _ = _config(ACKbits=payloads["ack"],
                                 CSI1bits=payloads["csi1"],
                                 CSI2bits=payloads["csi2"])
    _, drawn, _ = _config()
    wf = dict(numofslots=S, startSFN=0, startslot=0,
              samplerate_in_mhz=30.72)
    ref = tul.gen_ul_waveform(wf, dict(carrier), [
        tpusch.NrPUSCH(dict(carrier), dict(listed), device="cpu")])
    obj = tpusch.NrPUSCH(dict(carrier), dict(drawn), device="cpu")
    obj.uci_bits = {name: torch.tensor(p, dtype=torch.int8).repeat(S, 1)
                    for name, p in payloads.items()}
    got = tul.gen_ul_waveform(wf, dict(carrier), [obj])
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    with pytest.raises(ValueError, match="no payload list"):
        tul.gen_ul_waveform(wf, dict(carrier), [
            tpusch.NrPUSCH(dict(carrier), dict(drawn), device="cpu")])


@pytest.mark.parametrize("ack,csi1,csi2", [(7, 40, 40), (2, 25, 4),
                                           (1, 14, 0)])
def test_encode_rows_match_jax_row_by_row(ack, csi1, csi2):
    """The point's UCI coded at once (1- and 2-bit tables with their
    placeholders, Reed-Muller, polar with CRC6 and parity-check bits or
    CRC11) equals the JAX package's encode_uci_on_ulsch of each slot's
    payload, stream by stream in the multiplex's order."""
    carrier, cfg, _ = _config(ack, csi1, csi2)
    obj = tpusch.NrPUSCH(dict(carrier), dict(cfg), device="cpu")
    obj.uci_bits = tpusch.draw_uci_bits(cfg, 3, 77, "cpu")
    rows = obj.encode_uci_rows()
    g_total = obj.qm * 2 * obj._tx_layout()[1]
    rm = obj.uci_rm_info(g_total, obj._dmrs_symlist())
    for s in range(3):
        ref = np.concatenate([
            juci.encode_uci_on_ulsch(obj.uci_bits[name][s].numpy(), n,
                                     rm[e], obj.qm)
            for name, _, nb, _, e in tpusch.UCI_STREAMS
            for n in [cfg[nb]] if n])
        np.testing.assert_array_equal(rows[s].numpy(), ref)


def test_batched_and_per_slot_uci_results_agree():
    """The slot-batched RX and the per-slot RX with the UCI decode give
    the same pass rates, TB and UCI, on the same draws; at 30 dB every
    slot passes."""
    batched, lines = _sweep(use_batch=True)
    per_slot, _ = _sweep(use_batch=False, decode_uci=True)
    assert batched == per_slot
    assert batched["MMSE-IRC"] == [1.0]
    assert batched["uci"] == {"MMSE-IRC": {n: [1.0] for n in BITS}}
    assert lines == ["PUSCH snr=+30.0dB MMSE-IRC: 2/2 TB passed, "
                     "ack 2/2, csi1 2/2, csi2 2/2"]


def test_a_wrong_decoded_bit_fails_its_slot(monkeypatch):
    """A bit flipped in one slot's decoded CSI part 1 lowers that
    stream's pass rate by 1/S and no other."""
    real = tpusch.NrPUSCH.rx_process_batch

    def planted(self, *a, **kw):
        ok, tb, uci = real(self, *a, **kw)
        bits, okk = uci["csi1"]
        bits = bits.clone()
        bits[1, 17] ^= 1
        return ok, tb, dict(uci, csi1=(bits, okk))
    monkeypatch.setattr(tpusch.NrPUSCH, "rx_process_batch", planted)
    res, lines = _sweep(use_batch=True)
    assert res["uci"]["MMSE-IRC"] == dict(ack=[1.0], csi1=[1 - 1 / S],
                                          csi2=[1.0])
    assert res["MMSE-IRC"] == [1.0]
    assert "csi1 1/2" in lines[0]


@pytest.mark.parametrize("link", ["DL", "UL"])
def test_sweeps_without_uci_keep_their_results(link):
    """Without UCI the results hold the equalizers' pass rates and
    tbs_bits only, and each line is '<label> snr=... <algo>: n/N TB
    passed'."""
    run, carrier, cfg, chan, algos, _ = _sweep_case(link)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = run(carrier, cfg, chan, [25.0], algos, n_slots=2,
                  ce_config=SWEEP_CE, ldpc_config=SWEEP_LDPC, seed=7,
                  device="cpu")
    assert set(res) == set(algos) | {"tbs_bits"}
    label = "PDSCH" if link == "DL" else "PUSCH"
    for line in out.getvalue().splitlines():
        assert re.fullmatch(rf"{label} snr=\+25\.0dB [A-Z-]+: \d/2 TB "
                            r"passed", line), line


def test_uci_spans_and_counters():
    """Under a StageProfiler: tx.uci_encode in slot_grids, the decoders'
    spans in rx.ratematch, polar_blocks (slots x polar streams) and
    uci_crc_fail (0 at 30 dB); polar_graph_captures is counted on the
    card only. The results are those of the sweep without a
    profiler."""
    prof = tprof.StageProfiler("cpu")
    res, _ = _sweep(use_batch=True, prof=prof)
    s = prof.stats
    assert (s["slot_grids"].calls, s["slot_grids"].parent) == (
        1, "tx_waveform")
    assert (s["tx.uci_encode"].calls, s["tx.uci_encode"].parent) == (
        1, "slot_grids")
    assert (s["rx.uci.smallblock"].calls,
            s["rx.uci.smallblock"].parent) == (1, "rx.ratematch")
    assert (s["rx.uci.polar"].calls, s["rx.uci.polar"].parent) == (
        2, "rx.ratematch")
    assert prof.counters == {"polar_blocks": 2 * S, "uci_crc_fail": 0}
    assert res == _sweep(use_batch=True)[0]


def test_uci_path_records_nothing_without_a_profiler(monkeypatch):
    """With no profiler open the UCI sweep creates no CUDA event and
    opens no record_function range, though a torch profiler is taken as
    running."""
    calls = _Calls()
    monkeypatch.setattr(torch.cuda, "Event", calls.event)
    monkeypatch.setattr(torch.profiler, "record_function",
                        calls.record_function)
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
    counted = []
    monkeypatch.setattr(tprof.StageProfiler, "count",
                        lambda self, *a: counted.append(a))
    _sweep(use_batch=True)
    assert (calls.events, calls.ranges, counted) == (0, [], [])
