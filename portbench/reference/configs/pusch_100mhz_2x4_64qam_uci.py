"""The plain reference of the configuration pusch_100mhz_2x4_64qam_uci:
HARQ-ACK and CSI parts 1 and 2 multiplexed on the full-width PUSCH
(TS 38.104 8.2.3 on the PUSCH of 8.2.1).

One SNR point as reference/chain.py works it out, with the UCI the frozen
chain lacks written from TS 38.212 in reference/uci.py. The payloads are
the program's draw replayed: for each stream that is on, in the order
HARQ-ACK, CSI part 1, CSI part 2, where its payload list is empty,
(allocated slots, bits) int8 from one torch.Generator on the device seeded
with (2 * seed + 2) mod 2^63; a stream with a payload list sends it in
every slot. The TX is the frozen slot-batched PUSCH with the UL-SCH coded
into G_ULSCH bits and each stream coded into its own bits, all placed by
the 6.2.7 multiplex, then scrambled, modulated, precoded and mapped as
the frozen chain does (the multiplex changes only the order of the coded
bits). The RX is the frozen slot-batched receiver up to the descrambled
LLRs; the multiplex's positions then give each stream's LLRs to its
decoder (Reed-Muller ML, CA-SCL list 8) and the UL-SCH's to the frozen
LDPC rate recovery, decoder and TB CRC.

Eager float32, TF32 off. bf16 and llr_noise act as in chain.point.
Returns chain.point's dict with streams={name: {equalizer: (bits (Sa, n)
int8, ok (Sa,) bool)}} and sent={name: (Sa, n) int8}. Imports nothing
of the port.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference import chain, uci
from portbench.reference.frozen.models import channel as chan_mod
from portbench.reference.frozen.ops import crc as crc_ops
from portbench.reference.frozen.ops import ldpc as ldpc_ops
from portbench.reference.frozen.ops.modulation import QM_NAME
from portbench.reference.frozen.phy.pdsch import SlotBatchTx
from portbench.reference.frozen.phy.pdsch_rx import (PdschRxMixin,
                                                     rx_core_kwargs)
from portbench.reference.frozen.phy.pusch import (NrPUSCH,
                                                  pusch_symbol_encode,
                                                  ulsch_encode_batch)
from portbench.reference.frozen.rx import batch_core, ce_batch
from portbench.reference.frozen.utils.numerology import (carrier_prb_size,
                                                         fft_size,
                                                         slots_per_frame)
from portbench.reference.frozen.waveform import rx as rx_wf
from portbench.reference.frozen.waveform import ul as ul_wf

# stream -> the configuration's enable, size and payload keys
STREAMS = dict(ack=("EnableACK", "NumACKBits", "ACKbits"),
               csi1=("EnableCSI1", "NumCSI1Bits", "CSI1bits"),
               csi2=("EnableCSI2", "NumCSI2Bits", "CSI2bits"))


def payloads(cfg: dict, n_alloc: int, seed: int, device) -> dict:
    """{stream: (n_alloc, n) int8} of every stream that is on: drawn
    where its payload list is empty, else the list in every row."""
    gen = torch.Generator(device=device)
    gen.manual_seed((2 * seed + 2) % 2 ** 63)
    out = {}
    for name, (en, nb, bits) in STREAMS.items():
        if not cfg[en] * cfg[nb]:
            continue
        if len(cfg[bits]):
            out[name] = torch.tensor(cfg[bits], dtype=torch.int8,
                                     device=device).repeat(n_alloc, 1)
        else:
            out[name] = torch.randint(0, 2, (n_alloc, cfg[nb]),
                                      generator=gen, device=device,
                                      dtype=torch.int8)
    return out


class UciPusch(NrPUSCH):
    """The frozen PUSCH with UCI: sent {stream: (Sa, n)} the payloads of
    the allocated slots."""

    def __init__(self, carrier, cfg, sent: dict, rng, device):
        super().__init__(carrier, cfg, rng=rng, device=device)
        self.sent = sent

    def plan(self) -> tuple[dict, dict]:
        """(coded bits of each stream and of the UL-SCH, their positions
        in the slot's coded bits) at the slot-invariant layout."""
        cfg = self.cfg
        g_total = self.qm * cfg["num_of_layers"] * self._tx_layout()[1]
        info = ldpc_ops.sch_plan(self.tbsize, self.rate1024, g_total,
                                 self.qm, cfg["num_of_layers"], None)[3]
        symlist = self._dmrs_symlist()
        e = uci.rate_match_split(cfg, g_total, symlist, info.C * info.K,
                                 self.qm)
        return e, uci.multiplex_positions(
            cfg, symlist, self.qm * cfg["num_of_layers"], e)

    def tx_batch_supported(self) -> bool:
        return SlotBatchTx.tx_batch_supported(self)

    def encode_symbols(self, trb, rvs, prec) -> torch.Tensor:
        """The slots' multiplexed coded bits, then the frozen symbol
        encode (scrambling, modulation, layer mapping, precoding)."""
        cfg = self.cfg
        e, pos = self.plan()
        g_total = sum(e.values())
        dev = self.device
        g_seq = torch.zeros((len(rvs), g_total), dtype=torch.int8,
                            device=dev)
        for rv in sorted(set(rvs)):
            rows = torch.as_tensor([k for k, v in enumerate(rvs) if v == rv],
                                   device=dev)
            g_seq[rows[:, None], torch.as_tensor(pos["ulsch"], device=dev)] \
                = ulsch_encode_batch(trb[rows], self.tbsize, self.qm,
                                     self.rate1024, cfg["num_of_layers"],
                                     rv, e["ulsch"])
        for name, bits in self.sent.items():
            g_seq[:, torch.as_tensor(pos[name], device=dev)] = uci.encode(
                bits, e[name])
        return pusch_symbol_encode(
            g_seq, self.scramble_seq(g_total), prec, self.qm,
            cfg["num_of_layers"], cfg["nTransPrecode"],
            cfg["ResAlloType1"]["RBSize"] * 12)

    def rx_process_batch(self, *args, **kw):
        return PdschRxMixin.rx_process_batch(self, *args, **kw)

    def _rx_core(self, key: tuple):
        kw = rx_core_kwargs(key)
        e, pos = self.plan()
        return (_uci_core(kw, e, pos, {n: self.cfg[STREAMS[n][1]]
                                       for n in self.sent}),
                sum(e.values()), kw["symlist"])


def _uci_core(kw: dict, e: dict, pos: dict, n_bits: dict):
    """The frozen batched core (rx/batch_core.py) with the 6.2.7
    demultiplex and the UCI decoders between the descrambled LLRs and the
    UL-SCH's rate recovery: (fd, dmrs, scr_sign) -> (err (S,) int8, tbblk
    (S, A) int8, {stream: (bits, ok)})."""
    symlist, nl, qm = kw["symlist"], kw["nl"], kw["qm"]
    rb_start, rb_size, n_sc = kw["rb_start"], kw["rb_size"], kw["n_sc"]
    ssi, nsym, ncdm, nr = kw["ssi"], kw["nsym"], kw["ncdm"], kw["nr"]
    ce_config, ldpc_cfg = kw["ce_config"], kw["ldpc_cfg"]
    assert ncdm == 2 and not kw["harq"] and not kw["transform_precode"]
    g_total = sum(e.values())
    tb_poly, B, bgn, info, ncb, er_list = ldpc_ops.sch_plan(
        kw["tbsize"], kw["rate1024"], e["ulsch"], qm, nl, kw["tbs_lbrm"])
    rs_info = dict(RSSymMap=list(symlist), RE_distance=4,
                   NumCDMGroupsWithoutData=ncdm, scs=kw["scs"])
    data_syms = [ssi + k for k in range(nsym) if ssi + k not in symlist]

    def core(fd, dm, scr_sign):
        s, dev = fd.shape[0], fd.device
        h_ls = batch_core.ls_estimate(fd, dm, symlist, kw["ports"], nl,
                                      rb_start, rb_size, n_sc, kw["scaling"])
        est = ce_batch.channel_est_batch(h_ls, rs_info, ce_config)
        H, cov = est["H"], est["cov"]
        res = torch.stack([
            fd[:, :, k * n_sc + rb_start * 12:
               k * n_sc + rb_start * 12 + rb_size * 12].transpose(1, 2)
            for k in range(ssi, ssi + nsym)], dim=1)
        res = ce_batch.comp_data_batch(
            res, ssi, kw["scs"], est["to_avg"],
            est["fo"] if est["fo_applied"] else None, ce_config)
        idx = torch.arange(rb_size * 12, device=dev)
        y = torch.cat([res[:, l - ssi] for l in data_syms], 1)
        h = torch.cat([H[:, l, :, :, :nl] for l in data_syms], 1)
        cv = torch.cat([cov[:, l, idx // 12] for l in data_syms], 1)
        n_re = y.shape[1]
        llr = batch_core.equalize_and_demod_traced(
            y.reshape(s * n_re, nr), h.reshape(s * n_re, nr, nl),
            cv.reshape(s * n_re, nr, nr), QM_NAME[qm], kw["algo"])
        llr = llr.reshape(s, g_total) * scr_sign[None, :]

        streams = {name: uci.decode(llr[:, torch.as_tensor(pos[name],
                                                            device=dev)], n)
                   for name, n in n_bits.items()}
        llr = llr[:, torch.as_tensor(pos["ulsch"], device=dev)]
        grps, g_off = [], 0
        for c0, c1, E in ldpc_ops.er_groups(er_list):
            grp = llr[:, g_off: g_off + (c1 - c0) * E] \
                .reshape(s * (c1 - c0), E)
            mx = 10.0 * grp.abs().amax(dim=-1, keepdim=True)
            grps.append(ldpc_ops.ldpc_raterecover(
                grp, info, kw["rv"], qm, Ncb=ncb, max_llr=mx)
                .reshape(s, c1 - c0, info.N))
            g_off += (c1 - c0) * E
        llr_dns = torch.cat(grps, dim=1)
        bits, _, _ = ldpc_ops.ldpc_decode(
            llr_dns.reshape(s * info.C, info.N).contiguous(), info.Zc, bgn,
            ldpc_cfg["L"], algo=ldpc_cfg["algo"], alpha=ldpc_cfg["alpha"],
            beta=ldpc_cfg["beta"])
        bits = bits.reshape(s, info.C, -1)
        cb_bits = bits[:, :, : info.cbz] if info.C > 1 \
            else bits[:, :, : info.cbz + info.L]
        tbblkandcrc = cb_bits.reshape(s, -1)[:, :B]
        return (crc_ops.crc_check(tbblkandcrc, tb_poly),
                tbblkandcrc[:, :kw["tbsize"]], streams)

    return core


def point(cfg: dict, traffic: dict, snr_db: float, seed: int,
          trblks: torch.Tensor, device, bf16: bool = False,
          llr_noise: float = 0.0) -> dict:
    """One SNR point of the cell -> chain.point's dict with streams and
    sent (the module's docstring)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    carrier, ch_cfg = cfg["carrier"], cfg["channel_config"]
    n_slots = traffic["slots_per_point"]
    if not traffic["use_batch"]:
        raise ValueError("the reference runs the slot-batched RX")
    scs, bw = carrier["scs"], carrier["BW"]
    fs_hz = fft_size(carrier_prb_size(scs, bw)) * scs * 1000.0
    waveform_config = dict(numofslots=n_slots, startSFN=0, startslot=0,
                           samplerate_in_mhz=fs_hz / 1e6)
    chan_cfg = chain.channel_config(traffic["channel"], carrier)
    spf = slots_per_frame(scs)
    slots = [i % spf for i in range(n_slots)]
    alloc = [i for i, sl in enumerate(slots)
             if (sl % ch_cfg["period_in_slot"]) in ch_cfg["allocated_slots"]]
    sent = payloads(ch_cfg, len(alloc), seed, dev)
    obj = UciPusch(carrier, ch_cfg, sent, np.random.default_rng(seed), dev)
    model = chan_mod.NrChannelModel(
        chan_cfg, -snr_db, carrier["carrier_frequency_in_mhz"] * 1e6,
        fs_hz, scs, seed=seed, device=dev)
    if np.any(model.gen_Dm(n_slots)):
        raise ValueError("the frozen reference has no timing-error path")
    rnd = chain.to_bf16 if bf16 else (lambda x: x)
    tx = rnd(ul_wf.gen_ul_waveform(waveform_config, carrier, obj,
                                   trblks=trblks))
    rx = rnd(model.filter(tx))
    grid = rnd(rx_wf.waveform_rx_processing(rx, carrier, fs_hz)[1])

    ce = chain.ce_config(cfg["ce"], chan_cfg, scs)
    ldpc = dict(chain.DEFAULT_LDPC_CONFIG, **cfg["ldpc"])
    full = grid.reshape(grid.shape[0], n_slots, -1).transpose(0, 1)
    stack = full[torch.as_tensor(alloc, device=dev)]
    llrs, ok, tbblk = {}, {}, {}
    streams = {name: {} for name in sent}
    with chain._llr_taps(llrs, bf16, llr_noise, seed):
        obj.rvidx = -1
        for algo in traffic["equalizers"]:
            out = obj.rx_process_batch(stack, [slots[i] for i in alloc],
                                       {"algo": algo}, ldpc, ce, fetch=False)
            ok[algo], tbblk[algo] = out[:2]
            for name, pair in out[2].items():
                streams[name][algo] = pair
    return dict(tx=tx, channel=rx, grid=grid,
                llr={a: torch.cat(v) for a, v in llrs.items()}, ok=ok,
                tbblk=tbblk, streams=streams, sent=sent)
