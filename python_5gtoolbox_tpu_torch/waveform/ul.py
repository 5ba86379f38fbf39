"""Uplink waveform orchestration: PUSCH only.

Port of python_5gtoolbox_tpu/waveform/ul.py (gen_ul_waveform). Two
branches, as in the JAX package:

* a single batch-capable PUSCH (UL-SCH only, NrPUSCH.tx_batch_supported)
  encodes and composes every slot grid at once (tx_grid_batch).
  return_device picks the back end: True runs filters.tx_lowphy_duc with
  the antenna roll folded into the precoder and the slot phase before the
  IFFT (the spectrum DUC kernel duc_from_spec above the carrier rate,
  nfft >= 1024) and gives no td; False runs ofdm.tx_low_phy, the slot
  phase and filters.tx_channel_filter (fir_up2_fused above the carrier
  rate) and returns td;
* any other PUSCH list (UCI on PUSCH, several PUSCHs) runs the per-slot
  NrPUSCH.process into one grid per slot, then ofdm.tx_low_phy, the slot
  phase and filters.tx_channel_filter, and returns td whatever
  return_device says. The grids stay on the PUSCH's device (the JAX
  package builds them on the host).

Every output is a tensor on the PUSCH's device. Every branch counts the
slot phase from startslot, as the port's gen_dl_waveform does (the JAX
package's composed branches count from 0). SRS and PUCCH formats 0-4
(Queue A item 5) are not ported.
"""
from __future__ import annotations

import torch

from python_5gtoolbox_tpu_torch.ops import filters, ofdm
from python_5gtoolbox_tpu_torch.utils import numerology as num


def gen_ul_waveform(waveform_config: dict, carrier_config: dict,
                    nrPusch_list=(), nrSrs_list=(),
                    nrPucchFormat0_list=(), nrPucchFormat1_list=(),
                    nrPucchFormat2_list=(), nrPucchFormat3_list=(),
                    nrPucchFormat4_list=(), return_device: bool = False,
                    trblks=None):
    """-> (fd_waveform, td_waveform, ul_waveform), tensors on the PUSCH's
    device: fd (ant, S*14*12*prb), td (ant, S*slot_samples) or None
    (batched branch with return_device=True), ul at
    waveform_config["samplerate_in_mhz"]. trblks (Sa, TBSize), one row
    per allocated slot, replaces the drawn blocks (a single PUSCH only)."""
    others = (nrSrs_list, nrPucchFormat0_list, nrPucchFormat1_list,
              nrPucchFormat2_list, nrPucchFormat3_list, nrPucchFormat4_list)
    if not nrPusch_list or any(others):
        raise NotImplementedError("only PUSCH waveforms are ported (SRS and "
                                  "PUCCH: Queue A item 5)")
    pusch = nrPusch_list[0]
    n_slots = waveform_config["numofslots"]
    start_slot = waveform_config["startslot"]
    out_rate_hz = waveform_config["samplerate_in_mhz"] * 1e6
    nant = carrier_config["num_of_ant"]
    fc_hz = int(carrier_config["carrier_frequency_in_mhz"] * 1e6)
    scs, bw = carrier_config["scs"], carrier_config["BW"]
    spf = num.slots_per_frame(scs)
    slots = [(start_slot + idx) % spf for idx in range(n_slots)]

    if len(nrPusch_list) == 1 and pusch.tx_batch_supported():
        if return_device:
            roll = nant // 2 if nant > 1 else 0
            fd = pusch.tx_grid_batch(slots, roll_ant=roll, trblks=trblks)
            ul = filters.tx_lowphy_duc(fd.transpose(0, 1), scs, bw, fc_hz,
                                       out_rate_hz, slot_phase=True,
                                       start_slot=start_slot)
            if roll:
                fd = torch.roll(fd, roll, dims=1)  # fd is the unrolled grid
            return fd.transpose(0, 1).reshape(nant, -1), None, ul
        fd = pusch.tx_grid_batch(slots, trblks=trblks)
    else:
        if trblks is not None and len(nrPusch_list) != 1:
            raise ValueError("trblks= needs a single PUSCH")
        fd = _per_slot_grids(nrPusch_list, slots, nant,
                             12 * num.carrier_prb_size(scs, bw), trblks)
    td = ofdm.tx_low_phy(fd, scs, bw, fc_hz)
    ph = ofdm._slot_phase_const(scs, fc_hz, n_slots, start_slot)
    td = td * torch.as_tensor(ph, device=fd.device)[:, None, None]
    td_flat = td.transpose(0, 1).reshape(nant, -1)
    ul = filters.tx_channel_filter(td_flat, scs, bw, out_rate_hz)
    return fd.transpose(0, 1).reshape(nant, -1), td_flat, ul


def _per_slot_grids(nrPusch_list, slots, nant, n_sc, trblks=None
                    ) -> torch.Tensor:
    """Every PUSCH's process() slot by slot into shared grids ->
    (S, ant, 14, n_sc) complex64 on the first PUSCH's device."""
    dev = nrPusch_list[0].device
    grids = torch.zeros((len(slots), nant, 14 * n_sc),
                        dtype=torch.complex64, device=dev)
    usages = torch.zeros((len(slots), nant, 14 * n_sc), dtype=torch.int8,
                         device=dev)
    rows = None if trblks is None else iter(trblks)
    for idx, slot in enumerate(slots):
        for ch in nrPusch_list:
            allocated = ch.is_active_slot(slot)
            trblk = next(rows) if rows is not None and allocated else None
            ch.process(grids[idx], usages[idx], slot, trblk=trblk)
    return grids.reshape(len(slots), nant, 14, n_sc)
