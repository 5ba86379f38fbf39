"""Hand random state drawn by another implementation to the port.

The port cannot reproduce jax.random streams or the JAX package's global
numpy draws, so to compute exactly what a JAX run computed, the caller
takes that run's draws as numpy arrays and passes them here:

  trblks (S, TBSize) 0/1            -> Pdsch / NrPUSCH.tx_grid_batch(trblks=),
                                        gen_ul_waveform(trblks=) on either
                                        branch (one row per allocated slot;
                                        the per-slot branch hands each row
                                        to NrPUSCH.process(trblk=))
  taps   per path (N, Nr, Nt) complex -> NrChannelModel.filter(taps=)
         (one array per path: 23 for TDL-A)
  noise  (Nr, N) complex, or a (real, imag) pair of unit normals
                                     -> NrChannelModel.filter(noise=)

The sweeps take one such dict per SNR point as states=, batched and per
slot alike (run_pdsch_throughput, run_pusch_throughput).

For the multi-channel DL waveform (the test models), pin_payloads draws
one random payload per PDSCH (a transport block) and per PDCCH (the DCI
bits) and writes each into its config's data_source: both packages'
Pdsch and Pdcch then send exactly those bits in every allocated slot.
"""
from __future__ import annotations

import numpy as np
import torch

from python_5gtoolbox_tpu_torch import resolve_device
from python_5gtoolbox_tpu_torch.phy.tbsize import gen_tbsize


def state_from_numpy(trblks=None, taps=None, noise=None, device=None
                     ) -> dict:
    """numpy draws -> dict(trblks=, taps=, noise=) of tensors on device
    (None -> cuda); absent entries stay None."""
    dev = resolve_device(device)
    out = dict(trblks=None, taps=None, noise=None)
    if trblks is not None:
        out["trblks"] = torch.as_tensor(
            np.array(trblks, np.int8), device=dev)
    if taps is not None:
        out["taps"] = [torch.as_tensor(np.array(t, np.complex64),
                                       device=dev) for t in taps]
    if noise is not None:
        if isinstance(noise, (tuple, list)):
            re, im = (np.asarray(v, np.float32) for v in noise)
            noise = re + 1j * im
        out["noise"] = torch.as_tensor(np.array(noise, np.complex64),
                                       device=dev)
    return out


def pin_payloads(rng: np.random.Generator, pdsch_configs=(),
                 pdcch_configs=()) -> dict:
    """Draw a transport block (TBSize bits) per PDSCH config and the DCI
    bits (NumDCIBits) per PDCCH config from rng and write each, as a list
    of ints, into the config's data_source (in place) -> dict(trblks=,
    dcibits=) of the numpy draws."""
    out = dict(trblks=[], dcibits=[])
    for key, cfgs, size in (
            ("trblks", pdsch_configs, lambda c: gen_tbsize(c)[0]),
            ("dcibits", pdcch_configs, lambda c: c["NumDCIBits"])):
        for cfg in cfgs:
            bits = rng.integers(0, 2, size(cfg)).astype(np.int8)
            cfg["data_source"] = bits.tolist()
            out[key].append(bits)
    return out
