"""A frozen copy of the PyTorch port's link-level chain, plain PyTorch.

The modules under this package are copies of the port's modules taken
when the benchmark was written, cut to what the benchmark's cells run:
the slot-batched PDSCH and PUSCH TX at the carrier rate, the fading
channel, the RX front end, the slot-batched and the per-slot RX. Every
hand-written kernel is replaced by its plain PyTorch version (the FIR by
conv1d, the LDPC decoder by its tensor loop). Later changes to the port
do not reach this copy; it is the reference the port is judged by.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None -> cuda. Raises if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available")
    return dev


def on_device(x) -> torch.Tensor:
    """A tensor keeps its device; anything else goes to the card."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, device=resolve_device(None))
