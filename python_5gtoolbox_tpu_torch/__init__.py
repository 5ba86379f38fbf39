"""PyTorch/CUDA port of python_5gtoolbox_tpu (5G NR Release-15 PHY).

Same subpaths and public names as the JAX package. IQ is complex64 end
to end; six kernels are hand-written CUDA under csrc/, one for each
Pallas kernel of the JAX package, built on first use by kernels.py: the
banded FIR and the min-sum LDPC decoder of the link-level PDSCH sweep
(flooded or layered, exact or fast check node), the same decoder for
small liftings with its whole state in shared memory, and the three
fused DUC kernels of the 245.76 Msps waveform path (FIR + halfband from
a flat plane, from per-symbol IFFT outputs with CP insertion, and from
the spectrum with the IDFT inside). Every other operation is plain
PyTorch.

Entry points take `device=`; None means the CUDA card, and there is no
silent CPU fallback: pass device="cpu" to run on the host.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None -> cuda. Raises if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' "
                           "to run the port on the host")
    return dev


def on_device(x) -> torch.Tensor:
    """A tensor keeps its device; anything else (numpy, a list) goes to
    resolve_device(None), the card, as an entry point's default."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, device=resolve_device(None))
