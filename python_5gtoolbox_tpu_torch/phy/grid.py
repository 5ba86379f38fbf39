"""Writes of host-built channel values into a slot grid tensor.

The DL channels of the port (SSB, CSI-RS, PDCCH, the PDSCH DMRS) build
their few hundred values and positions per slot on the host, as the JAX
package does, and write them into the slot's (ant, 14*n_sc) grid, a
tensor that may live on the card, with one indexed write: on a CUDA
tensor every sliced write is a launch, so the per-symbol and per-PRB
writes of the JAX package become one.
"""
from __future__ import annotations

import numpy as np
import torch


def write_res(fd_slot: torch.Tensor, ant, re, vals) -> None:
    """fd_slot[ant[i], re[i]] = vals[i] for every i, in one indexed write.

    ant, re and vals broadcast against each other (ant (k, 1) against re
    (k, m), say). Positions must not repeat."""
    flat = np.asarray(ant, np.int64) * fd_slot.shape[-1] \
        + np.asarray(re, np.int64)
    if flat.size == 0:
        return
    vals = np.broadcast_to(np.asarray(vals, np.complex64), flat.shape)
    dev = fd_slot.device
    fd_slot.view(-1)[torch.as_tensor(flat.reshape(-1), device=dev)] = \
        torch.as_tensor(vals.reshape(-1).copy(), device=dev)
