"""PyTorch port, CSI-RS rows 1-5: the slot grid against the csirs_slot2
goldens of tests/test_csirs.py (usage exact, grid 2e-5) and the JAX
package (1e-6), and the inactive slot.
"""
import numpy as np
import pytest
import torch

from tests.golden import get_golden
from tests.test_csirs import CSIRS_CASES, _case_scs_bw, _mk_cfg

from python_5gtoolbox_tpu.phy import csirs as jcsirs
from python_5gtoolbox_tpu.utils.config import get_default_config, merged

from python_5gtoolbox_tpu_torch.phy import csirs as tcsirs
from python_5gtoolbox_tpu_torch.utils.numerology import carrier_prb_size


def _no_golden_gen():
    raise RuntimeError("golden file missing")


@pytest.mark.parametrize("i", range(len(CSIRS_CASES)))
def test_csirs_slot(i):
    gold = get_golden("csirs_slot2", _no_golden_gen)
    case = CSIRS_CASES[i]
    nant, slot = case[5], case[6]
    cfg = _mk_cfg(get_default_config("csirs"), case)
    scs, bw = _case_scs_bw(case)
    carrier = merged(get_default_config("dl_carrier"),
                     dict(num_of_ant=nant, BW=bw, scs=scs))
    n_rows, n = max(nant, case[1]), 14 * 12 * carrier_prb_size(scs, bw)
    fd, usage = tcsirs.NrCSIRS(carrier, cfg).process(
        torch.zeros((n_rows, n), dtype=torch.complex64),
        np.zeros((n_rows, n), np.int8), 0, slot)
    np.testing.assert_array_equal(usage, gold[f"usage_{i}"])
    np.testing.assert_allclose(fd.numpy(), gold[f"fd_{i}"], atol=2e-5)
    fd_j, usage_j = jcsirs.NrCSIRS(carrier, cfg).process(
        np.zeros((n_rows, n), np.complex64), np.zeros((n_rows, n), np.int8),
        0, slot)
    np.testing.assert_array_equal(usage, usage_j)
    np.testing.assert_allclose(fd.numpy(), fd_j, atol=1e-6)


def test_csirs_inactive_slot():
    cfg = get_default_config("csirs")
    carrier = merged(get_default_config("dl_carrier"), dict(BW=40, scs=30))
    n = 14 * 12 * carrier_prb_size(30, 40)
    fd, usage = tcsirs.NrCSIRS(carrier, cfg).process(
        torch.zeros((1, n), dtype=torch.complex64), np.zeros((1, n), np.int8),
        0, 3)                          # periodicity 20, offset 0
    assert not fd.abs().any() and not usage.any()
