"""PyTorch port, PDCCH and DCI: the DCI encoder, the PDCCH slot grid and
the DCI payload formats, held against the reference goldens of
tests/test_pdcch.py and tests/test_dci.py (coded bits and usage exact,
grids 2e-5) and against the JAX package (CORESET maps, search-space
hashing and the slot grid on the same DCI bits).
"""
import numpy as np
import pytest
import torch

from tests.golden import get_golden
from tests.test_dci import CASES as DCI_FORMAT_CASES
from tests.test_pdcch import DCI_CASES, PDCCH_SLOT_CASES, _mk_cfgs

from python_5gtoolbox_tpu.phy import dci as jdci
from python_5gtoolbox_tpu.phy import pdcch as jpdcch
from python_5gtoolbox_tpu.utils.config import get_default_config

from python_5gtoolbox_tpu_torch.phy import dci as tdci
from python_5gtoolbox_tpu_torch.phy import pdcch as tpdcch
from python_5gtoolbox_tpu_torch.utils.numerology import carrier_prb_size


def _no_golden_gen():
    raise RuntimeError("golden file missing")


@pytest.mark.parametrize("i", range(len(DCI_CASES)))
def test_dci_encode(i):
    gold = get_golden("pdcch_dci", _no_golden_gen)
    _, rnti, E = DCI_CASES[i]
    got = tpdcch.dci_encode(gold[f"in_{i}"], rnti, E)
    np.testing.assert_array_equal(got, gold[f"out_{i}"])
    np.testing.assert_array_equal(
        got, jpdcch.dci_encode(gold[f"in_{i}"], rnti, E))


def _cfgs(i):
    cfgs = dict(carrier=get_default_config("dl_carrier"),
                coreset=get_default_config("coreset"),
                ss=get_default_config("search_space"),
                pdcch=get_default_config("pdcch"))
    return _mk_cfgs(cfgs, PDCCH_SLOT_CASES[i], False)


@pytest.mark.parametrize("i", range(len(PDCCH_SLOT_CASES)))
def test_pdcch_slot(i):
    gold = get_golden("pdcch_slot", _no_golden_gen)
    carrier, coreset, ss, pd = _cfgs(i)
    slot = PDCCH_SLOT_CASES[i][-1]
    nrss = tpdcch.NrSearchSpace(carrier, ss, coreset)
    n = 14 * 12 * carrier_prb_size(30, 40)
    fd = torch.zeros((1, n), dtype=torch.complex64)
    usage = np.zeros((1, n), np.int8)
    fd, usage = tpdcch.Pdcch(pd, nrss).process(fd, usage, 0, slot)
    np.testing.assert_array_equal(usage, gold[f"usage_{i}"])
    np.testing.assert_allclose(fd.numpy(), gold[f"fd_{i}"], atol=2e-5)


@pytest.mark.parametrize("i", range(len(PDCCH_SLOT_CASES)))
def test_pdcch_random_bits_match_jax(i):
    """Random DCI bits drawn by the port, handed to the JAX Pdcch through
    data_source: the same grid; CORESET maps and the search-space
    reservation equal."""
    carrier, coreset, ss, pd = _cfgs(i)
    slot = PDCCH_SLOT_CASES[i][-1]
    pd = dict(pd, data_source=[])
    t_ss = tpdcch.NrSearchSpace(carrier, ss, coreset)
    j_ss = jpdcch.NrSearchSpace(carrier, ss, coreset)
    np.testing.assert_array_equal(t_ss.coreset.cce_to_reg,
                                  j_ss.coreset.cce_to_reg)
    ch = tpdcch.Pdcch(pd, t_ss, rng=np.random.default_rng(i))
    bits = np.random.default_rng(i).integers(0, 2, pd["NumDCIBits"])
    n = 14 * 12 * carrier_prb_size(30, 40)
    fd, usage = ch.process(torch.zeros((1, n), dtype=torch.complex64),
                           np.zeros((1, n), np.int8), 0, slot)
    fd_j, usage_j = jpdcch.Pdcch(dict(pd, data_source=bits.tolist()),
                                 j_ss).process(
        np.zeros((1, n), np.complex64), np.zeros((1, n), np.int8), 0, slot)
    np.testing.assert_array_equal(usage, usage_j)
    np.testing.assert_allclose(fd.numpy(), fd_j, atol=1e-6)
    u_t, u_j = np.zeros((1, n), np.int8), np.zeros((1, n), np.int8)
    np.testing.assert_array_equal(t_ss.process(u_t, 0, slot),
                                  j_ss.process(u_j, 0, slot))


def test_dci_formats_match_reference():
    gold = get_golden("dci_formats", _no_golden_gen)
    for i, (prb, riv, imcs, rv, hid) in enumerate(DCI_FORMAT_CASES):
        np.testing.assert_array_equal(
            tdci.gen_dciformat00(prb, riv, imcs, rv, hid), gold[f"d00_{i}"])
        np.testing.assert_array_equal(
            tdci.gen_dciformat01(prb, riv, imcs, rv, hid), gold[f"d01_{i}"])
        np.testing.assert_array_equal(
            tdci.gen_dciformat10(prb, riv, 2, 12, imcs, rv, hid),
            gold[f"d10_{i}"])
        np.testing.assert_array_equal(
            tdci.gen_dciformat11(prb, riv, 2, 12, imcs, rv, hid),
            gold[f"d11_{i}"])
        assert tdci.type1_riv(2, min(prb - 2, 20), prb) == \
            gold[f"riv_{i}"][0]


@pytest.mark.parametrize("args", [(4, 6, 15, 101), (0, 15, 30, 7),
                                  (10, 3, 30, 500)])
def test_coreset0_config_matches_jax(args):
    assert tdci.gen_coreset0_config(*args) == jdci.gen_coreset0_config(*args)
