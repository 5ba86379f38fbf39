"""PyTorch port, the small block codes: encode and rate match against the
reference goldens (as tests/test_smallblock.py), and rate recovery, the
special-table codebook and the ML decode against the JAX package on the
same LLRs. Bits match exactly; recovered LLRs exactly (the repetitions
are added one after the other, as the JAX package's reduction does at
these counts).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.golden import get_golden
from tests.test_smallblock import SB_CASES

from python_5gtoolbox_tpu.ops import smallblock as JSB
from python_5gtoolbox_tpu.phy import pusch as _jpusch  # noqa: F401 (first)
from python_5gtoolbox_tpu.phy import pusch_rx as jrx

from python_5gtoolbox_tpu_torch.ops import smallblock as TSB


def _no_golden_gen():
    raise RuntimeError("golden file missing")


@pytest.mark.parametrize("i", range(len(SB_CASES)))
def test_sb_encode_and_ratematch(i):
    gold = get_golden("smallblock_cases", _no_golden_gen)
    k, qm = SB_CASES[i]
    bits = gold[f"in_{i}"]
    np.testing.assert_array_equal(TSB.encode_smallblock_np(bits, qm),
                                  gold[f"dn_{i}"])
    batched = TSB.encode_smallblock(torch.as_tensor(bits[None]), qm)
    np.testing.assert_array_equal(batched[0].numpy(), gold[f"dn_{i}"])
    dn = np.where(gold[f"dn_{i}"] < 0, 0, gold[f"dn_{i}"]).astype("i1")
    got = TSB.ratematch_smallblock(torch.as_tensor(dn[None]),
                                   dn.size * 2 + 3)[0]
    np.testing.assert_array_equal(got.numpy(), gold[f"rm_{i}"])


@pytest.mark.parametrize("E,N", [(77, 32), (96, 32), (600, 32), (7, 3),
                                 (36, 12), (2, 1)])
def test_sb_raterecover_matches_jax(E, N):
    llr = np.random.default_rng(E + N).normal(size=(3, E)).astype(np.float32)
    got = TSB.raterecover_smallblock(torch.as_tensor(llr), N)
    ref = JSB.raterecover_smallblock(jnp.asarray(llr), N)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("k", range(3, 12))
def test_sb_decode_matches_jax(k):
    """Noisy codewords of every K in 3..11 (some at an SNR that breaks
    them): the ML decode picks the same codeword in both packages, and
    the clean ones decode to what was sent."""
    rng = np.random.default_rng(66 + k)
    bits = rng.integers(0, 2, (8, k)).astype(np.int8)
    dn = TSB.encode_smallblock(torch.as_tensor(bits)).numpy()
    llr = (1.0 - 2.0 * dn) * 4.0
    llr[:4] += rng.normal(size=(4, 32)) * 0.5
    llr[4:] += rng.normal(size=(4, 32)) * 6.0
    llr = llr.astype(np.float32)
    got = TSB.decode_smallblock(torch.as_tensor(llr), k).numpy()
    ref = np.asarray(JSB.decode_smallblock(jnp.asarray(llr), k))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[:4], bits[:4])


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("qm", [1, 2, 4, 6, 8])
def test_special_codebook_matches_jax(k, qm):
    np.testing.assert_array_equal(TSB.special_codebook(k, qm),
                                  jrx._special_codebook(k, qm))
