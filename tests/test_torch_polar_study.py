"""PyTorch port, the polar decoder BLER study (sim/polar_decoder.py)
against the JAX package's (scripts/internal/sim_polar_internal.py) at the
study's code (K 64, E 128, nMax 10, iIL 0, CRC11) and a small trial
count: the same seed draws the same trials, so every BLER must be equal.
The JAX study decodes through its scan implementation, which compiles in
O(1) in N and is bit-identical to the unrolled one its "auto" picks at
N 128 (tests/test_polar.py:test_scl_impls_match_unrolled).
"""
import functools

import numpy as np

from scripts.internal import sim_polar_internal as jstudy

from python_5gtoolbox_tpu_torch.sim import polar_decoder as tstudy


def test_study_bler_matches_jax(monkeypatch):
    monkeypatch.setattr(jstudy.polar_ops, "polar_decode_scl",
                        functools.partial(jstudy.polar_ops.polar_decode_scl,
                                          impl="scan"))
    snrs = [1.0, 3.0]
    args = (tstudy.K, tstudy.E, tstudy.N_MAX, tstudy.I_IL, tstudy.CRC_LEN,
            ["SC", "SCL"], [8], snrs, None)
    ref = jstudy.run_polar_simulation(*args, n_trials=40, seed=4)
    got = tstudy.run_polar_simulation(*args, n_trials=40, seed=4,
                                      device="cpu", verbose=False)
    assert got[1] == ref[1] == [dict(algo="SC", L=1), dict(algo="SCL", L=8)]
    assert got[0] == ref[0]
    np.testing.assert_array_equal(np.asarray(got[2]), np.asarray(ref[2]))
    assert np.asarray(got[2]).min() < np.asarray(got[2]).max()
