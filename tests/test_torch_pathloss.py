"""PyTorch port, the TR 38.901 pathloss models: the pathloss_cases
golden (the cases of tests/test_pathloss.py, rtol 1e-10), the vectorised
call, and the shadow-fading draw from an explicit Generator (the
reference's 10**(std/10) sigma).
"""
import numpy as np
import pytest

from tests.golden import get_golden
from tests.test_pathloss import CASES, FREQ

from python_5gtoolbox_tpu.models import pathloss as jpl

from python_5gtoolbox_tpu_torch.models import pathloss as tpl


def _no_golden_gen():
    raise RuntimeError("golden file missing")


@pytest.mark.parametrize("i", range(len(CASES)))
def test_pathloss_matches_golden(i):
    gold = get_golden("pathloss_cases", _no_golden_gen)
    scen, los, (dk, dv), extra = CASES[i]
    got = tpl.NrPathloss(scen, FREQ, los, **{dk: dv},
                         **extra).gen_pathloss_info()
    np.testing.assert_allclose([float(g) for g in got], gold[f"res_{i}"],
                               rtol=1e-10, err_msg=f"{scen} LOS={los}")


def test_pathloss_vectorized():
    d = np.array([20.0, 100.0, 3000.0])
    pl, sf, pr = tpl.NrPathloss("UMa", FREQ, True,
                                d2D=d).gen_pathloss_info()
    assert pl.shape == (3,)
    assert np.all(np.diff(pl) > 0)  # monotone in distance
    want = jpl.NrPathloss("UMa", FREQ, True, d2D=d).gen_pathloss_info()
    for a, b in zip((pl, sf, pr), want):
        np.testing.assert_array_equal(a, b)


def test_shadow_fading_draw():
    """The same Generator state gives the JAX package's draw; the hE
    distribution and the scenario list match."""
    kw = dict(Scenario="UMi", freq_in_Hz=FREQ, LOS=False, d2D=300.0,
              hUT=20.0)
    got = tpl.NrPathloss(rng=np.random.default_rng(3),
                         **kw).gen_new_pathloss()
    want = jpl.NrPathloss(rng=np.random.default_rng(3),
                          **kw).gen_new_pathloss()
    assert got == want
    t, j = tpl.NrPathloss(**kw), jpl.NrPathloss(**kw)
    assert t.get_hE_distribution() == j.get_hE_distribution()
    assert t.get_supported_Scenario_list() == j.get_supported_Scenario_list()
    assert t.get_config() == j.get_config()
    assert tpl.NrPathloss(**kw).gen_new_pathloss() \
        == tpl.NrPathloss(**kw).gen_new_pathloss()
