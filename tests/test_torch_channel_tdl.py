"""PyTorch port, the TDL channel profiles (TR 38.901 7.7.2 TDL-A..E from
data/tdl_profiles.npz): the tap lists and channel configurations against
the JAX package, and NrChannelModel.filter over every path of TDL-A
(Rayleigh taps) and TDL-D (Rician first tap) with the JAX run's own
fading taps and noise pinned.

Tolerances: tap lists and configurations exactly; IQ after the channel
1e-5 relative to its peak (tests/test_torch_slice.py).
"""
import numpy as np
import pytest
import torch

import jax

from python_5gtoolbox_tpu.models import channel as jchan

from python_5gtoolbox_tpu_torch.interop import state_from_numpy
from python_5gtoolbox_tpu_torch.models import channel as tchan

MODELS = ["TDL-A", "TDL-B", "TDL-C", "TDL-D", "TDL-E"]
TAPS = {"TDL-A": 23, "TDL-B": 23, "TDL-C": 24, "TDL-D": 12, "TDL-E": 14}


@pytest.mark.parametrize("model", MODELS)
def test_tdl_config_matches_jax(model):
    got = tchan.get_tdl_model_config(model, 30.0, 200.0)
    assert got == jchan.get_tdl_model_config(model, 30.0, 200.0)
    assert len(got) == TAPS[model]
    rician = [p[2] == "Rician" for p in got]
    assert rician == [model in ("TDL-D", "TDL-E")] + [False] * (len(got) - 1)
    kw = dict(model_format=model, Nt=1, Nr=2, fm_inHz=200, DSdesired=30,
              Rspat_config=("low", "uniform", "UL", (0, 0)))
    tc, jc = (tchan.gen_channel_model_config(**kw),
              jchan.gen_channel_model_config(**kw))
    assert tc["multi_paths"] == jc["multi_paths"]
    np.testing.assert_array_equal(tc["Rspat"], jc["Rspat"])
    assert {k: v for k, v in tc.items() if k not in ("multi_paths", "Rspat")} \
        == {k: v for k, v in jc.items() if k not in ("multi_paths", "Rspat")}


def test_unknown_format_refused():
    for mod in (tchan, jchan):
        with pytest.raises(ValueError):
            mod.gen_channel_model_config(model_format="TDL-F")


@pytest.mark.parametrize("model", ["TDL-A", "TDL-D"])
def test_tdl_filter_with_jax_draws(model):
    """Every path's delay and power, and the Rician first tap of TDL-D,
    give the JAX result when the fading taps of all paths are pinned."""
    kw = dict(model_format=model, Nt=1, Nr=2, fm_inHz=200, DSdesired=300,
              Rspat_config=("low", "uniform", "UL", (0, 0)))
    jc = jchan.gen_channel_model_config(**kw)
    tc = tchan.gen_channel_model_config(**kw)
    fc, fs, scs, n, seed = 3.84e9, 30.72e6, 30, 3000, 7
    tx = (np.random.default_rng(2).normal(size=(1, n))
          + 1j * np.random.default_rng(3).normal(size=(1, n))
          ).astype(np.complex64)
    jm = jchan.NrChannelModel(jc, -20.0, fc, fs, scs, seed=seed)
    ref = np.asarray(jm.filter(tx))
    m = jchan.NrChannelModel(jc, -20.0, fc, fs, scs, seed=seed)
    taps = [np.asarray(jchan.gen_mimo_channel(
        m._next_key(), m.nt, m.nr, m.rspat, n, m.fs, p[2], p[3], p[4],
        m.fm, m.n_sin)) for p in m.multi_paths]
    k1, k2 = jax.random.split(m._next_key())
    noise = (np.asarray(jax.random.normal(k1, (m.nr, n))),
             np.asarray(jax.random.normal(k2, (m.nr, n))))
    st = state_from_numpy(taps=taps, noise=noise, device="cpu")
    assert len(st["taps"]) == TAPS[model]
    got = tchan.NrChannelModel(tc, -20.0, fc, fs, scs, seed=seed,
                               device="cpu").filter(
        torch.as_tensor(tx), taps=st["taps"], noise=st["noise"]).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-5


def test_tdl_own_draws_power():
    """The port's own TDL-A draws: 23 paths, unit total mean power (the
    table's powers are normalized) within sampling error."""
    tc = tchan.gen_channel_model_config(model_format="TDL-A", Nt=1, Nr=1,
                                        fm_inHz=200, DSdesired=30)
    powers = 10 ** (np.array([p[1] for p in tc["multi_paths"]]) / 10)
    model = tchan.NrChannelModel(tc, 255, 3.84e9, 30.72e6, 30, seed=1,
                                 device="cpu")
    n = 200000
    rx = model.filter(torch.ones((1, n), dtype=torch.complex64)).numpy()
    tail = rx[0, 1000:]
    assert abs(np.mean(np.abs(tail) ** 2) / (2 * powers.sum()) - 1) < 0.3
