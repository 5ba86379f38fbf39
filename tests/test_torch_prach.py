"""PyTorch port, PRACH: the preamble sequences, Prach.process and
gen_prach_waveform against the prach_seq, prach_process and
prach_waveform goldens (the cases of tests/test_prach.py, at its
tolerances: 1e-6, 2e-4 and 3e-4), and prach_upsample (banded_fir `up2`
with the 56-tap halfband, banded_fir_plain on the CPU) against the JAX
package's prach_upsample for 1-3 stages within 1e-5.
"""
import numpy as np
import pytest
import torch

from tests.golden import get_golden
from tests.test_prach import PRACH_CASES, SEQ_CASES

from python_5gtoolbox_tpu.phy import prach as jprach

from python_5gtoolbox_tpu_torch.phy import prach as tprach
from python_5gtoolbox_tpu_torch.utils.config import get_default_config, merged


def _no_golden_gen():
    raise RuntimeError("golden file missing")


@pytest.mark.parametrize("i", range(len(SEQ_CASES)))
def test_prach_seq_matches_golden(i):
    gold = get_golden("prach_seq", _no_golden_gen)
    np.testing.assert_allclose(tprach.prach_seq_gen(*SEQ_CASES[i]),
                               gold[f"seq_{i}"], atol=1e-6)


@pytest.mark.parametrize("i", range(len(PRACH_CASES)))
def test_prach_process_matches_golden(i):
    gold = get_golden("prach_process", _no_golden_gen)
    ci, duplex, cscs, mscs, sfn, sub, pi = PRACH_CASES[i]
    base = get_default_config("prach")
    carrier = merged(get_default_config("ul_carrier"),
                     dict(scs=cscs, BW=40, duplex_type=duplex))
    cfg = merged(base["config"], dict(prach_ConfigurationIndex=ci,
                                      msg1_SubcarrierSpacing=mscs))
    par = merged(base["parameters"], dict(PRACH_subframe=sub,
                                          PreambleIndex=pi))
    ch = tprach.Prach(carrier, cfg, par)
    wav, data, active = ch.process(sfn)
    assert active == gold[f"active_{i}"][0] == int(ch.is_active(sfn))
    np.testing.assert_allclose(wav, gold[f"wav_{i}"], atol=2e-4)
    if active:
        np.testing.assert_allclose(data, gold[f"data_{i}"], atol=2e-4)


def test_prach_waveform_matches_golden():
    gold = get_golden("prach_waveform", _no_golden_gen)
    base = get_default_config("prach")
    carrier = merged(get_default_config("ul_carrier"),
                     dict(scs=30, BW=40, duplex_type="FDD"))
    wf = merged(get_default_config("ul_waveform"),
                dict(numofslots=5, samplerate_in_mhz=61.44))
    cfg = merged(base["config"], dict(prach_ConfigurationIndex=16,
                                      msg1_SubcarrierSpacing=15))
    td, datas = tprach.gen_prach_waveform(wf, carrier, cfg,
                                          base["parameters"], device="cpu")
    assert td.device.type == "cpu" and td.dtype == torch.complex64
    np.testing.assert_allclose(td.numpy(), gold["td"], atol=3e-4)
    np.testing.assert_allclose(datas.numpy(), gold["datas"], atol=3e-4)


@pytest.mark.parametrize("reps", [1, 2, 3])
def test_prach_upsample_matches_jax(reps):
    """Two rows of 3000 random complex samples; the JAX chain is XLA's
    dilated convolution with no sqrt(2) gain and the n//2 offset."""
    rng = np.random.default_rng(reps)
    x = (rng.standard_normal((2, 3000))
         + 1j * rng.standard_normal((2, 3000))).astype(np.complex64)
    got = tprach.prach_upsample(torch.as_tensor(x), reps)
    assert tprach.prach_halfband().size == 56
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jprach.prach_upsample(x, reps)),
                               atol=1e-5)


def test_prach_waveform_refuses_other_rates():
    base = get_default_config("prach")
    wf = merged(get_default_config("ul_waveform"),
                dict(numofslots=20, samplerate_in_mhz=100.0))
    with pytest.raises(ValueError, match="power of two"):
        tprach.gen_prach_waveform(wf, get_default_config("ul_carrier"),
                                  base["config"], base["parameters"],
                                  device="cpu")
