"""PyTorch port, low-PHY: OFDM modulation/demodulation and the channel
filters, against the reference goldens and the JAX package.

Tolerances: IQ against the JAX functions 1e-5 (docs/architecture.md
principle 4); IQ against the reference goldens 2e-4 (as
tests/test_lowphy.py, the reference works in float64); the FIR stages
against the JAX filters 1.2e-4 (tests/test_pallas_filters.py). The JAX
filters take their direct-conv branch below 4096 samples and the blocked
overlap-save branch above; both are held here. Tap designs must be equal.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.golden import get_golden

from python_5gtoolbox_tpu.ops import filters as jf
from python_5gtoolbox_tpu.ops import ofdm as jofdm
from python_5gtoolbox_tpu.utils import numerology as num

from python_5gtoolbox_tpu_torch.ops import filters as tf
from python_5gtoolbox_tpu_torch.ops import ofdm as tofdm

IQ_TOL = 1e-5
FIR_TOL = 1.2e-4

# cases of tests/test_lowphy.py: (scs, BW, num_ant, carrier_freq_mhz)
LP_CASES = [(15, 5, 1, 0), (15, 20, 2, 1900.05), (30, 20, 2, 3500.1),
            (30, 100, 4, 3500.1)]


@pytest.fixture(scope="module")
def lowphy_goldens():
    def _missing():
        raise RuntimeError("golden file missing")
    return get_golden("lowphy_cases", _missing)


@pytest.mark.parametrize("i", range(len(LP_CASES)))
def test_tx_low_phy(lowphy_goldens, i):
    scs, bw, nant, fc = LP_CASES[i]
    prb = num.carrier_prb_size(scs, bw)
    fd = lowphy_goldens[f"fd_{i}"].reshape(nant, 14, 12 * prb)
    td = tofdm.tx_low_phy(torch.as_tensor(fd), scs, bw, int(fc * 1e6)).numpy()
    np.testing.assert_allclose(td, lowphy_goldens[f"td_{i}"], atol=2e-4)
    ref = np.asarray(jofdm.tx_low_phy(jnp.asarray(fd), scs, bw,
                                      int(fc * 1e6)))
    np.testing.assert_allclose(td, ref, atol=IQ_TOL)


@pytest.mark.parametrize("i", range(len(LP_CASES)))
def test_rx_low_phy(lowphy_goldens, i):
    scs, bw, nant, fc = LP_CASES[i]
    prb = num.carrier_prb_size(scs, bw)
    td = lowphy_goldens[f"td_{i}"]
    fd = tofdm.rx_low_phy(torch.as_tensor(td), scs, bw, int(fc * 1e6)
                          ).numpy()
    np.testing.assert_allclose(
        fd, lowphy_goldens[f"fdrx_{i}"].reshape(nant, 14, 12 * prb),
        atol=2e-4)
    ref = np.asarray(jofdm.rx_low_phy(jnp.asarray(td), scs, bw,
                                      int(fc * 1e6)))
    np.testing.assert_allclose(fd, ref, atol=IQ_TOL)


def test_tx_low_phy_batched_with_timing_error():
    """Slot batch, antenna roll off and a per-symbol timing ramp (the
    sweep's impairment path) against the JAX function."""
    rng = np.random.default_rng(5)
    scs, bw, fc = 30, 10, 3840_000_000
    prb = num.carrier_prb_size(scs, bw)
    fd = (rng.normal(size=(2, 2, 14, 12 * prb))
          + 1j * rng.normal(size=(2, 2, 14, 12 * prb))).astype(np.complex64)
    dm = rng.uniform(-2e-8, 2e-8, size=(2, 14))
    for roll in (True, False):
        got = tofdm.tx_low_phy(torch.as_tensor(fd), scs, bw, fc,
                               dm=torch.as_tensor(dm), roll_ant=roll)
        ref = jofdm.tx_low_phy(jnp.asarray(fd), scs, bw, fc,
                               dm=jnp.asarray(dm), roll_ant=roll)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=IQ_TOL)
    np.testing.assert_array_equal(tofdm._slot_phase_const(scs, fc, 4, 1),
                                  jofdm._slot_phase_const(scs, fc, 4, 1))
    assert tofdm.slot_sample_count(scs, bw) == \
        jofdm.slot_sample_count(scs, bw)


# ---------------------------------------------------------------------------
# Channel filters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scs,bw", [(30, 20), (30, 100), (15, 10), (30, 10)])
def test_filter_taps_equal(scs, bw):
    np.testing.assert_array_equal(tf.fir_coeff(scs, bw), jf.fir_coeff(scs, bw))
    np.testing.assert_array_equal(tf.halfband_coeff(), jf.halfband_coeff())


STAGES = [("same", tf.fir_same, jf.fir_same),
          ("up2", tf.hb_upsample2, jf.hb_upsample2),
          ("down2", tf.hb_downsample2, jf.hb_downsample2)]


@pytest.mark.parametrize("t", [1000, 6000], ids=["conv1d", "blocked"])
@pytest.mark.parametrize("stage", STAGES, ids=[s[0] for s in STAGES])
@pytest.mark.parametrize("taps_of", ["fir71", "fir287", "hb55"])
def test_fir_stage_matches_jax(stage, t, taps_of):
    taps = {"fir71": jf.fir_coeff(30, 20), "fir287": jf.fir_coeff(30, 100),
            "hb55": jf.halfband_coeff()}[taps_of]
    _, fn_t, fn_j = stage
    rng = np.random.default_rng(t + len(taps))
    x = (rng.normal(size=(2, t)) + 1j * rng.normal(size=(2, t))
         ).astype(np.complex64)
    got = fn_t(torch.as_tensor(x), taps).numpy()
    ref = np.asarray(fn_j(jnp.asarray(x), taps))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < FIR_TOL


def test_tx_channel_filter_golden(lowphy_goldens):
    """Carrier-rate FIR + halfband chain up to 245.76 Msps against the
    reference (LP case 0: 3 halfband stages)."""
    scs, bw, _, _ = LP_CASES[0]
    td = lowphy_goldens["td_0"]
    dl = tf.tx_channel_filter(torch.as_tensor(td), scs, bw).numpy()
    ref = lowphy_goldens["dl_0"]
    assert dl.shape == ref.shape
    np.testing.assert_allclose(dl, ref, atol=2e-4)


@pytest.mark.parametrize("rate", [1, 2], ids=["carrier_rate", "x2"])
def test_channel_filters_match_jax(rate):
    rng = np.random.default_rng(9 + rate)
    scs, bw = 30, 10
    fs = num.fft_size(num.carrier_prb_size(scs, bw)) * scs * 1000
    x = (rng.normal(size=(2, 3000)) + 1j * rng.normal(size=(2, 3000))
         ).astype(np.complex64)
    got = tf.tx_channel_filter(torch.as_tensor(x), scs, bw, rate * fs)
    ref = jf.tx_channel_filter(jnp.asarray(x), scs, bw, rate * fs)
    assert np.abs(got.numpy() - np.asarray(ref)).max() < FIR_TOL
    back = tf.rx_channel_filter(got, scs, bw, rate * fs)
    back_ref = jf.rx_channel_filter(ref, scs, bw, rate * fs)
    assert np.abs(back.numpy() - np.asarray(back_ref)).max() < FIR_TOL


def test_tx_lowphy_duc_carrier_rate_matches_jax():
    """The sweep's TX path: OFDM + slot phase + FIR at the carrier rate."""
    rng = np.random.default_rng(17)
    scs, bw, fc = 30, 10, 3840_000_000
    prb = num.carrier_prb_size(scs, bw)
    fs = num.fft_size(prb) * scs * 1000
    fd = (rng.normal(size=(2, 2, 14, 12 * prb))
          + 1j * rng.normal(size=(2, 2, 14, 12 * prb))).astype(np.complex64)
    got = tf.tx_lowphy_duc(torch.as_tensor(fd), scs, bw, fc, fs,
                           slot_phase=True, start_slot=3)
    ref = jf.tx_lowphy_duc(jnp.asarray(fd), scs, bw, fc, fs,
                           slot_phase=True, start_slot=3)
    assert got.shape == ref.shape
    assert np.abs(got.numpy() - np.asarray(ref)).max() < FIR_TOL


@pytest.mark.parametrize("mode", ["same", "up2", "down2"])
def test_banded_fir_cpu_is_plain(mode):
    """On a CPU tensor the kernel wrapper runs the plain version and
    launches nothing."""
    from python_5gtoolbox_tpu_torch import kernels
    x = torch.randn(3, 512, generator=torch.Generator().manual_seed(1))
    before = dict(kernels.LAUNCHES)
    got = tf.banded_fir(x, jf.halfband_coeff(), mode)
    assert torch.equal(got, tf.banded_fir_plain(x, jf.halfband_coeff(),
                                                mode))
    assert kernels.LAUNCHES == before
