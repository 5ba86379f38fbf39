"""PyTorch port, the polar code chain: construction, encode, rate match
and recovery against the reference goldens (as tests/test_polar.py), the
UCI code-block segmentation, the per-row RNTI CRC and the CA-PC-SCL
decoder against the JAX package on the same inputs.

The decoder is held against the JAX package's scan implementation, which
compiles in O(1) in N and is tested bit-identical to its unrolled and
chunked ones (tests/test_polar.py:test_scl_impls_match_unrolled): ck and
ok must match bit for bit. Bits and tables match exactly; recovered LLRs
within 1e-6 of the goldens (rtol 1e-5), and exactly against the JAX
package up to two repetitions.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.golden import get_golden
from tests.test_polar import (CONSTRUCT_CASES, DEC_CASES, ENC_CASES,
                              RM_CASES)

from python_5gtoolbox_tpu.ops import crc as jcrc
from python_5gtoolbox_tpu.ops import polar as JP
from python_5gtoolbox_tpu.ops.polar.segment import \
    polar_cb_segment as j_segment

from python_5gtoolbox_tpu_torch.ops import crc as tcrc
from python_5gtoolbox_tpu_torch.ops import polar as TP
from python_5gtoolbox_tpu_torch.ops.polar.segment import \
    polar_cb_segment as t_segment


def _no_golden_gen():
    raise RuntimeError("golden file missing")


@pytest.mark.parametrize("i", range(len(CONSTRUCT_CASES)))
def test_construct(i):
    gold = get_golden("polar_construct", _no_golden_gen)
    k, e, nmax = CONSTRUCT_CASES[i]
    F, qpc, N, nPC, nPCwm = TP.construct(k, e, nmax)
    np.testing.assert_array_equal(F, gold[f"F_{i}"])
    np.testing.assert_array_equal(np.sort(qpc), np.sort(gold[f"qPC_{i}"]))
    np.testing.assert_array_equal(np.array([N, nPC, nPCwm]),
                                  gold[f"meta_{i}"])
    for got, ref in zip(TP.construct(k, e, nmax), JP.construct(k, e, nmax)):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("i", range(len(ENC_CASES)))
def test_polar_encode(i):
    gold = get_golden("polar_encode", _no_golden_gen)
    k, e, nmax, iil = ENC_CASES[i]
    got = TP.polar_encode_np(gold[f"in_{i}"], e, nmax, iil)
    np.testing.assert_array_equal(got, gold[f"out_{i}"])
    rows = np.stack([gold[f"in_{i}"], 1 - gold[f"in_{i}"]])
    batched = TP.polar_encode(torch.as_tensor(rows), e, nmax, iil).numpy()
    np.testing.assert_array_equal(batched[0], gold[f"out_{i}"])
    np.testing.assert_array_equal(batched[1],
                                  TP.polar_encode_np(rows[1], e, nmax, iil))


@pytest.mark.parametrize("i", range(len(RM_CASES)))
def test_polar_ratematch(i):
    gold = get_golden("polar_ratematch", _no_golden_gen)
    k, e, nmax, iil, ibil = RM_CASES[i]
    dn = gold[f"in_{i}"]
    got = TP.polar_ratematch(torch.as_tensor(dn[None]), k, e, ibil)[0]
    np.testing.assert_array_equal(got.numpy(), gold[f"out_{i}"])


@pytest.mark.parametrize("i", range(len(RM_CASES)))
def test_polar_raterecover(i):
    """reference_compat against the goldens; the JAX package's repaired
    chain (and a shortening limit) against the JAX package."""
    gold = get_golden("polar_ratematch", _no_golden_gen)
    k, e, nmax, iil, ibil = RM_CASES[i]
    N = gold[f"in_{i}"].size
    llr = gold[f"llr_{i}"][None]
    got = TP.polar_raterecover(torch.as_tensor(llr), k, N, ibil,
                               reference_compat=True)[0]
    np.testing.assert_allclose(got.numpy(), gold[f"rec_{i}"], rtol=1e-5,
                               atol=1e-6)
    for limit in (20.0, float(e)):
        got = TP.polar_raterecover(torch.as_tensor(llr), k, N, ibil, limit)
        ref = JP.polar_raterecover(jnp.asarray(llr), k, N, ibil, limit)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("A,E", [(12, 60), (19, 100), (20, 200),
                                 (359, 2000), (360, 1088), (361, 2200),
                                 (1013, 3000), (1706, 4000)])
def test_polar_cb_segment(A, E):
    """C = 1 with CRC6 / CRC11, C = 2 from A 360 at E 1088 and from A
    1013, the odd lengths with the front zero pad."""
    bits = np.random.default_rng(A).integers(0, 2, A).astype(np.int8)
    got, ref = t_segment(bits, E), j_segment(bits, E)
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1:] == ref[1:]


def test_crc_check_per_row_mask():
    """crc_check with one RNTI per message (a PDCCH candidate's mask), as
    an int tensor that broadcasts over the leading shape."""
    rng = np.random.default_rng(5)
    msgs = rng.integers(0, 2, (4, 3, 64)).astype(np.int8)
    rnti = rng.integers(0, 2 ** 16, (4, 1)).astype(np.int32)
    got = tcrc.crc_check(torch.as_tensor(msgs), "24C", torch.as_tensor(rnti))
    ref = jcrc.crc_check(jnp.asarray(msgs), "24C", jnp.asarray(rnti))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    enc = np.stack([jcrc.crc_encode_np(m, "24C", int(r))
                    for m, r in zip(msgs[:, 0, :40], rnti[:, 0])])
    ok = tcrc.crc_check(torch.as_tensor(enc), "24C",
                        torch.as_tensor(rnti[:, 0]))
    assert not ok.any()


def _decode_both(llr, E, K, L, nmax, iil, clen, pad, rnti):
    j_rnti = rnti if isinstance(rnti, int) else jnp.asarray(rnti)
    t_rnti = rnti if isinstance(rnti, int) else torch.as_tensor(rnti)
    a, oka = JP.polar_decode_scl(jnp.asarray(llr), E, K, L, nmax, iil, clen,
                                 pad, j_rnti, impl="scan")
    b, okb = TP.polar_decode_scl(torch.as_tensor(llr), E, K, L, nmax, iil,
                                 clen, pad, t_rnti)
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(okb.numpy(), np.asarray(oka))
    return b.numpy(), okb.numpy()


@pytest.mark.parametrize("K,E,nmax,iil,clen,pad,rnti,L", [
    (75, 128, 10, 0, 11, 0, 0, 8),    # UL CA-SCL
    (56, 150, 9, 1, 24, 0, 0, 8),     # DL BCH-style (distributed CRC)
    (64, 200, 9, 1, 24, 1, 4567, 4),  # DCI with RNTI mask
    (22, 80, 10, 0, 6, 0, 0, 8),      # PC bits (K in 18..25)
])
def test_scl_random_llrs_match_jax(K, E, nmax, iil, clen, pad, rnti, L):
    """The shapes of tests/test_polar.py:test_scl_impls_match_unrolled on
    random LLRs: most rows fail, so ties and dead paths decide."""
    N, _ = JP.gen_n_value(K, E, nmax)
    llr = (np.random.default_rng(K + E).normal(size=(6, N)) * 2
           ).astype(np.float32)
    _decode_both(llr, E, K, L, nmax, iil, clen, pad, rnti)


def _chain_tx(rng, A, E, nmax, iil, crc_len, pad_crc, rnti):
    poly = {6: "6", 11: "11", 24: "24C"}[crc_len]
    payload = rng.integers(0, 2, A).astype("i1")
    if pad_crc:
        ck = jcrc.crc_encode_np(np.concatenate([np.ones(24, "i1"), payload]),
                                poly, rnti)[24:]
    else:
        ck = jcrc.crc_encode_np(payload, poly)
    K = ck.size
    enc = TP.polar_encode_np(ck, E, nmax, iil)
    ibil = 1 if nmax == 10 else 0
    fe = TP.polar_ratematch(torch.as_tensor(enc[None]), K, E, ibil)[0]
    return ck, fe.numpy(), K, ibil


@pytest.mark.parametrize("i", range(len(DEC_CASES)))
def test_scl_roundtrips_match_jax(i):
    """The DEC_CASES of tests/test_polar.py: one noiseless (+-8) and four
    noisy (5 dB) codewords in one batch; every one decodes to what was
    sent, in both packages."""
    A, E, nmax, iil, crc_len, pad_crc, rnti, L = DEC_CASES[i]
    rng = np.random.default_rng(300 + i)
    llrs, cks = [], []
    for w in range(5):
        ck, fe, K, ibil = _chain_tx(rng, A, E, nmax, iil, crc_len, pad_crc,
                                    rnti)
        if w == 0:
            llr_e = 8.0 * (1 - 2.0 * fe)
        else:
            sigma = 10 ** (-5.0 / 20)
            rx = (1 - 2.0 * fe) + rng.normal(size=fe.size) * sigma
            llr_e = 2 * rx / sigma ** 2
        N, _ = TP.gen_n_value(K, E, nmax)
        llrs.append(TP.polar_raterecover(
            torch.as_tensor(llr_e[None], dtype=torch.float32), K, N,
            ibil)[0].numpy())
        cks.append(ck)
    ck_hat, ok = _decode_both(np.stack(llrs), E, K, L, nmax, iil, crc_len,
                              pad_crc, rnti)
    assert ok.all()
    np.testing.assert_array_equal(ck_hat, np.stack(cks))


def test_sc_decoder_matches_jax():
    """L = 1 plain SC: a noiseless codeword and random LLRs."""
    rng = np.random.default_rng(7)
    A, E, nmax, iil, crc_len = 32, 256, 10, 0, 11
    ck, fe, K, ibil = _chain_tx(rng, A, E, nmax, iil, crc_len, 0, 0)
    N, _ = TP.gen_n_value(K, E, nmax)
    clean = TP.polar_raterecover(torch.as_tensor(
        8.0 * (1 - 2.0 * fe[None]), dtype=torch.float32), K, N, ibil).numpy()
    llr = np.concatenate([clean, (rng.normal(size=(3, N)) * 3).astype(
        np.float32)])
    ck_hat, ok = _decode_both(llr, E, K, 1, nmax, iil, crc_len, 0, 0)
    assert ok[0]
    np.testing.assert_array_equal(ck_hat[0], ck)


def test_scl_per_row_rnti_matches_jax():
    """PDCCH blind decoding: K 64, E 432, L 8, one RNTI per row (a
    tensor); the rows whose RNTI is not the sender's still pass the
    forced distributed CRC, as in the JAX package."""
    K, E, nmax, iil, clen, L = 64, 432, 9, 1, 24, 8
    rng = np.random.default_rng(3)
    N, _ = TP.gen_n_value(K, E, nmax)
    rntis = rng.integers(0, 2 ** 16, 6).astype(np.int32)
    llrs = []
    for r in rntis:
        ck = jcrc.crc_encode_np(np.concatenate(
            [np.ones(24, "i1"), rng.integers(0, 2, K - 24).astype("i1")]),
            "24C", int(r))[24:]
        enc = TP.polar_encode_np(ck, E, nmax, iil)
        llrs.append((1 - 2.0 * enc) * 2 + rng.normal(size=N))
    rx_rnti = rntis.copy()
    rx_rnti[::3] ^= 5
    _decode_both(np.stack(llrs).astype(np.float32), E, K, L, nmax, iil,
                 clen, 1, rx_rnti)
    # without forcing, the final CRC check with the per-row mask decides
    b, okb = TP.polar_decode_scl(torch.as_tensor(np.stack(llrs), dtype=
                                                 torch.float32), E, K, L,
                                 nmax, iil, clen, 1,
                                 torch.as_tensor(rx_rnti), force_crc=False)
    a, oka = JP.polar_decode_scl(jnp.asarray(np.stack(llrs), jnp.float32),
                                 E, K, L, nmax, iil, clen, 1,
                                 jnp.asarray(rx_rnti), force_crc=False,
                                 impl="scan")
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(okb.numpy(), np.asarray(oka))
    assert not okb.numpy()[::3].any() and okb.numpy()[1::3].all()
