"""PyTorch port, LDPC chain: segmentation, encoding, rate matching and
recovery against the reference goldens and the JAX package, and the
plain flooded min-sum decoder bit for bit against the JAX decoder
(backend="jax") on the same noisy codewords. The other schedules, check
nodes and algorithms are in tests/test_torch_ldpc_variants.py.

Coded bits and decoded bits must match exactly; recovered LLRs within
1e-5 (float32 averaging of repeated bits, as the JAX test allows). The
JAX decodes come from recordings of the frozen JAX package
(tests/torch_oracles), checked against its sources, jax's version and
the inputs each test regenerates.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.golden import get_golden

from python_5gtoolbox_tpu.ops import ldpc as JL
from python_5gtoolbox_tpu.ops.ldpc.decode import ldpc_decode as jax_decode

from python_5gtoolbox_tpu_torch.ops import ldpc as TL
from python_5gtoolbox_tpu_torch.ops.ldpc.decode import ldpc_decode

from tests.torch_oracles import jax_tuple


def _no_golden_gen():
    raise RuntimeError("golden file missing")


# cases of tests/test_ldpc.py
SEG_CASES = [(100, 2), (3840, 2), (7000, 2), (8448, 1), (16000, 1),
             (20004, 1), (960, 2), (269280, 1)]
ENC_CASES = [(2, 1), (2, 2), (13, 1), (52, 2), (96, 1), (208, 2), (384, 1),
             (384, 2), (144, 2), (56, 1)]
RM_CASES = [
    # (zc, bgn, E, rv, Qm, nfiller)
    (24, 2, 1000, 0, 2, 10), (24, 2, 1500, 2, 4, 10), (64, 1, 3000, 1, 6, 30),
    (64, 1, 9000, 3, 8, 0), (13, 2, 2000, 0, 2, 5), (52, 1, 3456, 2, 2, 0),
]


@pytest.mark.parametrize("i", range(len(SEG_CASES)))
def test_cbs_info(i):
    b, bgn = SEG_CASES[i]
    gold = get_golden("ldpc_seg", _no_golden_gen)[f"info_{i}"]
    info = TL.get_cbs_info(b, bgn)
    got = np.array([info.C, info.cbz, info.L, info.F, info.K, info.Zc])
    np.testing.assert_array_equal(got, gold)


@pytest.mark.parametrize("i", range(6))
def test_cb_segment(i):
    _, bgn = SEG_CASES[i]
    gold = get_golden("ldpc_cbseg", _no_golden_gen)
    cbs, zc = TL.cb_segment_np(gold[f"in_{i}"], bgn)
    np.testing.assert_array_equal(cbs, gold[f"cbs_{i}"])
    assert zc == gold[f"zc_{i}"][0]


@pytest.mark.parametrize("i", range(len(ENC_CASES)))
def test_ldpc_encode(i):
    _, bgn = ENC_CASES[i]
    gold = get_golden("ldpc_encode", _no_golden_gen)
    np.testing.assert_array_equal(TL.ldpc_encode_np(gold[f"in_{i}"], bgn),
                                  gold[f"dn_{i}"])


@pytest.mark.parametrize("zc,bgn", [(352, 2), (384, 1), (16, 2)])
def test_ldpc_encode_batched_matches_jax(zc, bgn):
    rng = np.random.default_rng(zc)
    ck = rng.integers(0, 2, (3, (22 if bgn == 1 else 10) * zc)
                      ).astype(np.int8)
    np.testing.assert_array_equal(
        TL.ldpc_encode(torch.as_tensor(ck), bgn).numpy(),
        np.asarray(JL.ldpc_encode(jnp.asarray(ck), bgn)))


def _info_for(L, zc, bgn, nfiller):
    K = (22 if bgn == 1 else 10) * zc
    return L.CBInfo(C=1, cbz=K - nfiller - 24, L=24, F=nfiller, K=K, Zc=zc,
                    bgn=bgn)


@pytest.mark.parametrize("i", range(len(RM_CASES)))
def test_ratematch(i):
    zc, bgn, E, rv, qm, nfiller = RM_CASES[i]
    gold = get_golden("ldpc_ratematch", _no_golden_gen)
    dn = np.where(gold[f"dn_{i}"] == -1, 0, gold[f"dn_{i}"])
    fe = TL.ldpc_ratematch(torch.as_tensor(dn[None]),
                           _info_for(TL, zc, bgn, nfiller), E, rv,
                           qm).numpy()[0]
    np.testing.assert_array_equal(fe, gold[f"fe_{i}"])


@pytest.mark.parametrize("i", range(len(RM_CASES)))
def test_raterecover(i):
    zc, bgn, E, rv, qm, nfiller = RM_CASES[i]
    gold = get_golden("ldpc_ratematch", _no_golden_gen)
    llr = gold[f"llr_{i}"][None].astype(np.float32)
    rec = TL.ldpc_raterecover(torch.as_tensor(llr),
                              _info_for(TL, zc, bgn, nfiller), rv, qm)
    np.testing.assert_allclose(rec.numpy()[0], gold[f"rec_{i}"],
                               rtol=1e-5, atol=1e-5)
    jrec = JL.ldpc_raterecover(jnp.asarray(llr),
                               _info_for(JL, zc, bgn, nfiller), rv, qm)
    np.testing.assert_allclose(rec.numpy(), np.asarray(jrec), rtol=1e-6,
                               atol=1e-6)


def test_ratematch_lbrm_matches_jax():
    """Limited-buffer Ncb and an explicit max_llr, as the PDSCH RX uses."""
    info_t = TL.get_cbs_info(3256, 2)
    info_j = JL.get_cbs_info(3256, 2)
    assert dataclasses.astuple(info_t) == dataclasses.astuple(info_j)
    rng = np.random.default_rng(4)
    dn = rng.integers(0, 2, (2, info_t.N)).astype(np.int8)
    dn[:, info_t.Kd - 2 * info_t.Zc: info_t.K - 2 * info_t.Zc] = 0
    ncb, E, qm = 12000, 10560, 2
    fe = TL.ldpc_ratematch(torch.as_tensor(dn), info_t, E, 0, qm, Ncb=ncb)
    np.testing.assert_array_equal(
        fe.numpy(), np.asarray(JL.ldpc_ratematch(jnp.asarray(dn), info_j, E,
                                                 0, qm, Ncb=ncb)))
    llr = rng.normal(size=(2, E)).astype(np.float32)
    mx = 10.0 * np.abs(llr).max(axis=-1, keepdims=True)
    got = TL.ldpc_raterecover(torch.as_tensor(llr), info_t, 0, qm, Ncb=ncb,
                              max_llr=torch.as_tensor(mx))
    ref = JL.ldpc_raterecover(jnp.asarray(llr), info_j, 0, qm, Ncb=ncb,
                              max_llr=jnp.asarray(mx))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# Decoder: bit for bit with the JAX decoder
# ---------------------------------------------------------------------------

def _recorded(case, inputs, decode):
    return jax_tuple(case, ("python_5gtoolbox_tpu.ops.ldpc.decode",), inputs,
                     decode)


DEC_CASES = [
    # (zc, bgn, batch, snr_db, alpha, beta, n_iter); cases of one shape
    # share one JAX compilation
    (16, 2, 8, 3.0, 0.8, 0.3, 8),       # mixed min-sum
    (16, 2, 8, 2.0, 1.0, 0.0, 8),       # plain min-sum
    (16, 2, 8, 2.0, 0.75, 0.0, 8),      # NMS
    (352, 2, 4, -2.0, 0.8, 0.3, 10),    # the bench sweep's code
    (352, 2, 4, -6.0, 0.8, 0.3, 10),    # does not converge
]


@pytest.mark.parametrize("case", DEC_CASES, ids=lambda c: f"zc{c[0]}bg{c[1]}"
                         f"snr{c[3]}a{c[4]}b{c[5]}")
def test_decode_matches_jax(case):
    zc, bgn, batch, snr, alpha, beta, n_iter = case
    rng = np.random.default_rng(zc * bgn + batch)
    K = (22 if bgn == 1 else 10) * zc
    bits = rng.integers(0, 2, size=(batch, K)).astype(np.int8)
    dn = np.asarray(JL.ldpc_encode(jnp.asarray(bits), bgn))
    sigma2 = 10 ** (-snr / 10)
    llr = ((2 / sigma2) * (1 - 2.0 * dn + rng.normal(size=dn.shape)
                           * np.sqrt(sigma2))).astype(np.float32)
    b1, ok1, f1 = _recorded(
        "ldpc_flooded_zc{}_bg{}_b{}_snr{}_a{}_b{}_it{}".format(*case),
        (bits, llr, n_iter, alpha, beta),
        lambda: jax_decode(jnp.asarray(llr), zc, bgn, n_iter, "min-sum",
                           alpha, beta, backend="jax"))
    b2, ok2, f2 = ldpc_decode(torch.as_tensor(llr), zc, bgn, n_iter,
                              "min-sum", alpha, beta)
    np.testing.assert_array_equal(f2.numpy(), np.asarray(f1))
    np.testing.assert_array_equal(ok2.numpy(), np.asarray(ok1))
    np.testing.assert_array_equal(b2.numpy(), np.asarray(b1))
    if snr > -6.0:
        assert ok2.numpy().any()
        np.testing.assert_array_equal(b2.numpy()[ok2.numpy()],
                                      bits[ok2.numpy()])
    else:
        assert not ok2.numpy().any()


def test_decode_garbage_llrs_match_jax():
    rng = np.random.default_rng(7)
    zc, bgn = 10, 1
    llr = (2.0 * rng.normal(size=(8, 66 * zc))).astype(np.float32)
    llr[:, ::7] = 0.0          # zero LLRs exercise the sign(0) = 0 rule
    _, ok1, f1 = _recorded(
        "ldpc_flooded_garbage", (llr,),
        lambda: jax_decode(jnp.asarray(llr), zc, bgn, 4, "min-sum", 1.0,
                           0.0, backend="jax"))
    _, ok2, f2 = ldpc_decode(torch.as_tensor(llr), zc, bgn, 4, "min-sum",
                             1.0, 0.0)
    np.testing.assert_array_equal(f2.numpy(), np.asarray(f1))
    np.testing.assert_array_equal(ok2.numpy(), np.asarray(ok1))
