"""PyTorch port, the LDPC decoder family: the layered schedule, the fast
check node, the small-lifting layout, belief propagation and bit
flipping, each against the JAX package on the same numpy inputs.

Tolerance 0 (bits, ok flags and full codewords equal) for everything in
the min-sum family and for bit flipping: the layered schedule against
the JAX XLA decoder, the packed layout and the fast check node against
the Pallas kernels in interpret mode (the only JAX code that computes
them). The port's plain decoder is what both of its CUDA kernels are held
against on the card, so one plain version answers for both layouts. BP:
check-node messages within rtol 1e-5 / atol 1e-6 (tanh, log, exp and
atanh differ in the last bits between the two libraries); whole decodes
agree in ok, and in bits on the converged codewords.

One thing the Pallas kernels in interpret mode do not pin down: on the
CPU, XLA contracts the layered update ext + (alpha * sign) * mag into a
fused multiply-add inside the interpreted kernel, while the JAX XLA
decoder (_ldpc_decode_jit), the port's plain decoder and its CUDA kernels
(built without contraction) round the product first. The two agree
wherever the product is exact (alpha a power of two) and on codewords
that converge; on never-converging LLRs with alpha = 0.8 the interpreted
layered kernel differs from _ldpc_decode_jit itself in a few bits. So the
never-converging cases against the interpreted kernels use alpha = 0.5.

The JAX decodes (the interpreted Pallas kernels above all, a minute or
more of compiling each) come from recordings of the frozen JAX package
(tests/torch_oracles), checked against its sources, jax's version and
the inputs each test regenerates.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from python_5gtoolbox_tpu.ops.ldpc.decode import _check_node_bp as jax_bp_node
from python_5gtoolbox_tpu.ops.ldpc.decode import ldpc_decode as jax_decode
from python_5gtoolbox_tpu.ops.ldpc.decode import ldpc_decode_bf as jax_bf
from python_5gtoolbox_tpu.ops.ldpc.encode import ldpc_encode as jax_encode
from python_5gtoolbox_tpu.ops.ldpc.pallas_decode import ldpc_decode_pallas

from python_5gtoolbox_tpu_torch.ops import ldpc as TL
from python_5gtoolbox_tpu_torch.ops.ldpc import decode as tdec

from tests.torch_oracles import jax_tuple

N_ITER = 8
JAX_LDPC = ("python_5gtoolbox_tpu.ops.ldpc.decode",
            "python_5gtoolbox_tpu.ops.ldpc.pallas_decode")


def _recorded(case, inputs, decode):
    return jax_tuple(case, JAX_LDPC, inputs, decode)


def _noisy(zc, bgn, batch, snr_db, seed):
    rng = np.random.default_rng(seed)
    k = (22 if bgn == 1 else 10) * zc
    bits = rng.integers(0, 2, size=(batch, k)).astype(np.int8)
    dn = np.asarray(jax_encode(jnp.asarray(bits), bgn))
    s2 = 10 ** (-snr_db / 10)
    llr = (2 / s2) * (1 - 2.0 * dn + rng.normal(size=dn.shape) * np.sqrt(s2))
    return bits, llr.astype(np.float32)


def _garbage(zc, bgn, batch, seed):
    rng = np.random.default_rng(seed)
    ncols = 68 if bgn == 1 else 52
    llr = (2.0 * rng.normal(size=(batch, (ncols - 2) * zc))
           ).astype(np.float32)
    llr[:, ::7] = 0.0          # zero LLRs: sign(0) = 0 against sign(0) = +1
    return llr


def _assert_same(got, ref):
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


# (zc, bgn, alpha, beta) of tests/test_ldpc_pallas.py
CODES = [(16, 2, 0.8, 0.3), (10, 1, 1.0, 0.0), (52, 2, 0.75, 0.0)]


@pytest.mark.parametrize("zc,bgn,alpha,beta", CODES)
def test_layered_matches_jax(zc, bgn, alpha, beta):
    bits, llr = _noisy(zc, bgn, 12, 1.0, zc * bgn)
    ref = _recorded(
        f"ldpc_layered_{zc}_{bgn}_{alpha}_{beta}",
        (bits, llr, N_ITER, alpha, beta),
        lambda: jax_decode(jnp.asarray(llr), zc, bgn, N_ITER, "min-sum",
                           alpha, beta, backend="jax", schedule="layered"))
    got = TL.ldpc_decode(torch.as_tensor(llr), zc, bgn, N_ITER, "min-sum",
                         alpha, beta, schedule="layered")
    _assert_same(got, ref)
    ok = got[1].numpy()
    assert ok.any()
    np.testing.assert_array_equal(got[0].numpy()[ok], bits[ok])


def test_layered_nonconverging_matches_jax():
    llr = _garbage(16, 1, 9, 7)
    ref = _recorded(
        "ldpc_layered_nonconverging", (llr,),
        lambda: jax_decode(jnp.asarray(llr), 16, 1, 6, "min-sum", 1.0, 0.0,
                           backend="jax", schedule="layered"))
    got = TL.ldpc_decode(torch.as_tensor(llr), 16, 1, 6, "min-sum", 1.0, 0.0,
                         schedule="layered")
    _assert_same(got, ref)
    assert not got[1].numpy().all()


# BG1 in the layered schedule takes the interpreter a minute and a half:
# the layered packed kernel is held at BG2, the flooded one at both
@pytest.mark.parametrize("zc,bgn,alpha,beta,schedule", [
    CODES[0] + ("flooded",), CODES[0] + ("layered",),
    CODES[1] + ("flooded",)])
def test_plain_matches_packed_pallas_kernel(zc, bgn, alpha, beta, schedule):
    """The small-lifting TPU kernel in interpret mode, exact check node."""
    _, llr = _noisy(zc, bgn, 10, 1.0, zc + bgn)
    ref = _recorded(
        f"ldpc_pallas_packed_{zc}_{bgn}_{alpha}_{beta}_{schedule}",
        (llr, N_ITER, alpha, beta, schedule),
        lambda: ldpc_decode_pallas(jnp.asarray(llr), zc, bgn, N_ITER, alpha,
                                   beta, schedule=schedule, interpret=True,
                                   layout="packed"))
    got = TL.ldpc_decode(torch.as_tensor(llr), zc, bgn, N_ITER, "min-sum",
                         alpha, beta, schedule=schedule, layout="packed")
    _assert_same(got, ref)
    assert got[1].numpy().any()


@pytest.mark.parametrize("layout", ["batch", "packed"])
@pytest.mark.parametrize("schedule", ["flooded", "layered"])
@pytest.mark.parametrize("kind,alpha", [("noisy", 0.8), ("garbage", 0.5)])
def test_fast_matches_pallas_kernel(kind, alpha, schedule, layout):
    """semantics="fast" exists only in the TPU kernels; tolerance 0, on
    noisy codewords and on garbage with zero LLRs, where the fast and the
    exact check node differ (alpha = 0.5 there: see the module docstring)."""
    zc, bgn, beta = 16, 2, 0.3
    llr = (_noisy(zc, bgn, 12, 1.0, 3)[1] if kind == "noisy"
           else _garbage(zc, bgn, 12, 4))
    ref = _recorded(
        f"ldpc_pallas_fast_{kind}_{schedule}_{layout}",
        (llr, N_ITER, alpha, beta, schedule, layout),
        lambda: ldpc_decode_pallas(jnp.asarray(llr), zc, bgn, N_ITER, alpha,
                                   beta, schedule=schedule, interpret=True,
                                   layout=layout, semantics="fast"))
    got = TL.ldpc_decode(torch.as_tensor(llr), zc, bgn, N_ITER, "min-sum",
                         alpha, beta, schedule=schedule, semantics="fast",
                         layout=layout)
    _assert_same(got, ref)
    if kind == "noisy":
        assert got[1].numpy().any()
    else:
        exact = TL.ldpc_decode(torch.as_tensor(llr), zc, bgn, N_ITER,
                               "min-sum", alpha, beta, schedule=schedule)
        assert not torch.equal(got[2], exact[2])


def test_fast_check_node_rules():
    """sign(0) = +1 and every instance of the minimum excluded."""
    lq = torch.tensor([[[0.0], [-2.0], [2.0], [3.0]]])
    one, zero = torch.tensor(1.0), torch.tensor(0.0)
    fast = tdec._check_node_minsum_fast(lq, one, zero).flatten().tolist()
    exact = tdec._check_node_minsum(lq, one, zero).flatten().tolist()
    assert fast == [-2.0, 0.0, 0.0, 0.0]
    assert exact == [-2.0, 0.0, 0.0, 0.0]
    lq = torch.tensor([[[1.0], [-1.0], [4.0]]])
    fast = tdec._check_node_minsum_fast(lq, one, zero).flatten().tolist()
    exact = tdec._check_node_minsum(lq, one, zero).flatten().tolist()
    assert fast == [-4.0, 4.0, -1.0]
    assert exact == [-1.0, 1.0, -1.0]


def test_bp_check_node_matches_jax():
    rng = np.random.default_rng(0)
    x = (1.5 * rng.normal(size=(4, 7, 16))).astype(np.float32)
    x[:, 2, ::3] = 0.0         # one zero input: the raw tanh product
    x[1, 4, ::2] = 0.0         # two zero inputs in some checks
    got = tdec._check_node_bp(torch.as_tensor(x)).numpy()
    ref = np.asarray(jax_bp_node(jnp.asarray(x), 1.0, 0.0))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    # inputs that saturate tanh: the 2 * 19.07 clamp, exactly
    x = np.full((1, 5, 4), 60.0, np.float32)
    x[0, 1] = -60.0
    got = tdec._check_node_bp(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_bp_node(jnp.asarray(x), 1.0, 0.0)))
    assert np.abs(got).max() == np.float32(2 * 19.07)


def test_bp_decode_matches_jax():
    zc, bgn = 16, 2
    bits, llr = _noisy(zc, bgn, 12, 3.0, 5)
    b1, ok1, _ = _recorded(
        "ldpc_bp", (llr, N_ITER),
        lambda: jax_decode(jnp.asarray(llr), zc, bgn, N_ITER, "BP",
                           backend="jax"))
    b2, ok2, _ = TL.ldpc_decode(torch.as_tensor(llr), zc, bgn, N_ITER, "BP")
    ok = np.asarray(ok1)
    np.testing.assert_array_equal(ok2.numpy(), ok)
    assert ok.sum() >= 10
    np.testing.assert_array_equal(b2.numpy()[ok], np.asarray(b1)[ok])
    np.testing.assert_array_equal(b2.numpy()[ok], bits[ok])


@pytest.mark.parametrize("n_iter", [10, 20])
def test_bit_flipping_matches_jax(n_iter):
    zc, bgn = 16, 2
    rng = np.random.default_rng(n_iter)
    bits = rng.integers(0, 2, size=(24, 10 * zc)).astype(np.int8)
    dn = np.asarray(jax_encode(jnp.asarray(bits), bgn))
    full = np.concatenate([bits[:, :2 * zc], dn], axis=-1)
    sigma = 10 ** (-4.0 / 20)
    llr = ((1 - 2 * full) + rng.normal(0, sigma, full.shape)
           ).astype(np.float32)
    ref = _recorded(f"ldpc_bit_flipping_{n_iter}", (llr, n_iter),
                    lambda: jax_bf(jnp.asarray(llr), zc, bgn, n_iter))
    got = TL.ldpc_decode_bf(torch.as_tensor(llr), zc, bgn, n_iter)
    _assert_same(got, ref)
    assert got[0].dtype == torch.int8
    ok = got[1].numpy()
    assert ok.any()
    if n_iter == 10:            # some blocks need more than 10 flips
        assert not ok.all()


@pytest.mark.parametrize("kw", [
    dict(schedule="diagonal"), dict(algo="BP", semantics="fast"),
    dict(algo="BP", schedule="layered"), dict(semantics="quick"),
    dict(layout="lanes")], ids=lambda kw: "-".join(kw.values()))
def test_decode_argument_checks(kw):
    """The ValueErrors of the JAX ldpc_decode, and unknown option values."""
    llr = torch.zeros((1, 50 * 16))
    with pytest.raises(ValueError):
        TL.ldpc_decode(llr, 16, 2, 4, **kw)
    if "layout" not in kw and kw.get("semantics") != "quick":
        with pytest.raises(ValueError):
            jax_decode(jnp.zeros((1, 50 * 16)), 16, 2, 4, backend="jax",
                       **kw)


@pytest.mark.parametrize("name", ["ldpc_minsum", "ldpc_minsum_packed"])
def test_kernel_wrappers_need_a_cuda_tensor(name):
    with pytest.raises(ValueError, match="CUDA tensor"):
        getattr(TL, name)(torch.zeros((1, 50 * 16)), 16, 2, 4)


def test_packed_group_limit():
    """Every lifting below 128 fits one block's shared memory, as many
    codewords as (ncols + n_edges) * Zc floats allow; the largest do
    not."""
    assert tdec.packed_group_limit(12, 1) == 12
    assert tdec.packed_group_limit(80, 2) == 2
    assert tdec.packed_group_limit(120, 1) == 1
    assert tdec.packed_group_limit(112, 2) == 2
    assert tdec.packed_group_limit(2, 1) == 32
    assert tdec.packed_group_limit(384, 1) == 0
    assert tdec.packed_group_limit(352, 2) == 0
    for zc in TL.ZLIST:
        assert (tdec.packed_group_limit(zc, 1) >= 1) == (zc <= 144), zc
        assert (tdec.packed_group_limit(zc, 2) >= 1) == (zc <= 224), zc
