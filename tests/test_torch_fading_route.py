"""PyTorch port, the fading channel's two routes (models/channel.py): on
the CPU, and with pre-drawn taps, NrChannelModel.filter takes the plain
per-path loop, launches nothing and gives the output of the loop as it
stood before the kernel, bit for bit; the route counters
(fading_kernel_paths / fading_plain_paths) count on CUDA tensors only,
so a CPU sweep keeps its counters as they were. The
kernel's inputs are checked here too: fading_draws leaves the generator
where the plain path does, and the sum the kernel computes from those
draws and fading_constants (csrc/fading_channel.cu's formula, evaluated
in float64) is the plain loop's within 1e-5 of its peak. The kernel
itself runs on the card only (tests/test_torch_cuda.py).
"""
import numpy as np
import pytest
import torch

from python_5gtoolbox_tpu_torch import kernels
from python_5gtoolbox_tpu_torch.models import channel as tchan
from python_5gtoolbox_tpu_torch.utils.profiling import StageProfiler

FS, FC, SCS, N = 30.72e6, 3.5e9, 30, 3000

# (model_format, Nt, Nr, extra config): TDL-A's 23 Rayleigh paths on a
# correlated 2x4, TDL-D's Rician first path, the ML cell's one tap, and a
# timing and frequency error
CASES = {
    "tdla_2x4": ("TDL-A", 2, 4, dict(
        DSdesired=300, Rspat_config=("medium", "uniform", "DL", (0, 0)))),
    "tdld_1x2": ("TDL-D", 1, 2, dict(DSdesired=300)),
    "one_tap_2x4": ("customized", 2, 4, dict(
        multi_paths=[[0, 0, "Rayleigh", 0, 0]])),
    "timeoff_rho": ("TDL-A", 1, 2, dict(DSdesired=30, Timeoff_ns=120,
                                        rho=2e-6)),
}


def _config(case):
    fmt, nt, nr, kw = CASES[case]
    kw = dict(kw)
    kw.setdefault("Rspat_config", ("low", "uniform", "UL", (0, 0)))
    return tchan.gen_channel_model_config(model_format=fmt, Nt=nt, Nr=nr,
                                          fm_inHz=200, **kw)


def _tx(nt, n=N, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.complex(torch.randn(nt, n, generator=g),
                         torch.randn(nt, n, generator=g))


def _filter_as_before(m, tx, taps=None):
    """NrChannelModel.filter as the loop stood before the kernel."""
    n = tx.shape[1]
    ferr = m.fi * m.rho
    if ferr:
        ang = 2 * np.pi * ferr * torch.arange(n) / m.fs
        tx = tx * torch.polar(torch.ones_like(ang), ang)
    tx = tchan._delay(tx, m.n_integer_ta)
    acc = torch.zeros((m.nr, n), dtype=torch.complex64)
    for i, path in enumerate(m.multi_paths):
        if taps is None:
            h = tchan.gen_mimo_channel(m.gen, m.nt, m.nr, m.rspat, n, m.fs,
                                       path[2], path[3], path[4], m.fm,
                                       m.n_sin)
        else:
            h = taps[i]
        tap = torch.einsum("nrt,tn->rn", h, tx) * 10 ** (path[1] / 20)
        acc = acc + tchan._delay(tap, int(np.round(path[0] * 1e-9 * m.fs)))
    sigma = 10 ** (m.pnoise_db / 20) / np.sqrt(2)
    noise = torch.complex(torch.randn(acc.shape, generator=m.gen),
                          torch.randn(acc.shape, generator=m.gen))
    return acc + sigma * noise


def _model(cfg, seed=5, pnoise_db=-20.0):
    return tchan.NrChannelModel(cfg, pnoise_db, FC, FS, SCS, seed=seed,
                                device="cpu")


@pytest.mark.parametrize("pinned", [False, True], ids=["own", "taps"])
@pytest.mark.parametrize("method", ["filter", "filter_plain"])
@pytest.mark.parametrize("case", list(CASES))
def test_cpu_filter_takes_the_plain_loop(case, method, pinned):
    cfg = _config(case)
    tx = _tx(cfg["Nt"])
    taps = None
    if pinned:
        g = torch.Generator().manual_seed(9)
        taps = [tchan.gen_mimo_channel(g, cfg["Nt"], cfg["Nr"], cfg["Rspat"],
                                       N, FS, p[2], p[3], p[4], 200, 30)
                for p in cfg["multi_paths"]]
    ref = _filter_as_before(_model(cfg), tx, taps)
    before = dict(kernels.LAUNCHES)
    prof = StageProfiler("cpu")
    with prof.stage("channel"):
        got = getattr(_model(cfg), method)(tx, taps=taps)
    assert torch.equal(got, ref)
    assert prof.counters == {}
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("case", list(CASES))
def test_fading_draws_leave_the_generator_where_the_plain_path_does(case):
    """The kernel path's uniforms are the plain path's, drawn in its order
    and shapes, and the next draw (the noise) is the same."""
    cfg = _config(case)
    a, b = _model(cfg), _model(cfg)
    links, ns = cfg["Nt"] * cfg["Nr"], cfg["num_of_sinusoids"]
    draws, draws0 = tchan.fading_draws(a.gen, a.multi_paths, links, ns)
    for p, path in enumerate(b.multi_paths):
        for j in range(3):
            assert torch.equal(draws[p, j],
                               torch.rand((links, ns, 1), generator=b.gen))
        if path[2] != "Rayleigh":
            assert torch.equal(draws0[p],
                               torch.rand((links, 1), generator=b.gen))
    assert torch.equal(a.gen.get_state(), b.gen.get_state())


def _kernel_formula(tx, draws, draws0, consts, nr, w, amp):
    """out[r, n] = sum_p g_p sum_t H_p[n - d_p, r, t] tx[t, n - d_p], as
    csrc/fading_channel.cu states it, in float64 from its inputs."""
    nt, n = tx.shape
    n_paths, _, links = draws.shape[:3]
    blob = consts.numpy().tobytes()
    L = np.frombuffer(blob[:8 * links ** 2], np.complex64).reshape(
        links, links).astype(np.complex128)
    rows = np.frombuffer(blob[8 * links ** 2:], tchan._PATH_ROW)
    assert len(rows) == n_paths
    m = np.arange(n, dtype=np.float64)
    ph = (draws.double().numpy()[..., 0] * 2 - 1) * np.pi
    ph0 = (draws0.double().numpy()[..., 0] * 2 - 1) * np.pi
    x = tx.numpy().astype(np.complex128)
    out = np.zeros((nr, n), np.complex128)
    for p, row in enumerate(rows):
        p1, p2, seta = ph[p]
        arg = w * m[None, None] * np.cos(seta)[..., None] + p1[..., None]
        vec = np.cos(arg).sum(1)
        arg = w * m[None, None] * np.sin(seta)[..., None] + p2[..., None]
        vec = amp * (vec + 1j * np.cos(arg).sum(1))
        if row["rician"]:
            vec = vec * row["nlos"] + row["los"] * np.exp(
                1j * (row["fdo"] * m[None] + ph0[p][:, None]))
        h = (L @ vec).reshape(nt, nr, n)
        tap = np.einsum("trn,tn->rn", h, x) * row["gain"]
        d = row["delay"]
        out[:, d:] += tap[:, :n - d]
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_formula_on_its_inputs_is_the_plain_loop(case):
    """The constants' layout and meaning: from fading_draws and
    fading_constants the kernel's formula gives the plain loop's faded
    sum (no noise, no TA, no CFO: the kernel's part of filter)."""
    cfg = dict(_config(case), Timeoff_ns=0, rho=0)
    a, b = _model(cfg, pnoise_db=255), _model(cfg, pnoise_db=255)
    tx = _tx(cfg["Nt"])
    ref = a.filter(tx).numpy()
    links = cfg["Nt"] * cfg["Nr"]
    draws, draws0 = tchan.fading_draws(b.gen, b.multi_paths, links, b.n_sin)
    consts = tchan.fading_constants(b.rspat, b.multi_paths, FS, "cpu")
    got = _kernel_formula(tx, draws, draws0, consts, b.nr,
                          2 * np.pi * b.fm / FS, np.sqrt(2 / b.n_sin))
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_constants_rows():
    cfg = _config("tdld_1x2")
    consts = tchan.fading_constants(cfg["Rspat"], cfg["multi_paths"], FS,
                                    "cpu")
    blob = consts.numpy().tobytes()
    L = np.frombuffer(blob[:32], np.complex64).reshape(2, 2)
    np.testing.assert_array_equal(L, np.linalg.cholesky(cfg["Rspat"]))
    rows = np.frombuffer(blob[32:], tchan._PATH_ROW)
    paths = cfg["multi_paths"]
    assert rows["delay"].tolist() == [int(np.round(p[0] * 1e-9 * FS))
                                      for p in paths]
    assert rows["rician"].tolist() == [1] + [0] * (len(paths) - 1)
    kv = 10 ** (paths[0][3] / 10)
    assert rows["los"][0] == np.float32(np.sqrt(kv / (kv + 1)))
    assert rows["nlos"][0] == np.float32(1) / np.float32(np.sqrt(kv + 1))
    assert rows["gain"].tolist() == [np.float32(10 ** (p[1] / 20))
                                     for p in paths]
    # a configuration's constants are uploaded once
    assert tchan.fading_constants(cfg["Rspat"], paths, FS, "cpu") is consts


def test_route_rule_and_wrapper_refuse_the_cpu():
    cfg = _config("one_tap_2x4")
    tx = _tx(2)
    assert not tchan.fading_on_kernel(tx, 8, 30)
    draws, draws0 = tchan.fading_draws(torch.Generator().manual_seed(0),
                                       cfg["multi_paths"], 8, 30)
    consts = tchan.fading_constants(cfg["Rspat"], cfg["multi_paths"], FS,
                                    "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tchan.fading_channel(tx, draws, draws0, consts, 4, 1e-5, 0.25)
