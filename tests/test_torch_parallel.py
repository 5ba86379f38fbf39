"""PyTorch port, parallelism on torch.distributed, on the CPU.

One module fixture starts 4 gloo ranks once (tests/torch_parallel_ranks.py)
and runs every case of the port's parallel/ modules in them; each test
then holds a result against its reference:

  * the time-sharded TX and RX channel filters against the JAX package's
    timeshard functions on the 8-device virtual mesh, at
    tests/test_timeshard.py's shapes, within 2e-5;
  * tp_ml2 against the JAX tp_ml2 for one case and the port's ml2 (held
    against the JAX package by test_torch_equalize_ml.py) for the
    others, within rtol/atol 1e-5 (tests/test_tp.py), and its refusal of
    an indivisible candidate count;
  * the slot-sharded batched RX at tests/test_multichip_rx.py's
    configuration and the sweep split, bit for bit against their
    single-rank runs;
  * the dry run's own checks, the halo error, and init_distributed on a
    single process.

The pipelined TX waveform runs here, in the test process, against the
JAX pipelined_tx_waveform / serial_tx_waveform (atol/rtol 2e-5,
tests/test_pipeline.py). The fixture computes the JAX references while
the ranks run.
"""
import os
import pathlib
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from python_5gtoolbox_tpu.parallel import pipeline as jpipe
from python_5gtoolbox_tpu.parallel import timeshard as jts
from python_5gtoolbox_tpu.parallel.tp import tp_ml2 as jtp_ml2

from python_5gtoolbox_tpu_torch.parallel import mesh as pmesh
from python_5gtoolbox_tpu_torch.parallel import pipeline as tpipe

from tests import torch_parallel_ranks as ranks

WORLD = 4
_RANKS = pathlib.Path(ranks.__file__)
TP_JAX_CASE = ranks.TP_CASES[1]                  # 16QAM, 2 layers, IRC


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _vmesh(axis):
    return Mesh(np.array(jax.devices()[:8]), (axis,))


def _jax_timeshard(case):
    name, scs, bw, seed, shape, rx = case
    x = jnp.asarray(ranks.timeshard_input(seed, shape))
    with _vmesh("sp") as mesh:
        return np.asarray(
            jts.sharded_rx_channel_filter(x, scs, bw, mesh=mesh) if rx
            else jts.sharded_tx_channel_filter(x, scs, bw, mesh=mesh))


def _jax_references() -> dict:
    """The JAX package's results that the ranks' are held against: the
    timeshard cases (compiled on three threads), one tp_ml2 case and
    the pipelined and serial TX waveforms."""
    with ThreadPoolExecutor(len(ranks.TIMESHARD_CASES)) as ex:
        ref = dict(zip((c[0] for c in ranks.TIMESHARD_CASES),
                       ex.map(_jax_timeshard, ranks.TIMESHARD_CASES)))
    modtype, nl, irc, soft, _ = TP_JAX_CASE
    y, h, cov = (jnp.asarray(a) for a in ranks.tp_problem(*TP_JAX_CASE))
    ref["tp"] = [np.asarray(r) for r in jax.jit(lambda a, b, c: jtp_ml2(
        a, b, c, modtype, _vmesh("tp"), irc=irc, soft=soft))(y, h, cov)]
    fd = _pipeline_grid()
    ref["pipelined"] = np.asarray(jpipe.pipelined_tx_waveform(
        fd, 30, 20, int(3500e6), 61.44e6, chunk_slots=2))
    ref["serial"] = np.asarray(jpipe.serial_tx_waveform(
        fd, 30, 20, int(3500e6), 61.44e6))
    return ref


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The ranks' results, with the JAX references (computed here while
    the ranks run) under "jax"."""
    out = tmp_path_factory.mktemp("ranks") / "results.pt"
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MASTER_", "WORLD_SIZE", "RANK"))}
    procs = [subprocess.Popen(
        [sys.executable, str(_RANKS), str(r), str(WORLD), port, str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(WORLD)]
    logs = []
    try:
        ref = _jax_references()
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-3000:]}"
    res = torch.load(out, weights_only=False)
    res["jax"] = ref
    return res


@pytest.mark.parametrize("case", ranks.TIMESHARD_CASES,
                         ids=lambda c: c[0])
def test_timeshard_matches_jax(results, case):
    ref = results["jax"][case[0]]
    got = results[f"timeshard_{case[0]}"].numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)


def test_halo_shorter_than_block_raises(results):
    assert "smaller than the filter halo" in results["halo_error"]


def test_tp_ml2_matches_jax(results):
    for r, g, name in zip(results["jax"]["tp"], results[("tp", TP_JAX_CASE)],
                          ["s_est", "nv", "hard", "llr"]):
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("case", ranks.TP_CASES,
                         ids=lambda c: "-".join(map(str, c[:4])))
def test_tp_ml2_matches_ml2(results, case):
    for r, g, name in zip(results[("ml2", case)], results[("tp", case)],
                          ["s_est", "nv", "hard", "llr"]):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_tp_ml2_rejects_indivisible(results):
    assert "not divisible" in results["tp_indivisible"]


def test_slot_sharded_rx_equals_unsharded(results):
    (ok_s, tb_s), (ok_u, tb_u) = results["rx_sharded"], \
        results["rx_unsharded"]
    assert ok_s.shape == (2 * WORLD,)
    np.testing.assert_array_equal(ok_s.numpy(), ok_u.numpy())
    np.testing.assert_array_equal(tb_s.numpy(), tb_u.numpy())


def test_sweep_split_equals_single_rank(results):
    assert results["sweep_split"] == results["sweep_single"]
    assert results["sweep_split"][0] > 0        # the sweep sees failures


def test_dryrun_multichip(results):
    d = results["dryrun"]
    assert d["tx_filter_max_abs_err"] <= 2e-5
    assert d["tp_ml2_llr_max_abs_err"] <= 1e-5
    assert d["sweep_fails"] == results["sweep_single"]


def test_init_distributed_single_process(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert pmesh.init_distributed() is False
    assert not torch.distributed.is_initialized()


def _pipeline_grid() -> np.ndarray:
    """tests/test_pipeline.py's grid: scs 30 / BW 20, 2 antennas, 6
    slots."""
    rng = np.random.default_rng(4)
    shape = (2, 6, 14, 12 * 51)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)
            ).astype(np.complex64)


def test_pipelined_matches_jax(results):
    fd = _pipeline_grid()
    got_pp = tpipe.pipelined_tx_waveform(fd, 30, 20, int(3500e6), 61.44e6,
                                         devices=["cpu"], chunk_slots=2)
    got_ser = tpipe.serial_tx_waveform(fd, 30, 20, int(3500e6), 61.44e6,
                                       device="cpu")
    ref_pp, ref_ser = results["jax"]["pipelined"], results["jax"]["serial"]
    for got in (got_pp, got_ser):
        assert got.shape == ref_pp.shape
        np.testing.assert_allclose(got.numpy(), ref_pp, atol=2e-5,
                                   rtol=2e-5)
    np.testing.assert_allclose(got_ser.numpy(), ref_ser, atol=2e-5,
                               rtol=2e-5)
