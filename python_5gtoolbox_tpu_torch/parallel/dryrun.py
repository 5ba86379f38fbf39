"""Entry points: the flagship step, and a dry run over several ranks.

Counterpart of the repository's __graft_entry__.py for the port.

entry() returns the flagship forward step (OFDM + the 245.76 Msps channel
filter over a batch of slots, scs 30 / BW 100: fir_up2_fused) and its
arguments.

dryrun_multichip(n) runs every step of the JAX dry run over n ranks of a
(dp, sp) mesh, sharding over both axes together, and holds each result,
gathered, against the same computation on one rank:

  * the time-sharded TX channel filter (parallel/timeshard.py) over the
    OFDM of a slot-sharded grid;
  * codeword-sharded LDPC (Zc 8, BG2: ldpc_minsum_packed on the card) and
    polar CA-SCL decodes;
  * RE-sharded MMSE-IRC + max-log demod;
  * tp_ml2 over every rank (parallel/tp.py);
  * the slot-sharded batched RX core (slot_sharded_rx), bit for bit;
  * a small LDPC BLER sweep split by SNR point (mesh.sweep_split).

Called in each rank of an initialized group of n ranks it runs there;
called on a single process it spawns n gloo ranks on localhost and runs
in each.
"""
from __future__ import annotations

import socket

import numpy as np
import torch
import torch.distributed as dist

from python_5gtoolbox_tpu_torch import resolve_device
from python_5gtoolbox_tpu_torch.parallel import mesh as pmesh
from python_5gtoolbox_tpu_torch.parallel import timeshard
from python_5gtoolbox_tpu_torch.parallel.tp import tp_ml2
from python_5gtoolbox_tpu_torch.utils import numerology as num

RATE_HZ = 245.76e6
FC_HZ = int(3500e6)


def _step_fn(scs: int, bw: int, fc_hz: int, out_rate: float, device):
    from python_5gtoolbox_tpu_torch.ops import filters, ofdm

    def step(fd_slots):
        fd = torch.as_tensor(fd_slots, device=device)
        td = ofdm.tx_low_phy(fd, scs, bw, fc_hz)
        nant = td.shape[1]
        flat = td.transpose(0, 1).reshape(nant, -1)
        return filters.tx_channel_filter(flat, scs, bw, out_rate)

    return step


def entry(device=None):
    """(step, (fd,)): step(fd) is OFDM + the channel filter to 245.76 Msps
    at scs 30 / BW 100 on device (None: the card); fd (2 slots, 1 antenna,
    14, n_sc) complex64 from seed 0."""
    scs, bw = 30, 100
    prb = num.carrier_prb_size(scs, bw)
    rng = np.random.default_rng(0)
    fd = (rng.normal(size=(2, 1, 14, 12 * prb))
          + 1j * rng.normal(size=(2, 1, 14, 12 * prb))).astype(np.complex64)
    return _step_fn(scs, bw, FC_HZ, RATE_HZ, resolve_device(device)), (fd,)


def slot_sharded_rx(obj, rx_slots, slot_list, ceq_config, ldpc_config,
                    ce_config, mesh=None, axis="dp"):
    """The slot-batched RX (obj.rx_process_batch) with its slot axis over
    the ranks of mesh[axis]: each rank decodes its contiguous block of
    rx_slots (S, Nr, 14*n_sc) and slot_list, and the (ok (S,), tbblk (S,
    A)) of every slot are gathered, as tensors on obj's device, on every
    rank."""
    rx = torch.as_tensor(rx_slots, device=obj.device)
    local = pmesh.shard_batch(mesh, rx, axis)
    slots = pmesh.shard_batch(
        mesh, torch.as_tensor(list(slot_list)), axis).tolist()
    ok, tbblk = obj.rx_process_batch(local, slots, ceq_config, ldpc_config,
                                     ce_config, fetch=False)[:2]
    return pmesh.gather(mesh, ok, axis), pmesh.gather(mesh, tbblk, axis)


def _equal(name: str, got, ref) -> None:
    got, ref = torch.as_tensor(got).cpu(), torch.as_tensor(ref).cpu()
    if got.shape != ref.shape or not torch.equal(got, ref):
        raise AssertionError(f"dryrun {name}: sharded != single rank")


def _close(name: str, got, ref, atol: float) -> float:
    err = (got.cpu() - ref.cpu()).abs().max().item()
    if got.shape != ref.shape or not err <= atol:
        raise AssertionError(f"dryrun {name}: error {err} above {atol}")
    return err


def _rx_pdsch(device):
    """The JAX dry run's PDSCH: scs 30 / BW 5, 1 layer 256QAM MCS 2 on 8
    RBs, 2 RX antennas."""
    from python_5gtoolbox_tpu_torch.phy.pdsch import Pdsch
    from python_5gtoolbox_tpu_torch.utils.config import (get_default_config,
                                                         merged)
    carrier = merged(get_default_config("dl_carrier"),
                     dict(BW=5, scs=30, num_of_ant=1, Nr=2,
                          maxMIMO_layers=1, PCI=1,
                          carrier_frequency_in_mhz=3840.0))
    cfg = merged(get_default_config("pdsch"),
                 dict(mcs_index=2, mcs_table="256QAM", num_of_layers=1,
                      rv=[0], data_source=[], StartSymbolIndex=2,
                      NrOfSymbols=12))
    cfg["ResAlloType1"].update(RBStart=0, RBSize=8)
    cfg["DMRS"].update(nNIDnSCID=1, NumCDMGroupsWithoutData=1,
                       DMRSAddPos=1)
    cfg["precoding_matrix"] = np.empty(0)
    return Pdsch(cfg, carrier, device=device), carrier


def _sweep_fails(snr_db: float, device) -> int:
    """tests/dist_worker.py's sweep point: 24 codewords of Zc 36 / BG2
    through 8 min-sum iterations at snr_db, seeded by the SNR itself."""
    from python_5gtoolbox_tpu_torch.ops.ldpc import ldpc_decode, ldpc_encode

    zc, bgn, n_iter, n_cw = 36, 2, 8, 24
    k, n = 10 * zc, 50 * zc
    r = np.random.default_rng(90001 + int(round(snr_db * 10)))
    bits = r.integers(2, size=(n_cw, k)).astype(np.int8)
    cw = ldpc_encode(torch.as_tensor(bits, device=device), bgn).cpu().numpy()
    tx = 1.0 - 2.0 * cw[:, :n].astype(np.float32)
    sigma = 10 ** (-snr_db / 20)
    noisy = tx + sigma * r.normal(size=tx.shape).astype(np.float32)
    llr = torch.as_tensor(2.0 * noisy / sigma ** 2, device=device)
    dec, _, _ = ldpc_decode(llr, zc, bgn, n_iter, "min-sum", 0.8, 0.3)
    return int(np.sum(np.any(dec.cpu().numpy()[:, :k] != bits, axis=1)))


SWEEP_SNRS = (-2.0, -1.0, 0.0, 1.0)


def _dryrun_steps(n: int, device) -> dict:
    from python_5gtoolbox_tpu_torch.ops import filters, ofdm
    from python_5gtoolbox_tpu_torch.ops.ldpc import ldpc_decode
    from python_5gtoolbox_tpu_torch.ops.polar import polar_decode_scl
    from python_5gtoolbox_tpu_torch.rx import demod as rx_demod
    from python_5gtoolbox_tpu_torch.rx import equalize as rx_eq

    if dist.get_world_size() != n:
        raise ValueError(f"dryrun_multichip({n}) in a group of "
                         f"{dist.get_world_size()} ranks")
    sp = 2 if n % 2 == 0 else 1
    mesh = pmesh.make_mesh_2d(n // sp, sp, ("dp", "sp"))
    axes = ("dp", "sp")
    out = {}
    rng = np.random.default_rng(0)

    # OFDM of a slot-sharded grid, then the time-sharded channel filter
    scs, bw = 30, 5
    prb = num.carrier_prb_size(scs, bw)
    n_slots = (n // sp) * 2
    fd = torch.as_tensor((rng.normal(size=(n_slots, 1, 14, 12 * prb))
                          + 1j * rng.normal(size=(n_slots, 1, 14, 12 * prb))
                          ).astype(np.complex64), device=device)

    def flat(td):
        return td.transpose(0, 1).reshape(td.shape[1], -1)

    td = flat(ofdm.tx_low_phy(pmesh.shard_batch(mesh, fd, axes), scs, bw,
                              FC_HZ))
    y = pmesh.gather(mesh, timeshard.sharded_tx_channel_filter(
        td, scs, bw, mesh, axes), axes, dim=-1)
    over = filters._oversample(scs, bw, RATE_HZ)
    if y.shape[-1] != n_slots * ofdm.slot_sample_count(scs, bw) * over:
        raise AssertionError(f"dryrun tx filter shape {tuple(y.shape)}")
    ref = filters.tx_channel_filter(flat(ofdm.tx_low_phy(fd, scs, bw, FC_HZ)),
                                    scs, bw, RATE_HZ)
    out["tx_filter_max_abs_err"] = _close("tx filter", y, ref, 2e-5)

    # codeword-parallel LDPC (Zc 8: the packed layout on the card)
    zc, bgn = 8, 2
    llr = torch.as_tensor(rng.normal(size=(n * 2, 50 * zc)).astype(
        np.float32), device=device)
    bits, ok, _ = ldpc_decode(pmesh.shard_batch(mesh, llr, axes), zc, bgn, 4,
                              "min-sum")
    ref = ldpc_decode(llr, zc, bgn, 4, "min-sum")
    _equal("ldpc bits", pmesh.gather(mesh, bits, axes), ref[0])
    _equal("ldpc ok", pmesh.gather(mesh, ok, axes), ref[1])

    # codeword-parallel polar CA-SCL decode (PDCCH / UCI sized)
    k_p, e_p, n_p = 43, 100, 128
    pl = torch.as_tensor(rng.normal(size=(n * 2, n_p)).astype(np.float32)
                         * 2, device=device)
    ck, okp = polar_decode_scl(pmesh.shard_batch(mesh, pl, axes), e_p, k_p,
                               4, 10, 0, 11, 0, 0)
    ref = polar_decode_scl(pl, e_p, k_p, 4, 10, 0, 11, 0, 0)
    _equal("polar ck", pmesh.gather(mesh, ck, axes), ref[0])
    _equal("polar ok", pmesh.gather(mesh, okp, axes), ref[1])

    # RE-sharded MMSE-IRC + max-log demod, 2x2
    n_re = n * 8
    yv = torch.as_tensor((rng.normal(size=(n_re, 2))
                          + 1j * rng.normal(size=(n_re, 2))
                          ).astype(np.complex64), device=device)
    h = torch.as_tensor((rng.normal(size=(n_re, 2, 2))
                         + 1j * rng.normal(size=(n_re, 2, 2))
                         ).astype(np.complex64), device=device)
    cov = (0.1 * torch.eye(2, dtype=torch.complex64, device=device)
           ).expand(n_re, 2, 2)

    def rx_stage(yy, hh, cc):
        s, nv = rx_eq.mmse(yy, hh, cc, irc=True)
        return rx_demod.demodulate(s.reshape(-1), "16QAM", nv.reshape(-1))[1]

    llrs = pmesh.gather(mesh, rx_stage(
        *(pmesh.shard_batch(mesh, t, axes) for t in (yv, h, cov))), axes)
    _equal("mmse-irc demod", llrs, rx_stage(yv, h, cov))

    # the ML candidate axis over every rank
    tp_mesh = pmesh.make_mesh(axis="tp")
    got = tp_ml2(yv, h, cov, "16QAM", tp_mesh, irc=True)
    if got[0].shape != (n_re, 2) or got[3].shape != (n_re, 8):
        raise AssertionError("dryrun tp_ml2 shapes")
    ref = rx_eq.ml2_plain(yv, h, cov, "16QAM", irc=True)
    out["tp_ml2_llr_max_abs_err"] = _close("tp_ml2 llr", got[3], ref[3],
                                           1e-5)

    # the slot-sharded batched RX core
    pdsch, carrier = _rx_pdsch(device)
    s_rx = 2 * n
    n_sc = 12 * prb
    ce = dict(CE_algo="DFT_symmetric", L_symm_left_in_ns=1400,
              L_symm_right_in_ns=1200, eRB=4, enable_TO_comp=True,
              enable_FO_est=False, enable_FO_comp=False)
    ldpc = dict(L=4, algo="min-sum", alpha=0.8, beta=0.3)
    planes = rng.normal(size=(2, s_rx, 2, 14 * n_sc)).astype(np.float32)
    rx = torch.as_tensor(planes[0] + 1j * planes[1], device=device)
    slots = list(range(s_rx))
    err, tbblk = slot_sharded_rx(pdsch, rx, slots, {"algo": "MMSE-IRC"},
                                 ldpc, ce, mesh, axes)
    ref = pdsch.rx_process_batch(rx, slots, {"algo": "MMSE-IRC"}, ldpc, ce,
                                 fetch=False)
    _equal("batched rx ok", err, ref[0])
    _equal("batched rx tbblk", tbblk, ref[1])

    # sweep granularity: disjoint SNR points per rank, one all_gather
    fails = pmesh.sweep_split(SWEEP_SNRS,
                              lambda s: _sweep_fails(s, device), mesh, axes)
    _equal("sweep split", torch.as_tensor(fails),
           torch.as_tensor([_sweep_fails(s, device) for s in SWEEP_SNRS]))
    out["sweep_fails"] = fails
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawned(rank: int, n: int, port: int, device, results) -> None:
    pmesh.init_distributed(f"tcp://localhost:{port}", n, rank, "gloo")
    try:
        out = _dryrun_steps(n, resolve_device(device))
        if rank == 0:
            results.put(out)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Every dry-run step over n_devices ranks, each checked against one
    rank (raises on a mismatch) -> the checks' numbers. Inside a group
    of n_devices ranks it runs in place; on a single process it spawns
    n_devices gloo ranks on localhost, each on device (None: the card)."""
    if dist.is_initialized():
        return _dryrun_steps(n_devices, pmesh.rank_device(device))
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    mp.spawn(_spawned, args=(n_devices, _free_port(), device, results),
             nprocs=n_devices)
    return results.get()
