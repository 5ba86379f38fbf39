"""Rank process of tests/test_torch_parallel.py (torch and the port only).

    python tests/torch_parallel_ranks.py <rank> <world> <port> <out.pt> [cuda]

Each of the `world` processes joins one gloo group on localhost and runs
every case of the port's parallel/ modules on the CPU; rank 0 saves the
gathered results (and the single-rank runs the cases are held against)
to out.pt. The inputs come from the functions below, which the test
process uses for its JAX references. With `cuda` the ranks share cuda:0
and run the time-sharded filters there (tests/test_torch_cuda.py).
"""
import pathlib
import sys
import zlib

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# tests/test_timeshard.py's shapes: (name, scs, bw, seed, (planes, T), rx)
TIMESHARD_CASES = [("tx", 30, 20, 0, (2, 8 * 1024), False),
                   ("rx", 30, 20, 1, (2, 8 * 4096), True),
                   ("tx_bw100", 30, 100, 2, (1, 8 * 512), False)]
# tests/test_tp.py's cases: (modtype, nl, irc, soft, n)
TP_CASES = [(m, nl, irc, True, 64)
            for m, nl in (("16QAM", 2), ("QPSK", 2), ("64QAM", 1))
            for irc in (False, True)] + [("16QAM", 2, False, False, 48)]
SWEEP_SNRS = (-2.0, -1.0, 0.0, 1.0)


def timeshard_input(seed: int, shape) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)
            ).astype(np.complex64)


def tp_problem(modtype: str, nl: int, irc: bool, soft: bool, n: int,
               nr: int = 2):
    """tests/test_tp.py:_rand_problem, seeded by the case."""
    seed = zlib.crc32(f"{modtype}-{nl}-{irc}-{soft}".encode()) % 997
    rng = np.random.default_rng(seed)
    y = (rng.normal(size=(n, nr)) + 1j * rng.normal(size=(n, nr))
         ).astype(np.complex64)
    h = (rng.normal(size=(n, nr, nl)) + 1j * rng.normal(size=(n, nr, nl))
         ).astype(np.complex64)
    a = (rng.normal(size=(n, nr, nr)) + 1j * rng.normal(size=(n, nr, nr))
         ).astype(np.complex64)
    cov = 0.1 * np.eye(nr, dtype=np.complex64) \
        + 0.05 * (a @ a.conj().swapaxes(-1, -2))
    return y, h, cov


def multichip_rx(s: int):
    """tests/test_multichip_rx.py's configuration: (Pdsch on the CPU,
    rx (S, 2, 14*n_sc) complex64, ce, ldpc)."""
    from python_5gtoolbox_tpu_torch.phy.pdsch import Pdsch
    from python_5gtoolbox_tpu_torch.utils.config import (get_default_config,
                                                         merged)
    from python_5gtoolbox_tpu_torch.utils.numerology import carrier_prb_size

    carrier = merged(get_default_config("dl_carrier"),
                     dict(BW=10, scs=30, num_of_ant=2, Nr=2,
                          maxMIMO_layers=2, PCI=1,
                          carrier_frequency_in_mhz=3840.0))
    pdsch = merged(get_default_config("pdsch"),
                   dict(mcs_index=2, mcs_table="256QAM", num_of_layers=2,
                        rv=[0], data_source=[], StartSymbolIndex=2,
                        NrOfSymbols=12))
    pdsch["ResAlloType1"].update(RBStart=0, RBSize=12)
    pdsch["DMRS"].update(nNIDnSCID=1, NumCDMGroupsWithoutData=1,
                         DMRSAddPos=1)
    pdsch["precoding_matrix"] = np.empty(0)
    n_sc = 12 * carrier_prb_size(30, 10)
    planes = np.random.default_rng(21).normal(
        size=(2, s, 2, 14 * n_sc)).astype(np.float32)
    ce = dict(CE_algo="DFT_symmetric", L_symm_left_in_ns=1400,
              L_symm_right_in_ns=1200, eRB=4, enable_TO_comp=True,
              enable_FO_est=False, enable_FO_comp=False)
    ldpc = dict(L=8, algo="min-sum", alpha=0.8, beta=0.3)
    return (Pdsch(pdsch, carrier, device="cpu"),
            torch.as_tensor(planes[0] + 1j * planes[1]), ce, ldpc)


def run(rank: int, world: int, port: int, out: str) -> None:
    import torch.distributed as dist

    from python_5gtoolbox_tpu_torch.parallel import dryrun
    from python_5gtoolbox_tpu_torch.parallel import mesh as pmesh
    from python_5gtoolbox_tpu_torch.parallel import timeshard
    from python_5gtoolbox_tpu_torch.parallel.tp import tp_ml2
    from python_5gtoolbox_tpu_torch.rx import equalize

    torch.set_num_threads(1)
    assert pmesh.init_distributed(f"tcp://localhost:{port}", world, rank,
                                  "gloo")
    res = {}
    sp = pmesh.make_mesh(axis="sp")
    for name, scs, bw, seed, shape, rx in TIMESHARD_CASES:
        x = torch.as_tensor(timeshard_input(seed, shape))
        fn = (timeshard.sharded_rx_channel_filter if rx
              else timeshard.sharded_tx_channel_filter)
        y = fn(pmesh.shard_batch(sp, x, "sp", dim=-1), scs, bw, sp)
        res[f"timeshard_{name}"] = pmesh.gather(sp, y, "sp", dim=-1)
    try:                  # 2 samples a rank: shorter than the FIR's halo
        timeshard.sharded_tx_channel_filter(torch.zeros(1, 2), 30, 20, sp)
    except ValueError as e:
        res["halo_error"] = str(e)

    tp = pmesh.make_mesh(axis="tp")
    for case in TP_CASES:
        modtype, nl, irc, soft, n = case
        args = [torch.as_tensor(a) for a in tp_problem(*case)]
        res[("tp", case)] = tp_ml2(*args, modtype, tp, irc=irc, soft=soft)
        if rank == 0:
            res[("ml2", case)] = equalize.ml2(*args, modtype, irc=irc,
                                              soft=soft)
    try:                  # BPSK 1-layer: 2 candidates over 4 ranks
        tp_ml2(*[torch.as_tensor(a) for a in tp_problem("BPSK", 1, False,
                                                        True, 8)],
               "BPSK", tp)
    except ValueError as e:
        res["tp_indivisible"] = str(e)

    obj, rx, ce, ldpc = multichip_rx(2 * world)
    slots = list(range(2 * world))
    dp = pmesh.make_mesh(axis="dp")
    res["rx_sharded"] = dryrun.slot_sharded_rx(
        obj, rx, slots, {"algo": "MMSE-IRC"}, ldpc, ce, dp)
    if rank == 0:
        res["rx_unsharded"] = obj.rx_process_batch(
            rx, slots, {"algo": "MMSE-IRC"}, ldpc, ce, fetch=False)[:2]

    res["sweep_split"] = pmesh.sweep_split(
        SWEEP_SNRS, lambda s: dryrun._sweep_fails(s, "cpu"), dp)
    if rank == 0:
        res["sweep_single"] = [dryrun._sweep_fails(s, "cpu")
                               for s in SWEEP_SNRS]
    res["dryrun"] = dryrun.dryrun_multichip(world, device="cpu")
    if rank == 0:
        torch.save(res, out)
    dist.barrier()
    dist.destroy_process_group()


def run_card(rank: int, world: int, port: int, out: str) -> None:
    """The time-sharded TX and RX filters at scs 30 / BW 100 (2 antennas,
    2 slots at 122.88 Msps) on cuda:0, gathered, beside rank 0's
    unsharded filters on the card and the banded_fir launches of the
    sharded runs."""
    import torch.distributed as dist

    from python_5gtoolbox_tpu_torch import kernels
    from python_5gtoolbox_tpu_torch.ops import filters
    from python_5gtoolbox_tpu_torch.parallel import mesh as pmesh
    from python_5gtoolbox_tpu_torch.parallel import timeshard

    torch.backends.cuda.matmul.allow_tf32 = False
    assert pmesh.init_distributed(f"tcp://localhost:{port}", world, rank)
    assert dist.get_backend() == "gloo"        # ranks share the one card
    dev = pmesh.rank_device()
    sp = pmesh.make_mesh(axis="sp")
    x = torch.as_tensor(timeshard_input(5, (2, 2 * 61440)), device=dev)
    kernels.reset_launches()
    tx = timeshard.sharded_tx_channel_filter(
        pmesh.shard_batch(sp, x, "sp", dim=-1), 30, 100, sp)
    rx = timeshard.sharded_rx_channel_filter(tx, 30, 100, sp)
    torch.cuda.synchronize()
    res = dict(launches=dict(kernels.LAUNCHES),
               tx=pmesh.gather(sp, tx, "sp", dim=-1).cpu(),
               rx=pmesh.gather(sp, rx, "sp", dim=-1).cpu())
    if rank == 0:
        res["tx_ref"] = filters.tx_channel_filter(x, 30, 100).cpu()
        res["rx_ref"] = filters.rx_channel_filter(
            res["tx"].to(dev), 30, 100, 245.76e6).cpu()
        torch.save(res, out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    (run_card if sys.argv[5:] == ["cuda"] else run)(
        int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
