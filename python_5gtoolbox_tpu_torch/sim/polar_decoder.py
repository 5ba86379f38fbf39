"""Polar decoder BLER study: SC against CA-PC-SCL with several list sizes.

Port of scripts/internal/sim_polar_internal.py with the constants of
scripts/sim_polar_decoder.py (K 64 info + CRC bits, E 128, nMax 10, iIL
0, CRC11; SC and SCL at L 8 and 32; SNR 0.5..3.5 dB; 400 trials per
point): K - CRC random bits -> CRC -> polar encode -> BPSK -> AWGN ->
LLR 2x/sigma^2 on the N mother-code positions (the reference sims feed
N-length LLRs straight from the encoder) -> one batched SCL decode per
point on the device. The bits and the noise come from a numpy Generator
seeded per decoder setting, drawn in the JAX script's order, so a seed
gives the same trials on the card, on the host and in the JAX package.
The figure is not drawn.

    python -m python_5gtoolbox_tpu_torch.sim.polar_decoder [--device cpu]
        [--n-trials 400] [--out-dir DIR]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import pickle
import time

import numpy as np
import torch

from python_5gtoolbox_tpu_torch import resolve_device
from python_5gtoolbox_tpu_torch.ops import crc as crc_ops
from python_5gtoolbox_tpu_torch.ops import polar as polar_ops

# scripts/sim_polar_decoder.py
K, E, N_MAX, I_IL, CRC_LEN = 64, 128, 10, 0, 11
ALGO_LIST = ["SC", "SCL"]
L_LIST = [8, 32]
SNR_DB_LIST = np.arange(0.5, 4.0, 0.5).tolist()
N_TRIALS = 400


def gen_polar_llr_batch(rng: np.random.Generator, K: int, E: int,
                        n_max: int, i_il: int, snr_db: float, n_trials: int,
                        crc_len: int = 24, pad_crc: int = 0, rnti: int = 0):
    """-> (blkandcrc (B, K) int8, llr (B, N) float32), numpy."""
    poly = {6: "6", 11: "11", 24: "24C"}[crc_len]
    inbits = rng.integers(2, size=(n_trials, K - crc_len)).astype(np.int8)
    if pad_crc == 0:
        blkandcrc = crc_ops.crc_encode(torch.as_tensor(inbits), poly)
    else:
        padded = np.concatenate(
            [np.ones((n_trials, 24), np.int8), inbits], axis=-1)
        blkandcrc = crc_ops.crc_encode(torch.as_tensor(padded), poly,
                                       rnti)[:, 24:]
    enc = polar_ops.polar_encode(blkandcrc, E, n_max, i_il).numpy()
    en = 1.0 - 2.0 * enc
    sigma = 10 ** (-snr_db / 20)
    fn = en + rng.normal(0, sigma, en.shape)
    return blkandcrc.numpy(), (2.0 * fn / sigma ** 2).astype(np.float32)


def decode_batch(llr: np.ndarray, blkandcrc: np.ndarray, E: int, K: int,
                 list_size: int, n_max: int, i_il: int, crc_len: int,
                 pad_crc: int = 0, rnti: int = 0, device=None) -> int:
    """SCL decode (B, N) mother-code LLRs on device (None -> cuda) ->
    the number of blocks whose bits differ from blkandcrc."""
    dev = resolve_device(device)
    ck, _ = polar_ops.polar_decode_scl(
        torch.as_tensor(llr, device=dev), E, K, list_size, n_max, i_il,
        crc_len=crc_len, pad_crc=pad_crc, rnti=rnti)
    ref = torch.as_tensor(blkandcrc, device=dev)
    return int((ck != ref).any(dim=-1).sum())


def run_polar_simulation(K, E, n_max, i_il, crc_len, algo_list, L_list,
                         snr_db_list, filename=None, n_trials: int = 400,
                         seed: int = 0, device=None, verbose: bool = True):
    """-> (sim_config, cfgs, results): results[c][p] is the BLER of
    decoder setting c ('SC', or 'SCL' once per L) at SNR point p. Each
    setting draws from a numpy Generator seeded with seed. filename: a
    pickle of the three, as the JAX script writes."""
    sim_config = dict(K=K, E=E, nMax=n_max, iIL=i_il, CRCLEN=crc_len,
                      snr_db_list=list(snr_db_list), n_trials=n_trials)
    cfgs = []
    for algo in algo_list:
        cfgs += [dict(algo="SC", L=1)] if algo == "SC" else \
            [dict(algo="SCL", L=L) for L in L_list]
    results = []
    for cfg in cfgs:
        rng = np.random.default_rng(seed)
        blers = []
        for snr in snr_db_list:
            blkandcrc, llr = gen_polar_llr_batch(
                rng, K, E, n_max, i_il, snr, n_trials, crc_len)
            nerr = decode_batch(llr, blkandcrc, E, K, cfg["L"], n_max, i_il,
                                crc_len, device=device)
            blers.append(nerr / n_trials)
            if verbose:
                print(f"{cfg['algo']} L={cfg['L']} snr={snr:+.1f}dB "
                      f"BLER={blers[-1]:.4f}", flush=True)
        results.append(blers)
    if filename:
        with open(filename, "wb") as f:
            pickle.dump([sim_config, cfgs, results], f)
    return sim_config, cfgs, results


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--n-trials", type=int, default=N_TRIALS)
    ap.add_argument("--out-dir", default=None,
                    help="write polar_decode_result_all.pickle here")
    args = ap.parse_args()
    filename = None
    if args.out_dir:
        pathlib.Path(args.out_dir).mkdir(parents=True, exist_ok=True)
        filename = str(pathlib.Path(args.out_dir)
                       / "polar_decode_result_all.pickle")
    t0 = time.perf_counter()
    _, cfgs, results = run_polar_simulation(
        K, E, N_MAX, I_IL, CRC_LEN, ALGO_LIST, L_LIST, SNR_DB_LIST,
        filename, n_trials=args.n_trials, device=args.device)
    print(json.dumps(dict(cfgs=cfgs, bler=results, snr_db=SNR_DB_LIST,
                          wall_s=time.perf_counter() - t0)))


if __name__ == "__main__":
    main()
