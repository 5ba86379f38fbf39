"""LDPC decoder BLER studies: algorithm comparison, iteration count,
bit flipping and the NMS / OMS / mixed min-sum hyper-parameter searches.

Port of scripts/internal/sim_ldpc_internal.py (gen_ldpc_llr_batch,
decode_batch, expand_test_configs, run_ldpc_simulation,
draw_ldpc_decoder_result; same names, same pickle layout) and of the
constants of scripts/sim_ldpc_decoder.py, scripts/sim_ldpc_decoder_bf.py,
scripts/NMS_ldpc_search_best_alpha.py, scripts/OMS_ldpc_search_best_beta.py
and scripts/mixed_MS_ldpc_search_best_pair.py. The stimulus is K-crc random
bits -> CRC -> LDPC encode -> BPSK -> AWGN -> LLR = 2x/sigma^2, drawn from
a numpy Generator; every SNR point is one batched decode of n_trials
codewords on the device (None -> the CUDA card). Every lifting of the
studies below 128 decodes through the small-lifting kernel there.

    python -m python_5gtoolbox_tpu_torch.sim.ldpc_decoder \
        [--study decoder|L|bf|nms|oms|mixed] [--device cpu] [--trials 400]
        [--out-dir out] [--schedule layered] [--semantics fast]
        [--layout batch]
"""
from __future__ import annotations

import argparse
import pathlib
import pickle

import numpy as np
import torch

from python_5gtoolbox_tpu_torch import resolve_device
from python_5gtoolbox_tpu_torch.ops import crc as crc_ops
from python_5gtoolbox_tpu_torch.ops import ldpc as ldpc_ops

# scripts/sim_ldpc_decoder.py, test 1 (algorithm comparison) and test 2
# (iteration count)
SNR_DB_LIST = np.arange(-1, 1.5, 0.5).tolist()
DECODER_STUDY = dict(zc=12, bgn=1, crcpoly="24A",
                     algo_list=["BP", "min-sum", "NMS", "OMS", "mixed-MS"],
                     alpha_list=[0.7], beta_list=[0.5],
                     mixed_list=[[0.8, 0.3], [0.7, 0.3]], L_list=[16],
                     snr_db_list=SNR_DB_LIST)
L_STUDY = dict(zc=10, bgn=1, crcpoly="24A", algo_list=["mixed-MS"],
               alpha_list=[], beta_list=[], mixed_list=[[0.8, 0.3]],
               L_list=[16, 32, 64], snr_db_list=SNR_DB_LIST)
# scripts/sim_ldpc_decoder_bf.py
BF_STUDY = dict(zc=16, bgn=2, L_list=[10, 20],
                snr_db_list=np.arange(4.0, 9.0, 1.0).tolist())
# the three hyper-search scripts: L 16 at -0.5 dB; `swept` is the member
# of the (alpha, beta) pair that the script's pickle lists (None: both)
SEARCHES = {
    "nms": dict(stem="NMS_search_alpha", swept=0, zc_list=[12, 48, 112, 208],
                pairs=[(a, 0.0) for a in
                       np.arange(0.5, 1.0, 0.05).round(2).tolist()]),
    "oms": dict(stem="OMS_search_beta", swept=1, zc_list=[12, 48, 112, 208],
                pairs=[(1.0, b) for b in
                       np.arange(0.1, 0.8, 0.1).round(2).tolist()]),
    "mixed": dict(stem="mixed_MS_search_pair", swept=None, zc_list=[12, 112],
                  pairs=[(a, b) for a in [0.6, 0.7, 0.8, 0.9]
                         for b in [0.1, 0.2, 0.3, 0.4]]),
}
SEARCH_L, SEARCH_SNR_DB = 16, -0.5


def coded_blocks(rng: np.random.Generator, zc: int, bgn: int,
                 n_trials: int, crcpoly: str, device):
    """Random blocks with CRC and their codewords, as numpy int8."""
    dev = resolve_device(device)
    k = zc * (22 if bgn == 1 else 10)
    inbits = rng.integers(2, size=(n_trials, k - crc_ops.crc_len(crcpoly))
                          ).astype(np.int8)
    blkandcrc = crc_ops.crc_encode(torch.as_tensor(inbits, device=dev),
                                   crcpoly)
    dn = ldpc_ops.ldpc_encode(blkandcrc, bgn)
    return blkandcrc.cpu().numpy(), dn.cpu().numpy()


def gen_ldpc_llr_batch(rng: np.random.Generator, zc: int, bgn: int,
                       snr_db: float, n_trials: int, crcpoly: str = "24A",
                       device=None):
    """Batched stimulus -> (blkandcrc (B, K), llr (B, N)), numpy."""
    blkandcrc, dn = coded_blocks(rng, zc, bgn, n_trials, crcpoly, device)
    en = 1.0 - 2.0 * dn
    sigma = 10 ** (-snr_db / 20)
    fn = en + rng.normal(0, sigma, dn.shape)
    return blkandcrc, (2.0 * fn / sigma ** 2).astype(np.float32)


def decode_batch(llr: np.ndarray, blkandcrc: np.ndarray, zc: int, bgn: int,
                 L: int, algo: str, alpha: float, beta: float,
                 schedule: str = "flooded", semantics: str = "exact",
                 layout: str = "auto", device=None) -> int:
    """-> number of block errors in the batch."""
    dev = resolve_device(device)
    bits, _, _ = ldpc_ops.ldpc_decode(
        torch.as_tensor(llr, device=dev), zc, bgn, L, algo=algo, alpha=alpha,
        beta=beta, schedule=schedule, semantics=semantics, layout=layout)
    err = np.any(bits.cpu().numpy() != blkandcrc, axis=-1)
    return int(np.sum(err))


def expand_test_configs(algo_list, alpha_list, beta_list, mixed_list,
                        L_list):
    """(algo, alpha, beta, L) grid, reference semantics: NMS sweeps alpha
    with beta=0, OMS sweeps beta with alpha=1, mixed sweeps pairs."""
    cfgs = []
    for L in L_list:
        for algo in algo_list:
            if algo in ("BP", "min-sum"):
                cfgs.append(dict(algo=algo, alpha=1.0, beta=0.0, L=L))
            elif algo == "NMS":
                cfgs += [dict(algo="min-sum", name="NMS", alpha=a, beta=0.0,
                              L=L) for a in alpha_list]
            elif algo == "OMS":
                cfgs += [dict(algo="min-sum", name="OMS", alpha=1.0, beta=b,
                              L=L) for b in beta_list]
            elif algo == "mixed-MS":
                cfgs += [dict(algo="min-sum", name="mixed-MS", alpha=a,
                              beta=b, L=L) for a, b in mixed_list]
            else:
                raise ValueError(algo)
    for c in cfgs:
        c.setdefault("name", c["algo"])
    return cfgs


def _dump(filename, payload) -> None:
    if filename:
        pathlib.Path(filename).parent.mkdir(parents=True, exist_ok=True)
        with open(filename, "wb") as f:
            pickle.dump(payload, f)


def run_ldpc_simulation(zc, bgn, crcpoly, algo_list, alpha_list, beta_list,
                        mixed_list, L_list, snr_db_list, filename,
                        n_trials: int = 400, seed: int = 0, device=None,
                        **decode_kw):
    """Sweep the decoder grid over SNR; pickle
    [sim_config, test_config_list, test_results_list] like the reference.
    decode_kw (schedule, semantics, layout) goes to decode_batch for the
    min-sum family settings; BP takes none of them."""
    sim_config = dict(Zc=zc, bgn=bgn, crcpoly=crcpoly,
                      snr_db_list=list(snr_db_list), n_trials=n_trials)
    cfgs = expand_test_configs(algo_list, alpha_list, beta_list, mixed_list,
                               L_list)
    results = []
    for cfg in cfgs:
        rng = np.random.default_rng(seed)
        kw = {} if cfg["algo"] == "BP" else decode_kw
        blers = []
        for snr in snr_db_list:
            blkandcrc, llr = gen_ldpc_llr_batch(rng, zc, bgn, snr, n_trials,
                                                crcpoly, device=device)
            nerr = decode_batch(llr, blkandcrc, zc, bgn, cfg["L"],
                                cfg["algo"], cfg["alpha"], cfg["beta"],
                                device=device, **kw)
            blers.append(nerr / n_trials)
            print(f"{cfg['name']} a={cfg['alpha']} b={cfg['beta']} "
                  f"L={cfg['L']} snr={snr:+.1f}dB BLER={blers[-1]:.4f}")
        results.append(blers)
    _dump(filename, [sim_config, cfgs, results])
    return sim_config, cfgs, results


def run_ldpc_bf_simulation(zc, bgn, L_list, snr_db_list, filename,
                           n_trials: int = 400, seed: int = 0, device=None):
    """Bit-flipping BLER over the full unpunctured codeword (BPSK, AWGN,
    the noisy symbols themselves as LLRs); one Generator for the whole
    grid and the same pickle layout as scripts/sim_ldpc_decoder_bf.py."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    k = zc * (22 if bgn == 1 else 10)
    cfgs = [dict(name="BF", algo="BF", alpha=1.0, beta=0.0, L=L)
            for L in L_list]
    results = []
    for cfg in cfgs:
        blers = []
        for snr in snr_db_list:
            bc, dn = coded_blocks(rng, zc, bgn, n_trials, "24A", dev)
            full = np.concatenate([bc[:, : 2 * zc], dn], axis=-1)
            sigma = 10 ** (-snr / 20)
            llr = ((1 - 2 * full) + rng.normal(0, sigma, full.shape)
                   ).astype(np.float32)
            out, _ = ldpc_ops.ldpc_decode_bf(torch.as_tensor(llr, device=dev),
                                             zc, bgn, cfg["L"])
            err = np.any(out.cpu().numpy()[:, :k] != bc, axis=-1)
            blers.append(float(np.mean(err)))
            print(f"BF L={cfg['L']} snr={snr:+.1f}dB BLER={blers[-1]:.4f}")
        results.append(blers)
    sim_config = dict(Zc=zc, bgn=bgn, snr_db_list=list(snr_db_list),
                      n_trials=n_trials)
    _dump(filename, [sim_config, cfgs, results])
    return sim_config, cfgs, results


def run_hyper_search(zc, bgn, pairs, L: int = SEARCH_L,
                     snr_db: float = SEARCH_SNR_DB, n_trials: int = 400,
                     seed: int = 1, device=None, **decode_kw):
    """BLER of min-sum with each (alpha, beta) of pairs at one SNR, a
    fresh batch per pair from one Generator -> (blers, best pair)."""
    rng = np.random.default_rng(seed)
    blers = []
    for alpha, beta in pairs:
        blk, llr = gen_ldpc_llr_batch(rng, zc, bgn, snr_db, n_trials,
                                      device=device)
        nerr = decode_batch(llr, blk, zc, bgn, L, "min-sum", alpha, beta,
                            device=device, **decode_kw)
        blers.append(nerr / n_trials)
        print(f"Zc={zc} bgn={bgn} pair=({alpha},{beta}) "
              f"BLER={blers[-1]:.4f}")
    best = pairs[int(np.argmin(blers))]
    print(f"==> Zc={zc} bgn={bgn}: best (alpha, beta) = {best}")
    return blers, best


def draw_ldpc_decoder_result(snr_db_list, sim_config, test_config_list,
                             test_results_list, figfile):
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; skipping figure")
        return
    plt.figure(figsize=(8, 5))
    for cfg, blers in zip(test_config_list, test_results_list):
        label = (f"{cfg['name']} a={cfg['alpha']} b={cfg['beta']} "
                 f"L={cfg['L']}")
        plt.semilogy(snr_db_list, np.maximum(blers, 1e-5), "-o", label=label)
    plt.grid(True, which="both")
    plt.xlabel("SNR (dB)")
    plt.ylabel("BLER")
    plt.title(f"LDPC Zc={sim_config['Zc']} bgn={sim_config['bgn']}")
    plt.legend(fontsize=7)
    plt.savefig(figfile, dpi=120, bbox_inches="tight")
    plt.close()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--study", default="decoder",
                    choices=["decoder", "L", "bf", *SEARCHES])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the host")
    ap.add_argument("--trials", type=int, default=400)
    ap.add_argument("--out-dir", default="out")
    ap.add_argument("--schedule", default="flooded")
    ap.add_argument("--semantics", default="exact")
    ap.add_argument("--layout", default="auto")
    args = ap.parse_args()
    out = pathlib.Path(args.out_dir)
    kw = dict(schedule=args.schedule, semantics=args.semantics,
              layout=args.layout)
    if args.study in ("decoder", "L"):
        study, stem = ((DECODER_STUDY, "ldpc_decode_result_opt")
                       if args.study == "decoder"
                       else (L_STUDY, "ldpc_decode_result_for_L"))
        res = run_ldpc_simulation(**study, filename=out / f"{stem}.pickle",
                                  n_trials=args.trials, device=args.device,
                                  **kw)
        draw_ldpc_decoder_result(study["snr_db_list"], *res,
                                 out / f"{stem}.png")
    elif args.study == "bf":
        res = run_ldpc_bf_simulation(
            **BF_STUDY, filename=out / "ldpc_bf_decode_result.pickle",
            n_trials=args.trials, device=args.device)
        draw_ldpc_decoder_result(BF_STUDY["snr_db_list"], *res,
                                 out / "ldpc_bf_decode_result.png")
    else:
        search = SEARCHES[args.study]
        swept = search["swept"]
        for bgn in (1, 2):
            for zc in search["zc_list"]:
                blers, best = run_hyper_search(
                    zc, bgn, search["pairs"], n_trials=args.trials,
                    device=args.device, **kw)
                # the scripts' layout: [config, swept values, BLERs, best]
                values = [p if swept is None else p[swept]
                          for p in search["pairs"]]
                _dump(out / f"{search['stem']}_ZC{zc}_bgn{bgn}.pickle",
                      [dict(Zc=zc, bgn=bgn, snr_db=SEARCH_SNR_DB, L=SEARCH_L),
                       values, blers,
                       best if swept is None else best[swept]])


if __name__ == "__main__":
    main()
