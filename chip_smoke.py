"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Builds the hand-written CUDA kernels from python_5gtoolbox_tpu_torch/csrc,
holds each against its plain PyTorch version at the main path's shapes,
then runs the link-level PDSCH sweep at the bench configuration
(bench.py:bench_link_level) through the port's entry points and checks
that it went through both kernels and decodes a clean 30 dB point
exactly. Each phase prints one JSON line; the last two lines are the
kernel table and {"ok": true, "device": {...}}. Any failure raises and
exits non-zero. Run from the repository root:

    python3 chip_smoke.py

Matmuls and convolutions run in full float32 (TF32 off): the CRC and
the channel estimation are float32 matmuls whose results must be exact
or near-exact, and the FIR yardstick (cuDNN conv1d) defaults to TF32.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device available")

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from python_5gtoolbox_tpu_torch import kernels  # noqa: E402
from python_5gtoolbox_tpu_torch.interop import state_from_numpy  # noqa: E402
from python_5gtoolbox_tpu_torch.ops import filters  # noqa: E402
from python_5gtoolbox_tpu_torch.ops.ldpc import decode as ldpc_dec  # noqa: E402
from python_5gtoolbox_tpu_torch.ops.ldpc.encode import ldpc_encode  # noqa: E402
from python_5gtoolbox_tpu_torch.phy.pdsch import Pdsch  # noqa: E402
from python_5gtoolbox_tpu_torch.sim import pdsch_throughput as sim  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DEV = torch.device("cuda")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM data sheet, FP32 outside tensor cores
FIR_TOL = 1.2e-4               # tests/test_pallas_filters.py tolerance


def emit(phase: str, **kw) -> None:
    print(json.dumps(dict(phase=phase, **kw)), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, after one warm call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_device() -> str:
    smi = nvidia_smi()
    t0 = time.perf_counter()
    secs = kernels.build()
    ptxas = {stem: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for stem, log in kernels.BUILD_LOG.items()}
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         build_s=secs, build_wall_s=time.perf_counter() - t0, ptxas=ptxas)
    return smi


def _library_fir(planes, taps, mode):
    """One PyTorch call computing the same stage, where there is one."""
    n = len(taps)
    x = planes.unsqueeze(1)
    if mode == "same":
        k = torch.as_tensor(np.ascontiguousarray(taps[::-1]),
                            dtype=torch.float32, device=DEV).view(1, 1, n)
        return lambda: torch.nn.functional.conv1d(x, k, padding="same")
    if mode == "up2":
        k = torch.as_tensor(taps * np.sqrt(2), dtype=torch.float32,
                            device=DEV).view(1, 1, n)
        return lambda: torch.nn.functional.conv_transpose1d(
            x, k, stride=2, padding=n // 2 - 1)
    return None


def phase_fir(rng) -> dict:
    """banded_fir against banded_fir_plain in all three modes."""
    worst, main = 0.0, None
    cases = [((4, 307200), filters.fir_coeff(30, 20), "TX FIR, BW 20"),
             ((8, 307200), filters.fir_coeff(30, 20), "RX FIR, BW 20"),
             ((4, 307200), filters.fir_coeff(30, 100), "287 taps, BW 100")]
    for shape, taps, label in cases:
        x = torch.as_tensor(rng.standard_normal(shape, dtype=np.float32),
                            device=DEV)
        for mode in ("same", "up2", "down2"):
            got = filters.banded_fir(x, taps, mode)
            ref = filters.banded_fir_plain(x, taps, mode)
            torch.cuda.synchronize()
            if got.shape != ref.shape:
                raise AssertionError(f"banded_fir {mode} shape {got.shape} "
                                     f"!= {ref.shape}")
            err = (got - ref).abs().max().item()
            if not err < FIR_TOL:
                raise AssertionError(f"banded_fir {mode} {label}: max abs "
                                     f"error {err} >= {FIR_TOL}")
            worst = max(worst, err)
            k_ms = cuda_ms(lambda: filters.banded_fir(x, taps, mode), 50)
            p_ms = cuda_ms(lambda: filters.banded_fir_plain(x, taps, mode),
                           20)
            lib = _library_fir(x, taps, mode)
            if lib is not None:
                lib_out = lib()[:, 0, :got.shape[1]]
                lib_err = (lib_out - ref).abs().max().item()
                l_ms = cuda_ms(lib, 50)
            else:
                lib_err = l_ms = None
            n, (p, t), t_out = len(taps), shape, got.shape[1]
            b_ms, b_by = bound_ms(4 * (p * t + p * t_out + n),
                                  2 * n * p * t_out * (0.5 if mode == "up2"
                                                       else 1.0))
            row = dict(label=label, mode=mode, shape=list(shape), taps=n,
                       max_abs_err=err, kernel_ms=k_ms, plain_ms=p_ms,
                       library_ms=l_ms, library_max_abs_err=lib_err,
                       bound_ms=b_ms, bound_by=b_by)
            emit("banded_fir", **row)
            if label.startswith("RX") and mode == "same":
                main = row
    main["max_abs_err"] = worst
    return main


def _noisy_codewords(rng, zc, bgn, batch, snr_db):
    k = (22 if bgn == 1 else 10) * zc
    bits = torch.as_tensor(rng.integers(0, 2, (batch, k), dtype=np.int8),
                           device=DEV)
    dn = ldpc_encode(bits, bgn).to(torch.float32)
    s2 = 10 ** (-snr_db / 10)
    noise = torch.as_tensor(rng.standard_normal(tuple(dn.shape),
                                                dtype=np.float32), device=DEV)
    return (2 / s2) * (1 - 2 * dn + noise * np.sqrt(s2))


def phase_ldpc(rng) -> dict:
    """ldpc_minsum_flooded against the plain decoder, bit for bit."""
    main = None
    n_iter, alpha, beta = 16, 0.8, 0.3
    # the sweep's code (BG2, Zc 352, 20 codewords) where most codewords
    # converge, a large batch, BG1 at the largest lifting, and a point
    # where none converges (all 16 iterations and the final rule)
    for zc, bgn, batch, snr in [(352, 2, 20, -2.0), (352, 2, 256, -2.0),
                                (384, 1, 20, 0.0), (352, 2, 20, -6.0)]:
        llr = _noisy_codewords(rng, zc, bgn, batch, snr)
        iters = torch.zeros(batch, dtype=torch.int32, device=DEV)
        b1, ok1, f1 = ldpc_dec.ldpc_minsum_flooded(llr, zc, bgn, n_iter,
                                                   alpha, beta, iters)
        b2, ok2, f2 = ldpc_dec._ldpc_decode_plain(llr, zc, bgn, n_iter,
                                                  alpha, beta)
        torch.cuda.synchronize()
        n_bit_diff = int((f1 != f2).sum().item())
        n_ok_diff = int((ok1 != ok2).sum().item())
        if n_bit_diff or n_ok_diff:
            raise AssertionError(
                f"ldpc BG{bgn}/Zc{zc}/B{batch}: {n_bit_diff} bits and "
                f"{n_ok_diff} ok flags differ from the plain decoder")
        k_ms = cuda_ms(lambda: ldpc_dec.ldpc_minsum_flooded(
            llr, zc, bgn, n_iter, alpha, beta), 20)
        p_ms = cuda_ms(lambda: ldpc_dec._ldpc_decode_plain(
            llr, zc, bgn, n_iter, alpha, beta), 2)
        rows, _, ncols = ldpc_dec._graph(bgn, zc)
        n_edges = sum(len(r) for r in rows)
        n_upd = int(iters.sum().item())
        # per edge and lifting index: 14 operations per update (ext,
        # |.|, min1/min2, sign/zero count, message) + 1 variable-node add,
        # and 2 per syndrome check (one check per update, one more at the
        # end of each codeword)
        n_ops = zc * n_edges * (15 * n_upd + 2 * (n_upd + batch))
        n_bytes = batch * ((ncols - 2) * zc * 4 + ncols * zc + 4)
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        row = dict(bg=bgn, zc=zc, batch=batch, snr_db=snr, n_iter=n_iter,
                   converged=int(ok1.sum().item()),
                   mean_updates=n_upd / batch, bits_differing=n_bit_diff,
                   ok_differing=n_ok_diff, kernel_ms=k_ms, plain_ms=p_ms,
                   library_ms=None, bound_ms=b_ms, bound_by=b_by)
        emit("ldpc_minsum_flooded", **row)
        if main is None:
            main = row
    main["max_abs_err"] = 0.0
    return main


def phase_sweep() -> dict:
    carrier, pdsch, chan, ce, ldpc = sim.bench_link_level_config()
    snrs = [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]
    n_slots = 20
    kw = dict(ceq_algo_list=["MMSE-IRC"], n_slots=n_slots, ce_config=ce,
              ldpc_config=ldpc, seed=3, device=DEV)
    t0 = time.perf_counter()
    sim.run_pdsch_throughput(carrier, pdsch, chan, snrs, **kw)   # warm
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = sim.run_pdsch_throughput(carrier, pdsch, chan, snrs, **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"the sweep never launched {name}")
    emit("sweep", snr_db=snrs, pass_rate=res["MMSE-IRC"],
         tbs_bits=res["tbs_bits"], slots=len(snrs) * n_slots, seconds=dt,
         slots_per_s=len(snrs) * n_slots / dt, warm_run_s=warm_s,
         launches=launches)

    # a clean point decodes every block, and decodes it exactly
    nr_pdsch0 = Pdsch(pdsch, carrier, device=DEV)
    trblks = np.random.default_rng(30).integers(
        0, 2, (n_slots, nr_pdsch0.tbsize), dtype=np.int8)
    nr_pdsch, slots, rx_fd = sim.pdsch_before_ceq_processing(
        carrier, pdsch, chan, -30.0, n_slots, seed=30, device=DEV,
        state=state_from_numpy(trblks=trblks, device=DEV))
    n_sc = rx_fd.shape[1] // (n_slots * 14)
    if tuple(rx_fd.shape) != (4, n_slots * 14 * n_sc) \
            or not torch.isfinite(torch.view_as_real(rx_fd)).all():
        raise AssertionError(f"rx grid has shape {tuple(rx_fd.shape)} or "
                             f"non-finite values")
    stack = rx_fd.reshape(4, n_slots, -1).transpose(0, 1)
    ok, tbblk = nr_pdsch.rx_process_batch(
        stack, slots, {"algo": "MMSE-IRC"}, ldpc,
        sim._ce_config(ce, chan, carrier["scs"]))
    n_pass = int(ok.sum())
    exact = bool(np.array_equal(tbblk, trblks))
    emit("sweep_30db", passed=n_pass, slots=n_slots, tb_bits_exact=exact)
    if n_pass != n_slots or not exact:
        raise AssertionError(f"30 dB point: {n_pass}/{n_slots} passed, "
                             f"TB bits exact: {exact}")
    return launches


def main() -> None:
    rng = np.random.default_rng(2024)
    phase_device()
    fir = phase_fir(rng)
    ldpc = phase_ldpc(rng)
    launches = phase_sweep()
    table = []
    for name, src, replaces, row in [
            ("banded_fir", "python_5gtoolbox_tpu_torch/csrc/banded_fir.cu",
             "python_5gtoolbox_tpu/ops/pallas_filters.py:93", fir),
            ("ldpc_minsum_flooded",
             "python_5gtoolbox_tpu_torch/csrc/ldpc_minsum.cu",
             "python_5gtoolbox_tpu/ops/ldpc/pallas_decode.py:138", ldpc)]:
        table.append(dict(name=name, route="cuda", source=src,
                          replaces=replaces, launches=launches[name],
                          max_abs_err=row["max_abs_err"],
                          ms=row["kernel_ms"], plain_ms=row["plain_ms"],
                          bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                          library_ms=row["library_ms"]))
    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
