"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Builds the hand-written CUDA kernels from python_5gtoolbox_tpu_torch/csrc,
holds each against its plain PyTorch version at the main paths' shapes,
then drives the port's paths through its entry points:

  * the link-level PDSCH sweep at the bench configuration
    (bench.py:bench_link_level) at the carrier rate: banded FIR and LDPC
    kernels, a clean 30 dB point decoded exactly;
  * OFDM + DUC at the width of the waveform bench (bench.py:bench_ofdm_duc:
    scs 30, BW 100, 64 slots, 2 antennas, 245.76 Msps): the spectrum DUC
    kernel, held against the plain path;
  * the same sweep with waveform, channel and RX front end at 245.76
    Msps (spectrum DUC, halfband up/down stages, FIR, LDPC), and one
    waveform each with a timing error (flat fused FIR + halfband) and at
    scs 15 / BW 5 (symbol DUC kernel);
  * the sweep on a small allocation (MCS 0, 12 RBs: Zc 80), whose decode
    goes through the small-lifting LDPC kernel;
  * the LDPC decoder BLER study (scripts/sim_ldpc_decoder.py: Zc 12, BG1,
    400 codewords per SNR point, six decoder settings) and the
    bit-flipping study's decode, and the decoder bench's shape
    (bench.py:bench_ldpc: BG1, Zc 384, never-converging LLRs, flooded
    L=32 / layered L=16 / layered L=16 fast) through ldpc_decode.

Every kernel's time is the device time of back-to-back calls
(sim/time_ldpc_kernels.py:device_ms; a spin kernel holds the stream while
the host enqueues them), beside the time of consecutive calls with the
host's share (call_ms) and the launch plan: cluster, group, threads and
barriers per iteration for the LDPC kernels (ops/ldpc/decode.py:
plan_launch), taps per branch, delay, tiles per block and staging path
for banded_fir (ops/filters.py:fir_plan), cluster size and IDFTs per
symbol for duc_from_spec (ops/filters.py:duc_plan). The FIR's library
call (cuDNN) is timed as device time too.

The launch counters are zeroed just before each path and read just
after. Each phase prints JSON lines; the last two lines are the kernel
table and {"ok": true, "device": {...}}. Any failure raises and exits
non-zero. Run from the repository root:

    python3 chip_smoke.py

Matmuls and convolutions run in full float32 (TF32 off): the CRC and
the channel estimation are float32 matmuls whose results must be exact
or near-exact, and the FIR yardstick (cuDNN conv1d) defaults to TF32.
"""
from __future__ import annotations

import functools
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
from python_5gtoolbox_tpu_torch.ops import filters, ofdm  # noqa: E402
from python_5gtoolbox_tpu_torch.ops.ldpc import decode as ldpc_dec  # noqa: E402
from python_5gtoolbox_tpu_torch.ops.ldpc.encode import ldpc_encode  # noqa: E402
from python_5gtoolbox_tpu_torch.phy.pdsch import Pdsch  # noqa: E402
from python_5gtoolbox_tpu_torch.sim import ldpc_decoder as study  # noqa: E402
from python_5gtoolbox_tpu_torch.sim import pdsch_throughput as sim  # noqa: E402
from python_5gtoolbox_tpu_torch.sim.time_ldpc_kernels import (  # noqa: E402
    call_ms, device_ms, never_converging_llrs)
from python_5gtoolbox_tpu_torch.waveform import dl as dl_wf  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DEV = torch.device("cuda")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM data sheet, FP32 outside tensor cores
FIR_TOL = 1.2e-4               # tests/test_pallas_filters.py tolerance
SUMMARY: dict = {}             # end-to-end rates, printed again near the end


def emit(phase: str, **kw) -> None:
    print(json.dumps(dict(phase=phase, **kw)), flush=True)


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
                    if "registers" in ln or "spill" in ln
                    or "entry function" in ln]
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
    # down2: conv1d pads both ends alike, so with the stage's left padding
    # the call is one output short at the end
    k = torch.as_tensor(np.ascontiguousarray(taps[::-1]) * np.sqrt(2),
                        dtype=torch.float32, device=DEV).view(1, 1, n)
    return lambda: torch.nn.functional.conv1d(
        x, k, stride=2, padding=(n - 1) - 2 * ((n + 1) // 4))


def _fir_plan_row(plan) -> dict:
    return dict(kp=plan.kp, d=plan.d, tiles_per_block=plan.tiles_per_block,
                stages=plan.stages, blocks=plan.blocks, vec=plan.vec,
                smem_bytes=plan.smem_bytes)


def phase_fir(rng) -> dict:
    """banded_fir against banded_fir_plain in all three modes; kernel and
    library call timed as device time of back-to-back calls (device_ms),
    the kernel also as consecutive calls with the host's share
    (call_ms)."""
    worst, main = 0.0, None
    all_modes = ("same", "up2", "down2")
    hb = filters.halfband_coeff()
    # the FIR at the carrier rate, then the halfband stages of the 245.76
    # Msps sweep (BW 20, 20 slots, 2 TX / 4 RX antennas): DUC 2x -> 4x -> 8x
    # after the fused kernel, DDC 8x -> 4x -> 2x -> 1x before the FIR; last
    # a ragged row length on a base 4 bytes past a 16-byte boundary (the
    # kernel's 4-byte staging path)
    cases = [((4, 307200), filters.fir_coeff(30, 20), "TX FIR, BW 20",
              all_modes),
             ((8, 307200), filters.fir_coeff(30, 20), "RX FIR, BW 20",
              all_modes),
             ((4, 307200), filters.fir_coeff(30, 100), "287 taps, BW 100",
              all_modes),
             ((4, 614400), hb, "DUC halfband 2x -> 4x", ("up2",)),
             ((4, 1228800), hb, "DUC halfband 4x -> 8x", ("up2",)),
             ((8, 2457600), hb, "DDC halfband 8x -> 4x", ("down2",)),
             ((8, 1228800), hb, "DDC halfband 4x -> 2x", ("down2",)),
             ((8, 614400), hb, "DDC halfband 2x -> 1x", ("down2",)),
             ((3, 307201), filters.fir_coeff(30, 20),
              "ragged, unaligned base", all_modes)]
    for shape, taps, label, modes in cases:
        p, t = shape
        flat = torch.as_tensor(rng.standard_normal(p * t + 1,
                                                   dtype=np.float32),
                               device=DEV)
        x = (flat[1:] if label.startswith("ragged") else flat[:-1]).view(p, t)
        for mode in modes:
            plan = filters.fir_plan(len(taps), mode, t, p,
                                    x.data_ptr() % 16 == 0)
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

            def run():
                return filters.banded_fir(x, taps, mode)
            k_ms, c_ms = device_ms(run, 20), call_ms(run, 20)
            p_ms = call_ms(lambda: filters.banded_fir_plain(x, taps, mode),
                           10)
            lib = _library_fir(x, taps, mode)
            lib_out = lib()[:, 0, :got.shape[1]]
            lib_err = (lib_out - ref[:, :lib_out.shape[1]]
                       ).abs().max().item()
            if not lib_err < FIR_TOL \
                    or lib_out.shape[1] < got.shape[1] - 1:
                raise AssertionError(f"library FIR {mode} {label}: not the "
                                     f"same function ({lib_err})")
            l_ms = device_ms(lib, 20)
            n, t_out = len(taps), got.shape[1]
            b_ms, b_by = bound_ms(4 * (p * t + p * t_out + n),
                                  2 * n * p * t_out * (0.5 if mode == "up2"
                                                       else 1.0))
            row = dict(label=label, mode=mode, shape=list(shape), taps=n,
                       max_abs_err=err, kernel_ms=k_ms, call_ms=c_ms,
                       plain_ms=p_ms, library_ms=l_ms,
                       library_max_abs_err=lib_err, bound_ms=b_ms,
                       bound_by=b_by, plan=_fir_plan_row(plan))
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


def _event_ms(fn):
    """fn() once, its result and its device time."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _ldpc_bound(zc, bgn, batch, n_upd):
    """Per edge and lifting index: 14 operations per update (ext, |.|,
    min1/min2, sign/zero count, message) + 1 variable-node add, and 2 per
    syndrome check (one check per update, one more at the end of each
    codeword); input LLRs read once, bits and flags written once."""
    rows, _, ncols = ldpc_dec._graph(bgn, zc)
    n_edges = sum(len(r) for r in rows)
    n_ops = zc * n_edges * (15 * n_upd + 2 * (n_upd + batch))
    n_bytes = batch * ((ncols - 2) * zc * 4 + ncols * zc + 4)
    return bound_ms(n_bytes, n_ops)


def _ldpc_case(phase, kernel, llr, zc, bgn, n_iter, schedule="flooded",
               semantics="exact", n_plain=None, reps=20, **extra):
    """One decoder kernel (ldpc_minsum or ldpc_minsum_packed) against the
    plain decoder, bit for bit, then timed -> (row, (ok, full bits)).
    n_plain: hold only the first n_plain codewords against the plain
    decoder (a codeword's decode does not depend on its neighbours)."""
    alpha, beta = 0.8, 0.3
    batch = llr.shape[0]
    n_plain = batch if n_plain is None else n_plain
    iters = torch.zeros(batch, dtype=torch.int32, device=DEV)
    _, ok1, f1 = kernel(llr, zc, bgn, n_iter, alpha, beta, iters,
                        schedule=schedule, semantics=semantics)
    (_, ok2, f2), p_ms = _event_ms(lambda: ldpc_dec._ldpc_decode_plain(
        llr[:n_plain], zc, bgn, n_iter, alpha, beta, schedule, semantics))
    n_bit_diff = int((f1[:n_plain] != f2).sum().item())
    n_ok_diff = int((ok1[:n_plain] != ok2).sum().item())
    label = f"{phase} BG{bgn}/Zc{zc}/B{batch} {schedule} {semantics}"
    if n_bit_diff or n_ok_diff:
        raise AssertionError(f"{label}: {n_bit_diff} bits and {n_ok_diff} "
                             f"ok flags differ from the plain decoder")
    def run():
        return kernel(llr, zc, bgn, n_iter, alpha, beta, schedule=schedule,
                      semantics=semantics)
    k_ms, c_ms = device_ms(run, reps), call_ms(run, reps)
    n_upd = int(iters.sum().item())
    b_ms, b_by = _ldpc_bound(zc, bgn, batch, n_upd)
    plan = ldpc_dec.plan_launch(
        bgn, zc, batch, schedule,
        "packed" if kernel is ldpc_dec.ldpc_minsum_packed else "batch",
        torch.cuda.get_device_properties(DEV).multi_processor_count)
    row = dict(bg=bgn, zc=zc, batch=batch, n_iter=n_iter, schedule=schedule,
               semantics=semantics, converged=int(ok1.sum().item()),
               mean_updates=n_upd / batch, bits_differing=n_bit_diff,
               ok_differing=n_ok_diff, kernel_ms=k_ms, call_ms=c_ms,
               codewords_per_s=batch / k_ms * 1e3, plain_ms=p_ms,
               plain_batch=n_plain, library_ms=None, bound_ms=b_ms,
               bound_by=b_by, max_abs_err=0.0, cluster=plan.cluster,
               group=plan.group, threads=plan.threads, slice=plan.zl,
               blocks=plan.blocks, warp_per_codeword=plan.warp,
               lr_on_chip=plan.lr_on_chip,
               barriers_per_iteration=plan.barriers, **extra)
    emit(phase, **row)
    return row, (ok1, f1)


def phase_ldpc(rng) -> dict:
    """ldpc_minsum_flooded against the plain decoder, bit for bit."""
    main = None
    # the plain decoder is timed on one call per case: let the first such
    # call in the process (kernel loading, allocator growth) go untimed
    ldpc_dec._ldpc_decode_plain(never_converging_llrs(rng, 352, 2, 20, DEV),
                                352, 2, 2, 0.8, 0.3)
    # the sweep's code (BG2, Zc 352, 20 codewords) where most codewords
    # converge, a large batch, BG1 at the largest lifting, and a point
    # where none converges (all 16 iterations and the final rule)
    for zc, bgn, batch, snr in [(352, 2, 20, -2.0), (352, 2, 256, -2.0),
                                (384, 1, 20, 0.0), (352, 2, 20, -6.0)]:
        llr = _noisy_codewords(rng, zc, bgn, batch, snr)
        row, _ = _ldpc_case("ldpc_minsum_flooded", ldpc_dec.ldpc_minsum, llr,
                            zc, bgn, 16, snr_db=snr)
        if main is None:
            main = row
    return main


VARIANTS = [("flooded", "exact"), ("flooded", "fast"), ("layered", "exact"),
            ("layered", "fast")]


def _variant_name(schedule, semantics):
    return f"ldpc_minsum_{schedule}" + ("_fast" if semantics == "fast"
                                        else "")


def phase_ldpc_packed(rng) -> dict:
    """ldpc_minsum_packed, all four variants, against the plain decoder at
    the shapes of the decoder studies and of the small-allocation sweep,
    and the one-block-per-codeword kernel timed on the same inputs.
    Returns the row at the sweep's shape (flooded, exact)."""
    main = None
    cases = [(12, 1, 400, -0.5, "decoder study"),
             (10, 1, 400, -0.5, "iteration-count study"),
             (16, 2, 400, 1.0, "bit-flipping study's code"),
             (80, 2, 20, -2.0, "small-allocation sweep"),
             (112, 2, 400, -2.0, "hyper-search"),
             (12, 1, 397, -0.5, "batch not a multiple of the group"),
             (12, 1, 400, None, "never converging")]
    for zc, bgn, batch, snr, label in cases:
        llr = (never_converging_llrs(rng, zc, bgn, batch, DEV) if snr is None
               else _noisy_codewords(rng, zc, bgn, batch, snr))
        for schedule, semantics in VARIANTS:
            # the same input through the one-block-per-codeword kernel
            _, ok_b, f_b = ldpc_dec.ldpc_minsum(
                llr, zc, bgn, 16, 0.8, 0.3, schedule=schedule,
                semantics=semantics)
            batch_ms = device_ms(lambda: ldpc_dec.ldpc_minsum(
                llr, zc, bgn, 16, 0.8, 0.3, schedule=schedule,
                semantics=semantics), 10)
            row, (ok_p, f_p) = _ldpc_case(
                "ldpc_minsum_packed", ldpc_dec.ldpc_minsum_packed, llr, zc,
                bgn, 16, schedule, semantics, reps=10, label=label,
                snr_db=snr, batch_layout_ms=batch_ms,
                group_limit=ldpc_dec.packed_group_limit(zc, bgn))
            if not (torch.equal(ok_b, ok_p) and torch.equal(f_b, f_p)):
                raise AssertionError(f"{label}: the two layouts disagree")
            if label == "small-allocation sweep" and main is None:
                main = row
    return main


def phase_ldpc_layout(rng) -> None:
    """The rule of ldpc_decode(layout="auto") (packed below Zc 128 where
    the state fits) re-measured around its edge: both kernels on the same
    input at Zc 112, 120, 128 and 144, both base graphs, B 400."""
    for zc in (112, 120, 128, 144):
        for bgn in (1, 2):
            if ldpc_dec.packed_group_limit(zc, bgn) < 1:
                continue
            llr = _noisy_codewords(rng, zc, bgn, 400, -2.0 if bgn == 2
                                   else 0.0)
            for schedule in ("flooded", "layered"):
                ms = {}
                for name in ("ldpc_minsum", "ldpc_minsum_packed"):
                    kern = getattr(ldpc_dec, name)
                    ms[name] = device_ms(lambda: kern(
                        llr, zc, bgn, 16, 0.8, 0.3, schedule=schedule), 10)
                emit("ldpc_layout", bg=bgn, zc=zc, batch=400,
                     schedule=schedule, auto=("packed" if zc < 128
                                              else "batch"), **ms)


def phase_ldpc_variants(rng) -> tuple[dict, dict]:
    """ldpc_minsum in the layered schedule and with the fast check node
    against the plain decoder at the sweep's code and at the width of the
    decoder bench (bench.py:bench_ldpc: BG1, Zc 384, never-converging
    LLRs; flooded L=32, layered L=16, layered L=16 fast). Then that bench
    through the entry point ldpc_decode, with the launches counted.
    Returns the rows at the bench width and those launch counts."""
    llr = _noisy_codewords(rng, 352, 2, 20, -2.0)
    for schedule, semantics in VARIANTS[1:]:
        _ldpc_case("ldpc_variants", ldpc_dec.ldpc_minsum, llr, 352, 2, 16,
                   schedule, semantics, snr_db=-2.0)
    rows = {}
    zc, bgn = 384, 1
    llr = never_converging_llrs(rng, zc, bgn, 2048, DEV)
    for schedule, semantics in VARIANTS:
        n_iter = 32 if schedule == "flooded" else 16
        row, _ = _ldpc_case("ldpc_variants", ldpc_dec.ldpc_minsum, llr[:512],
                            zc, bgn, n_iter, schedule, semantics, n_plain=32,
                            reps=3, label="decoder bench width")
        big_ms = device_ms(lambda: ldpc_dec.ldpc_minsum(
            llr, zc, bgn, n_iter, 0.8, 0.3, schedule=schedule,
            semantics=semantics), 2)
        emit("ldpc_variants", label="decoder bench width, kernel time only",
             bg=bgn, zc=zc, batch=2048, n_iter=n_iter, schedule=schedule,
             semantics=semantics, kernel_ms=big_ms,
             codewords_per_s=2048 / big_ms * 1e3)
        rows[_variant_name(schedule, semantics)] = row
    # the bench itself, as a user calls it
    kernels.reset_launches()
    for schedule, semantics in VARIANTS:
        _, ok, _ = ldpc_dec.ldpc_decode(
            llr[:512], zc, bgn, 32 if schedule == "flooded" else 16,
            "min-sum", 0.8, 0.3, schedule=schedule, semantics=semantics)
        if ok.shape != (512,) or bool(ok.any()):
            raise AssertionError("decoder bench: garbage LLRs converged")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    for schedule, semantics in VARIANTS:
        if launches[_variant_name(schedule, semantics)] != 1:
            raise AssertionError(f"decoder bench launches: {launches}")
    emit("ldpc_variants", label="decoder bench through ldpc_decode",
         launches=launches)
    return rows, launches


# ---------------------------------------------------------------------------
# The three fused DUC kernels
# ---------------------------------------------------------------------------

def _fused_ops(n1: int, n2: int, planes: int, t: int) -> float:
    """FIR: n1 FMAs per 1x sample; halfband: n2 / 2 per output, two
    outputs per 1x sample."""
    return 2.0 * (n1 + n2) * planes * t


def _check(name: str, label: str, got, ref) -> float:
    torch.cuda.synchronize()
    if got.shape != ref.shape:
        raise AssertionError(f"{name} {label}: shape {tuple(got.shape)} != "
                             f"{tuple(ref.shape)}")
    err = (got - ref).abs().max().item()
    if not err < FIR_TOL or not torch.isfinite(got).all():
        raise AssertionError(f"{name} {label}: max abs error {err} >= "
                             f"{FIR_TOL} or non-finite output")
    return err


def _random_grid(rng, scs, bw, nant, n_slots):
    cfg = dict(scs=scs, bw=bw, nant=nant, n_slots=n_slots)
    return sim.ofdm_duc_grid(cfg, seed=int(rng.integers(1 << 30)), device=DEV)


def _case_fused(rng, shape, scs, bw, label):
    fir, hb = filters.fir_coeff(scs, bw), filters.halfband_coeff()
    x = torch.as_tensor(rng.standard_normal(shape, dtype=np.float32),
                        device=DEV)
    kern = functools.partial(filters.fir_up2_fused_planes, x, fir, hb)
    plain = functools.partial(filters.fir_up2_fused_plain, x, fir, hb)
    p, t = shape
    n_bytes = 4 * (3 * p * t + len(fir) + len(hb))
    return ("fir_up2_fused", label, kern, plain, n_bytes,
            _fused_ops(len(fir), len(hb), p, t),
            dict(shape=list(shape), taps=len(fir)))


def _case_symbols(rng, scs, bw, nant, n_slots):
    fc = int(3500e6)
    fir, hb = filters.fir_coeff(scs, bw), filters.halfband_coeff()
    symp = ofdm.tx_low_phy_sym_planes(_random_grid(rng, scs, bw, nant,
                                                   n_slots), scs, bw, fc)
    nfft = symp.shape[-1]
    cps = ofdm._cp_table(scs, nfft)
    kern = functools.partial(filters.fir_up2_fused_symbols, symp, cps, fir,
                             hb)
    plain = functools.partial(filters.fir_up2_fused_symbols_plain, symp, cps,
                              fir, hb)
    t = n_slots * ofdm.slot_sample_count(scs, bw)
    p = 2 * nant
    n_bytes = 4 * (symp.numel() + 2 * p * t + len(fir) + len(hb) + 14)
    return ("fir_up2_fused_symbols", f"scs {scs}, BW {bw}, {n_slots} slots",
            kern, plain, n_bytes, _fused_ops(len(fir), len(hb), p, t),
            dict(shape=list(symp.shape), taps=len(fir)))


def _case_spec(fd, scs, bw, fc=int(3500e6), cluster=None):
    nant, n_slots = fd.shape[0], fd.shape[1]
    fir, hb = filters.fir_coeff(scs, bw), filters.halfband_coeff()
    spec = ofdm.tx_spec_planes(fd, scs, bw, fc)
    nfft = spec.shape[-1]
    cps, pc = ofdm._cp_table(scs, nfft), ofdm._phase_comp(scs, nfft, fc)
    plan = filters.duc_plan(nant, n_slots, nfft, len(fir), len(hb), cps,
                            cluster)
    # the wrapper below duc_from_spec_planes: both planes in one tensor
    kern = functools.partial(filters._duc_from_spec, spec, cps, fir, hb, pc,
                             plan=None if cluster is None else plan)

    def plain():
        return torch.cat(filters.duc_from_spec_planes_plain(spec, cps, fir,
                                                            hb, pc))
    t = n_slots * ofdm.slot_sample_count(scs, bw)
    p = 2 * nant
    # IDFT 5 N log2 N per symbol; sign, scale and phase compensation 8 per
    # complex timeline sample
    n_ops = _fused_ops(len(fir), len(hb), p, t) \
        + nant * n_slots * 14 * 5.0 * nfft * np.log2(nfft) + 8.0 * nant * t
    n_bytes = 4 * (spec.numel() + 2 * p * t + len(fir) + len(hb) + 14 + 28
                   + nfft)
    label = f"scs {scs}, BW {bw}, {n_slots} slots" + (
        "" if cluster is None else f", cluster {cluster} forced")
    return ("duc_from_spec", label, kern, plain, n_bytes, n_ops,
            dict(shape=list(spec.shape), taps=len(fir),
                 plan=dict(cluster=plan.cluster, blocks=plan.blocks,
                           symbols=plan.symbols,
                           idfts_per_symbol=plan.idfts_per_symbol,
                           smem_bytes=plan.smem_bytes)))


def _run_case(case, reps_kernel=20, reps_plain=5) -> dict:
    """Kernel against plain on the card, then both timed: the kernel as
    device time of back-to-back calls (device_ms) and as consecutive calls
    with the host's share (call_ms)."""
    name, label, kern, plain, n_bytes, n_ops, extra = case
    err = _check(name, label, kern(), plain())
    k_ms, c_ms = device_ms(kern, reps_kernel), call_ms(kern, reps_kernel)
    p_ms = call_ms(plain, reps_plain)
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    # no single PyTorch call computes FIR + mask + halfband (+ CP, + IDFT)
    row = dict(label=label, max_abs_err=err, kernel_ms=k_ms, call_ms=c_ms,
               plain_ms=p_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by,
               **extra)
    emit(name, **row)
    return row


def phase_duc_kernels(rng) -> dict:
    """Each fused DUC kernel against its plain version; returns the row of
    each kernel at its main path's shape, with the worst error of all its
    cases."""
    cases = [
        _case_fused(rng, (4, 307200), 30, 20, "Dm waveform, BW 20"),
        _case_fused(rng, (4, 3932160), 30, 100, "287 taps, 64 slots BW 100"),
        _case_fused(rng, (2, 15360), 30, 20, "1 slot, BW 20"),
        _case_symbols(rng, 15, 5, 2, 20),
        _case_symbols(rng, 30, 10, 2, 20),
        _case_symbols(rng, 30, 5, 2, 1),
        _case_spec(_random_grid(rng, 30, 20, 2, 20), 30, 20),   # sweep_245
        _case_spec(_random_grid(rng, 30, 40, 2, 8), 30, 40),
        _case_spec(_random_grid(rng, 30, 100, 2, 8), 30, 100),
        _case_spec(_random_grid(rng, 30, 100, 2, 1), 30, 100),
        # 42 symbols: the grid padded to whole clusters, at the default
        # size and at the largest (non-portable) one
        _case_spec(_random_grid(rng, 30, 20, 2, 3), 30, 20),
        _case_spec(_random_grid(rng, 30, 20, 2, 3), 30, 20, cluster=16),
    ]
    main, worst = {}, {}
    for case in cases:
        row = _run_case(case)
        worst[case[0]] = max(worst.get(case[0], 0.0), row["max_abs_err"])
        main.setdefault(case[0], row)
    for name, row in main.items():
        row["max_abs_err"] = worst[name]
    return main


def _plain_duc(fd_ant_major, scs, bw, fc, rate_hz, slot_phase=True,
               start_slot=0):
    """The waveform of filters.tx_lowphy_duc from the plain versions
    only: torch.fft, CP concat, conv1d stages."""
    symp = ofdm.tx_low_phy_sym_planes(fd_ant_major, scs, bw, fc,
                                      slot_phase=slot_phase,
                                      start_slot=start_slot)
    y = filters.fir_up2_fused_symbols_plain(
        symp, ofdm._cp_table(scs, symp.shape[-1]), filters.fir_coeff(scs, bw),
        filters.halfband_coeff())
    for _ in range(int(np.log2(filters._oversample(scs, bw, rate_hz))) - 1):
        y = filters.banded_fir_plain(y, filters.halfband_coeff(), "up2")
    nant = fd_ant_major.shape[0]
    return torch.complex(y[:nant], y[nant:])


def phase_duc(main: dict) -> int:
    """OFDM + DUC at the full width of the waveform bench through
    sim.run_ofdm_duc; returns the launches of duc_from_spec in one run and
    puts the kernel's row at this shape into main."""
    cfg = sim.bench_ofdm_duc_config()
    fd = sim.ofdm_duc_grid(cfg, seed=0, device=DEV)
    sim.run_ofdm_duc(fd, cfg, device=DEV)                    # warm
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    re, im = sim.run_ofdm_duc(fd, cfg, device=DEV)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    if launches["duc_from_spec"] <= 0:
        raise AssertionError("run_ofdm_duc never launched duc_from_spec")
    n_out = re.shape[1]
    over = filters._oversample(cfg["scs"], cfg["bw"], cfg["out_rate_hz"])
    want = (cfg["nant"], over * cfg["n_slots"]
            * ofdm.slot_sample_count(cfg["scs"], cfg["bw"]))
    if tuple(re.shape) != want or tuple(im.shape) != want:
        raise AssertionError(f"waveform planes {tuple(re.shape)} != {want}")
    plain = _plain_duc(fd, cfg["scs"], cfg["bw"], cfg["carrier_freq_hz"],
                       cfg["out_rate_hz"], slot_phase=False)
    err = _check("run_ofdm_duc", "full width", torch.complex(re, im), plain)
    del plain
    step_ms = call_ms(lambda: sim.run_ofdm_duc(fd, cfg, device=DEV), 10)
    SUMMARY["ofdm_duc_msamples_per_s"] = cfg["nant"] * n_out / step_ms / 1e3
    emit("ofdm_duc", scs=cfg["scs"], bw=cfg["bw"], n_slots=cfg["n_slots"],
         nant=cfg["nant"], out_rate_mhz=cfg["out_rate_hz"] / 1e6,
         complex_samples_out=cfg["nant"] * n_out, first_timed_run_s=dt,
         step_ms=step_ms,
         msamples_per_s=cfg["nant"] * n_out / step_ms / 1e3,
         max_abs_err_vs_plain=err, launches=launches)
    row = _run_case(_case_spec(fd, cfg["scs"], cfg["bw"],
                               cfg["carrier_freq_hz"]))
    if not row["plan"]["idfts_per_symbol"] <= 1.25:
        raise AssertionError(f"duc_from_spec plan at the bench width: "
                             f"{row['plan']}")
    row["max_abs_err"] = max(row["max_abs_err"],
                             main["duc_from_spec"]["max_abs_err"])
    main["duc_from_spec"] = row
    return launches["duc_from_spec"]


def _sweep(phase: str, rate_mhz, expected,
           config=sim.bench_link_level_config,
           snrs=(0.0, 1.0, 2.0, 3.0, 4.0, 5.0)) -> dict:
    """A link-level sweep (the bench configuration unless config says
    otherwise; 6 SNR points x 20 slots, warm) at the carrier rate or at
    rate_mhz, then a clean 30 dB point that must decode exactly. Returns
    the timed sweep's launch counts. expected: the kernels that must have
    been launched, or a dict of exact counts."""
    carrier, pdsch, chan, ce, ldpc = config()
    if rate_mhz is not None:
        carrier["samplerate_in_mhz"] = rate_mhz
    snrs = list(snrs)
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
    for name in expected:
        if launches[name] <= 0 if not isinstance(expected, dict) \
                else launches[name] != expected[name]:
            raise AssertionError(f"the {phase} launched {name} "
                                 f"{launches[name]} times")
    SUMMARY[f"{phase}_slots_per_s"] = len(snrs) * n_slots / dt
    emit(phase, snr_db=snrs, pass_rate=res["MMSE-IRC"],
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
    emit(f"{phase}_30db", passed=n_pass, slots=n_slots, tb_bits_exact=exact)
    if n_pass != n_slots or not exact:
        raise AssertionError(f"{phase} 30 dB point: {n_pass}/{n_slots} "
                             f"passed, TB bits exact: {exact}")
    return launches


def phase_sweep() -> dict:
    return _sweep("sweep", None, ("banded_fir", "ldpc_minsum_flooded"))


def phase_sweep_245() -> dict:
    return _sweep("sweep_245", 245.76,
                  ("duc_from_spec", "banded_fir", "ldpc_minsum_flooded"))


def phase_sweep_small_alloc() -> dict:
    """The sweep on the small allocation (MCS 0, 12 RBs: TBS 736, BG2,
    Zc 80, one code block per slot) across its waterfall: every decode is
    one launch of the small-lifting kernel."""
    return _sweep("sweep_small_alloc", None,
                  dict(ldpc_minsum_packed=6, ldpc_minsum_flooded=0,
                       banded_fir=12),
                  config=sim.small_alloc_link_level_config,
                  snrs=(-12.0, -11.0, -10.0, -9.0, -8.0, -6.0))


def _z_score(p1, p2, n):
    """Two-sample z of two BLERs over n trials each (the criterion of
    tools/ldpc_fast_mode.py)."""
    pool = (p1 + p2) / 2
    return (p1 - p2) / np.sqrt(max(pool * (1 - pool), 1e-12) * 2 / n)


def phase_ldpc_study() -> int:
    """The decoder BLER study at full width through run_ldpc_simulation
    (Zc 12, BG1, 400 codewords per point, 5 SNR points, 6 settings, L 16)
    on the card; the min-sum family again on the CPU at one point (same
    draws, bit-identical decoders: equal BLER); two statistical anchors.
    Returns the study's launches of ldpc_minsum_packed."""
    cfg = dict(study.DECODER_STUDY)
    kernels.reset_launches()
    t0 = time.perf_counter()
    _, cfgs, blers = study.run_ldpc_simulation(**cfg, filename=None,
                                               n_trials=400, device=DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    n_points = len(cfg["snr_db_list"])
    n_minsum = sum(c["algo"] != "BP" for c in cfgs)
    others = sum(v for k, v in launches.items() if k != "ldpc_minsum_packed")
    if len(cfgs) != 6 or others \
            or launches["ldpc_minsum_packed"] != n_minsum * n_points:
        raise AssertionError(f"decoder study launches: {launches}")
    for c, b in zip(cfgs, blers):
        if len(b) != n_points or not all(0.0 <= x <= 1.0 for x in b) \
                or not b[0] > b[-1]:
            raise AssertionError(f"decoder study {c['name']}: BLER {b}")
    # the CPU runs the plain decoder on the same draws
    one = dict(cfg, algo_list=cfg["algo_list"][1:], snr_db_list=[-0.5])
    on_card = study.run_ldpc_simulation(**one, filename=None, n_trials=400,
                                        device=DEV)[2]
    on_cpu = study.run_ldpc_simulation(**one, filename=None, n_trials=400,
                                       device="cpu")[2]
    if on_card != on_cpu:
        raise AssertionError(f"decoder study: card {on_card} != CPU {on_cpu}")
    # mixed-MS (0.8, 0.3), Zc 10, L 32, -0.5 dB: the band of
    # tests/test_ldpc.py:test_bler_baseline_mixed_ms (reference 0.070)
    rng = np.random.default_rng(42)
    blk, llr = study.gen_ldpc_llr_batch(rng, 10, 1, -0.5, 800, device=DEV)
    anchor = study.decode_batch(llr, blk, 10, 1, 32, "min-sum", 0.8, 0.3,
                                device=DEV) / 800
    if not 0.038 <= anchor <= 0.105:
        raise AssertionError(f"mixed-MS BLER {anchor} outside 0.038..0.105")
    # the fast check node stays on the exact curve: |z| <= 3 at 4000 trials
    fast_vs_exact = []
    for snr in (-1.0, -0.5, 0.0):
        blk, llr = study.gen_ldpc_llr_batch(rng, 10, 1, snr, 4000, device=DEV)
        p = [study.decode_batch(llr, blk, 10, 1, 32, "min-sum", 0.8, 0.3,
                                semantics=sem, device=DEV) / 4000
             for sem in ("exact", "fast")]
        z = _z_score(p[1], p[0], 4000)
        fast_vs_exact.append(dict(snr_db=snr, exact=p[0], fast=p[1], z=z))
        if not abs(z) <= 3.0:
            raise AssertionError(f"fast check node off the exact curve: "
                                 f"{fast_vs_exact[-1]}")
    emit("ldpc_study", zc=cfg["zc"], bgn=cfg["bgn"], n_trials=400,
         snr_db=cfg["snr_db_list"], wall_s=wall,
         codewords_per_s=400 * n_points * len(cfgs) / wall,
         launches=launches,
         bler={f"{c['name']} a={c['alpha']} b={c['beta']}": b
               for c, b in zip(cfgs, blers)},
         cpu_equal_at_minus_0_5_db=on_cpu, mixed_ms_zc10_l32=anchor,
         fast_vs_exact=fast_vs_exact)
    return launches["ldpc_minsum_packed"]


def phase_ldpc_bf() -> None:
    """ldpc_decode_bf on the card equal to the CPU result at the shape of
    scripts/sim_ldpc_decoder_bf.py (BG2, Zc 16, 400 codewords, L 10 and
    20)."""
    zc, bgn, batch, snr = 16, 2, 400, 5.0
    rng = np.random.default_rng(5)
    bc, dn = study.coded_blocks(rng, zc, bgn, batch, "24A", DEV)
    full = np.concatenate([bc[:, :2 * zc], dn], axis=-1)
    llr = ((1 - 2 * full) + rng.normal(0, 10 ** (-snr / 20), full.shape)
           ).astype(np.float32)
    on_card = torch.as_tensor(llr, device=DEV)
    out = []
    for n_iter in (10, 20):
        bits, ok = ldpc_dec.ldpc_decode_bf(on_card, zc, bgn, n_iter)
        bits_c, ok_c = ldpc_dec.ldpc_decode_bf(torch.as_tensor(llr), zc, bgn,
                                               n_iter)
        if not (torch.equal(bits.cpu(), bits_c)
                and torch.equal(ok.cpu(), ok_c)):
            raise AssertionError(f"bit flipping L={n_iter}: card != CPU")
        ms = call_ms(lambda: ldpc_dec.ldpc_decode_bf(on_card, zc, bgn,
                                                     n_iter), 3)
        bler = float(np.mean(np.any(bits_c.numpy()[:, :10 * zc] != bc,
                                    axis=-1)))
        out.append(dict(L=n_iter, ms=ms, converged=int(ok_c.sum()),
                        bler=bler))
    if not 0 < out[1]["converged"] <= batch or out[1]["bler"] > out[0]["bler"]:
        raise AssertionError(f"bit flipping: {out}")
    emit("ldpc_bf", zc=zc, bgn=bgn, batch=batch, snr_db=snr, runs=out)


def phase_waveforms() -> dict:
    """gen_dl_waveform at 245.76 Msps on the two branches the sweep does
    not take: with a timing error Dm (OFDM apart, then fir_up2_fused) and
    at scs 15 / BW 5 (nfft 512: fir_up2_fused_symbols), each held against
    the plain versions. Returns the launches of those two kernels."""
    carrier, pdsch, _, _, _ = sim.bench_link_level_config()
    n_slots, out = 20, {}
    wf = dict(numofslots=n_slots, startSFN=0, startslot=0,
              samplerate_in_mhz=245.76)
    hb = filters.halfband_coeff()

    nr_pdsch = Pdsch(pdsch, carrier, rng=np.random.default_rng(7), device=DEV)
    kernels.reset_launches()
    _, td, dl, _ = dl_wf.gen_dl_waveform(
        wf, carrier, [nr_pdsch], Dm=np.full((n_slots, 14), 2e-9))
    torch.cuda.synchronize()
    out["fir_up2_fused"] = kernels.LAUNCHES["fir_up2_fused"]
    shape_dm = list(dl.shape)
    ref = filters.fir_up2_fused_plain(
        torch.cat([td.real, td.imag]), filters.fir_coeff(30, 20), hb)
    for _ in range(2):
        ref = filters.banded_fir_plain(ref, hb, "up2")
    err_dm = _check("gen_dl_waveform", "with Dm", dl,
                    torch.complex(ref[:2], ref[2:]))

    # the DDC on that waveform against its plain stages: three halfband
    # down2, then the FIR
    ddc = filters.rx_channel_filter(dl, 30, 20, 245.76e6)
    ref = torch.cat([dl.real, dl.imag])
    for _ in range(3):
        ref = filters.banded_fir_plain(ref, hb, "down2")
    ref = filters.banded_fir_plain(ref, filters.fir_coeff(30, 20), "same")
    err_ddc = _check("rx_channel_filter", "245.76 Msps", ddc,
                     torch.complex(ref[:2], ref[2:]))

    carrier15 = dict(carrier, scs=15, BW=5)
    nr_pdsch = Pdsch(pdsch, carrier15, rng=np.random.default_rng(8),
                     device=DEV)
    kernels.reset_launches()
    fd, _, dl, _ = dl_wf.gen_dl_waveform(wf, carrier15, [nr_pdsch])
    torch.cuda.synchronize()
    out["fir_up2_fused_symbols"] = kernels.LAUNCHES["fir_up2_fused_symbols"]
    # fd is the unrolled grid; the waveform was made from the rolled one
    grid = torch.roll(fd.reshape(2, n_slots, 14, -1), -1, dims=0)
    ref = _plain_duc(grid, 15, 5, int(carrier15["carrier_frequency_in_mhz"]
                                      * 1e6), 245.76e6)
    err_15 = _check("gen_dl_waveform", "scs 15, BW 5", dl, ref)
    for name, count in out.items():
        if count <= 0:
            raise AssertionError(f"gen_dl_waveform never launched {name}")
    emit("waveforms_245", launches=out, dl_shape_dm=shape_dm,
         dl_shape_scs15=list(dl.shape), max_abs_err_dm=err_dm,
         max_abs_err_ddc=err_ddc, max_abs_err_scs15=err_15)
    return out


def main() -> None:
    rng = np.random.default_rng(2024)
    phase_device()
    rows = dict(banded_fir=phase_fir(rng), ldpc_minsum_flooded=phase_ldpc(rng))
    rows.update(phase_duc_kernels(rng))
    rows["ldpc_minsum_packed"] = phase_ldpc_packed(rng)
    phase_ldpc_layout(rng)
    bench_rows, bench_launches = phase_ldpc_variants(rng)
    launches = phase_sweep()
    launches["duc_from_spec"] = phase_duc(rows)
    phase_sweep_245()
    launches.update(phase_waveforms())
    launches["ldpc_minsum_packed"] = \
        phase_sweep_small_alloc()["ldpc_minsum_packed"]
    phase_ldpc_study()
    phase_ldpc_bf()
    for name in ("ldpc_minsum_flooded_fast", "ldpc_minsum_layered",
                 "ldpc_minsum_layered_fast"):
        rows[name] = bench_rows[name]
        launches[name] = bench_launches[name]
    csrc = "python_5gtoolbox_tpu_torch/csrc/"
    tpu = "python_5gtoolbox_tpu/ops/"
    table = []
    # launches: banded_fir and ldpc_minsum_flooded in the carrier-rate
    # sweep, duc_from_spec in the OFDM + DUC run, the two other DUC kernels
    # in their gen_dl_waveform call, ldpc_minsum_packed in the
    # small-allocation sweep, the other variants of ldpc_minsum in the
    # decoder bench through ldpc_decode
    for name, src, replaces in [
            ("banded_fir", "banded_fir.cu", "pallas_filters.py:93"),
            ("ldpc_minsum_flooded", "ldpc_minsum.cu",
             "ldpc/pallas_decode.py:138"),
            ("ldpc_minsum_flooded_fast", "ldpc_minsum.cu",
             "ldpc/pallas_decode.py:138"),
            ("ldpc_minsum_layered", "ldpc_minsum.cu",
             "ldpc/pallas_decode.py:138"),
            ("ldpc_minsum_layered_fast", "ldpc_minsum.cu",
             "ldpc/pallas_decode.py:138"),
            ("ldpc_minsum_packed", "ldpc_minsum_packed.cu",
             "ldpc/pallas_decode.py:231"),
            ("fir_up2_fused", "fir_up2_fused.cu", "pallas_filters.py:223"),
            ("fir_up2_fused_symbols", "fir_up2_fused_symbols.cu",
             "pallas_filters.py:368"),
            ("duc_from_spec", "duc_from_spec.cu", "pallas_filters.py:581")]:
        row = rows[name]
        table.append(dict(name=name, route="cuda", source=csrc + src,
                          replaces=tpu + replaces, launches=launches[name],
                          max_abs_err=row["max_abs_err"],
                          ms=row["kernel_ms"], plain_ms=row["plain_ms"],
                          bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                          library_ms=row["library_ms"]))
    emit("summary", **SUMMARY)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
