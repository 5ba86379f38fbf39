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
    Msps (spectrum DUC, halfband up/down stages, FIR, LDPC), and
    gen_dl_waveform with a timing error (flat fused FIR + halfband) at BW
    20 and at full width (scs 30 / BW 100, 273 RBs), and on the three
    carriers below nfft 1024 (symbol DUC kernel: scs 15 / BW 5, scs 30 /
    BW 10, scs 30 / BW 5);
  * the sweep on a small allocation (MCS 0, 12 RBs: Zc 80), whose decode
    goes through the small-lifting LDPC kernel;
  * the uplink: the transform-precoded PUSCH sweep at its bench
    configuration (bench.py:bench_link_level_pusch_tp: BW 20, 1x2, 48 RBs,
    DFT-s-OFDM; banded FIR on 2 and 4 planes, LDPC at BG2 / Zc 288), the
    same sweep in CP-OFDM, each with a clean 30 dB point decoded exactly,
    and gen_ul_waveform at the default UL configuration (BW 40, 100 RBs,
    256QAM, 20 slots, 122.88 Msps) through both of its branches (the
    spectrum DUC kernel, and OFDM then the flat fused FIR + halfband);
  * UCI on PUSCH (HARQ-ACK, CSI parts 1 and 2, polar and small-block
    coded) at the carrier rate on the CP-OFDM UL sweep's configuration:
    gen_ul_waveform's per-slot branch, the channel and the batched UCI
    RX (banded FIR, LDPC), every TB and UCI stream exact at 30 dB; the
    per-slot branch at the default UL configuration with UCI (the flat
    fused FIR + halfband at 122.88 Msps); the polar SCL decoder at
    bench.py's three shapes and the polar decoder BLER study
    (scripts/sim_polar_decoder.py), equal to the CPU's results (plain
    PyTorch: the JAX package has no Pallas kernel for them);
  * the other DL channels and the NR-FR1 test models: the five test
    models at full width (scs 30 / BW 100 / TDD, 40 slots at 122.88 Msps:
    per-slot SSB / CSI-RS / PDCCH / PDSCH into one frame grid, then the
    287-tap FIR), sim/gen_nr_testmodel.py at its own constants, all four
    DL channels together at 245.76 Msps (flat fused FIR + halfband, then
    one halfband stage), the standalone SSB waveform and the CSI report
    (plain PyTorch), each held against the plain chain or the CPU;
  * UL control and PRACH: a PUSCH, PUCCH formats 0-4 and a 4-port SRS
    through the composed gen_ul_waveform at full width (scs 30 / BW 100,
    4 antennas, 20 slots at 245.76 Msps: the flat fused FIR + halfband),
    gen_prach_waveform for a long and a short preamble at 245.76 Msps
    (three banded_fir up2 stages with the 56-tap halfband, every SFN in
    one launch), and sim/nr_csirs_report_example.py, each held against
    the plain chain and the CPU;
  * the fading channel (csrc/fading_channel.cu) at the TDL cells'
    channel (TDL-A 30 ns, fm 10 Hz, 23 paths, 2x4) at one slot and one
    20-slot point of 122.88 Msps, against the plain per-path loop, beside
    its bound;
  * parallelism on torch.distributed: 2 gloo ranks sharing the card
    (spawned after the kernels are built) run the time-sharded TX and RX
    channel filters at full width, tp_ml2 on one bench slot, the
    pipelined TX waveform, the slot-sharded batched RX and
    dryrun_multichip(2), each gathered result held against the single
    rank's path on the card;
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
symbol for duc_from_spec (ops/filters.py:duc_plan), outputs per thread,
blocks and staging for fir_up2_fused (fused_plan), symbols per
block and copy runs for fir_up2_fused_symbols (fused_symbols_plan). The
FIR's library call (cuDNN) is timed as device time too.

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
import tempfile
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device available")

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from python_5gtoolbox_tpu_torch import kernels  # noqa: E402
from python_5gtoolbox_tpu_torch.interop import state_from_numpy  # noqa: E402
from python_5gtoolbox_tpu_torch.models import channel as chan_mod  # noqa: E402
from python_5gtoolbox_tpu_torch.ops import filters, ofdm, polar  # noqa: E402
from python_5gtoolbox_tpu_torch.ops.ldpc import decode as ldpc_dec  # noqa: E402
from python_5gtoolbox_tpu_torch.ops.ldpc import sch_plan  # noqa: E402
from python_5gtoolbox_tpu_torch.ops.ldpc.encode import ldpc_encode  # noqa: E402
from python_5gtoolbox_tpu_torch.ops.modulation import QM_TABLE  # noqa: E402
from python_5gtoolbox_tpu_torch.phy import csirs_report  # noqa: E402
from python_5gtoolbox_tpu_torch.phy.csirs import NrCSIRS  # noqa: E402
from python_5gtoolbox_tpu_torch.phy.pdsch import Pdsch  # noqa: E402
from python_5gtoolbox_tpu_torch.phy import prach  # noqa: E402
from python_5gtoolbox_tpu_torch.phy.pusch import NrPUSCH  # noqa: E402
from python_5gtoolbox_tpu_torch.phy.pdsch_rx import copy_rx_pdsch_resource  # noqa: E402
from python_5gtoolbox_tpu_torch.phy.ssb import NrSSB  # noqa: E402
from python_5gtoolbox_tpu_torch.rx import ce_batch  # noqa: E402
from python_5gtoolbox_tpu_torch.rx import equalize as teq  # noqa: E402
from python_5gtoolbox_tpu_torch.rx.batch_core import data_re_layout  # noqa: E402
from python_5gtoolbox_tpu_torch.rx.channel_estimate import NrChannelEstimation  # noqa: E402
from python_5gtoolbox_tpu_torch.sim import ldpc_decoder as study  # noqa: E402
from python_5gtoolbox_tpu_torch.sim import pdsch_throughput as sim  # noqa: E402
from python_5gtoolbox_tpu_torch.sim import polar_decoder as pstudy  # noqa: E402
from python_5gtoolbox_tpu_torch.utils.profiling import StageProfiler  # noqa: E402
from python_5gtoolbox_tpu_torch.sim import pusch_throughput as usim  # noqa: E402
from python_5gtoolbox_tpu_torch.sim import gen_nr_testmodel as tm_script  # noqa: E402
from python_5gtoolbox_tpu_torch.sim import nr_pdsch_throughput_example as pdsch_ex  # noqa: E402
from python_5gtoolbox_tpu_torch.sim import nr_pusch_throughput_example as pusch_ex  # noqa: E402
from python_5gtoolbox_tpu_torch.sim import nr_csirs_report_example as csirs_ex  # noqa: E402
from python_5gtoolbox_tpu_torch.utils.config import (  # noqa: E402
    get_default_config, merged)
from python_5gtoolbox_tpu_torch.sim.time_ldpc_kernels import (  # noqa: E402
    call_ms, device_ms, never_converging_llrs)
from python_5gtoolbox_tpu_torch.waveform import dl as dl_wf  # noqa: E402
from python_5gtoolbox_tpu_torch.waveform import ul as ul_wf  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DEV = torch.device("cuda")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM data sheet, FP32 outside tensor cores
FIR_TOL = 1.2e-4               # tests/test_pallas_filters.py tolerance
SUMMARY: dict = {}             # end-to-end rates, printed again near the end


def emit(phase: str, **kw) -> None:
    print(json.dumps(dict(phase=phase, **kw)), flush=True)


def _stage_s(prof: StageProfiler) -> dict:
    """Seconds per stage (CUDA events, resolved here)."""
    return {k: s.seconds for k, s in prof.stats.items()}


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


def _fir_row(x, taps, mode: str, label: str) -> dict:
    """banded_fir on planes x against banded_fir_plain and the library
    call; kernel and library timed as device time of back-to-back calls
    (device_ms), the kernel also as consecutive calls with the host's
    share (call_ms). Emits and returns the banded_fir line."""
    p, t = x.shape
    plan = filters.fir_plan(len(taps), mode, t, p, x.data_ptr() % 16 == 0)
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

    def run():
        return filters.banded_fir(x, taps, mode)
    k_ms, c_ms = device_ms(run, 20), call_ms(run, 20)
    p_ms = call_ms(lambda: filters.banded_fir_plain(x, taps, mode), 10)
    lib = _library_fir(x, taps, mode)
    lib_out = lib()[:, 0, :got.shape[1]]
    lib_err = (lib_out - ref[:, :lib_out.shape[1]]).abs().max().item()
    if not lib_err < FIR_TOL or lib_out.shape[1] < got.shape[1] - 1:
        raise AssertionError(f"library FIR {mode} {label}: not the "
                             f"same function ({lib_err})")
    l_ms = device_ms(lib, 20)
    n, t_out = len(taps), got.shape[1]
    b_ms, b_by = bound_ms(4 * (p * t + p * t_out + n),
                          2 * n * p * t_out * (0.5 if mode == "up2"
                                               else 1.0))
    row = dict(label=label, mode=mode, shape=[p, t], taps=n,
               max_abs_err=err, kernel_ms=k_ms, call_ms=c_ms,
               plain_ms=p_ms, library_ms=l_ms,
               library_max_abs_err=lib_err, bound_ms=b_ms,
               bound_by=b_by, plan=_fir_plan_row(plan))
    emit("banded_fir", **row)
    return row


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
              "ragged, unaligned base", all_modes),
             # the UL sweep's TX FIR (1 antenna; its RX, 2 antennas, is
             # the 4x307200 shape above)
             ((2, 307200), filters.fir_coeff(30, 20), "UL TX FIR, BW 20",
              ("same",)),
             # the full-width test models' FIR (scs 30 / BW 100, 40 slots
             # at 122.88 Msps, 1 antenna)
             ((2, 2457600), filters.fir_coeff(30, 100), "TM FIR, BW 100",
              ("same",))]
    for shape, taps, label, modes in cases:
        p, t = shape
        flat = torch.as_tensor(rng.standard_normal(p * t + 1,
                                                   dtype=np.float32),
                               device=DEV)
        x = (flat[1:] if label.startswith("ragged") else flat[:-1]).view(p, t)
        for mode in modes:
            row = _fir_row(x, taps, mode, label)
            worst = max(worst, row["max_abs_err"])
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
    # converge, a large batch, BG1 at the largest lifting, a point where
    # none converges (all 16 iterations and the final rule), and the UL
    # sweep's code (TBS 2600: BG2, Zc 288, 20 codewords)
    for zc, bgn, batch, snr in [(352, 2, 20, -2.0), (352, 2, 256, -2.0),
                                (384, 1, 20, 0.0), (352, 2, 20, -6.0),
                                (288, 2, 20, -2.0)]:
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
    plan = filters.fused_plan(p, t, len(fir), len(hb))
    n_bytes = 4 * (3 * p * t + len(fir) + len(hb))
    return ("fir_up2_fused", label, kern, plain, n_bytes,
            _fused_ops(len(fir), len(hb), p, t),
            dict(shape=list(shape), taps=len(fir),
                 plan=dict(per=plan.geometry.per, lead=plan.geometry.lead,
                           nz_tile=plan.geometry.nz_tile,
                           blocks=plan.blocks,
                           vec=plan.vec, smem_bytes=plan.smem_bytes)))


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
    plan = filters.fused_symbols_plan(p, n_slots, nfft, len(fir), len(hb),
                                      tuple(int(c) for c in cps))
    n_bytes = 4 * (symp.numel() + 2 * p * t + len(fir) + len(hb))
    return ("fir_up2_fused_symbols", f"scs {scs}, BW {bw}, {n_slots} slots",
            kern, plain, n_bytes, _fused_ops(len(fir), len(hb), p, t),
            dict(shape=list(symp.shape), taps=len(fir),
                 plan=dict(group=plan.group, lead=plan.geometry.lead,
                           blocks=plan.blocks,
                           runs=sum(len(r) for r in plan.runs),
                           vec_runs=sum(r[4] & 1 for rs in plan.runs
                                        for r in rs),
                           smem_bytes=plan.smem_bytes)))


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
        # the main path's shape first: the full-width Dm waveform
        _case_fused(rng, (4, 1228800), 30, 100, "Dm waveform, BW 100"),
        _case_fused(rng, (4, 307200), 30, 20, "Dm waveform, BW 20"),
        _case_fused(rng, (4, 3932160), 30, 100, "287 taps, 64 slots BW 100"),
        _case_fused(rng, (2, 15360), 30, 20, "1 slot, BW 20"),
        _case_symbols(rng, 15, 5, 2, 20),
        _case_symbols(rng, 30, 10, 2, 20),
        _case_symbols(rng, 30, 5, 2, 20),
        _case_symbols(rng, 30, 5, 2, 1),
        _case_spec(_random_grid(rng, 30, 20, 2, 20), 30, 20),   # sweep_245
        _case_spec(_random_grid(rng, 30, 40, 2, 8), 30, 40),
        _case_spec(_random_grid(rng, 30, 100, 2, 8), 30, 100),
        _case_spec(_random_grid(rng, 30, 100, 2, 1), 30, 100),
        # 42 symbols: the grid padded to whole clusters, at the default
        # size and at the largest (non-portable) one
        _case_spec(_random_grid(rng, 30, 20, 2, 3), 30, 20),
        _case_spec(_random_grid(rng, 30, 20, 2, 3), 30, 20, cluster=16),
        # gen_ul_waveform at the default UL configuration (BW 40, nfft
        # 2048, 143 taps, 1 antenna, 20 slots): the td branch's stage, the
        # same at twice the rows, and the fused branch's spectrum DUC
        _case_fused(rng, (2, 614400), 30, 40, "UL waveform, BW 40"),
        _case_fused(rng, (2, 1228800), 30, 40, "BW 40, 40 slots"),
        _case_spec(_random_grid(rng, 30, 40, 1, 20), 30, 40),
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


DL = (sim.run_pdsch_throughput, sim.pdsch_before_ceq_processing)
UL = (usim.run_pusch_throughput, usim.pusch_before_ceq_processing)


def _sweep(phase: str, rate_mhz, expected,
           config=sim.bench_link_level_config,
           snrs=(0.0, 1.0, 2.0, 3.0, 4.0, 5.0), link=DL) -> dict:
    """A link-level sweep (the PDSCH bench configuration unless config and
    link say otherwise; 6 SNR points x 20 slots, warm) at the carrier rate
    or at rate_mhz, then a clean 30 dB point that must decode exactly.
    Returns the timed sweep's launch counts. expected: the kernels that
    must have been launched, or a dict of exact counts. link: the sweep's
    (run, before_ceq_processing) pair, DL (PDSCH) or UL (PUSCH)."""
    run, before = link
    carrier, ch_cfg, chan, ce, ldpc = config()
    if rate_mhz is not None:
        carrier["samplerate_in_mhz"] = rate_mhz
    snrs = list(snrs)
    n_slots = 20
    kw = dict(ceq_algo_list=["MMSE-IRC"], n_slots=n_slots, ce_config=ce,
              ldpc_config=ldpc, seed=3, device=DEV)
    t0 = time.perf_counter()
    run(carrier, ch_cfg, chan, snrs, **kw)                       # warm
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = run(carrier, ch_cfg, chan, snrs, **kw)
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
    trblks = np.random.default_rng(30).integers(
        0, 2, (n_slots, res["tbs_bits"]), dtype=np.int8)
    obj, slots, rx_fd = before(
        carrier, ch_cfg, chan, -30.0, n_slots, seed=30, device=DEV,
        state=state_from_numpy(trblks=trblks, device=DEV))
    nr = carrier["Nr"]
    n_sc = rx_fd.shape[1] // (n_slots * 14)
    if tuple(rx_fd.shape) != (nr, n_slots * 14 * n_sc) \
            or not torch.isfinite(torch.view_as_real(rx_fd)).all():
        raise AssertionError(f"rx grid has shape {tuple(rx_fd.shape)} or "
                             f"non-finite values")
    stack = rx_fd.reshape(nr, n_slots, -1).transpose(0, 1)
    ok, tbblk = obj.rx_process_batch(
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


def phase_sweep_pusch_tp() -> dict:
    """The transform-precoded UL sweep at its bench configuration
    (bench.py:bench_link_level_pusch_tp: 1 TX x 2 RX, 48 RBs, MCS 2 of
    MCStable61411, TBS 2600 = one BG2 code block at Zc 288): per SNR point
    one TX FIR on 2 planes, one RX FIR on 4, one decode of 20 codewords."""
    return _sweep("sweep_pusch_tp", None,
                  dict(banded_fir=12, ldpc_minsum_flooded=6,
                       ldpc_minsum_packed=0),
                  config=usim.bench_link_level_pusch_tp_config, link=UL)


def _pusch_cp_config():
    carrier, pusch, chan, ce, ldpc = usim.bench_link_level_pusch_tp_config()
    pusch["nTransPrecode"] = 0
    return carrier, pusch, chan, ce, ldpc


def phase_sweep_pusch_cp() -> dict:
    """The same sweep in CP-OFDM, at 2 SNR points."""
    return _sweep("sweep_pusch_cp", None,
                  dict(banded_fir=4, ldpc_minsum_flooded=2,
                       ldpc_minsum_packed=0),
                  config=_pusch_cp_config, snrs=(0.0, 5.0), link=UL)


def phase_waveform_ul() -> dict:
    """gen_ul_waveform at the default UL configuration (BW 40 / scs 30,
    nfft 2048, PUSCH on 100 RBs, 256QAM MCS 20, 1 antenna port, 20 slots,
    122.88 Msps) through both branches, each against the plain versions:
    return_device=False (OFDM, slot phase, then fir_up2_fused with 143 + 55
    taps on 2x614400 planes) and return_device=True (duc_from_spec from
    the spectrum); the two branches' waveforms agree. Returns the launches
    of the two kernels."""
    carrier = get_default_config("ul_carrier")
    pusch = merged(get_default_config("pusch"),
                   dict(nNrOfAntennaPorts=1, nPMI=0))
    wf = get_default_config("ul_waveform")
    scs, bw = carrier["scs"], carrier["BW"]
    fc = int(carrier["carrier_frequency_in_mhz"] * 1e6)
    rate = wf["samplerate_in_mhz"] * 1e6
    fir, hb = filters.fir_coeff(scs, bw), filters.halfband_coeff()
    out, uls, rows = {}, {}, []
    for return_device, kernel in ((False, "fir_up2_fused"),
                                  (True, "duc_from_spec")):
        def run():
            ch = NrPUSCH(carrier, pusch, rng=np.random.default_rng(21),
                         device=DEV)
            return ul_wf.gen_ul_waveform(wf, carrier, [ch],
                                         return_device=return_device)
        kernels.reset_launches()
        fd, td, ul = run()
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        if launches[kernel] != 1 or sum(launches.values()) != 1:
            raise AssertionError(f"gen_ul_waveform(return_device="
                                 f"{return_device}) launches {launches}")
        out[kernel] = launches[kernel]
        if return_device:
            grid = fd.reshape(1, wf["numofslots"], 14, -1)
            ref = _plain_duc(grid, scs, bw, fc, rate)
        else:
            y = filters.fir_up2_fused_plain(torch.cat([td.real, td.imag]),
                                            fir, hb)
            ref = torch.complex(y[:1], y[1:])
        err = _check("gen_ul_waveform", f"return_device={return_device}",
                     ul, ref)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        rows.append(dict(return_device=return_device, kernel=kernel,
                         launches=launches[kernel], ul_shape=list(ul.shape),
                         td_shape=None if td is None else list(td.shape),
                         max_abs_err=err,
                         warm_ms=(time.perf_counter() - t0) * 1e3))
        uls[return_device] = ul
        del ref
    err = _check("gen_ul_waveform", "branch against branch", uls[True],
                 uls[False])
    emit("waveform_ul", n_slots=wf["numofslots"], bw=bw, rbs=pusch[
        "ResAlloType1"]["RBSize"], tbs_bits=NrPUSCH(
            carrier, pusch, device=DEV).tbsize, rate_mhz=rate / 1e6,
         branches=rows, max_abs_err_between_branches=err)
    return out


# ---------------------------------------------------------------------------
# UCI on PUSCH and the polar decoder. The polar decoder and the UCI code
# are plain PyTorch (the JAX package has no Pallas kernel for them); the
# UCI path runs banded_fir, ldpc_minsum and fir_up2_fused.
# ---------------------------------------------------------------------------

# pusch_slot2 case 6 (polar ACK and CSI1, Reed-Muller CSI2) and the
# small-block case of tests/test_batch_rx_uci.py (2-bit special table
# with the x/y placeholders, Reed-Muller CSI1)
UCI_CONFIGS = {
    "ack14_csi1_25_csi2_4": dict(
        EnableACK=1, NumACKBits=14,
        ACKbits=[1, 0, 1, 1, 0, 0, 1, 0, 1, 1, 1, 0, 0, 1],
        EnableCSI1=1, NumCSI1Bits=25, CSI1bits=[1, 0] * 12 + [1],
        EnableCSI2=1, NumCSI2Bits=4, CSI2bits=[0, 1, 1, 0]),
    "ack2_csi1_5": dict(
        EnableACK=1, NumACKBits=2, ACKbits=[1, 0], EnableCSI1=1,
        NumCSI1Bits=5, CSI1bits=[1, 0, 1, 1, 0], EnableCSI2=0,
        NumCSI2Bits=0),
}
_UCI_FIELDS = (("ack", "ACKbits"), ("csi1", "CSI1bits"), ("csi2", "CSI2bits"))
UCI_SNRS = [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]
UCI_SLOTS = 20


def _uci_exact(uci, pusch, n_slots) -> dict:
    """Per stream: slots whose bits equal what was sent and whose ok is
    set."""
    out = {}
    for name, field in _UCI_FIELDS:
        if name in uci:
            bits, ok = uci[name]
            out[name] = int((np.all(bits == np.asarray(pusch[field]), axis=1)
                             & ok).sum())
    return out


def phase_pusch_uci() -> dict:
    """UCI on PUSCH at the carrier rate on the CP-OFDM UL sweep's
    configuration (bench.py:327 with nTransPrecode 0: BW 20, scs 30, 1x2,
    48 RBs, MCS 2 of MCStable61411, NumCDM 2, DMRSAddPos 1), for both UCI
    configurations: gen_ul_waveform's per-slot branch (20 slots; one
    banded_fir on the TX), the Rayleigh channel at fm 200 Hz, the RX
    front end (one banded_fir) and the batched UCI RX with MMSE-IRC (one
    ldpc_minsum flooded decode of the 20 slots' UL-SCH), at 0..5 dB
    (warm, timed per stage), then at 30 dB: every TB and every UCI
    stream exact. Returns the timed run's launches, summed."""
    total = {}
    snrs, n_slots = UCI_SNRS, UCI_SLOTS
    for name, uci in UCI_CONFIGS.items():
        carrier, pusch, chan, ce, ldpc = _pusch_cp_config()
        pusch.update(uci)
        ce_cfg = sim._ce_config(ce, chan, carrier["scs"])
        nr = carrier["Nr"]

        def point(snr, seed, timer, state=None):
            obj, slots, rx_fd = usim.pusch_before_ceq_processing(
                carrier, pusch, chan, -snr, n_slots, seed=seed, device=DEV,
                state=state, prof=timer)
            stack = rx_fd.reshape(nr, n_slots, -1).transpose(0, 1)
            with timer.stage("rx_batch"):
                out = obj.rx_process_batch(stack, slots, {"algo": "MMSE-IRC"},
                                           ldpc, ce_cfg)
            return obj, out

        for i, snr in enumerate(snrs):                            # warm
            point(snr, 3 + 7919 * i, StageProfiler(DEV))
        kernels.reset_launches()
        rows = []
        for i, snr in enumerate(snrs):
            timer = StageProfiler(DEV)
            _, (ok, _, dec) = point(snr, 3 + 7919 * i, timer)
            ms = {k: v * 1e3 for k, v in _stage_s(timer).items()}
            rows.append(dict(snr_db=snr, tb_passed=int(ok.sum()),
                             uci_exact=_uci_exact(dec, pusch, n_slots),
                             tx_ms=ms["tx_waveform"], channel_ms=ms["channel"],
                             rx_ms=ms["rx_lowphy"] + ms["rx_batch"],
                             stage_ms=ms))
        launches = dict(kernels.LAUNCHES)
        want = dict(banded_fir=2 * len(snrs),
                    ldpc_minsum_flooded=len(snrs), fading_channel=len(snrs))
        if any(launches[k] != v for k, v in want.items()) \
                or sum(launches.values()) != sum(want.values()):
            raise AssertionError(f"pusch_uci {name} launches {launches}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

        trblks = np.random.default_rng(30).integers(
            0, 2, (n_slots, NrPUSCH(carrier, pusch, device=DEV).tbsize),
            dtype=np.int8)
        obj, (ok, tbblk, dec) = point(
            30.0, 30, StageProfiler(DEV),
            state=state_from_numpy(trblks=trblks, device=DEV))
        exact = _uci_exact(dec, pusch, n_slots)
        streams = [k for k, f in _UCI_FIELDS if pusch.get(
            {"ack": "EnableACK", "csi1": "EnableCSI1",
             "csi2": "EnableCSI2"}[k])]
        emit("pusch_uci", config=name, tbs_bits=obj.tbsize,
             g_ulsch=int(obj.uci_plan(obj._dmrs_symlist())
                         ["ulsch_pos"].size),
             uci_bits={k: len(pusch[f]) for k, f in _UCI_FIELDS
                       if k in streams},
             n_slots=n_slots, points=rows, launches=launches,
             at_30db=dict(tb_passed=int(ok.sum()),
                          tb_bits_exact=bool(np.array_equal(tbblk, trblks)),
                          uci_exact=exact))
        if int(ok.sum()) != n_slots or not np.array_equal(tbblk, trblks) \
                or sorted(exact) != sorted(streams) \
                or any(v != n_slots for v in exact.values()):
            raise AssertionError(f"pusch_uci {name} at 30 dB: "
                                 f"{int(ok.sum())}/{n_slots} TBs, UCI "
                                 f"{exact}")
    return total


def phase_waveform_ul_uci() -> dict:
    """gen_ul_waveform at the default UL configuration (BW 40, 100 RBs,
    256QAM MCS 20, 1 antenna port, 20 slots, 122.88 Msps) with the ACK 5
    + CSI1 4 bits of pusch_slot2 case 5: the per-slot branch (process per
    slot, OFDM, slot phase, one fir_up2_fused on 2x614400), held against
    the same chain with the plain filter. Returns its launches."""
    carrier = get_default_config("ul_carrier")
    pusch = merged(get_default_config("pusch"),
                   dict(nNrOfAntennaPorts=1, nPMI=0, EnableACK=1,
                        NumACKBits=5, ACKbits=[1, 0, 1, 1, 0], EnableCSI1=1,
                        NumCSI1Bits=4, CSI1bits=[1, 1, 0, 1]))
    wf = get_default_config("ul_waveform")

    def run():
        ch = NrPUSCH(carrier, pusch, rng=np.random.default_rng(22),
                     device=DEV)
        assert not ch.tx_batch_supported()
        return ul_wf.gen_ul_waveform(wf, carrier, [ch])
    kernels.reset_launches()
    fd, td, ul = run()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    if launches["fir_up2_fused"] != 1 or sum(launches.values()) != 1:
        raise AssertionError(f"gen_ul_waveform with UCI launches {launches}")
    y = filters.fir_up2_fused_plain(
        torch.cat([td.real, td.imag]),
        filters.fir_coeff(carrier["scs"], carrier["BW"]),
        filters.halfband_coeff())
    err = _check("gen_ul_waveform", "UCI, per-slot branch", ul,
                 torch.complex(y[:1], y[1:]))
    if not torch.isfinite(torch.view_as_real(fd)).all() \
            or not (fd != 0).any():
        raise AssertionError("gen_ul_waveform with UCI: empty or "
                             "non-finite grid")
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    emit("waveform_ul_uci", n_slots=wf["numofslots"], bw=carrier["BW"],
         rbs=pusch["ResAlloType1"]["RBSize"], uci_bits=dict(ack=5, csi1=4),
         rate_mhz=wf["samplerate_in_mhz"], fd_shape=list(fd.shape),
         td_shape=list(td.shape), ul_shape=list(ul.shape),
         launches=launches, max_abs_err=err,
         warm_ms=(time.perf_counter() - t0) * 1e3)
    return launches


class _OpCount(TorchDispatchMode):
    """Counts the ATen operations run under it (n) and those of them that
    write a CUDA tensor from a host tensor of one or more dimensions
    (h2d: copies and indexed writes of host-built values)."""

    def __init__(self):
        super().__init__()
        self.n = 0
        self.h2d = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        out = func(*args, **(kwargs or {}))
        if isinstance(out, torch.Tensor) and out.is_cuda and any(
                isinstance(a, torch.Tensor) and a.device.type == "cpu"
                and a.dim() > 0 for a in args):
            self.h2d += 1
        return out


def _kernels_per_call(fn):
    """CUDA kernels the profiler sees in one fn() (None if it sees none)."""
    try:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(1 for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA) or None
    except Exception as exc:                  # the profiler is optional here
        print(f"chip_smoke: profiler: {exc!r}", file=sys.stderr)
        return None


POLAR_SHAPES = [
    # bench.py:bench_polar_scl (DL scale, N 512), the UL UCI scale (N
    # 1024) and 64 PDCCH candidates with one RNTI each (bench.py:390-400)
    dict(name="n512", B=1024, K=164, E=512, L=8, n_max=9, i_il=1,
         crc_len=24),
    dict(name="n1024", B=512, K=512, E=1024, L=8, n_max=10, i_il=0,
         crc_len=11),
    dict(name="pdcch64", B=64, K=64, E=432, L=8, n_max=9, i_il=1,
         crc_len=24, rnti=True),
]


def phase_polar() -> None:
    """polar_decode_scl on the card at the three bench shapes on random
    LLRs (bench.py's stimulus, N-length here): the first call's ms (it
    captures the CUDA graph), warm ms, codewords/s, ATen operations per
    decode (the eager run's, which the graph holds) and the CUDA kernels
    one replay launches; the first 32 rows (all 64 candidates) decoded
    again on the CPU must give the same ck and ok."""
    rows = []
    for sh in POLAR_SHAPES:
        N, _ = polar.gen_n_value(sh["K"], sh["E"], sh["n_max"])
        rng = np.random.default_rng(2)
        llr = torch.as_tensor((rng.normal(size=(sh["B"], N)) * 2).astype(
            np.float32), device=DEV)
        rnti = torch.as_tensor(np.random.default_rng(5).integers(
            1, 65519, sh["B"]), device=DEV) if sh.get("rnti") else 0
        args = (sh["E"], sh["K"], sh["L"], sh["n_max"], sh["i_il"],
                sh["crc_len"], 0)

        def run():
            return polar.polar_decode_scl(llr, *args, rnti)
        t0 = time.perf_counter()
        run()                                   # warm: captures the graph
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ck, ok = run()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        _, dev_ms = _event_ms(run)
        # the operations the graph holds: the same decode run eagerly on
        # the CPU (their count does not depend on the batch)
        with _OpCount() as ops:
            polar.polar_decode_scl(
                llr[:2].cpu(), *args,
                rnti[:2].cpu() if torch.is_tensor(rnti) else rnti)
        counts = dict(aten_ops=ops.n, cuda_kernels=_kernels_per_call(run))
        n_cpu = min(sh["B"], 32 if sh["B"] > 64 else 64)
        ck_c, ok_c = polar.polar_decode_scl(
            llr[:n_cpu].cpu(), *args,
            rnti[:n_cpu].cpu() if torch.is_tensor(rnti) else rnti)
        equal = bool(torch.equal(ck[:n_cpu].cpu(), ck_c)
                     and torch.equal(ok[:n_cpu].cpu(), ok_c))
        row = dict(shape=sh["name"], B=sh["B"], K=sh["K"], E=sh["E"], N=N,
                   L=sh["L"], n_max=sh["n_max"], i_il=sh["i_il"],
                   crc_len=sh["crc_len"], per_row_rnti=torch.is_tensor(rnti),
                   first_call_ms=first_ms, warm_ms=ms, event_ms=dev_ms,
                   codewords_per_s=sh["B"] / (ms / 1e3),
                   per_decode=counts, crc_ok=int(ok.sum()),
                   cpu_rows=n_cpu, cpu_equal=equal)
        rows.append(row)
        emit("polar", **row)
        if not equal:
            raise AssertionError(f"polar {sh['name']}: card != CPU on the "
                                 f"first {n_cpu} rows")


def phase_polar_study() -> None:
    """sim/polar_decoder.py at scripts/sim_polar_decoder.py's constants
    (K 64, E 128, nMax 10, iIL 0, CRC11; SC, SCL L 8 and 32; 7 points x
    400 trials) on the card, then on the CPU: equal BLER."""
    args = (pstudy.K, pstudy.E, pstudy.N_MAX, pstudy.I_IL, pstudy.CRC_LEN,
            pstudy.ALGO_LIST, pstudy.L_LIST, pstudy.SNR_DB_LIST, None)
    t0 = time.perf_counter()
    _, cfgs, card = pstudy.run_polar_simulation(
        *args, n_trials=pstudy.N_TRIALS, device=DEV, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = pstudy.run_polar_simulation(*args, n_trials=pstudy.N_TRIALS,
                                      device="cpu", verbose=False)[2]
    cpu_wall = time.perf_counter() - t0
    emit("polar_study", n_trials=pstudy.N_TRIALS,
         snr_db=pstudy.SNR_DB_LIST, wall_s=wall, cpu_wall_s=cpu_wall,
         bler={f"{c['algo']} L={c['L']}": b for c, b in zip(cfgs, card)},
         cpu_equal=card == cpu)
    if card != cpu:
        raise AssertionError(f"polar study: card {card} != CPU {cpu}")
    for b in card:
        if not b[0] > b[-1]:
            raise AssertionError(f"polar study BLER does not fall: {card}")


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


def _gen_waveform(carrier, pdsch, n_slots, seed, kernel, dm=None):
    """gen_dl_waveform at 245.76 Msps on the card -> (fd, td, dl, launches
    of `kernel` in the checked run, warm wall ms of one more run)."""
    wf = dict(numofslots=n_slots, startSFN=0, startslot=0,
              samplerate_in_mhz=245.76)

    def run():
        nr_pdsch = Pdsch(pdsch, carrier, rng=np.random.default_rng(seed),
                         device=DEV)
        return dl_wf.gen_dl_waveform(wf, carrier, nrPdsch_list=[nr_pdsch],
                                      Dm=dm)
    kernels.reset_launches()
    fd, td, dl, _ = run()
    torch.cuda.synchronize()
    launches = kernels.LAUNCHES[kernel]
    if launches <= 0:
        raise AssertionError(f"gen_dl_waveform never launched {kernel}")
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return fd, td, dl, launches, (time.perf_counter() - t0) * 1e3


def phase_waveforms() -> dict:
    """gen_dl_waveform at 245.76 Msps on the two branches the sweep does
    not take, each held against the plain versions: with a timing error
    Dm (OFDM apart, then fir_up2_fused and the remaining halfband stages)
    at BW 20 and at full width (scs 30 / BW 100, 273 RBs: fir_up2_fused
    at 4x1228800 with 287 + 55 taps is the only filter stage), and without
    Dm on the three carriers below nfft 1024 (fir_up2_fused_symbols):
    scs 15 / BW 5, scs 30 / BW 10 and scs 30 / BW 5 (11 RBs, the PDSCH
    narrowed to them). Also the DDC on the BW 20 waveform against its plain
    stages. Returns the launches of the two kernels, summed over the
    cases."""
    carrier, pdsch, _, _, _ = sim.bench_link_level_config()
    n_slots, out, cases = 20, {"fir_up2_fused": 0,
                               "fir_up2_fused_symbols": 0}, []
    hb = filters.halfband_coeff()
    dm = np.full((n_slots, 14), 2e-9)

    for bw, rbs, seed in ((20, 20, 7), (100, 273, 9)):
        car = dict(carrier, BW=bw)
        pd = dict(pdsch, ResAlloType1=dict(pdsch["ResAlloType1"],
                                           RBSize=rbs))
        _, td, dl, n, ms = _gen_waveform(car, pd, n_slots, seed,
                                         "fir_up2_fused", dm)
        out["fir_up2_fused"] += n
        ref = filters.fir_up2_fused_plain(
            torch.cat([td.real, td.imag]), filters.fir_coeff(30, bw), hb)
        for _ in range(int(np.log2(filters._oversample(30, bw,
                                                       245.76e6))) - 1):
            ref = filters.banded_fir_plain(ref, hb, "up2")
        err = _check("gen_dl_waveform", f"with Dm, BW {bw}", dl,
                     torch.complex(ref[:2], ref[2:]))
        cases.append(dict(case=f"Dm, scs 30, BW {bw}, {rbs} RBs",
                          kernel="fir_up2_fused", launches=n,
                          td_shape=list(td.shape), dl_shape=list(dl.shape),
                          max_abs_err=err, warm_ms=ms))
        if bw == 20:
            # the DDC on that waveform against its plain stages: three
            # halfband down2, then the FIR
            ddc = filters.rx_channel_filter(dl, 30, 20, 245.76e6)
            ref = torch.cat([dl.real, dl.imag])
            for _ in range(3):
                ref = filters.banded_fir_plain(ref, hb, "down2")
            ref = filters.banded_fir_plain(ref, filters.fir_coeff(30, 20),
                                           "same")
            err_ddc = _check("rx_channel_filter", "245.76 Msps", ddc,
                             torch.complex(ref[:2], ref[2:]))
        del td, dl, ref

    for scs, bw, rbs, seed in ((15, 5, 20, 8), (30, 10, 20, 10),
                               (30, 5, 11, 11)):
        car = dict(carrier, scs=scs, BW=bw)
        pd = dict(pdsch, ResAlloType1=dict(pdsch["ResAlloType1"],
                                           RBSize=rbs))
        fd, _, dl, n, ms = _gen_waveform(car, pd, n_slots, seed,
                                         "fir_up2_fused_symbols")
        out["fir_up2_fused_symbols"] += n
        # fd is the unrolled grid; the waveform was made from the rolled one
        grid = torch.roll(fd.reshape(2, n_slots, 14, -1), -1, dims=0)
        ref = _plain_duc(grid, scs, bw, int(car["carrier_frequency_in_mhz"]
                                            * 1e6), 245.76e6)
        err = _check("gen_dl_waveform", f"scs {scs}, BW {bw}", dl, ref)
        cases.append(dict(case=f"scs {scs}, BW {bw}, {rbs} RBs",
                          kernel="fir_up2_fused_symbols", launches=n,
                          dl_shape=list(dl.shape), max_abs_err=err,
                          warm_ms=ms))
    emit("waveforms_245", launches=out, n_slots=n_slots, nant=2,
         cases=cases, max_abs_err_ddc=err_ddc)
    return out


def _tm_run(tm, device, seed=0, count_ops=False):
    """gen_dl_waveform of one test model at full width (scs 30, BW 100,
    TDD, cell 1, 3500 MHz: 40 slots at 122.88 Msps) on device, payloads
    from seed -> (fd, td, dl, PDSCH encodes, ATen operations or None)."""
    wf, carrier, lists = tm_script.tm_channel_lists(
        tm, tm_script.FULL_WIDTH, seed=seed, device=device)
    n_enc = sum(ch.is_active_slot(s) for ch in lists[1]
                for s in range(wf["numofslots"]))
    if not count_ops:
        return (*dl_wf.gen_dl_waveform(wf, carrier, *lists)[:3], n_enc, None)
    with _OpCount() as ops:
        out = dl_wf.gen_dl_waveform(wf, carrier, *lists)
    return (*out[:3], n_enc, ops.n)


def _warm_ms(fn, reps: int = 3) -> list:
    """Wall ms of reps synchronised calls of fn (the host-bound paths'
    spread shows between them)."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def phase_testmodels() -> dict:
    """The five NR-FR1 test models at full width (gen_nr_tm_cfg at scs 30
    / BW 100 / TDD / cell 1 / 3500 MHz: 40 slots, 1 antenna, 122.88 Msps)
    through gen_dl_channel_list and gen_dl_waveform on the card, payloads
    from seed 0: per TM exactly one banded_fir launch (the 287-tap FIR on
    2x2457600 planes) and none of any other kernel, dl within 1.2e-4 of
    banded_fir_plain on the returned td and the median warm wall ms of
    three more runs; then, after all five (the CPU's worker threads would share the
    host with the card runs' launches), fd within 1e-5 of the same run on
    the CPU, which also counts the ATen operations. Returns the launches,
    summed over the TMs."""
    total, rows, fds = {}, [], {}
    fir = filters.fir_coeff(*tm_script.FULL_WIDTH[:2])
    for tm in tm_script.TM_list:
        kernels.reset_launches()
        fd, td, dl, n_enc, _ = _tm_run(tm, DEV)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        if launches["banded_fir"] != 1 or sum(launches.values()) != 1:
            raise AssertionError(f"test model {tm} launches {launches}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        ref = filters.banded_fir_plain(torch.cat([td.real, td.imag]), fir,
                                       "same")
        err = _check("testmodel", tm, dl, torch.complex(ref[:1], ref[1:]))
        runs_ms = _warm_ms(lambda: _tm_run(tm, DEV))
        warm_ms = float(np.median(runs_ms))
        fds[tm] = fd.cpu()
        rows.append(dict(tm=tm, fd_shape=list(fd.shape),
                         td_shape=list(td.shape), dl_shape=list(dl.shape),
                         launches=launches, max_abs_err=err,
                         warm_ms=warm_ms, warm_runs_ms=runs_ms,
                         msamples_per_s=dl.shape[1] / warm_ms / 1e3,
                         pdsch_encodes=n_enc))
        del fd, td, dl, ref
    for row in rows:
        fd_c, _, _, _, n_ops = _tm_run(row["tm"], "cpu", count_ops=True)
        fd_err = (fds[row["tm"]] - fd_c).abs().max().item()
        if not fd_err <= 1e-5 or not (fd_c != 0).any():
            raise AssertionError(f"test model {row['tm']}: card fd against "
                                 f"the CPU's: {fd_err}")
        row.update(fd_max_abs_err_vs_cpu=fd_err, aten_ops=n_ops,
                   aten_ops_per_slot=n_ops / 40)
        emit("testmodels", **row)
    SUMMARY["testmodel_warm_ms"] = {r["tm"]: r["warm_ms"] for r in rows}
    return total


def phase_testmodel_script() -> dict:
    """sim/gen_nr_testmodel.py's main at its own constants (scs 30, BW 40,
    TDD: 20 slots at 61.44 Msps, the 143-tap FIR on 2x1228800 planes)
    into a temporary directory on the card, then on the CPU: main
    returns (rc 0) with five files each, one banded_fir launch per TM,
    and every waveform within 1.2e-4 of the CPU's (the plain chain).
    Returns the card run's launches."""
    with tempfile.TemporaryDirectory() as tmp:
        runs = {}
        for key, dev in (("card", str(DEV)), ("cpu", "cpu")):
            kernels.reset_launches()
            t0 = time.perf_counter()
            # main returns (rc 0 of `python -m ...`) or raises
            files = tm_script.main(["--device", dev, "--out-dir",
                                    f"{tmp}/{key}"])
            torch.cuda.synchronize()
            runs[key] = dict(files=files, launches=dict(kernels.LAUNCHES),
                             wall_s=time.perf_counter() - t0)
        card, cpu = runs["card"], runs["cpu"]
        if len(card["files"]) != 5 or len(cpu["files"]) != 5:
            raise AssertionError(f"gen_nr_testmodel: {runs}")
        if card["launches"]["banded_fir"] != 5 \
                or sum(card["launches"].values()) != 5:
            raise AssertionError(f"gen_nr_testmodel launches "
                                 f"{card['launches']}")
        errs = []
        for a, b in zip(card["files"], cpu["files"]):
            with np.load(a) as za, np.load(b) as zb:
                errs.append(float(np.abs(za["dl_waveform"]
                                         - zb["dl_waveform"]).max()))
                shape = za["dl_waveform"].shape
        if not max(errs) < FIR_TOL:
            raise AssertionError(f"gen_nr_testmodel card against CPU: {errs}")
    emit("testmodel_script", rc=0, files=len(card["files"]),
         dl_shape=list(shape), launches=card["launches"],
         max_abs_err_vs_cpu=max(errs), wall_s=card["wall_s"],
         cpu_wall_s=cpu["wall_s"])
    return card["launches"]


def phase_dl_multichannel_245() -> dict:
    """SSB + CSI-RS + PDCCH + PDSCH together (sim/gen_nr_testmodel.py:
    dl_multichannel_config: 2 antennas, scs 30 / BW 40, 20 slots,
    245.76 Msps) on the card: exactly one fir_up2_fused (4x614400 in,
    143 + 55 taps) and one banded_fir up2 (4x1228800 in), dl within
    1.2e-4 of fir_up2_fused_plain then banded_fir_plain on the returned
    td; the median warm wall ms of three more runs. Returns the
    launches."""
    kw = tm_script.dl_multichannel_config(n_slots=20, samplerate_in_mhz=245.76)
    wf, carrier = kw.pop("waveform_config"), kw.pop("carrier_config")

    def run():
        lists = dl_wf.gen_dl_channel_list(wf, carrier, **kw, seed=4,
                                          device=DEV)
        return dl_wf.gen_dl_waveform(wf, carrier, *lists)
    kernels.reset_launches()
    fd, td, dl, _ = run()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    if launches["fir_up2_fused"] != 1 or launches["banded_fir"] != 1 \
            or sum(launches.values()) != 2:
        raise AssertionError(f"multi-channel waveform launches {launches}")
    hb = filters.halfband_coeff()
    ref = filters.fir_up2_fused_plain(torch.cat([td.real, td.imag]),
                                      filters.fir_coeff(30, 40), hb)
    ref = filters.banded_fir_plain(ref, hb, "up2")
    err = _check("dl_multichannel_245", "SSB+CSI-RS+PDCCH+PDSCH", dl,
                 torch.complex(ref[:2], ref[2:]))
    runs_ms = _warm_ms(run)
    emit("dl_multichannel_245", n_slots=20, nant=2,
         td_shape=list(td.shape), dl_shape=list(dl.shape),
         launches=launches, max_abs_err=err,
         warm_ms=float(np.median(runs_ms)), warm_runs_ms=runs_ms)
    return launches


def phase_ssb_waveform_gen() -> None:
    """NrSSB.waveform_gen at 245.76 Msps (ifftsize 8192, the
    ssb_waveform_hifs case: 2 antennas, 3840 MHz) over a frame of 20
    slots on the card: no kernel launch, card within 1e-5 of the CPU."""
    carrier = merged(get_default_config("dl_carrier"),
                     dict(num_of_ant=2, carrier_frequency_in_mhz=3840))
    wf = dict(samplerate_in_mhz=245.76, numofslots=20, startSFN=0,
              startslot=0)
    kernels.reset_launches()
    td = NrSSB(carrier, get_default_config("ssb"),
               device=DEV).waveform_gen(wf)
    torch.cuda.synchronize()
    launches = sum(kernels.LAUNCHES.values())
    td_c = NrSSB(carrier, get_default_config("ssb"),
                 device="cpu").waveform_gen(wf)
    err = (td.cpu() - td_c).abs().max().item()
    if launches or not err <= 1e-5 or not td_c.abs().max() > 0:
        raise AssertionError(f"ssb waveform_gen: {launches} launches, "
                             f"card against CPU {err}")
    ms = call_ms(lambda: NrSSB(carrier, get_default_config("ssb"),
                               device=DEV).waveform_gen(wf), 3)
    emit("ssb_waveform_gen", td_shape=list(td.shape), ifftsize=8192,
         max_abs_err_vs_cpu=err, peak=td_c.abs().max().item(), ms=ms)


def phase_csirs_report() -> None:
    """One CSI-RS slot with 4 ports (row 4, fd-CDM2, 52 RBs of scs 30 /
    BW 40) through a rank-1 channel built from a Type-I codebook precoder
    (i11 2, i2 1; 4 RX) plus AWGN at 0 dB; NrCSIRSReport with subband CQI
    and PMI on the card: no kernel launch, RI, PMI and CQI equal to the
    CPU's, and the precoder recovered."""
    carrier = merged(get_default_config("dl_carrier"), dict(num_of_ant=4))
    csirs = merged(get_default_config("csirs"), dict(
        frequencyDomainAllocation=dict(row=4, bitstring="001"), nrofPorts=4,
        cdm_type="fd-CDM2", density="one", nrofRBs=52, periodicity=10))
    rcfg = merged(get_default_config("csirs_report"), {"SubbandSize ": 8})
    w, meta = csirs_report.type1_sp_codebook(4, 1)
    rng = np.random.default_rng(6)
    g = rng.normal(size=(4, 1)) + 1j * rng.normal(size=(4, 1))
    h = (g @ w[9].conj().T).astype(np.complex64)            # (4 RX, 4)
    n_sc = 12 * 106
    tx = torch.zeros((4, 14 * n_sc), dtype=torch.complex64)
    NrCSIRS(carrier, csirs).process(tx, np.zeros((4, 14 * n_sc), np.int8),
                                    0, 0)
    y = h @ tx.numpy() + (np.sqrt(0.5) * (
        rng.normal(size=(4, 14 * n_sc))
        + 1j * rng.normal(size=(4, 14 * n_sc)))).astype(np.complex64)
    kernels.reset_launches()
    rep = {dev: csirs_report.NrCSIRSReport(carrier, csirs, rcfg, n_rx=4,
                                           device=dev).report(y, 0, 0)
           for dev in (DEV, "cpu")}
    torch.cuda.synchronize()
    card, cpu = rep[DEV], rep["cpu"]
    keys = ("RI", "PMI", "CQI", "subband_CQI")
    if sum(kernels.LAUNCHES.values()) \
            or any(card[k] != cpu[k] for k in keys) or card["RI"] != 1 \
            or card["PMI"]["i11"] != meta[9]["i11"] \
            or set(card["PMI"]["i2"]) != {meta[9]["i2"]}:
        raise AssertionError(f"csirs_report card {card} != CPU {cpu}")
    ms = call_ms(lambda: csirs_report.NrCSIRSReport(
        carrier, csirs, rcfg, n_rx=4, device=DEV).report(y, 0, 0), 3)
    emit("csirs_report", **{k: card[k] for k in keys},
         wideband_se=card["wideband_SE"], cpu_wideband_se=cpu["wideband_SE"],
         ms=ms)


# ---------------------------------------------------------------------------
# UL control and PRACH: PUCCH formats 0-4 and SRS beside a PUSCH through the
# composed gen_ul_waveform (fir_up2_fused), the PRACH waveform (three
# banded_fir up2 stages with the 56-tap halfband) and the CSI-RS report
# example. Host-built channel values around the two kernels.
# ---------------------------------------------------------------------------

ULC_KW = dict(bw=100, n_slots=20, samplerate_in_mhz=245.76)


def _ulc_run(device, seed=7, prof=None):
    """ul_multichannel_config at full width (scs 30 / BW 100, 273 PRBs,
    TDD, 3840 MHz, 4 antennas, 20 slots at 245.76 Msps) through
    gen_ul_channel_list and gen_ul_waveform on device -> (fd, td, ul)."""
    kw = tm_script.ul_multichannel_config(**ULC_KW)
    wf, carrier = kw.pop("waveform_config"), kw.pop("carrier_config")
    lists = ul_wf.gen_ul_channel_list(wf, carrier, **kw, seed=seed,
                                      device=device)
    return ul_wf.gen_ul_waveform(wf, carrier, *lists, prof=prof)


def phase_ul_control_245() -> dict:
    """A PUSCH, PUCCH formats 0-4 and a 4-port SRS at full width (_ulc_run):
    exactly one fir_up2_fused launch (8x1228800, 287 + 55 taps) and none
    of any other kernel; ul within 1.2e-4 of fir_up2_fused_plain on the
    returned td; the median warm wall ms of three more runs and
    Msamples/s; the slot_grids / low_phy / channel_filter split of one
    more (StageProfiler: CUDA events); ATen operations and host-to-device writes per
    slot of another; the kernel at this shape against its plain version
    (kernel, plain, bound ms); fd equal to, and ul within 1.2e-4 of, the
    CPU's run on the same lists. Returns the launches."""
    kernels.reset_launches()
    fd, td, ul = _ulc_run(DEV)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    if launches["fir_up2_fused"] != 1 or sum(launches.values()) != 1:
        raise AssertionError(f"ul_control_245 launches {launches}")
    fir, hb = filters.fir_coeff(30, 100), filters.halfband_coeff()
    planes = torch.cat([td.real, td.imag]).contiguous()
    ref = filters.fir_up2_fused_plain(planes, fir, hb)
    err = _check("ul_control_245", "PUSCH+PUCCH F0-F4+SRS", ul,
                 torch.complex(ref[:4], ref[4:]))
    runs_ms = _warm_ms(lambda: _ulc_run(DEV))
    warm_ms = float(np.median(runs_ms))
    timer = StageProfiler(DEV)
    _ulc_run(DEV, prof=timer)
    with _OpCount() as ops:
        _ulc_run(DEV)
        torch.cuda.synchronize()
    n_slots, (p, t) = ULC_KW["n_slots"], planes.shape
    kern = _run_case(("fir_up2_fused", "UL control, BW 100, 4 ant, 20 slots",
                      functools.partial(filters.fir_up2_fused_planes, planes,
                                        fir, hb),
                      functools.partial(filters.fir_up2_fused_plain, planes,
                                        fir, hb),
                      4 * (3 * p * t + len(fir) + len(hb)),
                      _fused_ops(len(fir), len(hb), p, t),
                      dict(shape=[p, t], taps=len(fir))))
    fd_c, _, ul_c = _ulc_run("cpu")
    fd_err = (fd.cpu() - fd_c).abs().max().item()
    ul_err = (ul.cpu() - ul_c).abs().max().item()
    if not fd_err <= 1e-5 or not ul_err < FIR_TOL \
            or not (fd_c != 0).any():
        raise AssertionError(f"ul_control_245 card against CPU: fd {fd_err}"
                             f", ul {ul_err}")
    SUMMARY["ul_control_245_warm_ms"] = warm_ms
    emit("ul_control_245", n_slots=n_slots, nant=fd.shape[0],
         fd_shape=list(fd.shape), td_shape=list(td.shape),
         ul_shape=list(ul.shape), launches=launches, max_abs_err=err,
         warm_ms=warm_ms, warm_runs_ms=runs_ms,
         msamples_per_s=ul.shape[1] / warm_ms / 1e3,
         stage_s=_stage_s(timer), aten_ops_per_slot=ops.n / n_slots,
         h2d_writes_per_slot=ops.h2d / n_slots,
         fir_up2_fused=dict(kernel_ms=kern["kernel_ms"],
                            plain_ms=kern["plain_ms"],
                            bound_ms=kern["bound_ms"],
                            max_abs_err=kern["max_abs_err"]),
         fd_max_abs_err_vs_cpu=fd_err, ul_max_abs_err_vs_cpu=ul_err)
    return launches


# (label, duplex, prach_ConfigurationIndex, msg1_SubcarrierSpacing,
# PRACH_subframe): long format 0 (LRA 839) and short format A1 (LRA 139)
PRACH_CASES = [("format 0", "FDD", 16, 15, 1), ("format A1", "TDD", 77, 30, 9)]


def _prach_args(duplex, index, msg1, sub):
    base = get_default_config("prach")
    carrier = merged(get_default_config("ul_carrier"),
                     dict(BW=100, duplex_type=duplex))
    wf = merged(get_default_config("ul_waveform"),
                dict(numofslots=20, samplerate_in_mhz=245.76))
    cfg = merged(base["config"], dict(prach_ConfigurationIndex=index,
                                      msg1_SubcarrierSpacing=msg1))
    par = merged(base["parameters"], dict(PRACH_subframe=sub))
    return wf, carrier, cfg, par


def phase_prach_245() -> dict:
    """gen_prach_waveform at 245.76 Msps on the UL carrier (scs 30 / BW
    100, 20 slots: 4 SFNs) for a long and a short preamble, each active:
    exactly three banded_fir up2 launches (56 taps; 8x307200 ->
    8x614400 -> 8x1228800 -> 8x2457600) and nothing else; td within
    1.2e-4 of banded_fir_plain three times over the same SFN planes; the
    median warm ms of three more runs; each stage against its plain
    version and cuDNN conv_transpose1d (kernel, plain, bound, library
    ms); td within 1.2e-4 of the CPU's run and the preamble data equal.
    Returns the launches, summed over the two."""
    total = {}
    taps = prach.prach_halfband()
    for label, *case in PRACH_CASES:
        args = _prach_args(*case)
        ch = prach.Prach(*args[1:])
        if not all(ch.is_active(sfn) for sfn in range(4)):
            raise AssertionError(f"prach {label}: not active in every SFN")
        kernels.reset_launches()
        td, data = prach.gen_prach_waveform(*args, device=DEV)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        if launches["banded_fir"] != 3 or sum(launches.values()) != 3:
            raise AssertionError(f"prach {label} launches {launches}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        wavs = torch.as_tensor(np.stack([ch.process(sfn)[0]
                                         for sfn in range(4)]), device=DEV)
        x = torch.cat([wavs.real, wavs.imag]).contiguous()
        stages = []
        for k in range(3):
            stages.append(_fir_row(x, taps, "up2",
                                   f"PRACH {label} stage {k + 1}"))
            x = filters.banded_fir_plain(x, taps, "up2")
        err = _check("prach_245", label, td,
                     torch.complex(x[:4], x[4:]).reshape(1, -1))
        runs_ms = _warm_ms(lambda: prach.gen_prach_waveform(*args,
                                                            device=DEV))
        td_c, data_c = prach.gen_prach_waveform(*args, device="cpu")
        cpu_err = (td.cpu() - td_c).abs().max().item()
        if not cpu_err < FIR_TOL or not torch.equal(data.cpu(), data_c) \
                or data_c.shape[0] != 4:
            raise AssertionError(f"prach {label} card against CPU: "
                                 f"{cpu_err}")
        emit("prach_245", label=label, fmt=ch.fmt, lra=ch.info["LRA"],
             td_shape=list(td.shape), data_shape=list(data.shape),
             launches=launches, max_abs_err=err,
             warm_ms=float(np.median(runs_ms)), warm_runs_ms=runs_ms,
             stages=[{k: r[k] for k in ("shape", "kernel_ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms")} for r in stages],
             max_abs_err_vs_cpu=cpu_err)
    return total


def phase_csirs_report_example() -> dict:
    """sim/nr_csirs_report_example.py at its constants (row 3, 2 ports,
    TDL-A 2x4, 0 / 10 / 20 dB x 2 tests, 2 slots of BW 40 at 245.76 Msps)
    through its main on the card, then on the CPU with the same seed:
    wall s of each, and RI, PMI, CQI and subband CQI equal. Returns the
    card run's launches."""
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for key, dev in (("card", str(DEV)), ("cpu", "cpu")):
            kernels.reset_launches()
            t0 = time.perf_counter()
            rows = csirs_ex.main(["--device", dev, "--seed", "3",
                                  "--out-dir", f"{tmp}/{key}"])
            torch.cuda.synchronize()
            runs[key] = dict(rows=rows, launches=dict(kernels.LAUNCHES),
                             wall_s=time.perf_counter() - t0)
    keys = ("snr_db", "test", "slot", "RI", "PMI", "CQI", "subband_CQI")
    card, cpu = ([{k: r[k] for k in keys} for r in runs[d]["rows"]]
                 for d in ("card", "cpu"))
    if card != cpu or len(card) != 6:
        raise AssertionError(f"csirs report example card {card} != CPU {cpu}")
    emit("csirs_report_example", reports=card,
         launches=runs["card"]["launches"], wall_s=runs["card"]["wall_s"],
         cpu_wall_s=runs["cpu"]["wall_s"])
    return runs["card"]["launches"]


# ---------------------------------------------------------------------------
# Receiver breadth: the per-slot RX (channel estimation on the card, HARQ
# combining, UCI), the ML equalizers, the DCT CE, the TDL channel and the
# reference's PDSCH / PUSCH throughput examples. Plain PyTorch around
# banded_fir and the LDPC kernels.
# ---------------------------------------------------------------------------

def _count_syncs(fn):
    """fn() with CUDA's synchronisation debug mode at "warn" -> (its
    result, the host<->device synchronisations it made)."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(w.message) for w in caught)


def _per_slot_rx(obj, slots, rx_fd, ce_cfg, ldpc, algo="MMSE-IRC",
                 **rx_kw):
    """The sweep's per-slot loop on every slot: CE, then RX_process."""
    ests = sim.slot_estimates(obj, slots, rx_fd, range(len(slots)), ce_cfg)
    return sim.rx_slots(obj, ests, algo, ldpc, **rx_kw)


def _clean_point(config, n_slots, link=DL, snr=30.0, seed=30):
    """One point of n_slots at snr with pinned random transport blocks ->
    (channel object, slots, rx_fd, blocks sent, CE config)."""
    _, before = link
    carrier, ch_cfg, chan, ce, ldpc = config()
    cls = (lambda: Pdsch(ch_cfg, carrier, device=DEV)) if link is DL \
        else (lambda: NrPUSCH(carrier, ch_cfg, device=DEV))
    trblks = np.random.default_rng(seed).integers(
        0, 2, (n_slots, cls().tbsize), dtype=np.int8)
    obj, slots, rx_fd = before(carrier, ch_cfg, chan, -snr, n_slots,
                               seed=seed, device=DEV,
                               state=state_from_numpy(trblks=trblks,
                                                      device=DEV))
    return obj, slots, rx_fd, trblks, sim._ce_config(ce, chan,
                                                      carrier["scs"])


def _both_paths_exact(phase, obj, slots, rx_fd, trblks, ce_cfg, ldpc,
                      algo="MMSE-IRC") -> dict:
    """The per-slot and the batched RX on the same received slots: every
    TB passes with exact bits on both, else raises."""
    nr = rx_fd.shape[0]
    outs = _per_slot_rx(obj, slots, rx_fd, ce_cfg, ldpc, algo)
    ok_s = np.array([bool(o[0]) for o in outs])
    tb_s = np.stack([o[1].cpu().numpy() for o in outs])
    ok_b, tb_b = obj.rx_process_batch(
        rx_fd.reshape(nr, len(slots), -1).transpose(0, 1), slots,
        {"algo": algo}, ldpc, ce_cfg)
    row = dict(per_slot_passed=int(ok_s.sum()), batched_passed=int(ok_b.sum()),
               slots=len(slots),
               per_slot_bits_exact=bool(np.array_equal(tb_s, trblks)),
               batched_bits_exact=bool(np.array_equal(tb_b, trblks)))
    if not (ok_s.all() and ok_b.all() and row["per_slot_bits_exact"]
            and row["batched_bits_exact"]):
        raise AssertionError(f"{phase} clean point: {row}")
    return row


def _sch_info(obj) -> tuple:
    """(G, base graph, code-block info, Ncb) of the channel object's
    transport block in one slot."""
    cfg = obj.cfg
    _, G = data_re_layout(tuple(cfg["PortIndexList"]), cfg["num_of_layers"],
                          cfg["DMRS"]["NumCDMGroupsWithoutData"],
                          cfg["ResAlloType1"]["RBSize"],
                          cfg["StartSymbolIndex"], cfg["NrOfSymbols"],
                          obj._dmrs_symlist(), obj.qm)
    _, _, bgn, info, ncb, _ = sch_plan(obj.tbsize, obj.rate1024, G, obj.qm,
                                       cfg["num_of_layers"], obj.tbs_lbrm)
    return G, bgn, info, ncb


def phase_rx_per_slot() -> dict:
    """The bench sweep (sim.bench_link_level_config, 6 SNR points x 20
    slots, MMSE-IRC) through the per-slot RX (use_batch=False: H_LS_est,
    NrChannelEstimation and RX_process per slot; one ldpc_minsum launch
    per slot, B = 1), then the batched sweep on the same seeds: slots/s
    of both, ms per slot of channel_est and rx_process, host<->device
    synchronisations per slot; the LDPC kernel at B = 1; a 30 dB point of
    20 slots exact on both paths. Returns the per-slot sweep's
    launches."""
    config = sim.bench_link_level_config
    carrier, pdsch, chan, ce, ldpc = config()
    snrs, n_slots = [0.0, 1.0, 2.0, 3.0, 4.0, 5.0], 20
    kw = dict(ceq_algo_list=["MMSE-IRC"], n_slots=n_slots, ce_config=ce,
              ldpc_config=ldpc, seed=3, device=DEV)
    sim.run_pdsch_throughput(carrier, pdsch, chan, snrs[:1], use_batch=False,
                             **kw)                                  # warm
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res_s = sim.run_pdsch_throughput(carrier, pdsch, chan, snrs,
                                     use_batch=False, **kw)
    torch.cuda.synchronize()
    dt_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    want = dict(banded_fir=2 * len(snrs),
                ldpc_minsum_flooded=len(snrs) * n_slots,
                fading_channel=len(snrs))
    if any(launches[k] != v for k, v in want.items()) \
            or sum(launches.values()) != sum(want.values()):
        raise AssertionError(f"rx_per_slot launches {launches}")
    timer = StageProfiler(DEV)
    sim.run_pdsch_throughput(carrier, pdsch, chan, snrs[:2], use_batch=False,
                             prof=timer, **kw)
    stage_ms = {k: 1e3 * v.seconds / v.calls
                for k, v in timer.stats.items()}
    obj, slots, rx_fd = sim.pdsch_before_ceq_processing(
        carrier, pdsch, chan, -snrs[0], n_slots, seed=3, device=DEV)
    ce_cfg = sim._ce_config(ce, chan, carrier["scs"])
    torch.cuda.synchronize()
    _, n_sync = _count_syncs(lambda: torch.stack(
        [o[0] for o in _per_slot_rx(obj, slots, rx_fd, ce_cfg, ldpc)]).cpu())
    sim.run_pdsch_throughput(carrier, pdsch, chan, snrs[:1], **kw)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_b = sim.run_pdsch_throughput(carrier, pdsch, chan, snrs, **kw)
    torch.cuda.synchronize()
    dt_b = time.perf_counter() - t0
    SUMMARY["rx_per_slot_slots_per_s"] = len(snrs) * n_slots / dt_s
    _, bgn, info, _ = _sch_info(obj)
    ldpc_b1, _ = _ldpc_case("rx_per_slot_ldpc_b1", ldpc_dec.ldpc_minsum,
                            _noisy_codewords(np.random.default_rng(7),
                                             info.Zc, bgn, info.C, 2.0),
                            info.Zc, bgn, ldpc["L"])
    clean = _both_paths_exact("rx_per_slot",
                              *_clean_point(config, n_slots)[:4],
                              ce_cfg, ldpc)
    emit("rx_per_slot", snr_db=snrs, n_slots=n_slots,
         per_slot_pass_rate=res_s["MMSE-IRC"],
         batched_pass_rate=res_b["MMSE-IRC"],
         per_slot_seconds=dt_s,
         per_slot_slots_per_s=len(snrs) * n_slots / dt_s,
         batched_seconds=dt_b, batched_slots_per_s=len(snrs) * n_slots / dt_b,
         stage_ms_per_call=stage_ms, syncs_per_slot=n_sync / n_slots,
         tbs_bits=obj.tbsize, code_blocks=info.C, bg=bgn, zc=info.Zc,
         ldpc_b1_kernel_ms=ldpc_b1["kernel_ms"], launches=launches,
         at_30db=clean)
    return launches


def _full_width_config():
    """The bench configuration at full carrier width: scs 30 / BW 100, 273
    RBs, 2x4, 2 layers, MCS 20 of the 64QAM table."""
    carrier, pdsch, chan, ce, ldpc = sim.bench_link_level_config()
    carrier["BW"] = 100
    pdsch.update(mcs_table="64QAM", mcs_index=20)
    pdsch["ResAlloType1"]["RBSize"] = 273
    return carrier, pdsch, chan, ce, ldpc


def phase_rx_per_slot_full_width() -> dict:
    """The bench setup at full width (_full_width_config), 4 slots at 30
    dB, per slot and batched (each run twice, the second timed): every TB
    exact on both paths; TBS, code blocks, base graph, and the LDPC
    kernel's launch plan and device ms at B = C. Returns the launches of
    the timed runs."""
    n_slots = 4
    ldpc = _full_width_config()[4]
    obj, slots, rx_fd, trblks, ce_cfg = _clean_point(_full_width_config,
                                                     n_slots)
    nr = rx_fd.shape[0]
    stack = rx_fd.reshape(nr, n_slots, -1).transpose(0, 1)
    times = {}
    for path in ("per_slot", "batched"):
        for rep in range(2):
            if rep:
                kernels.reset_launches()
            t0 = time.perf_counter()
            if path == "per_slot":
                outs = _per_slot_rx(obj, slots, rx_fd, ce_cfg, ldpc)
                torch.stack([o[0] for o in outs]).cpu()
            else:
                obj.rx_process_batch(stack, slots, {"algo": "MMSE-IRC"}, ldpc,
                                     ce_cfg)
            torch.cuda.synchronize()
            times[path] = time.perf_counter() - t0
        times[path + "_launches"] = dict(kernels.LAUNCHES)
    G, bgn, info, ncb = _sch_info(obj)
    for path, n_launch in (("per_slot", n_slots), ("batched", 1)):
        got = times[path + "_launches"]
        if got["ldpc_minsum_flooded"] != n_launch \
                or sum(got.values()) != n_launch:
            raise AssertionError(f"full width {path} launches {got}")
    row, _ = _ldpc_case("rx_per_slot_full_width_ldpc", ldpc_dec.ldpc_minsum,
                        _noisy_codewords(np.random.default_rng(8), info.Zc,
                                         bgn, info.C, 2.0),
                        info.Zc, bgn, ldpc["L"])
    clean = _both_paths_exact("rx_per_slot_full_width", obj, slots, rx_fd,
                              trblks, ce_cfg, ldpc)
    emit("rx_per_slot_full_width", rbs=273, bw=100, n_slots=n_slots,
         tbs_bits=obj.tbsize, G=G, code_blocks=info.C, bg=bgn, zc=info.Zc,
         ncb=ncb, per_slot_ms_per_slot=times["per_slot"] * 1e3 / n_slots,
         batched_ms_per_slot=times["batched"] * 1e3 / n_slots,
         per_slot_launches=times["per_slot_launches"],
         batched_launches=times["batched_launches"],
         ldpc_at_b_eq_c=dict(kernel_ms=row["kernel_ms"],
                             cluster=row["cluster"], group=row["group"],
                             threads=row["threads"], blocks=row["blocks"]),
         at_30db=clean)
    return times["per_slot_launches"]


def phase_pdsch_throughput_example() -> dict:
    """sim/nr_pdsch_throughput_example.py at the JAX script's constants
    (2x4, 2 layers, 64QAM table MCS 5 on 20 RBs, Rayleigh low correlation
    at fm 200 Hz, -8..4 dB, 20 slots; MMSE, MMSE-IRC, ML-IRC-soft,
    ML2-IRC-soft, batched): wall s and the pass-rate curves. Then 4 slots
    at 30 dB for each equalizer: per slot (the RX follows the rv cycle
    [0, 2, 3, 1] of the configuration) and batched with rv [0], every TB
    exact. The batched sweep makes one ml2_maxlog launch a point.
    Returns the example's launches."""
    cfg = pdsch_ex.example_config()
    with tempfile.TemporaryDirectory() as tmp:
        pdsch_ex.main(["--out-dir", tmp],
                      config=dict(cfg, snr_db_list=[0.0], n_slots=2))
        torch.cuda.synchronize()
        kernels.reset_launches()
        timer = StageProfiler(DEV)
        t0 = time.perf_counter()
        res = pdsch_ex.main(["--out-dir", tmp], config=cfg, prof=timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    n_pts = len(cfg["snr_db_list"])
    n_ml2 = sum(a.startswith("ML2") for a in cfg["ceq_algo_list"])
    if launches["banded_fir"] != 2 * n_pts or launches[
            "ldpc_minsum_flooded"] + launches["ldpc_minsum_packed"] \
            != n_pts * len(cfg["ceq_algo_list"]) \
            or launches["ml2_maxlog"] != n_pts * n_ml2:
        raise AssertionError(f"pdsch example launches {launches}")
    carrier, pdsch, chan = cfg["carrier"], cfg["channel"], cfg["chan_cfg"]
    ldpc = dict(sim.DEFAULT_LDPC_CONFIG)
    ce_cfg = sim._ce_config(None, chan, carrier["scs"])
    exact = {}
    for rvs in ([0, 2, 3, 1], [0]):
        obj, slots, rx_fd = sim.pdsch_before_ceq_processing(
            carrier, dict(pdsch, rv=rvs), chan, -30.0, 4, seed=30,
            device=DEV)
        sent = np.tile(obj.get_trblk(obj.tbsize), (4, 1))
        ests = sim.slot_estimates(obj, slots, rx_fd, range(4), ce_cfg)
        for algo in cfg["ceq_algo_list"]:
            if rvs == [0]:
                ok, tb = obj.rx_process_batch(
                    rx_fd.reshape(rx_fd.shape[0], 4, -1).transpose(0, 1),
                    slots, {"algo": algo}, ldpc, ce_cfg)
                key = f"batched_rv0 {algo}"
            else:
                outs = sim.rx_slots(obj, ests, algo, ldpc)
                ok = np.array([bool(o[0]) for o in outs])
                tb = np.stack([o[1].cpu().numpy() for o in outs])
                key = f"per_slot {algo}"
            exact[key] = int((ok & np.all(tb == sent, axis=1)).sum())
    qm = Pdsch(pdsch, carrier, device=DEV).qm
    SUMMARY["pdsch_example_wall_s"] = wall
    emit("pdsch_throughput_example", snr_db=cfg["snr_db_list"],
         n_slots=cfg["n_slots"], wall_s=wall,
         stage_s=_stage_s(timer), pass_rate={
             a: res[a] for a in cfg["ceq_algo_list"]},
         tbs_bits=res["tbs_bits"], qm=qm,
         ml_candidates_per_re=(2 ** qm) ** pdsch["num_of_layers"],
         launches=launches, exact_of_4_at_30db=exact)
    if any(v != 4 for v in exact.values()):
        raise AssertionError(f"pdsch example at 30 dB: {exact}")
    return launches


def phase_pusch_throughput_example() -> dict:
    """sim/nr_pusch_throughput_example.py at the JAX script's constants
    (TDL-A, DS 30 ns, 1x2, MCStable61411 MCS 5 on 20 RBs, rv [0], 30
    slots, -10..2 dB, FO off): wall s and the channel stage. Then the
    TDL-A channel with its 23 per-path taps and the noise pinned
    (interop.state_from_numpy): the filter card == CPU, and 4 slots at 30
    dB through the per-slot RX: ok flags and TB bits card == CPU. Returns
    the example's launches."""
    cfg = pusch_ex.example_config()
    with tempfile.TemporaryDirectory() as tmp:
        pusch_ex.main(["--out-dir", tmp],
                      config=dict(cfg, snr_db_list=[0.0], n_slots=2))
        torch.cuda.synchronize()
        kernels.reset_launches()
        timer = StageProfiler(DEV)
        t0 = time.perf_counter()
        res = pusch_ex.main(["--out-dir", tmp], config=cfg, prof=timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    n_pts = len(cfg["snr_db_list"])
    if launches["banded_fir"] != 2 * n_pts or launches[
            "ldpc_minsum_flooded"] + launches["ldpc_minsum_packed"] != n_pts:
        raise AssertionError(f"pusch example launches {launches}")
    carrier, pusch, chan = cfg["carrier"], cfg["channel"], cfg["chan_cfg"]
    scs, n_slots = carrier["scs"], 4
    from python_5gtoolbox_tpu_torch.utils.numerology import (
        carrier_prb_size, fft_size)
    fs = fft_size(carrier_prb_size(scs, carrier["BW"])) * scs * 1000.0
    n = n_slots * int(round(fs * 1e-3 * 15 / scs))
    gen = torch.Generator().manual_seed(5)
    taps = [chan_mod.gen_mimo_channel(
        gen, 1, 2, np.asarray(chan["Rspat"]), n, fs, p[2], p[3], p[4],
        chan["fm_inHz"], chan["num_of_sinusoids"]).numpy()
        for p in chan["multi_paths"]]
    rng = np.random.default_rng(6)
    noise = (rng.standard_normal((2, n)), rng.standard_normal((2, n)))
    trblks = rng.integers(0, 2, (n_slots, res["tbs_bits"]), dtype=np.int8)
    tx = (rng.standard_normal((1, n)) + 1j * rng.standard_normal((1, n))
          ).astype(np.complex64)
    ce_cfg = sim._ce_config(cfg["ce"], chan, scs)
    ldpc = dict(sim.DEFAULT_LDPC_CONFIG)
    out = []
    for dev in (DEV, torch.device("cpu")):
        st = state_from_numpy(trblks=trblks, taps=taps, noise=noise,
                              device=dev)
        model = chan_mod.NrChannelModel(chan, -30.0, 3.5e9, fs, scs,
                                        device=dev)
        filt = model.filter(torch.as_tensor(tx, device=dev), taps=st["taps"],
                            noise=st["noise"]).cpu().numpy()
        obj, slots, rx_fd = usim.pusch_before_ceq_processing(
            carrier, pusch, chan, -30.0, n_slots, seed=30, device=dev,
            state=st)
        outs = _per_slot_rx(obj, slots, rx_fd, ce_cfg, ldpc)
        out.append((filt, np.array([bool(o[0]) for o in outs]),
                    np.stack([o[1].cpu().numpy() for o in outs])))
    card, cpu = out
    filt_err = float(np.abs(card[0] - cpu[0]).max() / np.abs(cpu[0]).max())
    same = bool(np.array_equal(card[1], cpu[1])
                and np.array_equal(card[2], cpu[2]))
    SUMMARY["pusch_example_wall_s"] = wall
    emit("pusch_throughput_example", snr_db=cfg["snr_db_list"],
         n_slots=cfg["n_slots"], paths=len(chan["multi_paths"]), wall_s=wall,
         channel_s=timer.stats["channel"].seconds, stage_s=_stage_s(timer),
         pass_rate=res["MMSE-IRC"], tbs_bits=res["tbs_bits"],
         launches=launches, tdl_filter_rel_err_card_vs_cpu=filt_err,
         pinned_30db=dict(card_passed=int(card[1].sum()),
                          cpu_passed=int(cpu[1].sum()),
                          slots=n_slots, card_equals_cpu=same))
    if filt_err > 1e-5 or not same or not cpu[1].all():
        raise AssertionError(f"pusch example pinned draws: filter "
                             f"{filt_err}, card == CPU {same}")
    return launches


def phase_pusch_uci_per_slot() -> dict:
    """run_pusch_throughput(decode_uci=True) on both UCI configurations of
    pusch_uci (2 points x 20 slots: the per-slot TX branch, one banded_fir
    each way, the per-slot RX with one ldpc_minsum launch per slot), then
    30 dB: every TB and every UCI stream exact in RX_process's returned
    uci. Returns the launches, summed."""
    total = {}
    snrs, n_slots = [0.0, 5.0], UCI_SLOTS
    rows = []
    for name, uci in UCI_CONFIGS.items():
        def config(uci=uci):
            carrier, pusch, chan, ce, ldpc = _pusch_cp_config()
            pusch.update(uci)
            return carrier, pusch, chan, ce, ldpc
        carrier, pusch, chan, ce, ldpc = config()
        kw = dict(n_slots=n_slots, ce_config=ce, ldpc_config=ldpc, seed=3,
                  decode_uci=True, device=DEV)
        usim.run_pusch_throughput(carrier, pusch, chan, snrs[:1],
                                  ["MMSE-IRC"], **dict(kw, n_slots=2))
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = usim.run_pusch_throughput(carrier, pusch, chan, snrs,
                                        ["MMSE-IRC"], **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        want = dict(banded_fir=2 * len(snrs),
                    ldpc_minsum_flooded=len(snrs) * n_slots,
                    fading_channel=len(snrs))
        if any(launches[k] != v for k, v in want.items()) \
                or sum(launches.values()) != sum(want.values()):
            raise AssertionError(f"pusch_uci_per_slot {name} {launches}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        obj, slots, rx_fd, trblks, ce_cfg = _clean_point(config, n_slots,
                                                         link=UL)
        outs = _per_slot_rx(obj, slots, rx_fd, ce_cfg, ldpc, decode_uci=True)
        ok = np.array([bool(o[0]) for o in outs])
        tb_exact = bool(np.array_equal(
            np.stack([o[1].cpu().numpy() for o in outs]), trblks))
        streams = {k: f for k, f in _UCI_FIELDS if pusch.get(
            {"ack": "EnableACK", "csi1": "EnableCSI1",
             "csi2": "EnableCSI2"}[k])}
        uci_exact = {k: sum(bool(o[3][k][1]) and np.array_equal(
            o[3][k][0].cpu().numpy(), pusch[f]) for o in outs)
            for k, f in streams.items()}
        rows.append(dict(config=name, pass_rate=res["MMSE-IRC"],
                         seconds=dt, slots_per_s=len(snrs) * n_slots / dt,
                         launches=launches,
                         at_30db=dict(tb_passed=int(ok.sum()),
                                      tb_bits_exact=tb_exact,
                                      uci_exact=uci_exact)))
        if not ok.all() or not tb_exact \
                or any(v != n_slots for v in uci_exact.values()) \
                or any(sorted(o[3]) != sorted(streams) for o in outs):
            raise AssertionError(f"pusch_uci_per_slot {name}: {rows[-1]}")
    emit("pusch_uci_per_slot", snr_db=snrs, n_slots=n_slots, configs=rows)
    return total


def _harq_config():
    """(carrier, pdsch, ce, ldpc, rv cycle, SNR dB, slots) of a HARQ study
    (tests/test_batch_rx_harq.py): BW 20 / scs 30, 2 TX x 2 RX, 2 layers
    of 256QAM MCS 10 on 10 RBs, a repeating payload, AWGN at -6 dB noise
    power where the first transmission fails and soft combining of the
    rv cycle (0, 2, 3, 1) decodes, 3 slots."""
    carrier = merged(get_default_config("dl_carrier"),
                     dict(BW=20, scs=30, num_of_ant=2, Nr=2,
                          maxMIMO_layers=2, PCI=1,
                          carrier_frequency_in_mhz=3840.0))
    payload = np.random.default_rng(9).integers(0, 2, 256).tolist()
    pdsch = merged(get_default_config("pdsch"),
                   dict(mcs_index=10, mcs_table="256QAM", num_of_layers=2,
                        data_source=payload, StartSymbolIndex=2,
                        NrOfSymbols=12))
    pdsch["ResAlloType1"].update(RBStart=0, RBSize=10)
    pdsch["DMRS"].update(nNIDnSCID=1, NumCDMGroupsWithoutData=1,
                         DMRSAddPos=1)
    pdsch["precoding_matrix"] = np.empty(0)
    ce = dict(CE_algo="DFT_symmetric", L_symm_left_in_ns=1400,
              L_symm_right_in_ns=1200, eRB=4, enable_TO_comp=True,
              enable_FO_est=False, enable_FO_comp=False)
    ldpc = dict(L=16, algo="min-sum", alpha=0.8, beta=0.3)
    return carrier, pdsch, ce, ldpc, [0, 2, 3, 1], -6.0, 3


def phase_harq() -> dict:
    """The HARQ study of _harq_config (tests/test_batch_rx_harq.py: rv
    cycle 0, 2, 3, 1 over AWGN at -6 dB, 3 slots): the batched chain's
    per-transmission ok flags equal the per-slot chain's on the card; rv
    0 alone fails, the combined chain decodes. Returns its launches."""
    carrier, pdsch, ce, ldpc, rvs, snr, n_slots = _harq_config()
    kernels.reset_launches()
    t0 = time.perf_counter()
    ok_b, ok_s = sim.harq_chains(carrier, pdsch, ce, ldpc, rvs, snr, n_slots,
                                 device=DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    emit("harq", rv_cycle=rvs, pnoise_db=snr, n_slots=n_slots,
         ok_batched=ok_b.tolist(), ok_per_slot=ok_s.tolist(), wall_s=wall,
         launches=launches)
    if not np.array_equal(ok_b, ok_s) or ok_b[0].any() \
            or not ok_b[-1].all():
        raise AssertionError(f"harq: batched {ok_b} per slot {ok_s}")
    return launches


def _ml2_search_row(y, h, s2, modtype: str) -> dict:
    """csrc/ml2_maxlog.cu against ml2_maxlog_plain on whitened (y, h,
    sigma2): device ms of each (the kernel back to back, the plain search
    once, warm), the kernel's bound, LLR error and differing best
    candidates (ties within rounding)."""
    n, nr, nl = h.shape
    n_cand = 2 ** (QM_TABLE[modtype] * nl)
    before = kernels.LAUNCHES["ml2_maxlog"]
    got = teq.ml2_maxlog(y, h, s2, modtype)
    torch.cuda.synchronize()
    launched = kernels.LAUNCHES["ml2_maxlog"] - before
    kernel_ms = device_ms(lambda: teq.ml2_maxlog(y, h, s2, modtype))
    teq.ml2_maxlog_plain(y[:8], h[:8], s2[:8], modtype)               # warm
    ref, plain_ms = _event_ms(lambda: teq.ml2_maxlog_plain(y, h, s2,
                                                           modtype))
    err = float((got[2] - ref[2]).abs().max() / ref[2].abs().max())
    # where the best candidates differ, the kernel's pick must score the
    # plain minimum to a few ulps in the plain arithmetic (a tie)
    differ = torch.nonzero(got[0] != ref[0])[:, 0]
    cand = torch.as_tensor(teq._candidates(modtype, nl)[1], device=DEV)
    lv = teq._distances(y[differ], h[differ], cand) / s2[differ, None]
    pick = lv.gather(1, got[0][differ, None])[:, 0]
    ties_ok = bool(((pick - ref[1][differ]).abs()
                    <= 1e-5 * ref[1][differ].abs()).all())
    # per candidate and RX antenna 2 subtractions and 2 FMAs, then a row
    # and a column minimum: (4 Nr + 2) FP32 instructions at half the FP32
    # FLOP rate (an FMA counts 2 FLOP); y, h, sigma2 read, best, min_lv and
    # the LLRs written once
    n_instr = n * n_cand * (4 * nr + 2)
    n_bytes = n * (8 * nr + 8 * nr * nl + 4 + 8 + 4 + 4 * nl
                   * QM_TABLE[modtype])
    bound, by = bound_ms(n_bytes, 2 * n_instr)
    if launched != 1 or err > 1e-4 or not ties_ok:
        raise AssertionError(f"ml2_maxlog {modtype}: {launched} launches, "
                             f"LLR error {err}, {len(differ)} best differ")
    return dict(modtype=modtype, res=n, candidates=n_cand, nr=nr,
                kernel_ms=kernel_ms, plain_ms=plain_ms,
                plain_pieces=len(teq._pieces(n, n_cand, nr)), bound_ms=bound,
                bound_by=by, llr_rel_err=err, best_differ=len(differ))


def phase_ml_equalizers() -> dict:
    """Every ML algorithm on the inputs of the equalize_ml_cases and
    equalize_ml2_cases goldens (tests/golden/), card against CPU: hard
    bits equal, LLRs within 1e-3 of their scale. Then ML2-IRC-soft at
    256QAM with 2 layers and Nr 4 on the data REs of one bench slot:
    device ms, peak memory, the eigh (cuSOLVER) ms of its whitening; card
    == CPU on its first 64 REs. Then ML2's search alone on that slot's
    whitened REs repeated to the bench cell's shapes (a full-width slot,
    36,036 REs, at its 64QAM and at 256QAM; a 20-slot point, 720,720 REs,
    at 64QAM): csrc/ml2_maxlog.cu beside its bound and the plain search.
    Returns the kernel table's row (64QAM, one slot)."""
    root = pathlib.Path(__file__).resolve().parent / "tests" / "golden"
    worst, n_cases = 0.0, 0
    for name in ("equalize_ml_cases", "equalize_ml2_cases"):
        with np.load(root / f"{name}.npz") as z:
            gold = {k: z[k] for k in z.files}
        for i in range(sum(k.startswith("y_") for k in gold)):
            args = [gold[f"{v}_{i}"].astype(np.complex64)
                    for v in ("y", "h", "cov")]
            for algo in teq.ML_EQUALIZERS:
                card = teq.channel_equ_and_demod(*args, "16qam",
                                                 {"algo": algo}, device=DEV)
                cpu = teq.channel_equ_and_demod(*args, "16qam",
                                                {"algo": algo}, device="cpu")
                err = float((card[3].cpu() - cpu[3]).abs().max()
                            / cpu[3].abs().max())
                if not torch.equal(card[2].cpu(), cpu[2]) or err > 1e-3:
                    raise AssertionError(f"{name} case {i} {algo}: hard "
                                         f"bits or LLRs {err} card != CPU")
                worst, n_cases = max(worst, err), n_cases + 1
    y, h, cv = _bench_ml_slot()
    n_re = y.shape[0]
    teq.ml2(y[:8], h[:8], cv[:8], "256qam", irc=True)               # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out, ms = _event_ms(lambda: teq.ml2(y, h, cv, "256qam", irc=True))
    peak = torch.cuda.max_memory_allocated() - base
    inv = torch.linalg.inv(teq._reg(cv))
    _, eigh_ms = _event_ms(lambda: torch.linalg.eigh(inv))
    cpu = teq.ml2(*(v[:64].cpu() for v in (y, h, cv)), "256qam", irc=True)
    err = float((out[3][:64].cpu() - cpu[3]).abs().max()
                / cpu[3].abs().max())
    hard_equal = torch.equal(out[2][:64].cpu(), cpu[2])
    yw, hw, cw = teq._whitened(y, h, cv, True)
    s2 = teq._sigma2(cw)
    # the bench cell's shapes, the slot's whitened REs repeated: one
    # full-width slot (36,036 data REs) and one 20-slot point (720,720)
    search = []
    for n, mods in ((36036, ("64qam", "256qam")), (720720, ("64qam",))):
        idx = torch.arange(n, device=DEV) % n_re
        search += [_ml2_search_row(yw[idx], hw[idx], s2[idx], mod)
                   for mod in mods]
    emit("ml_equalizers", golden_cases=n_cases,
         worst_llr_rel_err_card_vs_cpu=worst,
         ml2_256qam=dict(res_per_slot=n_re, candidates=256 ** 2, nr=4,
                         device_ms=ms, peak_bytes=peak, eigh_ms=eigh_ms,
                         first64_hard_equal=hard_equal,
                         first64_llr_rel_err=err),
         ml2_search=search)
    if not hard_equal or err > 1e-3:
        raise AssertionError(f"ML2 256QAM card != CPU: {err}")
    row = search[0]
    return dict(max_abs_err=row["llr_rel_err"], kernel_ms=row["kernel_ms"],
                plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                bound_by=row["bound_by"], library_ms=None)


def phase_fading() -> dict:
    """csrc/fading_channel.cu at the TDL cells' channel (TDL-A 30 ns, fm
    10 Hz, 23 paths, 2x4, 122.88 Msps) at one slot (61,440 samples) and
    one 20-slot point (1,228,800), against the plain per-path loop on the
    same draws (filter_plain without noise): device ms of the kernel back
    to back, its bound, the plain loop's ms once (warm), the error; and
    the whole filter() of the point on the kernel path (draws, noise and
    all). Returns the kernel table's row (the point)."""
    chan = chan_mod.gen_channel_model_config(
        model_format="TDL-A", Nt=2, Nr=4, fm_inHz=10, DSdesired=30,
        Rspat_config=("customized", "uniform", "DL", (0, 0)))
    fs, links = 122.88e6, 8
    rows = []
    for n in (61440, 1228800):
        gen = torch.Generator(device=DEV).manual_seed(8)
        tx = torch.complex(torch.randn((2, n), generator=gen, device=DEV),
                           torch.randn((2, n), generator=gen, device=DEV))

        def model(pnoise_db=255):
            return chan_mod.NrChannelModel(chan, pnoise_db, 3.5e9, fs, 30,
                                           seed=7, device=DEV)
        m = model()
        paths = m.multi_paths
        draws, draws0 = chan_mod.fading_draws(m.gen, paths, links, m.n_sin)
        consts = chan_mod.fading_constants(m.rspat, paths, fs, DEV)
        w, amp = 2 * np.pi * m.fm / fs, np.sqrt(2 / m.n_sin)
        before = kernels.LAUNCHES["fading_channel"]
        got = chan_mod.fading_channel(tx, draws, draws0, consts, 4, w, amp)
        torch.cuda.synchronize()
        launched = kernels.LAUNCHES["fading_channel"] - before
        kernel_ms = device_ms(lambda: chan_mod.fading_channel(
            tx, draws, draws0, consts, 4, w, amp))
        model().filter_plain(tx)                                     # warm
        ref, plain_ms = _event_ms(lambda: model().filter_plain(tx))
        err = float((got - ref).abs().max() / ref.abs().max())
        model(-20.0).filter(tx)                                      # warm
        _, filter_ms = _event_ms(lambda: model(-20.0).filter(tx))
        # per sample, path and link 2 n_sin cosine terms; 4 FP32
        # instructions a term (a complex rotation, the least that keeps
        # each term's phase exact) at half the FP32 FLOP rate; the SFU's
        # rate, 16 cosines a clock on each of 132 SMs at 1.98 GHz, is what
        # the kernel can reach; tx read and the output written once
        terms = n * len(paths) * links * m.n_sin * 2
        bound, by = bound_ms(n * (2 + 4) * 8, 2 * 4 * terms)
        if launched != 1 or err > 1e-5:
            raise AssertionError(f"fading_channel n {n}: {launched} "
                                 f"launches, error {err}")
        rows.append(dict(samples=n, paths=len(paths), links=links,
                         terms=terms, kernel_ms=kernel_ms, bound_ms=bound,
                         bound_by=by,
                         sfu_ms=terms / (16 * 132 * 1.98e9) * 1e3,
                         plain_ms=plain_ms, filter_ms=filter_ms,
                         rel_err=err))
    emit("fading", rows=rows)
    row = rows[-1]
    return dict(max_abs_err=row["rel_err"], kernel_ms=row["kernel_ms"],
                plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                bound_by=row["bound_by"], library_ms=None)


def _dct_config():
    carrier, pdsch, chan, ce, ldpc = sim.bench_link_level_config()
    return carrier, pdsch, chan, dict(ce, CE_algo="DCT"), ldpc


def phase_ce_dct() -> dict:
    """DCT and DCT_symmetric CE on the LS estimates of a bench slot, card
    against CPU: the per-slot NrChannelEstimation and the batched
    ce_batch.channel_est_batch, H and cov within 1e-4 of their scale.
    Then the bench sweep with CE_algo DCT at 2 points (_sweep: 30 dB
    exact). Returns the sweep's launches."""
    carrier, pdsch, chan, ce, ldpc = sim.bench_link_level_config()
    obj, slots, rx_fd = sim.pdsch_before_ceq_processing(
        carrier, pdsch, chan, -10.0, 1, seed=3, device=DEV)
    h_ls, info = obj.H_LS_est(rx_fd, slots[0])
    rows = {}
    for algo in ("DCT", "DCT_symmetric"):
        cfg = dict(ce, CE_algo=algo)
        errs = {}
        for kind in ("per_slot", "batched"):
            got = []
            for dev in (DEV, "cpu"):
                h = h_ls.to(dev)
                if kind == "per_slot":
                    H, cov = NrChannelEstimation(h, dict(info), dict(cfg)) \
                        .channel_est()
                else:
                    o = ce_batch.channel_est_batch(h[None], info, dict(cfg))
                    H, cov = o["H"][0], o["cov"][0]
                got.append((H.cpu(), cov.cpu()))
            errs[kind] = [float((a - b).abs().max() / b.abs().max())
                          for a, b in zip(*got)]
        rows[algo] = errs
        if max(max(v) for v in errs.values()) > 1e-4:
            raise AssertionError(f"ce_dct {algo} card != CPU: {errs}")
    emit("ce_dct", rel_err_card_vs_cpu_h_cov=rows)
    return _sweep("ce_dct_sweep", None, ("banded_fir", "ldpc_minsum_flooded"),
                  config=_dct_config, snrs=(0.0, 5.0))


# ---------------------------------------------------------------------------
# parallelism: 2 gloo ranks sharing cuda:0
# ---------------------------------------------------------------------------

PAR_WORLD = 2
PAR_KW = dict(scs=30, bw=100, nant=2, n_slots=20)   # 122.88 -> 245.76 Msps


def _bench_ml_slot():
    """(y, h, cov) on the data REs of one bench slot (phase_ml_equalizers'
    ML2-IRC input: Nr 4, 2 layers)."""
    carrier, pdsch, chan, ce, ldpc = sim.bench_link_level_config()
    obj, slots, rx_fd = sim.pdsch_before_ceq_processing(
        carrier, pdsch, chan, -20.0, 1, seed=3, device=DEV)
    ce_cfg = sim._ce_config(ce, chan, carrier["scs"])
    rx_slot, _, H, cov, est = sim.slot_estimates(obj, slots, rx_fd, [0],
                                                 ce_cfg)[0]
    _, sym_idx, re_idx, _ = obj._slot_rx_plan()
    ssi = pdsch["StartSymbolIndex"]
    res = est.process_pdsch_data(copy_rx_pdsch_resource(rx_slot, obj.cfg)[0],
                                 ssi)
    return (res[sym_idx, re_idx], H[sym_idx + ssi, re_idx],
            cov[sym_idx + ssi, torch.div(re_idx, 12, rounding_mode="floor")])


def _par_rank(rank: int, world: int, port: int, queue) -> None:
    """One rank of phase_parallel_245: every step sharded over the group
    (timed, its launches counted), gathered and held by rank 0 against
    the single-rank path on the card (timed too). Rank 0 puts the rows,
    and the launches of both ranks, on the queue."""
    import torch.distributed as dist

    from python_5gtoolbox_tpu_torch.parallel import dryrun, pipeline
    from python_5gtoolbox_tpu_torch.parallel import mesh as pmesh
    from python_5gtoolbox_tpu_torch.parallel import timeshard
    from python_5gtoolbox_tpu_torch.parallel.tp import tp_ml2
    from python_5gtoolbox_tpu_torch.utils.numerology import carrier_prb_size

    pmesh.init_distributed(f"tcp://localhost:{port}", world, rank)
    if dist.get_backend() != "gloo" or pmesh.rank_device() != DEV:
        raise AssertionError("parallel_245: ranks must share cuda:0 on gloo")
    launches = {k: 0 for k in kernels.LAUNCHES}
    rows = {}

    def bcast(x):                    # rank 0's tensor on every rank
        t = x.cpu() if rank == 0 else None
        box = [t]
        dist.broadcast_object_list(box, src=0)
        return box[0].to(DEV)

    def sharded(fn, together=True):
        """fn() warm, then timed with its launches: on every rank
        (together), or on this one."""
        fn()
        torch.cuda.synchronize()
        if together:
            dist.barrier()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        for k, v in kernels.LAUNCHES.items():
            launches[k] += v
        return out, ms

    def single(fn):
        """fn() on this rank alone, warm, then timed."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def row(name, ms, ref_ms=None, **kw):
        ms_all = [None] * world
        dist.all_gather_object(ms_all, ms)
        rows[name] = dict(sharded_ms=max(ms_all), rank_ms=ms_all,
                          single_rank_ms=ref_ms, **kw)

    sp = pmesh.make_mesh(axis="sp")
    scs, bw, nant, n_slots = (PAR_KW[k] for k in ("scs", "bw", "nant",
                                                  "n_slots"))
    t = n_slots * ofdm.slot_sample_count(scs, bw)
    g = np.random.default_rng(245)
    td = torch.as_tensor((g.normal(size=(nant, t)) + 1j * g.normal(
        size=(nant, t))).astype(np.complex64), device=DEV)
    local = pmesh.shard_batch(sp, td, "sp", dim=-1)
    tx, ms = sharded(lambda: timeshard.sharded_tx_channel_filter(
        local, scs, bw, sp))
    tx_all = pmesh.gather(sp, tx, "sp", dim=-1)
    rx, rx_ms = sharded(lambda: timeshard.sharded_rx_channel_filter(
        tx, scs, bw, sp))
    rx_all = pmesh.gather(sp, rx, "sp", dim=-1)
    err = ref_ms = rx_err = rx_ref_ms = None
    if rank == 0:
        ref, ref_ms = single(lambda: filters.tx_channel_filter(td, scs, bw))
        err = (tx_all - ref).abs().max().item()
        ref, rx_ref_ms = single(lambda: filters.rx_channel_filter(
            tx_all, scs, bw, 245.76e6))
        rx_err = (rx_all - ref).abs().max().item()
        if not (err <= 2e-5 and rx_err <= 2e-5):
            raise AssertionError(f"parallel_245 timeshard: tx {err}, "
                                 f"rx {rx_err}")
    row("timeshard_tx", ms, ref_ms, shape=list(tx_all.shape),
        max_abs_err=err)
    row("timeshard_rx", rx_ms, rx_ref_ms, shape=list(rx_all.shape),
        max_abs_err=rx_err)

    # the ML candidate axis over both ranks, one bench slot
    y, h, cv = (bcast(v) for v in (_bench_ml_slot() if rank == 0
                                   else (None,) * 3))
    tp = pmesh.make_mesh(axis="tp")
    got, ms = sharded(lambda: tp_ml2(y, h, cv, "256qam", tp, irc=True))
    err = ref_ms = None
    if rank == 0:
        # tp_ml2 splits the plain search (the kernel's own check is
        # phase_ml_equalizers)
        ref, ref_ms = single(lambda: teq.ml2_plain(y, h, cv, "256qam",
                                                   irc=True))
        err = max((a - b).abs().max().item() / max(b.abs().max().item(), 1)
                  for a, b in zip(got, ref))
        if not torch.equal(got[2], ref[2]) or not err <= 1e-5:
            raise AssertionError(f"parallel_245 tp_ml2: {err}")
    row("tp_ml2", ms, ref_ms, res=int(y.shape[0]), candidates=256 ** 2,
        max_rel_err=err)

    # the two-stage TX pipeline (rank 0: two streams of the card)
    if rank == 0:
        prb = carrier_prb_size(scs, bw)
        fd = torch.as_tensor((g.normal(size=(nant, n_slots, 14, 12 * prb))
                              + 1j * g.normal(size=(nant, n_slots, 14,
                                                    12 * prb))
                              ).astype(np.complex64), device=DEV)
        pp, ms = sharded(lambda: pipeline.pipelined_tx_waveform(
            fd, scs, bw, int(3500e6), 245.76e6, devices=[DEV, DEV]), False)
        ref, ref_ms = single(lambda: pipeline.serial_tx_waveform(
            fd, scs, bw, int(3500e6), 245.76e6, device=DEV))
        err = ((pp - ref).abs() - 2e-5 * ref.abs()).max().item()
        if pp.shape != ref.shape or not err <= 2e-5:
            raise AssertionError(f"parallel_245 pipeline: {err}")
        rows["pipeline"] = dict(sharded_ms=ms, single_rank_ms=ref_ms,
                                shape=list(pp.shape), chunks=n_slots // 4,
                                max_excess_err=err)
    dist.barrier()

    # the slot-sharded batched RX at the bench configuration
    carrier, pdsch, chan, ce, ldpc = sim.bench_link_level_config()
    obj = Pdsch(pdsch, carrier, device=DEV)
    if rank == 0:
        obj, slots, rx_fd = sim.pdsch_before_ceq_processing(
            carrier, pdsch, chan, -5.0, n_slots, seed=3, device=DEV)
        stack = rx_fd.reshape(rx_fd.shape[0], n_slots, -1).transpose(0, 1)
    stack = bcast(stack if rank == 0 else None)
    slots = list(range(n_slots))
    ce_cfg = sim._ce_config(ce, chan, carrier["scs"])
    ceq = {"algo": "MMSE-IRC"}
    dp = pmesh.make_mesh(axis="dp")
    (ok, tb), ms = sharded(lambda: dryrun.slot_sharded_rx(
        obj, stack, slots, ceq, ldpc, ce_cfg, dp))
    ref_ms = None
    if rank == 0:
        ref, ref_ms = single(lambda: obj.rx_process_batch(
            stack, slots, ceq, ldpc, ce_cfg, fetch=False)[:2])
        if not (torch.equal(ok, ref[0]) and torch.equal(tb, ref[1])):
            raise AssertionError("parallel_245 batched RX: sharded != "
                                 "single rank")
    row("slot_sharded_rx", ms, ref_ms, n_slots=n_slots,
        tb_passed=int(ok.sum()))

    # the dry run (its own checks against one rank)
    checks, ms = sharded(lambda: dryrun.dryrun_multichip(world))
    row("dryrun_multichip", ms, checks=checks)

    every = [None] * world
    dist.all_gather_object(every, launches)
    if rank == 0:
        queue.put(dict(rows=rows, launches={
            k: sum(d[k] for d in every) for k in launches}))
    dist.barrier()
    dist.destroy_process_group()


def phase_parallel_245() -> dict:
    """parallel/ at full width on 2 gloo ranks sharing cuda:0 (kernels
    built here first, so the ranks load them): the time-sharded TX and
    RX channel filters (scs 30 / BW 100, 2 antennas, 20 slots, 245.76
    Msps), tp_ml2 (256QAM, 2 layers, IRC, soft) on one bench slot, the
    two-stage pipelined TX waveform (BW 100, 20 slots, two streams), the
    slot-sharded batched RX at the bench configuration and
    dryrun_multichip(2): each gathered result held against the
    single-rank path on the card, each step's sharded ms (warm, the
    slower rank) beside the single rank's. The launches count the
    sharded runs of both ranks (warm runs and references excluded).
    Returns them."""
    import socket

    import torch.multiprocessing as mp

    kernels.build()
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    queue = mp.get_context("spawn").SimpleQueue()
    t0 = time.perf_counter()
    mp.spawn(_par_rank, args=(PAR_WORLD, port, queue), nprocs=PAR_WORLD)
    wall = time.perf_counter() - t0
    out = queue.get()
    launches = out["launches"]
    for k in ("banded_fir", "fir_up2_fused", "ldpc_minsum_flooded",
              "ldpc_minsum_packed"):
        if launches[k] <= 0:
            raise AssertionError(f"parallel_245 launched no {k}: {launches}")
    emit("parallel_245", ranks=PAR_WORLD, backend="gloo", wall_s=wall,
         steps=out["rows"], launches=launches)
    return launches


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
    # the uplink: per phase, the launches of each kernel in its run
    ul_launches = dict(sweep_pusch_tp=phase_sweep_pusch_tp(),
                       sweep_pusch_cp=phase_sweep_pusch_cp(),
                       waveform_ul=phase_waveform_ul(),
                       pusch_uci=phase_pusch_uci(),
                       waveform_ul_uci=phase_waveform_ul_uci())
    phase_polar()
    phase_polar_study()
    # the other DL channels and the test models: per phase, the launches
    # of each kernel in its run
    dl_launches = dict(testmodels=phase_testmodels(),
                       testmodel_script=phase_testmodel_script(),
                       dl_multichannel_245=phase_dl_multichannel_245())
    phase_ssb_waveform_gen()
    phase_csirs_report()
    # UL control and PRACH: per phase, the launches of each kernel in its
    # run
    ulc_launches = dict(ul_control_245=phase_ul_control_245(),
                        prach_245=phase_prach_245(),
                        csirs_report_example=phase_csirs_report_example())
    # receiver breadth: per phase, the launches of each kernel in its run
    rx_launches = dict(rx_per_slot=phase_rx_per_slot(),
                       rx_per_slot_full_width=phase_rx_per_slot_full_width(),
                       pdsch_throughput_example=(
                           phase_pdsch_throughput_example()),
                       pusch_throughput_example=(
                           phase_pusch_throughput_example()),
                       pusch_uci_per_slot=phase_pusch_uci_per_slot(),
                       harq=phase_harq())
    rows["ml2_maxlog"] = phase_ml_equalizers()
    rows["fading_channel"] = phase_fading()
    launches["ml2_maxlog"] = rx_launches["pdsch_throughput_example"][
        "ml2_maxlog"]
    rx_launches["ce_dct"] = phase_ce_dct()
    par_launches = dict(parallel_245=phase_parallel_245())
    for name in ("ldpc_minsum_flooded_fast", "ldpc_minsum_layered",
                 "ldpc_minsum_layered_fast"):
        rows[name] = bench_rows[name]
        launches[name] = bench_launches[name]
    csrc = "python_5gtoolbox_tpu_torch/csrc/"
    tpu = "python_5gtoolbox_tpu/ops/"
    table = []
    # launches: banded_fir and ldpc_minsum_flooded in the carrier-rate
    # sweep, duc_from_spec in the OFDM + DUC run, the two other DUC kernels
    # in their gen_dl_waveform calls (summed: 2 Dm waveforms, 3 carriers
    # below nfft 1024; one launch each), ldpc_minsum_packed in the
    # small-allocation sweep, the other variants of ldpc_minsum in the
    # decoder bench through ldpc_decode, ml2_maxlog in the PDSCH
    # throughput example's batched sweep (one a point), fading_channel in
    # the carrier-rate sweep (one a point); ul_launches,
    # dl_launches, rx_launches, ulc_launches and par_launches: the uplink
    # phases, the multi-channel DL phases, the receiver-breadth phases, the
    # UL-control / PRACH phases and the parallel phase that launched the
    # kernel, with their counts
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
            ("duc_from_spec", "duc_from_spec.cu", "pallas_filters.py:581"),
            # none: the JAX package's ml2 is plain jnp
            ("ml2_maxlog", "ml2_maxlog.cu", None),
            # none: the JAX package's fading generator is plain jnp
            ("fading_channel", "fading_channel.cu", None)]:
        row = rows[name]
        table.append(dict(name=name, route="cuda", source=csrc + src,
                          replaces=replaces and tpu + replaces,
                          launches=launches[name],
                          max_abs_err=row["max_abs_err"],
                          ms=row["kernel_ms"], plain_ms=row["plain_ms"],
                          bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                          library_ms=row["library_ms"],
                          ul_launches={ph: n[name] for ph, n in
                                       ul_launches.items()
                                       if n.get(name, 0) > 0},
                          dl_launches={ph: n[name] for ph, n in
                                       dl_launches.items()
                                       if n.get(name, 0) > 0},
                          rx_launches={ph: n[name] for ph, n in
                                       rx_launches.items()
                                       if n.get(name, 0) > 0},
                          ulc_launches={ph: n[name] for ph, n in
                                        ulc_launches.items()
                                        if n.get(name, 0) > 0},
                          par_launches={ph: n[name] for ph, n in
                                        par_launches.items()
                                        if n.get(name, 0) > 0}))
    emit("summary", **SUMMARY)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
