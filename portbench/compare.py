"""The numbers that decide `correct`, from one point's two sets of outputs.

Each number compares what the timed path produced (probe.Probe) with
what the configuration's reference worked out again (spec.reference) for
the same point:

  tx_err, channel_err, grid_err   relative RMS error of the TX waveform,
                                  the channel output and the RX grid:
                                  ||program - reference|| / ||reference||
  llr_err.<equalizer>             the same for that equalizer's LLRs
  flag_mismatch                   slots whose CRC flag differs from the
                                  reference's (over every equalizer)
  passed_tb_wrong                 slots the program passed whose decoded
                                  block is not the block that was sent

and, for each decoded side stream that the reference returns (its
streams and sent; the PUSCH's UCI), summed over every equalizer:

  flag_mismatch.<stream>          slots whose ok differs from the
                                  reference's
  bits_mismatch.<stream>          slots whose decoded bits differ from
                                  the reference's decoded bits
  passed_wrong.<stream>           slots the program passed whose bits
                                  are not the bits that were sent

A point's numbers are combined over the sampled points by their maximum
(the counts by their sum). A missing output (a stage the timed path no
longer went through, a shape that differs) reads inf.
"""
from __future__ import annotations

import math

import torch

STREAM_COUNTS = ("flag_mismatch", "bits_mismatch", "passed_wrong")
COUNTS = ("flag_mismatch", "passed_tb_wrong") + STREAM_COUNTS


def rel_err(got, ref) -> float:
    """||got - ref|| / ||ref|| in float64; inf where got is absent or of
    another shape."""
    if got is None or tuple(got.shape) != tuple(ref.shape):
        return math.inf
    g = torch.view_as_real(got) if got.is_complex() else got
    r = torch.view_as_real(ref) if ref.is_complex() else ref
    g, r = g.to(torch.float64), r.to(torch.float64)
    den = torch.linalg.vector_norm(r).item()
    num = torch.linalg.vector_norm(g - r).item()
    return num / den if den else (0.0 if num == 0 else math.inf)


def point_numbers(got: dict, ref: dict, trblks: torch.Tensor) -> dict:
    """-> {number: value} of one point."""
    out = {f"{k}_err": rel_err(got.get(k), ref[k])
           for k in ("tx", "channel", "grid")}
    for algo, r in ref["llr"].items():
        out[f"llr_err.{algo}"] = rel_err(got["llr"].get(algo), r)
    mismatch, wrong = 0, 0
    for algo, r_ok in ref["ok"].items():
        g_ok = got["ok"].get(algo)
        g_tb = got["tbblk"].get(algo)
        if g_ok is None or g_tb is None \
                or tuple(g_ok.shape) != tuple(r_ok.shape) \
                or tuple(g_tb.shape) != tuple(trblks.shape):
            return dict(out, flag_mismatch=math.inf,
                        passed_tb_wrong=math.inf)
        g_ok = g_ok.to(torch.bool).to(r_ok.device)
        mismatch += int((g_ok != r_ok.to(torch.bool)).sum())
        bad = (g_tb.to(trblks.device) != trblks).any(dim=1)
        wrong += int((g_ok.to(trblks.device) & bad).sum())
    out["flag_mismatch"] = float(mismatch)
    out["passed_tb_wrong"] = float(wrong)
    got_streams = got.get("streams", {})
    for name, algos in ref.get("streams", {}).items():
        out.update(stream_numbers(name, got_streams.get(name, {}), algos,
                                  ref["sent"][name]))
    return out


def stream_numbers(name: str, got: dict, ref: dict, sent) -> dict:
    """The three counts of one side stream: got and ref {equalizer:
    (bits (Sa, n), ok (Sa,))}, sent (Sa, n)."""
    keys = [f"{k}.{name}" for k in STREAM_COUNTS]
    counts = [0, 0, 0]
    for algo, (r_bits, r_ok) in ref.items():
        g = got.get(algo)
        if g is None or tuple(g[0].shape) != tuple(r_bits.shape) \
                or tuple(g[1].shape) != tuple(r_ok.shape):
            return dict.fromkeys(keys, math.inf)
        g_bits, g_ok = g[0].to(r_bits.device), g[1].to(r_ok.device, torch.bool)
        counts[0] += int((g_ok != r_ok.to(torch.bool)).sum())
        counts[1] += int((g_bits != r_bits).any(dim=1).sum())
        bad = (g_bits != sent.to(g_bits.device)).any(dim=1)
        counts[2] += int((g_ok & bad).sum())
    return {k: float(c) for k, c in zip(keys, counts)}


def combine(per_point: list[dict]) -> dict:
    """The cell's numbers over its sampled points: errors by their
    maximum, counts by their sum."""
    out: dict = {}
    for nums in per_point:
        for k, v in nums.items():
            if k.split(".")[0] in COUNTS:
                out[k] = out.get(k, 0.0) + v
            else:
                out[k] = max(out.get(k, 0.0), v)
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, list]:
    """-> (correct, [(name, value, limit)]): every limited number at or
    under its limit, and every limit read."""
    rows = [(k, numbers.get(k, math.inf), lim) for k, lim in limits.items()]
    ok = bool(rows) and all(v <= lim for _, v, lim in rows)
    return ok, rows
