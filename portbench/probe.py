"""What the timed path produced, kept for the comparison with the reference.

The probe wraps a few entry points of the port for the length of a run
and, while a sampled point runs (armed), keeps a copy of what each one
returned: the TX waveform (waveform.dl.gen_dl_waveform /
waveform.ul.gen_ul_waveform), the channel output (NrChannelModel.filter),
the RX front end's grid (waveform.rx.waveform_rx_processing), every
equalizer's LLRs (rx.batch_core.equalize_and_demod_traced on the
slot-batched RX, phy.pdsch_rx.channel_equ_and_demod per slot), the
decoded blocks with their CRC flags (rx_process_batch / RX_process of
the PDSCH and the PUSCH) and the decoded side streams beside them (the
PUSCH's UCI: rx_process_batch's third result, RX_process's fourth, a
dict {name: (bits, ok)}). Unarmed, a wrapper only calls through. The
wrapped functions run unchanged: the probe reads their results and
copies them (one device copy per stage of a sampled point).
"""
from __future__ import annotations

import importlib

import torch

PORT = "python_5gtoolbox_tpu_torch"


def _copy(x):
    return x.detach().clone() if isinstance(x, torch.Tensor) else x


class Probe:
    """Install with install(), arm with arm(key) before a sampled point,
    disarm() after it; taken[key] then holds that point's outputs."""

    def __init__(self):
        self.taken: dict = {}
        self._key = None
        self._undo = []

    def arm(self, key) -> None:
        self._key = key
        self.taken[key] = dict(llr={}, ok={}, tbblk={}, streams={})

    def disarm(self) -> None:
        self._key = None

    def _put(self, name, value, algo=None, append=False):
        if self._key is None:
            return
        rec = self.taken[self._key]
        if algo is None:
            rec[name] = _copy(value)
        elif append:
            rec[name].setdefault(algo, []).append(_copy(value))
        else:
            rec[name][algo] = _copy(value)

    def _put_streams(self, streams: dict, algo, append=False):
        """streams {name: (bits, ok)} of one equalizer into
        streams[name][algo] (a list of per-slot pairs with append)."""
        if self._key is None:
            return
        rec = self.taken[self._key]["streams"]
        for name, (bits, ok) in streams.items():
            pair = (_copy(torch.as_tensor(bits)), _copy(torch.as_tensor(ok)))
            if append:
                rec.setdefault(name, {}).setdefault(algo, []).append(pair)
            else:
                rec.setdefault(name, {})[algo] = pair

    def _wrap(self, owner, attr, make):
        orig = getattr(owner, attr)
        setattr(owner, attr, make(orig))
        self._undo.append((owner, attr, orig))

    def install(self) -> None:
        dl = importlib.import_module(f"{PORT}.waveform.dl")
        ul = importlib.import_module(f"{PORT}.waveform.ul")
        rx = importlib.import_module(f"{PORT}.waveform.rx")
        chan = importlib.import_module(f"{PORT}.models.channel")
        core = importlib.import_module(f"{PORT}.rx.batch_core")
        prx = importlib.import_module(f"{PORT}.phy.pdsch_rx")
        pdsch = importlib.import_module(f"{PORT}.phy.pdsch")
        pusch = importlib.import_module(f"{PORT}.phy.pusch")
        put = self._put

        def tx(orig):
            def fn(*a, **k):
                out = orig(*a, **k)
                put("tx", out[2])
                return out
            return fn

        def channel(orig):
            def fn(model, *a, **k):
                out = orig(model, *a, **k)
                put("channel", out)
                return out
            return fn

        def front_end(orig):
            def fn(*a, **k):
                out = orig(*a, **k)
                put("grid", out[1])
                return out
            return fn

        def eq_batch(orig):
            def fn(y, h, cov, modtype, algo):
                out = orig(y, h, cov, modtype, algo)
                put("llr", out, algo, append=True)
                return out
            return fn

        def eq_slot(orig):
            def fn(y, h, cov, modtype, ceq_config, device=None):
                out = orig(y, h, cov, modtype, ceq_config, device)
                put("llr", out[3], ceq_config["algo"], append=True)
                return out
            return fn

        def rx_batch(orig):
            def fn(obj, rx_fd, slots, ceq_config, *a, **k):
                out = orig(obj, rx_fd, slots, ceq_config, *a, **k)
                put("ok", out[0], ceq_config["algo"])
                put("tbblk", out[1], ceq_config["algo"])
                if len(out) > 2 and isinstance(out[2], dict):
                    self._put_streams(out[2], ceq_config["algo"])
                return out
            return fn

        def rx_slot(orig):
            def fn(obj, rx_fd, slot, ceq_config, *a, **k):
                out = orig(obj, rx_fd, slot, ceq_config, *a, **k)
                put("ok", torch.as_tensor(out[0]), ceq_config["algo"],
                    append=True)
                put("tbblk", out[1], ceq_config["algo"], append=True)
                if len(out) > 3 and isinstance(out[3], dict) and out[3]:
                    self._put_streams(out[3], ceq_config["algo"],
                                      append=True)
                return out
            return fn

        self._wrap(dl, "gen_dl_waveform", tx)
        self._wrap(ul, "gen_ul_waveform", tx)
        self._wrap(chan.NrChannelModel, "filter", channel)
        self._wrap(rx, "waveform_rx_processing", front_end)
        self._wrap(core, "equalize_and_demod_traced", eq_batch)
        self._wrap(prx, "channel_equ_and_demod", eq_slot)
        for cls in (pdsch.Pdsch, pusch.NrPUSCH):
            self._wrap(cls, "rx_process_batch", rx_batch)
            self._wrap(cls, "RX_process", rx_slot)

    def uninstall(self) -> None:
        while self._undo:
            owner, attr, orig = self._undo.pop()
            setattr(owner, attr, orig)

    def outputs(self, key) -> dict:
        """The point's outputs in the reference's layout: per-slot lists
        stacked, LLR pieces concatenated in call order."""
        rec = self.taken[key]
        out = {k: v for k, v in rec.items() if k not in ("llr", "ok",
                                                          "tbblk", "streams")}
        out["llr"] = {a: torch.cat(v) for a, v in rec["llr"].items()}
        for name in ("ok", "tbblk"):
            out[name] = {a: torch.stack(v) if isinstance(v, list) else v
                         for a, v in rec[name].items()}
        out["streams"] = {
            name: {a: tuple(torch.stack(x) for x in zip(*v))
                   if isinstance(v, list) else v for a, v in algos.items()}
            for name, algos in rec["streams"].items()}
        return out
