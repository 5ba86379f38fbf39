"""CSI report: RI / PMI / CQI from CSI-RS, TS 38.214 5.2.2.

Port of python_5gtoolbox_tpu/phy/csirs_report.py. The reference declares
this feature but ships it as a stub
(py5gphy/scripts/NR_CSIRS_report_example.py:118-128); the JAX package
implements it, scoped to what the reference's config schema declares
(default_csirs_report_config.json): Type-I single-panel codebooks for
1/2/4 CSI-RS ports (38.214 Tables 5.2.2.2.1-1..8 with N1=2, N2=1, O1=4
for 4 ports), CQI tables 1/2/3 (38.214 Tables 5.2.2.1-2/3/4),
Wideband/Subband CQI+PMI modes with subband sizes per Table 5.2.1.4-2.

One despreading gather turns the received grid into per-CDM-group LS
channel estimates; RI/PMI/CQI selection is one batched einsum of the
subband channel against the whole codebook (nsb, Nr, P) x (ncw, P, v)
-> per-(subband, codeword) MMSE layer SINRs through a batched v x v
inverse. The einsums and the inverse run on the report's device in
complex64. On the card they keep full float32 precision only with TF32
off (torch.backends.cuda.matmul.allow_tf32 False, PyTorch's default):
leave it off. The codebooks and the selection bookkeeping stay on the
host.

CQI mapping uses the ideal-link abstraction: per-layer spectral
efficiency log2(1+SINR_mmse) averaged per subband, reported as the
highest CQI whose table efficiency does not exceed it. CQI 0 means
out of range.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from python_5gtoolbox_tpu_torch import on_device, resolve_device
from python_5gtoolbox_tpu_torch.phy.csirs import NrCSIRS

# 38.214 Table 5.2.2.1-2 (table1, 64QAM), -3 (table2, 256QAM),
# -4 (table3, 64QAM low SE): (modulation order Qm, R*1024, efficiency)
CQI_TABLES = {
    "table1": [(2, 78, 0.1523), (2, 120, 0.2344), (2, 193, 0.3770),
               (2, 308, 0.6016), (2, 449, 0.8770), (2, 602, 1.1758),
               (4, 378, 1.4766), (4, 490, 1.9141), (4, 616, 2.4063),
               (6, 466, 2.7305), (6, 567, 3.3223), (6, 666, 3.9023),
               (6, 772, 4.5234), (6, 873, 5.1152), (6, 948, 5.5547)],
    "table2": [(2, 78, 0.1523), (2, 193, 0.3770), (2, 449, 0.8770),
               (4, 378, 1.4766), (4, 490, 1.9141), (4, 616, 2.4063),
               (6, 466, 2.7305), (6, 567, 3.3223), (6, 666, 3.9023),
               (6, 772, 4.5234), (6, 873, 5.1152), (8, 711, 5.5547),
               (8, 797, 6.2266), (8, 885, 6.9141), (8, 948, 7.4063)],
    "table3": [(2, 30, 0.0586), (2, 50, 0.0977), (2, 78, 0.1523),
               (2, 120, 0.2344), (2, 193, 0.3770), (2, 308, 0.6016),
               (2, 449, 0.8770), (2, 602, 1.1758), (4, 378, 1.4766),
               (4, 490, 1.9141), (4, 616, 2.4063), (6, 466, 2.7305),
               (6, 567, 3.3223), (6, 666, 3.9023), (6, 772, 4.5234)],
}

# 38.214 Table 5.2.1.4-2: configurable subband sizes by BWP PRB count
_SUBBAND_SIZES = [(24, 72, (4, 8)), (73, 144, (8, 16)), (145, 275, (16, 32))]


def valid_subband_sizes(n_prb: int) -> tuple[int, ...]:
    for lo, hi, sizes in _SUBBAND_SIZES:
        if lo <= n_prb <= hi:
            return sizes
    return ()  # < 24 PRB: wideband only


@functools.lru_cache(maxsize=None)
def type1_sp_codebook(nports: int, rank: int):
    """Type-I single-panel precoders (38.214 5.2.2.2.1, codebookMode 1).

    Returns (W, meta): W complex64 (ncw, nports, rank) and meta a tuple
    of dicts {"i11", "i13", "i2"} per codeword. For 4 ports the panel
    is (N1, N2) = (2, 1) with (O1, O2) = (4, 1) - the only layout the
    schema's 1/2/4-port scope admits.
    """
    assert nports in (1, 2, 4) and 1 <= rank <= nports
    if nports == 1:
        return (np.ones((1, 1, 1), np.complex64),
                ({"i11": 0, "i13": 0, "i2": 0},))
    phi = np.array([1, 1j, -1, -1j])
    if nports == 2:
        # Table 5.2.2.2.1-1
        if rank == 1:
            ws = [np.array([[1], [phi[n]]]) / np.sqrt(2) for n in range(4)]
            meta = tuple({"i11": 0, "i13": 0, "i2": n} for n in range(4))
        else:
            ws = [np.array([[1, 1], [phi[n], -phi[n]]]) / 2 for n in range(2)]
            meta = tuple({"i11": 0, "i13": 0, "i2": n} for n in range(2))
        return np.stack(ws).astype(np.complex64), meta
    # 4 ports, (N1, N2, O1) = (2, 1, 4): beams v_l = [1, e^{2 pi i l/8}]
    n1o1 = 8
    vl = np.exp(2j * np.pi * np.arange(n1o1) / n1o1)

    def beam(l):
        return np.array([1.0, vl[l % n1o1]])

    ws, meta = [], []
    if rank == 1:
        # Table 5.2.2.2.1-5: W = 1/2 [v; phi_n v]
        for l in range(n1o1):
            for n in range(4):
                v = beam(l)
                ws.append(np.concatenate([v, phi[n] * v])[:, None] / 2)
                meta.append({"i11": l, "i13": 0, "i2": n})
    elif rank == 2:
        # Table 5.2.2.2.1-6; i13 -> k1 per Table 5.2.2.2.1-3
        # (N1=2, N2=1: k1 in {0, O1})
        for i13, k1 in enumerate((0, 4)):
            for l in range(n1o1):
                for n in range(2):
                    v, vp = beam(l), beam(l + k1)
                    col = [np.concatenate([v, phi[n] * v]),
                           np.concatenate([vp, -phi[n] * vp])]
                    ws.append(np.stack(col, 1) / np.sqrt(8))
                    meta.append({"i11": l, "i13": i13, "i2": n})
    elif rank == 3:
        # Table 5.2.2.2.1-7 (P_CSIRS < 16); k1 = O1 per Table 5.2.2.2.1-4
        k1 = 4
        for l in range(n1o1):
            for n in range(2):
                v, vp = beam(l), beam(l + k1)
                col = [np.concatenate([v, phi[n] * v]),
                       np.concatenate([vp, phi[n] * vp]),
                       np.concatenate([v, -phi[n] * v])]
                ws.append(np.stack(col, 1) / np.sqrt(12))
                meta.append({"i11": l, "i13": 0, "i2": n})
    else:
        # Table 5.2.2.2.1-8 (P_CSIRS < 16); k1 = O1
        k1 = 4
        for l in range(n1o1):
            for n in range(2):
                v, vp = beam(l), beam(l + k1)
                col = [np.concatenate([v, phi[n] * v]),
                       np.concatenate([vp, phi[n] * vp]),
                       np.concatenate([v, -phi[n] * v]),
                       np.concatenate([vp, -phi[n] * vp])]
                ws.append(np.stack(col, 1) / 4)
                meta.append({"i11": l, "i13": 0, "i2": n})
    return np.stack(ws).astype(np.complex64), tuple(meta)




def csirs_channel_estimate(fd_slot_rx, nrcsirs: NrCSIRS, sfn: int,
                           slot: int):
    """LS estimate at CSI-RS REs with fd-CDM2 despreading.

    fd_slot_rx: (Nr, 14*n_sc) received grid of one slot, a tensor (a
    numpy array goes to resolve_device(None), the card). Returns (H, prb_of_group,
    n_var): H complex64 (ngroups, Nr, P) on fd_slot_rx's device, one
    estimate per CDM group, aligned across ports by frequency order;
    prb_of_group numpy int (ngroups,); n_var the per-RE noise power (a
    0-d tensor) estimated from adjacent-group differences.

    Reference behavior source for the RE layout being despread:
    py5gphy/nr_csirs/nr_csirs_row{1..5}_process.py (the TX mapping);
    the estimation itself has no reference counterpart (stub).
    """
    ports = nrcsirs.cfg["nrofPorts"]
    n_sc = 12 * nrcsirs.prb_size
    tx = torch.zeros((ports, 14 * n_sc), dtype=torch.complex64)
    nrcsirs.process(tx, np.zeros((ports, 14 * n_sc), np.int8), sfn, slot)
    tx = tx.numpy()
    gsz = 2 if nrcsirs.cfg["cdm_type"] == "fd-CDM2" else 1

    y = on_device(fd_slot_rx).to(torch.complex64)
    dev = y.device
    hs, prbs = [], None
    for p in range(ports):
        idx = np.flatnonzero(tx[p])
        assert idx.size and idx.size % gsz == 0, "no CSI-RS in this slot"
        grp = idx.reshape(-1, gsz)                     # (ng, gsz)
        x = torch.as_tensor(tx[p][grp], device=dev)    # (ng, gsz)
        # despread: orthogonal covers cancel the co-scheduled port
        hs.append(torch.einsum("gj,rgj->gr", x.conj(),
                               y[:, torch.as_tensor(grp, device=dev)]) / gsz)
        if p == 0:
            prbs = (grp[:, 0] % n_sc) // 12
    h = torch.stack(hs, -1)                            # (ng, Nr, P)
    # Blind noise estimate from second differences across adjacent CDM
    # groups: d2 = h[k+1] - 2 h[k] + h[k-1] cancels any linearly-varying
    # channel (Var(d2) = 6 sigma_h^2 for white estimation noise). A
    # quadratic-or-faster channel variation still leaks in and biases
    # SINR/CQI low on very dispersive channels: pass noise_var to
    # report() when a receiver-side estimate is available.
    ng = h.shape[0]
    if ng >= 3:
        d2 = h[2:] - 2.0 * h[1:-1] + h[:-2]
        n_var = torch.mean(d2.abs() ** 2) / 6 * gsz
    elif ng == 2:
        # second differences are empty: the first difference,
        # Var(d1) = 2 sigma_h^2
        d1 = h[1:] - h[:-1]
        n_var = torch.mean(d1.abs() ** 2) / 2 * gsz
    else:
        # single group: no blind estimate exists; a -30 dB floor relative
        # to the estimate power
        n_var = torch.mean(h.abs() ** 2) * 1e-3 * gsz
    return h, prbs, n_var


def _mmse_layer_sinr(h_sb: torch.Tensor, w: torch.Tensor,
                     n_var: float) -> torch.Tensor:
    """(nsb, Nr, P) x (ncw, P, v) -> per-layer MMSE SINR (nsb, ncw, v)."""
    heff = torch.einsum("grp,cpv->gcrv", h_sb, w)
    g = torch.einsum("gcrv,gcru->gcvu", heff.conj(), heff)
    v = w.shape[-1]
    a = torch.eye(v, dtype=g.dtype, device=g.device) + g / n_var
    diag = torch.linalg.inv(a).diagonal(dim1=-2, dim2=-1).real
    return 1.0 / diag.clamp(min=1e-12) - 1.0


class NrCSIRSReport:
    """RI/PMI/CQI reporting on a CSI-RS resource (TS 38.214 5.2.2).

    device (None -> cuda) is where the channel estimate and the codebook
    search run."""

    def __init__(self, carrier_config: dict, csirs_config: dict,
                 csirs_report_config: dict, n_rx: int, device=None):
        self.nrcsirs = NrCSIRS(carrier_config, csirs_config)
        self.device = resolve_device(device)
        # the reference schema carries trailing-space key quirks
        rc = {k.strip(): v for k, v in csirs_report_config.items()}
        self.cqi_table = CQI_TABLES[rc.get("CQITable", "table1")]
        assert rc.get("CodebookType", "Type1SinglePanel") == \
            "Type1SinglePanel", "only Type1SinglePanel is in scope"
        assert rc.get("CodebookMode", 1) == 1, \
            "codebookMode 2 adds nothing for N1=2,N2=1 (38.214 5.2.2.2.1)"
        self.cqi_mode = rc.get("CQIMode", "Wideband")
        self.pmi_mode = rc.get("PMIMode", "Wideband")
        self.n_rx = n_rx
        self.prb_size = self.nrcsirs.prb_size
        self.sb_size = rc.get("SubbandSize", 8)
        # 38.214 5.2.1.4: subbands are BWP-relative with a possibly
        # partial first subband of sb_size - (N_start_BWP mod sb_size)
        # PRBs; one BWP per carrier at CRB offset 0 by default
        self.n_start_bwp = int(rc.get("NStartBWP", 0))
        if "Subband" in (self.cqi_mode, self.pmi_mode):
            ok = valid_subband_sizes(self.prb_size)
            assert self.sb_size in ok, (
                f"SubbandSize {self.sb_size} invalid for {self.prb_size} "
                f"PRB (38.214 Table 5.2.1.4-2 allows {ok})")

    def is_valid_slot(self, sfn: int, slot: int) -> bool:
        return self.nrcsirs.is_active_slot(sfn, slot)

    def _cqi_from_se(self, se: float) -> int:
        eff = [e for _, _, e in self.cqi_table]
        return int(np.searchsorted(np.asarray(eff), se + 1e-9))

    def report(self, fd_slot_rx, sfn: int, slot: int,
               noise_var: float | None = None) -> dict:
        """Compute {RI, PMI, CQI, ...} from one received slot grid
        (Nr, 14*n_sc), a tensor or numpy array, moved to self.device."""
        dev = self.device
        h, prbs, n_est = csirs_channel_estimate(
            torch.as_tensor(fd_slot_rx, device=dev), self.nrcsirs, sfn,
            slot)
        n_var = float(n_est) if noise_var is None else float(noise_var)
        n_var = max(n_var, 1e-9)
        # average the per-group estimates into subbands (boundaries per
        # 38.214 5.2.1.4: partial first subband when the BWP start is
        # not subband-aligned)
        sb_of_group = (np.asarray(prbs)
                       + self.n_start_bwp % self.sb_size) // self.sb_size
        sbs = np.unique(sb_of_group)
        sel = np.stack([(sb_of_group == s) for s in sbs]).astype(np.float32)
        sel = torch.as_tensor(sel / sel.sum(1, keepdims=True), device=dev)
        h_sb = torch.einsum("sg,grp->srp", sel.to(h.dtype), h)

        ports = self.nrcsirs.cfg["nrofPorts"]
        best = None  # (cap, (rank, W, meta, cap_sb (nsb, ncw), ...))
        for rank in range(1, min(ports, self.n_rx) + 1):
            w, meta = type1_sp_codebook(ports, rank)
            sinr = _mmse_layer_sinr(h_sb, torch.as_tensor(w, device=dev),
                                    n_var)
            cap_np = torch.log2(1.0 + sinr).sum(-1).cpu().numpy()
            if self.pmi_mode == "Subband":
                # i11/i13 wideband, i2 per subband: group codewords
                groups = {}
                for c, m in enumerate(meta):
                    groups.setdefault((m["i11"], m["i13"]), []).append(c)
                g_tot = {k: cap_np[:, cs].max(1).sum()
                         for k, cs in groups.items()}
                k_best = max(g_tot, key=g_tot.get)
                tot = g_tot[k_best]
                pick = (rank, w, meta, cap_np, groups[k_best], k_best)
            else:
                tot_per_cw = cap_np.sum(0)
                c_best = int(tot_per_cw.argmax())
                tot = tot_per_cw[c_best]
                pick = (rank, w, meta, cap_np, [c_best], None)
            if best is None or tot > best[0]:
                best = (tot, pick)
        _, (rank, w, meta, cap_np, cands, k_best) = best

        nsb = cap_np.shape[0]
        if self.pmi_mode == "Subband":
            sb_choice = [cands[int(cap_np[s, cands].argmax())]
                         for s in range(nsb)]
            pmi = {"i11": k_best[0], "i13": k_best[1],
                   "i2": [meta[c]["i2"] for c in sb_choice]}
            cap_sel = np.array([cap_np[s, c]
                                for s, c in enumerate(sb_choice)])
        else:
            c = cands[0]
            pmi = {"i11": meta[c]["i11"], "i13": meta[c]["i13"],
                   "i2": meta[c]["i2"]}
            cap_sel = cap_np[:, c]

        se_sb = cap_sel / rank                        # per-layer SE
        wb_se = float(se_sb.mean())
        out = {"RI": rank, "PMI": pmi, "CQI": self._cqi_from_se(wb_se),
               "wideband_SE": wb_se, "noise_var": n_var,
               "subbands": [int(s) for s in sbs]}
        if self.cqi_mode == "Subband":
            out["subband_CQI"] = [self._cqi_from_se(float(s))
                                  for s in se_sb]
        return out
