"""TR 38.901 V16.1.0 7.4 pathloss models (RMa/UMa/UMi/InH/InF).

Port of python_5gtoolbox_tpu/models/pathloss.py: scenario calculators
returning [PL_no_shadow_dB, SF_std_dB, Pr_LOS] and the shadow-fading
draw (keeping the reference's 10**(std/10) sigma quirk,
nr_pathloss.py:56-68). A host model with no device work, so NumPy as in
the JAX package: `d2d`/`d3d` may be arrays, and a whole cell grid of
links evaluates in one vectorized call. The shadow-fading draw takes an
explicit numpy Generator.
"""
from __future__ import annotations

import numpy as np

_C = 3e8


def _los_prob_rma(d2d):
    return np.where(d2d <= 10, 1.0, np.exp(-(np.asarray(d2d, float) - 10)
                                           / 1000))


def rma(freq_hz, los, d2d, hBS=35.0, hUT=1.5, W=20.0, h=5.0):
    """RMa pathloss -> (PL_dB, SF_std, Pr_LOS). All of d2d may be array."""
    d2d = np.asarray(d2d, float)
    fc = freq_hz / 1e9
    pr_los = _los_prob_rma(d2d)
    d3d = np.sqrt(d2d ** 2 + (hBS - hUT) ** 2)
    dbp = 2 * np.pi * hBS * hUT * freq_hz / _C

    def pl1(d):
        return (20 * np.log10(40 * np.pi * d * fc / 3)
                + min(0.03 * h ** 1.72, 10) * np.log10(d)
                - min(0.044 * h ** 1.72, 14.77)
                + 0.002 * np.log10(h) * d)

    pl_los = np.where(d2d <= dbp, pl1(d3d),
                      pl1(dbp) + 40 * np.log10(d3d / dbp))
    sf = np.where(d2d <= dbp, 4.0, 6.0)
    if los:
        return pl_los, sf, pr_los
    pl_nlos = (161.04 - 7.11 * np.log10(W) + 7.5 * np.log10(h)
               - (24.37 - 3.7 * (h / hBS) ** 2) * np.log10(hBS)
               + (43.42 - 3.11 * np.log10(hBS)) * (np.log10(d3d) - 3)
               + 20 * np.log10(fc)
               - (3.2 * np.log10(11.75 * hUT) ** 2 - 4.97))
    return np.maximum(pl_los, pl_nlos), np.full_like(d2d, 8.0), pr_los


def _he_distribution(d2d, hUT):
    """[hE, probability] list, Table 7.4.1-1 note 1 (UMa/UMi)."""
    if hUT < 13:
        return [[1, 1]]
    g = 0.0 if d2d <= 18 else 5 / 4 * (d2d / 100) ** 3 * np.exp(-d2d / 150)
    c = ((hUT - 13) / 10) ** 1.5 * g
    if c == 0:
        return [[1, 1]]
    p1 = 1 / (1 + c)
    he_list = list(np.arange(12, hUT - 1.5, 3)) + [hUT - 1.5]
    p2 = (1 - p1) / len(he_list)
    return [[1, p1]] + [[he, p2] for he in he_list]


def uma(freq_hz, los, d2d, hUT=1.5, hE=1.0, optional=False, hBS=25.0):
    d2d = np.asarray(d2d, float)
    fc = freq_hz / 1e9
    c_hut = 0.0 if hUT <= 13 else ((hUT - 13) / 10) ** 1.5
    pr = (18 / np.maximum(d2d, 18)
          + np.exp(-d2d / 63) * (1 - 18 / np.maximum(d2d, 18)))
    pr_los = np.where(
        d2d <= 18, 1.0,
        pr * (1 + c_hut * 5 / 4 * (d2d / 100) ** 3 * np.exp(-d2d / 150)))
    d3d = np.sqrt(d2d ** 2 + (hBS - hUT) ** 2)
    dbp = 4 * (hBS - hE) * (hUT - hE) * freq_hz / _C
    pl_los = np.where(
        d2d <= dbp,
        28.0 + 22 * np.log10(d3d) + 20 * np.log10(fc),
        28.0 + 40 * np.log10(d3d) + 20 * np.log10(fc)
        - 9 * np.log10(dbp ** 2 + (hBS - hUT) ** 2))
    if los:
        return pl_los, np.full_like(d2d, 4.0), pr_los
    if optional:
        return (32.4 + 20 * np.log10(fc) + 30 * np.log10(d3d),
                np.full_like(d2d, 7.8), pr_los)
    pl_nlos = (13.54 + 39.08 * np.log10(d3d) + 20 * np.log10(fc)
               - 0.6 * (hUT - 1.5))
    return np.maximum(pl_los, pl_nlos), np.full_like(d2d, 6.0), pr_los


def umi(freq_hz, los, d2d, hUT=1.5, hE=1.0, optional=False, hBS=10.0):
    d2d = np.asarray(d2d, float)
    fc = freq_hz / 1e9
    pr_los = np.where(
        d2d <= 18, 1.0,
        18 / np.maximum(d2d, 18)
        + np.exp(-d2d / 36) * (1 - 18 / np.maximum(d2d, 18)))
    d3d = np.sqrt(d2d ** 2 + (hBS - hUT) ** 2)
    dbp = 4 * (hBS - hE) * (hUT - hE) * freq_hz / _C
    pl_los = np.where(
        d2d <= dbp,
        32.4 + 21 * np.log10(d3d) + 20 * np.log10(fc),
        32.4 + 40 * np.log10(d3d) + 20 * np.log10(fc)
        - 9.5 * np.log10(dbp ** 2 + (hBS - hUT) ** 2))
    if los:
        return pl_los, np.full_like(d2d, 4.0), pr_los
    if optional:
        return (32.4 + 20 * np.log10(fc) + 31.9 * np.log10(d3d),
                np.full_like(d2d, 8.2), pr_los)
    pl_nlos = (35.3 * np.log10(d3d) + 22.4 + 21.3 * np.log10(fc)
               - 0.3 * (hUT - 1.5))
    return np.maximum(pl_los, pl_nlos), np.full_like(d2d, 7.82), pr_los


def inh(freq_hz, los, d3d, hBS=3.0, hUT=1.0, optional=False,
        office_type="Mixed"):
    d3d = np.asarray(d3d, float)
    fc = freq_hz / 1e9
    d2d = np.sqrt(np.maximum(d3d ** 2 - (hBS - hUT) ** 2, 0.0))
    if office_type == "Mixed":
        pr_los = np.where(
            d2d <= 1.2, 1.0,
            np.where(d2d < 6.5, np.exp(-(d2d - 1.2) / 4.7),
                     np.exp(-(d2d - 6.5) / 32.6) * 0.32))
    else:
        pr_los = np.where(
            d2d <= 5, 1.0,
            np.where(d2d <= 49, np.exp(-(d2d - 5) / 70.8),
                     np.exp(-(d2d - 49) / 211.7) * 0.54))
    pl_los = 32.4 + 17.3 * np.log10(d3d) + 20 * np.log10(fc)
    if los:
        return pl_los, np.full_like(d3d, 3.0), pr_los
    if optional:
        return (32.4 + 20 * np.log10(fc) + 31.9 * np.log10(d3d),
                np.full_like(d3d, 8.29), pr_los)
    pl_nlos = 38.3 * np.log10(d3d) + 17.3 + 24.9 * np.log10(fc)
    return np.maximum(pl_los, pl_nlos), np.full_like(d3d, 8.03), pr_los


_INF_NLOS = {"SL": (33.0, 25.5, 5.7), "DL": (18.6, 35.7, 7.2),
             "SH": (32.4, 23.0, 5.8), "DH": (33.63, 21.9, 4.0)}


def inf_(freq_hz, los, d3d, type="SL"):
    d3d = np.asarray(d3d, float)
    fc = freq_hz / 1e9
    pr_los = np.ones_like(d3d)
    pl_los = 31.84 + 21.5 * np.log10(d3d) + 19.0 * np.log10(fc)
    if los:
        return pl_los, np.full_like(d3d, 4.3), pr_los
    if type == "HH":
        return pl_los, np.full_like(d3d, 4.3), pr_los
    a, b, sf = _INF_NLOS[type]
    pl_nlos = a + b * np.log10(d3d) + 20.0 * np.log10(fc)
    return np.maximum(pl_los, pl_nlos), np.full_like(d3d, sf), pr_los


class NrPathloss:
    """Reference-compatible scenario dispatcher (nr_pathloss.py:10-68)."""

    _DEFAULTS = {
        "RMa": dict(hBS=35.0, hUT=1.5, W=20.0, h=5.0, d2D=20.0),
        "UMa": dict(hBS=25.0, hUT=1.5, hE=1.0, d2D=20.0, optional=False),
        "UMi": dict(hBS=10.0, hUT=1.5, hE=1.0, d2D=20.0, optional=False),
        "InH": dict(hBS=3.0, hUT=1.0, d3D=20.0, optional=False,
                    office_type="Mixed"),
        "InF": dict(d3D=20.0, type="SL"),
    }

    def __init__(self, Scenario="RMa", freq_in_Hz=3e9, LOS=True,
                 rng: np.random.Generator | None = None, **overrides):
        """rng: the shadow-fading draws' Generator (default: seeded
        with 0)."""
        self.set_Scenario(Scenario, freq_in_Hz, LOS, **overrides)
        self._rng = np.random.default_rng(0) if rng is None else rng

    def set_Scenario(self, Scenario, freq_in_Hz=3e9, LOS=True, **overrides):
        assert Scenario in self._DEFAULTS, Scenario
        self.Scenario = Scenario
        self.config = dict(self._DEFAULTS[Scenario], **overrides)
        self.freq_in_Hz = freq_in_Hz
        self.LOS = LOS

    def get_supported_Scenario_list(self):
        return ["UMa", "UMi", "RMa", "InH", "InF"]

    def get_config(self):
        return dict(Scenario=self.Scenario, Scenario_config=self.config,
                    freq_in_Hz=self.freq_in_Hz, LOS=self.LOS)

    def gen_pathloss_info(self):
        c = self.config
        if self.Scenario == "RMa":
            return list(rma(self.freq_in_Hz, self.LOS, c["d2D"], c["hBS"],
                            c["hUT"], c["W"], c["h"]))
        if self.Scenario == "UMa":
            return list(uma(self.freq_in_Hz, self.LOS, c["d2D"], c["hUT"],
                            c["hE"], c["optional"], c["hBS"]))
        if self.Scenario == "UMi":
            return list(umi(self.freq_in_Hz, self.LOS, c["d2D"], c["hUT"],
                            c["hE"], c["optional"], c["hBS"]))
        if self.Scenario == "InH":
            return list(inh(self.freq_in_Hz, self.LOS, c["d3D"], c["hBS"],
                            c["hUT"], c["optional"], c["office_type"]))
        return list(inf_(self.freq_in_Hz, self.LOS, c["d3D"], c["type"]))

    def gen_new_pathloss(self):
        """PL + shadow fading draw (keeps the reference's 10**(std/10)
        sigma convention, nr_pathloss.py:62-68)."""
        pl, sf_std, _ = self.gen_pathloss_info()
        return pl + self._rng.normal(0, 10 ** (np.asarray(sf_std) / 10))

    def get_hE_distribution(self):
        assert self.Scenario in ("UMa", "UMi")
        return _he_distribution(self.config["d2D"], self.config["hUT"])
