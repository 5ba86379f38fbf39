"""PyTorch port, configuration validation: the port's NrSSB and NrPUSCH
refuse every configuration of tests/test_validate.py that the JAX
package's refuse, with a ValueError matching the same pattern, and take
the valid defaults; the port's PUCCH format classes refuse the PUCCH
cases as the JAX classes do.
"""
import pytest

from python_5gtoolbox_tpu.phy import pucch as jpucch
from python_5gtoolbox_tpu.phy import pusch as jpusch
from python_5gtoolbox_tpu.phy import ssb as jssb
from python_5gtoolbox_tpu.phy import validate as jval
from python_5gtoolbox_tpu.utils.config import get_default_config, merged

from python_5gtoolbox_tpu_torch.phy import pucch as tpucch
from python_5gtoolbox_tpu_torch.phy import pusch as tpusch
from python_5gtoolbox_tpu_torch.phy import ssb as tssb
from python_5gtoolbox_tpu_torch.phy import validate as tval


def _carrier(ul=False, **kw):
    c = get_default_config("ul_carrier" if ul else "dl_carrier")
    return merged(c, kw)


def _both_refuse(make_j, make_t, pat):
    with pytest.raises(ValueError, match=pat) as want:
        make_j()
    with pytest.raises(ValueError, match=pat) as got:
        make_t()
    assert str(got.value) == str(want.value)


def _ssb_cases():
    bad_k = get_default_config("ssb")
    bad_k["kSSB"] = 24
    bad_sib = get_default_config("ssb")
    bad_sib["MIB"]["pdcch_ConfigSIB1"] = 256
    return [(bad_k, "kSSB"), (bad_sib, "pdcch_ConfigSIB1")]


@pytest.mark.parametrize("case", range(2))
def test_ssb_valid_and_invalid(case):
    carrier = _carrier()
    tssb.NrSSB(carrier, get_default_config("ssb"), device="cpu")
    cfg, pat = _ssb_cases()[case]
    _both_refuse(lambda: jssb.NrSSB(carrier, cfg),
                 lambda: tssb.NrSSB(carrier, cfg, device="cpu"), pat)


def _pusch_cases():
    out = []
    for field, value, pat in [("rnti", 0, "rnti"),
                              ("mcs_index", 28, "mcs_index"),
                              ("nHARQID", 16, "nHARQID"),
                              ("UCIScaling", 0.7, "UCIScaling")]:
        bad = get_default_config("pusch")
        bad[field] = value
        out.append((2, bad, pat))
    bad = get_default_config("pusch")
    bad["ResAlloType1"]["RBStart"] = 270    # beyond the carrier
    out.append((2, bad, "ResAlloType1"))
    # 2 layers on 1 antenna
    out.append((1, merged(get_default_config("pusch"),
                          dict(num_of_layers=2, nNrOfAntennaPorts=2)),
                "num_of_layers"))
    return out


@pytest.mark.parametrize("case", range(6))
def test_pusch_valid_and_invalid(case):
    """NrPUSCH validates first thing, as the JAX NrPUSCH does."""
    tpusch.NrPUSCH(_carrier(ul=True, num_of_ant=2),
                   get_default_config("pusch"), device="cpu")
    nant, cfg, pat = _pusch_cases()[case]
    carrier = _carrier(ul=True, num_of_ant=nant)
    _both_refuse(lambda: jpusch.NrPUSCH(carrier, cfg),
                 lambda: tpusch.NrPUSCH(carrier, cfg, device="cpu"), pat)


@pytest.mark.parametrize("fmt,field,value,pat", [
    (0, "initialCyclicShift", 12, "initialCyclicShift"),
    (0, "SR", "maybe", "SR"),
    (1, "nrofSymbols", 3, "nrofSymbols"),
    (2, "NumUCIBits", 5, "NumUCIBits"),
    (3, "nrofPRBs", 7, "nrofPRBs"),
    (4, "occ_index", 2, "occ_index"),
])
def test_pucch_invalid(fmt, field, value, pat):
    """Each PUCCH format class validates first thing, as the JAX class."""
    carrier = _carrier(ul=True)
    cfg = get_default_config(f"pucch_format{fmt}")
    t_cls = getattr(tpucch, f"NrPUCCHFormat{fmt}")
    t_cls(carrier, cfg, device="cpu")               # default valid
    cfg[field] = value
    if fmt == 2 and field == "NumUCIBits":
        cfg["UCIbits"] = [1] * value
    _both_refuse(lambda: getattr(jpucch, f"NrPUCCHFormat{fmt}")(carrier,
                                                                cfg),
                 lambda: t_cls(carrier, cfg, device="cpu"), pat)
    _both_refuse(lambda: jval.validate_pucch_config(fmt, carrier, cfg),
                 lambda: tval.validate_pucch_config(fmt, carrier, cfg), pat)
