"""PyTorch port, foundations: numerology, configs, GF(2), CRC, PRBS,
modulation, LDPC tables and the package's copied data files, held against
the reference goldens and the JAX package on the same numpy inputs.

Bit-level functions must match exactly; constellation points within
1e-6 (float32 rounding of the 1/sqrt(170)-style scales).
"""
import ast
import dataclasses
import filecmp
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.golden import get_golden

from python_5gtoolbox_tpu.ops import crc as jcrc
from python_5gtoolbox_tpu.ops import modulation as jmod
from python_5gtoolbox_tpu.ops import prbs as jprbs
from python_5gtoolbox_tpu.ops.ldpc import tables as jtables
from python_5gtoolbox_tpu.utils import config as jconfig
from python_5gtoolbox_tpu.utils import gf2 as jgf2
from python_5gtoolbox_tpu.utils import numerology as jnum

from python_5gtoolbox_tpu_torch.ops import crc as tcrc
from python_5gtoolbox_tpu_torch.ops import modulation as tmod
from python_5gtoolbox_tpu_torch.ops import prbs as tprbs
from python_5gtoolbox_tpu_torch.ops.ldpc import tables as ttables
from python_5gtoolbox_tpu_torch.utils import config as tconfig
from python_5gtoolbox_tpu_torch.utils import gf2 as tgf2
from python_5gtoolbox_tpu_torch.utils import numerology as tnum

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = REPO / "python_5gtoolbox_tpu"
PORT = REPO / "python_5gtoolbox_tpu_torch"


def _no_golden_gen():
    raise RuntimeError("golden file missing")


# ---------------------------------------------------------------------------
# Data files, configs, numerology, GF(2)
# ---------------------------------------------------------------------------

DATA_FILES = ["configs/default_dl_carrier_config.json",
              "configs/default_pdsch_config.json",
              "configs/default_ssb_config.json",
              "configs/default_coreset_config.json",
              "configs/default_search_space.json",
              "configs/default_pdcch_config.json",
              "configs/default_csirs_config.json",
              "configs/default_csirs_report_config.json",
              "configs/default_dl_waveform_config.json",
              "configs/default_channel_model_config.json",
              "configs/default_pusch_config.json",
              "configs/default_ul_carrier_config.json",
              "configs/default_ul_waveform_config.json",
              "configs/default_pucch_format0_config.json",
              "configs/default_pucch_format1_config.json",
              "configs/default_pucch_format2_config.json",
              "configs/default_pucch_format3_config.json",
              "configs/default_pucch_format4_config.json",
              "configs/default_srs_config.json",
              "configs/default_prach_config.json",
              "data/ldpc_basegraphs.npz",
              "data/lowpapr_phi.npz",
              "data/polar_reliability.npz",
              "data/tdl_profiles.npz",
              "data/srs_bw_config.npz",
              "data/prach_config_fr1_fdd.json",
              "data/prach_config_fr1_tdd.json",
              "data/prach_root_sequences.npz"]


@pytest.mark.parametrize("rel", DATA_FILES)
def test_data_file_copies_are_identical(rel):
    assert filecmp.cmp(JAX_PKG / rel, PORT / rel, shallow=False)


@pytest.mark.parametrize("name", ["dl_carrier", "pdsch", "channel_model",
                                  "ul_carrier", "pusch", "ul_waveform",
                                  "ssb", "coreset", "search_space", "pdcch",
                                  "csirs", "csirs_report", "dl_waveform",
                                  "pucch_format0", "pucch_format1",
                                  "pucch_format2", "pucch_format3",
                                  "pucch_format4", "srs", "prach"])
def test_default_configs(name):
    assert tconfig.get_default_config(name) == \
        jconfig.get_default_config(name)
    base = tconfig.get_default_config(name)
    over = {"x": {"y": 1}}
    assert tconfig.merged(base, over) == jconfig.merged(base, over)


@pytest.mark.parametrize("scs,bw", [(15, 5), (15, 20), (30, 10), (30, 20),
                                    (30, 100)])
def test_numerology(scs, bw):
    prb = tnum.carrier_prb_size(scs, bw)
    assert prb == jnum.carrier_prb_size(scs, bw)
    assert tnum.fft_size(prb) == jnum.fft_size(prb)
    assert tnum.cp_sizes(scs, bw) == jnum.cp_sizes(scs, bw)
    assert tnum.slot_samples(scs, bw) == jnum.slot_samples(scs, bw)
    assert tnum.slots_per_frame(scs) == jnum.slots_per_frame(scs)
    for a, b in zip(tnum.symbol_timing_offsets(scs),
                    jnum.symbol_timing_offsets(scs)):
        np.testing.assert_array_equal(a, b)


def test_gf2():
    rng = np.random.default_rng(3)
    m = rng.integers(0, 2, (31, 31)).astype(np.uint8)
    np.testing.assert_array_equal(tgf2.gf2_matpow(m, 1600),
                                  jgf2.gf2_matpow(m, 1600))
    np.testing.assert_array_equal(tgf2.int_to_bits_msb(12345, 24),
                                  jgf2.int_to_bits_msb(12345, 24))


# ---------------------------------------------------------------------------
# CRC (cases of tests/test_foundations.py)
# ---------------------------------------------------------------------------

CRC_CASES = [
    ("6", 40, 0), ("6", 40, 45678), ("11", 37, 0), ("11", 37, 12345),
    ("16", 123, 0), ("16", 123, 65535), ("24A", 100, 0), ("24A", 3824, 4567),
    ("24B", 64, 0), ("24C", 200, 17), ("24A", 8424, 0), ("24A", 275000, 0),
]


@pytest.fixture(scope="module")
def crc_goldens():
    return get_golden("crc_cases", _no_golden_gen)


@pytest.mark.parametrize("i", range(len(CRC_CASES)))
def test_crc_encode_golden(crc_goldens, i):
    poly, _, mask = CRC_CASES[i]
    got = tcrc.crc_encode(torch.as_tensor(crc_goldens[f"in_{i}"]), poly,
                          mask).numpy()
    np.testing.assert_array_equal(got, crc_goldens[f"out_{i}"])


def test_crc_batched_check_matches_jax():
    rng = np.random.default_rng(7)
    bits = rng.integers(0, 2, (5, 3256)).astype(np.int8)
    enc = tcrc.crc_encode(torch.as_tensor(bits), "16").numpy()
    np.testing.assert_array_equal(
        enc, np.asarray(jcrc.crc_encode(jnp.asarray(bits), "16")))
    enc[2, 17] ^= 1
    got = tcrc.crc_check(torch.as_tensor(enc), "16").numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jcrc.crc_check(jnp.asarray(enc), "16")))
    assert got.tolist() == [0, 0, 1, 0, 0]


# ---------------------------------------------------------------------------
# PRBS and modulation
# ---------------------------------------------------------------------------

PRBS_CASES = [(0, 100), (1, 607), (2**31 - 1, 1600), (12345678, 5000),
              (850, 14 * 12 * 273 * 2)]


@pytest.fixture(scope="module")
def prbs_goldens():
    return get_golden("prbs_cases", _no_golden_gen)


@pytest.mark.parametrize("i", range(len(PRBS_CASES)))
def test_prbs_golden(prbs_goldens, i):
    c, n = PRBS_CASES[i]
    np.testing.assert_array_equal(tprbs.gen_prbs_np(c, n),
                                  prbs_goldens[f"seq_{i}"])


def test_prbs_offset_matches_jax():
    np.testing.assert_array_equal(tprbs.gen_prbs_np(999, 500, offset=700),
                                  jprbs.gen_prbs_np(999, 500, offset=700))


MODTYPES = ["pi/2-bpsk", "bpsk", "qpsk", "16qam", "64qam", "256qam",
            "1024qam"]


@pytest.fixture(scope="module")
def mod_goldens():
    return get_golden("modulation_cases", _no_golden_gen)


@pytest.mark.parametrize("i", range(len(MODTYPES)))
def test_modulate(mod_goldens, i):
    mt = MODTYPES[i]
    bits = mod_goldens[f"in_{i}"]
    got = tmod.modulate(torch.as_tensor(bits), mt).numpy()
    np.testing.assert_allclose(got, mod_goldens[f"out_{i}"], atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jmod.modulate(bits, mt)),
                               atol=1e-6)
    np.testing.assert_allclose(tmod.modulate_np(bits, mt), got, atol=0)


# ---------------------------------------------------------------------------
# LDPC tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bgn,zc", [(1, 2), (1, 384), (2, 352), (2, 16),
                                    (2, 52), (1, 208)])
def test_ldpc_shift_tables(bgn, zc):
    np.testing.assert_array_equal(ttables.shift_table(bgn, zc),
                                  jtables.shift_table(bgn, zc))
    for b in (100, 3256, 8448, 16000):
        assert dataclasses.astuple(ttables.get_cbs_info(b, bgn)) == \
            dataclasses.astuple(jtables.get_cbs_info(b, bgn))


# ---------------------------------------------------------------------------
# The port imports neither JAX nor the JAX package
# ---------------------------------------------------------------------------

def _forbidden_imports(path: pathlib.Path):
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for name in names:
            if (name == "jax" or name.startswith("jax.")
                    or name == "python_5gtoolbox_tpu"
                    or name.startswith("python_5gtoolbox_tpu.")):
                bad.append(f"{path.name}:{node.lineno} {name}")
    return bad


def test_port_sources_import_no_jax():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                          REPO / "tests" /
                                          "torch_parallel_ranks.py"]
    assert len(files) > 20
    assert PORT / "sim" / "ldpc_decoder.py" in files
    for rel in ("ops/polar/decode.py", "ops/polar/segment.py",
                "ops/smallblock.py", "phy/pusch_uci.py",
                "sim/polar_decoder.py", "phy/validate.py", "phy/dci.py",
                "phy/ssb.py", "phy/csirs.py", "phy/pdcch.py",
                "phy/testmodel.py", "phy/csirs_report.py", "phy/grid.py",
                "sim/gen_nr_testmodel.py", "rx/channel_estimate.py",
                "sim/examples.py", "sim/nr_pdsch_throughput_example.py",
                "sim/nr_pdsch_ber_example.py",
                "sim/nr_pusch_throughput_example.py",
                "sim/nr_pusch_ber_example.py", "phy/pucch.py",
                "phy/srs.py", "phy/prach.py", "models/pathloss.py",
                "sim/nr_csirs_report_example.py", "utils/platform.py",
                "utils/profiling.py", "parallel/mesh.py",
                "parallel/timeshard.py", "parallel/tp.py",
                "parallel/pipeline.py", "parallel/dryrun.py"):
        assert PORT / rel in files, rel
    bad = [b for f in files for b in _forbidden_imports(f)]
    assert not bad, bad


def test_port_import_loads_no_jax():
    code = ("import sys, importlib, pkgutil\n"
            "import python_5gtoolbox_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'python_5gtoolbox_tpu' or "
            "m.startswith('python_5gtoolbox_tpu.')]\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
