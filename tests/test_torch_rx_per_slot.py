"""PyTorch port, the per-slot receive path: the LS estimates and resource
copies (phy/pdsch_rx.py, phy/pusch_rx.py), the DL-SCH / UL-SCH decode
with HARQ combining (the cases of tests/test_harq.py), RX_process on the
PDSCH, the PUSCH in CP-OFDM and DFT-s-OFDM and with UCI (polar and
small-block), the per-slot sweeps (run_pdsch_throughput(use_batch=False),
run_pusch_throughput(decode_uci=True)) on the JAX run's draws, the HARQ
chain of tests/test_batch_rx_harq.py (batched == per slot) and one tiny
call of each example module, all against the JAX package.

Tolerances: LS estimates and resource copies 1e-6 (the same float32
products); the rate-recovered, HARQ-combined buffers 1e-6 relative on
identical LLRs; decode flags, TB bits, UCI bits and pass rates exactly.
Small size: BW 10, 12-16 RBs, 1-2 slots.
"""
import numpy as np
import pytest
import torch

from tests.test_torch_pusch_rx import _config
from tests.test_torch_pusch_uci import _uci_config
from tests.test_torch_slice import (CE, LDPC, N_SLOTS, _jax_states,
                                    _small_config)

from python_5gtoolbox_tpu.phy import pdsch as jpdsch
from python_5gtoolbox_tpu.phy import pdsch_rx as jdrx
from python_5gtoolbox_tpu.phy import pusch as jpusch
from python_5gtoolbox_tpu.phy import pusch_rx as jurx
from python_5gtoolbox_tpu.rx.channel_estimate import \
    NrChannelEstimation as JCE
from scripts.internal import sim_pdsch_throughput_internal as jsim
from scripts.internal import sim_pusch_throughput_internal as jusim

from python_5gtoolbox_tpu_torch.models import channel as tchan
from python_5gtoolbox_tpu_torch.phy import pdsch as tpdsch
from python_5gtoolbox_tpu_torch.phy import pdsch_rx as tdrx
from python_5gtoolbox_tpu_torch.phy import pusch as tpusch
from python_5gtoolbox_tpu_torch.phy import pusch_rx as turx
from python_5gtoolbox_tpu_torch.phy import tbsize as ttbs
from python_5gtoolbox_tpu_torch.rx.channel_estimate import \
    NrChannelEstimation as TCE
from python_5gtoolbox_tpu_torch.sim import (nr_pdsch_ber_example,
                                            nr_pdsch_throughput_example,
                                            nr_pusch_ber_example,
                                            nr_pusch_throughput_example)
from python_5gtoolbox_tpu_torch.sim import pdsch_throughput as tsim
from python_5gtoolbox_tpu_torch.sim import pusch_throughput as tusim

CE_FO = dict(CE, enable_FO_est=True, enable_FO_comp=True)
# ACK 2 bits (special small-block code) + CSI1 14 bits (polar), and ACK 2
# + CSI1 5 (Reed-Muller): one polar stream, so that the JAX package
# compiles one polar decoder for the RX_process test and the UCI sweep
POLAR_UCI = ([1, 0], 14)
SMALL_UCI = ([1, 0], 5)
# MCS of the UL cases, chosen so that the JAX package compiles two LDPC
# decoders for this file: TBS 2536 (BG2, Zc 256: the DL case, cp_2layer
# at its MCS 5 and the HARQ cases) and TBS 2280 (BG2, Zc 240: QPSK at
# MCS 9 of MCStable61411 with transform precoding, MCS 2 of the 256QAM
# table in the UCI configurations)
UL_MCS = {"tp_qpsk": 9, "uci_polar": 2, "uci_small": 2}


def _uci(ack, n_csi1, payload):
    carrier, pusch = _uci_config(ack, n_csi1, payload)
    pusch["mcs_index"] = UL_MCS["uci_polar"]
    return carrier, pusch


def _rx(grid_fn, nt, nr, seed=6, noise=0.05):
    """A received slot: the port's TX grid (nt, 14*n_sc) through a fixed
    nr x nt channel plus AWGN, numpy complex64."""
    fd = grid_fn()
    rng = np.random.default_rng(seed)
    hmat = (rng.normal(size=(nr, nt)) + 1j * rng.normal(size=(nr, nt))) / 2
    rx = hmat @ fd
    return (rx + noise * (rng.normal(size=rx.shape)
                          + 1j * rng.normal(size=rx.shape))
            ).astype(np.complex64)


def _dl_case():
    carrier, pdsch, _, _ = _small_config()
    ch = tpdsch.Pdsch(pdsch, carrier, device="cpu")
    blocks = np.random.default_rng(4).integers(0, 2, (2, ch.tbsize),
                                               dtype=np.int8)
    grid = ch.tx_grid_batch([0, 1], trblks=blocks).numpy()
    rx = [_rx(lambda g=g: g.reshape(2, -1), 2, 4) for g in grid]
    return carrier, pdsch, rx, blocks


def _ul_case(kind):
    """kind: cp_2layer / tp_qpsk (tests/test_torch_pusch_rx.py), or the
    polar / small-block UCI configuration of tests/test_torch_pusch_uci.py
    -> (carrier, pusch, rx slot 0, the block sent)."""
    if kind in ("uci_polar", "uci_small"):
        ack, n_csi1 = POLAR_UCI if kind == "uci_polar" else SMALL_UCI
        payload = np.random.default_rng(6).integers(0, 2, n_csi1).tolist()
        carrier, pusch = _uci(ack, n_csi1, payload)
    else:
        carrier, pusch = _config(kind)
        pusch["mcs_index"] = UL_MCS.get(kind, pusch["mcs_index"])
    ch = tpusch.NrPUSCH(carrier, pusch, device="cpu")
    n = 14 * 12 * ch.prb_size
    nt = pusch["nNrOfAntennaPorts"]
    blk = np.random.default_rng(4).integers(0, 2, ch.tbsize, dtype=np.int8)

    def grid():
        fd, _ = ch.process(torch.zeros((nt, n), dtype=torch.complex64),
                           np.zeros((nt, n), np.int8), 0,
                           trblk=blk)
        return fd.numpy()
    return carrier, pusch, _rx(grid, nt, carrier["Nr"]), blk


def test_dl_ls_estimate_and_resource_copy_match_jax():
    carrier, pdsch, rx, _ = _dl_case()
    ch = tpdsch.Pdsch(pdsch, carrier, device="cpu")
    jch = jpdsch.Pdsch(pdsch, carrier)
    for slot in (0, 1):
        hj, ij = jch.H_LS_est(rx[slot], slot)
        ht, it = ch.H_LS_est(rx[slot], slot)
        hm, _ = tdrx.pdsch_dmrs_ls_est(torch.as_tensor(rx[slot]), pdsch, slot)
        np.testing.assert_allclose(ht.numpy(), hj, atol=1e-6)
        np.testing.assert_allclose(hm.numpy(), hj, atol=1e-6)
        assert {k: it[k] for k in ij} == ij and it["scs"] == 30
    rj, uj = jdrx.copy_rx_pdsch_resource(rx[0], pdsch)
    rt, ut = tdrx.copy_rx_pdsch_resource(torch.as_tensor(rx[0]), pdsch)
    np.testing.assert_allclose(rt.numpy(), rj, atol=1e-6)
    np.testing.assert_array_equal(ut, uj)


@pytest.mark.parametrize("kind", ["cp_2layer", "tp_qpsk"])
def test_ul_ls_estimate_and_resource_copy_match_jax(kind):
    carrier, pusch, rx, _ = _ul_case(kind)
    hj, ij = jurx.pusch_dmrs_ls_est(rx, pusch, 3)
    ht, it = turx.pusch_dmrs_ls_est(torch.as_tensor(rx), pusch, 3)
    np.testing.assert_allclose(ht.numpy(), hj, atol=1e-6)
    assert it == ij
    hs, _ = tpusch.NrPUSCH(carrier, pusch, device="cpu").H_LS_est(rx, 3)
    np.testing.assert_allclose(hs.numpy(), hj, atol=1e-6)
    rj, uj = jurx.copy_rx_pusch_resource(rx, pusch)
    rt, ut = turx.copy_rx_pusch_resource(torch.as_tensor(rx), pusch)
    np.testing.assert_allclose(rt.numpy(), rj, atol=1e-6)
    np.testing.assert_array_equal(ut, uj)


# --- DL-SCH / UL-SCH decode with HARQ combining (tests/test_harq.py) -----
# The scenario of tests/test_harq.py (G ~ 0.9 K, 3 dB) on the transport
# block of the DL case (TBS 2536, BG2, Zc 256), so that the JAX package
# builds one decoder for both tests
TBSIZE, QM, RATE1024, G = 2536, 2, 193, 2304
SNR_DB = 3.0


def _llr(fe, rng):
    sigma = 10 ** (-SNR_DB / 20)
    rx = (1 - 2.0 * fe.astype(np.float64)) + rng.normal(size=fe.shape) * sigma
    return (2.0 * rx / sigma ** 2).astype(np.float32)


def _encode(link, trblk, rv):
    t = torch.as_tensor(trblk)
    if link == "dl":
        return tpdsch.dlsch_encode(t[None], TBSIZE, QM, RATE1024, 1, rv,
                                   10 ** 9, G)[0].numpy()
    return tpusch.ulsch_encode_batch(t[None], TBSIZE, QM, RATE1024, 1, rv,
                                     G)[0].numpy()


def _decode(link, pkg, llr, rv, harq_on, prev):
    if link == "dl":
        mod = jdrx if pkg == "jax" else tdrx
        return mod.dlsch_decode(llr, TBSIZE, QM, RATE1024, 1, rv, 10 ** 9,
                                LDPC, harq_on=harq_on, current_llr_dns=prev)
    mod = jurx if pkg == "jax" else turx
    return mod.ulsch_decode(llr, TBSIZE, QM, RATE1024, 1, rv, LDPC,
                            harq_on=harq_on, current_llr_dns=prev)


@pytest.mark.parametrize("link", ["dl", "ul"])
def test_sch_harq_rv_cycle_matches_jax(link):
    """A high-rate first transmission fails; rv 2 combined decodes. The
    port's flags, bits and combined buffers equal the JAX package's on
    the same LLRs."""
    rng = np.random.default_rng(5 if link == "dl" else 7)
    trblk = rng.integers(0, 2, TBSIZE).astype(np.int8)
    llr0 = _llr(_encode(link, trblk, 0), rng)
    llr2 = _llr(_encode(link, trblk, 2), rng)
    ok_j, _, buf_j = _decode(link, "jax", llr0, 0, True, None)
    ok_t, _, buf_t = _decode(link, "port", torch.as_tensor(llr0), 0, True,
                             None)
    assert not ok_j and not bool(ok_t)
    np.testing.assert_allclose(buf_t.numpy(), buf_j, rtol=1e-6, atol=1e-6)
    ok_j, tb_j, comb_j = _decode(link, "jax", llr2, 2, True, buf_j)
    ok_t, tb_t, comb_t = _decode(link, "port", torch.as_tensor(llr2), 2,
                                 True, buf_t)
    assert ok_j and bool(ok_t)
    np.testing.assert_array_equal(tb_t.numpy(), tb_j)
    np.testing.assert_array_equal(tb_t.numpy(), trblk)
    np.testing.assert_allclose(comb_t.numpy(), comb_j, rtol=1e-6, atol=1e-6)


def test_dlsch_no_combine_still_fails():
    rng = np.random.default_rng(6)
    trblk = rng.integers(0, 2, TBSIZE).astype(np.int8)
    ok, _, _ = _decode("dl", "port", torch.as_tensor(
        _llr(_encode("dl", trblk, 2), rng)), 2, False, None)
    assert not bool(ok)


# --- RX_process on the same received grid ---------------------------------

def test_pdsch_rx_process_matches_jax():
    carrier, pdsch, rx, blocks = _dl_case()
    jch = jpdsch.Pdsch(pdsch, carrier)
    ch = tpdsch.Pdsch(pdsch, carrier, device="cpu")
    for slot in (0, 1):
        hj, ij = jch.H_LS_est(rx[slot], slot)
        ij["scs"] = 30
        ej = JCE(hj, ij, dict(CE_FO))
        Hj, cj = ej.channel_est()
        ok_j, tb_j, _ = jch.RX_process(rx[slot], slot, {"algo": "MMSE-IRC"},
                                       Hj, cj, LDPC, ej)
        et = TCE(*ch.H_LS_est(rx[slot], slot), dict(CE_FO))
        Ht, ct = et.channel_est()
        ok_t, tb_t, buf = ch.RX_process(rx[slot], slot, {"algo": "MMSE-IRC"},
                                        Ht, ct, LDPC, et)
        assert bool(ok_t) == bool(ok_j) is True
        np.testing.assert_array_equal(tb_t.numpy(), tb_j)
        np.testing.assert_array_equal(tb_t.numpy(), blocks[slot])
    gated = tpdsch.Pdsch(dict(pdsch, period_in_slot=2, allocated_slots=[0]),
                         carrier, device="cpu")
    assert gated.RX_process(rx[1], 1, {"algo": "MMSE"}, Ht, ct, LDPC)[0] \
        is False


@pytest.mark.parametrize("kind", ["cp_2layer", "tp_qpsk", "uci_polar",
                                  "uci_small"])
def test_pusch_rx_process_matches_jax(kind):
    carrier, pusch, rx, blk = _ul_case(kind)
    jch = jpusch.NrPUSCH(carrier, pusch)
    ch = tpusch.NrPUSCH(carrier, pusch, device="cpu")
    hj, ij = jch.H_LS_est(rx, 0)
    ej = JCE(hj, ij, dict(CE))
    Hj, cj = ej.channel_est()
    ok_j, tb_j, _, uci_j = jch.RX_process(rx, 0, {"algo": "MMSE-IRC"}, Hj,
                                          cj, LDPC, ej)
    ht, it = ch.H_LS_est(rx, 0)
    et = TCE(ht, it, dict(CE))
    Ht, ct = et.channel_est()
    ok_t, tb_t, _, uci_t = ch.RX_process(rx, 0, {"algo": "MMSE-IRC"}, Ht,
                                         ct, LDPC, et)
    assert bool(ok_t) == bool(ok_j) is True
    np.testing.assert_array_equal(tb_t.numpy(), tb_j)
    np.testing.assert_array_equal(tb_t.numpy(), blk)
    assert sorted(uci_t) == sorted(uci_j)
    for name, field in (("ack", "ACKbits"), ("csi1", "CSI1bits")):
        if name in uci_j:
            np.testing.assert_array_equal(uci_t[name][0].numpy(),
                                          uci_j[name][0])
            np.testing.assert_array_equal(uci_t[name][0].numpy(),
                                          pusch[field])
            assert uci_t[name][1] == uci_j[name][1]
    if uci_j:
        assert ch.RX_process(rx, 0, {"algo": "MMSE-IRC"}, Ht, ct, LDPC, et,
                             decode_uci=False)[3] == {}


# --- the per-slot sweeps on the JAX run's draws ---------------------------

def test_pdsch_per_slot_sweep_matches_jax():
    """rv cycling [0, 2, 3, 1] over the slots, the rv restarted per
    equalizer; MMSE-IRC and MMSE-ML-IRC."""
    carrier, pdsch, jc, tc = _small_config()
    pdsch["rv"] = [0, 2, 3, 1]
    snrs, seed, algos = [-9.0, 20.0], 3, ["MMSE-IRC", "MMSE-ML-IRC"]
    np.random.seed(11)
    ref = jsim.run_pdsch_throughput(carrier, pdsch, jc, snrs, algos,
                                    n_slots=N_SLOTS, ce_config=CE,
                                    ldpc_config=LDPC, seed=seed,
                                    use_batch=False)
    states = _jax_states(carrier, jpdsch.Pdsch(pdsch, carrier).tbsize, jc,
                         snrs, seed, 11)
    got = tsim.run_pdsch_throughput(carrier, pdsch, tc, snrs, algos,
                                    n_slots=N_SLOTS, ce_config=CE,
                                    ldpc_config=LDPC, seed=seed,
                                    device="cpu", states=states,
                                    use_batch=False)
    assert got == ref
    assert got["MMSE-IRC"][-1] == 1.0


def test_pusch_uci_sweep_matches_jax():
    """decode_uci=True sends the polar UCI configuration through the
    per-slot RX in both packages: the same TB pass rates; the port's
    results also hold the UCI pass rates, which the JAX sweep does not
    return (every slot's streams decode to the payload sent)."""
    ack, n_csi1 = POLAR_UCI
    carrier, pusch = _uci(ack, n_csi1, [1, 0] * 7)
    pusch["data_source"] = []
    kw = dict(model_format="customized", Nt=2, Nr=4, fm_inHz=200,
              multi_paths=[[0, 0, "Rayleigh", 0, 0]])
    from python_5gtoolbox_tpu.models import channel as jchan
    jc, tc = (jchan.gen_channel_model_config(**kw),
              tchan.gen_channel_model_config(**kw))
    snrs, seed = [-4.0, 20.0], 5
    np.random.seed(12)
    ref = jusim.run_pusch_throughput(carrier, pusch, jc, snrs, ["MMSE-IRC"],
                                     n_slots=N_SLOTS, ce_config=CE,
                                     ldpc_config=LDPC, seed=seed,
                                     decode_uci=True)
    states = _jax_states(carrier, jpusch.NrPUSCH(carrier, pusch).tbsize, jc,
                         snrs, seed, 12)
    got = tusim.run_pusch_throughput(carrier, pusch, tc, snrs, ["MMSE-IRC"],
                                     n_slots=N_SLOTS, ce_config=CE,
                                     ldpc_config=LDPC, seed=seed,
                                     decode_uci=True, device="cpu",
                                     states=states)
    uci = got.pop("uci")
    assert got == ref
    assert got["MMSE-IRC"][-1] == 1.0
    assert uci == {"MMSE-IRC": {"ack": [1.0, 1.0], "csi1": [1.0, 1.0]}}


def _numpy_calls(name):
    """(entry point, its numpy arguments) of each per-slot RX function that
    takes the slot, the LLRs or the LS estimate."""
    carrier, pdsch, _, _ = _small_config()
    n_sc = 12 * 24                                     # BW 10, scs 30
    grid = np.zeros((carrier["Nr"], 14 * n_sc), np.complex64)
    llr = np.zeros(G, np.float32)
    _, upusch = _uci(*SMALL_UCI, [1, 0, 1, 1, 0])
    _, usage = turx.copy_rx_pusch_resource(torch.as_tensor(grid), upusch)
    g_uci = int((usage == 0).sum()) * upusch["num_of_layers"] \
        * ttbs.ulsch_tbsize(upusch)[1]
    return {
        "pdsch_dmrs_ls_est": (tdrx.pdsch_dmrs_ls_est, (grid, pdsch, 0)),
        "copy_rx_pdsch_resource": (tdrx.copy_rx_pdsch_resource,
                                   (grid, pdsch)),
        "dlsch_decode": (tdrx.dlsch_decode, (llr, TBSIZE, QM, RATE1024, 1,
                                             0, 10 ** 9, LDPC)),
        "pusch_dmrs_ls_est": (turx.pusch_dmrs_ls_est, (grid, upusch, 0)),
        "copy_rx_pusch_resource": (turx.copy_rx_pusch_resource,
                                   (grid, upusch)),
        "ulsch_decode": (turx.ulsch_decode, (llr, TBSIZE, QM, RATE1024, 1,
                                             0, LDPC)),
        "ulsch_uci_decode_process": (
            turx.ulsch_uci_decode_process,
            (np.zeros(g_uci, np.float32), upusch, 0, LDPC)),
        "decode_uci_on_ulsch": (turx.decode_uci_on_ulsch,
                                (np.zeros(64, np.float32), 5, 2)),
    }[name]


@pytest.mark.parametrize("name", [
    "pdsch_dmrs_ls_est", "copy_rx_pdsch_resource", "dlsch_decode",
    "pusch_dmrs_ls_est", "copy_rx_pusch_resource", "ulsch_decode",
    "ulsch_uci_decode_process", "decode_uci_on_ulsch"])
def test_numpy_input_goes_to_the_card(name):
    """A tensor keeps its device; numpy goes to the card, as every entry
    point's default device, and on a host without one that raises."""
    fn, args = _numpy_calls(name)
    on_cpu = fn(*(torch.as_tensor(a) if isinstance(a, np.ndarray) else a
                  for a in args))
    tensors = [o for o in on_cpu if isinstance(o, torch.Tensor)]
    assert tensors and all(t.device.type == "cpu" for t in tensors)
    if torch.cuda.is_available():
        assert all(o.is_cuda for o in fn(*args)
                   if isinstance(o, torch.Tensor))
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(*args)


@pytest.mark.parametrize("module", ["pdsch_rx", "pusch_rx"])
def test_rx_module_can_be_imported_first(module):
    """Importing a receive module before its channel's module (a fresh
    interpreter) still gives Pdsch and NrPUSCH their RX methods."""
    import pathlib
    import subprocess
    import sys
    code = (f"import python_5gtoolbox_tpu_torch.phy.{module}\n"
            "from python_5gtoolbox_tpu_torch.phy.pdsch import Pdsch\n"
            "from python_5gtoolbox_tpu_torch.phy.pusch import NrPUSCH\n"
            "assert Pdsch.RX_process.__qualname__ == "
            "'PdschRxMixin.RX_process'\n"
            "assert NrPUSCH.RX_process.__qualname__ == "
            "'PuschRxMixin.RX_process'\n"
            "assert NrPUSCH.H_LS_est is Pdsch.H_LS_est\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=pathlib.Path(__file__).resolve().parents[1])


def test_harq_batched_matches_per_slot():
    """tests/test_batch_rx_harq.py on the port, with that test's
    configuration and constants: a 4-rv chain (0, 2, 3, 1) over AWGN at
    -6 dB, 3 slots; the batched chain's per-transmission flags equal the
    per-slot chain's, rv 0 alone fails and combining decodes."""
    from tests.test_batch_rx_harq import (CE as HCE, LDPC as HLDPC,
                                          RV_CYCLE, S, SNR_DB, _configs)
    carrier, pdsch = _configs()
    ok_b, ok_s = tsim.harq_chains(carrier, pdsch, HCE, HLDPC, RV_CYCLE,
                                  SNR_DB, S, device="cpu")
    np.testing.assert_array_equal(ok_b, ok_s)
    assert not ok_b[0].any() and ok_b[-1].all()


@pytest.mark.parametrize("mod", [nr_pdsch_throughput_example,
                                 nr_pdsch_ber_example,
                                 nr_pusch_throughput_example,
                                 nr_pusch_ber_example],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_example_module_tiny_call(mod, tmp_path):
    """Each example at one SNR point of 2 slots writes the JAX script's
    pickle; the full configurations keep the JAX scripts' constants."""
    import pickle
    cfg = mod.example_config()
    assert cfg["carrier"]["BW"] == 20 and cfg["channel"]["ResAlloType1"][
        "RBSize"] == 20
    cfg.update(snr_db_list=[30.0], n_slots=2)
    out = mod.main(["--device", "cpu", "--out-dir", str(tmp_path)],
                   config=cfg)
    with open(tmp_path / cfg["filename"], "rb") as f:
        head, saved = pickle.load(f)
    assert head == dict(Nt=cfg["Nt"], Nr=cfg["Nr"], snr_db_list=[30.0])
    for algo in cfg["ceq_algo_list"]:
        assert saved[algo] == out[algo] and len(out[algo]) == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main(["--out-dir", str(tmp_path)], config=cfg)
