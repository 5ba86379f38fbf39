"""PyTorch port, the paths that run the small-lifting decoder: the LDPC
decoder BLER study (sim/ldpc_decoder.py against
scripts/internal/sim_ldpc_internal.py on the same Generator seed) and the
link-level PDSCH sweep on a small allocation (Zc 80) against the JAX
package on its own received grid.

Stimulus bits and BLER lists exactly equal (same draws, bit-identical
decoders); LLRs within 1e-6 (float64 noise rounded to float32 on both
sides); decode flags and TB bits exactly.
"""
import pickle

import numpy as np
import pytest

from python_5gtoolbox_tpu.phy import pdsch as jpdsch
from scripts.internal import sim_ldpc_internal as jstudy
from scripts.internal import sim_pdsch_throughput_internal as jsim

from python_5gtoolbox_tpu_torch.interop import state_from_numpy
from python_5gtoolbox_tpu_torch.ops import ldpc as TL
from python_5gtoolbox_tpu_torch.phy import pdsch as tpdsch
from python_5gtoolbox_tpu_torch.sim import ldpc_decoder as tstudy
from python_5gtoolbox_tpu_torch.sim import pdsch_throughput as tsim


def test_expand_test_configs_matches_jax_script():
    args = (["BP", "min-sum", "NMS", "OMS", "mixed-MS"], [0.7, 0.75], [0.5],
            [[0.8, 0.3], [0.7, 0.3]], [16, 32])
    assert tstudy.expand_test_configs(*args) == \
        jstudy.expand_test_configs(*args)
    with pytest.raises(ValueError):
        tstudy.expand_test_configs(["SPA"], [], [], [], [16])


@pytest.mark.parametrize("zc,bgn,crcpoly", [(12, 1, "24A"), (16, 2, "16")])
def test_gen_ldpc_llr_batch_matches_jax_script(zc, bgn, crcpoly):
    blk_j, llr_j = jstudy.gen_ldpc_llr_batch(np.random.default_rng(5), zc,
                                             bgn, -0.5, 6, crcpoly)
    blk_t, llr_t = tstudy.gen_ldpc_llr_batch(np.random.default_rng(5), zc,
                                             bgn, -0.5, 6, crcpoly,
                                             device="cpu")
    np.testing.assert_array_equal(blk_t, blk_j)
    assert llr_t.dtype == np.float32 and llr_t.shape == llr_j.shape
    np.testing.assert_allclose(llr_t, llr_j, atol=1e-6, rtol=0)


def test_run_ldpc_simulation_matches_jax_script(tmp_path):
    """Zc 12, 24 trials, 2 SNR points, two min-sum settings: the same
    BLER lists and the same pickle layout."""
    args = (12, 1, "24A", ["min-sum", "mixed-MS"], [], [], [[0.8, 0.3]],
            [16], [-1.0, 1.0])
    ref = jstudy.run_ldpc_simulation(*args, str(tmp_path / "jax.pickle"),
                                     n_trials=24, seed=2)
    got = tstudy.run_ldpc_simulation(*args, tmp_path / "torch.pickle",
                                     n_trials=24, seed=2, device="cpu")
    assert got == ref
    assert got[2][0][0] > got[2][0][1]          # BLER falls with SNR
    with open(tmp_path / "torch.pickle", "rb") as f:
        assert pickle.load(f) == list(ref)


def test_study_options_reach_the_decoder():
    """schedule, semantics and layout go through decode_batch; BP takes
    none of them."""
    rng = np.random.default_rng(3)
    blk, llr = tstudy.gen_ldpc_llr_batch(rng, 12, 1, 0.0, 16, device="cpu")
    flooded = tstudy.decode_batch(llr, blk, 12, 1, 4, "min-sum", 0.8, 0.3,
                                  device="cpu")
    layered = tstudy.decode_batch(llr, blk, 12, 1, 4, "min-sum", 0.8, 0.3,
                                  schedule="layered", semantics="fast",
                                  layout="packed", device="cpu")
    assert layered < flooded            # layered converges in fewer sweeps
    _, cfgs, res = tstudy.run_ldpc_simulation(
        12, 1, "24A", ["BP", "min-sum"], [], [], [], [4], [0.0], None,
        n_trials=16, seed=3, device="cpu", schedule="layered")
    assert [c["name"] for c in cfgs] == ["BP", "min-sum"]
    assert all(0.0 <= b[0] <= 1.0 for b in res)


def test_bf_study_and_hyper_search_on_cpu(tmp_path):
    cfg, cfgs, res = tstudy.run_ldpc_bf_simulation(
        16, 2, [10, 20], [4.0, 8.0], tmp_path / "bf.pickle", n_trials=32,
        device="cpu")
    assert cfg == dict(Zc=16, bgn=2, snr_db_list=[4.0, 8.0], n_trials=32)
    assert [c["L"] for c in cfgs] == [10, 20]
    assert all(b[0] >= b[1] for b in res) and res[1][1] < 0.5
    blers, best = tstudy.run_hyper_search(12, 2, [(0.5, 0.0), (0.8, 0.0)],
                                          L=8, snr_db=1.0, n_trials=32,
                                          device="cpu")
    assert len(blers) == 2 and best in [(0.5, 0.0), (0.8, 0.0)]


def test_study_constants_match_the_scripts():
    """The constants of scripts/sim_ldpc_decoder.py, sim_ldpc_decoder_bf.py
    and the three hyper-search scripts."""
    d = tstudy.DECODER_STUDY
    assert (d["zc"], d["bgn"], d["L_list"]) == (12, 1, [16])
    assert d["snr_db_list"] == [-1.0, -0.5, 0.0, 0.5, 1.0]
    assert len(tstudy.expand_test_configs(
        d["algo_list"], d["alpha_list"], d["beta_list"], d["mixed_list"],
        d["L_list"])) == 6
    assert tstudy.L_STUDY["L_list"] == [16, 32, 64]
    assert tstudy.BF_STUDY["snr_db_list"] == [4.0, 5.0, 6.0, 7.0, 8.0]
    assert [len(tstudy.SEARCHES[k]["pairs"]) for k in ("nms", "oms", "mixed")
            ] == [10, 7, 16]
    assert tstudy.SEARCHES["nms"]["pairs"][0] == (0.5, 0.0)
    assert tstudy.SEARCHES["oms"]["pairs"][-1] == (1.0, 0.7)


# ---------------------------------------------------------------------------
# The link-level sweep on a small allocation (MCS 0, 12 RBs: Zc 80)
# ---------------------------------------------------------------------------

N_SLOTS = 2


def test_small_alloc_config_is_zc_80():
    carrier, pdsch, _, _, ldpc = tsim.small_alloc_link_level_config()
    ch = tpdsch.Pdsch(pdsch, carrier, device="cpu")
    assert ch.tbsize == 736
    info = TL.get_cbs_info(ch.tbsize + 16, 2)
    assert (info.C, info.Zc, info.bgn) == (1, 80, 2)
    assert ldpc == dict(L=16, algo="min-sum", alpha=0.8, beta=0.3)
    bench = tsim.bench_link_level_config()
    assert bench[1]["ResAlloType1"]["RBSize"] == 20     # left as it was
    assert jpdsch.Pdsch(pdsch, carrier).tbsize == 736


def test_small_alloc_sweep_on_cpu_decodes_exactly():
    carrier, pdsch, chan, ce, ldpc = tsim.small_alloc_link_level_config()
    got = tsim.run_pdsch_throughput(carrier, pdsch, chan, [30.0],
                                    ["MMSE-IRC"], n_slots=N_SLOTS,
                                    ce_config=ce, ldpc_config=ldpc, seed=3,
                                    device="cpu")
    assert got["MMSE-IRC"] == [1.0] and got["tbs_bits"] == 736
    blocks = np.random.default_rng(30).integers(0, 2, (N_SLOTS, 736),
                                                dtype=np.int8)
    ch, slots, rx_fd = tsim.pdsch_before_ceq_processing(
        carrier, pdsch, chan, -30.0, N_SLOTS, seed=30, device="cpu",
        state=state_from_numpy(trblks=blocks, device="cpu"))
    stack = rx_fd.reshape(4, N_SLOTS, -1).transpose(0, 1)
    ok, tb = ch.rx_process_batch(stack, slots, {"algo": "MMSE-IRC"}, ldpc,
                                 tsim._ce_config(ce, chan, carrier["scs"]))
    assert ok.all()
    np.testing.assert_array_equal(tb, blocks)


@pytest.mark.parametrize("snr", [30.0, -14.0])
def test_small_alloc_batched_rx_matches_jax_on_its_grid(snr):
    """The JAX sweep's received grid for the small allocation through both
    packages' batched RX: the same ok flags and TB bits."""
    carrier, pdsch, chan, ce, ldpc = tsim.small_alloc_link_level_config()
    np.random.seed(17)
    # the channel configuration is a plain dict of numbers and numpy
    # arrays: the JAX sweep takes the port's as it is
    jch, slots, rx_j = jsim.pdsch_before_ceq_processing(
        carrier, pdsch, chan, -snr, N_SLOTS, 9, ce, do_ce=False,
        return_full=True)
    rx = np.asarray(rx_j).reshape(4, N_SLOTS, -1).transpose(1, 0, 2)
    slots = list(range(N_SLOTS))
    ok_j, tb_j = jch.rx_process_batch(rx, slots, {"algo": "MMSE-IRC"}, ldpc,
                                      ce)
    tch = tpdsch.Pdsch(pdsch, carrier, device="cpu")
    ok_t, tb_t = tch.rx_process_batch(rx, slots, {"algo": "MMSE-IRC"}, ldpc,
                                      ce)
    np.testing.assert_array_equal(ok_t, np.asarray(ok_j))
    if snr > 0:
        assert ok_t.all()
        np.testing.assert_array_equal(tb_t, np.asarray(tb_j))
    else:
        assert not ok_t.any()
