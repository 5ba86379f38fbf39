"""PDSCH throughput example: equalizers compared over a fading channel
(the counterpart of scripts/NR_PDSCH_throughput_example.py).

TX -> Rayleigh one-tap 2x4 MIMO channel (low correlation, fm 200 Hz) +
AWGN -> RX low-PHY -> DFT CE -> MMSE, MMSE-IRC, ML-IRC-soft and
ML2-IRC-soft -> LDPC decode, slot-batched; TB pass rate per SNR, pickled
to <out-dir>/nr_pdsch_throughput.pickle with the stage seconds in
profile_pdsch_sim.json.

    python -m python_5gtoolbox_tpu_torch.sim.nr_pdsch_throughput_example
        [--device cpu] [--seed 0] [--out-dir out/torch]
"""
from __future__ import annotations

import numpy as np

from python_5gtoolbox_tpu_torch.models.channel import gen_channel_model_config
from python_5gtoolbox_tpu_torch.sim import pdsch_throughput as sim
from python_5gtoolbox_tpu_torch.sim.examples import run_example
from python_5gtoolbox_tpu_torch.utils.config import get_default_config, merged


def example_config() -> dict:
    """The JAX script's constants: 2x4, 2 layers, 64QAM table MCS 5 on 20
    RBs, SNR -8..4 dB in 2 dB steps, 20 slots."""
    nt, nr = 2, 4
    carrier = merged(get_default_config("dl_carrier"),
                     dict(BW=20, scs=30, num_of_ant=nt, Nr=nr,
                          maxMIMO_layers=nt))
    pdsch = get_default_config("pdsch")
    pdsch.update(mcs_table="64QAM", mcs_index=5, num_of_layers=nt,
                 data_source=[1, 0, 0, 1])
    pdsch["ResAlloType1"]["RBSize"] = 20
    pdsch["precoding_matrix"] = np.eye(nt).tolist()
    chan_cfg = gen_channel_model_config(
        model_format="customized", Nt=nt, Nr=nr,
        Rspat_config=("low", "uniform", "DL", (0, 0)),
        multi_paths=[[0, 0, "Rayleigh", 0, 0]], fm_inHz=200)
    return dict(Nt=nt, Nr=nr, carrier=carrier, channel=pdsch,
                chan_cfg=chan_cfg,
                snr_db_list=np.arange(-8.0, 5.0, 2.0).tolist(),
                ceq_algo_list=["MMSE", "MMSE-IRC", "ML-IRC-soft",
                               "ML2-IRC-soft"],
                n_slots=20, filename="nr_pdsch_throughput.pickle")


def main(argv=None, config=None, prof=None) -> dict:
    return run_example(__doc__, config or example_config(),
                       sim.run_pdsch_throughput, argv,
                       profile_json="profile_pdsch_sim.json", prof=prof)


if __name__ == "__main__":
    main()
