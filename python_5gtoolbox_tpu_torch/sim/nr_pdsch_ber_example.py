"""PDSCH BLER-vs-SNR example over AWGN (the counterpart of
scripts/NR_PDSCH_BER_example.py): 2x2, 2 layers, 64QAM table MCS 4 on 20
RBs, SNR 2..9 dB, 4 slots, MMSE-IRC; TB BLER per SNR pickled to
<out-dir>/nr_pdsch_ber.pickle.

    python -m python_5gtoolbox_tpu_torch.sim.nr_pdsch_ber_example
        [--device cpu] [--seed 0] [--out-dir out/torch]
"""
from __future__ import annotations

import numpy as np

from python_5gtoolbox_tpu_torch.models.channel import gen_channel_model_config
from python_5gtoolbox_tpu_torch.sim import pdsch_throughput as sim
from python_5gtoolbox_tpu_torch.sim.examples import run_example
from python_5gtoolbox_tpu_torch.utils.config import get_default_config, merged


def example_config() -> dict:
    """The JAX script's constants."""
    nt = nr = 2
    carrier = merged(get_default_config("dl_carrier"),
                     dict(BW=20, scs=30, num_of_ant=nt, Nr=nr,
                          maxMIMO_layers=nt))
    pdsch = get_default_config("pdsch")
    pdsch.update(mcs_table="64QAM", mcs_index=4, num_of_layers=nt,
                 data_source=[1, 0, 0, 1])
    pdsch["ResAlloType1"]["RBSize"] = 20
    pdsch["precoding_matrix"] = np.eye(nt).tolist()
    return dict(Nt=nt, Nr=nr, carrier=carrier, channel=pdsch,
                chan_cfg=gen_channel_model_config(model_format="AWGN",
                                                  Nt=nt, Nr=nr),
                snr_db_list=np.arange(2.0, 10.0, 1.0).tolist(),
                ceq_algo_list=["MMSE-IRC"], n_slots=4,
                filename="nr_pdsch_ber.pickle")


def main(argv=None, config=None, prof=None) -> dict:
    return run_example(__doc__, config or example_config(),
                       sim.run_pdsch_throughput, argv, ber=True,
                       prof=prof)


if __name__ == "__main__":
    main()
