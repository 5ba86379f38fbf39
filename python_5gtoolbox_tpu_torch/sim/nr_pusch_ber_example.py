"""PUSCH BLER-vs-SNR example over AWGN (the counterpart of
scripts/NR_PUSCH_BER_example.py): 1x1, MCStable61411 MCS 5 on 20 RBs,
SNR -2..5 dB, 4 slots, MMSE-IRC; TB BLER per SNR pickled to
<out-dir>/nr_pusch_ber.pickle.

    python -m python_5gtoolbox_tpu_torch.sim.nr_pusch_ber_example
        [--device cpu] [--seed 0] [--out-dir out/torch]
"""
from __future__ import annotations

import numpy as np

from python_5gtoolbox_tpu_torch.models.channel import gen_channel_model_config
from python_5gtoolbox_tpu_torch.sim import pusch_throughput as usim
from python_5gtoolbox_tpu_torch.sim.examples import run_example
from python_5gtoolbox_tpu_torch.utils.config import get_default_config, merged


def example_config() -> dict:
    """The JAX script's constants."""
    nt = nr = 1
    carrier = merged(get_default_config("ul_carrier"),
                     dict(BW=20, scs=30, num_of_ant=nt, Nr=nr))
    pusch = get_default_config("pusch")
    pusch.update(mcs_table="MCStable61411", mcs_index=5, num_of_layers=1,
                 nNrOfAntennaPorts=1, data_source=[1, 0, 0, 1])
    pusch["ResAlloType1"]["RBSize"] = 20
    return dict(Nt=nt, Nr=nr, carrier=carrier, channel=pusch,
                chan_cfg=gen_channel_model_config(model_format="AWGN",
                                                  Nt=nt, Nr=nr),
                snr_db_list=np.arange(-2.0, 6.0, 1.0).tolist(),
                ceq_algo_list=["MMSE-IRC"], n_slots=4,
                filename="nr_pusch_ber.pickle")


def main(argv=None, config=None, prof=None) -> dict:
    return run_example(__doc__, config or example_config(),
                       usim.run_pusch_throughput, argv, ber=True,
                       prof=prof)


if __name__ == "__main__":
    main()
