"""PUSCH throughput example over TDL-A (the counterpart of
scripts/NR_PUSCH_throughput_example.py).

TX -> TDL-A (delay spread 30 ns, fm 200 Hz, low UL correlation) 1x2 +
AWGN -> RX low-PHY -> DFT CE (FO estimation off, as the reference's
PUSCH sims) -> MMSE-IRC -> UL-SCH decode; TB pass rate per SNR pickled
to <out-dir>/nr_pusch_throughput.pickle.

    python -m python_5gtoolbox_tpu_torch.sim.nr_pusch_throughput_example
        [--device cpu] [--seed 0] [--out-dir out/torch]
"""
from __future__ import annotations

import numpy as np

from python_5gtoolbox_tpu_torch.models.channel import gen_channel_model_config
from python_5gtoolbox_tpu_torch.sim import pusch_throughput as usim
from python_5gtoolbox_tpu_torch.sim.examples import run_example
from python_5gtoolbox_tpu_torch.utils.config import get_default_config, merged


def example_config() -> dict:
    """The JAX script's constants: 1 layer, MCStable61411 MCS 5 on 20 RBs,
    rv [0], SNR -10..2 dB in 2 dB steps, 30 slots."""
    nt, nr = 1, 2
    carrier = merged(get_default_config("ul_carrier"),
                     dict(BW=20, scs=30, num_of_ant=nt, Nr=nr))
    pusch = get_default_config("pusch")
    pusch.update(mcs_table="MCStable61411", mcs_index=5, num_of_layers=1,
                 nNrOfAntennaPorts=1, data_source=[1, 0, 0, 1], rv=[0])
    pusch["ResAlloType1"]["RBSize"] = 20
    chan_cfg = gen_channel_model_config(
        model_format="TDL-A", Nt=nt, Nr=nr,
        Rspat_config=("low", "uniform", "UL", (0, 0)), fm_inHz=200,
        DSdesired=30)
    return dict(Nt=nt, Nr=nr, carrier=carrier, channel=pusch,
                chan_cfg=chan_cfg,
                snr_db_list=np.arange(-10.0, 3.0, 2.0).tolist(),
                ceq_algo_list=["MMSE-IRC"], n_slots=30,
                ce=dict(enable_FO_est=False, enable_FO_comp=False),
                filename="nr_pusch_throughput.pickle")


def main(argv=None, config=None, prof=None) -> dict:
    return run_example(__doc__, config or example_config(),
                       usim.run_pusch_throughput, argv, prof=prof)


if __name__ == "__main__":
    main()
