"""Regenerate the recordings of tests/torch_oracles from the JAX package.

Runs the tests that read recordings with TORCH_ORACLES_RECORD=1: each
runs its JAX side live, writes <case>.npz beside this file and then
compares as it always does. Run from the repository root on the CPU:

    python tests/torch_oracles/make.py [test ids]

With no test ids it records every case below and removes the recordings
that no test wrote.
"""
import os
import pathlib
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parents[1]

# every test that reads a recording (all its parametrized cases)
TESTS = [
    "tests/test_torch_ldpc_variants.py::test_layered_matches_jax",
    "tests/test_torch_ldpc_variants.py::test_layered_nonconverging_matches_jax",
    "tests/test_torch_ldpc_variants.py::test_plain_matches_packed_pallas_kernel",
    "tests/test_torch_ldpc_variants.py::test_fast_matches_pallas_kernel",
    "tests/test_torch_ldpc_variants.py::test_bp_decode_matches_jax",
    "tests/test_torch_ldpc_variants.py::test_bit_flipping_matches_jax",
    "tests/test_torch_ldpc.py::test_decode_matches_jax",
    "tests/test_torch_ldpc.py::test_decode_garbage_llrs_match_jax",
    "tests/test_torch_pusch_uci.py::test_uci_path_matches_jax",
]


def main(argv) -> int:
    t0 = time.time()
    env = dict(os.environ, TORCH_ORACLES_RECORD="1", JAX_PLATFORMS="cpu")
    rc = subprocess.call([sys.executable, "-m", "pytest", "-q",
                          "-p", "no:cacheprovider", "-p", "no:randomly",
                          *(argv or TESTS)], cwd=REPO, env=env)
    if rc or argv:
        return rc
    stale = [p for p in HERE.glob("*.npz") if p.stat().st_mtime < t0]
    for p in stale:
        print(f"removing {p.name}: no test wrote it")
        p.unlink()
    total = sum(p.stat().st_size for p in HERE.glob("*.npz"))
    print(f"{len(list(HERE.glob('*.npz')))} recordings, {total} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
