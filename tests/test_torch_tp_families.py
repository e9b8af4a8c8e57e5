"""The meshed train step's tensor- and expert-parallel paths of the MoE,
hybrid and VLM families (`tests/test_torch_tp.py`'s FAMILY_CASES and
oracles), in a file of their own so that each file's tests stay within
120 s in one process.
"""
import pytest

from test_torch_tp import FAMILY_CASES, check_case


@pytest.mark.parametrize("case", FAMILY_CASES)
def test_tp_step_of_the_family_matches_the_single_device_step(tmp_path, case):
    check_case(tmp_path, *FAMILY_CASES[case])
