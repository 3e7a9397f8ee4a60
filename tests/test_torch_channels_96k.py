"""The port against the JAX package on stereo at 96 kHz, 30 s: the case and the rules of
tests/test_torch_channels.py (the reduced geometry, the limiter off; the
adds at most 1 LSB apart on at most 1e-3 of the samples, cmp byte for
byte, the unknown-length add equal to the known-length add), in a file of
its own so that each file runs well inside its worker's share of the
tier-1 run."""

import pytest

from test_torch_channels import (
    _set, check_add_within_one_lsb_of_jax, check_cmp_prints_what_jax_prints,
    check_unknown_length_add_equals_known_length_add, run_case)

CASE = (2, 96000, 30)


@pytest.fixture(autouse=True)
def _reset_params():
    _set()
    yield
    _set()


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    return run_case(tmp_path_factory.mktemp("case"), *CASE)


def test_add_within_one_lsb_of_jax(case):
    check_add_within_one_lsb_of_jax(case)


def test_cmp_prints_what_jax_prints(case):
    check_cmp_prints_what_jax_prints(case)


def test_unknown_length_add_equals_known_length_add(case):
    check_unknown_length_add_equals_known_length_add(case)
