"""CLI surface (powersystemsreliabilityassessment/__main__.py).

Parse-only: build_parser is separated from dispatch precisely so these
tests can pin every documented flag combination without running a study
(the studies themselves are covered by test_parallel / test_seq_split /
smoke tests). The conflict-combination errors ARE dispatch logic, so
those run through a subprocess and assert on exit code 2.
"""
import subprocess
import sys

import pytest

from powersystemsreliabilityassessment.__main__ import build_parser


@pytest.mark.parametrize("argv", [
    ["nsq"],
    ["nsq", "--samples", "1000", "--batch", "512", "--beta", "0.01",
     "--seed", "3", "--is-boost", "2.5", "--control-variate",
     "--checkpoint", "/tmp/x.json", "--checkpoint-backend", "orbax"],
    ["nsq", "--case", "path/to/case.m"],
    ["nsq", "--is-boost", "8", "--is-boost-scope", "gens"],
    ["nsq", "--is-boost", "8", "--is-boost-scope", "branches"],
    ["seq"],
    ["seq", "--years", "100", "--cov", "0.1", "--years-per-device", "8",
     "--sampling", "stationary", "--control-variate"],
    ["seq", "--split-level", "auto", "--split-k", "6", "--split-max", "4"],
    ["seq", "--split-level", "-150.0"],
    ["seq", "--maintenance"],
    ["hl1", "--iterations", "100", "--years", "10"],
    ["education", "--out", "results"],
    ["planning", "--mc-years", "50", "--hydro-hours", "50"],
    ["multiarea", "--system", "demo"],
    ["multiarea", "--system", "ring", "--areas", "5"],
    ["multiarea", "--system", "case", "--case", "rts96"],
    ["scaleup", "--case", "case300s", "--samples", "1000"],
    ["bench"],
])
def test_documented_combinations_parse(argv):
    args = build_parser().parse_args(argv)
    assert args.study == argv[0]


@pytest.mark.parametrize("argv", [
    ["seq", "--sampling", "bogus"],
    ["multiarea", "--system", "bogus"],
    ["nsq", "--checkpoint-backend", "bogus"],
    ["nsq", "--is-boost-scope", "bogus"],
    [],
    # Removed with the kernels they selected.
    ["nsq", "--early-exit"],
    ["seq", "--early-exit", "--control-variate"],
    ["nsq", "--fused-tier1"],
])
def test_invalid_flags_rejected(argv):
    with pytest.raises(SystemExit):
        build_parser().parse_args(argv)


@pytest.mark.parametrize("argv,needle", [
    (["seq", "--split-level", "auto", "--control-variate"],
     "--control-variate"),
    (["seq", "--split-level", "auto", "--sampling", "stationary"],
     "--control-variate"),
    (["seq", "--split-level", "auto", "--maintenance"], "--maintenance"),
])
def test_conflicting_combinations_error(argv, needle):
    r = subprocess.run(
        [sys.executable, "-m", "powersystemsreliabilityassessment",
         *argv], capture_output=True, text=True)
    assert r.returncode == 2
    assert needle in r.stderr
