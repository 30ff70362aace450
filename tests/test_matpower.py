"""MATPOWER ``.m`` interop (core/matpower_io.py).

The reference's solver path loads arbitrary MATPOWER cases via
``loadcase`` (README.md:47-49, nsqMain.m:42) with reliability in a
separate failrate struct (case24_failrate.m) — these tests pin the same
contract for load_matpower_case/save_matpower_case: lossless round-trip,
standard-column parsing semantics (status filtering, ext2int numbering,
tap folding, unlimited ratings) and the documented RTS-79 reliability
synthesis rule for cases that ship none.
"""
import numpy as np
import pytest

from powersystemsreliabilityassessment.core import cases
from powersystemsreliabilityassessment.core.matpower_io import (
    load_matpower_case, parse_matpower, resolve_case, save_matpower_case)


def test_roundtrip_rts24_exact(tmp_path):
    case = cases.rts24()
    path = str(tmp_path / "rts24x.m")
    save_matpower_case(case, path)
    got = load_matpower_case(path)   # sibling failrate JSON auto-detected
    assert got.name == "rts24x"
    assert got.base_mva == case.base_mva
    for f in ("bus_pd", "bus_qd", "gen_bus", "gen_pmax", "gen_pmin",
              "gen_mttf", "gen_mttr", "gen_maint_weeks", "br_from",
              "br_to", "br_x", "br_rate", "br_lambda", "br_dur"):
        np.testing.assert_allclose(getattr(got, f), getattr(case, f),
                                   rtol=1e-9, err_msg=f)


def test_roundtrip_bus_area(tmp_path):
    # BUS_AREA survives the .m round-trip (0-based contiguous), enabling
    # multiarea --system case on loaded files; single-area cases load as
    # bus_area None.
    case = cases.rts96()
    path = str(tmp_path / "r96.m")
    save_matpower_case(case, path)
    got = load_matpower_case(path)
    np.testing.assert_array_equal(got.bus_area, case.bus_area)
    single = cases.rts24()
    assert single.bus_area is None
    path1 = str(tmp_path / "r24.m")
    save_matpower_case(single, path1)
    assert load_matpower_case(path1).bus_area is None


def test_case_hl15_view_from_loaded_file(tmp_path):
    from powersystemsreliabilityassessment.studies import multiarea_demo
    case = cases.rts96()
    path = str(tmp_path / "r96b.m")
    save_matpower_case(case, path)
    sys_direct = multiarea_demo.case_system(case, hours=48)
    sys_loaded = multiarea_demo.case_system(load_matpower_case(path),
                                            hours=48)
    assert sys_loaded.area_names == sys_direct.area_names
    np.testing.assert_allclose(sys_loaded.tie_cap, sys_direct.tie_cap)
    np.testing.assert_allclose(sys_loaded.hourly_load,
                               sys_direct.hourly_load, rtol=1e-6)
    import pytest as _pytest
    with _pytest.raises(ValueError, match="no area structure"):
        multiarea_demo.case_system(cases.rts24(), hours=48)


def test_roundtrip_system_parity(tmp_path):
    """The loaded case builds the same electrical model (PTDF)."""
    from powersystemsreliabilityassessment.core.system import build_system
    from powersystemsreliabilityassessment.utils.config import CompatFlags
    case = cases.rts24()
    path = str(tmp_path / "rt.m")
    save_matpower_case(case, path)
    got = load_matpower_case(path)
    a = build_system(case, CompatFlags())
    b = build_system(got, CompatFlags())
    np.testing.assert_allclose(np.asarray(b.ptdf), np.asarray(a.ptdf),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(b.br_rate),
                               np.asarray(a.br_rate), rtol=1e-6)


def test_synthesized_reliability_class_rule(tmp_path):
    case = cases.rts24()
    path = str(tmp_path / "nofail.m")
    save_matpower_case(case, path, failrate_json=False)
    got = load_matpower_case(path)
    # Every RTS-24 Pmax is exactly an RTS-79 class -> generator
    # reliability synthesis reproduces the published values exactly.
    np.testing.assert_allclose(got.gen_mttf, case.gen_mttf)
    np.testing.assert_allclose(got.gen_mttr, case.gen_mttr)
    np.testing.assert_allclose(got.gen_maint_weeks, case.gen_maint_weeks)
    # Branches synthesize by ENDPOINT BUS voltage class: save emits
    # 230 kV for rate >= 400 MW branches and lifts both endpoint buses,
    # so a 138 kV-rated branch touching such a bus also loads as the
    # 230 kV class (the rule keys on max endpoint kv, not the branch).
    kv_branch = np.where(case.br_rate >= 400.0, 230.0, 138.0)
    kv_bus = np.full(case.n_bus, 138.0)
    for ends in (case.br_from, case.br_to):
        np.maximum.at(kv_bus, ends, kv_branch)
    hi = np.maximum(kv_bus[case.br_from], kv_bus[case.br_to]) >= 200.0
    assert hi.any() and (~hi).any()
    np.testing.assert_allclose(got.br_lambda[hi], 0.38)
    np.testing.assert_allclose(got.br_dur[hi], 11.0)
    np.testing.assert_allclose(got.br_lambda[~hi], 0.37)
    np.testing.assert_allclose(got.br_dur[~hi], 10.0)


_SAMPLE = """\
function mpc = weird_case
% a comment line
mpc.version = '2';
mpc.baseMVA = 100;
mpc.bus = [
  10 3 50 10 0 0 1 1.0 0 138 1 1.05 0.95;
  20 1 80 16 0 0 1 1.0 0 138 1 1.05 0.95;  % trailing comment
  40 1  0  0 0 0 1 1.0 0 230 1 1.05 0.95
];
mpc.gen = [
  10 60 0 30 -30 1 100 1 ...
     60 12 0 0 0 0 0 0 0 0 0 0 0;
  20 99 0 30 -30 1 100 0 99 0 0 0 0 0 0 0 0 0 0 0 0;
  40 155 0 30 -30 1 100 1 155 54.25 0 0 0 0 0 0 0 0 0 0 0
];
mpc.branch = [
  10, 20, 0.01, 0.10, 0.0, 175, 0, 0, 0,   0, 1, -360, 360;
  20, 40, 0.01, 0.20, 0.0, 0,   0, 0, 1.05, 0, 1, -360, 360;
  10, 40, 0.01, 0.30, 0.0, 500, 0, 0, 0,   0, 0, -360, 360
];
"""


def test_parser_and_conventions(tmp_path):
    mpc = parse_matpower(_SAMPLE)
    assert mpc["version"] == "2"
    assert mpc["baseMVA"] == 100.0
    assert mpc["bus"].shape == (3, 13)
    assert mpc["gen"].shape == (3, 21)   # '...' continuation joined

    path = str(tmp_path / "weird_case.m")
    with open(path, "w") as f:
        f.write(_SAMPLE)
    case = load_matpower_case(path)
    # ext2int: buses 10/20/40 -> 0/1/2.
    assert case.n_bus == 3
    np.testing.assert_array_equal(case.bus_pd, [50.0, 80.0, 0.0])
    # status-0 gen and branch dropped.
    assert case.n_gen == 2 and case.n_branch == 2
    np.testing.assert_array_equal(case.gen_bus, [0, 2])
    np.testing.assert_allclose(case.gen_pmax, [60.0, 155.0])
    # off-nominal tap folds into x.
    np.testing.assert_allclose(case.br_x, [0.10, 0.20 * 1.05])
    # RATE_A=0 -> finite never-binding rating (>= 4x system peak).
    assert case.br_rate[1] >= 4 * 130.0
    assert case.br_rate[0] == 175.0
    # synthesized reliability: nearest class for 60 MW is U50.
    np.testing.assert_allclose(case.gen_mttf, [1980.0, 960.0])
    # branch 1 touches the 230 kV bus -> 230 class.
    np.testing.assert_allclose(case.br_lambda, [0.37, 0.38])


def test_reliability_size_mismatch(tmp_path):
    path = str(tmp_path / "weird_case.m")
    with open(path, "w") as f:
        f.write(_SAMPLE)
    with pytest.raises(ValueError, match="reliability arrays sized"):
        load_matpower_case(path, reliability={
            "genmttf": [1.0], "genmttr": [1.0],
            "brlambda": [0.1, 0.1], "brdur": [10.0, 10.0]})


def test_resolve_case(tmp_path):
    assert resolve_case("rts24").n_bus == 24
    path = str(tmp_path / "rc.m")
    save_matpower_case(cases.rts24(), path)
    assert resolve_case(path).n_bus == 24
    with pytest.raises(SystemExit, match="unknown case"):
        resolve_case("nope")
