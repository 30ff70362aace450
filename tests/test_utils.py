"""Utility-layer coverage: profiling counters, checkpoint round-trip,
report helpers."""
import numpy as np

from powersystemsreliabilityassessment.runtime.checkpoint import Checkpointer
from powersystemsreliabilityassessment.utils import profiling, report


def test_timings_sections():
    t = profiling.Timings()
    with t.section("solve", items=100):
        pass
    with t.section("solve", items=50):
        pass
    rep = t.report()
    assert "solve" in rep
    assert t.counts["solve"] == 150


def test_checkpointer_roundtrip_and_clear(tmp_path):
    ck = Checkpointer(str(tmp_path / "x.ckpt"))
    assert ck.restore() is None
    state = {"a": 1.5, "arr": np.arange(4.0), "nested": {"b": [1, 2]}}
    ck.save(state)
    back = ck.restore()
    assert back["a"] == 1.5
    np.testing.assert_array_equal(back["arr"], np.arange(4.0))
    assert back["nested"]["b"] == [1, 2]
    ck.clear()
    assert ck.restore() is None


def test_orbax_checkpointer_roundtrip(tmp_path):
    from powersystemsreliabilityassessment.runtime.checkpoint import (
        OrbaxCheckpointer)
    ck = OrbaxCheckpointer(str(tmp_path / "orbax_ckpt"))
    assert ck.restore() is None
    state = {"stats": {"n": 256.0, "sum_dns": 3.5,
                       "nodal": np.arange(24.0)},
             "histories": {"beta": [0.3, 0.2], "edns": [1.0, 1.1]},
             "batch_idx": 2, "overflow": 0}
    ck.save(state)
    back = ck.restore()
    assert float(back["stats"]["n"]) == 256.0
    np.testing.assert_array_equal(np.asarray(back["stats"]["nodal"]),
                                  np.arange(24.0))
    assert [float(x) for x in back["histories"]["beta"]] == [0.3, 0.2]
    assert int(back["batch_idx"]) == 2
    ck.save({**state, "batch_idx": 3})  # overwrite (force) path
    assert int(ck.restore()["batch_idx"]) == 3
    ck.clear()
    assert ck.restore() is None


def test_report_helpers(tmp_path):
    imp = np.array([0.1, 0.5, 0.02, 0.4])
    top = report.top_components(imp, n_gen=2, k=3)
    assert top[0] == ("Gen 2", 0.5)
    assert top[1] == ("Line 2", 0.4)
    path = tmp_path / "nodal.csv"
    report.export_nodal_csv(str(path), np.array([1.0, 2.0]))
    lines = path.read_text().strip().splitlines()
    assert lines[0] == "BusID,EENS_MWh_yr"
    assert lines[1].startswith("1,")


def test_export_mat_roundtrip(tmp_path):
    from scipy.io import loadmat
    d = {"edns_mw": 1.25, "samples": 1024, "converged": True,
         "beta_history": [0.5, 0.2, 0.1],
         "nodal_eens_mwh_yr": [1.0, 2.0, 3.0],
         "none_field": None, "empty": []}
    path = str(tmp_path / "res.mat")
    report.export_mat(path, d)
    back = loadmat(path)
    assert float(back["edns_mw"]) == 1.25
    assert float(back["samples"]) == 1024.0
    np.testing.assert_allclose(back["beta_history"].ravel(),
                               [0.5, 0.2, 0.1])
    np.testing.assert_allclose(back["nodal_eens_mwh_yr"].ravel(),
                               [1.0, 2.0, 3.0])
    assert "none_field" not in back and "empty" not in back
