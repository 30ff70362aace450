"""chip_smoke.py's phases at tiny sizes on the CPU.

On the card every phase runs at full size against the CPU device in the
same process; here "device" and "reference" are both the CPU, which
checks the phases' plumbing, placement, comparisons and checks. The
script's ``main`` itself must refuse the CPU.
"""
import jax
import numpy as np
import pytest

import chip_smoke
from powersystemsreliabilityassessment.core import cases
from powersystemsreliabilityassessment.runtime import device


@pytest.fixture(autouse=True)
def _no_persistent_cache(monkeypatch):
    # The CLI enables the persistent compile cache; keep it out of the
    # test workers' shared process state.
    monkeypatch.setattr(device, "enable_compile_cache", lambda: None)


@pytest.mark.parametrize("argv", [[], ["--chips", "4"]])
def test_main_refuses_cpu(argv, capsys):
    with pytest.raises(RuntimeError, match="no GPU found"):
        chip_smoke.main(argv)
    assert '"ok"' not in capsys.readouterr().out


def test_phase_card_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU found"):
        chip_smoke.phase_card()


def test_phase_bench_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU found"):
        chip_smoke.phase_bench()


def test_phase_golden():
    out = chip_smoke.phase_golden()
    assert out["states"] == 98 and out["flags_equal"]
    assert out["shedding"] > 0
    assert out["max_err_highs_mw"] <= chip_smoke.DNS_TOL_MW


@pytest.mark.parametrize("mode,cmp_batch", [("proportional", None),
                                            ("lp", 512)])
def test_phase_hot_path(mode, cmp_batch):
    out = chip_smoke.phase_hot_path(mode, batch=2048, max_lp=512,
                                    cmp_batch=cmp_batch, reps=1,
                                    hint_batch=2048)
    assert out["n_over"] == 0 and out["max_err_mw"] <= chip_smoke.DNS_TOL_MW
    # "lp" mode routes every deficit state to the LP.
    assert out["lp_lanes"] > 0 or mode == "proportional"
    assert out["compared_lanes"] == (cmp_batch or 2048)
    assert out["step_ms"] > 0 and out["lp_pass_ms"] > 0


def test_phase_large_m_path():
    # rts24 x 6 (m = 384) takes the large-m path case300s takes on the
    # card (structured block-Schur operator, island-PF tier, rescue).
    out = chip_smoke.phase_large_m(
        batch=256, case=cases.replicate_case(cases.rts24(), 6),
        hint_batch=512, max_highs=8)
    assert out["m"] == 384 and out["max_err_mw"] <= chip_smoke.DNS_TOL_MW
    assert out["memory_analysis"]["temp_size_in_bytes"] > 0


def test_phase_studies_through_cli(tmp_path):
    nsq = chip_smoke.phase_nsq(str(tmp_path / "nsq"), (
        "--samples", "1024", "--batch", "512"))
    assert nsq["samples"] == 1024 and nsq["device"]["platform"] == "cpu"
    seq = chip_smoke.phase_seq(str(tmp_path / "seq"), years=8, argv_extra=(
        "--years-per-device", "1"))
    assert seq["years"] == 8
    ma = chip_smoke.phase_multiarea(years=2)
    assert ma["eue_interconnected"] <= ma["eue_isolated"] + 1e-3


def test_cli_runs_without_matplotlib(tmp_path, monkeypatch, capsys):
    import json
    import sys

    from powersystemsreliabilityassessment.__main__ import main
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = main(["nsq", "--samples", "256", "--batch", "256",
                "--out", str(tmp_path)])
    assert out["figures"] == [] and np.isfinite(out["edns"])
    assert out["device"]["platform"] == "cpu"
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == out
    assert (tmp_path / "nsq_results.json").exists()


def test_phase_multichip_on_four_virtual_devices():
    devs = jax.devices()[:4]
    assert len(devs) == 4
    out = chip_smoke.phase_multichip(devs, per_card=256, seq_years=1,
                                     hours=48)
    assert out["counts_equal"] and out["devices"] == 4
    assert out["nsq_samples"] == 4 * 256 and out["seq_years"] == 4
    assert out["max_rel_diff"] <= 1e-5


@pytest.mark.parametrize("device_right", [True, False])
def test_compare_dns_settles_disputes_with_oracle(device_right):
    dns = np.array([0.0, 12.5, 0.0, 3.0])
    ref = np.array([0.0, 12.5, 0.18, 3.01])     # lane 2 disputed
    truth = 0.0 if device_right else 0.18
    calls = []

    def highs_of(i):
        calls.append(i)
        return truth

    if device_right:
        out = chip_smoke._compare_dns(dns, ref, "t", highs_of, 0.05)
        assert out["disputed_lanes"] == 1 and calls == [2]
        assert out["disputed_reference_wrong"] == 1
        assert out["max_err_mw"] == pytest.approx(0.01)
    else:
        with pytest.raises(chip_smoke.SmokeFailure, match="lane 2"):
            chip_smoke._compare_dns(dns, ref, "t", highs_of, 0.05)
