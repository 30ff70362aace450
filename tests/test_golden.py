"""Golden-value regression pins (SURVEY.md §4 implication (c)).

Two layers:
1. exact regression pins of THIS framework's deterministic small-sample
   outputs (catches any behavioral drift in sampling/evaluation/reduction);
2. statistical-consistency gates against the reference baselines scaled to
   the small sample's Monte-Carlo tolerance (the full-scale comparison
   lives in PARITY.md).
"""
import pytest

from powersystemsreliabilityassessment.core import cases
from powersystemsreliabilityassessment.studies.hl2_nsq import run_nsq_study
from powersystemsreliabilityassessment.studies.hl2_seq import run_seq_study
from powersystemsreliabilityassessment.utils.config import MCSConfig

# Recorded from the virtual 8-device CPU mesh (conftest forces it).
GOLDEN_EDNS = 13.746116638183594
GOLDEN_LOLE = 787.03125
GOLDEN_PLC = 0.08984375

REF_EDNS = 14.8894    # reliability_results.mat (PARITY.md)
REF_LOLE = 735.93


def test_nsq_small_sample_regression_pin():
    r = run_nsq_study(cases.rts24(),
                      MCSConfig(batch_size=128, max_samples=256, seed=9),
                      log_every=0)
    assert r.samples == 256
    assert r.edns_mw == pytest.approx(GOLDEN_EDNS, rel=1e-5)
    assert r.lole_hr_yr == pytest.approx(GOLDEN_LOLE, rel=1e-6)
    assert r.plc == pytest.approx(GOLDEN_PLC, rel=1e-9)
    # statistical gate vs the reference artifact: 256 samples -> EDNS
    # standard error ~ 3 MW; 3-sigma window.
    assert abs(r.edns_mw - REF_EDNS) < 9.0
    assert abs(r.lole_hr_yr - REF_LOLE) < 350.0


# SEQ small-run pin (16 years x 2016 h on the 8-device CPU mesh; the
# 12-week window is the shortest horizon with nonzero shed at seed 2):
# catches silent drift anywhere in the chronological sampler / screened
# evaluator / annual-index path, which the NSQ pin does not cover.
# Recorded twice (pre/post the round-2 trace-time refactor) — identical.
GOLDEN_SEQ_EENS = 3.8826998472213745
GOLDEN_SEQ_LOLE = 0.375
GOLDEN_SEQ_LOLF = 0.1875


def test_seq_small_sample_regression_pin():
    r = run_seq_study(cases.rts24(),
                      MCSConfig(max_years=16, cov_threshold=0.0, seed=2),
                      years_per_device=2, max_lp=96, hours=2016,
                      log_every=0)
    assert r.years == 16
    assert r.eens_mwh_yr == pytest.approx(GOLDEN_SEQ_EENS, rel=1e-5)
    assert r.lole_hr_yr == pytest.approx(GOLDEN_SEQ_LOLE, rel=1e-6)
    assert r.lolf_occ_yr == pytest.approx(GOLDEN_SEQ_LOLF, rel=1e-6)
