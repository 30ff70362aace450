"""Run the remaining study configurations on the default device; save
results JSON."""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

out = {}

from powersystemsreliabilityassessment.studies import hl1_rts24
t0 = time.time()
out["hl1_rts24"] = hl1_rts24.run(iterations=20000, years=2000)
out["hl1_rts24"]["wall_s"] = time.time() - t0

from powersystemsreliabilityassessment.studies import scaleup
t0 = time.time()
out["antithetic"] = scaleup.antithetic_variance_comparison(samples=40960)
out["antithetic"]["wall_s"] = time.time() - t0
t0 = time.time()
out["rts96"] = scaleup.run(samples=40960, batch_size=4096)
out["rts96"]["wall_s"] = time.time() - t0

from powersystemsreliabilityassessment.core import cases
from powersystemsreliabilityassessment.studies.hl2_seq import run_seq_study
from powersystemsreliabilityassessment.utils.config import MCSConfig
t0 = time.time()
seqm = run_seq_study(cases.rts24(), MCSConfig(max_years=512, cov_threshold=0.0, seed=11),
                     years_per_device=8, max_lp=1024, scheduled_maintenance=True, log_every=10)
out["seq_with_maintenance"] = {"eens": seqm.eens_mwh_yr, "lole": seqm.lole_hr_yr,
                               "lolf": seqm.lolf_occ_yr, "years": seqm.years,
                               "wall_s": time.time() - t0}

from powersystemsreliabilityassessment.studies import planning_elu
from powersystemsreliabilityassessment.utils import report
t0 = time.time()
cmp600 = planning_elu.run_elu_comparison(mc_years=1000, seed=3)
out["elu_600h"] = cmp600.to_dict(); out["elu_600h"]["wall_s"] = time.time() - t0
t0 = time.time()
tail = planning_elu.run_tail_risk_study(mc_years=2000, seed=4)
out["tail_risk_50h"] = tail.to_dict(); out["tail_risk_50h"]["wall_s"] = time.time() - t0
os.makedirs("results", exist_ok=True)
report.plot_tail_risk(tail, "results/tail_risk.png")

from powersystemsreliabilityassessment.studies import multiarea_demo
t0 = time.time()
out["multiarea"] = multiarea_demo.run_demo(n_years=200, seed=5)
out["multiarea"]["wall_s"] = time.time() - t0

with open("results/study_sweep.json", "w") as f:
    json.dump(out, f, indent=2, default=str)
print(json.dumps(out, indent=1, default=str)[:2000])
