"""Full-scale SEQ compat-mode parity table (VERDICT round-1 item 6).

Runs the sequential HL2 study twice at reference scale (CoV 0.05, RTS-24,
8736 h years): once in the default (correct-physics) mode and once with
``CompatFlags.island_blackout=True`` — the deliberate modeling choice
closest to the reference's accidental islanded-solve behavior (PARITY.md
forensics; seqMain.m:117-126, seq_mcsimulation.m:462-472). Commits the
five-index side-by-side against the reference artifact so the deviation
is bounded by numbers, not narrative.

Usage: python scripts/parity_seq_compat.py [--cov 0.05] [--years 4000]
       [--out results/seq_compat_parity.json]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import powersystemsreliabilityassessment as psra  # noqa: F401

from powersystemsreliabilityassessment.core import cases
from powersystemsreliabilityassessment.studies.hl2_seq import (
    run_seq_study)
from powersystemsreliabilityassessment.utils.config import (
    CompatFlags, MCSConfig)

# Reference artifact values (PARITY.md; Montecarlo_seq/
# seq_reliability_results.mat via seqMain.m:160-213).
ARTIFACT = {"eens_mwh_yr": 4266.87, "lole_hr_yr": 14.331,
            "lolf_occ_yr": 2.465, "plc": 1.640e-3, "edns_mw": 0.4884}
INDICES = list(ARTIFACT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cov", type=float, default=0.05)
    ap.add_argument("--years", type=int, default=4000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="results/seq_compat_parity.json")
    args = ap.parse_args()

    case = cases.rts24()
    out = {"artifact": ARTIFACT, "cov": args.cov, "seed": args.seed}
    for mode, compat in (("default", CompatFlags()),
                         ("island_blackout",
                          CompatFlags(island_blackout=True))):
        t0 = time.time()
        r = run_seq_study(case, MCSConfig(max_years=args.years,
                                          cov_threshold=args.cov,
                                          seed=args.seed),
                          compat=compat, log_every=20)
        wall = time.time() - t0
        out[mode] = {k: float(getattr(r, k)) for k in INDICES}
        out[mode].update(years=r.years, cov=float(r.cov),
                         wall_s=round(wall, 1))
        print(f"[{mode}] years {r.years} cov {r.cov:.4f} wall {wall:.0f}s")
        for k in INDICES:
            ours, ref = out[mode][k], ARTIFACT[k]
            print(f"  {k:>12s}: ours {ours:10.4f} | artifact {ref:10.4f} "
                  f"| {100 * (ours / ref - 1):+7.1f}%")

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
