"""float64-on-CPU golden replay (regression gate for the LP/DC-OPF path).

Replays a FIXED, seeded state set through the CPU evaluator and checks two
things:

  1. **Oracle agreement** — every lane's DNS against an independent
     float64 ``scipy.optimize.linprog(method="highs")`` solve of the same
     LP (the canonical oracle of ``tests/test_lp_dcopf.py``);
  2. **Replay stability** — the full DNS vector against the committed
     golden file ``tests/golden/golden_replay.json``. Any change to the LP
     path (solver iterations, certificates, conditioning tricks) that
     moves a state's answer shows up as a diff here, state-by-state,
     before it can bias a Monte Carlo study.

Usage:
    python scripts/golden_replay.py            # verify (exit 1 on drift)
    python scripts/golden_replay.py --update   # regenerate the golden file

The reference has no analog — its regression baselines are committed
end-of-run artifacts only (SURVEY.md §4 item 4); this gives per-state
coverage at ~1 s cost.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from powersystemsreliabilityassessment.core import cases  # noqa: E402
from powersystemsreliabilityassessment.core.system import build_system  # noqa: E402
from powersystemsreliabilityassessment.engines import dcopf  # noqa: E402
from powersystemsreliabilityassessment.utils import oracle  # noqa: E402
from powersystemsreliabilityassessment.utils.config import (  # noqa: E402
    CompatFlags, IPMConfig)

ORACLE_TOL_MW = 0.05   # |DNS - f64 oracle| per lane
REPLAY_TOL_MW = 0.02   # |DNS - committed golden| per lane


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--update", action="store_true",
                    help="regenerate the committed golden file")
    args = ap.parse_args()
    # The golden vector is the CPU float32 replay; pin the platform
    # before the first computation initializes a backend.
    jax.config.update("jax_platforms", "cpu")

    compat, ipm = CompatFlags(), IPMConfig()
    case = cases.rts24()
    sys_ = build_system(case, compat)
    downs, loads, tags = oracle.golden_state_set(case, sys_)

    res = dcopf.evaluate_states(sys_, jnp.asarray(downs), jnp.asarray(loads),
                                compat, ipm)
    dns = np.asarray(res.dns_mw, np.float64)

    # 1) oracle agreement, every lane
    worst, n_bad = 0.0, 0
    for i in range(len(tags)):
        ref = oracle.highs_dns(sys_, downs[i], loads[i], compat,
                               ipm.theta_max)
        err = abs(dns[i] - ref)
        worst = max(worst, err)
        if err > ORACLE_TOL_MW:
            n_bad += 1
            print(f"ORACLE MISMATCH {tags[i]}: dns={dns[i]:.4f} "
                  f"oracle={ref:.4f} (|err|={err:.4f} MW)")
    print(f"oracle check: {len(tags)} lanes, worst |err| = {worst:.5f} MW")

    # 2) replay vs committed golden
    if args.update:
        with open(oracle.GOLDEN_PATH, "w") as f:
            json.dump({"case": case.name, "seed": 2024, "tags": tags,
                       "dns_mw": [round(float(d), 6) for d in dns]}, f,
                      indent=1)
        print(f"golden file updated: {oracle.GOLDEN_PATH}")
        return 0 if n_bad == 0 else 1

    if not os.path.exists(oracle.GOLDEN_PATH):
        print(f"no golden file at {oracle.GOLDEN_PATH}; "
              "run with --update first")
        return 1
    with open(oracle.GOLDEN_PATH) as f:
        g = json.load(f)
    ref = np.asarray(g["dns_mw"], np.float64)
    if len(ref) != len(dns):
        print(f"golden length {len(ref)} != replay length {len(dns)}")
        return 1
    drift = np.abs(dns - ref)
    for i in np.nonzero(drift > REPLAY_TOL_MW)[0]:
        print(f"REPLAY DRIFT {g['tags'][i]}: dns={dns[i]:.4f} "
              f"golden={ref[i]:.4f}")
    print(f"replay check: worst drift = {drift.max():.5f} MW")
    ok = n_bad == 0 and bool((drift <= REPLAY_TOL_MW).all())
    print("golden replay:", "OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
