"""case300-scale NSQ end-to-end run (RESULTS.md "case300-scale NSQ").

Reproduces the committed artifact `results/case300_scaleup.json`: full
NSQ study on the synthetic 300-bus system (``cases.case300s``, m = 792 —
the large-m block-Schur LP path with the refinement+restart rescue).

Round-3 regime: the rank-4 Woodbury certificates close 99.45% of plain-MC
lanes, so the study runs at full batch (8192)
with the auto LP buffer instead of round-2's LP-bound batch-1024 /
max_lp-384 configuration, and the rare-event estimate composes the
copper-sheet control variate and/or the gens-only importance boost
(both leave branch outage rates at the true measure, preserving the
certificate closure).

Usage:
  python scripts/run_case300_scaleup.py                 # converged artifact
  python scripts/run_case300_scaleup.py --pilot         # config sweep
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import powersystemsreliabilityassessment as psra  # noqa: F401


def run_one(case, samples: int, seed: int, batch: int, is_boost: float,
            scope: str, cv: bool, beta_limit: float = 0.0,
            nodal_mode: str = "proportional", is_ce: bool = False) -> dict:
    """``nodal_mode="proportional"`` is the right regime at m = 792:
    only certificate MISSES (~0.55% of lanes) enter the LP buffer, so
    it stays at 128 lanes. "lp" mode would route every deficit state
    there and its default 25-50% buffer multiplies the [max_lp, 792,
    792] IPM temporaries. Aggregate indices are identical by construction."""
    import numpy as np

    from powersystemsreliabilityassessment.studies.hl2_nsq import (
        run_nsq_study)
    from powersystemsreliabilityassessment.utils.config import MCSConfig

    t0 = time.perf_counter()
    res = run_nsq_study(
        case,
        MCSConfig(batch_size=batch, max_samples=samples,
                  beta_limit=beta_limit, seed=seed,
                  is_boost=is_boost, is_boost_scope=scope,
                  nodal_mode=nodal_mode, is_ce=is_ce),
        control_variate=cv, log_every=50)
    wall = time.perf_counter() - t0
    # Warm throughput: drop the first convergence-history point's worth
    # of wall (compile lives there). Histories are per
    # batch, so warm wall ~ wall * (n_batches-1)/n_batches is NOT
    # recoverable post-hoc; instead report the honest incl-compile rate
    # plus the study's own batch count for context.
    return {"samples": res.samples, "seed": seed,
            "edns_mw": round(res.edns_mw, 5),
            "lole_hr_yr": round(res.lole_hr_yr, 3),
            "plc": round(res.plc, 7),
            "beta": round(float(res.beta), 5),
            "overflow_states": res.overflow_states,
            "wall_s_incl_compile": round(wall, 1),
            "samples_per_s_incl_compile": round(res.samples / wall, 1),
            "is_boost": is_boost, "scope": scope, "cv": cv,
            "is_ce": is_ce, "batch": batch,
            "nonfinite": bool(not np.isfinite(res.edns_mw))}


def main() -> None:
    import argparse

    from powersystemsreliabilityassessment.core import cases

    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--samples", type=int, default=262144)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--beta", type=float, default=0.05)
    ap.add_argument("--is-boost", type=float, default=0.0)
    ap.add_argument("--is-boost-scope", default="gens",
                    choices=["all", "gens", "branches"])
    ap.add_argument("--control-variate", action="store_true")
    ap.add_argument("--is-ce", action="store_true",
                    help="cross-entropy network-aware importance "
                         "sampling (calibrate_ce_proposal pilot)")
    ap.add_argument("--pilot", action="store_true",
                    help="16k-sample config sweep (plain / cv / boost / "
                         "cv+boost) instead of the converged artifact")
    ap.add_argument("--arm", default=None,
                    help="run a single pilot arm by name (one process "
                         "per arm)")
    ap.add_argument("--replicate-seeds", type=int, nargs="*", default=[],
                    help="extra seeds to replicate the converged run")
    ap.add_argument("--out", default="results/case300_scaleup.json")
    args = ap.parse_args()

    case = cases.case300s()
    base = {"case": case.name, "n_bus": case.n_bus, "n_comp": case.n_comp,
            "m": case.n_bus + case.n_branch}

    if args.pilot:
        grid = [
            ("plain", 0.0, "gens", False),
            ("cv", 0.0, "gens", True),
            ("boost2", 2.0, "gens", False),
            ("boost4", 4.0, "gens", False),
            ("cv_boost2", 2.0, "gens", True),
            ("cv_boost4", 4.0, "gens", True),
            ("brboost2", 2.0, "branches", False),
            ("brboost4", 4.0, "branches", False),
        ]
        if args.arm:
            grid = [g for g in grid if g[0] == args.arm]
        out = dict(base, pilot_samples=16384, runs={})
        path = args.out.replace(".json", "_pilot.json")
        if args.arm and os.path.exists(path):
            with open(path) as f:   # accumulate across per-arm processes
                out = json.load(f)
        for name, boost, scope, cv in grid:
            r = run_one(case, 16384, args.seed, args.batch, boost, scope,
                        cv, beta_limit=0.0)
            out["runs"][name] = r
            print(json.dumps({name: r}))
    else:
        out = dict(base)
        out.update(run_one(case, args.samples, args.seed, args.batch,
                           args.is_boost, args.is_boost_scope,
                           args.control_variate, beta_limit=args.beta,
                           is_ce=args.is_ce))
        reps = []
        for s in args.replicate_seeds:
            reps.append(run_one(case, args.samples, s, args.batch,
                                args.is_boost, args.is_boost_scope,
                                args.control_variate,
                                beta_limit=args.beta, is_ce=args.is_ce))
        if reps:
            out["replicates"] = reps
        path = args.out

    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
