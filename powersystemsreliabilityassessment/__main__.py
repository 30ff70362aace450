"""Command-line interface: ``python -m powersystemsreliabilityassessment``.

Runs the study configurations:

  nsq         HL2 non-sequential MCS (nsqMain path)
  seq         HL2 sequential chronological MCS (seqMain path)
  hl1         HL1 three-engine comparison (run_full_comparison path)
  planning    analytical planning + ELU comparison + tail risk
  multiarea   two-area ISOLATED vs INTERCONNECTED comparison
  bench       throughput benchmark
"""
from __future__ import annotations

import argparse
import json


def build_parser() -> argparse.ArgumentParser:
    """CLI parser, separate from dispatch so tests can parse
    flag combinations without running a study."""
    p = argparse.ArgumentParser(prog="powersystemsreliabilityassessment")
    sub = p.add_subparsers(dest="study", required=True)

    nsq = sub.add_parser("nsq")
    nsq.add_argument("--case", default="rts24",
                     help="builtin case name or MATPOWER .m path")
    nsq.add_argument("--samples", type=int, default=100_000)
    nsq.add_argument("--batch", type=int, default=8192)
    nsq.add_argument("--beta", type=float, default=0.0017)
    nsq.add_argument("--seed", type=int, default=0)
    nsq.add_argument("--out", default="results")
    nsq.add_argument("--checkpoint", default=None)
    nsq.add_argument("--checkpoint-backend", default="json",
                     choices=["json", "orbax"])
    nsq.add_argument("--is-boost", type=float, default=0.0,
                     help="importance-sampling failure boost (0 = plain "
                          "MC; try 2-4 for rare-event regimes)")
    nsq.add_argument("--is-boost-scope", default="all",
                     choices=["all", "gens", "branches"],
                     help="components the boost applies to: 'gens' "
                          "leaves branch rates at the true measure, "
                          "preserving the certificate closure rate; "
                          "'branches' targets transmission/islanding-"
                          "driven risk (case300-class systems)")
    nsq.add_argument("--is-ce", action="store_true",
                     help="cross-entropy ADAPTIVE importance sampling: "
                          "a pilot phase learns per-component proposal "
                          "rates from the CE-optimal marginals "
                          "E[DNS*1(k down)]/E[DNS] — the network-aware "
                          "tilt for transmission-driven regimes where "
                          "a uniform boost is blind "
                          "(hl2_nsq.calibrate_ce_proposal)")
    nsq.add_argument("--ce-rounds", type=int, default=2)
    nsq.add_argument("--ce-batch", type=int, default=32768)
    nsq.add_argument("--ce-boost0", type=float, default=4.0)
    nsq.add_argument("--control-variate", action="store_true",
                     help="copper-sheet control variate with exact f64 "
                          "COPT mean (composes with --is-boost and "
                          "antithetic; studies/hl2_nsq.py)")
    nsq.add_argument("--enum-order", type=int, default=0,
                     help="contingency-enumeration hybrid: evaluate every "
                          "state with <= K outages exactly (f64-weighted "
                          "pre-pass), MC only the deeper tail "
                          "(sampling/enumeration.py; try 3-5)")

    seq = sub.add_parser("seq")
    seq.add_argument("--case", default="rts24",
                     help="builtin case name or MATPOWER .m path")
    seq.add_argument("--years", type=int, default=4000)
    seq.add_argument("--cov", type=float, default=0.05)
    seq.add_argument("--seed", type=int, default=0)
    seq.add_argument("--out", default="results")
    seq.add_argument("--checkpoint", default=None)
    seq.add_argument("--checkpoint-backend", default="json",
                     choices=["json", "orbax"])
    seq.add_argument("--years-per-device", type=int, default=16,
                     help="simulated years per device batch (bigger = "
                          "fewer dispatches but longer first compile)")
    seq.add_argument("--split-level", default=None,
                     help="enable multilevel splitting (RESTART): copper "
                          "margin level in MW that triggers cloning, or "
                          "'auto' to calibrate from a sampler-only pilot "
                          "(rare-event variance reduction; see "
                          "studies/hl2_seq_split.py)")
    seq.add_argument("--split-k", type=int, default=4,
                     help="tail samples per split parent (incl. parent)")
    seq.add_argument("--control-variate", action="store_true",
                     help="copper-sheet control variate with exact f64 "
                          "COPT mean (implies --sampling stationary; "
                          "studies/hl2_seq.py)")
    seq.add_argument("--sampling", default="reference",
                     choices=("reference", "stationary"),
                     help="'stationary' starts each year from the "
                          "stationary component distribution "
                          "(continuous dwells, no January transient)")
    seq.add_argument("--split-max", type=int, default=8,
                     help="max split parents per device batch")
    seq.add_argument("--maintenance", action="store_true",
                     help="apply the levelized maintenance schedule "
                          "derived from the genweeks data (reference "
                          "case24_failrate.m col 4; incompatible with "
                          "--control-variate and --split-level)")

    hl1 = sub.add_parser("hl1")
    hl1.add_argument("--iterations", type=int, default=5000)
    hl1.add_argument("--years", type=int, default=500)
    hl1.add_argument("--out", default="results")

    edu = sub.add_parser(
        "education",
        help="Markov-process / parameter-estimation / COPT teaching "
             "figures (Markov_process.jl, parameter_estimation.jl, "
             "generating_adequacy_assessment.jl)")
    edu.add_argument("--out", default="results")

    pl = sub.add_parser("planning")
    pl.add_argument("--mc-years", type=int, default=1000)
    pl.add_argument("--hydro-hours", type=float, default=600.0)

    ma = sub.add_parser("multiarea")
    ma.add_argument("--years", type=int, default=100)
    ma.add_argument("--system", default="demo",
                    choices=["demo", "rts96", "ring", "case"],
                    help="demo: reference 2-area; rts96: 3 areas from the "
                         "network case; ring: N-area tiled ring; case: "
                         "areas from --case's BUS_AREA column")
    ma.add_argument("--areas", type=int, default=4,
                    help="ring size (--system ring)")
    ma.add_argument("--case", default="rts96",
                    help="builtin case name or MATPOWER .m path "
                         "(--system case)")

    sc = sub.add_parser("scaleup")
    sc.add_argument("--case", default="rts96")
    sc.add_argument("--samples", type=int, default=50_000)
    sc.add_argument("--antithetic", action="store_true", default=True)

    sub.add_parser("bench")

    return p


def _emit(result: dict) -> dict:
    """Print the study's one JSON line, naming the device it ran on,
    and return it."""
    from powersystemsreliabilityassessment.runtime import device
    out = {**result, "device": device.jax_device()}
    print(json.dumps(out))
    return out


def _draw(figures: list) -> list:
    """Run each ``(path, draw)`` pair when matplotlib is installed and
    return the paths written (none without matplotlib: figures are
    optional output, the study's numbers are not)."""
    from powersystemsreliabilityassessment.utils import report
    if not report.can_plot():
        return []
    for path, draw in figures:
        draw(path)
    return [path for path, _ in figures]


def main(argv: list[str] | None = None) -> dict | None:
    """Run one study; returns the JSON line's content where it prints
    one."""
    p = build_parser()
    args = p.parse_args(argv)
    from powersystemsreliabilityassessment.runtime import device
    device.enable_compile_cache()

    if args.study == "nsq":
        from powersystemsreliabilityassessment.core.matpower_io import (
            resolve_case)
        from powersystemsreliabilityassessment.runtime.checkpoint import (
            Checkpointer, OrbaxCheckpointer)
        from powersystemsreliabilityassessment.studies.hl2_nsq import (
            run_nsq_study)
        from powersystemsreliabilityassessment.utils import report
        from powersystemsreliabilityassessment.utils.config import MCSConfig
        case = resolve_case(args.case)
        cls = (OrbaxCheckpointer if args.checkpoint_backend == "orbax"
               else Checkpointer)
        ck = cls(args.checkpoint) if args.checkpoint else None
        res = run_nsq_study(case, MCSConfig(
            batch_size=args.batch, max_samples=args.samples,
            beta_limit=args.beta, seed=args.seed,
            is_boost=args.is_boost,
            is_boost_scope=args.is_boost_scope,
            is_ce=args.is_ce, ce_rounds=args.ce_rounds,
            ce_batch=args.ce_batch, ce_boost0=args.ce_boost0),
            checkpointer=ck, control_variate=args.control_variate,
            enum_order=args.enum_order)
        report.export_study(res, args.out, "nsq")
        figures = _draw([
            (f"{args.out}/convergence.png",
             lambda f: report.plot_nsq(res, f, args.beta)),
            (f"{args.out}/nodal_reliability.png",
             lambda f: report.plot_nodal_and_weakpoints(
                 res.nodal_eens_mwh_yr, res.comp_importance, case.n_gen,
                 f))])
        return _emit({"edns": res.edns_mw, "lole": res.lole_hr_yr,
               "plc": res.plc, "beta": res.beta, "samples": res.samples,
               "converged": res.converged, "figures": figures})
    elif args.study == "seq":
        from powersystemsreliabilityassessment.core.matpower_io import (
            resolve_case)
        from powersystemsreliabilityassessment.runtime.checkpoint import (
            Checkpointer, OrbaxCheckpointer)
        from powersystemsreliabilityassessment.studies.hl2_seq import (
            run_seq_study)
        from powersystemsreliabilityassessment.utils import report
        from powersystemsreliabilityassessment.utils.config import MCSConfig
        case = resolve_case(args.case)
        cls = (OrbaxCheckpointer if args.checkpoint_backend == "orbax"
               else Checkpointer)
        ck = cls(args.checkpoint) if args.checkpoint else None
        if args.split_level is not None:
            if args.control_variate or args.sampling != "reference":
                p.error("--split-level cannot be combined with "
                        "--control-variate/--sampling (the split study "
                        "uses its own continuous-dwell sampler; "
                        "silently ignoring the flags would misreport "
                        "the estimator in use)")
            if args.maintenance:
                p.error("--split-level does not support --maintenance "
                        "(cloning restarts assume time-homogeneous "
                        "component processes)")
            from powersystemsreliabilityassessment.studies.hl2_seq_split import (
                SplitConfig, run_seq_split_study)
            res = run_seq_split_study(
                case, MCSConfig(max_years=args.years,
                                cov_threshold=args.cov, seed=args.seed),
                SplitConfig(level_mw=(None if args.split_level == "auto"
                                      else float(args.split_level)),
                            k_clones=args.split_k,
                            max_split=args.split_max),
                years_per_device=args.years_per_device, checkpointer=ck)
        else:
            res = run_seq_study(case, MCSConfig(
                max_years=args.years, cov_threshold=args.cov,
                seed=args.seed),
                years_per_device=args.years_per_device, checkpointer=ck,
                sampling=args.sampling,
                control_variate=args.control_variate,
                scheduled_maintenance=args.maintenance)
        report.export_study(res, args.out, "seq")
        figures = _draw([(f"{args.out}/convergence_curve.png",
                          lambda f: report.plot_seq(res, f, args.cov,
                                                    case.n_gen))])
        return _emit({"eens": res.eens_mwh_yr, "lole": res.lole_hr_yr,
               "lolf": res.lolf_occ_yr, "years": res.years,
               "figures": figures})
    elif args.study == "hl1":
        from powersystemsreliabilityassessment.studies import hl1_comparison
        from powersystemsreliabilityassessment.utils import report
        hl1_comparison.run_full_comparison(
            args.iterations, args.years,
            out_dir=args.out if report.can_plot() else None)
    elif args.study == "education":
        import os

        import numpy as np

        from powersystemsreliabilityassessment.engines import copt
        from powersystemsreliabilityassessment.studies import (
            hl1_comparison, markov_education)
        from powersystemsreliabilityassessment.utils import report
        os.makedirs(args.out, exist_ok=True)
        times, tt, pdf = markov_education.exponential_proof()
        single = markov_education.single_component_study()
        cap, total = markov_education.multi_unit_capacity_series()
        report.plot_markov_education(
            times, tt, pdf, single, cap, total,
            f"{args.out}/markov_process.png")
        est = markov_education.parameter_estimation_study()
        report.plot_parameter_estimation(
            est, f"{args.out}/parameter_estimation.png")
        gens = hl1_comparison.demo_fleet()
        caps = np.array([g.capacity for g in gens], np.float32)
        fors = np.array([g.for_rate for g in gens], np.float32)
        step = 10.0
        n = copt.grid_points_for(float(caps.sum()), step)
        probs = copt.build_copt(caps, fors, step, n)
        report.plot_copt_adequacy(
            probs, step, float(caps.sum()),
            hl1_comparison.sinusoidal_load(),
            f"{args.out}/copt_adequacy.png")
        print(json.dumps({"figures": ["markov_process.png",
                                      "parameter_estimation.png",
                                      "copt_adequacy.png"],
                          "out": args.out}))
    elif args.study == "planning":
        from powersystemsreliabilityassessment.studies import planning_elu
        from powersystemsreliabilityassessment.utils import report
        fleet = planning_elu.demo_planning_fleet(args.hydro_hours)
        res = planning_elu.run_elu_comparison(fleet, mc_years=args.mc_years)
        figures = _draw([("results/tail_risk.png",
                          lambda f: report.plot_tail_risk(res, f))])
        return _emit({**res.to_dict(), "figures": figures})
    elif args.study == "multiarea":
        from powersystemsreliabilityassessment.studies import multiarea_demo
        if args.system == "rts96":
            return _emit(multiarea_demo.run_rts96_hl15(args.years))
        elif args.system == "ring":
            return _emit(multiarea_demo.run_nring_demo(args.areas,
                                                       args.years))
        elif args.system == "case":
            from powersystemsreliabilityassessment.core.matpower_io import (
                resolve_case)
            return _emit(multiarea_demo.run_case_hl15(
                resolve_case(args.case), args.years))
        else:
            return _emit(multiarea_demo.run_demo(args.years))
    elif args.study == "scaleup":
        from powersystemsreliabilityassessment.studies import scaleup
        return _emit(scaleup.run(case_name=args.case, samples=args.samples,
                                 antithetic=args.antithetic))
    elif args.study == "bench":
        import runpy
        runpy.run_path("bench.py", run_name="__main__")


if __name__ == "__main__":
    main()
