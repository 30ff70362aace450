"""Two-area interconnected adequacy study (run_adequacy_assessmentII.jl).

ISOLATED vs INTERCONNECTED support-policy comparison on the reference demo
system (AdequacyAssessmentII.jl:256-291): a "rich" area (5x400 MW) and a
"poor" area (5x200 MW) joined by a 200 MW tie; interconnection must reduce
both areas' risk (the policy comparison doubles as a sanity check,
SURVEY.md §4.1).
"""
from __future__ import annotations

import numpy as np

from powersystemsreliabilityassessment.engines import multiarea


def demo_system(hours: int = 8760) -> multiarea.MultiAreaSystem:
    h = np.linspace(0, 2 * np.pi, hours)
    return multiarea.MultiAreaSystem(
        area_names=["Area_Rich", "Area_Poor"],
        gen_capacity=[np.full(5, 400.0), np.full(5, 200.0)],
        gen_mttf=[np.full(5, 1000.0), np.full(5, 900.0)],
        gen_mttr=[np.full(5, 50.0), np.full(5, 60.0)],
        hourly_load=np.stack([1000.0 + 500.0 * np.sin(h),
                              800.0 + 400.0 * np.sin(h)]),
        tie_from=np.array([0], np.int32),
        tie_to=np.array([1], np.int32),
        tie_cap=np.array([200.0]),
    )


def run_demo(n_years: int = 100, seed: int = 0, hours: int = 8760) -> dict:
    sys = demo_system(hours)
    results = {}
    for policy in (multiarea.ISOLATED, multiarea.INTERCONNECTED):
        lole, eue = multiarea.run_multiarea_sequential(
            sys, policy, n_years, seed=seed)
        results[policy] = {"lole": lole.tolist(), "eue": eue.tolist()}

    print("\n=== MULTI-AREA COMPARISON ===")
    print(f"{'Policy':<15} | {'Area':<10} | {'LOLE (h/yr)':>11} | "
          f"{'EUE (MWh/yr)':>12}")
    print("-" * 60)
    for policy, res in results.items():
        for a, name in enumerate(sys.area_names):
            print(f"{policy:<15} | {name:<10} | {res['lole'][a]:>11.2f} | "
                  f"{res['eue'][a]:>12.2f}")
    return results


def case_system(case, hours: int = 8736) -> "multiarea.MultiAreaSystem":
    """HL1.5 view of any :class:`CaseData` carrying a per-bus area
    assignment (``bus_area`` — the MATPOWER BUS_AREA column for loaded
    ``.m`` cases, or the tiled construction for rts96/replicate_case)."""
    from powersystemsreliabilityassessment.core import load_profile

    if case.bus_area is None:
        raise ValueError(
            f"case {case.name!r} carries no area structure (bus_area is "
            "None / all buses share one MATPOWER area number) — the "
            "multi-area HL1.5 view needs >= 2 areas")
    return multiarea.areas_from_case(case, case.bus_area,
                                     load_profile.load_factors(hours))


def run_case_hl15(case, n_years: int = 50, seed: int = 0,
                  hours: int = 8736) -> dict:
    """ISOLATED vs INTERCONNECTED adequacy on any area-carrying case."""
    sys = case_system(case, hours)
    out = {}
    for policy in (multiarea.ISOLATED, multiarea.INTERCONNECTED):
        lole, eue = multiarea.run_multiarea_sequential(
            sys, policy, n_years, seed=seed)
        out[policy] = {"lole": lole.tolist(), "eue": eue.tolist()}
    return out


def rts96_three_area_system(hours: int = 8736) -> "multiarea.MultiAreaSystem":
    """HL1.5 view of RTS-96, derived directly from the network case: three
    RTS-24 areas with the five published inter-area ties (107-203 at
    175 MW plus 113-215/123-217/223-318/325-121 at 500 MW each, so A-B
    aggregates to 1175 MW of tie capability) and RTS-79 chronological
    loads per area."""
    from powersystemsreliabilityassessment.core import cases

    return case_system(cases.rts96(), hours)


def ring_system(n_areas: int, hours: int = 8736) -> "multiarea.MultiAreaSystem":
    """N-area ring built from the tiled RTS construction (two 500 MW ties
    between consecutive areas) — the >2-area generalization of the
    reference's two-area demo."""
    from powersystemsreliabilityassessment.core import cases

    return case_system(cases.replicate_case(cases.rts24(), n_areas), hours)


def run_nring_demo(n_areas: int = 4, n_years: int = 50, seed: int = 0,
                   hours: int = 8736) -> dict:
    """ISOLATED vs INTERCONNECTED on an N-area ring (N > 2)."""
    sys = ring_system(n_areas, hours)
    out = {}
    for policy in (multiarea.ISOLATED, multiarea.INTERCONNECTED):
        lole, eue = multiarea.run_multiarea_sequential(
            sys, policy, n_years, seed=seed)
        out[policy] = {"lole": lole.tolist(), "eue": eue.tolist()}
    print(f"\n=== {n_areas}-AREA RING ===")
    for policy, res in out.items():
        for a, name in enumerate(sys.area_names):
            print(f"{policy:<15} | {name:<6} | LOLE {res['lole'][a]:8.2f} "
                  f"h/yr | EUE {res['eue'][a]:10.2f} MWh/yr")
    return out


def run_rts96_hl15(n_years: int = 50, seed: int = 0,
                   hours: int = 8736) -> dict:
    """Three-area generation-adequacy comparison on the RTS-96 topology."""
    sys = rts96_three_area_system(hours)
    out = {}
    for policy in (multiarea.ISOLATED, multiarea.INTERCONNECTED):
        lole, eue = multiarea.run_multiarea_sequential(
            sys, policy, n_years, seed=seed)
        out[policy] = {"lole": lole.tolist(), "eue": eue.tolist()}
    return out
