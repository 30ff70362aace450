"""HL1 generation adequacy on IEEE RTS-24.

Copper-sheet (no network) adequacy of the RTS-24 generation fleet against
the RTS-79 chronological load curve, by all three engines: analytical COPT
convolution, non-sequential MC, sequential MC. This is the
``run_full_comparison`` capability applied to the flagship system instead
of a demo fleet.
"""
from __future__ import annotations

import numpy as np

from powersystemsreliabilityassessment.core import cases, load_profile
from powersystemsreliabilityassessment.studies import hl1_comparison


def rts24_fleet() -> list[hl1_comparison.GeneratorSpec]:
    case = cases.rts24()
    return [
        hl1_comparison.GeneratorSpec(i + 1, float(case.gen_pmax[i]),
                                     float(case.gen_mttf[i]),
                                     float(case.gen_mttr[i]))
        for i in range(case.n_gen) if case.gen_pmax[i] > 0
    ]


def rts24_load(hours: int = 8736) -> np.ndarray:
    return (load_profile.PEAK_MW
            * load_profile.load_factors(hours)).astype(np.float32)


def run(iterations: int = 20000, years: int = 2000, seed: int = 0) -> dict:
    gens = rts24_fleet()
    load = rts24_load()
    results = [
        hl1_comparison.run_analytical(gens, load, step=1.0),
        hl1_comparison.run_non_sequential_mc(gens, load, iterations,
                                             seed=seed),
        hl1_comparison.run_sequential_mc(gens, load, years, seed=seed + 1),
    ]
    print(hl1_comparison.compare_results(results))
    return {r.method: {"lole": r.lole_hours_yr, "eue": r.eue_mwh_yr}
            for r in results}
