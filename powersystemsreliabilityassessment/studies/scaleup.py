"""Scale-up study: larger multi-area systems with
multi-device scenario sharding and antithetic variance reduction.

Runs the HL2 NSQ pipeline on an RTS-96-style tiled system (3x RTS-24 areas
joined by inter-area ties; ``core/cases.py:replicate_case``) across the
full device mesh, optionally with antithetic sampling (paired U, 1-U
uniform draws — exact variance reduction for monotone state functions).
"""
from __future__ import annotations

from powersystemsreliabilityassessment.core import cases
from powersystemsreliabilityassessment.core.matpower_io import resolve_case
from powersystemsreliabilityassessment.studies.hl2_nsq import (
    run_nsq_study)
from powersystemsreliabilityassessment.utils.config import MCSConfig


def run(case_name: str = "rts96", samples: int = 50_000,
        batch_size: int = 4096, antithetic: bool = True,
        seed: int = 0) -> dict:
    case = resolve_case(case_name)   # builtin name or MATPOWER .m path
    res = run_nsq_study(
        case,
        MCSConfig(batch_size=batch_size, max_samples=samples,
                  beta_limit=0.0, seed=seed, antithetic=antithetic))
    return {"case": case.name, "n_bus": case.n_bus, "n_comp": case.n_comp,
            "edns_mw": res.edns_mw, "lole_hr_yr": res.lole_hr_yr,
            "beta": res.beta, "samples": res.samples,
            "antithetic": antithetic}


def antithetic_variance_comparison(samples: int = 20_000,
                                   seed: int = 0) -> dict:
    """Quantify the variance reduction: same budget with/without pairing."""
    case = cases.rts24()
    out = {}
    for anti in (False, True):
        res = run_nsq_study(case, MCSConfig(
            batch_size=2048, max_samples=samples, beta_limit=0.0,
            seed=seed, antithetic=anti), log_every=0)
        out["antithetic" if anti else "independent"] = {
            "edns": res.edns_mw, "beta": res.beta}
    return out
