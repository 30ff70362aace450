"""HL1 three-engine comparison study (the ``run_full_comparison.jl`` /
``PowerSystemAdequacy.jl`` capability): analytical COPT convolution vs.
non-sequential MC vs. sequential MC on the same fleet + load model, with a
comparison table and convergence histories.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from jax.sharding import PartitionSpec as P
from jax import shard_map

from powersystemsreliabilityassessment.engines import copper_sheet, copt
from powersystemsreliabilityassessment.parallel import mesh as meshlib
from powersystemsreliabilityassessment.sampling import chronological


@dataclasses.dataclass(frozen=True)
class GeneratorSpec:
    """HL1 generator (PowerSystemAdequacy.jl Generator struct :20-37)."""
    id: int
    capacity: float
    mttf: float
    mttr: float

    @property
    def for_rate(self) -> float:
        lam, mu = 1.0 / self.mttf, 1.0 / self.mttr
        return lam / (lam + mu)


@dataclasses.dataclass
class MethodResult:
    method: str
    lole_hours_yr: float
    eue_mwh_yr: float
    computation_time: float
    convergence_history: list


def demo_fleet() -> list[GeneratorSpec]:
    """8-unit demo fleet in the spirit of run_full_comparison.jl:6-16."""
    data = [(1, 200, 1000, 50), (2, 200, 1100, 60), (3, 150, 900, 45),
            (4, 150, 950, 55), (5, 100, 1200, 40), (6, 100, 1150, 50),
            (7, 50, 800, 30), (8, 50, 850, 35)]
    return [GeneratorSpec(*d) for d in data]


def sinusoidal_load(hours: int = 8760, base: float = 600.0,
                    seasonal: float = 200.0, daily: float = 50.0,
                    noise: float = 20.0, seed: int = 0) -> np.ndarray:
    h = np.arange(hours)
    rng = np.random.default_rng(seed)
    load = (base + seasonal * np.sin(2 * np.pi * h / hours)
            + daily * np.sin(2 * np.pi * h / 24)
            + noise * rng.standard_normal(hours))
    return np.maximum(load, 0.0).astype(np.float32)


def run_analytical(gens: list[GeneratorSpec], hourly_load: np.ndarray,
                   step: float = 10.0) -> MethodResult:
    t0 = time.time()
    caps = jnp.asarray([g.capacity for g in gens], jnp.float32)
    fors = jnp.asarray([g.for_rate for g in gens], jnp.float32)
    total = float(caps.sum())
    n = copt.grid_points_for(total, step)
    probs = copt.build_copt(caps, fors, step, n)
    lole, eue = copt.lole_eue(probs, step, total, jnp.asarray(hourly_load))
    return MethodResult("Analytical", float(lole), float(eue),
                        time.time() - t0, [])


def run_non_sequential_mc(gens: list[GeneratorSpec], hourly_load: np.ndarray,
                          iterations: int, seed: int = 0,
                          batch: int = 1000,
                          mesh=None) -> MethodResult:
    """NSQ capacity-sampling MC, sharded over the scenario mesh: each
    device draws ``batch / n_dev`` samples per step and the (LOLE, EUE)
    partials are ``psum``-reduced (the reference's loop is single-threaded
    Julia, PowerSystemAdequacy.jl:169-208)."""
    t0 = time.time()
    caps = jnp.asarray([g.capacity for g in gens], jnp.float32)
    fors = jnp.asarray([g.for_rate for g in gens], jnp.float32)
    curve = copper_sheet.LoadCurve.build(jnp.asarray(hourly_load))
    mesh = mesh or meshlib.scenario_mesh()
    n_dev = mesh.devices.size
    bpd = max(1, batch // n_dev)

    def device_step(key):
        dev = jax.lax.axis_index(meshlib.SCENARIO_AXIS)
        lole, eue, _ = copper_sheet.nsq_batch(
            jax.random.fold_in(key, dev), caps, fors, curve, bpd)
        ps = lambda a: jax.lax.psum(a, meshlib.SCENARIO_AXIS)
        return ps(jnp.sum(lole)), ps(jnp.sum(eue))

    step = jax.jit(shard_map(device_step, mesh=mesh, in_specs=P(),
                             out_specs=(P(), P()), check_vma=False))
    key = jax.random.key(seed)
    per_batch = bpd * n_dev
    history, tot_l, tot_e, n = [], 0.0, 0.0, 0
    for b in range((iterations + per_batch - 1) // per_batch):
        lole_s, eue_s = step(jax.random.fold_in(key, b))
        tot_l += float(lole_s); tot_e += float(eue_s); n += per_batch
        history.append(tot_l / n)
    return MethodResult("Non-Sequential MC", tot_l / n, tot_e / n,
                        time.time() - t0, history)


def run_sequential_mc(gens: list[GeneratorSpec], hourly_load: np.ndarray,
                      years: int, seed: int = 1,
                      batch: int = 100,
                      mesh=None) -> MethodResult:
    """Chronological copper-sheet MC, years sharded over the mesh
    (PowerSystemAdequacy.jl:214-269's per-hour countdown loop)."""
    t0 = time.time()
    caps = jnp.asarray([g.capacity for g in gens], jnp.float32)
    mttf = np.asarray([g.mttf for g in gens])
    mttr = np.asarray([g.mttr for g in gens])
    hours = len(hourly_load)
    k = chronological.default_num_draws(mttf, mttr, hours)
    load_d = jnp.asarray(hourly_load)
    mttf_d = jnp.asarray(mttf, jnp.float32)
    mttr_d = jnp.asarray(mttr, jnp.float32)
    mesh = mesh or meshlib.scenario_mesh()
    n_dev = mesh.devices.size
    ypd = max(1, batch // n_dev)

    def device_step(key):
        dev = jax.lax.axis_index(meshlib.SCENARIO_AXIS)
        down = chronological.sample_timeline_batch(
            jax.random.fold_in(key, dev), mttf_d, mttr_d, hours, k, ypd)
        cap_series = copper_sheet.capacity_series_from_down(down, caps)
        lole, eens, _ = copper_sheet.hourly_deficit(cap_series, load_d)
        ps = lambda a: jax.lax.psum(a, meshlib.SCENARIO_AXIS)
        return ps(jnp.sum(lole)), ps(jnp.sum(eens))

    step = jax.jit(shard_map(device_step, mesh=mesh, in_specs=P(),
                             out_specs=(P(), P()), check_vma=False))
    key = jax.random.key(seed)
    per_batch = ypd * n_dev
    history, tot_l, tot_e, n = [], 0.0, 0.0, 0
    for b in range((years + per_batch - 1) // per_batch):
        lole_s, eens_s = step(jax.random.fold_in(key, b))
        tot_l += float(lole_s); tot_e += float(eens_s); n += per_batch
        history.append(tot_l / n)
    return MethodResult("Sequential MC", tot_l / n, tot_e / n,
                        time.time() - t0, history)


def compare_results(results: list[MethodResult]) -> str:
    """Comparison table (PowerSystemAdequacy.jl:275-298)."""
    lines = ["=" * 60,
             "       METHOD COMPARISON SUMMARY",
             "=" * 60,
             f"{'Method':<20} | {'LOLE(h/yr)':<10} | {'EUE(MWh)':<10} | "
             f"{'Time(s)':<8}",
             "-" * 60]
    for r in results:
        lines.append(f"{r.method:<20} | {r.lole_hours_yr:<10.4f} | "
                     f"{r.eue_mwh_yr:<10.2f} | {r.computation_time:<8.4f}")
    lines.append("-" * 60)
    return "\n".join(lines)


def run_full_comparison(iterations: int = 5000, years: int = 500,
                        seed: int = 0,
                        out_dir: str | None = None) -> dict[str, Any]:
    """The run_full_comparison.jl driver: all three engines + table
    (+ the convergence/comparison figure when ``out_dir`` is given,
    PowerSystemAdequacy.jl:275-298)."""
    gens = demo_fleet()
    load = sinusoidal_load(seed=seed)
    results = [
        run_analytical(gens, load),
        run_non_sequential_mc(gens, load, iterations, seed=seed),
        run_sequential_mc(gens, load, years, seed=seed + 1),
    ]
    print(compare_results(results))
    if out_dir is not None:
        import os

        from powersystemsreliabilityassessment.utils import report
        os.makedirs(out_dir, exist_ok=True)
        report.plot_hl1_comparison(
            results, os.path.join(out_dir, "hl1_comparison.png"))
    return {r.method: dataclasses.asdict(r) for r in results}
