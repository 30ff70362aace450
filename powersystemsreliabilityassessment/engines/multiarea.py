"""Multi-area adequacy with tie-line constraints (HL1.5).

Replaces ``AdequacyAssessmentII.jl`` (module AdequacyAssessmentFast): areas
with their own fleets and load curves, joined by capacity-limited tie
lines; per-hour minimum total curtailment moving surplus to deficit areas.

The reference hand-rolls a Ford-Fulkerson augmenting-path max-flow
(:73-179). Max-flow min-curtailment is a tiny LP, so here it reuses the
batched interior-point engine (one more consumer of the same kernel —
SURVEY.md §7 layer 6):

    variables  x = [flow+ (T), flow- (T), curtail (A), spill (A)]
    minimize   sum(curtail)
    s.t. per area: margin + inflow - outflow + curtail - spill = 0
         0 <= flow± <= tie_cap, 0 <= curtail <= max(-margin,0)+,
         0 <= spill

with a vectorized fast path for the all-margins-nonnegative case
(:78-80) and the closed-form ISOLATED policy (:84-92).
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from powersystemsreliabilityassessment.sampling import chronological
from powersystemsreliabilityassessment.utils.config import IPMConfig

ISOLATED = "isolated"
INTERCONNECTED = "interconnected"


@dataclasses.dataclass(frozen=True)
class MultiAreaSystem:
    """Host-side description (numpy)."""
    area_names: list
    gen_capacity: list          # per area: np [Gi]
    gen_mttf: list
    gen_mttr: list
    hourly_load: np.ndarray     # [A, H]
    tie_from: np.ndarray        # [T] 0-based area index
    tie_to: np.ndarray          # [T]
    tie_cap: np.ndarray         # [T]

    @property
    def n_areas(self) -> int:
        return len(self.area_names)


def areas_from_case(case, area_of_bus: np.ndarray,
                    hourly_factors: np.ndarray,
                    area_names: list | None = None) -> MultiAreaSystem:
    """Build the HL1.5 multi-area view of a full network case.

    Generalizes the reference's hand-built two-area demo
    (AdequacyAssessmentII.jl:259-269) to ANY :class:`CaseData` plus a
    per-bus area assignment: each area aggregates its generating units
    (zero-capacity units, i.e. synchronous condensers, are dropped — they
    carry no adequacy), each inter-area branch becomes one tie line with
    its continuous rating as capacity (parallel ties stay separate
    entries; the curtailment LP handles them natively), and each area's
    chronological load is its summed bus peak load scaled by
    ``hourly_factors``.

    Args:
      case: a :class:`~..core.cases.CaseData`.
      area_of_bus: [nb] int area index per bus (e.g. ``arange(nb) // 24``
        for tiled RTS constructions).
      hourly_factors: [H] load-profile factors (1.0 = bus peak).
    """
    area_of_bus = np.asarray(area_of_bus, np.int64)
    n_areas = int(area_of_bus.max()) + 1
    if area_names is None:
        area_names = [chr(ord("A") + a) if n_areas <= 26 else f"Area{a}"
                      for a in range(n_areas)]
    gen_area = area_of_bus[np.asarray(case.gen_bus)]
    real = np.asarray(case.gen_pmax) > 0
    gen_capacity = [np.asarray(case.gen_pmax)[real & (gen_area == a)]
                    for a in range(n_areas)]
    gen_mttf = [np.asarray(case.gen_mttf)[real & (gen_area == a)]
                for a in range(n_areas)]
    gen_mttr = [np.asarray(case.gen_mttr)[real & (gen_area == a)]
                for a in range(n_areas)]
    af = area_of_bus[np.asarray(case.br_from)]
    at = area_of_bus[np.asarray(case.br_to)]
    inter = af != at
    factors = np.asarray(hourly_factors, np.float64)
    area_peak = np.zeros(n_areas)
    np.add.at(area_peak, area_of_bus, np.asarray(case.bus_pd))
    return MultiAreaSystem(
        area_names=area_names,
        gen_capacity=gen_capacity,
        gen_mttf=gen_mttf,
        gen_mttr=gen_mttr,
        hourly_load=area_peak[:, None] * factors[None, :],
        tie_from=af[inter].astype(np.int32),
        tie_to=at[inter].astype(np.int32),
        tie_cap=np.asarray(case.br_rate)[inter].astype(np.float64),
    )


def curtail_isolated(margins: jax.Array) -> jax.Array:
    """[..., A] -> [..., A]: curtailment = -min(margin, 0)."""
    return jnp.maximum(-margins, 0.0)


def _build_interconnect_lp(margins, tie_from, tie_to, tie_cap, big):
    """Assemble one interconnected-curtailment LP instance (vmapped)."""
    A_areas = margins.shape[0]
    T = tie_cap.shape[0]
    dt = margins.dtype
    # incidence of directed flows: +1 into 'to', -1 out of 'from'
    inc = jnp.zeros((A_areas, T), dt)
    inc = inc.at[tie_to, jnp.arange(T)].add(1.0)
    inc = inc.at[tie_from, jnp.arange(T)].add(-1.0)
    # Per-area curtailment is capped at the area's ISOLATED deficit: the
    # reference's max-flow moves surplus only, so interconnection can never
    # worsen an area (AdequacyAssessmentII.jl policy comparison invariant).
    # Without this cap the min-total-curtailment LP has degenerate optima
    # that redistribute shedding between deficit areas. Surplus areas get a
    # ZERO curtail column + dummy box (epsilon-width boxes break the f32
    # interior point; see dcopf.build_state_lp).
    deficit_mask = (margins < 0).astype(dt)
    curtail_cap = jnp.where(margins < 0, -margins, 1.0)
    # x = [f+ (T), f- (T), curtail (A), spill (A)]
    Amat = jnp.concatenate(
        [inc, -inc, jnp.eye(A_areas, dtype=dt) * deficit_mask[None, :],
         -jnp.eye(A_areas, dtype=dt)],
        axis=1)
    b = -margins
    # Tiny cost on tie flows: among the (often degenerate) minimum-total-
    # curtailment optima, pick the MINIMAL-FLOW one — no power is routed
    # through a deficit area just to re-shed it elsewhere. This matches the
    # reference max-flow's augmenting-path behavior (surplus moves only
    # toward unserved demand) and makes the per-area split deterministic.
    # Bound: minimum-total-curtailment is preserved only while augmenting
    # paths traverse < 1/flow_eps = 1000 ties (a path of k ties adds
    # k*flow_eps to 1.0 per MW served), and the tiebreak perturbs the
    # reported per-area curtailment by O(flow_eps * flow) through the f32
    # IPM — both fine for the intended N <= 26-area systems (path length
    # <= N-1 << 1000; perturbation << the 0.01 MW reporting threshold at
    # demo tie scales). Scale flow_eps down if you ever exceed that.
    flow_eps = jnp.asarray(1e-3, dt)
    c = jnp.concatenate([jnp.full((2 * T,), flow_eps, dt),
                         jnp.ones((A_areas,), dt),
                         jnp.zeros((A_areas,), dt)])
    l = jnp.zeros((2 * T + 2 * A_areas,), dt)
    u = jnp.concatenate([tie_cap, tie_cap, curtail_cap,
                         jnp.full((A_areas,), big, dt)])
    return c, Amat, b, l, u


@partial(jax.jit, static_argnames=("policy", "ipm"))
def solve_curtailment(margins: jax.Array, tie_from: jax.Array,
                      tie_to: jax.Array, tie_cap: jax.Array,
                      policy: str = INTERCONNECTED,
                      ipm: IPMConfig = IPMConfig(iterations=20)) -> jax.Array:
    """Batched minimum curtailment [B, A] for per-area margins [B, A]."""
    from powersystemsreliabilityassessment.engines import lp_ipm_batched

    if policy == ISOLATED:
        return curtail_isolated(margins)
    T = tie_cap.shape[0]
    big = jnp.maximum(jnp.max(jnp.abs(margins)), 1.0) * 2.0
    c, Am, b, l, u = jax.vmap(lambda m: _build_interconnect_lp(
        m, tie_from, tie_to, tie_cap, big))(margins)
    sol = lp_ipm_batched.solve_box_lp_batched(c, Am, b, l, u, ipm)
    # Exact repair: with the LP's (near-optimal) tie flows fixed, the
    # per-area curtailment is the closed-form deficit of the netted
    # margins, removing the f32 interior-point gap.
    flows = jnp.einsum("bat,bt->ba", Am[:, :, : 2 * T], sol.x[:, : 2 * T])
    out = jnp.maximum(-(margins + flows), 0.0)
    # fast path: no deficit anywhere -> exactly zero
    any_deficit = jnp.any(margins < 0, axis=1, keepdims=True)
    return jnp.where(any_deficit, out, 0.0)


def _padded_fleet(sys: MultiAreaSystem):
    """Pad the ragged per-area fleets to [A, Gmax] arrays (cap 0 padding
    with huge MTTF contributes nothing to capacity or failures)."""
    A = sys.n_areas
    gmax = max(int(len(c)) for c in sys.gen_capacity)
    caps = np.zeros((A, gmax), np.float32)
    mttf = np.full((A, gmax), 1e9, np.float64)
    mttr = np.full((A, gmax), 1.0, np.float64)
    for a in range(A):
        g = len(sys.gen_capacity[a])
        caps[a, :g] = sys.gen_capacity[a]
        mttf[a, :g] = sys.gen_mttf[a]
        mttr[a, :g] = sys.gen_mttr[a]
    return caps, mttf, mttr


def make_multiarea_batch_step(sys: MultiAreaSystem, mesh,
                              years_per_device: int, policy: str,
                              ipm: IPMConfig):
    """Jitted shard_map step: one block of years per device, psum-reduced
    per-area (loss-hour count, curtailment sum, years) partials."""
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    from powersystemsreliabilityassessment.parallel import (
        mesh as meshlib)

    A = sys.n_areas
    H = sys.hourly_load.shape[1]
    caps, mttf, mttr = _padded_fleet(sys)
    n_draws = chronological.default_num_draws(
        mttf.reshape(-1), mttr.reshape(-1), H)
    gmax = caps.shape[1]
    # Device data enters the jitted step as ARGUMENTS, never closure
    # constants — captured device arrays execute all-constant expressions
    # eagerly at trace time (one device dispatch each) and are
    # fetched back to host one blocking transfer at a time at MLIR
    # lowering (the round-1 SEQ cold-start root cause; see
    # make_seq_batch_step).
    arrs = (jnp.asarray(caps.reshape(-1)),                  # [A*G]
            jnp.asarray(mttf.reshape(-1), jnp.float32),
            jnp.asarray(mttr.reshape(-1), jnp.float32),
            jnp.asarray(sys.hourly_load, jnp.float32),      # [A, H]
            jnp.asarray(sys.tie_from, jnp.int32),
            jnp.asarray(sys.tie_to, jnp.int32),
            jnp.asarray(sys.tie_cap, jnp.float32))

    def device_step(key, caps_d, mttf_d, mttr_d, load_d, tf, tt, tc):
        dev = jax.lax.axis_index(meshlib.SCENARIO_AXIS)
        keys = jax.random.split(jax.random.fold_in(key, dev),
                                years_per_device)
        down = jax.vmap(lambda kk: chronological.sample_timeline(
            kk, mttf_d, mttr_d, H, n_draws, quantize=False))(keys)
        avail = 1.0 - down.astype(jnp.float32)             # [Y, A*G, H]
        cap_series = jnp.einsum(
            "yagh,ag->yah", avail.reshape(-1, A, gmax, H),
            caps_d.reshape(A, gmax))                       # [Y, A, H]
        margins = jnp.swapaxes(cap_series, 1, 2) - load_d.T[None]  # [Y,H,A]
        curt = solve_curtailment(margins.reshape(-1, A), tf, tt, tc,
                                 policy, ipm)
        loss_h = jnp.sum(curt > 0, axis=0)                 # [A]
        eue_s = jnp.sum(curt, axis=0)                      # [A]
        ps = lambda a: jax.lax.psum(a, meshlib.SCENARIO_AXIS)
        return ps(loss_h), ps(eue_s)

    jstep = jax.jit(shard_map(
        device_step, mesh=mesh, in_specs=(P(),) * 8, out_specs=(P(), P()),
        check_vma=False))
    return lambda key: jstep(key, *arrs)


def run_multiarea_sequential(sys: MultiAreaSystem, policy: str,
                             n_years: int, seed: int = 0,
                             ipm: IPMConfig = IPMConfig(iterations=20),
                             mesh=None, years_per_device: int = 8):
    """Sequential multi-area simulation (AdequacyAssessmentII.jl:185-250).

    Chronological TTF/TTR sampling per unit, per-hour area margins, batched
    curtailment solve, per-area LOLE (h/yr) and EUE (MWh/yr).

    Years are sharded over the scenario mesh (every device simulates
    ``years_per_device`` years per step; partials are ``psum``-reduced)
    and the host loop walks year blocks, so device memory is
    O(years_per_device * H * A) regardless of ``n_years`` — the same
    scaling pattern as the HL2 studies.
    """
    from powersystemsreliabilityassessment.parallel import (
        mesh as meshlib)

    mesh = mesh or meshlib.scenario_mesh()
    n_dev = mesh.devices.size
    # Don't overshoot small requests: cap the per-device block so the
    # simulated total stays close to n_years (rounded up to fill the mesh).
    years_per_device = max(1, min(years_per_device, -(-n_years // n_dev)))
    years_per_batch = years_per_device * n_dev
    n_batches = max(1, -(-n_years // years_per_batch))
    step = make_multiarea_batch_step(sys, mesh, years_per_device, policy,
                                     ipm)
    key = jax.random.key(seed)
    A = sys.n_areas
    loss_h = np.zeros(A, np.float64)
    eue_s = np.zeros(A, np.float64)
    for b in range(n_batches):
        lh, es = step(jax.random.fold_in(key, b))
        loss_h += np.asarray(lh, np.float64)
        eue_s += np.asarray(es, np.float64)
    total_years = n_batches * years_per_batch
    return loss_h / total_years, eue_s / total_years
