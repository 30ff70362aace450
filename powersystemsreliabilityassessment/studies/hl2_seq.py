"""HL2 sequential (chronological) Monte Carlo study (the ``seqMain.m`` path).

Per batch of simulated years (years sharded over the mesh — hours within a
year stay on-chip; SURVEY.md §5.7):

1. sample per-component chronological timelines for the whole year with
   the vectorized next-event engine (replaces seq_mcsampling.m:44-75);
2. scale the RTS-79 hourly load profile (anloducurve.m) and certify every
   hour with the Tier-1 PTDF check — the reference's "contingency hours
   only" filter (seqMain.m:93-100) generalizes here to "hours the
   certificate cannot prove shed-free", which is strictly safer (it also
   catches N-0 congestion);
3. compact uncertified hours into a fixed-size LP buffer and evaluate;
4. reduce to the annual indices PLC / NLC (event counting, calnlc.m) /
   DLC / ENS / EDNS (seqMain.m:160-176) plus nodal and weak-point
   accumulators; CoV stopping on host (std/(mean*sqrt(N)) < 0.05,
   seqMain.m:178-198).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from powersystemsreliabilityassessment.core import load_profile
from powersystemsreliabilityassessment.core.cases import CaseData
from powersystemsreliabilityassessment.core.system import System, build_system
from powersystemsreliabilityassessment.engines import copper_sheet, dcopf
from powersystemsreliabilityassessment.models import twostate
from powersystemsreliabilityassessment.parallel import mesh as meshlib
from powersystemsreliabilityassessment.runtime.checkpoint import Checkpointer
from powersystemsreliabilityassessment.runtime.host_loop import double_buffered_loop
from powersystemsreliabilityassessment.sampling import chronological
from powersystemsreliabilityassessment.utils.config import (
    CompatFlags, IPMConfig, MCSConfig)


def _years_eval(sys: System, compat: CompatFlags, ipm: IPMConfig,
                factors: jax.Array, hours: int, n_draws: int, max_lp: int,
                maint_down: jax.Array | None, nodal_mode: str,
                keys: jax.Array, stationary: bool = False,
                cv_arrays: tuple[jax.Array, jax.Array] | None = None):
    """Evaluate a block of simulated years as ONE flat evaluation batch.

    Only the chronological sampling is vmapped (it is ~free with the
    compare-and-count construction); the two-tier evaluator then sees a
    single [years*hours] batch — vmapping the SCREENED evaluator per
    year lowers its nonzero/compaction/scatter steps far worse, while
    the flat batch is exactly the NSQ-shaped fast path. Annual
    indices are recovered by reshape. ``max_lp`` here is the TOTAL
    LP-lane buffer for the whole block.
    """
    Y = keys.shape[0]
    if stationary:
        # Stationary start + continuous dwells: every hour's marginal is
        # exactly Bernoulli(U) — required by the control-variate mode,
        # and removes the reference's all-up January transient.
        down = jax.vmap(lambda kk: chronological.sample_timeline_stationary(
            kk, sys.mttf, sys.mttr, hours, n_draws))(keys)
    else:
        down = jax.vmap(lambda kk: chronological.sample_timeline(
            kk, sys.mttf, sys.mttr, hours, n_draws))(keys)  # [Y, ncomp, H]
    down_h = jnp.swapaxes(down, 1, 2)                     # [Y, H, ncomp]
    if maint_down is not None:
        down_h = down_h | maint_down[None]
    load_h = factors[:, None] * sys.load_pd[None, :]      # [H, nd]

    # Compacted certificate repair: chronological outages cluster (one
    # long line repair can contribute ~800 consecutive needy hours), so
    # the buffer is sized batch//16 — far above the bursts observed —
    # rather than the NSQ policy's batch//64. Overflow only routes the
    # excess lanes to the LP buffer, which this study already grows
    # adaptively on overflow.
    res, n_over = dcopf.evaluate_states_screened(
        sys, down_h.reshape(Y * hours, -1),
        jnp.tile(load_h, (Y, 1)), max_lp, compat, ipm, nodal_mode,
        repair_buffer=max(4096, (Y * hours) // 16),
        pf_buffer=dcopf.default_pf_buffer(sys, Y * hours))

    dns = res.dns_mw.reshape(Y, hours)
    flag = dns > compat.seq_curtail_threshold_mw          # [Y, H]
    flag_f = flag.astype(dns.dtype)

    ens = jnp.sum(dns, axis=1)                            # [Y] MWh
    plc = jnp.mean(flag_f, axis=1)
    dlc = jnp.sum(flag_f, axis=1)
    nlc = copper_sheet.count_curtailment_events(flag).astype(dns.dtype)
    # Nodal EENS + weak-point accumulators over loss hours
    nodal_yh = res.nodal_mw.reshape(Y, hours, -1)
    nodal = jnp.sum(jnp.where(flag[:, :, None], nodal_yh, 0.0), axis=1)
    comp_fail = jnp.einsum("yh,yhc->yc", flag_f,
                           down_h.astype(dns.dtype))      # [Y, ncomp]
    loss_hours = dlc
    outs = (ens, plc, nlc, dlc, ens / hours,
            nodal, comp_fail, loss_hours, n_over,
            jnp.sum(res.infeasible))
    if cv_arrays is not None:
        # Copper-sheet control variates, in MW so the analytical means
        # (copt.copper_cv_means) see bit-identical load values: loads_mw
        # is the f32-rounded hourly system load, gen_cap_mw the integer
        # unit capacities (integer-valued f32 => the einsum capacity sum
        # is exact; matmul precision is "highest" package-wide).
        loads_mw, gen_cap_mw = cv_arrays
        gen_up = 1.0 - down[:, :sys.n_gen, :].astype(dns.dtype)
        cap_mw = jnp.einsum("ygh,g->yh", gen_up, gen_cap_mw)
        deficit = jnp.maximum(loads_mw[None, :] - cap_mw, 0.0)  # [Y, H]
        c_ens = jnp.sum(deficit, axis=1)
        c_dlc = jnp.sum(
            (deficit > compat.seq_curtail_threshold_mw).astype(dns.dtype),
            axis=1)
        outs = outs + (c_ens, c_dlc)
    return outs


def make_seq_batch_step(sys: System, mesh: Mesh, years_per_device: int,
                        compat: CompatFlags, ipm: IPMConfig,
                        hours: int, n_draws: int, max_lp: int,
                        factors: np.ndarray,
                        maint_down: np.ndarray | None = None,
                        nodal_mode: str = "lp",
                        stationary: bool = False,
                        cv_arrays: tuple[np.ndarray, np.ndarray]
                        | None = None):
    # The System pytree and load-profile vector enter the jitted step as
    # ARGUMENTS, not closure constants. Closing over device-resident
    # arrays is the root cause of the round-1 SEQ cold-start blowup:
    # every all-constant expression on them executes EAGERLY at trace time (one
    # device dispatch + compile each), and MLIR lowering then fetches every
    # captured device array back to host one blocking device-to-host transfer
    # at a time. As tracers they cost nothing at trace time, and the few
    # leftover static constants are built with numpy (host-embedded).
    fac = jnp.asarray(factors, np.float32)
    md = None if maint_down is None else jnp.asarray(maint_down)
    cv = cv_arrays is not None
    n_md = 0 if md is None else 1

    def device_step(dev_key, sys, fac, *rest):
        md_arg = rest[0] if n_md else None
        cva = rest[n_md:n_md + 2] if cv else None
        # dev_key[0] is this device's fold_in(key, dev).
        keys = jax.random.split(dev_key[0], years_per_device)
        outs = _years_eval(sys, compat, ipm, fac, hours, n_draws,
                           max_lp * years_per_device,
                           md_arg, nodal_mode, keys,
                           stationary=stationary, cv_arrays=cva)
        # Per-year vectors are gathered (all years visible on all hosts);
        # scalar accumulators are psum-reduced.
        (ens, plc, nlc, dlc, edns, nodal, comp_fail, loss_h, n_over,
         n_infeas), cv_outs = outs[:10], outs[10:]
        gather = lambda a: jax.lax.all_gather(
            a, meshlib.SCENARIO_AXIS, tiled=True)
        return (gather(ens), gather(plc), gather(nlc), gather(dlc),
                gather(edns),
                jax.lax.psum(jnp.sum(nodal, 0), meshlib.SCENARIO_AXIS),
                jax.lax.psum(jnp.sum(comp_fail, 0), meshlib.SCENARIO_AXIS),
                jax.lax.psum(jnp.sum(loss_h), meshlib.SCENARIO_AXIS),
                jax.lax.psum(jnp.sum(n_over), meshlib.SCENARIO_AXIS),
                jax.lax.psum(jnp.sum(n_infeas), meshlib.SCENARIO_AXIS),
                ) + tuple(gather(a) for a in cv_outs)

    n_in = 3 + n_md + (2 if cv else 0)
    n_out = 10 + (2 if cv else 0)
    sharded = shard_map(
        device_step, mesh=mesh,
        in_specs=(P(meshlib.SCENARIO_AXIS),) + (P(),) * (n_in - 1),
        out_specs=(P(),) * n_out,
        check_vma=False,
    )
    n_dev = mesh.devices.size
    jstep = jax.jit(lambda key, *a: sharded(
        meshlib.device_keys(key, n_dev), *a))
    jkeys = jax.jit(sharded)
    extra = (sys, fac) + (() if md is None else (md,))
    if cv:
        extra = extra + (jnp.asarray(cv_arrays[0], np.float32),
                         jnp.asarray(cv_arrays[1], np.float32))
    step = lambda key: jstep(key, *extra)
    # from_keys([n_dev] per-device keys): see make_nsq_batch_step.
    step.from_keys = lambda keys: jkeys(keys, *extra)
    return step


@dataclasses.dataclass
class SEQResult:
    eens_mwh_yr: float
    lole_hr_yr: float       # mean DLC (seqMain.m:212)
    lolf_occ_yr: float      # mean NLC (seqMain.m:213)
    plc: float
    edns_mw: float
    cov: float
    years: int
    converged: bool
    nodal_eens_mwh_yr: np.ndarray
    comp_importance: np.ndarray
    eens_history: list
    cov_history: list
    overflow_hours: int
    annual_ens: list = dataclasses.field(default_factory=list)
    # Hours with no feasible dispatch (enforce_pmin only); the reference's
    # try/catch silently records zero for these (seqMain.m:117-126).
    infeasible_hours: int = 0
    # Multilevel-splitting diagnostics (studies/hl2_seq_split.py only):
    # parent years that entered the splitting level, and entering parents
    # beyond the per-batch clone budget (kept their plain estimate).
    split_entered: int = 0
    split_overflow: int = 0

    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["nodal_eens_mwh_yr"] = self.nodal_eens_mwh_yr.tolist()
        d["comp_importance"] = self.comp_importance.tolist()
        return d


def seq_lp_cap(m: int, hours: int, years_per_device: int) -> int:
    """Per-year LP-buffer ceiling for the chronological study.

    Small-m systems (dense factor range, m <= 336) may grow to the full
    year — their factor temporaries are [lanes, m <= 336] class, far
    from any device's memory. At case300 scale (m = 792, block-Schur +
    dense-rescue temporaries) the cap is ~4096/Y TOTAL lanes per
    year-block, i.e. 4096/Y^2 per year: sized for a 16 GB device (2048
    total lanes fit at Y=2, not at Y=4) and not re-derived for this one
    yet (ROADMAP D6). It bounds the work and fixes compiled shapes.
    run_seq_study clamps both the initial buffer and the
    overflow growth here; hours past the cap degrade to certified
    deficit bounds and are counted (never the reference's silent
    zeros, seqMain.m:117-126)."""
    if m <= 336:
        return hours
    return min(hours, max(128, 4096 // (years_per_device *
                                        years_per_device)))


def run_seq_study(case: CaseData, cfg: MCSConfig = MCSConfig(),
                  compat: CompatFlags = CompatFlags(),
                  ipm: IPMConfig = IPMConfig(),
                  mesh: Mesh | None = None,
                  # Block-size tradeoff: bigger blocks cut the number of
                  # dispatches, but one-time trace+lower+compile grows
                  # with the program. Not measured on the GPU yet; raise
                  # --years-per-device for multi-10k-year runs where the
                  # dispatch count dominates.
                  years_per_device: int = 16,
                  max_lp: int = 256,
                  hours: int | None = None,
                  scheduled_maintenance: bool = False,
                  checkpointer: Checkpointer | None = None,
                  checkpoint_every: int = 20,
                  log_every: int = 5,
                  sampling: str = "reference",
                  control_variate: bool = False,
                  load_scale: float = 1.0) -> SEQResult:
    """See module docstring. Beyond the reference path:

    ``sampling="stationary"`` starts each year from the stationary
    component distribution with continuous dwells (no all-up January
    transient; chronological.sample_timeline_stationary).
    ``control_variate=True`` (implies stationary sampling) subtracts the
    copper-sheet deficit from each year's indices and adds back its
    EXACT stationary expectation from a float64 COPT
    (copt.copper_cv_means): EENS_cv = mu_C + mean(ENS - C). Unbiased by
    construction; the network-free copper deficit explains most of the
    ENS variance, so the residual variance is far smaller. The reference
    has no counterpart (its SEQ loop is plain MC, seqMain.m:85-199).
    """
    from powersystemsreliabilityassessment.parallel.accumulators import AnnualStats

    if control_variate and sampling == "reference":
        sampling = "stationary"
    if sampling not in ("reference", "stationary"):
        raise ValueError(f"unknown sampling mode {sampling!r}")
    if control_variate and scheduled_maintenance:
        raise ValueError("control_variate requires a stationary fleet; "
                         "scheduled maintenance breaks stationarity")
    stationary = sampling == "stationary"

    sys = build_system(case, compat)
    if log_every:
        # Intact-system sanity line (the reference's pre-loop runopf,
        # nsqMain.m:188-198 — host-side f64 analog, no compile cost).
        dcopf.print_baseline(sys)
    mesh = mesh or meshlib.scenario_mesh()
    hours = hours or compat.hours_per_year_seq
    factors = load_profile.load_factors(hours, compat.weekday_mode)
    if load_scale != 1.0:
        factors = factors * load_scale
    n_draws = chronological.default_num_draws(
        twostate.mean_times(case)[:, 0], twostate.mean_times(case)[:, 1],
        hours)

    cv_arrays, mu_eens, mu_lole = None, 0.0, 0.0
    if control_variate:
        from powersystemsreliabilityassessment.engines import copt
        gen_cap_mw = np.asarray(case.gen_pmax, np.float32)
        total_load_mw = float(np.sum(np.asarray(case.bus_pd, np.float64)))
        # f32-round the hourly loads BEFORE computing the analytical
        # means so host and device see bit-identical load values.
        loads_mw = (np.asarray(factors, np.float64)
                    * total_load_mw).astype(np.float32)
        q_gen = twostate.unavailability(case)[:case.n_gen]
        mu_eens, mu_lole, _, _ = copt.copper_cv_means(
            gen_cap_mw.astype(np.float64), q_gen,
            loads_mw.astype(np.float64),
            thresh_mw=compat.seq_curtail_threshold_mw)
        cv_arrays = (loads_mw, gen_cap_mw)
        if log_every:
            print(f"control variate: mu_EENS {mu_eens:.3f} MWh/yr, "
                  f"mu_LOLE {mu_lole:.4f} h/yr (exact f64 COPT)")

    maint_down = None
    if scheduled_maintenance:
        # Levelized maintenance schedule from the genweeks data
        # (case24_failrate.m:48-56 — unused by the reference's committed
        # SEQ code, available here as an explicit option).
        from powersystemsreliabilityassessment.engines import planning
        from powersystemsreliabilityassessment.engines.planning import (
            PlanningFleet)
        fleet = PlanningFleet(
            names=[f"G{i+1}" for i in range(case.n_gen)],
            capacity=case.gen_pmax.astype(float),
            for_rate=np.zeros(case.n_gen),
            maint_weeks=np.round(case.gen_maint_weeks).astype(int),
            energy_limit=np.full(case.n_gen, np.inf))
        # Schedule against the full 52-week profile even when simulating a
        # truncated horizon (tests).
        planning.schedule_maintenance(
            fleet, load_profile.weekly_peaks(
                load_profile.load_factors(52 * 168, compat.weekday_mode)))
        wk_mask = planning.maintenance_mask(fleet)        # [52, ng]
        week_of_hour = np.minimum(np.arange(hours) // 168, 51)
        maint_down = np.zeros((hours, case.n_comp), bool)
        maint_down[:, :case.n_gen] = wk_mask[week_of_hour]

    # Memory cap for the LP buffer (large-m only; see seq_lp_cap).
    # Chronological outages cluster — one long critical-line repair put
    # 890 uncertified hours in a single 2-year case300s block
    # (results/case300_seq_results.json) — and the grow-and-redo loop
    # would otherwise double max_lp without bound. Past the cap,
    # overflow hours degrade to their CERTIFIED deficit bounds and stay
    # counted in ``overflow_hours`` — an explicit lower-bound
    # degradation, unlike the reference's silent zeros on its failed
    # hours (seqMain.m:117-126). Small-m systems keep the full
    # ``hours`` ceiling.
    lp_cap = seq_lp_cap(sys.n_bus + sys.n_branch, hours, years_per_device)
    if max_lp > lp_cap:
        print(f"max_lp {max_lp}/yr exceeds the large-m memory cap; "
              f"clamping to {lp_cap}/yr (years_per_device="
              f"{years_per_device})")
        max_lp = lp_cap

    step = make_seq_batch_step(sys, mesh, years_per_device, compat, ipm,
                               hours, n_draws, max_lp, factors, maint_down,
                               nodal_mode=cfg.nodal_mode,
                               stationary=stationary, cv_arrays=cv_arrays)
    root = jax.random.key(cfg.seed)

    stats = AnnualStats()
    cov_history, eens_history = [], []
    batch_idx, overflow, infeasible = 0, 0, 0

    if checkpointer is not None:
        restored = checkpointer.restore()
        if restored is not None:
            stats = AnnualStats.from_state(restored["stats"])
            cov_history = restored["cov_history"]
            eens_history = restored["eens_history"]
            batch_idx = int(restored["batch_idx"])
            overflow = int(restored.get("overflow", 0))
            infeasible = int(restored.get("infeasible", 0))

    years_per_batch = years_per_device * mesh.devices.size

    # Transient grow-and-redo (round 5). Chronological outages CLUSTER:
    # one long critical-line repair put 890 uncertified hours in a
    # single 2-year case300s block while every other block fit the
    # base buffer — and a permanently-grown buffer taxes every later
    # batch (the 256-year case300s artifact run spent most of its wall
    # paying for ONE cluster batch). So overflowed batches
    # are redone through a TRANSIENT big-buffer step (per-size compiled
    # cache) while the steady-state path keeps the base buffer; keys
    # are batch-index-deterministic, so the redo is exact and the
    # estimate is invariant to buffer sizes (test_seq_adaptive_lp_
    # buffer). Batches whose need exceeds lp_cap (the memory cap)
    # degrade their residual overflow hours to certified deficit
    # bounds, counted in overflow_hours — never the reference's silent
    # zeros (seqMain.m:117-126). NSQ keeps permanent growth: its
    # batches are iid, so one overflow predicts more.
    import collections
    inflight = collections.deque()
    redo_lp: dict[int, int] = {}     # batch_idx -> transient buffer size
    big_steps: dict[int, Any] = {}   # buffer size -> compiled step
    cap_warned = False

    def step_for(i: int):
        lp = redo_lp.get(i)
        if lp is None:
            return step
        if lp not in big_steps:
            big_steps[lp] = make_seq_batch_step(
                sys, mesh, years_per_device, compat, ipm, hours, n_draws,
                lp, factors, maint_down, nodal_mode=cfg.nodal_mode,
                stationary=stationary, cv_arrays=cv_arrays)
        return big_steps[lp]

    def dispatch(i: int):
        inflight.append(i)
        return step_for(i)(jax.random.fold_in(root, i))

    consec_over = 0

    def consume(out, next_idx) -> bool:
        nonlocal overflow, infeasible, cap_warned, consec_over, step, max_lp
        idx = inflight.popleft()
        (ens, plc, nlc, dlc, edns, nodal, comp_fail, loss_h, n_over,
         n_infeas) = out[:10]
        if int(n_over) > 0:
            lp_used = redo_lp.get(idx, max_lp)
            if lp_used < lp_cap:
                redo_lp[idx] = min(2 * lp_used, lp_cap)
                print(f"LP buffer overflow ({int(n_over)} h); redoing "
                      f"batch {idx} with a transient {redo_lp[idx]}/yr "
                      "buffer")
                # The loop discards the batch it dispatched just before
                # this consume (it will re-dispatch it after the redo) —
                # drop its in-flight entry so the FIFO stays aligned.
                # In the drain phase nothing else is in flight.
                if inflight:
                    inflight.pop()
                return True
            if not cap_warned:
                cap_warned = True
                print(f"LP buffer at its memory cap ({lp_used}/yr x "
                      f"{years_per_device}); {int(n_over)} overflow "
                      "hours degrade to certified deficit bounds "
                      "(counted in overflow_hours)")
        else:
            if idx in redo_lp:
                # The redo succeeded at this size. Clustering makes
                # this usually a one-off; but if several consecutive
                # batches all needed it, the BASE buffer is undersized
                # (not a cluster) and transient redo would double every
                # dispatch — promote the size permanently.
                consec_over += 1
                if consec_over >= 3 and redo_lp[idx] > max_lp:
                    max_lp = redo_lp[idx]
                    step = step_for(idx)
                    print(f"3 consecutive overflow redos; promoting "
                          f"max_lp {max_lp}/yr to the base step")
                redo_lp.pop(idx, None)
            else:
                consec_over = 0
        if control_variate:
            # Adjusted per-year values Y_i = ENS_i - C_i + mu_C (f64 on
            # host). E[C_i] = mu_C exactly under stationary sampling, so
            # the estimator mean is untouched while the copper deficit's
            # variance is removed. NLC/nodal/weak-point stay plain
            # (unbiased; no copper counterpart with an exact mean).
            c_ens = np.asarray(out[10], np.float64)
            c_dlc = np.asarray(out[11], np.float64)
            ens = np.asarray(ens, np.float64) - c_ens + mu_eens
            dlc = np.asarray(dlc, np.float64) - c_dlc + mu_lole
            plc = dlc / hours
            edns = ens / hours
        stats.update_years(ens, plc, nlc, dlc, edns, nodal, comp_fail,
                           float(loss_h))
        overflow += int(n_over)
        infeasible += int(n_infeas)
        eens_history.append(stats.eens)
        cov_history.append(stats.cov)
        n_batches = len(eens_history)
        if log_every and n_batches % log_every == 0:
            print(f"year {stats.years:5d} | EENS {stats.eens:9.2f} MWh/yr "
                  f"| CoV {stats.cov:.4f}")
        if checkpointer is not None and n_batches % checkpoint_every == 0:
            checkpointer.save({
                "stats": dataclasses.asdict(stats),
                "cov_history": cov_history,
                "eens_history": eens_history,
                "batch_idx": next_idx, "overflow": overflow,
                "infeasible": infeasible})
        return False

    double_buffered_loop(
        dispatch=dispatch,
        consume=consume,
        should_continue=lambda i: (i * years_per_batch < cfg.max_years
                                   and stats.cov > cfg.cov_threshold),
        start_idx=batch_idx)

    return SEQResult(
        eens_mwh_yr=stats.eens,
        lole_hr_yr=float(np.mean(stats.dlc)) if stats.dlc else 0.0,
        lolf_occ_yr=float(np.mean(stats.nlc)) if stats.nlc else 0.0,
        plc=float(np.mean(stats.plc)) if stats.plc else 0.0,
        edns_mw=float(np.mean(stats.dns)) if stats.dns else 0.0,
        cov=stats.cov,
        years=stats.years,
        converged=stats.cov <= cfg.cov_threshold,
        nodal_eens_mwh_yr=stats.nodal_eens(),
        comp_importance=stats.component_importance(),
        eens_history=eens_history,
        cov_history=cov_history,
        overflow_hours=overflow,
        annual_ens=list(stats.ens),
        infeasible_hours=infeasible,
    )
