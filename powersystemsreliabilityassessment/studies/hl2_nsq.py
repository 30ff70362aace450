"""HL2 non-sequential Monte Carlo study (the ``nsqMain.m`` path).

Pipeline per batch (all on device, scenarios sharded over the mesh):
sample Bernoulli component states at FIXED PEAK LOAD (the reference
evaluates the peak-load snapshot only — nsqMain.m has no load profile,
hence its large LOLE; SURVEY.md §6 consistency note) -> two-tier DC-OPF
evaluation -> index partial sums ``psum``-reduced over the scenario axis.
The host folds batch partials into float64 running statistics, applies the
beta stopping rule (beta < 0.0017 or max samples, nsqMain.m:60-61), and
checkpoints for preemption recovery.

The reference's unique-state dedup database (nsqMain.m:219-245) is
intentionally dropped: dense re-evaluation on the device beats host-side
dedup and is identical in expectation.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from powersystemsreliabilityassessment.core.cases import CaseData
from powersystemsreliabilityassessment.core.system import System, build_system
from powersystemsreliabilityassessment.engines import dcopf
from powersystemsreliabilityassessment.parallel import accumulators, mesh as meshlib
from powersystemsreliabilityassessment.runtime.checkpoint import Checkpointer
from powersystemsreliabilityassessment.runtime.host_loop import double_buffered_loop
from powersystemsreliabilityassessment.utils.config import (
    CompatFlags, IPMConfig, MCSConfig)


def default_max_lp(batch_per_device: int, nodal_mode: str = "lp",
                   is_boost: float = 0.0,
                   is_boost_scope: str = "all",
                   pf_tier: bool = False) -> int:
    """Default LP-lane buffer per device batch.

    The IPM solves every buffer lane (padding included), so the buffer
    should track the actual LP need, with overflow self-correcting via
    the study's grow-and-redo loop:
    - "lp" nodal mode sends every positive-deficit state to the LP
      (~10% of RTS-24 peak states): 25% buffer.
    - "proportional" mode LP-solves only certificate-failing states
      (~0.044% at RTS-24 peak since the post-outage repair extension):
      1.56% buffer is ~35x the need — generous for harder cases/loads —
      and the grow-and-redo loop still self-corrects if a case exceeds
      it. A buffer far above the need is pure overhead.
    - Importance sampling with the all-component scope boosts the
      multi-BRANCH-outage rate, i.e. certificate-ineligible lanes: 50%
      buffer. The gens-only scope leaves branch rates (and hence the
      certificate miss rate) at plain-MC levels, so in "proportional"
      mode the unboosted default applies; "lp" mode routes every
      DEFICIT state to the LP and gens boost inflates exactly those
      (measured: boost 2.5 on RTS-24 lifts the deficit fraction ~9% ->
      ~44%), so it needs the 50% buffer too. The study's grow-and-redo
      loop self-corrects either way.
    """
    if is_boost > 1.0 and (is_boost_scope in ("all", "branches")
                           or nodal_mode == "lp"):
        frac = 2
    elif nodal_mode == "proportional":
        frac = 64
    else:
        frac = 4
    lanes = max(batch_per_device // frac, 16)
    if pf_tier:
        # Large-m memory cap: the IPM temporaries of a [lanes, m~800]
        # buffer grow with the lane count (a 4096-lane buffer needs
        # ~16 GB). The 2048 cap bounds the work and fixes the compiled
        # shape; it was sized for a 16 GB device and is not re-derived
        # for this one yet (chip_smoke.py's large_m phase prints the
        # real footprint; ROADMAP D6). Boosted regimes that genuinely
        # need more lanes per sample should lower the batch instead.
        lanes = min(lanes, 2048)
    if pf_tier and nodal_mode == "proportional" and is_boost <= 1.0:
        # Island-PF tier active (large-m systems): tier-2 misses are
        # ~0.1% of lanes (8.6/8192 at case300s, results/r4_miss.json),
        # and the block-Schur LP pass scales ~linearly in buffer lanes.
        # 128 covers batches through ~65k at that miss rate;
        # grow-and-redo remains the safety net.
        lanes = min(lanes, 128)
    return lanes


def default_woodbury_k(sys: System, is_boost: float = 0.0,
                       is_boost_scope: str = "all",
                       q_vec: np.ndarray | None = None) -> int:
    """Auto certificate rank: 2 unless >= 3 simultaneous branch outages
    are non-negligible UNDER THE SAMPLING MEASURE (boost included when
    its scope covers branches; ``q_vec`` supplies the CE-adaptive
    per-component proposal directly), then 4.

    Poisson bound on the branch-outage count N with rate
    lam = sum_k q_k: P(N >= 3) <= 1 - e^-lam (1 + lam + lam^2/2).
    RTS-24 (lam ~ 0.015) gives ~6e-7 -> rank 2 (the extra rank-4
    selector matmuls are pure cost there); case300s (lam ~ 0.69) gives
    ~3.3e-2 -> rank 4 (matches the measured n_out histogram,
    results/case300_cert_breakdown.json)."""
    if q_vec is not None:
        q = np.asarray(q_vec, np.float64)[sys.n_gen:]
    else:
        q = np.asarray(sys.unavail, np.float64)[sys.n_gen:]
        if is_boost > 1.0 and is_boost_scope in ("all", "branches"):
            q = np.minimum(is_boost * q, 0.5)
    lam = float(q.sum())
    p_ge3 = 1.0 - np.exp(-lam) * (1.0 + lam + lam * lam / 2.0)
    return 2 if p_ge3 < 1e-4 else 4


def gen_area_masks(case: CaseData) -> np.ndarray | None:
    """[K, n_comp] bool masks: one row per area's GENERATORS.

    The grouping for :func:`sampling.state.sample_states_mixture` in
    composition-anomaly regimes (case300s: every deficit event is a
    normal-count outage draw whose generator outages concentrate in one
    area past the ring import — results/case300_events.json). Requires
    ``case.bus_area``; returns None when absent or single-area.
    """
    if case.bus_area is None:
        return None
    areas = np.unique(case.bus_area)
    if areas.size < 2:
        return None
    gen_area = np.asarray(case.bus_area)[np.asarray(case.gen_bus)]
    masks = np.zeros((areas.size, case.n_comp), bool)
    for i, a in enumerate(areas):
        masks[i, :case.n_gen] = gen_area == a
    return masks[masks.any(axis=1)]


def calibrate_ce_proposal(sys: System, compat: CompatFlags,
                          ipm: IPMConfig,
                          batch: int = 32768, rounds: int = 2,
                          boost0: float = 4.0, smoothing: float = 0.7,
                          seed: int = 1717,
                          shed_hint: np.ndarray | None = None,
                          log_every: int = 1):
    """Cross-entropy calibration of the NETWORK-AWARE importance
    proposal: per-component rates q_k, learned from pilot batches.

    The CE-optimal product-form proposal for estimating E[f] (f = DNS)
    has marginals q_k* = E_p[f(S) 1(S_k down)] / E_p[f(S)] — estimated
    here self-normalized under the current proposal (both expectations
    as w-weighted pilot means, so any proposal gives a consistent
    estimate). The pilot starts from a uniform BRANCH tilt (boost0) to
    see enough events, then each round replaces it with the learned
    marginals (smoothed); two rounds suffice to concentrate the tilt on
    the deliverability-critical branches that actually co-occur with
    deficits — exactly the information the uniform boost lacks
    (case300s pilot: uniform boost 2 made beta WORSE,
    results/case300_scaleup_pilot.json, because the tilt spends KL
    budget on ~480 branches that never matter).

    Correctness is decoupled from calibration quality: the returned q
    only defines a proposal; the study's likelihood ratios are exact
    for ANY q (clamped to [U, 0.5]), so a bad pilot costs variance,
    never bias. Returns (q [n_comp] f32, diagnostics dict), or
    (None, diag) when no pilot round saw a deficit event (caller keeps
    its configured sampler).

    The reference has no rare-event machinery at all (plain MC,
    mc_sampling.m); this replaces hand-tuned boost scopes with a
    measured, system-specific tilt."""
    from powersystemsreliabilityassessment.sampling.state import (
        sample_states_importance)

    ng = sys.n_gen
    U = np.asarray(sys.unavail, np.float64)
    always = np.asarray(sys.always_up_nsq)
    q = U.copy()
    q[ng:] = np.minimum(boost0 * np.maximum(U[ng:], 1e-9), 0.5)
    q = np.where(always, 0.0, q)

    # Chunked pilot dispatches: the pilot batch is a STATISTICAL size,
    # not a device-buffer size — a single 32768-lane dispatch with a
    # batch//4 LP buffer wants [8192-lane, m=792] IPM temporaries
    # (37.3 GB by the compiler's estimate). Each chunk caps the LP buffer
    # at 1024; an overflow only degrades the overflowed PILOT lanes to
    # their certified bounds (slightly blunting the learned tilt, never
    # biasing the study — final-estimator weights are exact for any q).
    chunk = min(batch, 8192)
    n_chunks = (batch + chunk - 1) // chunk
    load = jnp.broadcast_to(sys.load_pd[None, :], (chunk, sys.n_load))
    hint_j = None if shed_hint is None else jnp.asarray(shed_hint,
                                                        jnp.float32)
    max_lp = min(chunk, 1024)
    wk = default_woodbury_k(sys, q_vec=q)

    @jax.jit
    def pilot(key, qv):
        down, w = sample_states_importance(
            key, sys.unavail, sys.always_up_nsq, chunk, 0.0,
            q_override=qv)
        res, n_over = dcopf.evaluate_states_screened(
            sys, down, load, max_lp, compat, ipm, "proportional",
            repair_buffer=None, woodbury_k=wk, shed_hint=hint_j,
            pf_buffer=dcopf.default_pf_buffer(sys, chunk))
        f = res.dns_mw
        wf = w * f
        x = down.astype(f.dtype)
        return (wf @ x, jnp.sum(wf), jnp.sum(wf * wf),
                jnp.sum((f > 0)), n_over)

    # The pilot actually draws n_chunks * chunk samples (>= batch when
    # batch is not a chunk multiple); the rvar diagnostic must use the
    # real count or the CE descent metric is biased (advisor r4).
    n_total = n_chunks * chunk
    diag = {"rounds": [], "batch": batch, "n_pilot": n_total,
            "boost0": boost0, "chunk": chunk}
    for r in range(rounds):
        qv = jnp.asarray(q, jnp.float32)
        acc = [np.zeros(sys.n_comp), 0.0, 0.0, 0.0, 0.0]
        for j in range(n_chunks):
            key = jax.random.fold_in(
                jax.random.fold_in(jax.random.key(seed), r), j)
            for i, v in enumerate(pilot(key, qv)):
                acc[i] = acc[i] + np.asarray(v, np.float64)
        swfx, swf, swf2, n_events, n_over = acc
        # Relative variance of the wf estimator under the current
        # proposal (the quantity CE descends).
        rvar = float(n_total * swf2 / max(swf * swf, 1e-30) - 1.0)
        diag["rounds"].append({
            "round": r, "events": int(n_events),
            "overflow": int(n_over), "rel_var_wf": round(rvar, 3),
            "sum_q_branches": round(float(q[ng:].sum()), 4)})
        if log_every:
            print(f"CE round {r}: {int(n_events)} deficit events, "
                  f"rel-var(wf) {rvar:.1f}, sum q_br "
                  f"{q[ng:].sum():.3f}, overflow {int(n_over)}")
        if swf <= 0.0 or n_events < 8:
            return None, diag
        q_ce = np.clip(swfx / swf, 0.0, 1.0)
        q = smoothing * q_ce + (1.0 - smoothing) * q
        q = np.clip(q, U, 0.5)
        q = np.where(always, 0.0, q)
    return q.astype(np.float32), diag


def sparsify_ce_proposal(q: np.ndarray, sys: System,
                         top_k: int = 8, q_cap: float = 0.05,
                         branches_only: bool = True) -> np.ndarray:
    """Sparsify a CE-learned tilt to its top-k components, capped.

    Why (round-5 measurement, results/ce_ab.json): the DENSE CE
    proposal fails catastrophically on case300s — per-sample rel-var
    85,674 vs plain MC's 4,357 (20x WORSE) — because network-driven
    deficits are concentrated co-occurrence events and a product-form
    tilt spread over ~480 branches degenerates the likelihood weights
    (the pilot's own rel-var already rose between rounds), while the
    broad rate inflation destroys the tier-1/1.5 certificate closure
    (14k LP overflows).

    The fix keeps the tilt only where it provably pays: the top-k
    components by learned-marginal-to-true-rate ratio q_hat/U (the CE
    marginal q_hat_k = P_f(S_k down) IS the f-weighted down
    probability, so the ratio ranks components by how over-represented
    they are in deficit mass), capped at ``q_cap`` and floored at U
    everywhere else. With q >= U everywhere and sum_k (q_k - U_k)
    <= k * q_cap small, every likelihood weight is bounded:
    w <= prod_k (1-U_k)/(1-q_k) <= exp(sum q_k) ~ 1 + k*q_cap — weight
    degeneracy is impossible by construction, and the off-tilt state
    distribution (hence certificate closure and throughput) is nearly
    unchanged. This is the 'per-cutset deliverability tilt' resolved to
    its measurable core: the learned marginals locate the critical
    cutset branches; the cap keeps the proposal inside the
    bounded-weight regime.

    Unbiasedness is unaffected (exact likelihood ratios for any q).
    """
    ng = sys.n_gen
    U = np.asarray(sys.unavail, np.float64)
    always = np.asarray(sys.always_up_nsq)
    ratio = np.asarray(q, np.float64) / np.maximum(U, 1e-9)
    if branches_only:
        ratio[:ng] = 0.0
    ratio[always] = 0.0
    keep = np.argsort(ratio)[::-1][:top_k]
    out = U.copy()
    # max(U, min(q_hat, cap)): capped up-tilt, never below the true
    # rate (a clip with inverted bounds would sneak a down-tilt in).
    out[keep] = np.maximum(U[keep],
                           np.minimum(np.asarray(q, np.float64)[keep],
                                      q_cap))
    out[always] = 0.0
    return out.astype(np.float32)


def make_nsq_batch_step(sys: System, mesh: Mesh, batch_per_device: int,
                        compat: CompatFlags, ipm: IPMConfig,
                        max_lp: int | None = None, antithetic: bool = False,
                        nodal_mode: str = "lp", is_boost: float = 0.0,
                        cv_arrays: tuple | None = None,
                        enum_order: int = 0,
                        is_boost_scope: str = "all",
                        woodbury_k: int | None = None,
                        shed_hint: np.ndarray | None = None,
                        is_q: np.ndarray | None = None,
                        mix: tuple | None = None):
    """Build the jitted, mesh-sharded one-batch step: key -> BatchMoments.

    ``cv_arrays = (gen_cap_mw [ng] f32, total_load_mw, mu_e, mu_l)``
    enables the copper-sheet control variate (see run_nsq_study).

    ``enum_order > 0`` masks every sampled state with <= enum_order
    outages out of the moments: those states' contributions are carried
    EXACTLY by the enumeration pre-pass (sampling/enumeration.py) via
    the RunningStats ``mu_*`` offsets, so the MC estimates only the
    deep-tail term E[f(S) * 1(#down > enum_order)].
    """
    from powersystemsreliabilityassessment.sampling.state import (
        sample_states, sample_states_importance)

    assert not (antithetic and (is_boost > 0 or is_q is not None)), \
        "antithetic and importance sampling are mutually exclusive"
    assert not (enum_order > 0 and cv_arrays is not None), \
        "enumeration hybrid and control variate both carry exact-mean " \
        "offsets; combine is not supported"
    assert not (is_q is not None and is_boost > 0), \
        "is_q (CE proposal) replaces is_boost"
    assert mix is None or (is_boost == 0 and is_q is None
                           and not antithetic and enum_order == 0), \
        "mix (defensive mixture IS) excludes every other sampler mode"
    if max_lp is None:
        if is_q is not None:
            # CE tilt concentrates on few components, so the deficit /
            # deep-outage fraction rises far less than under a uniform
            # branch boost; batch//8 covers the measured need at
            # case300s with grow-and-redo as the safety net.
            max_lp = max(batch_per_device // 8, 16)
        elif mix is not None:
            # Mixture IS oversamples deficit events ~alpha_g*boost^j;
            # measured need at case300s (boost 2-3) is a few percent of
            # lanes. batch//16 + the memory cap, grow-and-redo as the
            # net.
            max_lp = min(max(batch_per_device // 16, 128), 2048)
        else:
            max_lp = default_max_lp(
                batch_per_device, nodal_mode, is_boost, is_boost_scope,
                pf_tier=dcopf.default_pf_buffer(
                    sys, batch_per_device) is not None)
    if woodbury_k is None:
        woodbury_k = default_woodbury_k(sys, is_boost, is_boost_scope,
                                        q_vec=is_q)
    if not 2 <= woodbury_k <= 4:
        # The unrolled Laplace/Cramer kernels in dcopf have factorial
        # cost in k, and the f32 conditioning + 1e-5 det threshold of
        # the Woodbury certificate are only characterized for k <= 4.
        raise ValueError(f"woodbury_k must be in [2, 4], got {woodbury_k}")
    if is_boost_scope not in ("all", "gens", "branches"):
        raise ValueError(f"unknown is_boost_scope {is_boost_scope!r}; "
                         "expected 'all', 'gens' or 'branches'")
    gen_only_mask = None
    if is_boost > 0 and is_boost_scope == "gens":
        gen_only_mask = jnp.asarray(
            np.arange(sys.n_comp) < sys.n_gen)
    elif is_boost > 0 and is_boost_scope == "branches":
        # Branch-only boost: the lever for transmission/islanding-driven
        # risk (case300s: deficit_pos_frac ~ 0 at peak — the events are
        # network-driven, so boosting GEN rates buys nothing there).
        gen_only_mask = jnp.asarray(
            np.arange(sys.n_comp) >= sys.n_gen)

    if cv_arrays is not None:
        gen_cap_mw = jnp.asarray(cv_arrays[0], jnp.float32)
        total_load_mw = np.float32(cv_arrays[1])  # host constant

    def device_step(dev_key, sys, *cv_cap):
        # sys enters as an ARGUMENT (tracers), never a closure constant —
        # see make_seq_batch_step for why (trace-time eager dispatch +
        # per-constant device fetches at lowering).
        k = dev_key[0]                 # this device's fold_in(key, dev)
        if is_q is not None:
            down, weight = sample_states_importance(
                k, sys.unavail, sys.always_up_nsq, batch_per_device,
                0.0, q_override=jnp.asarray(is_q, jnp.float32))
        elif mix is not None:
            from powersystemsreliabilityassessment.sampling.state \
                import sample_states_mixture
            down, weight = sample_states_mixture(
                k, sys.unavail, sys.always_up_nsq, batch_per_device,
                jnp.asarray(np.asarray(mix[0], bool)), float(mix[1]),
                float(mix[2]))
        elif is_boost > 0:
            down, weight = sample_states_importance(
                k, sys.unavail, sys.always_up_nsq, batch_per_device,
                is_boost, boost_mask=gen_only_mask)
        else:
            down = sample_states(k, sys.unavail, sys.always_up_nsq,
                                 batch_per_device, antithetic=antithetic)
            weight = None
        load = jnp.broadcast_to(sys.load_pd[None, :],
                                (batch_per_device, sys.n_load))
        # The hint is a tiny host constant ([n_load] literal in the
        # jaxpr), not a device-resident closure array — safe for the
        # trace-time rules that apply to System (see device_step note).
        hint = (None if shed_hint is None
                else jnp.asarray(shed_hint, jnp.float32))
        res, n_over = dcopf.evaluate_states_screened(
            sys, down, load, max_lp, compat, ipm, nodal_mode,
            # Any boost (regardless of scope) inflates the first-check-
            # needy fraction: gens boost pushes deficit>0 to ~44% of
            # lanes, branch boost multiplies congested-outage lanes.
            # default_repair_buffer returns None (full-batch repair) for
            # boost > 1, which is what those regimes need — sizing the
            # gens-scope buffer as if unboosted overflowed lanes to the
            # LP buffer (absorbed in "lp" mode but forcing grow-and-redo
            # rebuilds in "proportional" mode).
            repair_buffer=dcopf.default_repair_buffer(
                batch_per_device,
                max(is_boost,
                    2.0 if (is_q is not None or mix is not None)
                    else 1.0),
                hinted=shed_hint is not None),
            woodbury_k=woodbury_k, shed_hint=hint,
            # Tier 1.5 (island-aware reduced-network PF certificate) on
            # large-m systems: closes the deep/islanding miss class so
            # the m>336 LP buffer stays at the TRUE positive-shed rate.
            pf_buffer=dcopf.default_pf_buffer(sys, batch_per_device))
        if enum_order > 0:
            # Tail mask: low-order states are counted exactly by the
            # enumeration pre-pass; only #down > enum_order contributes
            # to the MC moments (n still counts every sample, so the
            # tail term is E[f * 1(tail)], not a conditional mean).
            tail = jnp.sum(down, axis=1) > enum_order
            res = res._replace(
                dns_mw=res.dns_mw * tail,
                nodal_mw=res.nodal_mw * tail[:, None],
                failure=res.failure & tail)
        cv = None
        if cv_cap:
            # Copper-sheet control variate in MW: integer-valued f32 unit
            # capacities => the einsum capacity sum is exact, and the
            # analytical means (copt.copper_cv_means) were computed from
            # the same f32-rounded total load. Only the RESIDUALS go into
            # the moments (see accumulators.batch_moments); the exact
            # means live on the host accumulator.
            gen_up = 1.0 - down[:, :sys.n_gen].astype(res.dns_mw.dtype)
            c_mw = jnp.maximum(
                total_load_mw - gen_up @ cv_cap[0], 0.0)       # [B]
            c_flag = c_mw > compat.nsq_fail_flag_threshold_mw
            cv = (c_mw, c_flag)
        m = accumulators.batch_moments(res.dns_mw, res.nodal_mw, res.failure,
                                       down, weight, cv)
        return (accumulators.psum_moments(m),
                jax.lax.psum(n_over, meshlib.SCENARIO_AXIS),
                jax.lax.psum(jnp.sum(res.infeasible), meshlib.SCENARIO_AXIS))

    n_in = 2 + (1 if cv_arrays is not None else 0)
    sharded = shard_map(
        device_step, mesh=mesh,
        in_specs=(P(meshlib.SCENARIO_AXIS),) + (P(),) * (n_in - 1),
        out_specs=(accumulators.MOMENTS_OUT_SPECS, P(), P()),
        check_vma=False,
    )
    n_dev = mesh.devices.size
    jstep = jax.jit(lambda key, *a: sharded(
        meshlib.device_keys(key, n_dev), *a))
    jkeys = jax.jit(sharded)
    extra = (sys,) if cv_arrays is None else (sys, gen_cap_mw)
    step = lambda key: jstep(key, *extra)
    # from_keys([n_dev] per-device keys) runs the same step on explicit
    # keys: a 1-device step replays one device's share of a mesh batch.
    step.from_keys = lambda keys: jkeys(keys, *extra)
    return step


@dataclasses.dataclass
class NSQResult:
    edns_mw: float
    lole_hr_yr: float
    plc: float
    beta: float
    samples: int
    converged: bool
    nodal_eens_mwh_yr: np.ndarray
    comp_importance: np.ndarray
    beta_history: list
    edns_history: list
    lole_history: list
    plc_history: list
    overflow_states: int
    # States with no feasible dispatch (enforce_pmin only) — the reference
    # silently records zero for these (seqMain.m:117-126); reported here.
    infeasible_states: int = 0
    # Enumeration-hybrid diagnostics (enum_order > 0): enumerated state
    # count, their exact probability mass, and the exact EDNS part (the
    # MC contribution is edns_mw - enum_edns_exact_mw).
    enum_order: int = 0
    enum_states: int = 0
    enum_mass: float = 0.0
    enum_edns_exact_mw: float = 0.0

    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["nodal_eens_mwh_yr"] = self.nodal_eens_mwh_yr.tolist()
        d["comp_importance"] = self.comp_importance.tolist()
        return d


def run_nsq_study(case: CaseData, cfg: MCSConfig = MCSConfig(),
                  compat: CompatFlags = CompatFlags(),
                  ipm: IPMConfig = IPMConfig(),
                  mesh: Mesh | None = None,
                  checkpointer: Checkpointer | None = None,
                  checkpoint_every: int = 50,
                  log_every: int = 10,
                  max_lp: int | None = None,
                  control_variate: bool = False,
                  enum_order: int = 0) -> NSQResult:
    """``max_lp``: initial LP-lane buffer per device batch (None = the
    step's default); on overflow it doubles and the batch is redone with
    the same keys, so the estimate is invariant to the initial size
    (tests/test_parallel.py::test_nsq_adaptive_lp_buffer_redo_exact).

    ``enum_order=k > 0`` enables the enumeration hybrid (classic
    contingency enumeration, sampling/enumeration.py): every state with
    <= k outages is evaluated ONCE exactly (float64-weighted pre-pass
    through the same evaluator), and the MC loop estimates only the
    #down > k tail. Zero sampling variance on the enumerated mass
    (97.6% of RTS-24 state space at k=4); measured EDNS-variance
    reduction 3.5x at k=4, 10.8x at k=5. Composes with antithetic and
    is_boost (the tail is exactly the rare region a boost targets); not
    with control_variate (both use the exact-mean offsets).

    ``control_variate=True`` subtracts each state's copper-sheet deficit
    and adds back its EXACT expectation from a float64 COPT at the peak
    load (copt.copper_cv_means): EDNS_cv = mu_C + mean(DNS - C). NSQ
    states are iid Bernoulli(U) — exactly the COPT's stationary law — so
    no sampling change is needed, and the adjustment composes with both
    antithetic pairing and importance sampling (E_q[w C] = mu_C). The
    network-free copper deficit explains most DNS variance, so beta
    collapses; the reference's plain-MC loop (nsqMain.m:60-61) has no
    counterpart."""
    sys = build_system(case, compat)
    if log_every:
        # Intact-system sanity line (the reference's pre-loop runopf,
        # nsqMain.m:188-198 — host-side f64 analog, no compile cost).
        dcopf.print_baseline(sys)
    mesh = mesh or meshlib.scenario_mesh()
    n_dev = mesh.devices.size
    bpd = max(cfg.batch_size // n_dev, 1)
    ce_auto_lp = max_lp is None and cfg.is_ce
    if max_lp is None and not cfg.is_ce:
        # Resolve the step's default HERE so consume()'s doubling always
        # grows from the buffer actually in use (growing from a wrongly
        # assumed default would rebuild an identical step and waste a
        # full redo + compile). The CE case defers to after calibration:
        # the pilot MEASURES the deficit fraction under the learned
        # proposal, which is the right sizing input (a CE tilt on a
        # capacity-driven system legitimately drives >50% of draws into
        # deficit — that is what CE optimality means — and a guessed
        # buffer forces multi-recompile grow-and-redo cycles).
        max_lp = default_max_lp(
            bpd, cfg.nodal_mode, cfg.is_boost, cfg.is_boost_scope,
            pf_tier=dcopf.default_pf_buffer(sys, bpd) is not None)

    cv_arrays = None
    if control_variate:
        from powersystemsreliabilityassessment.engines import copt
        from powersystemsreliabilityassessment.models import twostate
        gen_cap_mw = np.asarray(case.gen_pmax, np.float32)
        total_load_mw = np.float32(np.sum(np.asarray(case.bus_pd,
                                                     np.float64)))
        mu_e, mu_l, _, _ = copt.copper_cv_means(
            gen_cap_mw.astype(np.float64),
            twostate.unavailability(case)[:case.n_gen],
            np.asarray([total_load_mw], np.float64),
            thresh_mw=compat.nsq_fail_flag_threshold_mw)
        cv_arrays = (gen_cap_mw, total_load_mw, mu_e, mu_l)
        if log_every:
            print(f"control variate: mu_EDNS {mu_e:.4f} MW, "
                  f"mu_PLC {mu_l:.6f} (exact f64 COPT)")

    if enum_order > 0 and control_variate:
        raise ValueError("enum_order and control_variate are mutually "
                         "exclusive (both carry exact-mean offsets)")

    # Static shed-direction calibration (dcopf.calibrate_shed_hint):
    # one deterministic pilot batch, then the first certificate pass
    # closes ~99.96% of lanes and the repair buffer shrinks 8x.
    # Correctness never depends on the hint (a bad hint only routes
    # more lanes to the LP), so any calibration outcome is safe.
    shed_hint = dcopf.calibrate_shed_hint(sys)
    if log_every and shed_hint is None:
        print("shed-hint calibration: too few repairable lanes; "
              "keeping the load-proportional candidate")

    is_q = None
    if cfg.is_ce:
        # Cross-entropy network-aware proposal (calibrate_ce_proposal):
        # pilot-learned per-component tilt. Falls back to the configured
        # fixed sampler when the pilot sees no events — unbiasedness
        # never depends on the calibration outcome.
        is_q, ce_diag = calibrate_ce_proposal(
            sys, compat, ipm, batch=cfg.ce_batch, rounds=cfg.ce_rounds,
            boost0=cfg.ce_boost0, smoothing=cfg.ce_smoothing,
            seed=cfg.seed + 90210, shed_hint=shed_hint,
            log_every=log_every)
        if is_q is not None and cfg.ce_top_k is not None:
            is_q = sparsify_ce_proposal(is_q, sys, top_k=cfg.ce_top_k,
                                        q_cap=cfg.ce_q_cap)
        if log_every:
            if is_q is None:
                print("CE calibration saw no deficit events; keeping "
                      "the configured sampler")
            else:
                top = np.argsort(is_q[sys.n_gen:])[::-1][:5]
                print("CE proposal: sum q_br "
                      f"{float(is_q[sys.n_gen:].sum()):.3f}, top branches "
                      f"{top.tolist()}")
    if ce_auto_lp:
        if is_q is None:
            max_lp = default_max_lp(
                bpd, cfg.nodal_mode, cfg.is_boost, cfg.is_boost_scope,
                pf_tier=dcopf.default_pf_buffer(sys, bpd) is not None)
        else:
            # Sized from the pilot's measured deficit fraction under
            # the (near-final) proposal, x1.5 margin + 64; the
            # grow-and-redo loop remains the safety net for drift
            # between the pilot-round and final proposals.
            frac = ce_diag["rounds"][-1]["events"] / cfg.ce_batch
            need = int(1.5 * frac * bpd) + 64
            max_lp = min(bpd, ((need + 127) // 128) * 128)
            if log_every:
                print(f"CE max_lp: {max_lp} (pilot deficit frac "
                      f"{frac:.3f})")

    step_kwargs = dict(
        antithetic=cfg.antithetic, nodal_mode=cfg.nodal_mode,
        is_boost=0.0 if is_q is not None else cfg.is_boost,
        cv_arrays=cv_arrays, enum_order=enum_order,
        is_boost_scope=cfg.is_boost_scope, woodbury_k=cfg.woodbury_k,
        shed_hint=shed_hint, is_q=is_q)
    step = make_nsq_batch_step(sys, mesh, bpd, compat, ipm, max_lp=max_lp,
                               **step_kwargs)
    root = jax.random.key(cfg.seed)

    stats = accumulators.RunningStats()
    if cv_arrays is not None:
        stats.mu_dns, stats.mu_flag = float(mu_e), float(mu_l)
    histories = {"beta": [], "edns": [], "lole": [], "plc": []}
    batch_idx, overflow, infeasible = 0, 0, 0
    exact = None

    restored = checkpointer.restore() if checkpointer is not None else None
    if restored is not None:
        stats = accumulators.RunningStats.from_state(restored["stats"])
        histories = restored["histories"]
        batch_idx = int(restored["batch_idx"])
        overflow = int(restored.get("overflow", 0))
        infeasible = int(restored.get("infeasible", 0))
    elif enum_order > 0:
        # Enumeration pre-pass (skipped on resume: the exact part lives
        # in the checkpointed mu_* offsets already).
        from powersystemsreliabilityassessment.sampling import (
            enumeration)
        exact = enumeration.enumerate_exact(
            sys, compat, ipm, cfg.nodal_mode, enum_order,
            log_every=log_every)
        stats.mu_dns = exact.edns_mw
        stats.mu_flag = exact.pfail
        stats.mu_flag_raw = exact.pfail
        stats.mu_nodal = exact.nodal_mw
        stats.mu_comp_fail = exact.comp_fail
        if log_every:
            print(f"enumeration order {enum_order}: {exact.n_states:,} "
                  f"states, mass {exact.mass:.6f} (tail "
                  f"{exact.tail_mass:.2e}), exact EDNS part "
                  f"{exact.edns_mw:.4f} MW, exact PLC part "
                  f"{exact.pfail:.6f}")

    enum_info = None
    if exact is not None:
        enum_info = {"order": enum_order, "n_states": exact.n_states,
                     "mass": exact.mass, "edns_exact": exact.edns_mw}
    elif restored is not None:
        enum_info = restored.get("enum")

    def consume(out, next_idx) -> bool:
        """Fold a finished batch into stats; True if a redo is needed."""
        nonlocal max_lp, step, overflow, infeasible
        moments, n_over, n_infeas = out
        if int(n_over) > 0:
            # Adaptive LP buffer: grow and REDO (keys are deterministic,
            # so the redo is exact, not a resample). Large-m systems cap
            # the growth at the memory cap (see default_max_lp); past
            # it, overflow states keep their certified bounds and are
            # counted — the documented degradation, not a crash.
            lp_cap = (2048 if dcopf.default_pf_buffer(sys, bpd)
                      is not None else bpd)
            grown = 2 * max_lp  # resolved to the step's actual buffer above
            if grown <= min(bpd, lp_cap):
                max_lp = grown
                print(f"LP buffer overflow ({int(n_over)}); growing "
                      f"max_lp to {max_lp} and redoing batch")
                step = make_nsq_batch_step(
                    sys, mesh, bpd, compat, ipm, max_lp=max_lp,
                    **step_kwargs)
                return True
            overflow += int(n_over)  # buffer already at batch size
        infeasible += int(n_infeas)
        stats.update(moments)
        histories["beta"].append(stats.beta)
        histories["edns"].append(stats.edns)
        histories["lole"].append(stats.lole(compat.hours_per_year_annualize))
        histories["plc"].append(stats.plc)
        n_batches = len(histories["beta"])
        if log_every and n_batches % log_every == 0:
            print(f"samples {int(stats.n):7d}: beta={stats.beta:.6f} "
                  f"EDNS={stats.edns:.4f} MW LOLE="
                  f"{stats.lole(compat.hours_per_year_annualize):.2f} hr/yr")
        if checkpointer is not None and n_batches % checkpoint_every == 0:
            checkpointer.save({"stats": stats.state(),
                               "histories": histories,
                               "batch_idx": next_idx,
                               "overflow": overflow,
                               "infeasible": infeasible,
                               "enum": enum_info})
        return False

    global_batch = bpd * n_dev
    double_buffered_loop(
        dispatch=lambda i: step(jax.random.fold_in(root, i)),
        consume=consume,
        should_continue=lambda i: (i * global_batch < cfg.max_samples
                                   and stats.beta > cfg.beta_limit),
        start_idx=batch_idx)

    return NSQResult(
        edns_mw=stats.edns,
        lole_hr_yr=stats.lole(compat.hours_per_year_annualize),
        plc=stats.plc,
        beta=stats.beta,
        samples=int(stats.n),
        converged=stats.beta <= cfg.beta_limit,
        nodal_eens_mwh_yr=stats.nodal_eens(compat.hours_per_year_annualize),
        comp_importance=stats.component_importance(),
        beta_history=histories["beta"],
        edns_history=histories["edns"],
        lole_history=histories["lole"],
        plc_history=histories["plc"],
        overflow_states=overflow,
        infeasible_states=infeasible,
        enum_order=enum_order,
        enum_states=(enum_info or {}).get("n_states", 0),
        enum_mass=(enum_info or {}).get("mass", 0.0),
        enum_edns_exact_mw=(enum_info or {}).get("edns_exact", 0.0),
    )
