"""Dataclass configuration objects (the reference hard-codes these as
script-top constants; see SURVEY.md §5.6)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CompatFlags:
    """Explicit compatibility switches for the reference's reproducibility
    quirks (SURVEY.md §6). Defaults replicate the reference behavior."""

    # mc_sampling.m:40-41 — sync condenser (comp 15, 1-based) pinned up in
    # the NSQ sampler only (NOT in the SEQ sampler).
    sync_cond_always_up_nsq: bool = True
    # mc_simulation.m:57-59 / seq_mcsimulation.m:475-477 — DNS noise floor.
    dns_noise_floor_mw: float = 0.1
    # nsqMain.m:270 — failure flag threshold on total DNS.
    nsq_fail_flag_threshold_mw: float = 1e-4
    # seqMain.m:41 — curtailment event threshold.
    seq_curtail_threshold_mw: float = 0.01
    # nodal shed noise threshold (mc_simulation.m:86).
    nodal_noise_threshold_mw: float = 1e-3
    # 8736 vs 8760 inconsistency: SEQ simulates 8736 h/yr but rate
    # conversions and NSQ LOLE annualization use 8760.
    hours_per_year_seq: int = 8736
    hours_per_year_annualize: int = 8760
    # MATPOWER enforces Pmin for committed units; the min-shed LP is run
    # without Pmin by default (documented deviation: with zero generator
    # costs Pmin only binds in over-generation corner cases, which the
    # reference itself handles inconsistently — seqMain.m:117-126 records
    # solver failures as zero curtailment).
    enforce_pmin: bool = False
    # anloducurve.m:39 nonstandard weekday formula ("reference") vs
    # conventional calendar ("calendar").
    weekday_mode: str = "reference"
    # Treat load buses disconnected from the reference bus as fully shed
    # (and their generators as unusable). Default False = islands are
    # solved physically (per-island balance emerges from the B-theta LP).
    # True approximates the reference's accidental behavior on islanded
    # states (MATPOWER cannot represent a second island; see PARITY.md).
    island_blackout: bool = False


@dataclasses.dataclass(frozen=True)
class MCSConfig:
    """Monte Carlo study configuration."""

    seed: int = 0
    # Scenarios per device batch. Large by default so each dispatch
    # amortizes the host round trip; convergence is checked once per
    # batch, which at 100k-sample scale is still ~12 checkpoints. Small
    # smoke runs should pass a smaller batch.
    batch_size: int = 8192
    max_samples: int = 100_000      # NSQ cap (nsqMain.m:61)
    beta_limit: float = 0.0017      # NSQ convergence target (nsqMain.m:60)
    max_years: int = 4000           # SEQ cap (seqMain.m:39)
    cov_threshold: float = 0.05     # SEQ convergence target (seqMain.m:40)
    antithetic: bool = False        # variance reduction (scale-up config)
    # Importance sampling: >1 draws component failures from the boosted
    # proposal q = min(is_boost * U, 0.5) with exact likelihood-ratio
    # weights (sampling/state.py::sample_states_importance) — unbiased
    # variance reduction for rare-event regimes plain MC undersamples.
    # 0 disables. Mutually exclusive with antithetic.
    is_boost: float = 0.0
    # Which components the boost applies to: "all" (every non-pinned
    # component) or "gens" (generators only — branches keep their true
    # outage rates, likelihood-ratio factor 1). "gens" is the right
    # scope for capacity-driven rare events at transmission scale: it
    # preserves the tier-1 certificate's n_out <= woodbury_k closure
    # (boosted branch rates flood the batch with deep multi-branch
    # topologies the certificate must LP-route).
    is_boost_scope: str = "all"
    # Cross-entropy ADAPTIVE importance sampling (network-aware): a
    # short pilot phase learns per-COMPONENT proposal rates q_k from
    # the CE-optimal product-form marginals q_k* = E[f 1(k down)]/E[f]
    # (f = DNS), so the tilt concentrates on exactly the branches whose
    # outages drive deficits — the uniform is_boost is provably blind
    # in network-driven regimes (case300s: boost 2 made beta WORSE,
    # results/case300_scaleup_pilot.json). Overrides is_boost /
    # is_boost_scope when True. Unbiased for any learned q (exact
    # likelihood ratios); the pilot only affects variance.
    is_ce: bool = False
    ce_rounds: int = 2              # CE pilot iterations
    ce_batch: int = 32768           # pilot batch per round
    ce_boost0: float = 4.0          # round-0 uniform branch boost
    ce_smoothing: float = 0.7       # q <- a*q_CE + (1-a)*q_prev
    # Sparsify the learned tilt to its top-k components by q_hat/U
    # ratio, capped at ce_q_cap, floored at U elsewhere
    # (hl2_nsq.sparsify_ce_proposal). REQUIRED for network-driven
    # regimes: the dense proposal's product-form weights degenerate
    # (case300s A/B: rel-var 20x WORSE than plain MC + certificate
    # closure destroyed, results/ce_ab.json), while the sparse capped
    # tilt has provably bounded weights. None = dense (the measured
    # failure mode; kept for A/B).
    ce_top_k: int | None = 8
    ce_q_cap: float = 0.05
    # Certificate multi-branch-outage coverage: post-outage flows are
    # exact (rank-k Woodbury) for outage sets of size <= woodbury_k,
    # deeper sets fall through to the LP. None = auto per system: 2
    # unless the expected fraction of sampled states with >= 3 branch
    # outages exceeds 1e-4 (Poisson bound on the sampling measure,
    # including the boost), then 4. RTS-24 resolves to 2 (rank-4 slots
    # cost ~2 extra [B,nl]@[nl,nl] matmuls on the bandwidth-bound hot path
    # for states that essentially never occur); case300s resolves to 4
    # (3% of plain-MC states have >= 3 branch outages —
    # results/case300_cert_breakdown.json).
    woodbury_k: int | None = None
    # "lp": states with a positive capacity deficit get their nodal shed
    # split from the interior-point LP (MIPS-like center of the degenerate
    # optimal face). "proportional": certified deficit states skip the LP —
    # the returned pattern is a different (equally optimal) point of the
    # same face; all aggregate indices identical, ~5-8x faster.
    nodal_mode: str = "lp"


@dataclasses.dataclass(frozen=True)
class IPMConfig:
    """Batched interior-point solver settings (fixed-shape, jit-safe)."""

    iterations: int = 16
    tau: float = 0.99               # fraction-to-boundary
    regularization: float = 1e-7    # normal-matrix diagonal shift
    theta_max: float = 6.0          # voltage-angle box, rad
    dtype: str = "float32"
    # Freeze threshold on the average complementarity product mu: duality
    # gap ~ 2n*mu, so 1e-7 gives ~2e-5 p.u. (0.002 MW) objective accuracy on
    # RTS-24-sized LPs — far below the reference's 0.1 MW noise floor, and
    # above the f32 zone where Newton steps degrade.
    mu_tol: float = 1e-7
    # Below this mu the solver switches from Mehrotra predictor-corrector
    # to damped pure-centering steps (f32 stability; see lp_ipm.py).
    center_tol: float = 1e-4
    # Extra polished warm-restart passes of the batched IPM (stall rescue
    # for large m; lp_ipm_batched.solve_box_lp_batched). None = auto:
    # 1 when m exceeds the blocked-Cholesky range (case300 scale), else 0.
    restarts: int | None = None
    # Per-lane escalation (large-m batched path only): after the
    # unconditional restarts, up to this many FURTHER warm-restart
    # passes run under lax.cond, gated on any lane still exceeding
    # ``escalate_tol`` on the evaluator's quality score
    # (primal_residual + 2n * duality_gap — the same score dcopf's
    # 5e-3 trust guard reads). A clean batch skips them at runtime;
    # a rare stalled lane gets the extra budget instead of silently
    # degrading to its certified copper bound.
    escalate_passes: int = 2
    escalate_tol: float = 5e-3
    # Compacted restart (large-m batched path only): instead of running
    # the unconditional warm-restart pass on the FULL buffer, compact
    # the worst ``restart_compact`` lanes by quality score
    # (primal_residual + 2n * duality_gap) into a sub-buffer and run
    # the restart + escalation pipeline there; lanes left behind keep
    # their first-pass solution (their score bounds the duality gap, so
    # they are within ~0.1 MW of optimal by construction). Pass-1
    # real-miss quality at case300s: 14 of 325 lanes above 5e-3
    # (results/case300_lpq.json), so the 32-lane sub-buffer has ~2.3x
    # headroom per 8192-batch, while the
    # cond-gated full-batch escalation below stays as the safety net
    # for adversarial batches where > restart_compact lanes are hard.
    # 0 disables (round-2 behavior: full-buffer unconditional restart).
    restart_compact: int = 32
    # Iteration budget for each rescue-ladder sub-solve (the compacted
    # dense pass above). The rescue warm-starts from the POLISHED pass-1
    # iterate, so it re-converges in fewer Mehrotra iterations than a
    # cold pass; lanes a short stage fails to fix are caught by the
    # next cond-gated stage (the ladder's monotone merge makes a short
    # budget safe, unlike the round-3 half-length FULL-buffer restart
    # that lost deep lanes with no backstop). None = ``iterations``.
    # (16 -> 8 cost 0.57 MW of batch DNS at case300s — keep None.)
    rescue_iterations: int | None = None
    # Rescue-ladder stage insets, in trajectory order: a float is a
    # warm sub-solve clipped that fraction of the box width inside
    # (trajectory-carried), None is the cold side branch (feeds the
    # monotone merge only). Every stage is lax.cond-gated on the
    # best-so-far worst trust score, so stages that aren't needed at
    # runtime cost one scalar reduction. See lp_ipm_batched.run_rescue
    # for why the default order is warm-2% (step-length-jam escape)
    # -> cold (garbage-basin side branch) -> two 1e-3 feasibility
    # restorations.
    rescue_stages: tuple = (0.02, None, 1e-3, 1e-3)
    # Structured constraint operator (dcopf.make_dc_linops) for the
    # large-m (> _BLOCKED_MAX_M) XLA IPM path: assembles A diag(w) A'
    # from the DC-OPF block structure (~7x fewer gram FLOPs at case300
    # scale, no [B, m, n] tensor) instead of materializing A. False
    # falls back to the dense path (debug / A/B).
    structured_gram: bool = True
    # Block-Schur structured normal solve for the large-m path (needs
    # structured_gram's LinOps): reduce the [B, m, m] factorization to
    # two [B, nb, nb] explicit inverses (Woodbury through the flow
    # block + Schur onto the balance block with analytic Laplacian
    # cancellation — dcopf.make_dc_linops.schur_factor); the
    # latency-bound [B, m, m] large-m Cholesky disappears from the hot
    # path. False = dense factorization (A/B / fallback).
    large_m_schur: bool = True
