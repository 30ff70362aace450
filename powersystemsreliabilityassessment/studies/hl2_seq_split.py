"""Multilevel-splitting (RESTART) variance reduction for the sequential
HL2 study — the chronological counterpart of NSQ importance sampling.

The reference has nothing like it; naive path-IS was analyzed and
rejected in round 1 (a year's ~600 biased dwell draws accumulate enough
KL divergence that the likelihood weights degenerate). Splitting
biases NOTHING: it spends extra samples on the conditional tail of years
that approach failure, using the margin process as the importance
function.

Estimator (per parent year, one splitting level):

    M_t   = available capacity(t) - system load(t)   (copper margin)
    T     = first hour with M_t < level_mw           (H if never)
    F     = F_pre(T)  +  (1/K) sum_k F_tail_k(T)

where F_pre sums the index over hours < T, clone 0's tail is the parent's
own continuation, and clones 1..K-1 restart the component process at hour
T from the parent's binary state vector — exact by the memorylessness of
the exponential dwell times (``chronological.sample_timeline_from_state``;
this is why the splitting study samples with ``quantize=False``). Each
parent's estimate is unbiased by the tower property:
E[F_tail_k | state(T)] = E[F_tail | state(T)] for every k, so splitting
changes only the variance. Parents that never reach the level keep their
plain estimate, and when more parents enter the level than the per-batch
clone budget, the surplus (in lane order — independent of the tails) also
keep the plain estimate, which preserves unbiasedness.

All indices (ENS, PLC/DLC, the NLC event count with its boundary rise,
nodal EENS and the weak-point accumulators) decompose across the split
hour; see ``_split_year_estimates``.

STATUS (round 3, measured): splitting has NOT demonstrated a winning
niche. On RTS-24 (capacity-driven tail) the copper control variate
dominates it ~20x (results/cv_rare_event.json). On the engineered
transmission-driven tail (RTS-96 with tie ratings halved — the one
knob the sensitivity sweep showed matters) it TIES plain MC and loses
to the CV (results/split_niche.json). The failure
is structural, not statistical: the importance function that triggers
cloning is the COPPER margin M_t, which by construction cannot see
network-driven deficits (copper deficit = 0 at every such event) — the
very tails the method was reserved for. The machinery stays (unbiased,
tested, reference-free capability); the open lead for making it win is
a network-aware importance function, e.g. the per-area deliverability
margin min_a(area capacity + tie import capacity - area load), which
is sampler-cheap and sees tie outages. Until that is built and
measured, prefer plain MC or the control variate.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from powersystemsreliabilityassessment.core import load_profile
from powersystemsreliabilityassessment.core.cases import CaseData
from powersystemsreliabilityassessment.core.system import System, build_system
from powersystemsreliabilityassessment.engines import dcopf
from powersystemsreliabilityassessment.models import twostate
from powersystemsreliabilityassessment.parallel import mesh as meshlib
from powersystemsreliabilityassessment.runtime.host_loop import double_buffered_loop
from powersystemsreliabilityassessment.sampling import chronological
from powersystemsreliabilityassessment.utils.config import (
    CompatFlags, IPMConfig, MCSConfig)


@dataclasses.dataclass(frozen=True)
class SplitConfig:
    # Margin level (MW) that triggers splitting; None = auto-calibrate
    # from a sampler-only pilot so that ~entry_target of years enter.
    level_mw: float | None = None
    k_clones: int = 4         # tail samples per split parent (incl. parent)
    max_split: int = 8        # clone budget: parents split per device batch
    entry_target: float = 0.10   # auto-calibration yearly entry fraction
    pilot_years: int = 256    # pilot size for auto-calibration
    # Draw fresh clones in antithetic (u, 1-u) dwell pairs: tail ENS is
    # monotone in the dwell uniforms, so pair members are negatively
    # correlated and the clone average tightens below the independent
    # value at zero cost. Each member remains exactly distributed, so
    # unbiasedness is untouched.
    antithetic_clones: bool = True


def _pad_shift_table(v: np.ndarray) -> np.ndarray:
    """Zero-pad a length-H table so dynamic_slice(t, H) is in-bounds for
    ANY t <= H. dynamic_slice CLAMPS out-of-range starts, so padding only
    to the next 128 multiple would silently alias every split hour
    T > pad onto T = pad (the round-2 split-bias bug: clones saw the
    January load profile instead of their own season). Total length is
    also kept a 128 multiple (see engines/copt.py::summarize)."""
    n = v.shape[0]
    total = 2 * n + ((-2 * n) % 128)
    out = np.zeros(total, v.dtype)
    out[:n] = v
    return out


def calibrate_level(sys: System, factors: np.ndarray, hours: int,
                    n_draws: int, entry_target: float = 0.10,
                    pilot_years: int = 256, seed: int = 0) -> float:
    """Sampler-only pilot: pick the copper-margin level (MW) whose yearly
    entry fraction is ``entry_target`` (the empirical quantile of the
    yearly MINIMUM margin). No LP work — cost is a few seconds;
    RESTART's efficiency is flat in a wide band around
    the target, so a pilot this size suffices."""
    ng = sys.n_gen
    total_load = jnp.sum(sys.load_pd)
    fac = jnp.asarray(factors, jnp.float32)

    @jax.jit
    def min_margin(key, sys):
        keys = jax.random.split(key, 128)
        down = jax.vmap(lambda kk: chronological.sample_timeline(
            kk, sys.mttf, sys.mttr, hours, n_draws,
            quantize=False))(keys)
        up = 1.0 - down[:, :ng, :].astype(jnp.float32)
        cap = jnp.einsum("ygh,g->yh", up, sys.gen_pmax)
        return jnp.min(cap - fac[None, :] * total_load, axis=1)

    root = jax.random.fold_in(jax.random.key(seed), 0x5117)
    mm = np.concatenate([
        np.asarray(min_margin(jax.random.fold_in(root, b), sys))
        for b in range(max(pilot_years // 128, 1))])
    return float(np.percentile(mm, 100.0 * entry_target)
                 * float(sys.base_mva))


def make_split_batch_step(sys: System, mesh, years_per_device: int,
                          compat: CompatFlags, ipm: IPMConfig,
                          hours: int, n_draws: int, max_lp: int,
                          factors: np.ndarray, split: SplitConfig,
                          nodal_mode: str = "lp"):
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    K = split.k_clones
    Yp = years_per_device
    S = min(split.max_split, Yp)        # clone budget per device batch
    fac_pad = jnp.asarray(_pad_shift_table(np.asarray(factors, np.float32)))
    fac = jnp.asarray(factors, np.float32)
    level_pu = split.level_mw / sys.base_mva

    def eval_flat(sys, down_h, load_h):
        """[N, H, ncomp], [N, H] load factor -> per-hour dns [N, H]."""
        N = down_h.shape[0]
        load_pu = load_h[:, :, None] * sys.load_pd[None, None, :]
        res, n_over = dcopf.evaluate_states_screened(
            sys, down_h.reshape(N * hours, -1),
            load_pu.reshape(N * hours, -1), max_lp * N, compat, ipm,
            nodal_mode)
        return (res.dns_mw.reshape(N, hours),
                res.nodal_mw.reshape(N, hours, -1), n_over)

    def device_step(key, sys):
        dev = jax.lax.axis_index(meshlib.SCENARIO_AXIS)
        k = jax.random.fold_in(key, dev)
        kp, kc = jax.random.split(k)
        keys = jax.random.split(kp, Yp)
        down = jax.vmap(lambda kk: chronological.sample_timeline(
            kk, sys.mttf, sys.mttr, hours, n_draws,
            quantize=False))(keys)                     # [Yp, ncomp, H]
        down_h = jnp.swapaxes(down, 1, 2)              # [Yp, H, ncomp]

        # Copper margin & first entry hour into the splitting level.
        ng = sys.n_gen
        gen_up = 1.0 - down[:, :ng, :].astype(fac.dtype)   # [Yp, ng, H]
        cap = jnp.einsum("ygh,g->yh", gen_up, sys.gen_pmax)
        margin = cap - fac[None, :] * jnp.sum(sys.load_pd)
        danger = margin < level_pu
        entered = jnp.any(danger, axis=1)
        T = jnp.where(entered, jnp.argmax(danger, axis=1), hours)  # [Yp]

        # Parent evaluation (full years).
        ones_h = jnp.ones((Yp, hours), bool)
        dns_p, nodal_p, n_over_p = eval_flat(
            sys, down_h, fac[None, :] + jnp.zeros((Yp, 1), fac.dtype))

        # Select up to S entering parents (lane order; surplus parents
        # keep the plain estimate — unbiased, logged).
        score = entered.astype(jnp.int32) * (2 * Yp) - np.arange(
            Yp, dtype=np.int32)
        _, pidx = jax.lax.top_k(score, S)
        psel = entered[pidx] & (np.arange(S, dtype=np.int32)
                                < jnp.sum(entered))
        n_split_over = jnp.maximum(jnp.sum(entered) - S, 0)

        # Clone tails: state at hour T, fresh randomness, masked loads.
        Tsel = T[pidx]                                  # [S]
        state0 = jax.vmap(
            lambda y, t: jax.lax.dynamic_slice(
                down[y], (0, jnp.minimum(t, hours - 1)),
                (down.shape[1], 1))[:, 0])(pidx, Tsel)  # [S, ncomp]
        rel = np.arange(hours, dtype=np.int32)
        valid_rel = rel[None, :] < (hours - Tsel)[:, None]   # [S, H]
        if K > 1:
            def sample_tail(anti):
                def f(kk, s0):
                    return chronological.sample_timeline_from_state(
                        kk, s0, sys.mttf, sys.mttr, hours, n_draws,
                        antithetic=anti)
                return jax.vmap(jax.vmap(f, in_axes=(0, None)))

            if split.antithetic_clones and K > 2:
                # (K-1) fresh tails as antithetic (u, 1-u) pairs sharing
                # a key, plus one independent plain tail if K-1 is odd.
                n_pairs = (K - 1) // 2
                rem = (K - 1) - 2 * n_pairs
                ckeys = jax.random.split(kc, (S, n_pairs + rem))
                plain = sample_tail(False)(ckeys, state0)
                anti = sample_tail(True)(ckeys[:, :n_pairs], state0)
                clone_down = jnp.concatenate([plain, anti], axis=1)
            else:
                ckeys = jax.random.split(kc, (S, K - 1))
                clone_down = sample_tail(False)(ckeys, state0)
            # clone_down: [S, K-1, ncomp, H]
            # Relative-hour load factors: factor[T + s], zero past year
            # end (zero load => certified zero-shed lane, no LP burned).
            fshift = jax.vmap(lambda t: jax.lax.dynamic_slice(
                fac_pad, (t,), (hours,)))(Tsel)         # [S, H]
            fshift = jnp.where(valid_rel, fshift, 0.0)
            cd = jnp.swapaxes(clone_down, 2, 3)         # [S, K-1, H, ncomp]
            cl = jnp.broadcast_to(fshift[:, None, :], (S, K - 1, hours))
            dns_c, nodal_c, n_over_c = eval_flat(
                sys, cd.reshape(S * (K - 1), hours, -1),
                cl.reshape(S * (K - 1), hours))
            dns_c = dns_c.reshape(S, K - 1, hours)
            nodal_c = nodal_c.reshape(S, K - 1, hours, -1)
        else:
            # K=1: the only tail sample is the parent's own continuation.
            nb = sys.load_onehot.shape[0]
            cd = jnp.zeros((S, 0, hours, down.shape[1]), bool)
            dns_c = jnp.zeros((S, 0, hours), fac.dtype)
            nodal_c = jnp.zeros((S, 0, hours, nb), fac.dtype)
            n_over_c = 0

        # --- combine into per-parent-year index estimates --------------
        thresh = compat.seq_curtail_threshold_mw
        t_abs = np.arange(hours, dtype=np.int32)
        pre_mask = t_abs[None, :] < T[:, None]          # [Yp, H]
        flag_p = dns_p > thresh
        # Plain (no-split) yearly values.
        ens_plain = jnp.sum(dns_p, axis=1)
        dlc_plain = jnp.sum(flag_p, axis=1).astype(dns_p.dtype)
        from powersystemsreliabilityassessment.engines import (
            copper_sheet)
        nlc_plain = copper_sheet.count_curtailment_events(
            flag_p).astype(dns_p.dtype)
        nodal_plain = jnp.sum(jnp.where(flag_p[:, :, None], nodal_p, 0.0),
                              axis=1)                   # [Yp, nb]
        comp_plain = jnp.einsum("yh,yhc->yc", flag_p.astype(dns_p.dtype),
                                down_h.astype(dns_p.dtype))

        # Split decomposition for the selected parents.
        dns_pre = jnp.where(pre_mask, dns_p, 0.0)[pidx]         # [S, H]
        flag_pre = flag_p[pidx] & pre_mask[pidx]
        ens_pre = jnp.sum(dns_pre, axis=1)
        dlc_pre = jnp.sum(flag_pre, axis=1).astype(dns_p.dtype)
        nlc_pre = copper_sheet.count_curtailment_events(
            flag_pre).astype(dns_p.dtype)
        nodal_pre = jnp.sum(
            jnp.where(flag_pre[:, :, None], nodal_p[pidx], 0.0), axis=1)
        comp_pre = jnp.einsum(
            "sh,shc->sc", flag_pre.astype(dns_p.dtype),
            (down_h[pidx] & pre_mask[pidx][:, :, None]).astype(dns_p.dtype))
        # Last pre-split flag (for the boundary rise of each tail).
        tm1 = jnp.maximum(Tsel - 1, 0)
        last_pre = jnp.where(
            Tsel > 0,
            jnp.take_along_axis(flag_p[pidx], tm1[:, None], axis=1)[:, 0],
            False)                                       # [S]

        def tail_stats(dns_tail, nodal_tail, down_tail, vmask,
                       start_idx=None):
            """Per-tail (ens, dlc, nlc_tail+boundary, nodal, comp).

            ``start_idx``: position of the tail's FIRST hour within the
            flag array — None for fresh clones (relative hours, position
            0 = the split hour) and ``Tsel`` for the parent's own tail
            (absolute hours). count_curtailment_events counts a rise at
            that position (start edge, or masked-False -> True
            transition) equal to the flag there; it is replaced by the
            true boundary rise vs the pre-split hour. Anchoring at
            position 0 for the parent tail would leave a curtailment
            event straddling T double-counted (its rise is in nlc_pre
            AND the tail's T-transition).
            """
            flag = (dns_tail > thresh) & vmask
            ens = jnp.sum(jnp.where(vmask, dns_tail, 0.0), axis=-1)
            dlc = jnp.sum(flag, axis=-1).astype(dns_tail.dtype)
            rises = copper_sheet.count_curtailment_events(flag)
            if start_idx is None:
                start = flag[..., 0]
            else:
                start = jnp.take_along_axis(
                    flag, jnp.minimum(start_idx, hours - 1)[:, None],
                    axis=1)[:, 0]
            nlc = (rises.astype(dns_tail.dtype)
                   - start.astype(dns_tail.dtype)
                   + (start & ~last_pre[:, None] if flag.ndim == 3
                      else start & ~last_pre).astype(dns_tail.dtype))
            nodal = jnp.sum(jnp.where(flag[..., None], nodal_tail, 0.0),
                            axis=-2)
            comp = jnp.einsum("...h,...hc->...c",
                              flag.astype(dns_tail.dtype),
                              down_tail.astype(dns_tail.dtype))
            return ens, dlc, nlc, nodal, comp

        # Parent's own tail (clone 0): absolute hours >= T.
        tail_mask_p = ~pre_mask[pidx]                    # [S, H]
        pt = tail_stats(dns_p[pidx], nodal_p[pidx],
                        down_h[pidx] & tail_mask_p[:, :, None],
                        tail_mask_p, start_idx=Tsel)
        # Fresh clones: relative hours, valid until year end.
        ct = tail_stats(
            dns_c, nodal_c,
            cd & valid_rel[:, None, :, None],
            valid_rel[:, None, :])

        mean_tail = lambda p, c: (p + jnp.sum(c, axis=1)) / K
        ens_split = ens_pre + mean_tail(pt[0], ct[0])
        dlc_split = dlc_pre + mean_tail(pt[1], ct[1])
        nlc_split = nlc_pre + mean_tail(pt[2], ct[2])
        nodal_split = nodal_pre + mean_tail(pt[3], ct[3])
        comp_split = comp_pre + mean_tail(pt[4], ct[4])

        sub = lambda plain, idx, new, sel: plain.at[idx].set(
            jnp.where(sel if new.ndim == 1 else sel[:, None], new,
                      plain[idx]))
        ens = sub(ens_plain, pidx, ens_split, psel)
        dlc = sub(dlc_plain, pidx, dlc_split, psel)
        nlc = sub(nlc_plain, pidx, nlc_split, psel)
        nodal = sub(nodal_plain, pidx, nodal_split, psel)
        comp = sub(comp_plain, pidx, comp_split, psel)
        plc = dlc / hours
        edns = ens / hours

        gather = lambda a: jax.lax.all_gather(
            a, meshlib.SCENARIO_AXIS, tiled=True)
        ps = lambda a: jax.lax.psum(a, meshlib.SCENARIO_AXIS)
        return (gather(ens), gather(plc), gather(nlc), gather(dlc),
                gather(edns), ps(jnp.sum(nodal, 0)), ps(jnp.sum(comp, 0)),
                ps(jnp.sum(dlc)), ps(n_over_p + n_over_c),
                ps(n_split_over), ps(jnp.sum(entered)))

    jstep = jax.jit(shard_map(
        device_step, mesh=mesh, in_specs=(P(), P()),
        out_specs=(P(),) * 11, check_vma=False))
    step = lambda key: jstep(key, sys)
    step.jstep, step.extra_args = jstep, (sys,)
    return step


def run_seq_split_study(case: CaseData, cfg: MCSConfig = MCSConfig(),
                        split: SplitConfig = SplitConfig(),
                        compat: CompatFlags = CompatFlags(),
                        ipm: IPMConfig = IPMConfig(),
                        mesh=None,
                        years_per_device: int = 16,
                        max_lp: int = 256,
                        hours: int | None = None,
                        load_scale: float = 1.0,
                        checkpointer=None,
                        checkpoint_every: int = 10,
                        log_every: int = 5):
    """SEQ study with multilevel splitting; returns an ``SEQResult``.

    ``load_scale`` scales the whole load profile (rare-event configs for
    the variance-reduction measurements use e.g. 0.85). Loop features
    match run_seq_study: double-buffered dispatch, adaptive LP-buffer
    growth with an exact same-keys redo, optional checkpoint/resume.
    """
    from powersystemsreliabilityassessment.parallel.accumulators import (
        AnnualStats)
    from powersystemsreliabilityassessment.studies.hl2_seq import (
        SEQResult)

    sys = build_system(case, compat)
    mesh = mesh or meshlib.scenario_mesh()
    hours = hours or compat.hours_per_year_seq
    factors = load_profile.load_factors(hours, compat.weekday_mode)
    factors = factors * load_scale
    mt = twostate.mean_times(case)
    n_draws = chronological.default_num_draws(mt[:, 0], mt[:, 1], hours)

    if split.level_mw is None:
        level = calibrate_level(sys, np.asarray(factors), hours, n_draws,
                                split.entry_target, split.pilot_years,
                                cfg.seed)
        if log_every:
            print(f"auto-calibrated splitting level: {level:.1f} MW "
                  f"(target entry {split.entry_target:.0%}, "
                  f"{split.pilot_years}-year pilot)")
        split = dataclasses.replace(split, level_mw=level)

    step = make_split_batch_step(sys, mesh, years_per_device, compat, ipm,
                                 hours, n_draws, max_lp, factors, split,
                                 nodal_mode=cfg.nodal_mode)
    root = jax.random.key(cfg.seed)
    stats = AnnualStats()
    cov_history, eens_history = [], []
    batch_idx, overflow, split_overflow, entered_total = 0, 0, 0, 0
    years_per_batch = years_per_device * mesh.devices.size

    if checkpointer is not None:
        restored = checkpointer.restore()
        if restored is not None:
            stats = AnnualStats.from_state(restored["stats"])
            cov_history = restored["cov_history"]
            eens_history = restored["eens_history"]
            batch_idx = int(restored["batch_idx"])
            overflow = int(restored.get("overflow", 0))
            split_overflow = int(restored.get("split_overflow", 0))
            entered_total = int(restored.get("entered_total", 0))

    def consume(out, next_idx) -> bool:
        nonlocal max_lp, step, overflow, split_overflow, entered_total
        (ens, plc, nlc, dlc, edns, nodal, comp, loss_h, n_over,
         n_sover, n_entered) = out
        if int(n_over) > 0 and max_lp < hours:
            max_lp = min(2 * max_lp, hours)
            print(f"LP buffer overflow ({int(n_over)} h); growing max_lp "
                  f"to {max_lp} and redoing batch")
            step = make_split_batch_step(
                sys, mesh, years_per_device, compat, ipm, hours, n_draws,
                max_lp, factors, split, nodal_mode=cfg.nodal_mode)
            return True
        stats.update_years(ens, plc, nlc, dlc, edns, nodal, comp,
                           float(loss_h))
        overflow += int(n_over)
        split_overflow += int(n_sover)
        entered_total += int(n_entered)
        eens_history.append(stats.eens)
        cov_history.append(stats.cov)
        n_batches = len(eens_history)
        if log_every and n_batches % log_every == 0:
            print(f"year {stats.years:5d} | EENS {stats.eens:9.3f} "
                  f"| CoV {stats.cov:.4f} | split-over {split_overflow}")
        if checkpointer is not None and n_batches % checkpoint_every == 0:
            checkpointer.save({
                "stats": dataclasses.asdict(stats),
                "cov_history": cov_history,
                "eens_history": eens_history,
                "batch_idx": next_idx, "overflow": overflow,
                "split_overflow": split_overflow,
                "entered_total": entered_total})
        return False

    double_buffered_loop(
        dispatch=lambda i: step(jax.random.fold_in(root, i)),
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
        split_entered=entered_total,
        split_overflow=split_overflow,
    )
