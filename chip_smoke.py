"""Proof that the reliability studies run on an NVIDIA GPU, in one process.

    python chip_smoke.py             # one GPU: every phase below
    python chip_smoke.py --chips 4   # four GPUs: the sharded study steps only

Phases on one GPU (each prints one ``phase <name>: {...}`` line with the
numbers it checked, the XLA compile seconds and the wall seconds):

  card       device report, compile-cache directory, JAX version and
             matmul precision ("highest": full f32, no TF32 — every
             tolerance below assumes it);
  golden     the 98 fixed states of ``tests/golden/golden_replay.json``
             through ``dcopf.evaluate_states`` on the GPU, against the
             committed DNS vector and float64 HiGHS;
  hot_*      the RTS-24 bench step (B = 262,144) in "proportional" and
             "lp" nodal mode, against the CPU device on the same threefry
             states, plus the LP pass alone next to the full step;
  large_m    case300s (m = 792) at batch 8,192, against the CPU and, on
             the LP-routed lanes, HiGHS; prints the compiled step's
             memory analysis and the card's peak memory;
  nsq/seq/multiarea   the CLI's studies, in-process;
  bench      ``bench.py``, in-process.

The CPU reference runs on ``jax.devices("cpu")`` inside this process (a
second JAX process could not reserve the card's memory). Any failed
check raises: the script exits non-zero and prints no result line. It
also refuses to run without a GPU. The last line of a passing run is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from powersystemsreliabilityassessment.core import cases, load_profile
from powersystemsreliabilityassessment.core.system import build_system
from powersystemsreliabilityassessment.engines import dcopf
from powersystemsreliabilityassessment.models import twostate
from powersystemsreliabilityassessment.parallel import mesh as meshlib
from powersystemsreliabilityassessment.runtime import device
from powersystemsreliabilityassessment.sampling import chronological
from powersystemsreliabilityassessment.sampling.state import sample_states
from powersystemsreliabilityassessment.studies import hl2_nsq, hl2_seq
from powersystemsreliabilityassessment.utils import oracle
from powersystemsreliabilityassessment.utils.config import (
    CompatFlags, IPMConfig)

REPO = os.path.dirname(os.path.abspath(__file__))
COMPAT, IPM = CompatFlags(), IPMConfig()
DNS_TOL_MW = 0.05          # per-lane DNS agreement (device vs reference)
QUALITY_GUARD = 5e-3       # the evaluator's LP trust guard (dcopf)
LARGE_M_HIGHS_TOL_MW = 1.5  # f32 floor on deep m = 792 lanes (test_case300)
REF_EDNS_MW, REF_EDNS_BETA = 14.8894, 0.01451   # PARITY.md, NSQ table
REF_LOLE_HR_YR = 735.93
_BACKEND_COMPILE = "/jax/core/compile/backend_compile_duration"


class SmokeFailure(RuntimeError):
    """A phase's check did not hold."""


def _check(ok, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def _devices(dev, ref_dev):
    return (dev or jax.devices()[0]), (ref_dev or jax.devices("cpu")[0])


def _peak_bytes(dev):
    stats = dev.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _median_ms(fn, reps: int) -> float:
    """Host-clocked median of ``reps`` calls, each ended by
    ``block_until_ready`` (the caller has compiled ``fn`` already)."""
    times = []
    for r in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(r))
        times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times))


def _compare_dns(dns, ref, what: str, highs_of, highs_tol: float,
                 max_disputed: int = 64) -> dict:
    """Per-lane DNS within DNS_TOL_MW of the reference device, failure
    flags equal except lanes within 0.1 MW of the noise floor. The
    reference runs the same float32 IPM, so it can be the one that is
    off: a lane outside either bound is settled by the float64 HiGHS
    oracle (``highs_of(lane)``), and the device must be within
    ``highs_tol`` of it there."""
    err = np.abs(dns - ref)
    thr = COMPAT.nsq_fail_flag_threshold_mw
    flip = (dns > thr) != (ref > thr)
    near = np.maximum(dns, ref) <= COMPAT.dns_noise_floor_mw + 0.1
    disputed = np.flatnonzero((err > DNS_TOL_MW) | (flip & ~near))
    _check(len(disputed) <= max_disputed,
           f"{what}: {len(disputed)} lanes differ from the reference")
    ref_wrong, worst_oracle = 0, 0.0
    for i in disputed:
        h = highs_of(int(i))
        e = abs(dns[i] - h)
        _check(e <= highs_tol and (dns[i] > thr) == (h > thr),
               f"{what}: lane {int(i)} DNS {dns[i]:.4f} MW, reference "
               f"{ref[i]:.4f}, HiGHS {h:.4f}")
        worst_oracle = max(worst_oracle, e)
        ref_wrong += abs(ref[i] - h) > highs_tol
    agreed = np.ones(len(dns), bool)
    agreed[disputed] = False
    return {"max_err_mw": float(err[agreed].max(initial=0.0)),
            "disputed_lanes": int(len(disputed)),
            "disputed_reference_wrong": int(ref_wrong),
            "disputed_max_err_highs_mw": worst_oracle,
            "flag_flips_near_floor": int((flip & near).sum())}


def phase_card() -> dict:
    dev = device.require_gpu()
    cards = device.card_lines()
    for line in cards:
        print(f"card: {line}", flush=True)
    return {"device": dev, "cards": [device.parse_smi_line(c)
                                     for c in cards],
            "cache_dir": device.cache_dir(), "jax": jax.__version__,
            "matmul_precision": jax.config.jax_default_matmul_precision}


def phase_golden(dev=None) -> dict:
    """The committed golden state set on ``dev`` vs the committed DNS
    vector and HiGHS: 0.05 MW on shedding lanes, identical flags."""
    dev, _ = _devices(dev, None)
    case = cases.rts24()
    sys_ = build_system(case, COMPAT)
    downs, loads, tags = oracle.golden_state_set(case, sys_)
    golden = np.asarray(oracle.load_golden()["dns_mw"], np.float64)
    _check(len(golden) == len(tags), "golden file length")
    res = dcopf.evaluate_states(*jax.device_put((sys_, downs, loads), dev),
                                COMPAT, IPM)
    dns = np.asarray(res.dns_mw, np.float64)
    highs = np.asarray([oracle.highs_dns(sys_, downs[i], loads[i], COMPAT,
                                         IPM.theta_max)
                        for i in range(len(tags))])
    shed = (highs > 0) | (golden > 0) | (dns > 0)
    err_h = float(np.abs(dns - highs)[shed].max())
    err_g = float(np.abs(dns - golden)[shed].max())
    _check(err_h <= DNS_TOL_MW, f"golden: max |DNS - HiGHS| {err_h:.4f} MW")
    _check(err_g <= DNS_TOL_MW, f"golden: max |DNS - golden| {err_g:.4f} MW")
    thr = COMPAT.nsq_fail_flag_threshold_mw
    flags_equal = bool(((dns > thr) == (highs > thr)).all()
                       and ((dns > thr) == (golden > thr)).all())
    _check(flags_equal, "golden: failure flags differ")
    return {"states": len(tags), "shedding": int(shed.sum()),
            "max_err_highs_mw": err_h, "max_err_golden_mw": err_g,
            "flags_equal": flags_equal}


def phase_hot_path(nodal_mode: str, batch: int = 262_144,
                   max_lp: int | None = None, cmp_batch: int | None = None,
                   reps: int = 10, hint_batch: int = 8192, dev=None,
                   ref_dev=None) -> dict:
    """The RTS-24 bench step on ``dev`` vs ``ref_dev`` on the same
    threefry states (the first ``cmp_batch`` of them; default all).
    ``max_lp`` defaults to the bench's 256 lanes in "proportional" mode
    and to the NSQ study's buffer in "lp" mode (which sends every deficit
    state to the LP)."""
    dev, ref_dev = _devices(dev, ref_dev)
    sys_ = build_system(cases.rts24(), COMPAT)
    if max_lp is None:
        max_lp = (256 if nodal_mode == "proportional"
                  else hl2_nsq.default_max_lp(batch, nodal_mode))
    cmp_batch = cmp_batch or batch
    with jax.default_device(dev):
        hint = dcopf.calibrate_shed_hint(sys_, batch=hint_batch)
    hints = {on: None if hint is None else jax.device_put(hint, on)
             for on in (dev, ref_dev)}

    def evaluate(on, sys_in, down, b, lanes):
        load = jnp.broadcast_to(sys_in.load_pd[None, :], (b, sys_in.n_load))
        return dcopf.evaluate_states_screened(
            sys_in, down, load, lanes, COMPAT, IPM, nodal_mode,
            repair_buffer=dcopf.default_repair_buffer(
                b, hinted=hint is not None),
            shed_hint=hints[on])

    sys_d = jax.device_put(sys_, dev)
    key = jax.random.key(20261016)
    down = jax.device_put(sample_states(key, sys_.unavail,
                                        sys_.always_up_nsq, batch), dev)
    res, n_over = evaluate(dev, sys_d, down, batch, max_lp)
    dns = np.asarray(res.dns_mw, np.float64)
    _check(int(n_over) == 0, f"hot_{nodal_mode}: {int(n_over)} LP overflow")

    sys_r = jax.device_put(sys_, ref_dev)
    down_r = jax.device_put(np.asarray(down)[:cmp_batch], ref_dev)
    ref_lanes = (hl2_nsq.default_max_lp(cmp_batch, nodal_mode)
                 if nodal_mode == "lp" else max_lp)
    ref, ref_over = evaluate(ref_dev, sys_r, down_r, cmp_batch, ref_lanes)
    _check(int(ref_over) == 0, "reference LP overflow")
    down_h = np.asarray(down)
    load_h = np.asarray(sys_.load_pd)
    cmp = _compare_dns(
        dns[:cmp_batch], np.asarray(ref.dns_mw, np.float64),
        f"hot_{nodal_mode}", lambda i: oracle.highs_dns(
            sys_, down_h[i], load_h, COMPAT, IPM.theta_max), DNS_TOL_MW)

    # Lane quality on the LP-routed lanes (the only ones with a score).
    q = np.asarray(res.primal_residual, np.float64)
    lp_lanes = q > 0
    n_lp = int(lp_lanes.sum())
    q_lp = q[lp_lanes] if n_lp else np.zeros(1)

    # Full step (sampler + screened evaluator) vs the LP pass alone on
    # the step's LP buffer, both host-clocked on the device.
    def step(r):
        d = sample_states(jax.random.fold_in(key, r), sys_d.unavail,
                          sys_d.always_up_nsq, batch)
        return evaluate(dev, sys_d, d, batch, max_lp)[0].dns_mw
    jax.block_until_ready(step(reps + 1))
    step_ms = _median_ms(step, reps)
    idx = np.concatenate([np.flatnonzero(lp_lanes),
                          np.flatnonzero(~lp_lanes)])[:max_lp]
    lp_down = down[idx]
    lp_load = jnp.broadcast_to(sys_d.load_pd[None, :], (max_lp, sys_.n_load))
    solve = jax.jit(dcopf._solve_batch, static_argnames=("compat", "ipm"))
    jax.block_until_ready(solve(sys_d, lp_down, lp_load, COMPAT, IPM))
    lp_ms = _median_ms(lambda r: solve(sys_d, lp_down, lp_load, COMPAT, IPM),
                       reps)
    return {"batch": batch, "max_lp": max_lp, "compared_lanes": cmp_batch,
            **cmp, "n_over": int(n_over), "lp_lanes": n_lp,
            "lp_quality_median": float(np.median(q_lp)),
            "lp_frac_over_guard": float((q_lp > QUALITY_GUARD).mean()),
            "step_ms": step_ms, "lp_pass_ms": lp_ms,
            "lp_share_of_step": lp_ms / step_ms,
            "peak_bytes": _peak_bytes(dev)}


def phase_large_m(batch: int = 8192, case=None, hint_batch: int = 8192,
                  max_highs: int = 64, dev=None, ref_dev=None) -> dict:
    """The screened NSQ evaluator at m = 792 (case300s, "proportional"
    mode, the study's default LP buffer, island-PF tier and rank-4
    certificate) on ``dev`` vs ``ref_dev``, and its LP-routed lanes vs
    HiGHS."""
    dev, ref_dev = _devices(dev, ref_dev)
    case = case or cases.case300s()
    sys_ = build_system(case, COMPAT)
    pf = dcopf.default_pf_buffer(sys_, batch)
    max_lp = hl2_nsq.default_max_lp(batch, "proportional",
                                    pf_tier=pf is not None)
    wk = hl2_nsq.default_woodbury_k(sys_)
    with jax.default_device(dev):
        hint = dcopf.calibrate_shed_hint(sys_, batch=hint_batch)
    kw = dict(repair_buffer=dcopf.default_repair_buffer(
        batch, hinted=hint is not None), woodbury_k=wk, pf_buffer=pf)
    down = np.asarray(sample_states(jax.random.key(300), sys_.unavail,
                                    sys_.always_up_nsq, batch))
    load = np.tile(np.asarray(sys_.load_pd)[None, :], (batch, 1))

    def run(on, lower=False):
        args = jax.device_put((sys_, down, load), on)
        h = None if hint is None else jax.device_put(jnp.asarray(hint), on)
        if lower:
            return dcopf.evaluate_states_screened.lower(
                *args, max_lp, COMPAT, IPM, "proportional", shed_hint=h,
                **kw).compile().memory_analysis()
        return dcopf.evaluate_states_screened(
            *args, max_lp, COMPAT, IPM, "proportional", shed_hint=h, **kw)

    mem = run(dev, lower=True)
    res, n_over = run(dev)
    dns = np.asarray(res.dns_mw, np.float64)
    peak = _peak_bytes(dev)
    ref, ref_over = run(ref_dev)
    _check(int(n_over) == 0 and int(ref_over) == 0, "large_m: LP overflow")
    cmp = _compare_dns(
        dns, np.asarray(ref.dns_mw, np.float64), "large_m",
        lambda i: oracle.highs_dns(sys_, down[i], load[i], COMPAT,
                                   IPM.theta_max), LARGE_M_HIGHS_TOL_MW)

    q = np.asarray(res.primal_residual, np.float64)
    lanes = np.flatnonzero(q > 0)
    trusted = lanes[q[lanes] <= QUALITY_GUARD][:max_highs]
    highs = np.asarray([oracle.highs_dns(sys_, down[i], load[i], COMPAT,
                                         IPM.theta_max) for i in trusted])
    err = np.abs(dns[trusted] - highs) if len(trusted) else np.zeros(1)
    _check(err.max() <= LARGE_M_HIGHS_TOL_MW,
           f"large_m: LP lane vs HiGHS {err.max():.3f} MW")
    mem_fields = {k: getattr(mem, k) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")
        if mem is not None and hasattr(mem, k)}
    return {"m": sys_.n_bus + sys_.n_branch, "batch": batch,
            "max_lp": max_lp, **cmp, "lp_lanes": int(len(lanes)),
            "lp_lanes_over_guard": int((q[lanes] > QUALITY_GUARD).sum()),
            "highs_lanes": int(len(trusted)),
            "max_err_highs_mw": float(err.max()),
            "memory_analysis": mem_fields, "peak_bytes": peak}


def phase_nsq(out_dir: str, argv_extra=()) -> dict:
    """``nsq --control-variate`` on RTS-24 through the CLI until its beta
    target; EDNS against the reference artifact within 3 combined
    standard errors (the artifact is itself an MC estimate)."""
    from powersystemsreliabilityassessment.__main__ import main as cli
    r = cli(["nsq", "--control-variate", "--out", out_dir, *argv_extra])
    se = np.hypot(r["beta"] * r["edns"], REF_EDNS_BETA * REF_EDNS_MW)
    _check(np.isfinite(r["edns"]) and abs(r["edns"] - REF_EDNS_MW) <= 3 * se,
           f"nsq: EDNS {r['edns']:.4f} vs {REF_EDNS_MW} (3 se = "
           f"{3 * se:.4f})")
    return {"edns": r["edns"], "edns_3se": 3 * float(se),
            "ref_edns": REF_EDNS_MW, "lole": r["lole"],
            "ref_lole": REF_LOLE_HR_YR, "beta": r["beta"],
            "samples": r["samples"], "converged": r["converged"],
            "figures": r["figures"], "device": r["device"]}


def phase_seq(out_dir: str, years: int = 32, argv_extra=()) -> dict:
    from powersystemsreliabilityassessment.__main__ import main as cli
    r = cli(["seq", "--years", str(years), "--cov", "0", "--out", out_dir,
             *argv_extra])
    _check(r["years"] == years, f"seq: {r['years']} years run")
    _check(all(np.isfinite(r[k]) and r[k] >= 0
               for k in ("eens", "lole", "lolf")), "seq: indices")
    return {k: r[k] for k in ("eens", "lole", "lolf", "years", "figures")}


def phase_multiarea(years: int = 8) -> dict:
    """Two-area demo: ISOLATED vs INTERCONNECTED on the same draws; the
    interconnection can only lower total unserved energy."""
    from powersystemsreliabilityassessment.__main__ import main as cli
    r = cli(["multiarea", "--system", "demo", "--years", str(years)])
    iso = float(np.sum(r["isolated"]["eue"]))
    inter = float(np.sum(r["interconnected"]["eue"]))
    _check(np.isfinite(iso) and np.isfinite(inter)
           and inter <= iso + 1e-3, f"multiarea: EUE {inter} > {iso}")
    return {"eue_isolated": iso, "eue_interconnected": inter}


def phase_bench() -> dict:
    import runpy
    return runpy.run_path(os.path.join(REPO, "bench.py"))["main"]()


def phase_multichip(devices, per_card: int = 65_536, seq_years: int = 8,
                    hours: int | None = None) -> dict:
    """NSQ batch step and SEQ year-block step over a mesh of ``devices``
    vs the same per-device keys replayed one at a time on
    ``devices[0]``: counts equal, sums to 1e-5 relative."""
    n = len(devices)
    sys_ = build_system(cases.rts24(), COMPAT)
    mesh_n = meshlib.scenario_mesh(devices)
    mesh_1 = meshlib.scenario_mesh(devices[:1])
    key = jax.random.key(4)
    keys = meshlib.device_keys(key, n)
    hint = dcopf.calibrate_shed_hint(sys_)
    nsq = [hl2_nsq.make_nsq_batch_step(sys_, m, per_card, COMPAT, IPM,
                                       shed_hint=hint)
           for m in (mesh_n, mesh_1)]
    mom_n, over_n, _ = jax.device_get(nsq[0](key))
    peaks = [_peak_bytes(d) for d in devices]
    parts = [jax.device_get(nsq[1].from_keys(keys[d:d + 1]))
             for d in range(n)]
    mom_1 = jax.tree.map(lambda *a: np.sum(np.asarray(a, np.float64), 0),
                         *[p[0] for p in parts])
    over_1 = sum(int(p[1]) for p in parts)
    _check(int(over_n) == 0 and over_1 == 0, "multichip: NSQ overflow")
    worst = 0.0
    for name in mom_n._fields:
        a = np.asarray(getattr(mom_n, name), np.float64)
        b = np.asarray(getattr(mom_1, name), np.float64)
        if name in ("n", "sum_flag", "sum_flag_raw", "sum_comp_fail"):
            _check(np.array_equal(a, b), f"multichip: NSQ {name} differs")
        else:
            rel = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))
            _check(rel <= 1e-5, f"multichip: NSQ {name} rel {rel:.2e}")
            worst = max(worst, rel)

    hours = hours or COMPAT.hours_per_year_seq
    factors = load_profile.load_factors(hours, COMPAT.weekday_mode)
    mt = twostate.mean_times(cases.rts24())
    n_draws = chronological.default_num_draws(mt[:, 0], mt[:, 1], hours)
    seq = [hl2_seq.make_seq_batch_step(sys_, m, seq_years, COMPAT, IPM,
                                       hours, n_draws, 256, factors)
           for m in (mesh_n, mesh_1)]
    out_n = jax.device_get(seq[0](key))
    out_1 = [jax.device_get(seq[1].from_keys(keys[d:d + 1]))
             for d in range(n)]
    # (ens, plc, nlc, dlc, edns) are gathered per year in device order;
    # (nodal, comp_fail, loss_h, n_over, n_infeas) are psum-reduced.
    for i, name in enumerate(("ens", "plc", "nlc", "dlc", "edns", "nodal",
                              "comp_fail", "loss_h", "n_over",
                              "n_infeas")):
        a = np.asarray(out_n[i], np.float64)
        parts = [np.asarray(o[i], np.float64) for o in out_1]
        b = np.concatenate(parts) if i < 5 else np.sum(parts, axis=0)
        if name in ("nlc", "dlc", "comp_fail", "loss_h", "n_over",
                    "n_infeas"):
            _check(np.array_equal(a, b), f"multichip: SEQ {name} differs")
        else:
            rel = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))
            _check(rel <= 1e-5, f"multichip: SEQ {name} rel {rel:.2e}")
            worst = max(worst, rel)
    _check(int(out_n[8]) == 0, "multichip: SEQ overflow")
    return {"devices": n, "nsq_per_card": per_card,
            "seq_hour_states_per_card": seq_years * hours,
            "nsq_samples": int(mom_n.n), "seq_years": int(len(out_n[0])),
            "max_rel_diff": worst, "counts_equal": True,
            "peak_bytes_per_card": peaks}


class _CompileClock:
    """XLA compile seconds, summed from JAX's monitoring events."""

    def __init__(self):
        self.secs = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, secs, **_):
        if event == _BACKEND_COMPILE:
            self.secs += secs


def _run(clock: _CompileClock, name: str, fn, *args, **kw) -> dict:
    c0, t0 = clock.secs, time.perf_counter()
    out = fn(*args, **kw)
    out = {**out, "compile_s": clock.secs - c0,
           "wall_s": time.perf_counter() - t0}
    print(f"phase {name}: {json.dumps(out, default=str)}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: only the sharded NSQ/SEQ steps over four "
                         "GPUs and their one-GPU replay")
    args = ap.parse_args(argv)
    device.enable_compile_cache()
    clock = _CompileClock()
    _run(clock, "card", phase_card)
    if args.chips == 4:
        devs = jax.devices()
        _check(len(devs) == 4, f"--chips 4 needs 4 GPUs, found {len(devs)}")
        _run(clock, "multichip", phase_multichip, devs)
    else:
        out = os.path.join(REPO, "chiprun_out", "smoke")
        _run(clock, "golden", phase_golden)
        _run(clock, "hot_proportional", phase_hot_path, "proportional")
        _run(clock, "hot_lp", phase_hot_path, "lp", cmp_batch=16_384)
        _run(clock, "large_m", phase_large_m)
        _run(clock, "nsq", phase_nsq, os.path.join(out, "nsq"))
        _run(clock, "seq", phase_seq, os.path.join(out, "seq"))
        _run(clock, "multiarea", phase_multiarea)
        _run(clock, "bench", phase_bench)
    print(json.dumps({"ok": True, "device": device.jax_device()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
