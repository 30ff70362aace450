"""Built-in test systems as plain numpy data (host side).

The flagship case is the IEEE RTS-24 (1979 Reliability Test System, single
area): 24 buses, 33 generating units (incl. one synchronous condenser at
bus 14), 38 branches, 2850 MW system peak.

Network data follows the published IEEE RTS-79 tables (the reference loads
the equivalent MATPOWER ``case24_ieee_rts``; see reference
``Montecarlo_nsq_single/nsqMain.m:42``). Reliability parameters replicate the
reference data file ``Montecarlo_*/case24_failrate.m:23-78`` exactly (note:
that file deviates from the RTS-79 paper in a couple of branch repair
durations; we replicate the file, since it is what the baseline numbers were
produced with). The RTS-79 hierarchical load model replicates
``Montecarlo_seq/case24_loadprofile.m:18-95``.

Everything here is plain ``numpy`` — the JAX pytree view with derived
matrices is built by :mod:`..core.system`.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CaseData:
    """Raw case description (host-side, numpy).

    Component ordering convention (identical to the reference): the
    ``n_gen + n_branch`` component vector is generators first (in the order
    below) then branches. For RTS-24 this gives 71 components with the
    synchronous condenser at component index 14 (0-based; index 15 in the
    reference's 1-based MATLAB).
    """

    name: str
    base_mva: float
    # Buses -----------------------------------------------------------------
    bus_pd: np.ndarray          # [nb] peak active load, MW
    bus_qd: np.ndarray          # [nb] peak reactive load, MVAr
    # Generators ------------------------------------------------------------
    gen_bus: np.ndarray         # [ng] 0-based bus index
    gen_pmax: np.ndarray        # [ng] MW
    gen_pmin: np.ndarray        # [ng] MW
    gen_mttf: np.ndarray        # [ng] hours
    gen_mttr: np.ndarray        # [ng] hours
    gen_maint_weeks: np.ndarray  # [ng] scheduled maintenance weeks/yr
    # Branches ----------------------------------------------------------------
    br_from: np.ndarray         # [nl] 0-based bus index
    br_to: np.ndarray           # [nl] 0-based bus index
    br_x: np.ndarray            # [nl] reactance, p.u.
    br_rate: np.ndarray         # [nl] continuous rating, MW (MVA)
    br_lambda: np.ndarray       # [nl] permanent outage rate, occ/yr
    br_dur: np.ndarray          # [nl] outage duration, hours
    # Optional per-bus area assignment (0-based contiguous), from the
    # MATPOWER BUS_AREA column or a tiled construction; None when the
    # case carries no area structure. Consumed by
    # engines/multiarea.areas_from_case for the HL1.5 view.
    bus_area: np.ndarray | None = None

    @property
    def n_bus(self) -> int:
        return int(self.bus_pd.shape[0])

    @property
    def n_gen(self) -> int:
        return int(self.gen_bus.shape[0])

    @property
    def n_branch(self) -> int:
        return int(self.br_from.shape[0])

    @property
    def n_comp(self) -> int:
        return self.n_gen + self.n_branch

    @property
    def total_load(self) -> float:
        return float(self.bus_pd.sum())

    @property
    def sync_cond_mask(self) -> np.ndarray:
        """Boolean mask of zero-capacity units (synchronous condensers)."""
        return self.gen_pmax <= 0.0


def _f(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float64)


def _i(x) -> np.ndarray:
    return np.asarray(x, dtype=np.int32)


def rts24() -> CaseData:
    """IEEE RTS-24 single-area system with reference reliability data."""
    # Bus peak loads (RTS-79 Table 4 / case24_loadprofile.m:842-860). Buses
    # without entries carry zero load.
    nb = 24
    bus_pd = np.zeros(nb)
    bus_qd = np.zeros(nb)
    load_rows = [
        # bus (1-based), Pd, Qd
        (1, 108, 22), (2, 97, 20), (3, 180, 37), (4, 74, 15), (5, 71, 14),
        (6, 136, 28), (7, 125, 25), (8, 171, 35), (9, 175, 36), (10, 195, 40),
        (13, 265, 54), (14, 194, 39), (15, 317, 64), (16, 100, 20),
        (18, 333, 68), (19, 181, 37), (20, 128, 26),
    ]
    for b, p, q in load_rows:
        bus_pd[b - 1] = p
        bus_qd[b - 1] = q

    # Generating units, in the same order as the reference component vector
    # (MATPOWER case24_ieee_rts order; reliability rows from
    # case24_failrate.m:23-78).   (bus, Pmax, Pmin, MTTF, MTTR, maint_weeks)
    gen_rows = [
        (1, 20, 4.0, 450, 50, 2),       # U20
        (1, 20, 4.0, 450, 50, 2),
        (1, 76, 15.2, 1960, 40, 3),     # U76
        (1, 76, 15.2, 1960, 40, 3),
        (2, 20, 4.0, 450, 50, 2),
        (2, 20, 4.0, 450, 50, 2),
        (2, 76, 15.2, 1960, 40, 3),
        (2, 76, 15.2, 1960, 40, 3),
        (7, 100, 25.0, 1200, 50, 3),    # U100
        (7, 100, 25.0, 1200, 50, 3),
        (7, 100, 25.0, 1200, 50, 3),
        (13, 197, 69.0, 950, 50, 4),    # U197
        (13, 197, 69.0, 950, 50, 4),
        (13, 197, 69.0, 950, 50, 4),
        (14, 0, 0.0, 10000, 0.1, 0.1),  # synchronous condenser (component 15)
        (15, 12, 2.4, 2940, 60, 2),     # U12
        (15, 12, 2.4, 2940, 60, 2),
        (15, 12, 2.4, 2940, 60, 2),
        (15, 12, 2.4, 2940, 60, 2),
        (15, 12, 2.4, 2940, 60, 2),
        (15, 155, 54.25, 960, 40, 4),   # U155
        (16, 155, 54.25, 960, 40, 4),
        (18, 400, 100.0, 1100, 150, 6),  # U400
        (21, 400, 100.0, 1100, 150, 6),
        (22, 50, 10.0, 1980, 20, 2),    # U50 hydro
        (22, 50, 10.0, 1980, 20, 2),
        (22, 50, 10.0, 1980, 20, 2),
        (22, 50, 10.0, 1980, 20, 2),
        (22, 50, 10.0, 1980, 20, 2),
        (22, 50, 10.0, 1980, 20, 2),
        (23, 155, 54.25, 960, 40, 4),
        (23, 155, 54.25, 960, 40, 4),
        (23, 350, 140.0, 1150, 100, 5),  # U350
    ]
    gen_bus = _i([r[0] - 1 for r in gen_rows])
    gen_pmax = _f([r[1] for r in gen_rows])
    gen_pmin = _f([r[2] for r in gen_rows])
    gen_mttf = _f([r[3] for r in gen_rows])
    gen_mttr = _f([r[4] for r in gen_rows])
    gen_weeks = _f([r[5] for r in gen_rows])

    # Branches (RTS-79 Table 12 / MATPOWER case24_ieee_rts):
    # (from, to, x, rateA).  Reliability columns (lambda occ/yr, duration h)
    # appended from case24_failrate.m:62-78 in the same order.
    br_rows = [
        (1, 2, 0.0139, 175), (1, 3, 0.2112, 175), (1, 5, 0.0845, 175),
        (2, 4, 0.1267, 175), (2, 6, 0.1920, 175), (3, 9, 0.1190, 175),
        (3, 24, 0.0839, 400), (4, 9, 0.1037, 175), (5, 10, 0.0883, 175),
        (6, 10, 0.0605, 175), (7, 8, 0.0614, 175), (8, 9, 0.1651, 175),
        (8, 10, 0.1651, 175), (9, 11, 0.0839, 400), (9, 12, 0.0839, 400),
        (10, 11, 0.0839, 400), (10, 12, 0.0839, 400), (11, 13, 0.0476, 500),
        (11, 14, 0.0418, 500), (12, 13, 0.0476, 500), (12, 23, 0.0966, 500),
        (13, 23, 0.0865, 500), (14, 16, 0.0389, 500), (15, 16, 0.0173, 500),
        (15, 21, 0.0490, 500), (15, 21, 0.0490, 500), (15, 24, 0.0519, 500),
        (16, 17, 0.0259, 500), (16, 19, 0.0231, 500), (17, 18, 0.0144, 500),
        (17, 22, 0.1053, 500), (18, 21, 0.0259, 500), (18, 21, 0.0259, 500),
        (19, 20, 0.0396, 500), (19, 20, 0.0396, 500), (20, 23, 0.0216, 500),
        (20, 23, 0.0216, 500), (21, 22, 0.0678, 500),
    ]
    br_lambda = _f([
        0.24, 0.51, 0.33, 0.39, 0.48, 0.38, 0.02, 0.36, 0.34, 0.33, 0.30,
        0.44, 0.44, 0.02, 0.02, 0.02, 0.02, 0.40, 0.39, 0.40, 0.52, 0.49,
        0.38, 0.33, 0.41, 0.41, 0.41, 0.35, 0.34, 0.32, 0.54, 0.35, 0.35,
        0.38, 0.38, 0.34, 0.34, 0.45,
    ])
    br_dur = _f([
        16, 10, 10, 10, 10, 768, 10, 10, 35, 10, 10, 10,
        10, 768, 768, 768, 768, 11, 11, 11, 11, 11, 11, 11,
        11, 11, 11, 11, 11, 11, 11, 11, 11, 11, 11, 11, 11, 11,
    ])

    return CaseData(
        name="rts24",
        base_mva=100.0,
        bus_pd=bus_pd,
        bus_qd=bus_qd,
        gen_bus=gen_bus,
        gen_pmax=gen_pmax,
        gen_pmin=gen_pmin,
        gen_mttf=gen_mttf,
        gen_mttr=gen_mttr,
        gen_maint_weeks=gen_weeks,
        br_from=_i([r[0] - 1 for r in br_rows]),
        br_to=_i([r[1] - 1 for r in br_rows]),
        br_x=_f([r[2] for r in br_rows]),
        br_rate=_f([r[3] for r in br_rows]),
        br_lambda=br_lambda,
        br_dur=br_dur,
    )


def replicate_case(case: CaseData, n_areas: int, tie_rate: float = 500.0,
                   tie_x: float = 0.05) -> CaseData:
    """Scale a case up by tiling it into ``n_areas`` interconnected areas.

    Follows the IEEE RTS-96 construction principle (identical areas joined
    by a small set of inter-area ties). Each consecutive area pair is
    joined by two 230 kV tie lines anchored at strongly-connected buses
    (bus 13 of area i to bus 15 of area i+1, and bus 23 of area i to bus 17
    of area i+1) so the ties, not some internal radial line, bound the
    inter-area transfer — giving a connected multi-area system suitable
    for multi-chip scale-up studies.
    """
    nb = case.n_bus
    reps = range(n_areas)

    def tile_f(a):
        return np.concatenate([a for _ in reps])

    bus_pd = tile_f(case.bus_pd)
    bus_qd = tile_f(case.bus_qd)
    gen_bus = np.concatenate([case.gen_bus + k * nb for k in reps]).astype(np.int32)
    br_from = [case.br_from + k * nb for k in reps]
    br_to = [case.br_to + k * nb for k in reps]
    br_x = [case.br_x for _ in reps]
    br_rate = [case.br_rate for _ in reps]
    br_lambda = [case.br_lambda for _ in reps]
    br_dur = [case.br_dur for _ in reps]
    # Inter-area ties (ring topology when n_areas > 2).
    pairs = [(k, (k + 1) % n_areas) for k in range(n_areas if n_areas > 2 else 1)]
    for a, b in pairs:
        br_from.append(_i([a * nb + 12, a * nb + 22]))
        br_to.append(_i([b * nb + 14, b * nb + 16]))
        br_x.append(_f([tie_x, tie_x]))
        br_rate.append(_f([tie_rate, tie_rate]))
        br_lambda.append(_f([0.4, 0.4]))
        br_dur.append(_f([11.0, 11.0]))

    return CaseData(
        name=f"{case.name}x{n_areas}",
        base_mva=case.base_mva,
        bus_pd=bus_pd,
        bus_qd=bus_qd,
        bus_area=np.repeat(np.arange(n_areas, dtype=np.int64), nb),
        gen_bus=gen_bus,
        gen_pmax=tile_f(case.gen_pmax),
        gen_pmin=tile_f(case.gen_pmin),
        gen_mttf=tile_f(case.gen_mttf),
        gen_mttr=tile_f(case.gen_mttr),
        gen_maint_weeks=tile_f(case.gen_maint_weeks),
        br_from=np.concatenate(br_from).astype(np.int32),
        br_to=np.concatenate(br_to).astype(np.int32),
        br_x=np.concatenate(br_x),
        br_rate=np.concatenate(br_rate),
        br_lambda=np.concatenate(br_lambda),
        br_dur=np.concatenate(br_dur),
    )


def case300s() -> CaseData:
    """Synthetic 300-bus system ("case300-scale": MATPOWER case300 has 300
    buses / 411 branches, m = nb + nl = 711; this one has 300 / 492,
    m = 792 — the same solver regime: the large-m block-Schur LP path).

    The reference's solver path handles arbitrary MATPOWER cases via
    ``loadcase`` (README.md:47-49, nsqMain.m:42), but no public case at
    this scale ships reliability data (case300 has none), so this build —
    offline by construction — synthesizes the case instead of retrieving
    it. Synthesis rule (documented per VERDICT r1):

    * **12 RTS-24 areas** (buses 0..287): every bus/generator/branch
      parameter, including the reliability columns, is the published
      RTS-79 value replicated per area — reliability data stays exactly
      the per-unit-type data of ``case24_failrate.m``.
    * **12 backbone hub buses** (288..299, one per area, no load/gen),
      modeling a 345 kV interconnection ring: hub k joins its area at
      buses 13 and 23 (the strong 230 kV generation buses) with two
      500 MW links, and consecutive hubs are joined by a 1000 MW ring
      branch. Link reactances are 230/345 kV-typical (x = 0.05 / 0.03
      p.u. at 100 MVA); tie reliability uses the RTS-79 230 kV line
      class (lambda = 0.38/yr, 11 h repairs) — the same convention as
      :func:`rts96`'s estimated ties.

    Totals: 300 buses, 396 units (36,860 MW), 492 branches, 34,200 MW
    peak. Per-area adequacy matches RTS-24; the ring lets deficit areas
    import up to 1000 MW, so network-limited states exist but the system
    is far from radial — the same qualitative regime as case300.
    """
    base = rts24()
    nb = base.n_bus
    areas = 12
    nb_total = areas * nb + areas          # 288 + 12 hubs = 300

    def tile_f(a):
        return np.concatenate([a for _ in range(areas)])

    bus_pd = np.zeros(nb_total)
    bus_qd = np.zeros(nb_total)
    bus_pd[: areas * nb] = tile_f(base.bus_pd)
    bus_qd[: areas * nb] = tile_f(base.bus_qd)

    gen_bus = np.concatenate(
        [base.gen_bus + k * nb for k in range(areas)]).astype(np.int32)

    br_from = [base.br_from + k * nb for k in range(areas)]
    br_to = [base.br_to + k * nb for k in range(areas)]
    br_x = [base.br_x] * areas
    br_rate = [base.br_rate] * areas
    br_lambda = [base.br_lambda] * areas
    br_dur = [base.br_dur] * areas

    hub = lambda k: areas * nb + k
    # Area-to-hub links: bus 13 and bus 23 (1-based) of each area.
    for k in range(areas):
        br_from.append(_i([k * nb + 12, k * nb + 22]))
        br_to.append(_i([hub(k), hub(k)]))
        br_x.append(_f([0.05, 0.05]))
        br_rate.append(_f([500.0, 500.0]))
        br_lambda.append(_f([0.38, 0.38]))
        br_dur.append(_f([11.0, 11.0]))
    # 345 kV backbone ring.
    for k in range(areas):
        br_from.append(_i([hub(k)]))
        br_to.append(_i([hub((k + 1) % areas)]))
        br_x.append(_f([0.03]))
        br_rate.append(_f([1000.0]))
        br_lambda.append(_f([0.38]))
        br_dur.append(_f([11.0]))

    return CaseData(
        name="case300s",
        base_mva=base.base_mva,
        bus_pd=bus_pd,
        bus_qd=bus_qd,
        # Area labels: tile buses 0..287 -> their RTS-24 area, hub bus
        # 288+k -> area k (enables multi-area views and the area-gen
        # mixture sampler's gen_area_masks).
        bus_area=np.concatenate([
            np.repeat(np.arange(areas, dtype=np.int64), nb),
            np.arange(areas, dtype=np.int64)]),
        gen_bus=gen_bus,
        gen_pmax=tile_f(base.gen_pmax),
        gen_pmin=tile_f(base.gen_pmin),
        gen_mttf=tile_f(base.gen_mttf),
        gen_mttr=tile_f(base.gen_mttr),
        gen_maint_weeks=tile_f(base.gen_maint_weeks),
        br_from=np.concatenate(br_from).astype(np.int32),
        br_to=np.concatenate(br_to).astype(np.int32),
        br_x=np.concatenate(br_x),
        br_rate=np.concatenate(br_rate),
        br_lambda=np.concatenate(br_lambda),
        br_dur=np.concatenate(br_dur),
    )


def rts96() -> CaseData:
    """IEEE RTS-96 three-area system (Grigg et al., 1996).

    The 1996 update replicates the RTS-79 single area three times (areas
    A/B/C; buses renumbered 101-124 / 201-224 / 301-324, here 0-based
    0..71) and joins them with five inter-area AC ties: 107-203, 113-215,
    123-217, 223-318 and 325-121 (the paper's optional bus 25 / HVDC
    variants are not modeled). Tie endpoints follow the publication;
    impedance/rating/reliability parameters for the ties use values
    typical of their voltage class (this build is offline and cannot
    retrieve the paper's exact tie parameters; flows on ties are secondary
    for adequacy indices). Bus "325" maps to area C bus 23 (the paper
    inserts a new 230 kV bus 25 adjacent to 323; modeling the tie from
    323 preserves the area-C attachment point's electrical neighborhood).
    """
    base = rts24()
    nb = base.n_bus
    areas = 3

    def tile_f(a):
        return np.concatenate([a for _ in range(areas)])

    gen_bus = np.concatenate(
        [base.gen_bus + k * nb for k in range(areas)]).astype(np.int32)
    br_from = [base.br_from + k * nb for k in range(areas)]
    br_to = [base.br_to + k * nb for k in range(areas)]
    br_x = [base.br_x] * areas
    br_rate = [base.br_rate] * areas
    br_lambda = [base.br_lambda] * areas
    br_dur = [base.br_dur] * areas

    # Inter-area ties (1-based in-area bus numbers from the paper).
    #   (area_from, bus_from, area_to, bus_to, x, rate, lambda, dur)
    ties = [
        (0, 7, 1, 3, 0.042, 175.0, 0.40, 10.0),    # 107-203 (138 kV)
        (0, 13, 1, 15, 0.075, 500.0, 0.38, 11.0),  # 113-215 (230 kV)
        (0, 23, 1, 17, 0.074, 500.0, 0.38, 11.0),  # 123-217 (230 kV)
        (1, 23, 2, 18, 0.104, 500.0, 0.38, 11.0),  # 223-318 (230 kV)
        (2, 23, 0, 21, 0.087, 500.0, 0.38, 11.0),  # 325-121 (230 kV)
    ]
    br_from.append(_i([a * nb + (bf - 1) for a, bf, _, _, _, _, _, _ in ties]))
    br_to.append(_i([c * nb + (bt - 1) for _, _, c, bt, _, _, _, _ in ties]))
    br_x.append(_f([t[4] for t in ties]))
    br_rate.append(_f([t[5] for t in ties]))
    br_lambda.append(_f([t[6] for t in ties]))
    br_dur.append(_f([t[7] for t in ties]))

    return CaseData(
        name="rts96",
        base_mva=base.base_mva,
        bus_pd=tile_f(base.bus_pd),
        bus_qd=tile_f(base.bus_qd),
        bus_area=np.repeat(np.arange(areas, dtype=np.int64), nb),
        gen_bus=gen_bus,
        gen_pmax=tile_f(base.gen_pmax),
        gen_pmin=tile_f(base.gen_pmin),
        gen_mttf=tile_f(base.gen_mttf),
        gen_mttr=tile_f(base.gen_mttr),
        gen_maint_weeks=tile_f(base.gen_maint_weeks),
        br_from=np.concatenate(br_from).astype(np.int32),
        br_to=np.concatenate(br_to).astype(np.int32),
        br_x=np.concatenate(br_x),
        br_rate=np.concatenate(br_rate),
        br_lambda=np.concatenate(br_lambda),
        br_dur=np.concatenate(br_dur),
    )
