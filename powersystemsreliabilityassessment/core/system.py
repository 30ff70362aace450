"""Device-side system representation: a JAX pytree of struct-of-array data
plus precomputed topology matrices.

Replaces the reference's MATPOWER case struct + the dispatchable-load
transform (``nsqMain.m:117-153`` / ``Montecarlo_seq/dispaload.m:30-87``):
instead of appending "virtual generators" with negative output to a gen
table, load shedding is a first-class LP variable per load bus, and the
network is held as dense incidence/one-hot matrices so that per-scenario
constraint assembly is a masked broadcast, not a data-structure edit.

All electrical quantities are stored in per-unit (base ``base_mva``) as
float32, the evaluator's device precision.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from powersystemsreliabilityassessment.core.cases import CaseData
from powersystemsreliabilityassessment.models import twostate
from powersystemsreliabilityassessment.utils.config import CompatFlags


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "bus_pd", "gen_bus_onehot", "load_onehot", "load_pd", "incidence",
        "b_susceptance", "br_rate", "gen_pmax", "gen_pmin", "unavail",
        "mttf", "mttr", "always_up_nsq", "ptdf", "lodf", "br_transfer",
        "theta_bound",
    ],
    meta_fields=["name", "n_bus", "n_gen", "n_branch", "n_load", "base_mva"],
)
@dataclasses.dataclass(frozen=True)
class System:
    """Struct-of-arrays power system pytree (all data leaves are jnp arrays).

    Component vector convention: generators (n_gen) then branches
    (n_branch), matching the reference (nsqMain.m:90-93).
    """

    # Data leaves (jnp, float32, per-unit where electrical)
    bus_pd: jax.Array          # [nb] peak bus load, p.u.
    gen_bus_onehot: jax.Array  # [nb, ng] Cg: maps gen output to buses
    load_onehot: jax.Array     # [nb, nd] Cd: maps load-bus shed to buses
    load_pd: jax.Array         # [nd] peak load at load buses, p.u.
    incidence: jax.Array       # [nl, nb] +1 at from-bus, -1 at to-bus
    b_susceptance: jax.Array   # [nl] 1/x, p.u.
    br_rate: jax.Array         # [nl] flow limit, p.u.
    gen_pmax: jax.Array        # [ng] p.u.
    gen_pmin: jax.Array        # [ng] p.u.
    unavail: jax.Array         # [ncomp] steady-state unavailability
    mttf: jax.Array            # [ncomp] hours
    mttr: jax.Array            # [ncomp] hours
    always_up_nsq: jax.Array   # [ncomp] bool: pinned-up in NSQ sampling
    ptdf: jax.Array            # [nl, nb] intact-network power transfer
    #                            distribution factors (ref bus column 0)
    lodf: jax.Array            # [nl, nl] line-outage distribution factors;
    #                            column k is +inf-free only when outaging k
    #                            does NOT island the network
    br_transfer: jax.Array     # [nl, nl] a[l,k]: flow on l per unit
    #                            transfer across k (PTDF_l,fk - PTDF_l,tk)
    theta_bound: jax.Array     # [nb] per-bus |theta| bound, rad (vs the
    #                            gauge-fixed reference bus 0); see
    #                            build_system for the derivation

    # Static metadata
    name: str
    n_bus: int
    n_gen: int
    n_branch: int
    n_load: int
    base_mva: float

    @property
    def n_comp(self) -> int:
        return self.n_gen + self.n_branch

    @property
    def total_load_pu(self) -> jax.Array:
        return jnp.sum(self.load_pd)

    @property
    def load_bus_index(self) -> jax.Array:
        """[nd] int32 bus index of each load entry."""
        return jnp.argmax(self.load_onehot, axis=0).astype(jnp.int32)


def build_system(case: CaseData, compat: CompatFlags = CompatFlags(),
                 dtype=jnp.float32) -> System:
    """Compile raw case data into the device pytree."""
    nb, ng, nl = case.n_bus, case.n_gen, case.n_branch
    base = case.base_mva

    load_idx = np.flatnonzero(case.bus_pd != 0.0)
    nd = len(load_idx)

    cg = np.zeros((nb, ng))
    cg[case.gen_bus, np.arange(ng)] = 1.0
    cd = np.zeros((nb, nd))
    cd[load_idx, np.arange(nd)] = 1.0

    inc = np.zeros((nl, nb))
    inc[np.arange(nl), case.br_from] = 1.0
    inc[np.arange(nl), case.br_to] = -1.0

    u = twostate.unavailability(case)
    mt = twostate.mean_times(case)

    # Intact-network PTDF (float64 on host, once): flows = PTDF @ injections.
    # Used by the exact fast-path certificate in engines/dcopf.py for states
    # without branch outages; reference bus = bus 0.
    bsus = 1.0 / case.br_x
    b_bus = inc.T @ (bsus[:, None] * inc)
    b_red = b_bus[1:, 1:]
    ptdf = np.zeros((nl, nb))
    ptdf[:, 1:] = (bsus[:, None] * inc[:, 1:]) @ np.linalg.inv(b_red)

    # LODF for single-branch-outage certificates: a[l,k] = flow on l per
    # unit transfer across k; LODF[l,k] = a[l,k]/(1-a[k,k]). A column whose
    # outage islands the network (a_kk -> 1, e.g. RTS-24 line 7-8) is
    # marked unusable with a huge sentinel so its PTDF check always fails
    # and the state falls through to the LP.
    a = ptdf @ inc.T                      # [nl, nl]
    denom = 1.0 - np.diagonal(a)
    usable = np.abs(denom) > 1e-6
    lodf = np.where(usable[None, :], a / np.where(usable, denom, 1.0)[None, :],
                    1e6)
    np.fill_diagonal(lodf, -1.0)
    lodf = np.where(usable[None, :], lodf, 1e6)

    # Per-bus voltage-angle bound for the B-theta LP (the flat +-6 rad box
    # leaves near-null inter-area angle modes in the float32 normal
    # matrices of large tiled systems, stalling the IPM). With theta_0
    # gauge-fixed (its column is zeroed in build_state_lp), any feasible
    # flow pattern satisfies |theta_i| <= min-path sum of rate_l/b_l from
    # bus 0 (the angle difference can be evaluated along the cheapest
    # path), so that distance is a provably non-clipping bound for states
    # connected to the reference. Islanded buses only need SOME level in
    # the box (their island's internal spread obeys the same kind of
    # bound but on the reduced graph), hence the 2x margin + 0.5 rad
    # floor; the lane-quality guard catches any residual corner case.
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra

    w = (case.br_rate / base) * case.br_x        # rad per branch at rating
    adj = csr_matrix((np.concatenate([w, w]),
                      (np.concatenate([case.br_from, case.br_to]),
                       np.concatenate([case.br_to, case.br_from]))),
                     shape=(nb, nb))
    dist = dijkstra(adj, directed=False, indices=0)
    dist = np.where(np.isfinite(dist), dist, np.max(w) * nb)
    theta_bound = 2.0 * dist + 0.5

    always_up = np.zeros(case.n_comp, dtype=bool)
    if compat.sync_cond_always_up_nsq:
        always_up[: ng] = case.sync_cond_mask

    def dev(a):
        return jnp.asarray(a, dtype=dtype)

    return System(
        bus_pd=dev(case.bus_pd / base),
        gen_bus_onehot=dev(cg),
        load_onehot=dev(cd),
        load_pd=dev(case.bus_pd[load_idx] / base),
        incidence=dev(inc),
        b_susceptance=dev(1.0 / case.br_x),
        br_rate=dev(case.br_rate / base),
        gen_pmax=dev(case.gen_pmax / base),
        gen_pmin=dev(case.gen_pmin / base),
        unavail=dev(u),
        mttf=dev(mt[:, 0]),
        mttr=dev(mt[:, 1]),
        always_up_nsq=jnp.asarray(always_up),
        ptdf=dev(ptdf),
        lodf=dev(lodf),
        br_transfer=dev(a),
        theta_bound=dev(theta_bound),
        name=case.name,
        n_bus=nb,
        n_gen=ng,
        n_branch=nl,
        n_load=nd,
        base_mva=base,
    )
