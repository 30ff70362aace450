"""Bulk power-system reliability assessment framework on JAX.

A JAX/XLA implementation, run on NVIDIA GPUs, of the capabilities of the
MATLAB+Julia reference suite ``Matrixeigs/PowerSystemsReliabilityAssessment``:

* HL1 generation adequacy ("copper sheet"): non-sequential and sequential
  Monte Carlo, analytical COPT convolution (probability and
  frequency-and-duration variants), load-forecast uncertainty, maintenance
  scheduling, energy-limited units, multi-area adequacy with tie-line
  constraints, tail-risk (VaR/CVaR) analysis.
* HL2 composite generation+transmission adequacy: non-sequential state
  sampling and sequential chronological Monte Carlo with a batched DC-OPF
  minimum-load-shedding evaluator (replacing MATPOWER/MIPS per-state solves),
  nodal indices and weak-point detection.

Design: scenarios are a sharded batch axis over a ``jax.sharding.Mesh``;
state sampling is vectorized counter-based PRNG; state evaluation is a
vmapped fixed-iteration primal-dual interior-point LP in B-theta form
(islanding-safe); index accumulation is ``psum`` over ICI with
coefficient-of-variation convergence control on host.
"""

__version__ = "0.1.0"

import jax as _jax

# Reduced-precision matmul defaults (bfloat16 inputs, or TF32 on NVIDIA
# GPUs) silently round integers like 265 -> 264 in one-hot scatters and
# add ~0.4% error to PTDF flow checks and IPM residuals. Reliability
# indices need exact bookkeeping: force full float32 matmul precision
# framework-wide. Its cost on the GPU is not measured yet (ROADMAP S4).
_jax.config.update("jax_default_matmul_precision", "highest")

from powersystemsreliabilityassessment.utils.config import (  # noqa: F401
    CompatFlags,
    IPMConfig,
    MCSConfig,
)

# Lazy top-level API (PEP 562): the study/engine entry points without
# importing the heavy modules (and triggering backend warm-up paths) at
# package-import time. ``import powersystemsreliabilityassessment
# as psra; psra.run_nsq_study(psra.cases.rts24())`` just works.
_LAZY = {
    "cases": "powersystemsreliabilityassessment.core.cases",
    "build_system":
        "powersystemsreliabilityassessment.core.system",
    "load_matpower_case":
        "powersystemsreliabilityassessment.core.matpower_io",
    "resolve_case":
        "powersystemsreliabilityassessment.core.matpower_io",
    "evaluate_states":
        "powersystemsreliabilityassessment.engines.dcopf",
    "evaluate_states_screened":
        "powersystemsreliabilityassessment.engines.dcopf",
    "run_nsq_study":
        "powersystemsreliabilityassessment.studies.hl2_nsq",
    "run_seq_study":
        "powersystemsreliabilityassessment.studies.hl2_seq",
}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(_LAZY[name])
        obj = mod if name == "cases" else getattr(mod, name)
        globals()[name] = obj
        return obj
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
