"""kafka_assignment_optimizer_tpu_torch — the Kafka partition-reassignment
optimizer on an NVIDIA GPU, in PyTorch with hand-written CUDA kernels.

The port of ``kafka_assignment_optimizer_tpu`` (JAX + Pallas), module for
module at the same relative paths, held against it in the tests. This
package imports neither JAX nor the reference package.

- ``models``  — cluster/assignment model, the solver-neutral instance
- ``solvers`` — the exact host backends (``milp``, ``native``, ``lp_solve``)
  and the annealing engine (the race, the ladder on the card, selection)
- ``decompose`` — the map-reduce solve over a cluster's AZs
- ``resilience`` — the deadline budget, the chaos harness, the
  degradation ladder
- ``watch``   — the cluster watch: events, the plan store, the manager,
  and the warm-start adaptation of the delta API
- ``obs``     — structured log lines, solve traces, flight records
- ``analysis`` — ``kao-check`` (lint rules, runtime contracts), the runtime
  sanitizer and the lock sanitizer
- ``serve``   — the HTTP service (``python -m ...serve``)
- ``native``  — the bundled C++ sources (built with g++ at first use)
- ``ops``     — scoring in plain PyTorch, and the CUDA kernels' wrappers
- ``csrc``    — the CUDA C++ kernel sources (built with nvcc at first use)
- ``prng``    — threefry2x32 random bits, equal to the reference's
"""

from .api import (  # noqa: F401
    OptimizeResult,
    evaluate,
    optimize,
    optimize_batch,
    optimize_delta,
)
from .models.cluster import (  # noqa: F401
    Assignment,
    MoveReport,
    PartitionAssignment,
    Topology,
    move_diff,
    parse_broker_list,
)
from .models.instance import ProblemInstance, build_instance  # noqa: F401

__version__ = "0.1.0"
