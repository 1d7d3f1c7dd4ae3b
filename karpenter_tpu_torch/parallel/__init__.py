"""The multi-solve over a ``data × model`` mesh of devices
(``sharding.sharded_multi_solve``)."""

from karpenter_tpu_torch.parallel.sharding import (  # noqa: F401
    SolverMesh,
    make_solver_mesh,
    sharded_multi_solve,
)
