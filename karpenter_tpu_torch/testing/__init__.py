"""Object factories and scenario generators for tests and the smoke run."""
from karpenter_tpu_torch.testing.factories import (  # noqa: F401
    hostname_spread,
    make_daemonset,
    make_pod,
    make_provisioner,
    zone_spread,
)
from karpenter_tpu_torch.testing.scenarios import (  # noqa: F401
    affinity_dense_pods,
    diverse_pods,
)
