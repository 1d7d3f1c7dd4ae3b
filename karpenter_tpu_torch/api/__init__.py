from karpenter_tpu_torch.api import labels  # noqa: F401
from karpenter_tpu_torch.api.objects import (  # noqa: F401
    Container,
    DaemonSet,
    LabelSelector,
    Node,
    NodeSelectorRequirement,
    ObjectMeta,
    PersistentVolume,
    PersistentVolumeClaim,
    Pod,
    PodCondition,
    PodDisruptionBudget,
    StorageClass,
    Taint,
    Toleration,
    TopologySpreadConstraint,
)
from karpenter_tpu_torch.api.requirements import Requirements  # noqa: F401
from karpenter_tpu_torch.api.provisioner import (  # noqa: F401
    Constraints,
    Limits,
    Provisioner,
    ProvisionerSpec,
    ProvisionerStatus,
)
