from karpenter_tpu_torch.cloudprovider.types import (  # noqa: F401
    CloudProvider,
    InstanceType,
    NodeRequest,
    Offering,
)
from karpenter_tpu_torch.cloudprovider.requirements import (  # noqa: F401
    catalog_requirements,
    compatible,
    filter_instance_types,
)
