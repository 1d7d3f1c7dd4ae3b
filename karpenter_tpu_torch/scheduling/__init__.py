from karpenter_tpu_torch.scheduling.ffd import VirtualNode, FFDScheduler  # noqa: F401
from karpenter_tpu_torch.scheduling.scheduler import Scheduler  # noqa: F401
