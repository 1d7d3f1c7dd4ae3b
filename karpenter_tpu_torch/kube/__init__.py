from karpenter_tpu_torch.kube.client import Cluster  # noqa: F401
