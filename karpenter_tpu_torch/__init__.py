"""karpenter-tpu on PyTorch and CUDA: the provisioning solve for an NVIDIA
Hopper GPU.

The package mirrors ``karpenter_tpu``'s layout (``api``, ``utils``,
``cloudprovider``, ``kube``, ``scheduling``, ``solver``, ``testing``) and
keeps its own copy of every module it needs; it imports ``torch`` and
``numpy``, never ``jax``. The packing recurrence runs in a hand-written
CUDA kernel (``solver/csrc/pack_first_fit.cu``); every other stage is host
Python or torch ops.

Entry point: ``scheduling.scheduler.Scheduler(cluster, device=...)``. Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``, and raise
when ``cuda`` is asked for and no card is present.
"""

__version__ = "0.1.0"
