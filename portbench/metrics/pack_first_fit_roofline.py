"""pack_first_fit's share of its roofline (%): the least time of its
launches' own work (``roofline.v1_work`` and ``roofline.bound``) over their
device time in the traced stretch."""

from roofline import Capture

_capture = Capture(
    "pack_first_fit",
    event="pack_first_fit_kernel",
    patch=["karpenter_tpu_torch.solver.fused:pack_first_fit",
           "karpenter_tpu_torch.solver.pack_kernel:pack_first_fit"],
    counter="karpenter_tpu_torch.solver.pack_kernel:launches",
)
prepare, finish, read = _capture.prepare, _capture.finish, _capture.read
