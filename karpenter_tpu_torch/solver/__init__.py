"""The batch bin-pack solver on PyTorch: host-side signature encoding
(``signature``, ``encode``), the first-fit packing recurrence as a CUDA
kernel (``pack_kernel``, ``csrc/pack_first_fit.cu``) beside its plain
PyTorch version (``kernel``), the single-dispatch device solve (``fused``)
and the scheduler backend (``backend``)."""
