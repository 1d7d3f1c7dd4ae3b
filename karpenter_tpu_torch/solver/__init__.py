"""The batch bin-pack solver on PyTorch: host-side signature encoding
(``signature``, ``encode``), the first-fit packing recurrence as a CUDA
kernel (``pack_kernel``, ``csrc/pack_first_fit.cu``) beside its plain
PyTorch version (``kernel``), the single-dispatch device solve (``fused``),
the card's unfused kernel ladder (``pack_kernel.pack_best``), the native
C++ packer (``native``, ``csrc/ffd_pack.cpp``), the measured-cost router a
``device="cpu"`` scheduler weighs it with (``router``) and the scheduler
backend (``backend``, whose ``pack_unfused`` holds the forced rungs)."""
