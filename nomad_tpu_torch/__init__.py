"""nomad_tpu_torch — the PyTorch/CUDA port of nomad_tpu.

A second package beside ``nomad_tpu`` (the JAX reference, which stays
as it is). Same layout and module names, so every module here has its
counterpart there; the dense placement programs of ``ops/`` run as
hand-written CUDA kernels for Hopper (``csrc/``) on CUDA tensors and as
their plain PyTorch versions on CPU tensors.

Entry points run on the CUDA device unless the caller asks for the CPU
(``nomad_tpu_torch.device.set_default_device("cpu")``). The package
imports torch and never jax, and nothing of ``nomad_tpu``.

Layering (mirrors nomad_tpu):
  structs/    data model (Job, Node, Allocation, Evaluation, Plan, ...)
  state/      MVCC in-memory state store with watch notifications
  scheduler/  host scheduler (the oracle) + the dense GPU factories
  models/     dense cluster-matrix construction (host numpy)
  ops/        placement programs over torch tensors + kernel wrappers
  csrc/       the CUDA C++ kernels (sm_90a)
"""

__version__ = "0.1.0"
