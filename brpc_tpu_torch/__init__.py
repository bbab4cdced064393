"""brpc_tpu_torch: the PyTorch/CUDA port of brpc_tpu, the device side of
the RPC framework, for an NVIDIA H100 (sm_90a).

Layers:
  - brpc_tpu_torch.parallel.collective_echo: the single-device echo step
    (frame checksum, length word, identity echo) and the mesh steps
    (ParallelChannel / PartitionChannel fan-out and the collective
    twins) on torch.distributed; brpc_tpu_torch.parallel.world starts
    the world of ranks they run in.
  - brpc_tpu_torch.device_path: framed payloads host -> device -> host
    through the C++ framework's staging ring (brpc_tpu_torch.native).
  - brpc_tpu_torch.kernels: the hand-written CUDA kernels and their
    plain PyTorch versions.
  - brpc_tpu_torch.infer_sched: the continuous micro-batching scheduler
    (pure Python).
  - brpc_tpu_torch.graft_entry: the entry points, `entry()` and
    `dryrun_multichip(n)`.

Importing the package creates no CUDA context and loads no shared
library; entry points take `device=None`, meaning CUDA, and never fall
back to the CPU unless asked with device="cpu".
"""

__version__ = "0.1.0"
