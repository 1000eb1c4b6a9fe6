"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.  The CUDA sources live in ``repro_torch/csrc`` and build at first
use (:mod:`repro_torch.kernels._build`)."""
