"""RMSNorm Hopper kernel (replaces the Pallas ``repro.kernels.rmsnorm``)."""

from repro_torch.kernels.rmsnorm.kernel import rms_norm_plain, rmsnorm

__all__ = ["rmsnorm", "rms_norm_plain"]
