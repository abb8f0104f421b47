"""RMSNorm Hopper kernel (replaces the Pallas ``repro.kernels.rmsnorm``)."""

from repro_torch.kernels.rmsnorm.kernel import plan_rmsnorm, rms_norm_plain, rmsnorm

__all__ = ["plan_rmsnorm", "rmsnorm", "rms_norm_plain"]
