"""RMSNorm Hopper kernels (replace the Pallas ``repro.kernels.rmsnorm``):
the forward, its gradient, and the autograd Function of the two."""

from repro_torch.kernels.rmsnorm.kernel import (
    RmsNormFn,
    plan_rmsnorm,
    plan_rmsnorm_bwd,
    rms_norm_bwd_plain,
    rms_norm_plain,
    rmsnorm,
    rmsnorm_bwd,
)

__all__ = ["plan_rmsnorm", "plan_rmsnorm_bwd", "rmsnorm", "rms_norm_plain", "rmsnorm_bwd",
           "rms_norm_bwd_plain", "RmsNormFn"]
