"""bn_fused_share.ppo: the share of the BatchNorm layer's device time (``bn_device_ms.ppo``'s
kernels) spent in the port's fused BatchNorm + add + ReLU kernels (``gym_bn_*``,
csrc/batch_norm.cu) (%): how often the fused layer runs where torch's BatchNorm could. 0 where
only torch's kernels ran; None without a device trace or without a BatchNorm kernel."""

TORCH_KERNELS = ("batch_norm", "bn_fw_", "bn_bw_")
FUSED = "gym_bn_"


def read(ctx):
    fused = ctx.op_seconds(FUSED)
    total = fused + sum(ctx.op_seconds(k) for k in TORCH_KERNELS)
    if total <= 0:
        return None
    return 100.0 * fused / total
