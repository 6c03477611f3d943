"""bn_device_ms.ppo: device ms an iteration of the BatchNorm layer's kernels (models/resnet.py):
torch's ``batch_norm_*`` kernels (and cuDNN's ``bn_fw_``/``bn_bw_``, which torch may choose for
float32) and the port's fused BatchNorm + add + ReLU kernels (``gym_bn_*``,
csrc/batch_norm.cu). None without a device trace or without such a kernel."""

BN_KERNELS = ("batch_norm", "bn_fw_", "bn_bw_", "gym_bn_")


def read(ctx):
    seconds = sum(ctx.op_seconds(k) for k in BN_KERNELS)
    if seconds <= 0 or ctx.units <= 0:
        return None
    return 1000.0 * seconds / ctx.units
