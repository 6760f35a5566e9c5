"""The share of the nested-bottleneck tower's 1x1 convs that ran as the
program's 1x1 conv kernel: 100 x its ``launch.pointwise_conv`` counter (one
a conv call) over the blocks' 1x1 convs of every forward, two a block (its
``nbt_blocks`` counter, one a block a forward, whichever path runs), over
the run's process.  The heads' 1x1 convs are not the blocks' and not
counted.  A block's 1x1 conv back on cuDNN lowers it.  None where the
program counts no such blocks or has no such kernel."""


def read(r):
    if r.kind != "match":
        return None
    try:
        from hex_gym_env_tpu_torch.ops import cuda_lib
        from hex_gym_env_tpu_torch.utils import profiling
    except ImportError:
        return None
    if "pointwise_conv" not in getattr(cuda_lib, "KERNELS", ()):
        return None
    blocks = getattr(profiling, "counters", {}).get("nbt_blocks")
    if not blocks:
        return None
    return 100.0 * profiling.counters.get("launch.pointwise_conv", 0) / (2 * blocks)
