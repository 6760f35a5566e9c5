"""The share of the nested-bottleneck tower's 3x3 convs that ran as the
program's Winograd conv kernels: 100 x its ``launch.winograd_conv`` counter
(one a conv call) over the blocks' 3x3 convs of every forward, four a
block (its ``nbt_blocks`` counter, one a block a forward, whichever path
runs), over the run's process.  The input conv and the 1x1 convs are
cuDNN's by design and not counted.  A 3x3 conv back on cuDNN lowers it.
None where the program counts no such blocks or has no such kernel."""


def read(r):
    if r.kind != "match":
        return None
    try:
        from hex_gym_env_tpu_torch.ops import cuda_lib
        from hex_gym_env_tpu_torch.utils import profiling
    except ImportError:
        return None
    if "winograd_conv" not in getattr(cuda_lib, "KERNELS", ()):
        return None
    blocks = getattr(profiling, "counters", {}).get("nbt_blocks")
    if not blocks:
        return None
    return 100.0 * profiling.counters.get("launch.winograd_conv", 0) / (4 * blocks)
