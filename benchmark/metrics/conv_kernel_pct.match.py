"""The share of the residual tower's block convs that ran as the program's
Winograd conv kernels: 100 x its ``launch.winograd_conv`` counter (one a
conv call) over the blocks' convs of every forward, two a block (its
``residual_blocks`` counter, one a block a forward, whichever path runs),
over the run's process.  The input conv (1 -> C) is not a block's and is
not counted.  None where the program counts no residual blocks or has no
such kernel."""


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
    blocks = getattr(profiling, "counters", {}).get("residual_blocks")
    if not blocks:
        return None
    return 100.0 * profiling.counters.get("launch.winograd_conv", 0) / (2 * blocks)
