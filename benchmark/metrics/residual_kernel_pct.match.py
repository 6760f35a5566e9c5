"""The share of the residual tower's layers whose BatchNorm and ReLU (and,
in a block's second layer, the skip) ran as one launch of the program's
epilogue kernel: 100 x its ``launch.cnn_epilogue`` and
``launch.cnn_epilogue_residual`` counters over the tower's layers of every
forward, two a block (its ``residual_blocks`` counter, one a block a
forward, whichever path runs) and the input block (its ``forwards``
counter, one a side each ply), over the run's process.  None where the
program counts no residual blocks."""


def read(r):
    if r.kind != "match":
        return None
    try:
        from hex_gym_env_tpu_torch.utils import profiling
    except ImportError:
        return None
    counters = getattr(profiling, "counters", {})
    blocks, forwards = counters.get("residual_blocks"), counters.get("forwards")
    if not blocks or not forwards:
        return None
    launches = (counters.get("launch.cnn_epilogue", 0)
                + counters.get("launch.cnn_epilogue_residual", 0))
    return 100.0 * launches / (2 * blocks + forwards)
