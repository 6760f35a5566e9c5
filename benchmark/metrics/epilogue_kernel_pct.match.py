"""The share of a CNN forward's layers whose bias, BatchNorm and ReLU ran
as one launch of the program's hand-written epilogue kernel: 100 x its
``launch.cnn_epilogue`` counter over the conv layers of every forward
(``len(CONV_LAYERS)`` times the ``forwards`` counter, one a side each
ply, whichever path runs), over the run's process.  None where the program
counts no forwards; 0 where it has no such kernel."""


def read(r):
    if r.kind != "match":
        return None
    try:
        from hex_gym_env_tpu_torch.models.cnn import CONV_LAYERS
        from hex_gym_env_tpu_torch.utils import profiling
    except ImportError:
        return None
    counters = getattr(profiling, "counters", {})
    forwards = counters.get("forwards")
    if not forwards:
        return None
    return 100.0 * counters.get("launch.cnn_epilogue", 0) / (len(CONV_LAYERS) * forwards)
