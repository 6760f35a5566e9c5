"""The share of the match's policy forwards that ran as one launch of the
program's hand-written forward kernel: 100 x its ``launch.mlp_forward``
counter over its ``forwards`` counter (one a side each ply, whichever path
runs), over the run's process.  None where the program counts no
forwards."""


def read(r):
    if r.kind != "match":
        return None
    try:
        from hex_gym_env_tpu_torch.utils import profiling
    except ImportError:
        return None
    counters = getattr(profiling, "counters", {})
    forwards = counters.get("forwards")
    return 100.0 * counters.get("launch.mlp_forward", 0) / forwards if forwards else None
