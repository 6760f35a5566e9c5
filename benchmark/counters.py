"""The program's own counters (``hex_gym_env_tpu_torch.utils.profiling``),
read in the run's process after the driver has returned, for the
``program_counter`` metrics.

The counters are always on and count over the whole run, the warm-up and
the checked matches included, so a reader divides by the program's
``matches`` counter.  A program that keeps no such counters gives None."""

from __future__ import annotations


def per_match(r, name: str):
    """Counter ``name`` per match over the run, where ``r`` is a match
    unit's readings and the program counted its matches."""
    if r.kind != "match":
        return None
    try:
        from hex_gym_env_tpu_torch.utils import profiling
    except ImportError:
        return None
    counters = getattr(profiling, "counters", {})
    matches = counters.get("matches")
    return counters.get(name, 0) / matches if matches else None
