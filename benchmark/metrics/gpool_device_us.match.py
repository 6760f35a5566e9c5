"""Device microseconds a nested-bottleneck forward spends in its trunk's
global poolings: the ``device_ms`` of the program's own ``forward.gpool``
spans (six a forward at 18 blocks: the three features over the board and
the dense layer to the bias) over the calls of ``ply.forward``, over the
matches the driver plays inside the program's tracing after the window.

None where the program keeps no ``forward.gpool`` span or its span table
has no device clock."""


def read(r):
    if r.kind != "match":
        return None
    spans = r.program_spans or {}
    gpool, forward = spans.get("forward.gpool"), spans.get("ply.forward")
    if not gpool or not forward or not forward["calls"] or gpool.get("device_ms") is None:
        return None
    return 1e3 * gpool["device_ms"] / forward["calls"]
