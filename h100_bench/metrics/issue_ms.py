"""Milliseconds a step that the host spent in the call of the step:
``fit.call`` or ``distill.call`` spans over their ``steps``. On a card
a call writes the static inputs and launches the graph's replay, so a
call that waits for the device to take more work counts that wait. Read
from the program's spans of the traced slice
(``fourier_feature_nets_torch.utils.tracing``); None from a program
without them."""

CALLS = ("fit.call", "distill.call")


def read(trace):
    if not trace.get("units"):
        return None
    try:
        from fourier_feature_nets_torch.utils.tracing import latest
    except ImportError:
        return None
    calls = [s for s in latest()[0] if s.name in CALLS]
    steps = sum(s.attrs["steps"] for s in calls)
    if not steps:
        return None
    return 1e3 * sum(s.seconds for s in calls) / steps
