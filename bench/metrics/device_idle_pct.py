"""Share of the traced sub-window with no kernel running on the card:
the union of the device intervals in ``torch.profiler``'s trace against
the sub-window's host-clock length (%)."""


def read(run):
    if run.profile is None:
        return None
    p = run.profile
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
