"""Mean milliseconds of a prefiller-to-decoder transfer in the window
(``TransferStats.total_wall_s / n_transfers``)."""


def read(run):
    c = run.counters
    if not c.get("transfers"):
        return None
    return c["transfer_wall_s"] / c["transfers"] * 1e3
