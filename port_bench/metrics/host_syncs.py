"""Host waits on the card per unit, in any cell
(``host_syncs.<cell kind>``): the program's ``sync.<site>`` counters in
the attribution sub-window over its units. Each counts one place where the
host waited for the device's queue: a read to the host, a copy from
pageable host memory, a boolean-mask index."""

from port_bench import program_trace as PT


def read(run):
    evs, bounds = PT.events(), PT.attribution_bounds(run)
    if evs is None or bounds is None:
        return None
    return PT.counted(evs, "sync.", bounds) / run.traffic["trace"][
        "profile_units"]
