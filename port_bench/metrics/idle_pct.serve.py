"""Share of the traced window in which no kernel, copy or memset ran on the
device (the union of their intervals), in %."""

from port_bench.metrics._device import idle_pct


def read(r):
    return idle_pct(r)
