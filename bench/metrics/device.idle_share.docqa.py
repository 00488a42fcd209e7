"""% of the traced slice in which no operation ran on the device: one
minus the union of every device operation's interval over the slice's
host seconds."""

from bench.readers import idle_share


def read(run):
    return idle_share(run)
