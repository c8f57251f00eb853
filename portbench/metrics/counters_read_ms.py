"""Host ms of one ``Fleet.counters`` call (the port's
``hext.fleet.counters`` span): the host copy and a ``Counters`` a hart."""
from portbench import spans


def read(rec):
    return spans.per_call_ms("hext.fleet.counters", "host")
