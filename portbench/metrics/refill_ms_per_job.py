"""Device ms of one refill: the clones of one ``Fleet.replace_hart`` call
(the port's ``hext.fleet.replace_hart`` span, timed by events on the
stream), the mean over the traced part's refills."""
from portbench import spans


def read(rec):
    return spans.per_call_ms("hext.fleet.replace_hart", "device")
