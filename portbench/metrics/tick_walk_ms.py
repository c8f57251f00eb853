"""Device ms a tick of the page walks with their TLB fills, fetch side
and data side (``hext.fetch_walk`` + ``hext.data_walk``): the captured
tick runs both for every hart."""
from portbench import spans


def read(rec):
    return spans.stage_ms("hext.fetch_walk", "hext.data_walk")
