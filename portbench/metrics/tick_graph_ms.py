"""Device ms of one captured tick from its first event to its last: the
kernels and the gaps between them (the port's ``hext.tick`` stage, timed
by events inside the graph, so dropped trace events do not move it)."""
from portbench import spans


def read(rec):
    return spans.stage_ms("hext.tick")
