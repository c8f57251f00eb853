"""Device ms a tick of the two whole-memory copies: the out-of-place
store scatter (``hext.retire.store``) and the copy back into the graph's
static buffers (``hext.graph.copy_back``)."""
from portbench import spans


def read(rec):
    return spans.stage_ms("hext.retire.store", "hext.graph.copy_back")
