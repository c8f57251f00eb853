"""Device ms a tick of the tick's two stores into the graph's static
buffers: the retire's in-place scatter of one memory word a hart
(``hext.retire.store``) and the copy back of every leaf but the memory
(``hext.graph.copy_back``)."""
from portbench import spans


def read(rec):
    return spans.stage_ms("hext.retire.store", "hext.graph.copy_back")
