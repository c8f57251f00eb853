"""PyTorch port of the H-extension simulator ``repro.core.hext``.

Same module layout as the reference: ``programs`` (assembler + images),
``bits``, ``csr``, ``decode``, ``translate``, ``tlb``, ``trap``, ``isa``,
``machine`` (the tick), ``engine`` (the run loop) and ``sim`` (the typed
``HartState`` / ``Fleet`` API).
"""
