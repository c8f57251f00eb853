"""The benchmark's frozen reference: the assembler, the constants and
the pure-Python ISA model, importing nothing of ``repro_torch``."""
