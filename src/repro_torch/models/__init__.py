"""The port's model stack: the dense decoder-only serving path (prefill
and decode over a dense K/V cache) of ``repro.models``."""
