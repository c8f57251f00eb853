"""PyTorch port of the two-stage paged KV cache ``repro.core.vmem``.

Same module layout as the reference: ``page_table`` (the two-stage tables,
``translate`` through the ``pagewalk`` kernel), ``allocator`` (the
``PagePool`` with per-tenant quotas) and ``kvcache`` (``PagedKVCache``,
decode attention through the ``paged_attention`` kernel).  JAX's gather
and scatter rules are in :mod:`repro_torch.indexing`.
"""
from repro_torch.core.vmem.page_table import TwoStageTable  # noqa: F401
from repro_torch.core.vmem.allocator import PagePool  # noqa: F401
from repro_torch.core.vmem.kvcache import PagedKVCache  # noqa: F401
