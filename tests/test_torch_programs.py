"""The port's copy of the assembler and workloads builds the same images
as the reference's ``repro.core.hext.programs``, byte for byte."""
import numpy as np
import pytest

from repro.core.hext import programs as ref_programs
from repro_torch.core.hext import programs

NAMES = [w.name for w in ref_programs.WORKLOADS]
EXTRA = [w.name for w in ref_programs.WORKLOADS_EXTRA]


def _by_name(mod, name):
    return next(w for w in mod.WORKLOADS + mod.WORKLOADS_EXTRA
                if w.name == name)


@pytest.mark.parametrize("guest", [False, True], ids=["native", "guest"])
@pytest.mark.parametrize("name", NAMES)
def test_build_image_byte_identical(name, guest):
    a = ref_programs.build_image(_by_name(ref_programs, name), guest)
    b = programs.build_image(_by_name(programs, name), guest)
    assert a.dtype == b.dtype == np.uint64
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_build_image_nguest_byte_identical(n):
    # heterogeneous tenants, cycling through the workload list
    ref_w = [ref_programs.WORKLOADS[i % 9] for i in range(n)]
    port_w = [programs.WORKLOADS[i % 9] for i in range(n)]
    a = ref_programs.build_image_nguest(ref_w, timeslice=700)
    b = programs.build_image_nguest(port_w, timeslice=700)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("live", [(True, False, True), (False, True)])
def test_build_image_nguest_reserved_slots(live):
    ref_w = [ref_programs.WORKLOADS[i] if on else None
             for i, on in enumerate(live)]
    port_w = [programs.WORKLOADS[i] if on else None
              for i, on in enumerate(live)]
    np.testing.assert_array_equal(ref_programs.build_image_nguest(ref_w),
                                  programs.build_image_nguest(port_w))


@pytest.mark.parametrize("name", NAMES + EXTRA)
def test_goldens_equal(name):
    assert int(_by_name(programs, name).golden()) == \
        int(_by_name(ref_programs, name).golden())


@pytest.mark.parametrize("n", range(1, 9))
def test_sched_layout_equal(n):
    assert tuple(programs.sched_layout(n)) == \
        tuple(ref_programs.sched_layout(n))
