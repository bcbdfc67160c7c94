"""The guard around CUDA-graph captures (``models/ocean/graphs.py``
``capturing``), on the CPU: it collects pending garbage before a capture
and holds the collector off during it, so that no graph of a dropped
model is destroyed in the middle of another capture (that ends the
capture with cudaErrorStreamCaptureInvalidated; the graph classes keep
only a weak reference to their model, so that no cycle holds graphs in
the first place).
"""

import gc
import weakref

from uvic_tpu_torch.models.ocean.graphs import capturing
from torch_threads import torch_one_thread  # noqa: F401  (autouse)


class _Holder:
    pass


def test_capturing_collects_cycles_first_and_holds_the_collector():
    a, b = _Holder(), _Holder()
    a.other, b.other = b, a               # a cycle, as model <-> graphs was
    dead = weakref.ref(a)
    del a, b
    was_enabled = gc.isenabled()
    with capturing():
        assert dead() is None             # collected before the capture
        assert not gc.isenabled()
    assert gc.isenabled() == was_enabled


def test_capturing_restores_a_disabled_collector():
    gc.disable()
    try:
        with capturing():
            assert not gc.isenabled()
        assert not gc.isenabled()
    finally:
        gc.enable()
