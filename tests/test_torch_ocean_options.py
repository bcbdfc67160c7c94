"""The port's ocean options against ``uvic_tpu`` on the CPU, in float64:
the tracer schemes and mixing options (``tests/torch_option_runs.py``
has the set-up of ``tests/test_variants.py``).

Each option runs 4 steps in both packages from the same state, the
first a mixing step: t, u, psi0/psi1, ptd and ubar agree to 1e-9 of each
field's largest magnitude after every step, itt and nconv exactly.
With isopycnal mixing on, the Smagorinsky tracer mixing is not taken
(the reference's precedence in its tracer step); the momentum mixing is.
"""

import pytest
import torch

from torch_option_runs import assert_close, step_both

ISO = dict(isopycmix=True, gent_mcwilliams=True)
CASES = {
    "quicker": dict(tracer_advection="quicker"),
    "centered": dict(tracer_advection="centered"),
    "upstream": dict(tracer_advection="upstream"),
    "fct_dlm2": dict(fct_variant="dlm2"),
    "fct_3d": dict(fct_3d=True),
    "fct_dlm2_3d": dict(fct_variant="dlm2", fct_3d=True),
    "smagnl": dict(hmix="smagnl"),
    "biharmonic": dict(hmix="biharmonic", ambi=1.0e21, ahbi=5.0e20),
    "ppmix": dict(vmix="ppmix", aidif=0.0),
    "ncon": dict(convection="ncon"),
    "shortwave": dict(shortwave=True),
    "neptune": dict(neptune=True),
    "full_tensor": dict(full_tensor=True, **ISO),
    "isopycnal_smagnl": dict(hmix="smagnl", **ISO),
    "isopycnal_quicker": dict(tracer_advection="quicker", **ISO),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the steps are many small operations, which a
    thread pool slows down when other test processes share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", list(CASES))
def test_option_steps_match_jax(name):
    for n, (ref, got) in enumerate(step_both(CASES[name])):
        assert_close(ref, got, f"{name} step {n}")
