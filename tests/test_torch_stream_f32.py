"""The slice end to end in float32: the port's stream executor vs the JAX
package's, behaviourally.

In float32 the stagnation exit sits at the rounding noise floor, so
iteration counts may differ between two differently-built programs; the
closed-loop BEHAVIOUR must agree, to the bounds the JAX package holds its
own two executors to (tests/test_stream.py): the same success pattern,
feasible solutions, the same plant trajectory to 2e-2.
"""
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_stream import jax_fleet, port_inputs, run_jax_stream, run_port_stream
from torch_shared import one_core_threads  # noqa: F401 (autouse)


def test_stream_matches_jax_stream_f32_behavioral():
    f = jax_fleet(jnp.float32)
    st_j, so_j = run_jax_stream(f, jnp.float32)
    st_t, so_t = run_port_stream(port_inputs(f, torch.float32), torch.float32)
    np.testing.assert_array_equal(so_t.success.numpy(), np.asarray(so_j.success))
    assert np.asarray(so_j.viol).max() < 1e-4 and float(so_t.viol.max()) < 1e-4
    for fld in ("q", "dq", "phi", "dphi", "pr_ref", "iw_ref", "sector"):
        np.testing.assert_allclose(
            getattr(st_t, fld).numpy().astype(np.float64),
            np.asarray(getattr(st_j, fld), np.float64),
            rtol=0, atol=2e-2, err_msg=f"EngineState.{fld} diverged")
