"""gpufluidsimulator_tpu — an SPH fluid simulation framework in JAX.

A JAX/XLA/Pallas rebuild of the capabilities of the CUDA reference
``oadrian/GPUFluidSimulator`` (see SURVEY.md), running on NVIDIA GPUs (and
on the CPU for tests): WCSPH with poly6/spiky kernels, uniform-grid
neighbor search on a fixed-capacity cell table, fused Triton density/force
sweeps, whole-trajectory ``lax.scan`` stepping, spatial ``shard_map``
sharding with ``ppermute`` halo exchange, and a device-side point-splat
renderer replacing the OpenGL path.
"""

__version__ = "0.1.0"

from .models.params import SimParams           # noqa: F401
from .models.state import State, make_state    # noqa: F401
from .models import scenes                     # noqa: F401
from .models.solver import FluidSim, run, step, rollout  # noqa: F401
