"""Multi-host (DCN) smoke test: two local CPU PROCESSES form one global mesh
via parallel.mesh.init_distributed (SURVEY.md §5.8 "cross-host via
jax.distributed over DCN"), run the full sharded pipeline, and the gathered
trajectory matches a single-process run.

Runs in child subprocesses: the distributed runtime must initialize before
any other jax usage, which cannot happen inside this already-initialized
test process.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

pytestmark = pytest.mark.heavy

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import os, sys
sys.path.insert(0, os.environ["FLUID_REPO"])
import jax
from gpufluidsimulator_tpu.parallel import mesh as meshmod

assert meshmod.init_distributed(), "distributed init returned False"
assert jax.process_count() == 2, jax.process_count()

import numpy as np
from gpufluidsimulator_tpu import scenes
from gpufluidsimulator_tpu.models import solver
from gpufluidsimulator_tpu.parallel import sharded

mesh = meshmod.make_mesh()          # global devices (2 procs x 2 = 4)
assert mesh.devices.size == 4, mesh.devices.size

params, state = scenes.dam_break(n=700, dim=2, jitter=0.2, seed=1)
params = params.replace(diagnostics=False)
sstate, m_cap = sharded.distribute_global(params, state, mesh)
out = sharded.run_sharded(sstate, params, mesh, n_steps=3, m_cap=m_cap)

from jax.experimental import multihost_utils
# tiled=True: the inputs are already global (device-leading) arrays
gpos = np.asarray(multihost_utils.process_allgather(out.pos, tiled=True))
gids = np.asarray(multihost_utils.process_allgather(out.ids, tiled=True))
govf = np.asarray(multihost_utils.process_allgather(out.overflow,
                                                    tiled=True))
gpos = gpos.reshape(-1, 2)
gids = gids.reshape(-1)
live = gids >= 0
assert live.sum() == state.n, (live.sum(), state.n)
order = np.argsort(gids[live])
got = gpos[live][order]

# single-process reference computed identically in every process
ref = solver.run(state, params, 3, method="pallas")
rorder = np.argsort(np.asarray(ref.ids))
rp = np.asarray(ref.pos)[rorder]
err = np.abs(got - rp).max()
assert err < 1e-5, err
assert govf.sum() == 0
if jax.process_index() == 0:
    print(f"MULTIHOST OK err={err:.2e}")
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_cpu_matches_single():
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update({
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
            "FLUID_COORDINATOR": f"127.0.0.1:{port}",
            "FLUID_NUM_PROCESSES": "2",
            "FLUID_PROCESS_ID": str(pid),
            "FLUID_REPO": _ROOT,
            "JAX_COMPILATION_CACHE_DIR": os.path.join(
                os.path.dirname(os.path.abspath(__file__)), ".jax_cache"),
        })
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _CHILD], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=900)
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"child failed rc={rc}\n{out}\n{err[-3000:]}"
    assert "MULTIHOST OK" in outs[0][1]
