"""`repro_torch.optim.grad_compress.shard_map_allreduce_i8` over 8 gloo
ranks against the reference's over 8 host devices, on the CPU.

The reference runs in a subprocess with
`XLA_FLAGS=--xla_force_host_platform_device_count=8` (its own test fails
only in its indexing of the result: ROADMAP R12), on `default_rng(0)`'s
(64, 16) float32 normal draws, rows split 8 a shard over a ("data",)
mesh. Each port rank takes the same 8 rows. The ranks agree on one
scale, and the int8 sum is exact in int32, so every rank's rows must
equal the reference's to the byte.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import torch
import torch.distributed as dist
from test_torch_train_mesh import SRC, run_ranks

from repro_torch.optim.grad_compress import shard_map_allreduce_i8

WORLD = 8


def data() -> np.ndarray:
    return np.random.default_rng(0).normal(size=(64, 16)).astype(np.float32)


def rank_mean(out: str) -> None:
    """(rank worker) this rank's rows through the int8 all-reduce."""
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("data",))
    r = dist.get_rank()
    got = shard_map_allreduce_i8(torch.from_numpy(data()[8 * r:8 * (r + 1)]), mesh, "data")
    rows = [None] * WORLD
    dist.all_gather_object(rows, got.numpy())
    if r == 0:
        np.save(out, np.concatenate(rows))


def test_int8_allreduce_is_the_reference_byte_for_byte(tmp_path):
    ref_out = str(tmp_path / "ref.npy")
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    code = textwrap.dedent(f"""
        import jax, jax.numpy as jnp, numpy as np
        from repro.optim.grad_compress import shard_map_allreduce_i8
        assert len(jax.devices()) == 8
        mesh = jax.make_mesh((8,), ('data',))
        x = jnp.asarray(np.random.default_rng(0).normal(size=(64, 16)).astype(np.float32))
        np.save({ref_out!r}, np.asarray(shard_map_allreduce_i8(x, mesh, 'data')))
    """)
    ref = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert ref.returncode == 0, ref.stderr
    out = str(tmp_path / "port.npy")
    run_ranks(tmp_path, WORLD, f"m.rank_mean({out!r})", module="test_torch_allreduce_i8")
    got, want = np.load(out), np.load(ref_out)
    assert got.shape == want.shape == (64, 16) and got.dtype == want.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    mean = data().reshape(8, 8, 16).mean(0)
    for r in range(WORLD):          # every rank holds the mean, within the int8 step
        assert np.array_equal(got[8 * r:8 * (r + 1)], got[:8])
    assert float(np.abs(got[:8] - mean).max() / np.abs(mean).max()) < 0.05
