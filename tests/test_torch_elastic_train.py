"""Sharded checkpoints and the elastic re-mesh restore
(`repro_torch.checkpoint` on a sharded state, `runtime.elastic.
remesh_restore` / `state_shardings`), on gloo ranks on the CPU.

The semantics of the reference's `test_elastic_restore_across_meshes` and
`test_remesh_restore_after_mesh_shrink` (whose sharded steps fail under
this JAX: ROADMAP R12): reduced Qwen2-0.5B, batch 8 x seq 32, one step on
a (2, 2) mesh from the seeded state, a checkpoint at step 1, and a second
step. The checkpoint is restored onto (4, 1) and onto (1, 1) (each a run
of its own ranks) and steps once more: the loss must equal the
uninterrupted (2, 2) run's within the reference's rtol 2e-5. A
checkpoint holds whole arrays: its keys, shapes and bytes do not depend on
the mesh that wrote it (the (2, 2) one, each restored run's, and one
process's unmeshed save of the same state).
"""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_train_mesh import BATCH, run_ranks

from repro_torch.checkpoint import latest_step, save
from repro_torch.configs import get_config
from repro_torch.data.tokens import lm_batch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model
from repro_torch.runtime.elastic import abstract_train_state, remesh_restore
from repro_torch.runtime.train_lib import make_train_state, make_train_step

torch.set_num_threads(1)

LOSS_RTOL = 2e-5
MODULE = "test_torch_elastic_train"


def config():
    return get_config("qwen2-0.5b").reduced()


def first_run(ckpt_dir: str, out: str) -> None:
    """(rank worker) on (2, 2): step 0, checkpoint at 1, step 1."""
    cfg = config()
    model = build_model(cfg, "cpu")
    mesh = make_host_mesh(data=2, model=2)
    step = make_train_step(model, mesh=mesh)
    state = make_train_state(model, torch.Generator("cpu").manual_seed(0), mesh)
    state, _ = step(state, lm_batch(cfg, **BATCH, step=0))
    save(ckpt_dir, 1, state, mesh_shape=tuple(mesh.shape))
    state, metrics = step(state, lm_batch(cfg, **BATCH, step=1))
    if dist.get_rank() == 0:
        torch.save(float(metrics["loss"]), out)


def restored_run(ckpt_dir: str, resave_dir: str, out: str, shape: tuple[int, int]) -> None:
    """(rank worker) restore the newest checkpoint onto `shape`, save it
    again from this mesh, and step."""
    cfg = config()
    model = build_model(cfg, "cpu")
    mesh = make_host_mesh(data=shape[0], model=shape[1])
    step_n, state = remesh_restore(ckpt_dir, abstract_train_state(cfg), cfg, mesh,
                                   multi_pod=False)
    assert step_n == 1 and int(state.step) == 1
    save(resave_dir, 1, state, mesh_shape=tuple(mesh.shape))
    _, metrics = make_train_step(model, mesh=mesh)(state, lm_batch(cfg, **BATCH, step=1))
    if dist.get_rank() == 0:
        torch.save(float(metrics["loss"]), out)


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic")
    ckpt, out = str(tmp / "ckpt_2x2"), str(tmp / "loss.pt")
    run_ranks(tmp, 4, f"m.first_run({ckpt!r}, {out!r})", module=MODULE)
    assert latest_step(ckpt) == 1
    return ckpt, torch.load(out)


def arrays(ckpt_dir: str) -> dict:
    with np.load(os.path.join(ckpt_dir, "step_00000001", "arrays.npz")) as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("shape", ((4, 1), (1, 1)), ids=("4x1", "1x1"))
def test_remesh_restore_continues_the_run(tmp_path, uninterrupted, shape):
    ckpt, want = uninterrupted
    resave, out = str(tmp_path / "resaved"), str(tmp_path / "loss.pt")
    run_ranks(tmp_path, shape[0] * shape[1],
              f"m.restored_run({ckpt!r}, {resave!r}, {out!r}, {shape!r})", module=MODULE)
    np.testing.assert_allclose(torch.load(out), want, rtol=LOSS_RTOL)
    a, b = arrays(ckpt), arrays(resave)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k], b[k]), k


def test_checkpoint_does_not_depend_on_the_mesh(tmp_path, uninterrupted):
    """The (2, 2) checkpoint against one process's save of an unmeshed
    state: the same keys, shapes and dtypes; the manifest records the
    mesh."""
    import json
    ckpt, _ = uninterrupted
    model = build_model(config(), "cpu")
    plain = make_train_state(model, torch.Generator("cpu").manual_seed(0))
    save(str(tmp_path), 1, plain, mesh_shape=(1, 1))
    a, b = arrays(ckpt), arrays(str(tmp_path))
    assert sorted(a) == sorted(b)
    assert all(a[k].shape == b[k].shape and a[k].dtype == b[k].dtype for k in a)
    manifest = json.load(open(os.path.join(ckpt, "step_00000001", "manifest.json")))
    assert manifest["mesh_shape"] == [2, 2] and manifest["num_leaves"] == len(a)


def test_remesh_restore_without_a_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        remesh_restore(str(tmp_path), None, config(), None, multi_pod=False)
