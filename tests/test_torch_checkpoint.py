"""The port's checkpoints and crash-safe training loop
(`repro_torch.checkpoint`, `repro_torch.runtime.fault.run_training`,
`StragglerMonitor`, `FaultInjector.check`), on the CPU, on the reduced
Qwen2-0.5B (float32) at batch 2, seq 16.

Counterparts of the reference's `tests/test_checkpoint_fault.py`, with
the same scenarios; the port's restart is held bit-identical (the CPU
step is deterministic), where the reference's test allows 1e-6. The
checkpoint layout is the reference's: `step_%08d/{arrays.npz,
manifest.json}`, and an optimizer state saved by each package has the
same leaf paths.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import save as ref_save
from repro.configs import get_config as ref_get_config
from repro.models.model import build_model as ref_build_model
from repro.runtime.train_lib import make_train_state as ref_make_train_state
from repro_torch.checkpoint import CheckpointManager, latest_step, restore, save
from repro_torch.configs import get_config
from repro_torch.core.tree import tree_paths
from repro_torch.data.tokens import lm_batch
from repro_torch.models import build_model
from repro_torch.runtime.fault import (
    FaultInjector,
    InjectedFault,
    StragglerMonitor,
    run_training,
)
from repro_torch.runtime.train_lib import make_train_state, make_train_step

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def small():
    cfg = get_config("qwen2-0.5b").reduced()
    return cfg, build_model(cfg, "cpu")


def fresh(model):
    return make_train_state(model, torch.Generator("cpu").manual_seed(0))


def leaves(tree, prefix=""):
    return dict(tree_paths(tree, prefix))


def assert_same(a, b):
    la, lb = leaves(a), leaves(b)
    assert sorted(la) == sorted(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype and torch.equal(la[k].detach(), lb[k].detach()), k


def test_save_restore_roundtrip(tmp_path, small):
    cfg, model = small
    state = fresh(model)
    state, _ = make_train_step(model)(state, lm_batch(cfg, batch=2, seq=16))
    save(str(tmp_path), 7, state, mesh_shape=(1, 1))
    assert latest_step(str(tmp_path)) == 7
    manifest = json.loads((tmp_path / "step_00000007" / "manifest.json").read_text())
    assert manifest == {"step": 7, "num_leaves": len(leaves(state)), "mesh_shape": [1, 1],
                        "complete": True}
    back = restore(str(tmp_path), 7, fresh(model), device="cpu")
    assert type(back).__name__ == "TrainState"
    assert_same(back, state)
    assert int(back.step) == 1 and back.step.dtype == torch.int32
    assert all(t.requires_grad for t in leaves(back.params).values())
    assert not back.opt["count"].requires_grad


def test_restore_refuses_another_shape(tmp_path, small):
    cfg, model = small
    save(str(tmp_path), 1, {"w": torch.zeros(3, 4)})
    with pytest.raises(ValueError, match="shape mismatch for w"):
        restore(str(tmp_path), 1, {"w": torch.zeros(4, 3)})
    with pytest.raises(ValueError, match="no leaf 'v'"):
        restore(str(tmp_path), 1, {"v": torch.zeros(3, 4)})


def test_optimizer_state_paths_are_the_references(tmp_path):
    """The same arch saved by each package: the optimizer state's leaf paths
    and shapes in arrays.npz are equal (the port's params are per layer,
    the reference's stacked)."""
    arch = "nemotron-4-340b"
    ref_state = ref_make_train_state(ref_build_model(ref_get_config(arch).reduced()),
                                     jax.random.PRNGKey(0))
    ref_save(str(tmp_path / "ref"), 1, ref_state)
    save(str(tmp_path / "port"), 1, fresh(build_model(get_config(arch).reduced(), "cpu")))

    def opt_leaves(d):
        with np.load(tmp_path / d / "step_00000001" / "arrays.npz") as z:
            return {k: z[k].shape for k in z.files if k.startswith("opt/")}
    assert opt_leaves("port") == opt_leaves("ref")


def test_torn_checkpoint_is_ignored(tmp_path, small):
    cfg, model = small
    save(str(tmp_path), 5, fresh(model))
    torn = tmp_path / "step_00000009"
    torn.mkdir()
    (torn / "manifest.json").write_text("{")          # truncated JSON
    (tmp_path / "step_00000011.tmp-123").mkdir()      # a write that never renamed
    assert latest_step(str(tmp_path)) == 5


def test_async_save_completes_and_later_updates_do_not_leak_in(tmp_path, small):
    """The snapshot is a copy taken before `save` returns: on the CPU
    `.cpu()` would share storage, and the in-place update right after
    would race the writer thread."""
    cfg, model = small
    state = fresh(model)
    want = {k: t.detach().clone() for k, t in leaves(state).items()}
    t = save(str(tmp_path), 3, state, blocking=False)
    with torch.no_grad():
        for leaf in leaves(state.params).values():
            leaf.add_(1.0)
    t.join()
    assert latest_step(str(tmp_path)) == 3
    back = leaves(restore(str(tmp_path), 3, fresh(model)))
    assert all(torch.equal(back[k].detach(), want[k]) for k in want)


def test_ckpt_manager_retention(tmp_path, small):
    cfg, model = small
    state = fresh(model)
    mgr = CheckpointManager(str(tmp_path), interval=1, keep=2)
    for step in range(1, 6):
        assert mgr.maybe_save(step, state)
    mgr.wait()
    kept = sorted(k for k in os.listdir(tmp_path) if k.startswith("step_"))
    assert kept == ["step_00000004", "step_00000005"]
    every2 = CheckpointManager(str(tmp_path / "every2"), interval=2)
    assert [every2.maybe_save(s, state) for s in (1, 2, 3)] == [False, True, False]
    every2.wait()


def run(model, cfg, ckpt_dir, inject=(), num_steps=10, max_restarts=10):
    losses = {}
    state = run_training(
        train_step=make_train_step(model),
        init_state=lambda: fresh(model),
        batch_fn=lambda s: lm_batch(cfg, batch=2, seq=16, step=s),
        num_steps=num_steps, ckpt=CheckpointManager(ckpt_dir, interval=5),
        mesh_shape=(1, 1), injector=FaultInjector(inject), max_restarts=max_restarts,
        on_metrics=lambda s, m: losses.__setitem__(s, float(m["loss"])))
    return state, losses


def test_injected_fault_restart_is_bit_identical(tmp_path, small):
    """Crash at step 7, restart from the step-5 checkpoint: the same losses
    and the same final state, byte for byte, as a clean run."""
    cfg, model = small
    s_clean, l_clean = run(model, cfg, str(tmp_path / "clean"))
    s_fault, l_fault = run(model, cfg, str(tmp_path / "fault"), inject=[7])
    assert l_fault == l_clean and len(l_clean) == 10
    assert_same(s_fault, s_clean)
    assert int(s_fault.step) == 10


def test_fault_budget_exhaustion_raises(tmp_path, small):
    cfg, model = small
    with pytest.raises(InjectedFault):
        run(model, cfg, str(tmp_path), inject=[1, 2, 3], num_steps=5, max_restarts=1)


def test_fault_injector_check_fires_once_per_step():
    inj = FaultInjector([2])
    inj.check(1)
    with pytest.raises(InjectedFault, match="step 2"):
        inj.check(2)
    inj.check(2)
    assert inj.fired == {2}


def test_straggler_monitor_flags_slow_steps():
    mon = StragglerMonitor(threshold=3.0)
    for i in range(10):
        mon.record(i, 0.1)
    mon.record(10, 0.95)
    mon.record(11, 0.25)
    assert [f[0] for f in mon.flagged] == [10]
    early = StragglerMonitor()
    for i in range(7):
        early.record(i, 0.1)
    early.record(7, 10.0)                  # fewer than 8 steps seen: no median yet
    assert early.flagged == []
