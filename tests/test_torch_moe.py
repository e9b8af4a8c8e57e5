"""The port's MoE layer (`repro_torch.models.moe`) against the JAX
package's (`repro.models.moe`), on the CPU.

Both packages take the same numpy inputs: gates and activations made from
seeds with numpy, weights from the reference's `moe_init` at
`jax.random.PRNGKey(0)`, carried across as numpy arrays. Configs are the
reduced deepseek-v3-671b and kimi-k2-1t-a32b (float32, 8 experts, top 2,
chunk 16), and deepseek-v3-671b's own routing (256 experts, top 8).

Tolerances, and why:
  * `_dispatch_combine` is byte-equal: its slots are integer work (the
    cumsum positions, the capacity, the drops) and its combine weights
    are the same float32 divisions of the same picks. The order of equal
    gates decides which token takes a slot, so the padding rows' exact
    ties (every gate 1/E) are part of the check.
  * `moe_block` output: rtol 1e-4 / atol 1e-5 under `exact` (the LM
    forward's tolerance in `test_torch_lm.py`): each library's softmax exp
    and its einsum contraction order differ in the last bit. Under a
    quantized method (the shared experts' `dense` calls) max |diff| <=
    the LM forward's QUANT_TOL x max |reference|.
  * the aux loss: rtol 1e-6 (float32 means and a sum over the experts,
    each library in its own order).
  * The grouped expert einsum against one einsum over every expert:
    byte-equal (the same batched matmul of each expert's slots).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import moe as ref_moe
from repro_torch.configs import get_config
from repro_torch.models import moe

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
QUANT_TOL = {"mitchell": 5e-2, "karatsuba_int16": 5e-3}
MOE_ARCHS = ("deepseek-v3-671b", "kimi-k2-1t-a32b")


def cfgs(arch: str, **changes):
    """(reference cfg, port cfg): the reduced config of `arch` with
    `changes`."""
    return (dataclasses.replace(ref_get_config(arch).reduced(), **changes),
            dataclasses.replace(get_config(arch).reduced(), **changes))


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(np.asarray(tree)))


def gates_of(logits: np.ndarray) -> np.ndarray:
    """float32 softmax rows, computed once in numpy and given to both."""
    z = np.exp(logits - logits.max(-1, keepdims=True))
    return (z / z.sum(-1, keepdims=True)).astype(np.float32)


def check_dispatch(gates: np.ndarray, top_k: int, capacity: int) -> tuple:
    want = ref_moe._dispatch_combine(jnp.asarray(gates), top_k, capacity)
    got = moe._dispatch_combine(torch.from_numpy(gates), top_k, capacity)
    for name, g, w in zip(("dispatch", "combine"), got, want):
        assert g.dtype == torch.float32, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    return got


# ------------------------------------------------------------- dispatch

@pytest.mark.parametrize("t,e,top_k,capacity", [
    (16, 8, 2, 4),            # the reduced configs' chunk
    (16, 8, 2, 1),            # one slot an expert
    (4, 256, 8, 1),           # deepseek-v3's decode chunk (capacity 1)
    (128, 256, 8, 5),         # deepseek-v3's prefill chunk (batch 4 x 32)
])
@pytest.mark.parametrize("seed", (0, 1))
def test_dispatch_combine_is_byte_equal_for_random_gates(t, e, top_k, capacity, seed):
    gates = gates_of(np.random.default_rng(seed).standard_normal((t, e)).astype(np.float32))
    dispatch, _ = check_dispatch(gates, top_k, capacity)
    assert float(dispatch.sum(2).max()) <= 1.0          # one slot a pick at most


@pytest.mark.parametrize("e,top_k", ((8, 2), (256, 8)))
def test_dispatch_combine_resolves_ties_as_the_reference(e, top_k):
    """A chunk whose last rows are padding (gates all 1/E, exact ties) and
    whose real rows repeat gate values. With room for every pick, the
    padding rows' picks are the lowest expert indices; with 2 slots an
    expert, which tie wins decides which tokens keep their slots."""
    rng = np.random.default_rng(5)
    logits = rng.integers(0, 3, (16, e)).astype(np.float32)      # repeated values
    logits[12:] = 0.0                                             # padding rows
    gates = gates_of(logits)
    assert (gates[12:] == np.float32(1.0 / e)).all()
    check_dispatch(gates, top_k, 2)
    dispatch, _ = check_dispatch(gates, top_k, 16 * top_k)
    picked = dispatch[12:].sum(2).numpy()
    assert (picked[:, :top_k] == 1).all() and (picked[:, top_k:] == 0).all()


@pytest.mark.parametrize("cf", (0.25, 0.5))
def test_dispatch_combine_drops_past_the_capacity_as_the_reference(cf):
    t, e, top_k = 16, 8, 2
    capacity = max(1, int(t * top_k * cf / e))
    gates = gates_of(np.random.default_rng(7).standard_normal((t, e)).astype(np.float32) * 3)
    dispatch, combine = check_dispatch(gates, top_k, capacity)
    assert float(dispatch.sum()) < t * top_k                    # tokens were dropped
    assert int((dispatch.sum((0, 2)) <= capacity).sum()) == e


# ---------------------------------------------------------------- block

def block_inputs(arch: str, t: int, method: str = "exact", **changes):
    ref_cfg, cfg = cfgs(arch, matmul_method=method, **changes)
    ref_p = ref_moe.moe_init(jax.random.PRNGKey(0), ref_cfg)
    x = np.random.default_rng(3).standard_normal((2, t // 2, cfg.d_model)).astype(np.float32)
    return ref_cfg, cfg, ref_p, to_torch(jax.tree.map(np.asarray, ref_p)), x


@pytest.mark.parametrize("t", (30, 32))             # chunk 16: padded, not padded
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_block_matches_the_reference(arch, t):
    ref_cfg, cfg, ref_p, p, x = block_inputs(arch, t)
    want, want_aux = ref_moe.moe_block(ref_p, jnp.asarray(x), ref_cfg)
    got, aux = moe.moe_block(p, torch.from_numpy(x), cfg)
    assert got.shape == x.shape and aux.dtype == torch.float32 and aux.dim() == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)


@pytest.mark.parametrize("method", ("mitchell", "karatsuba_int16"))
def test_moe_block_shared_experts_quantized_match_the_reference(method):
    ref_cfg, cfg, ref_p, p, x = block_inputs("deepseek-v3-671b", 30, method)
    want, want_aux = ref_moe.moe_block(ref_p, jnp.asarray(x), ref_cfg)
    got, aux = moe.moe_block(p, torch.from_numpy(x), cfg)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= QUANT_TOL[method] * np.abs(want).max()
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)


def test_moe_block_with_a_small_capacity_factor_matches_the_reference():
    """capacity_factor 0.5: 2 slots an expert for 32 picks a chunk, so
    tokens are dropped (their routed output is 0)."""
    ref_cfg, cfg, ref_p, p, x = block_inputs("deepseek-v3-671b", 30, capacity_factor=0.5)
    want, want_aux = ref_moe.moe_block(ref_p, jnp.asarray(x), ref_cfg)
    got, aux = moe.moe_block(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)


# -------------------------------------------------------- expert groups

@pytest.mark.parametrize("group", (1, 3, 8))
def test_grouped_expert_einsum_equals_one_einsum_over_every_expert(group, monkeypatch):
    """Groups of 1, 3 (ragged: 3 + 3 + 2) and all 8 experts give the same
    bytes as the reference's single einsum over the stack, experts with no
    dispatched token (zeros in, zeros out) included."""
    _, cfg, _, p, _ = block_inputs("deepseek-v3-671b", 32)
    rng = np.random.default_rng(11)
    xe = torch.from_numpy(rng.standard_normal((8, 4, cfg.d_model)).astype(np.float32))
    xe[5:] = 0.0                                      # experts 5-7 received no token
    full_h = torch.einsum("ecd,edf->ecf", xe, p["wi"])
    full_g = torch.einsum("ecd,edf->ecf", xe, p["wg"])
    want = torch.einsum("ecf,efd->ecd", torch.nn.functional.silu(full_g) * full_h, p["wo"])
    assert torch.equal(want[5:], torch.zeros_like(want[5:]))
    monkeypatch.setattr(moe, "EXPERT_GROUP", group)
    got = moe._routed_experts(p, xe)
    assert torch.equal(got, want)


def test_moe_block_is_the_same_for_every_expert_group(monkeypatch):
    _, cfg, _, p, x = block_inputs("kimi-k2-1t-a32b", 30)
    want, want_aux = moe.moe_block(p, torch.from_numpy(x), cfg)
    for group in (1, 3):
        monkeypatch.setattr(moe, "EXPERT_GROUP", group)
        got, aux = moe.moe_block(p, torch.from_numpy(x), cfg)
        assert torch.equal(got, want) and torch.equal(aux, want_aux), group
