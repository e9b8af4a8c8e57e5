"""Parity of the port's quantized inference path (`repro_torch.infer`) with
the JAX package.

Each reference model (mlp and cnn at 8x8, the reference tests' seeds) is
calibrated by the JAX package and carried across with
`convert.from_reference_model` (its layers, numpy params and
`export_scales()` bundle), so both packages compute from the same integers.
Then, on the CPU, where the port's kernel wrappers run their plain versions:

  * every quantized method's logits and `collect=True` accumulators are
    byte-equal to the reference's, `per_layer` pinning included, and the
    four exact methods equal the int8 oracle (the §14 contract);
  * `error_report` gives the reference's numbers for every quantized method;
  * `calibrate` and `float_forward`, float32 passes whose matmuls may sum in
    another order than XLA's, agree within rtol 1e-5.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.infer as J
import repro_torch.infer as T
from repro.data.images import inference_batch
from repro_torch.convert import from_reference_model
from repro_torch.core.quant import balanced_limbs
from repro_torch.kernels.karatsuba_matmul_i8 import limbs_fit_int8
from repro_torch.data.images import inference_batch as t_inference_batch

# The suite runs in several worker processes; one torch thread each keeps
# them from oversubscribing the cores.
torch.set_num_threads(1)

HW = (8, 8)
MODELS = sorted(J.MODELS)
QUANTIZED = [m for m in J.INFER_METHODS if m != "exact"]
EXACT_METHODS = ["refmlm", "refmlm_kom3", "schoolbook_int16", "karatsuba_int16"]


def _carry(cal, device="cpu"):
    g = cal.graph
    return from_reference_model(
        g.name, g.input_hw, [(type(l).__name__, dataclasses.asdict(l)) for l in g.layers],
        g.num_classes, cal.params, J.export_scales(cal), device=device)


def _reference(model, nbits=8):
    g = J.MODELS[model](HW)
    p = J.init_params(g, seed=1)
    return J.calibrate(g, p, inference_batch(4, HW, seed=100), nbits=nbits)


@pytest.fixture(scope="module")
def models():
    return {name: (ref, _carry(ref)) for name in MODELS
            for ref in [_reference(name)]}


@pytest.fixture(scope="module")
def x_eval():
    return inference_batch(8, HW, seed=0)


def _equal(jax_value, torch_value):
    return np.array_equal(np.asarray(jax_value), torch_value.cpu().numpy())


# ------------------------------------------------------------- the forward

@pytest.mark.parametrize("method", QUANTIZED)
@pytest.mark.parametrize("model", MODELS)
def test_quantized_forward_byte_equal(models, x_eval, model, method):
    ref, port = models[model]
    j_logits, j_accs = J.forward(ref, x_eval, method, collect=True)
    t_logits, t_accs = T.forward(port, x_eval, method, collect=True)
    assert t_logits.dtype == torch.float32 and _equal(j_logits, t_logits)
    assert len(t_accs) == len(j_accs)
    for ja, ta in zip(j_accs, t_accs):
        assert ta.dtype == torch.int32 and _equal(ja, ta)
    assert _equal(J.forward(ref, x_eval, method), T.forward(port, x_eval, method))


@pytest.mark.parametrize("method", EXACT_METHODS)
@pytest.mark.parametrize("model", MODELS)
def test_exact_methods_equal_int8_oracle(models, x_eval, model, method):
    """The paper's zero-error theorem lifted to networks, on the port."""
    _, port = models[model]
    oracle, o_accs = T.forward(port, x_eval, "int8", collect=True)
    got, accs = T.forward(port, x_eval, method, collect=True)
    assert all(torch.equal(a, o) for a, o in zip(accs, o_accs))
    assert torch.equal(got, oracle)


@pytest.mark.parametrize("pins", [{0: "mitchell"}, {-1: "refmlm", 0: "karatsuba_int16"},
                                  {0: "odma", -1: "mitchell_ecc2"}])
@pytest.mark.parametrize("model", MODELS)
def test_per_layer_pinning_byte_equal(models, x_eval, model, pins):
    ref, port = models[model]
    dense = [i for i, q in enumerate(ref.lq) if q is not None]
    per_layer = {dense[k]: m for k, m in pins.items()}
    j_logits, j_accs = J.forward(ref, x_eval, "int8", per_layer=per_layer, collect=True)
    t_logits, t_accs = T.forward(port, x_eval, "int8", per_layer=per_layer, collect=True)
    assert _equal(j_logits, t_logits)
    assert all(_equal(a, b) for a, b in zip(j_accs, t_accs))


@pytest.mark.parametrize("method", ["mitchell", "mitchell_ecc1", "mitchell_ecc3", "odma",
                                    "schoolbook_int16", "int8"])
def test_forward_at_12_bits_byte_equal(x_eval, method):
    """Wider operands through the kernel routes: nbits=12 magnitudes."""
    ref = _reference("mlp", nbits=12)
    port = _carry(ref)
    j_logits, j_accs = J.forward(ref, x_eval, method, collect=True)
    t_logits, t_accs = T.forward(port, x_eval, method, collect=True)
    assert _equal(j_logits, t_logits)
    assert all(_equal(a, b) for a, b in zip(j_accs, t_accs))


@pytest.mark.parametrize("method", ["karatsuba_int16", "schoolbook_int16"])
@pytest.mark.parametrize("nbits", [14, 16])
def test_forward_with_wide_limbs_byte_equal(x_eval, nbits, method):
    """nbits = 14 / 16: the weights' limbs pass int8 (Karatsuba's w = 7 at
    both, schoolbook's w = 8 at 16; on the card the wide kernel's thin
    route takes them); the accumulators equal the reference's and the int8
    oracle's."""
    ref = _reference("mlp", nbits=nbits)
    port = _carry(ref)
    w = 7 if method == "karatsuba_int16" else 8
    qw = port.lq[1].qweight
    hi, lo = balanced_limbs(qw, w)
    assert limbs_fit_int8(hi, lo, hi.T, lo.T, karatsuba=w == 7) == (w == 8 and nbits == 14)
    j_logits, j_accs = J.forward(ref, x_eval, method, collect=True)
    t_logits, t_accs = T.forward(port, x_eval, method, collect=True)
    o_logits, o_accs = T.forward(port, x_eval, "int8", collect=True)
    assert _equal(j_logits, t_logits) and torch.equal(t_logits, o_logits)
    assert all(_equal(a, b) and torch.equal(b, o) for a, b, o in zip(j_accs, t_accs, o_accs))


@pytest.mark.parametrize("model", MODELS)
def test_float_forward_within_rtol(models, x_eval, model):
    ref, port = models[model]
    want = np.asarray(J.float_forward(ref.graph, ref.params, x_eval))
    got = T.float_forward(port.graph, port.params, x_eval, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    exact = T.forward(port, x_eval, "exact").numpy()
    np.testing.assert_allclose(exact, np.asarray(J.forward(ref, x_eval, "exact")),
                               rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ calibration

@pytest.mark.parametrize("model", MODELS)
def test_calibrate_within_rtol(models, model):
    ref, _ = models[model]
    graph = T.MODELS[model](HW)
    params = T.init_params(graph, seed=1)
    port = T.calibrate(graph, params, t_inference_batch(4, HW, seed=100), device="cpu")
    assert port.nbits == ref.nbits and port.qmax == ref.qmax
    for jq, tq in zip(ref.lq, port.lq):
        assert (jq is None) == (tq is None)
        if jq is None:
            continue
        assert tq.w_scale == jq.w_scale
        assert _equal(jq.qweight, tq.qweight)
        np.testing.assert_allclose(tq.a_scale, jq.a_scale, rtol=1e-5)


@pytest.mark.parametrize("model", MODELS)
def test_carried_model_matches_reference(models, model):
    """Graph, params, scales and quantized integers are the reference's."""
    ref, port = models[model]
    assert port.graph == T.MODELS[model](HW)
    assert T.export_scales(port) == J.export_scales(ref)
    for jq, tq in zip(ref.lq, port.lq):
        if jq is not None:
            assert _equal(jq.qweight, tq.qweight) and _equal(jq.qbias, tq.qbias)
    for jp, tp in zip(J.init_params(ref.graph, seed=1),
                      T.init_params(port.graph, seed=1)):
        assert (jp is None and tp is None) or all(
            np.array_equal(jp[k], tp[k]) for k in ("w", "b"))
    assert port.device == torch.device("cpu")


def test_scale_bundle_round_trip(models, x_eval):
    _, port = models["cnn"]
    again = T.with_scales(port.graph, port.params, T.export_scales(port), device="cpu")
    assert torch.equal(T.forward(again, x_eval, "mitchell_ecc2"),
                       T.forward(port, x_eval, "mitchell_ecc2"))
    with pytest.raises(ValueError, match="arity"):
        T.with_scales(port.graph, port.params, {"nbits": 8, "layers": [None]},
                      device="cpu")


def test_inference_batch_matches_reference():
    assert np.array_equal(t_inference_batch(3, (8, 12), seed=5),
                          inference_batch(3, (8, 12), seed=5))


# ----------------------------------------------------------------- report

@pytest.mark.parametrize("model", MODELS)
def test_error_report_matches_reference(models, x_eval, model):
    ref, port = models[model]
    methods = tuple(J.INFER_METHODS)
    j_rep = J.error_report(ref, x_eval, methods)
    t_rep = T.error_report(port, x_eval, methods)
    assert list(t_rep) == list(j_rep)
    for method in QUANTIZED:
        assert t_rep[method] == j_rep[method], method
    assert T.format_report({m: t_rep[m] for m in QUANTIZED}, "t") == \
        J.format_report({m: j_rep[m] for m in QUANTIZED}, "t")
    # 'exact' is the float32 forward: its PSNR within float32 rounding
    assert t_rep["exact"]["layers"] == []
    np.testing.assert_allclose(t_rep["exact"]["psnr_db"], j_rep["exact"]["psnr_db"],
                               rtol=1e-5)


# ------------------------------------------------------------- validation

def test_validation_matches_reference(models, x_eval):
    _, port = models["mlp"]
    with pytest.raises(ValueError, match="unknown method"):
        T.forward(port, x_eval, "booth")
    with pytest.raises(ValueError, match="per_layer"):
        T.forward(port, x_eval, "exact", per_layer={1: "int8"})
    with pytest.raises(ValueError, match="invalid pinned method"):
        T.forward(port, x_eval, "int8", per_layer={1: "exact"})
    bad = [None if p is None else {"w": p["w"] * np.inf, "b": p["b"]}
           for p in port.params]
    with pytest.raises(ValueError, match="non-finite"):
        T.calibrate(port.graph, bad, x_eval, device="cpu")
    with pytest.raises(ValueError, match="unknown layer kind"):
        from_reference_model("m", HW, [("Pool", {})], 4, [None], {"nbits": 8,
                             "layers": [None]}, device="cpu")


def test_entry_points_default_to_the_card(monkeypatch, x_eval):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    graph = T.mlp_head(HW)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.calibrate(graph, T.init_params(graph), x_eval)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.float_forward(graph, T.init_params(graph), x_eval)
