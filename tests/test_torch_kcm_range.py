"""The kcm path on operands at or past its ROMs (|t| >= 2**nbits), byte for
byte against the JAX package's Pallas passes in interpret mode.

The reference gathers with `jnp.take`, whose fill for an index past the ROM
is the minimum of the narrow host stack's dtype (-2**15 for an int16 stack,
-2**31 for int32), and sums it in the carry `_tables_for` picks: int16 when
the stack's bound is below 2**15, where the sum wraps, else int32. The
fused pass keeps an int32 carry for both passes. The port carries both
facts with its ROM stacks (`repro_torch.filters.conv.RomStack`).

Covered: operands 256, 300, -300, 65536, 70000 and +-(2**31 - 1), at
nbits 8 and 16; `conv2d_pass` (direct), `fused_separable_pass`, and
`apply_filter(..., device="cpu")` under every dataflow over the bank and
several multipliers; stacks with an int16 carry, with an int16 stack and an
int32 carry, and int32 stacks. And the column prefix of the persistent
fused kcm kernel (`column_prefix`): it covers every row sum the row ROMs
give, and it is int16 exactly when its entries fit. The tolerance is zero:
the datapath is all integers.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.filters.conv as jconv
from repro.filters.pipeline import apply_filter as japply_filter
from repro_torch.core.kcm import METHODS
from repro_torch.filters import conv as tconv
from repro_torch.filters.bank import FILTER_BANK, max_intermediate
from repro_torch.filters.pipeline import apply_filter

# The suite runs in several worker processes; one torch thread each keeps
# them from oversubscribing the cores.
torch.set_num_threads(1)

OPERANDS = (256, 300, -300, 65536, 70000)
# -2**31 crashes the reference's interpret-mode pass (ROADMAP R4); the port's
# answer for it is held against jnp.take itself below
EXTREMES = (-(1 << 31) + 1, (1 << 31) - 1)
SEPARABLE = [n for n in FILTER_BANK if FILTER_BANK[n].separable]
SHAPE = (2, 6, 7)
F1_TAPS = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]])


def _frame(operand: int, nbits: int, seed: int = 0) -> np.ndarray:
    """A seeded in-range (2, 6, 7) batch with `operand` at four pixels:
    two side by side (two fills in one sum), one on an edge, one alone."""
    top = (1 << nbits) - 1
    x = np.random.default_rng(seed).integers(-top, top + 1, SHAPE)
    for n, y, c in ((0, 2, 3), (0, 2, 4), (1, 0, 6), (1, 4, 1)):
        x[n, y, c] = operand
    return x.astype(np.int32)


def _ref_pass(x, taps, **kw):
    return np.asarray(jconv.conv2d_pass(jnp.asarray(x), taps, mult_impl="kcm",
                                        interpret=True, **kw))


def _port_pass(x, taps, **kw):
    return tconv.conv2d_pass(torch.from_numpy(x), taps, mult_impl="kcm", **kw).numpy()


def test_f1_input_gives_the_reference_fill_at_nine_pixels():
    """ROADMAP F1: a zero image with one 300, 3x3 binomial taps, refmlm at 8
    bits: -32768 at the nine pixels around it, 0 elsewhere."""
    x = np.zeros((1, 5, 5), np.int32)
    x[0, 2, 2] = 300
    kw = dict(method="refmlm", nbits=8, shift=0, post="none")
    want = np.zeros((1, 5, 5), np.int32)
    want[0, 1:4, 1:4] = -32768
    np.testing.assert_array_equal(_ref_pass(x, F1_TAPS, **kw), want)
    np.testing.assert_array_equal(_port_pass(x, F1_TAPS, **kw), want)


# (name, taps, nbits, carry, fill): the three kinds of stack the bank makes
STACKS = [
    ("gaussian3 row, int16 stack, int16 carry", np.array([[4, 8, 4]]), 8, 16, -(1 << 15)),
    ("F1 taps, int16 stack, int16 carry", F1_TAPS, 8, 16, -(1 << 15)),
    ("gaussian3 direct, int16 stack, int32 carry", FILTER_BANK["gaussian3"].taps, 8, 32,
     -(1 << 15)),
    ("gaussian5 column at 16 bits, int32 stack", np.array([[1, 4, 6, 4, 1]]).T, 16, 32,
     -(1 << 31)),
]


@pytest.mark.parametrize("name,taps,nbits,carry,fill", STACKS, ids=[s[0] for s in STACKS])
@pytest.mark.parametrize("method", ["refmlm", "exact"])
def test_rom_stack_facts_match_the_reference_tables(name, taps, nbits, carry, fill, method):
    """fill and carry of the port's stack == the dtype and carry of the
    reference's `_tables_for`."""
    tables, acc = jconv._tables_for(method, taps, nbits)
    roms = tconv.rom_stack(method, taps, nbits, torch.device("cpu"))
    assert (roms.fill, roms.carry_bits) == (fill, carry)
    assert roms.fill == int(jnp.iinfo(tables.dtype).min)
    assert acc == f"int{carry}"


@pytest.mark.parametrize("name,taps,nbits,carry,fill", STACKS, ids=[s[0] for s in STACKS])
@pytest.mark.parametrize("operand", OPERANDS + EXTREMES)
def test_conv2d_pass_past_the_rom_matches_pallas(name, taps, nbits, carry, fill, operand):
    x = _frame(operand, nbits)
    for method, post, shift in (("refmlm", "none", 0), ("mitchell", "clip", 4)):
        kw = dict(method=method, nbits=nbits, shift=shift, post=post)
        np.testing.assert_array_equal(_port_pass(x, taps, **kw), _ref_pass(x, taps, **kw),
                                      err_msg=f"{method} {post}")


@pytest.mark.parametrize("method", ["refmlm", "odma"])
@pytest.mark.parametrize("nbits", [8, 16])
def test_conv2d_pass_every_operand_at_once_matches_pallas(method, nbits):
    """Every listed operand in one batch, at both widths, on bank taps with
    signed coefficients (sobel_x: an int16 carry at 8 bits)."""
    x = _frame(0, nbits, seed=1)
    flat = x.reshape(-1)
    flat[::5][:len(OPERANDS + EXTREMES)] = OPERANDS + EXTREMES
    flat[1::5][:len(OPERANDS)] = [-v for v in OPERANDS]
    for taps in (FILTER_BANK["sobel_x"].taps, FILTER_BANK["sharpen3"].taps):
        kw = dict(method=method, nbits=nbits, shift=0, post="none")
        np.testing.assert_array_equal(_port_pass(x, taps, **kw), _ref_pass(x, taps, **kw))


@pytest.mark.parametrize("name", ["gaussian3", "gaussian5", "sobel_y"])
@pytest.mark.parametrize("operand", OPERANDS)
def test_fused_separable_pass_past_the_rom_matches_pallas(name, operand):
    """Rows at 8 bits, columns at the bank's nbits2 (16): the fused pass
    keeps an int32 carry in both passes (where gaussian3's direct row pass
    would narrow), and 65536 or 70000 make row sums past the column ROMs."""
    spec = FILTER_BANK[name]
    nb2 = jconv.second_pass_nbits(max_intermediate(spec), int(np.abs(spec.sep_col).max()))
    x = _frame(operand, 8, seed=2)
    for method in ("refmlm", "mitchell"):
        kw = dict(method=method, nbits=8, nbits2=nb2, shift=spec.shift, post="none",
                  mult_impl="kcm")
        want = np.asarray(jconv.fused_separable_pass(jnp.asarray(x), spec.sep_row,
                                                     spec.sep_col, interpret=True, **kw))
        got = tconv.fused_separable_pass(torch.from_numpy(x), spec.sep_row, spec.sep_col,
                                         **kw).numpy()
        np.testing.assert_array_equal(got, want, err_msg=method)


def _filter_frame(values: dict) -> np.ndarray:
    """A 16x16 frame of 100s with `values` at their (y, x)."""
    f = np.full((1, 16, 16), 100, np.int32)
    for (y, x), v in values.items():
        f[0, y, x] = v
    return f


# the 16x16 frame of ROADMAP F1, and one with every other operand
FRAMES = {"300": _filter_frame({(4, 4): 300}),
          "mixed": _filter_frame({(3, 3): 256, (3, 4): -300, (9, 10): 65536,
                                  (12, 5): 70000, (0, 15): -256})}
DATAFLOWS = [(name, flow) for name in FILTER_BANK
             for flow in (("fused", "two_pass", "direct") if FILTER_BANK[name].separable
                          else ("direct",))]
_FLOW_KW = {"fused": dict(fused=True), "two_pass": dict(fused=False),
            "direct": dict(separable=False)}


@pytest.mark.parametrize("name,flow", DATAFLOWS, ids=[f"{n}-{f}" for n, f in DATAFLOWS])
@pytest.mark.parametrize("frame", FRAMES)
def test_apply_filter_past_the_rom_matches_pallas(name, flow, frame):
    x = FRAMES[frame]
    for method in (("refmlm", "mitchell_ecc2") if frame == "300" else ("refmlm",)):
        kw = dict(method=method, **_FLOW_KW[flow])
        want = np.asarray(japply_filter(jnp.asarray(x), name, interpret=True, **kw))
        got = apply_filter(x, name, device="cpu", **kw).numpy()
        np.testing.assert_array_equal(got, want, err_msg=method)


def test_int32_minimum_takes_the_fill_as_jnp_take_does():
    """|-2**31| wraps to -2**31 in int32, an index past any ROM: jnp.take
    gives its fill, and the term is sgn(-2**31) * fill."""
    x = np.zeros((1, 3, 4), np.int32)
    x[0, 1, 1] = -(1 << 31)
    tables, _ = jconv._tables_for("refmlm", np.array([[4, 8, 4]]), 8)
    fill = int(jnp.take(tables[0], jnp.abs(jnp.asarray(x[0, 1, 1])), axis=0))
    assert fill == -(1 << 15)
    got = _port_pass(x, np.array([[4, 8, 4]]), method="refmlm", nbits=8, shift=0, post="none")
    want = np.zeros_like(x)
    want[0, 1, :3] = fill          # -1 * -2**15 wraps to -2**15 in the int16 carry
    np.testing.assert_array_equal(got, want)


def test_f1_frame_differs_from_the_in_range_answer():
    """The fill changes the answer where the reference's does: gaussian3 at
    the 300 gives 0 (nine fills), not the 75 of dropped terms."""
    out = apply_filter(FRAMES["300"], "gaussian3", method="refmlm", device="cpu").numpy()
    assert out[0, 4, 4] == 0 and out[0, 0, 0] != 0


# ------------------------------------------------- the fused kernel's prefix

PREFIX_METHODS = list(METHODS) + ["mitchell_ecc1", "mitchell_ecc3"]


@pytest.mark.parametrize("method", PREFIX_METHODS)
@pytest.mark.parametrize("name", SEPARABLE)
def test_column_prefix_covers_every_row_sum(name, method):
    """P > max |row sum| that in-range operands can give (the sum of each
    row ROM's largest |entry|, reached by choosing each operand's sign), or
    P is the whole column ROM; int16 iff every entry of the prefix fits."""
    spec = FILTER_BANK[name]
    nb2 = tconv.second_pass_nbits(max_intermediate(spec), int(np.abs(spec.sep_col).max()))
    cpu = torch.device("cpu")
    row = tconv.rom_stack(method, spec.sep_row, 8, cpu)
    col = tconv.rom_stack(method, spec.sep_col, nb2, cpu)
    length, int16 = tconv.column_prefix(row, col)
    widest = int(row.table.to(torch.int64).abs().amax(dim=1).sum())
    col_len = col.table.shape[1]
    assert length > widest or length == col_len
    assert length == col_len or (length < col_len and length % tconv.PREFIX_GRANULE == 0)
    entries = col.table[:, :length]
    assert int16 == bool(((entries >= -(1 << 15)) & (entries < (1 << 15))).all())
    assert length * col.table.shape[0] * (2 if int16 else 4) <= tconv.PREFIX_MAX_BYTES


def test_column_prefix_of_the_bank_is_int16_at_4096_entries():
    """gaussian3's column reaches 4080 x 8 = 32640 and gaussian5's 4080 x 6
    = 24480: both prefixes fit int16."""
    cpu = torch.device("cpu")
    for name in ("gaussian3", "gaussian5"):
        spec = FILTER_BANK[name]
        for method in ("refmlm", "exact"):
            row = tconv.rom_stack(method, spec.sep_row, 8, cpu)
            col = tconv.rom_stack(method, spec.sep_col, 16, cpu)
            assert tconv.column_prefix(row, col) == (4096, True), (name, method)


def test_column_prefix_falls_back_to_int32_and_caps_its_size():
    """16-bit rows give row sums up to 2**18: the prefix is held to
    PREFIX_MAX_BYTES, and an entry past int16 inside it makes it int32."""
    cpu = torch.device("cpu")
    wide_row = tconv.rom_stack("exact", np.array([1, 2, 1]), 16, cpu)
    small_row = tconv.rom_stack("exact", np.array([1, 0, 1]), 8, cpu)      # sums <= 510
    col16 = tconv.rom_stack("exact", np.array([1, 2, 1]), 16, cpu)        # x * 2 fits int16 below 16384
    col32 = tconv.rom_stack("exact", np.array([70, 0, 70]), 16, cpu)      # x * 70 fits below 469
    assert tconv.column_prefix(wide_row, col16) == (tconv.PREFIX_MAX_BYTES // (2 * 3), True)
    assert tconv.column_prefix(wide_row, col32) == (tconv.PREFIX_MAX_BYTES // (4 * 3), False)
    assert tconv.column_prefix(small_row, col16) == (512, True)
    assert tconv.column_prefix(small_row, col32) == (512, False)
