"""The port's packed-row gather (opendrift_tpu_torch/ops/gather.py) and its
A/B entry point (opendrift_tpu_torch/tools/gather_ab.py).

The reference is ``jnp.take(packed, idx, axis=0, mode="clip")``: variant A
of the JAX package's ``tools/gather_ab.py`` and the function its two Pallas
kernels compute (that tool gives its ``pallas_call``s no interpret switch,
so on the CPU the plain take is their reference).  A gather moves bits and
does no arithmetic, so everything is compared bit for bit.  On the CPU both
kernel wrappers take their plain version; what is tested of them here is
the checking of their arguments, the copy width they would choose and the
refusal of a table beyond shared memory.  The kernels themselves are held
against the plain version on the card in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendrift_tpu_torch.ops import gather
from opendrift_tpu_torch.tools import gather_ab

BITS = {2: np.uint16, 4: np.uint32}


def _case(R, C, N, dtype, idx_dtype, seed=0):
    r = np.random.default_rng(seed)
    table = (r.normal(size=(R, C)) * 100).astype(dtype)
    if np.issubdtype(table.dtype, np.floating):
        table[0, 0] = np.nan
        table[min(1, R - 1), C - 1] = -0.0
    # out-of-range indices on both sides exercise the clamp
    idx = r.integers(-3, R + 3, N).astype(idx_dtype)
    return table, idx


@pytest.mark.parametrize("wrapper", [gather.gather_rows_plain,
                                     gather.gather_rows_async,
                                     gather.gather_rows_smem])
@pytest.mark.parametrize("R,C,N,dtype,idx_dtype", [
    (500, 24, 2003, np.float32, np.int32),     # the tool's row width
    (500, 22, 2003, np.float32, np.int64),     # 88 B: 8-byte copies
    (500, 23, 2003, np.float32, np.int32),     # 92 B: 4-byte copies
    (300, 5, 1001, np.float16, np.int64),      # 10 B rows: 2-byte copies
    (300, 48, 1001, np.float16, np.int32),     # a compensated table's data
    (64, 7, 5, np.int32, np.int32),
    (1, 3, 17, np.float32, np.int64)])         # every index clamps to row 0
def test_gather_matches_jnp_take_clip(wrapper, R, C, N, dtype, idx_dtype):
    table, idx = _case(R, C, N, dtype, idx_dtype)
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(idx), axis=0,
                               mode="clip"))
    got = wrapper(torch.as_tensor(table), torch.as_tensor(idx)).numpy()
    bits = BITS[table.dtype.itemsize]
    assert got.shape == want.shape == (N, C) and got.dtype == table.dtype
    np.testing.assert_array_equal(got.view(bits), want.view(bits))


def test_ragged_tail_and_empty_index():
    table, idx = _case(100, 6, 1025, np.float32, np.int32)   # 1024 + 1
    t = torch.as_tensor(table)
    for n in (1025, 1024, 1, 0):
        for wrapper in (gather.gather_rows_async, gather.gather_rows_smem):
            got = wrapper(t, torch.as_tensor(idx[:n]))
            assert tuple(got.shape) == (n, 6)
            np.testing.assert_array_equal(
                got.numpy().view(np.uint32),
                table[np.clip(idx[:n], 0, 99)].view(np.uint32))


def test_smem_wrapper_refuses_a_table_beyond_shared_memory():
    """The tool's 'table exceeds VMEM budget', as an error that states both
    sizes; neither a fallback nor a silent switch to the other kernel."""
    fits = torch.zeros((2000, 24))                     # 192,000 bytes
    idx = torch.zeros(8, dtype=torch.int32)
    assert gather.gather_rows_smem(fits, idx).shape == (8, 24)
    assert gather.SMEM_TABLE_MAX_BYTES == 232_448
    too_big = torch.zeros((2422, 24))                  # 232,512 bytes
    with pytest.raises(ValueError, match="232512.*232448"):
        gather.gather_rows_smem(too_big, idx)
    assert gather.gather_rows_async(too_big, idx).shape == (8, 24)
    with pytest.raises(ValueError, match="ring of 8 rows"):
        gather.gather_rows_async(torch.zeros((2, 8000)), idx)


@pytest.mark.parametrize("bad,error", [
    (lambda t, i: (t[:, ::2], i), ValueError),         # not contiguous
    (lambda t, i: (t, i.to(torch.int16)), TypeError),
    (lambda t, i: (t.double(), i), TypeError),
    (lambda t, i: (t.to(torch.uint8), i), TypeError),
    (lambda t, i: (t[0], i), ValueError),
    (lambda t, i: (t, i[None]), ValueError),
    (lambda t, i: (t[:0], i), ValueError),
    (lambda t, i: (t.numpy(), i), TypeError)])
def test_wrappers_raise_on_what_the_kernels_do_not_take(bad, error):
    t = torch.zeros((10, 4))
    i = torch.zeros(3, dtype=torch.int64)
    for wrapper in (gather.gather_rows_async, gather.gather_rows_smem):
        with pytest.raises(error):
            wrapper(*bad(t, i))


@pytest.mark.parametrize("row_bytes,addresses,width", [
    (96, (256, 512), 16), (96, (256, 520), 8), (96, (256, 516), 4),
    (88, (256, 512), 8), (92, (256, 512), 4), (10, (256, 512), 2),
    (352, (0, 16), 16), (6, (2, 4), 2)])
def test_copy_width(row_bytes, addresses, width):
    assert gather.unit_bytes(row_bytes, *addresses) == width


def test_no_copy_width_for_odd_bytes():
    with pytest.raises(ValueError):
        gather.unit_bytes(3, 256)


def test_bound_bytes_counts_distinct_rows_in_sectors():
    # 96-byte rows: rows 0 and 1 share no sector pair fully; row r covers
    # sectors [3r, 3r + 2]
    table = torch.zeros((10, 24))
    idx = torch.tensor([0, 0, 5, 5, 5, 99], dtype=torch.int32)  # 99 -> row 9
    b = gather.gather_bound_bytes(table, idx)
    assert b["distinct_rows"] == 3
    assert b["index_bytes"] == 24 and b["out_bytes"] == 6 * 96
    assert b["table_bytes"] == 3 * 96
    assert b["total"] == 24 + 288 + 576
    assert b["traffic"] == 6 * (4 + 2 * 96)
    # 10-byte rows straddle sectors: rows 2, 3 -> bytes [20, 40): sectors
    # 0 and 1; row 6 -> bytes [60, 70): sectors 1 and 2
    narrow = torch.zeros((8, 5), dtype=torch.float16)
    b = gather.gather_bound_bytes(narrow, torch.tensor([2, 3, 6]))
    assert b["table_bytes"] == 3 * 32
    assert b["index_bytes"] == 3 * 8


def test_ab_entry_point_on_the_cpu(capsys):
    """``python -m opendrift_tpu_torch.tools.gather_ab R C N --device cpu``:
    the four variants, one line each, B and C bit-equal to A."""
    assert gather_ab.main(["300", "24", "4099", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[0] for ln in lines[1:]] == ["A", "D", "B", "C"]
    assert "host clock" in lines[0] and "(300, 24)" in lines[0]
    assert lines[3].endswith("bit-equal to A")
    assert lines[4].endswith("bit-equal to A")
    # a table beyond shared memory: C says so and is skipped
    assert gather_ab.main(["3000", "24", "1000", "--device", "cpu"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("C") and "exceeds" in last and "skipped" in last


def test_ab_inputs_are_the_jax_tools():
    """Seed 0 and the draw order of tools/gather_ab.py:167-170."""
    packed, idx, fx = gather_ab.default_inputs(50, 6, 200, "cpu")
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        packed.numpy(), rng.normal(size=(50, 6)).astype(np.float32))
    np.testing.assert_array_equal(
        idx.numpy(), rng.integers(0, 49, 200).astype(np.int32))
    np.testing.assert_array_equal(
        fx.numpy(), rng.uniform(0, 1, 200).astype(np.float32))
    assert idx.dtype == torch.int32


def test_run_ab_returns_numbers_and_checks_equality(monkeypatch):
    packed, idx, fx = gather_ab.default_inputs(40, 5, 333, "cpu")
    res = gather_ab.run_ab(packed, idx, fx, out=lambda s: None, warmup=0,
                           reps=2)
    assert set(res) == {"A", "D", "B", "C"}
    for key in "ADBC":
        assert res[key]["ms"] > 0 and res[key]["bound_share"] is None
    assert res["B"]["bit_equal"] and res["C"]["bit_equal"]
    # an integer table has no blend
    ints = (packed * 100).to(torch.int32)
    assert gather_ab.run_ab(ints, idx, out=lambda s: None, warmup=0,
                            reps=1)["D"] is None
    # a kernel that disagrees ends the program: no line, no carrying on
    monkeypatch.setattr(gather, "gather_rows_async",
                        lambda p, i: gather.gather_rows_plain(p, i + 1))
    with pytest.raises(AssertionError, match="gather_rows_async differs"):
        gather_ab.run_ab(packed, idx, fx, out=lambda s: None, warmup=0,
                         reps=1)
